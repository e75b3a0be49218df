"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``):
``auto_cast`` and ``decorate`` (``auto_cast.py``), the op lists
(``amp_lists.py``) and ``GradScaler`` (``grad_scaler.py``). ``dtype``
defaults to bfloat16; float16 is for loss-scaled training. The
reference's ``debugging`` and ``fp8`` modules are not ported yet."""
from . import amp_lists
from .amp_lists import AutoCastLists, AutoMixedPrecisionLists
from .auto_cast import (amp_decorate, amp_guard, auto_cast, decorate,
                        is_bfloat16_supported, is_float16_supported)
from .grad_scaler import AmpScaler, GradScaler, OptimizerState

__all__ = ["amp_lists", "auto_cast", "amp_guard", "decorate", "amp_decorate",
           "GradScaler", "AmpScaler", "OptimizerState", "AutoCastLists",
           "AutoMixedPrecisionLists", "is_float16_supported",
           "is_bfloat16_supported"]
