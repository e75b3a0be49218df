"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``):
``auto_cast`` and ``decorate`` (``auto_cast.py``), the op lists
(``amp_lists.py``) and ``GradScaler`` (``grad_scaler.py``). ``dtype``
defaults to bfloat16; float16 is for loss-scaled training. ``fp8.py``
holds the delayed-scaling fp8 GEMMs (``fp8_linear``, ``Fp8Linear``,
``convert_to_fp8``). ``debugging.py`` holds the tensor checker, the
operator stats and ``compare_accuracy``."""
from . import amp_lists, debugging
from .amp_lists import AutoCastLists, AutoMixedPrecisionLists
from .fp8 import (E4M3_MAX, E5M2_MAX, Fp8Linear, convert_to_fp8,
                  fp8_linear)
from .auto_cast import (amp_decorate, amp_guard, auto_cast, decorate,
                        is_bfloat16_supported, is_float16_supported)
from .grad_scaler import AmpScaler, GradScaler, OptimizerState

__all__ = ["amp_lists", "debugging", "auto_cast", "amp_guard", "decorate", "amp_decorate",
           "GradScaler", "AmpScaler", "OptimizerState", "AutoCastLists",
           "AutoMixedPrecisionLists", "is_float16_supported",
           "is_bfloat16_supported", "Fp8Linear", "convert_to_fp8",
           "fp8_linear", "E4M3_MAX", "E5M2_MAX"]
