"""``auto_cast`` and ``decorate`` (counterpart of ``paddle_tpu/amp/auto_cast.py``).

``auto_cast`` sets the thread-local amp state (``base/amp_state.py``) that
the port's op entry points consult; ``torch.autocast`` is not used, since
its op lists are not the reference's. ``dtype`` defaults to bfloat16, as
in the reference.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from ..base import amp_state
from ..base.dtype import to_torch_dtype
from .amp_lists import AutoCastLists

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_decorate",
           "is_bfloat16_supported", "is_float16_supported"]

_SUPPORTED_LEVELS = ("O0", "OD", "O1", "O2")


def is_float16_supported(device=None) -> bool:
    return True


def is_bfloat16_supported(device=None) -> bool:
    return True


@contextlib.contextmanager
def amp_guard(enable: bool = True,
              custom_white_list: Optional[Sequence[str]] = None,
              custom_black_list: Optional[Sequence[str]] = None,
              level: str = "O1", dtype: str = "bfloat16",
              use_promote: bool = True):
    """Per-op casting inside the block: O1 casts the white list's ops to
    ``dtype`` and the black list's to f32, O2 every op but the black
    list's, OD only the black list's; O0 turns amp off."""
    if level not in _SUPPORTED_LEVELS:
        raise ValueError(f"level should be one of {_SUPPORTED_LEVELS}, got {level}")
    if dtype not in ("float16", "bfloat16"):
        raise ValueError(f"dtype should be float16 or bfloat16, got {dtype}")
    if level == "O0":
        enable = False
    tls = amp_state.amp_attrs()
    prev = (tls.enable, tls.dtype, tls.level, tls.white, tls.black)
    if enable:
        lists = AutoCastLists(custom_white_list, custom_black_list, dtype,
                              level)
        tls.enable = True
        tls.dtype = to_torch_dtype(dtype)
        tls.level = level
        tls.white = lists.white_list
        tls.black = lists.black_list
    else:
        tls.enable = False
    try:
        yield
    finally:
        tls.enable, tls.dtype, tls.level, tls.white, tls.black = prev


auto_cast = amp_guard


def decorate(models, optimizers=None, level: str = "O1",
             dtype: str = "bfloat16", master_weight: Optional[bool] = None,
             save_dtype: Optional[str] = None, master_grad: bool = False,
             excluded_layers=None):
    """O1: the models stay as they are (casting is per op). O2: every
    floating parameter and buffer is cast to ``dtype`` in place (modules
    of the ``excluded_layers`` types keep theirs), and the optimizers keep
    f32 master weights (``master_weight``, default True). Returns the
    models, and the optimizers when given, as they were passed."""
    if level not in _SUPPORTED_LEVELS:
        raise ValueError(f"level should be one of {_SUPPORTED_LEVELS}, got {level}")
    models_in = models
    if isinstance(models, torch.nn.Module):
        models = [models]
    opts_in = optimizers
    if optimizers is None:
        optimizers = []
    elif not isinstance(optimizers, (list, tuple)):
        optimizers = [optimizers]
    if level == "O2":
        excluded = ()
        if excluded_layers:
            extra = (tuple(excluded_layers)
                     if isinstance(excluded_layers, (list, tuple))
                     else (excluded_layers,))
            excluded = tuple(t for t in extra if isinstance(t, type))
        dt = to_torch_dtype(dtype)
        for model in models:
            for sub in model.modules():
                if excluded and isinstance(sub, excluded):
                    continue
                for t in [*sub.parameters(recurse=False),
                          *sub.buffers(recurse=False)]:
                    if t.is_floating_point():
                        t.data = t.data.to(dt)
        use_master = master_weight if master_weight is not None else True
        for opt in optimizers:
            opt._multi_precision = bool(use_master)
    if save_dtype is not None:
        for model in models:
            model._save_dtype = to_torch_dtype(save_dtype)
    if opts_in is None:
        return models_in
    return models_in, opts_in


amp_decorate = decorate
