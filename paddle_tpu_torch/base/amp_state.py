"""Thread-local AMP state (counterpart of ``paddle_tpu/base/amp_state.py``).

The reference casts op inputs at its one dispatch point (``tape.apply``),
from the op's name. The port has no such point, so each op entry point on
the Llama path calls :func:`amp_cast` under the reference's op name
(``linear``, ``embedding``, ``rms_norm``, ``rope``,
``scaled_dot_product_attention``, ``silu``, ``multiply``, ``add``,
``reshape``, ``tied_lm_head``, ``cross_entropy``, ...) with the same rule:
a floating input that is not f64 and not already the target dtype is cast
to the target. ``auto_cast`` (``amp/auto_cast.py``) sets the state; with it
off, :func:`amp_cast` returns its inputs untouched.
"""
from __future__ import annotations

import threading
from typing import Optional, Set

import torch

__all__ = ["amp_attrs", "cast_target", "amp_cast"]


class _AmpTLS(threading.local):
    def __init__(self):
        self.enable = False
        self.dtype: Optional[torch.dtype] = None  # the low-precision type
        self.level = "O1"  # "OD" | "O1" | "O2"
        self.white: Set[str] = set()
        self.black: Set[str] = set()


_tls = _AmpTLS()


def amp_attrs() -> _AmpTLS:
    return _tls


def cast_target(op_name: str) -> Optional[torch.dtype]:
    """The dtype ``op_name``'s floating inputs are cast to under the active
    amp state, or None when no cast applies (the reference's rule: the
    black list wins, O2 casts everything else, O1 the white list, OD
    nothing but the black list)."""
    if (not _tls.enable or not op_name or op_name in ("cast", "recompute")
            or op_name.startswith("grad_")):
        return None
    if op_name in _tls.black:
        return torch.float32
    if _tls.level == "O2":
        return _tls.dtype
    if op_name in _tls.white:
        return _tls.dtype
    if _tls.level == "OD":
        return torch.float32
    return None


def amp_cast(op_name: str, *tensors):
    """``tensors`` as op ``op_name`` sees them under the active amp state:
    each floating tensor that is not f64 cast to :func:`cast_target`; other
    values (ints, None, Python numbers) pass through. Returns one value for
    one input, else a tuple."""
    target = cast_target(op_name) if _tls.enable else None
    if target is not None:
        tensors = tuple(
            t.to(target) if (isinstance(t, torch.Tensor)
                             and t.is_floating_point()
                             and t.dtype not in (target, torch.float64))
            else t for t in tensors)
    return tensors[0] if len(tensors) == 1 else tensors
