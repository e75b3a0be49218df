"""``rms_norm`` (counterpart of ``paddle_tpu/nn/functional/norm.py:rms_norm``)."""
from __future__ import annotations

from typing import Optional

import torch

from ...base.amp_state import amp_cast

__all__ = ["rms_norm"]


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6, axis: int = -1) -> torch.Tensor:
    """Stats in f32 even for bf16 inputs, ``rsqrt(ms + eps)``, cast back to
    ``x``'s dtype, then the weight multiply — the reference's op order."""
    x, weight = amp_cast("rms_norm", x, weight)
    xf = x.float()
    ms = xf.square().mean(dim=axis, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight
