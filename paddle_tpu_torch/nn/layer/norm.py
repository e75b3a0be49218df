"""``RMSNorm`` (counterpart of ``paddle_tpu/nn/layer/norm.py:RMSNorm``)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import rms_norm
from .common import tp_meta

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.epsilon = epsilon
        self.weight = tp_meta(nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.epsilon)
