"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``,
limited to what the Llama MLP uses)."""
from __future__ import annotations

import torch

from ...base.amp_state import amp_cast

__all__ = ["silu"]


def silu(x: torch.Tensor) -> torch.Tensor:
    x = amp_cast("silu", x)
    return x * torch.sigmoid(x)
