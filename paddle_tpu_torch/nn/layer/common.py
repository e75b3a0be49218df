"""``Linear`` and ``Embedding`` (counterpart of ``paddle_tpu/nn/layer/common.py``).

``Linear`` keeps paddle's ``[in_features, out_features]`` weight layout
(``y = x @ W``), so weights carried over from the JAX package need no
transpose. Init mirrors the reference's defaults: Xavier-uniform weights,
zero bias, N(0, 1) embeddings — drawn from an explicit ``torch.Generator``.
Every parameter carries the reference ``Parameter``'s tensor-parallel
metadata (``paddle_tpu/nn/layer/layers.py:49-50``): ``is_distributed``
(False: the whole tensor) and ``tp_axis`` (None: no sharding hint), which
``distributed.fleet``'s tensor parallelism reads.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...base.amp_state import amp_cast

__all__ = ["Linear", "Embedding", "tp_meta"]


def tp_meta(p: nn.Parameter, tp_axis: Optional[int] = None) -> nn.Parameter:
    """Set the reference ``Parameter``'s TP metadata on ``p``: the whole
    tensor (``is_distributed = False``) with the sharding hint
    ``tp_axis``."""
    p.is_distributed = False
    p.tp_axis = tp_axis
    return p


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, device: torch.device, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        limit = math.sqrt(6.0 / (in_features + out_features))
        w = torch.empty(in_features, out_features, device=device, dtype=dtype)
        w.uniform_(-limit, limit, generator=generator)
        self.weight = tp_meta(nn.Parameter(w))
        self.bias = (tp_meta(nn.Parameter(torch.zeros(
            out_features, device=device, dtype=dtype))) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = amp_cast("linear", x, self.weight, self.bias)
        y = torch.matmul(x, w)
        return y if b is None else y + b

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 device: torch.device, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = torch.empty(num_embeddings, embedding_dim, device=device,
                        dtype=dtype)
        w.normal_(0.0, 1.0, generator=generator)
        self.weight = tp_meta(nn.Parameter(w))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return amp_cast("embedding", self.weight)[ids.long()]

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"
