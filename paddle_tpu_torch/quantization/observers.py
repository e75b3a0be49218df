"""Quantization observers (counterpart of
``paddle_tpu/quantization/observers.py``): ``AbsmaxObserver`` and
``GroupWiseWeightObserver``."""
from __future__ import annotations

import torch

from . import AbsmaxObserver, BaseObserver  # noqa: F401

__all__ = ["AbsmaxObserver", "GroupWiseWeightObserver"]


class GroupWiseWeightObserver(BaseObserver):
    """Per-group abs-max over a 2-D ``[cin, cout]`` weight: input channels
    are scanned in ``group_size`` chunks; ``scales()`` returns
    ``[cin/group_size, cout]``, the layout ``weight_quantize`` and
    ``weight_only_linear`` use for group-wise scales."""

    def __init__(self, quant_bits: int = 8, group_size: int = 128):
        super().__init__()
        if group_size not in (64, 128):
            raise ValueError("group_size only supports 64 or 128")
        self.quant_bits = quant_bits
        self.group_size = group_size
        self._max = None

    def forward(self, x):
        w = x.detach()
        if w.dim() != 2:
            raise ValueError("GroupWiseWeightObserver expects 2-D weights")
        cin, cout = w.shape
        if cin % self.group_size:
            raise ValueError(
                f"group_size {self.group_size} must divide input "
                f"channels {cin}")
        g = w.t().reshape(cout, cin // self.group_size, self.group_size)
        m = g.abs().amax(2).to(torch.float32)
        self._max = torch.clamp_min(m, 1e-8).t()  # [cin/group, cout]
        return x

    def scales(self):
        if self._max is None:
            raise RuntimeError("observer has not seen a weight yet")
        bound = 2 ** (self.quant_bits - 1) - 1
        return self._max / bound

    def zero_points(self):
        return None

    def bit_length(self):
        return self.quant_bits

    def quant_axis(self):
        # with the [cin/group, cout] scale layout the out-channel axis is
        # the last one
        return -1
