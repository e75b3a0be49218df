"""Convolution layers (counterpart of ``paddle_tpu/nn/layer/conv.py``).

Weight layout ``[out_channels, in_channels // groups, *kernel]``
(transposed: ``[in_channels, out_channels // groups, *kernel]``), paddle's
and torch's alike. Default init as the reference's: ``Normal(0,
sqrt(2 / fan))`` with ``fan = prod(kernel) * in_channels`` for a
convolution, the global default weight init (Xavier-uniform) for a
transposed one, zero biases; drawn from ``generator`` on ``device``
(default: the card).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import functional as F
from .common import param

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _tuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(nn.Module):
    ndim_spatial = 2
    transposed = False

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None,
                 output_padding=0, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from .. import initializer as I

        n = self.ndim_spatial
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _tuple(kernel_size, n)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._padding_mode = padding_mode
        self._data_format = data_format or ("NCL", "NCHW", "NCDHW")[n - 1]
        self._output_padding = output_padding
        if self.transposed:
            shape = [in_channels, out_channels // groups]
            default = I._default_weight_init()
        else:
            shape = [out_channels, in_channels // groups]
            fan = int(np.prod(self._kernel_size)) * in_channels
            default = I.Normal(0.0, (2.0 / fan) ** 0.5)
        self.weight = param(shape + list(self._kernel_size), weight_attr,
                            default, device, dtype, generator)
        self.bias = param([out_channels], bias_attr, I._default_bias_init(),
                          device, dtype, generator)

    def extra_repr(self) -> str:
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")


class Conv1D(_ConvNd):
    ndim_spatial = 1

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    ndim_spatial = 2

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    ndim_spatial = 3

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    ndim_spatial = 1
    transposed = True

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv2DTranspose(_ConvNd):
    ndim_spatial = 2
    transposed = True

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv3DTranspose(_ConvNd):
    ndim_spatial = 3
    transposed = True

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)
