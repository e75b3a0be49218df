"""Pooling layers (counterpart of ``paddle_tpu/nn/layer/pooling.py``).

Each layer calls its functional in ``nn/functional/pooling.py``. The
constructors take the reference's positional order (``kernel_size,
stride, padding, ceil_mode``); the reference's layers keep any other
keyword and drop it, the port's pass it on to the functional
(``return_mask``, ``exclusive``, ``divisor_override``, ``data_format``),
as Paddle's layers do. No layer holds a parameter.
"""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = [
    "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
    "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
    "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
    "AdaptiveMaxPool3D", "MaxUnPool2D", "LPPool1D", "LPPool2D",
]


class _PoolNd(nn.Module):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 name=None, **kw):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.kw = kw

    def forward(self, x):
        return type(self)._fn(x, self.kernel_size, self.stride, self.padding,
                              ceil_mode=self.ceil_mode, **self.kw)

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class MaxPool1D(_PoolNd):
    _fn = F.max_pool1d


class MaxPool2D(_PoolNd):
    _fn = F.max_pool2d


class MaxPool3D(_PoolNd):
    _fn = F.max_pool3d


class AvgPool1D(_PoolNd):
    _fn = F.avg_pool1d


class AvgPool2D(_PoolNd):
    _fn = F.avg_pool2d


class AvgPool3D(_PoolNd):
    _fn = F.avg_pool3d


class _AdaptivePoolNd(nn.Module):
    _fn = None

    def __init__(self, output_size, name=None, **kw):
        super().__init__()
        self.output_size = output_size
        self.kw = kw

    def forward(self, x):
        return type(self)._fn(x, self.output_size, **self.kw)

    def extra_repr(self):
        return f"output_size={self.output_size}"


class AdaptiveAvgPool1D(_AdaptivePoolNd):
    _fn = F.adaptive_avg_pool1d


class AdaptiveAvgPool2D(_AdaptivePoolNd):
    _fn = F.adaptive_avg_pool2d


class AdaptiveAvgPool3D(_AdaptivePoolNd):
    _fn = F.adaptive_avg_pool3d


class AdaptiveMaxPool1D(_AdaptivePoolNd):
    _fn = F.adaptive_max_pool1d


class AdaptiveMaxPool2D(_AdaptivePoolNd):
    _fn = F.adaptive_max_pool2d


class AdaptiveMaxPool3D(_AdaptivePoolNd):
    _fn = F.adaptive_max_pool3d


class MaxUnPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, os = self.args
        return F.max_unpool2d(x, indices, k, s, p, df, os)


class LPPool1D(nn.Module):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        return F.lp_pool1d(x, *self.args)


class LPPool2D(nn.Module):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        return F.lp_pool2d(x, *self.args)
