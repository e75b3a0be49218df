"""Normalization layers (counterpart of ``paddle_tpu/nn/layer/norm.py``):
``RMSNorm``, ``LayerNorm``, ``GroupNorm``, ``BatchNorm``/``1D``/``2D``/``3D``,
``InstanceNorm1D``-``3D`` and ``LocalResponseNorm``. Weights start at 1
and biases at 0 (or the layer's ``weight_attr`` / ``bias_attr``); the
batch norms keep their running statistics as the buffers ``_mean`` (0)
and ``_variance`` (1), the reference's names. ``device`` ``None`` is the
card."""
from __future__ import annotations

import torch
from torch import nn

from ...base.device import get_device
from ...base.dtype import to_torch_dtype
from .. import functional as F
from .common import param, tp_meta

__all__ = ["RMSNorm", "LayerNorm", "GroupNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "LocalResponseNorm"]


def _ones():
    from ..initializer import Constant

    return Constant(1.0)


def _zeros():
    from .. import initializer as I

    return I._default_bias_init()


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.epsilon = epsilon
        self.weight = tp_meta(nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = param(self._normalized_shape, weight_attr, _ones(),
                            device, dtype, None)
        self.bias = param(self._normalized_shape, bias_attr, _zeros(),
                          device, dtype, None)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self) -> str:
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class GroupNorm(nn.Module):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = param([num_channels], weight_attr, _ones(), device,
                            dtype, None)
        self.bias = param([num_channels], bias_attr, _zeros(), device, dtype,
                          None)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)

    def extra_repr(self) -> str:
        return f"num_groups={self._num_groups}, epsilon={self._epsilon}"


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = param([num_features], weight_attr, _ones(), device,
                            dtype, None)
        self.bias = param([num_features], bias_attr, _zeros(), device, dtype,
                          None)
        kw = dict(device=get_device(device), dtype=to_torch_dtype(dtype))
        self.register_buffer("_mean", torch.zeros(num_features, **kw))
        self.register_buffer("_variance", torch.ones(num_features, **kw))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self) -> str:
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class _InstanceNormBase(nn.Module):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is not False:
            self.weight = param([num_features], weight_attr, _ones(), device,
                                dtype, None)
            self.bias = param([num_features], bias_attr, _zeros(), device,
                              dtype, None)
        else:
            self.weight = self.bias = None

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(nn.Module):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)
