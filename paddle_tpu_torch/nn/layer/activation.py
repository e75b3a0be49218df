"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``):
each a ``torch.nn.Module`` over its functional. Only ``PReLU`` holds a
parameter (built on ``device``, default the card)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from ..functional import activation as A
from .common import param

__all__ = [
    "CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid", "Hardswish",
    "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout", "Mish",
    "PReLU", "ReLU", "ReLU6", "RReLU", "SELU", "Sigmoid", "Silu", "Softmax",
    "Softplus", "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
    "ThresholdedReLU",
]


class _Act(nn.Module):
    """An activation with its keyword arguments fixed at construction."""

    _fn = None
    _names: tuple = ()

    def __init__(self, *args, name=None, **kwargs):
        super().__init__()
        self._kw = dict(zip(self._names, args))
        self._kw.update(kwargs)

    def forward(self, x):
        return type(self)._fn(x, **self._kw)

    def extra_repr(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in self._kw.items())


def _act(cls_name, fn, *names):
    """A ``_Act`` class named ``cls_name`` over ``fn``, whose positional
    arguments are ``names``."""
    return type(cls_name, (_Act,), {"_fn": staticmethod(fn), "_names": names,
                                    "__module__": __name__})


ReLU = _act("ReLU", A.relu)
Sigmoid = _act("Sigmoid", A.sigmoid)
Silu = _act("Silu", A.silu)
Tanh = _act("Tanh", A.tanh)
ReLU6 = _act("ReLU6", A.relu6)
LogSigmoid = _act("LogSigmoid", A.log_sigmoid)
Mish = _act("Mish", A.mish)
Tanhshrink = _act("Tanhshrink", A.tanhshrink)
Softsign = _act("Softsign", A.softsign)
Swish = _act("Swish", A.swish)
Hardswish = _act("Hardswish", A.hardswish)
GELU = _act("GELU", A.gelu, "approximate")
ELU = _act("ELU", A.elu, "alpha")
CELU = _act("CELU", A.celu, "alpha")
SELU = _act("SELU", A.selu, "scale", "alpha")
LeakyReLU = _act("LeakyReLU", A.leaky_relu, "negative_slope")
Hardshrink = _act("Hardshrink", A.hardshrink, "threshold")
Softshrink = _act("Softshrink", A.softshrink, "threshold")
Hardtanh = _act("Hardtanh", A.hardtanh, "min", "max")
Softplus = _act("Softplus", A.softplus, "beta", "threshold")
ThresholdedReLU = _act("ThresholdedReLU", A.thresholded_relu, "threshold",
                       "value")
LogSoftmax = _act("LogSoftmax", A.log_softmax, "axis")
GLU = _act("GLU", A.glu, "axis")
Maxout = _act("Maxout", A.maxout, "groups", "axis")


class Hardsigmoid(nn.Module):
    """The reference layer's ``hardsigmoid`` at its default slope and
    offset."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardsigmoid(x)


class Softmax(nn.Module):
    def __init__(self, axis=-1, dtype=None, name=None):
        super().__init__()
        self.axis, self._softmax_dtype = axis, dtype

    def forward(self, x):
        return F.softmax(x, self.axis, self._softmax_dtype)


class RReLU(nn.Module):
    """Random slopes in training (from the port's generator of the input's
    device), the mean slope in eval mode."""

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class PReLU(nn.Module):
    """``weight`` ``[num_parameters]`` (one slope, or one per channel of
    ``data_format``), initialized to ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        from ..initializer import Constant

        self.data_format = data_format
        self.weight = param([num_parameters], weight_attr, Constant(init),
                            device, dtype, None)

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)
