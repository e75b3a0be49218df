"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``).

Each is the reference's formula in plain torch ops, under the op name the
reference's amp lists key on. The in-place variants (``relu_``, ...) write
the result into ``x`` and return it. ``rrelu`` in training and
``gumbel_softmax`` draw from ``generator`` (default: the port's seeded
generator of ``x``'s device, ``base/random.py``); their draws cannot match
the reference's, their distributions do.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...base.amp_state import amp_cast
from ...base.dtype import to_torch_dtype

__all__ = [
    "celu", "elu", "gelu", "glu", "gumbel_softmax", "hardshrink",
    "hardsigmoid", "hardswish", "hardtanh", "leaky_relu", "log_sigmoid",
    "log_softmax", "maxout", "mish", "prelu", "relu", "relu6", "relu_",
    "rrelu", "selu", "sigmoid", "silu", "softmax", "softmax_", "softplus",
    "softshrink", "softsign", "swish", "tanh", "tanh_", "tanhshrink",
    "thresholded_relu", "elu_", "hardtanh_", "leaky_relu_",
    "thresholded_relu_",
]

_SELU_SCALE = 1.0507009873554804934193349852946
_SELU_ALPHA = 1.6732632423543772848170429916717


def _gen(x: torch.Tensor, generator):
    if generator is not None:
        return generator
    from ...base.random import get_generator

    return get_generator(x.device)


def silu(x: torch.Tensor, name=None) -> torch.Tensor:
    x = amp_cast("silu", x)
    return x * torch.sigmoid(x)


def swish(x, name=None):
    return silu(x)


def relu(x, name=None):
    return torch.relu(amp_cast("relu", x))


def sigmoid(x, name=None):
    return torch.sigmoid(amp_cast("sigmoid", x))


def tanh(x, name=None):
    return torch.tanh(amp_cast("tanh", x))


def softsign(x, name=None):
    x = amp_cast("softsign", x)
    return x / (1 + x.abs())


def log_sigmoid(x, name=None):
    return torch.nn.functional.logsigmoid(amp_cast("log_sigmoid", x))


def mish(x, name=None):
    x = amp_cast("mish", x)
    return x * torch.tanh(torch.nn.functional.softplus(x))


def tanhshrink(x, name=None):
    x = amp_cast("tanhshrink", x)
    return x - torch.tanh(x)


def relu6(x, name=None):
    return torch.clamp(amp_cast("relu6", x), 0, 6)


def elu(x, alpha=1.0, name=None):
    x = amp_cast("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    x = amp_cast("celu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def selu(x, scale=_SELU_SCALE, alpha=_SELU_ALPHA, name=None):
    x = amp_cast("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def gelu(x, approximate=False, name=None):
    return torch.nn.functional.gelu(
        amp_cast("gelu", x), approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope=0.01, name=None):
    x = amp_cast("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight, data_format="NCHW", name=None):
    x, weight = amp_cast("prelu", x, weight)
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    ch_axis = 1 if data_format[1] == "C" else x.dim() - 1
    shape = [1] * x.dim()
    shape[ch_axis] = weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None,
          generator: Optional[torch.Generator] = None):
    """Training: each negative element scaled by its own ``U(lower,
    upper)`` draw (f32, cast to ``x``'s dtype); eval: ``leaky_relu`` at the
    midpoint."""
    if not training:
        return leaky_relu(x, (lower + upper) / 2.0)
    x = amp_cast("rrelu", x)
    r = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    r.uniform_(lower, upper, generator=_gen(x, generator))
    return torch.where(x >= 0, x, x * r.to(x.dtype))


def hardshrink(x, threshold=0.5, name=None):
    x = amp_cast("hardshrink", x)
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    x = amp_cast("softshrink", x)
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return torch.clamp(amp_cast("hardtanh", x), min, max)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    x = amp_cast("hardsigmoid", x)
    return torch.clamp(x * slope + offset, 0.0, 1.0)


def hardswish(x, name=None):
    x = amp_cast("hardswish", x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``x`` where ``beta * x > threshold``, else ``log1p(exp(beta x)) /
    beta`` computed stably (``jax.nn.softplus``'s ``logaddexp(x, 0)``)."""
    x = amp_cast("softplus", x)
    bx = x * beta
    soft = torch.logaddexp(bx, torch.zeros_like(bx)) / beta
    return torch.where(bx > threshold, x, soft)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    x = amp_cast("thresholded_relu", x)
    return torch.where(x > threshold, x, torch.full_like(x, value))


def _cast(x, dtype):
    return x if dtype is None else x.to(to_torch_dtype(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    return torch.softmax(_cast(amp_cast("softmax", x), dtype), dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    return torch.log_softmax(_cast(amp_cast("log_softmax", x), dtype),
                             dim=axis)


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(amp_cast("glu", x), 2, dim=axis)
    return a * torch.sigmoid(b)


def maxout(x, groups, axis=1, name=None):
    x = amp_cast("maxout", x)
    ax = axis % x.dim()
    shape = list(x.shape)
    shape[ax:ax + 1] = [shape[ax] // groups, groups]
    return x.reshape(shape).amax(dim=ax + 1)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None,
                   generator: Optional[torch.Generator] = None):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g =
    -log(-log(u))``, ``u ~ U(1e-10, 1 - 1e-10)`` drawn in f32; ``hard``
    returns the one-hot argmax with the soft gradient (straight-through)."""
    x = amp_cast("gumbel_softmax", x)
    u = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    u.uniform_(1e-10, 1.0 - 1e-10, generator=_gen(x, generator))
    g = -torch.log(-torch.log(u.to(x.dtype)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard - y.detach() + y
    return y


def relu_(x, name=None):
    return x.copy_(relu(x))


def tanh_(x, name=None):
    return x.copy_(tanh(x))


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(softmax(x, axis=axis, dtype=dtype))


def elu_(x, alpha=1.0, name=None):
    return x.copy_(elu(x, alpha))


def hardtanh_(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return x.copy_(hardtanh(x, min, max))


def leaky_relu_(x, negative_slope=0.01, name=None):
    return x.copy_(leaky_relu(x, negative_slope))


def thresholded_relu_(x, threshold=1.0, value=0.0, name=None):
    return x.copy_(thresholded_relu(x, threshold, value))

