"""Parameter initializers (counterpart of ``paddle_tpu/nn/initializer/``).

Each initializer is a callable ``init(shape, dtype=None, *, device=None,
generator=None) -> torch.Tensor`` that draws from an explicit
``torch.Generator`` (the device's global one when ``generator`` is None),
so a model built from one seeded generator is reproducible. Draws cannot
match the reference's threefry stream; fans, gains, bounds and the
distributions do.

Fans follow the reference's ``_compute_fans``: a 2-D weight is
``[fan_in, fan_out]`` (paddle's ``Linear`` stores ``[in, out]``), a
higher-rank one takes ``shape[1] * receptive`` as fan_in and ``shape[0] *
receptive`` as fan_out.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ...base.device import get_device
from ...base.dtype import to_torch_dtype

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "Bilinear", "calculate_gain",
    "set_global_initializer",
]


def _compute_fans(shape):
    if not shape:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    """The reference's table of recommended gains."""
    recommended = {
        "sigmoid": 1.0, "linear": 1.0,
        "conv1d": 1.0, "conv2d": 1.0, "conv3d": 1.0,
        "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0,
        "tanh": 5.0 / 3,
        "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    if nonlinearity not in recommended:
        raise ValueError(f"unsupported nonlinearity: {nonlinearity}")
    return recommended[nonlinearity]


class Initializer:
    def __call__(self, shape, dtype=None, *, device=None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dtype = (to_torch_dtype(dtype) if dtype is not None
                 else torch.get_default_dtype())
        return self._generate(tuple(int(s) for s in shape), dtype,
                              get_device(device), generator)

    def _generate(self, shape, dtype, device, generator):
        raise NotImplementedError


def _sample_dtype(dtype):
    """Floating draws in the target dtype, integer targets through f32
    (the reference's ``sample_dt``)."""
    return dtype if dtype.is_floating_point else torch.float32


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _generate(self, shape, dtype, device, generator):
        return torch.full(shape, self.value, dtype=dtype, device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _generate(self, shape, dtype, device, generator):
        out = torch.empty(shape, dtype=_sample_dtype(dtype), device=device)
        return out.normal_(self.mean, self.std, generator=generator).to(dtype)


class TruncatedNormal(Initializer):
    """Normal truncated to ``[mean + a*std, mean + b*std]``: a standard
    normal cut to ``[a, b]``, then scaled and shifted, as the reference
    draws it."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _generate(self, shape, dtype, device, generator):
        out = torch.empty(shape, dtype=_sample_dtype(dtype), device=device)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, self.a, self.b,
                                    generator=generator)
        return (self.mean + self.std * out).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def _generate(self, shape, dtype, device, generator):
        out = torch.empty(shape, dtype=_sample_dtype(dtype), device=device)
        return out.uniform_(self.low, self.high,
                            generator=generator).to(dtype)


class _Fans(Initializer):
    def _fans(self, shape):
        f_in, f_out = _compute_fans(shape)
        f_in = self.fan_in if self.fan_in is not None else f_in
        fan_out = getattr(self, "fan_out", None)
        f_out = fan_out if fan_out is not None else f_out
        return f_in, f_out


class XavierNormal(_Fans):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape, dtype, device, generator):
        f_in, f_out = self._fans(shape)
        std = self.gain * math.sqrt(2.0 / (f_in + f_out))
        return Normal(0.0, std)._generate(shape, dtype, device, generator)


class XavierUniform(_Fans):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape, dtype, device, generator):
        f_in, f_out = self._fans(shape)
        limit = self.gain * math.sqrt(6.0 / (f_in + f_out))
        return Uniform(-limit, limit)._generate(shape, dtype, device,
                                                generator)


class KaimingNormal(_Fans):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, shape, dtype, device, generator):
        f_in, _ = self._fans(shape)
        std = calculate_gain(self.nonlinearity,
                             self.negative_slope) / math.sqrt(f_in)
        return Normal(0.0, std)._generate(shape, dtype, device, generator)


class KaimingUniform(_Fans):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, shape, dtype, device, generator):
        f_in, _ = self._fans(shape)
        limit = calculate_gain(self.nonlinearity,
                               self.negative_slope) * math.sqrt(3.0 / f_in)
        return Uniform(-limit, limit)._generate(shape, dtype, device,
                                                generator)


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def _generate(self, shape, dtype, device, generator):
        v = self.value
        t = (v.detach() if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v)))
        return t.to(device=device, dtype=dtype).reshape(shape).clone()


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def _generate(self, shape, dtype, device, generator):
        if len(shape) < 2:
            raise ValueError("Orthogonal initializer needs >=2 dims")
        rows, cols = shape[0], int(np.prod(shape[1:]))
        flat = torch.empty(max(rows, cols), min(rows, cols),
                           dtype=torch.float32, device=device)
        flat.normal_(generator=generator)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        q = q.T if rows < cols else q
        return (self.gain * q[:rows, :cols]).reshape(shape).to(dtype)


class Dirac(Initializer):
    """Identity-preserving convolution kernel."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def _generate(self, shape, dtype, device, generator):
        if len(shape) < 3:
            raise ValueError("Dirac needs a conv kernel shape")
        out = torch.zeros(shape, dtype=dtype, device=device)
        per_group = shape[0] // self.groups
        mid = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(per_group, shape[1])):
                out[(g * per_group + i, i) + mid] = 1.0
        return out


class Bilinear(Initializer):
    """Bilinear-interpolation kernel for transposed-convolution upsampling:
    each ``[k, k]`` slice of the ``[C_out, C_in, k, k]`` weight is the tent
    filter."""

    def __init__(self, name=None):
        pass

    def _generate(self, shape, dtype, device, generator):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        k = shape[3]
        if shape[2] != k:
            raise ValueError("Bilinear initializer needs square kernels")
        f = int(np.ceil(k / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        tent = 1 - np.abs(np.arange(k) / f - c)
        filt = torch.from_numpy(np.outer(tent, tent).astype(np.float32))
        return filt.expand(shape).to(device=device, dtype=dtype).clone()


_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """Make ``weight_init`` / ``bias_init`` the defaults of every layer
    built after this call (``None`` restores the built-in ones)."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def _default_weight_init():
    return (_global_weight_init if _global_weight_init is not None
            else XavierUniform())


def _default_bias_init():
    return (_global_bias_init if _global_bias_init is not None
            else Constant(0.0))
