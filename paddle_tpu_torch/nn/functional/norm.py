"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``).

Each keeps the reference's op order: statistics in the input's dtype
(``rms_norm``'s in f32), ``(x - mean) / sqrt(var + eps)`` with the biased
variance, then the weight multiply and the bias add. ``batch_norm`` in
training also moves the running statistics in place, ``new = momentum *
old + (1 - momentum) * batch`` with the batch's biased variance.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...base.amp_state import amp_cast

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "local_response_norm", "rms_norm"]


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def _normalize(x, axes, eps):
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6, axis: int = -1) -> torch.Tensor:
    """Stats in f32 even for bf16 inputs, ``rsqrt(ms + eps)``, cast back to
    ``x``'s dtype, then the weight multiply — the reference's op order."""
    x, weight = amp_cast("rms_norm", x, weight)
    xf = x.float()
    ms = xf.square().mean(dim=axis, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Over the trailing ``len(normalized_shape)`` axes."""
    x, weight, bias = amp_cast("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    n = len(tuple(normalized_shape))
    out = _normalize(x, tuple(range(x.dim() - n, x.dim())), epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def _channel_axis(ndim: int, channels_first: bool) -> int:
    return 1 if channels_first else ndim - 1


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Per channel; the running statistics when ``use_global_stats``
    (default: ``not training``), else the batch's, and then the running
    ones move in place."""
    x, weight, bias = amp_cast("batch_norm", x, weight, bias)
    if use_global_stats is None:
        use_global_stats = not training
    channels_first = data_format.startswith("NC") and data_format != "NC"
    ch = 1 if x.dim() == 2 else (0 if x.dim() < 2
                                  else _channel_axis(x.dim(), channels_first))
    axes = tuple(i for i in range(x.dim()) if i != ch)
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    if use_global_stats:
        out = ((x - running_mean.reshape(shape))
               / torch.sqrt(running_var.reshape(shape) + epsilon))
        return _affine(out, weight, bias, shape)
    mean = x.mean(dim=axes)
    var = x.var(dim=axes, unbiased=False)
    out = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + epsilon)
    with torch.no_grad():
        if running_mean is not None:
            running_mean.copy_(momentum * running_mean
                               + (1 - momentum) * mean.detach())
        if running_var is not None:
            running_var.copy_(momentum * running_var
                              + (1 - momentum) * var.detach())
    return _affine(out, weight, bias, shape)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Per sample and channel, over the spatial axes."""
    x, weight, bias = amp_cast("instance_norm", x, weight, bias)
    ch = _channel_axis(x.dim(), data_format.startswith("NC"))
    axes = tuple(i for i in range(x.dim()) if i not in (0, ch))
    out = _normalize(x, axes, eps)
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    return _affine(out, weight, bias, shape)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Channels split into ``num_groups`` contiguous groups; each sample's
    group normalized over its channels and spatial positions."""
    x, weight, bias = amp_cast("group_norm", x, weight, bias)
    channels_first = data_format.startswith("NC")
    if not channels_first:
        x = torch.movedim(x, -1, 1)
    n, c = x.shape[0], x.shape[1]
    spatial = tuple(x.shape[2:])
    g = x.reshape(n, num_groups, c // num_groups, *spatial)
    out = _normalize(g, tuple(range(2, g.dim())), epsilon).reshape(
        n, c, *spatial)
    out = _affine(out, weight, bias, [1, c] + [1] * len(spatial))
    return out if channels_first else torch.movedim(out, 1, -1)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * sum(x^2 over a window of `size` channels) /
    size) ** beta``, the window zero-padded ``size // 2`` before and the
    rest after."""
    x = amp_cast("local_response_norm", x)
    channels_first = data_format.startswith("NC")
    if not channels_first:
        x = torch.movedim(x, -1, 1)
    c = x.shape[1]
    half = size // 2
    sq = torch.nn.functional.pad(
        x.square().movedim(1, -1), (half, size - half - 1)).movedim(-1, 1)
    acc = sum(sq[:, i:i + c] for i in range(size))
    out = x / torch.pow(k + alpha * acc / size, beta)
    return out if channels_first else torch.movedim(out, 1, -1)
