"""Common functionals (counterpart of ``paddle_tpu/nn/functional/common.py``):
``linear``, the dropouts, ``pad``, ``embedding``, ``one_hot``,
``interpolate``, ``normalize`` and the distances.

The dropouts draw their keep masks (f32 uniforms against ``1 - p``) from
``generator``, by default the port's seeded generator of the input's
device (``base/random.py``): the draws cannot match the reference's, the
keep rate, the scaling and the identity at ``p = 0`` and in eval mode do.

``interpolate`` keeps the reference's semantics, which are
``jax.image.resize``'s and not torch's defaults:

- ``"nearest"`` samples at half-pixel centres, ``floor((i + 0.5) * in /
  out)`` in f32 (torch's ``"nearest-exact"``, not its ``"nearest"``);
- ``"linear"`` / ``"bilinear"`` / ``"trilinear"`` and ``"bicubic"`` weigh
  the inputs with a triangle or a Keys cubic (``a = -0.5``) kernel at
  half-pixel centres, each output's weights renormalized over the inputs
  that exist, and, when downsampling, the kernel widened by ``in / out``
  (antialiasing); ``"area"`` is the antialiased linear resize;
- only ``align_corners=True`` with a bilinear 2-D resize takes the
  corner-aligned gather; otherwise ``align_corners`` is ignored.

Each resized axis is one contraction with an ``[in, out]`` weight matrix
(built in f32, cast to the input's dtype), in axis order.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF

from ...base.amp_state import amp_cast
from .activation import _gen

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout", "pad",
    "zeropad2d", "embedding", "one_hot", "interpolate", "upsample",
    "normalize", "cosine_similarity", "pairwise_distance",
]

_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def _keep(x, p, shape, generator):
    u = torch.empty(shape, dtype=torch.float32, device=x.device)
    return u.uniform_(generator=_gen(x, generator)) < 1.0 - p


def linear(x, weight, bias=None, name=None):
    """``x @ W (+ b)``, W ``[in_features, out_features]`` (paddle's
    layout)."""
    x, weight, bias = amp_cast("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator: Optional[torch.Generator] = None):
    """Elements (or, with ``axis``, whole slices along the other axes)
    kept with probability ``1 - p``: ``upscale_in_train`` scales the kept
    ones by ``1 / (1 - p)``; ``downscale_in_infer`` keeps them as they are
    and scales by ``1 - p`` in eval mode."""
    if isinstance(p, torch.Tensor):
        p = float(p.item())
    if not training or p == 0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if not 0 <= p <= 1:
        raise ValueError(f"dropout p must be in [0,1], got {p}")
    if p == 1:
        return torch.zeros_like(x)
    if axis is None:
        shape = tuple(x.shape)
    else:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = tuple(x.shape[i] if i in axes else 1 for i in range(x.dim()))
    keep = _keep(x, p, shape, generator)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero)
    return torch.where(keep, x, zero)


def _dropout_nd(x, p, training, data_format, n, generator):
    if not training or p == 0:
        return x
    if data_format.startswith("NC"):
        shape = tuple(x.shape[:2]) + (1,) * n
    else:
        shape = (x.shape[0],) + (1,) * n + (x.shape[-1],)
    keep = _keep(x, p, shape, generator)
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator: Optional[torch.Generator] = None):
    """Whole channels dropped, the kept scaled by ``1 / (1 - p)``."""
    return _dropout_nd(x, p, training, data_format, 2, generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator: Optional[torch.Generator] = None):
    return _dropout_nd(x, p, training, data_format, 3, generator)


def alpha_dropout(x, p=0.5, training=True, name=None,
                  generator: Optional[torch.Generator] = None):
    """SELU-preserving dropout: dropped elements set to SELU's negative
    saturation, then the affine correction that keeps mean and variance."""
    if not training or p == 0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * p * alpha_p
    keep = _keep(x, p, tuple(x.shape), generator)
    return a * torch.where(keep, x, torch.full_like(x, alpha_p)) + b


def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """Source index of each padded position along an axis of length ``n``
    (numpy's ``edge``, ``wrap`` and ``reflect``, any width)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return torch.remainder(i, n)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j < n, j, period - j)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",  # noqa: A002
        pad_from_left_axis=True, name=None):
    """``pad`` covers every axis (``2 * ndim`` values, (low, high) from the
    first axis, or from the last with ``pad_from_left_axis=False``) or only
    the spatial axes of ``data_format``, last spatial axis first."""
    if isinstance(pad, torch.Tensor):
        pad = pad.tolist()
    pad = [int(p) for p in pad]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"unsupported pad mode {mode!r}")
    x = amp_cast("pad", x)
    nd = x.dim()
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
        if not pad_from_left_axis:
            widths = widths[::-1]
    else:
        widths = [(0, 0)] * nd
        first = 2 if data_format.startswith("NC") else 1
        spatial = list(range(first, first + nd - 2))
        for i in range(len(pad) // 2):
            widths[spatial[-(i + 1)]] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = []
        for lo, hi in reversed(widths):
            flat += [lo, hi]
        return TF.pad(x, flat, mode="constant", value=value)
    for ax, (lo, hi) in enumerate(widths):
        if lo or hi:
            x = torch.index_select(
                x, ax, _pad_index(x.shape[ax], lo, hi, mode, x.device))
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def embedding(x, weight, padding_idx=None, sparse=False, max_norm=None,
              norm_type=2.0, name=None):
    """Rows of ``weight`` at ``x``; rows at ``padding_idx`` come out as
    zeros."""
    weight = amp_cast("embedding", weight)
    ids = x.long()
    out = weight[ids]
    if padding_idx is not None:
        pidx = padding_idx if padding_idx >= 0 else weight.shape[0] + padding_idx
        out = torch.where((ids == pidx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


def one_hot(x, num_classes, name=None):
    """f32 one-hot rows (``jax.nn.one_hot``): an id outside ``[0,
    num_classes)`` gives a row of zeros."""
    ids = x.long()
    cls = torch.arange(num_classes, device=x.device)
    return (ids[..., None] == cls).to(torch.float32)


def _triangle(x):
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_mat(n_in: int, n_out: int, kernel, device) -> torch.Tensor:
    """``jax.image``'s ``compute_weight_mat`` at scale ``out / in`` and no
    translation, antialiased: ``[n_in, n_out]`` f32."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_axis(x, axis: int, n_out: int, kernel) -> torch.Tensor:
    w = _weight_mat(x.shape[axis], n_out, kernel, x.device).to(x.dtype)
    return torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1, axis)


def _nearest_axis(x, axis: int, n_out: int) -> torch.Tensor:
    n_in = x.shape[axis]
    idx = ((torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5)
           * n_in / n_out).floor().long()
    return torch.index_select(x, axis, idx)


def _bilinear_align_corners(a, out_hw):
    """NCHW, the reference's corner-aligned gather."""
    h, w = a.shape[2], a.shape[3]
    oh, ow = out_hw
    dev = a.device
    ys = torch.linspace(0, h - 1, oh, device=dev)
    xs = torch.linspace(0, w - 1, ow, device=dev)
    y0 = ys.floor().long().clamp(0, h - 1)
    x0 = xs.floor().long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0).reshape(1, 1, -1, 1).to(a.dtype)
    wx = (xs - x0).reshape(1, 1, 1, -1).to(a.dtype)
    v00 = a[:, :, y0][:, :, :, x0]
    v01 = a[:, :, y0][:, :, :, x1]
    v10 = a[:, :, y1][:, :, :, x0]
    v11 = a[:, :, y1][:, :, :, x1]
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)


_METHODS = {"nearest": "nearest", "bilinear": "linear", "trilinear": "linear",
            "linear": "linear", "area": "linear", "bicubic": "cubic"}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes to ``size`` or ``floor(in * scale_factor)``
    by the reference's rules (module docstring)."""
    if mode not in _METHODS:
        raise ValueError(f"unsupported interpolate mode {mode!r}")
    if isinstance(size, torch.Tensor):
        size = size.tolist()
    x = amp_cast("interpolate", x)
    cf = data_format.startswith("NC")
    a = x if cf else torch.movedim(x, -1, 1)
    spatial = tuple(a.shape[2:])
    n = len(spatial)
    if size is not None:
        out = tuple(int(s) for s in (size if isinstance(size, (list, tuple))
                                     else [size]))
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * n)
        out = tuple(int(np.floor(s * f)) for s, f in zip(spatial, sf))
    method = _METHODS[mode]
    if mode != "nearest" and align_corners and n == 2 and method == "linear":
        a = _bilinear_align_corners(a, out)
    else:
        for i, (s_in, s_out) in enumerate(zip(spatial, out)):
            if s_in == s_out:
                continue
            if method == "nearest":
                a = _nearest_axis(a, 2 + i, s_out)
            else:
                a = _resize_axis(a, 2 + i, s_out, _triangle if method ==
                                 "linear" else _keys_cubic)
    return a if cf else torch.movedim(a, 1, -1)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format, name)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    x1, x2 = amp_cast("cosine_similarity", x1, x2)
    dot = (x1 * x2).sum(dim=axis)
    na = torch.sqrt((x1 * x1).sum(dim=axis))
    nb = torch.sqrt((x2 * x2).sum(dim=axis))
    return dot / torch.clamp(na * nb, min=eps)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    x = amp_cast("normalize", x)
    norm = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(norm, min=epsilon)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``sum(|x - y + epsilon| ** p) ** (1 / p)`` over the last axis."""
    x, y = amp_cast("pairwise_distance", x, y)
    d = x - y + epsilon
    return (d.abs() ** p).sum(dim=-1, keepdim=keepdim) ** (1.0 / p)
