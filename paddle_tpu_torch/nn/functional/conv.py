"""Convolutions (counterpart of ``paddle_tpu/nn/functional/conv.py``).

Over ``torch.nn.functional.conv{1,2,3}d`` and ``conv_transpose{1,2,3}d``,
as the reference is over ``lax.conv_general_dilated``: a convolution is a
library call on both sides, not a kernel of the port. Paddle's weight
layouts are torch's (``[out, in / groups, *k]``; transposed ``[in, out /
groups, *k]``), so nothing is transposed. Paddle's padding forms (an int,
one per spatial axis, a (low, high) pair per axis, ``"SAME"`` /
``"VALID"``) become explicit low/high pads; an uneven pair is applied with
``F.pad`` (or, transposed, as a crop of the full output).

**f32 precision.** The reference runs f32 convolutions at
``Precision.HIGHEST``. cuDNN may run an f32 convolution on TF32 tensor
cores when ``torch.backends.cudnn.allow_tf32`` is True (torch's default),
which rounds the operands to 10 mantissa bits. The port does not depend on
that global: every f32 convolution here runs with TF32 off, whatever the
flag says outside the call.
2-byte inputs run at the tensor cores' native precision, as the
reference's MXU-native path does.
"""
from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch
import torch.nn.functional as TF

from ...base.amp_state import amp_cast

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tuple(v, n) -> Tuple[int, ...]:
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return (int(v[0]),) * n
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _norm_padding(padding, n):
    """Paddle padding -> ``"SAME"`` / ``"VALID"`` or ``n`` (low, high)
    pairs: an int, ``n`` ints, ``2n`` ints (low, high per axis), or pairs
    (the last ``n`` kept, as batch and channel pairs may lead)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if padding and isinstance(padding[0], (list, tuple)):
        return [tuple(int(x) for x in p) for p in padding][-n:]
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"bad padding {padding!r}")


def _same_pads(sizes, kernel, strides, dilations) -> List[Tuple[int, int]]:
    """XLA's ``"SAME"``: the output ``ceil(size / stride)``, the total pad
    split with the smaller half first."""
    pads = []
    for size, k, s, d in zip(sizes, kernel, strides, dilations):
        out = -(-size // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


@contextlib.contextmanager
def _precision(x: torch.Tensor):
    """TF32 off for an f32 convolution on the card, for the call only (the
    reference's ``Precision.HIGHEST``)."""
    if x.dtype != torch.float32 or x.device.type != "cuda":
        yield
        return
    b = torch.backends.cudnn
    with b.flags(enabled=b.enabled, benchmark=b.benchmark,
                 deterministic=b.deterministic,
                 allow_tf32=False):
        yield


def _channels_first(data_format: str) -> bool:
    return data_format.startswith("NC")


def _to_ncx(x, cf):
    return x if cf else torch.movedim(x, -1, 1)


def _from_ncx(x, cf):
    return x if cf else torch.movedim(x, 1, -1)


def _torch_pad(pairs) -> List[int]:
    """(low, high) per spatial axis, first axis first -> ``F.pad``'s list
    (last axis first)."""
    out = []
    for lo, hi in reversed(pairs):
        out += [lo, hi]
    return out


def _conv_nd(x, weight, bias, stride, padding, dilation, groups,
             data_format, n, name):
    x, weight, bias = amp_cast(name, x, weight, bias)
    strides, dilations = _tuple(stride, n), _tuple(dilation, n)
    cf = _channels_first(data_format)
    a = _to_ncx(x, cf)
    pad = _norm_padding(padding, n)
    if pad == "VALID":
        pad = [(0, 0)] * n
    elif pad == "SAME":
        pad = _same_pads(a.shape[2:], weight.shape[2:], strides, dilations)
    if all(lo == hi for lo, hi in pad):
        conv_pad = tuple(lo for lo, _ in pad)
    else:
        a = TF.pad(a, _torch_pad(pad))
        conv_pad = (0,) * n
    with _precision(a):
        out = _CONV[n](a, weight, bias, strides, conv_pad, dilations, groups)
    return _from_ncx(out, cf)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    fmt = "NCH" if data_format in ("NCL", "NCH") else "NHC"
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, fmt,
                    1, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 2, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 3, "conv3d")


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, data_format, n, name):
    """The reference's lhs-dilated convolution with padding ``(d(k-1) -
    lo, d(k-1) - hi + output_padding)`` per axis (``"SAME"`` / ``"VALID"``
    as XLA pads the undilated input at stride 1), as the full transposed
    output (``conv_transpose`` with no padding) cropped by ``d(k-1) - pad``
    at each end, or zero-extended where that is negative; the bias is
    added after."""
    x, weight, bias = amp_cast(name, x, weight, bias)
    strides, dilations = _tuple(stride, n), _tuple(dilation, n)
    out_pad = (_tuple(output_padding, n) if output_padding is not None
               else (0,) * n)
    cf = _channels_first(data_format)
    a = _to_ncx(x, cf)
    kernel = weight.shape[2:]
    pad = _norm_padding(padding, n)
    if isinstance(pad, str):
        # XLA pads the undilated input as a stride-1 convolution would
        eff = [d * (k - 1) for k, d in zip(kernel, dilations)]
        lax_pads = ([(0, 0)] * n if pad == "VALID" else
                    _same_pads(a.shape[2:], kernel, (1,) * n, dilations))
        crop = [(e - lo, e - hi) for e, (lo, hi) in zip(eff, lax_pads)]
    else:
        crop = [(lo, hi - op) for (lo, hi), op in zip(pad, out_pad)]
    with _precision(a):
        # the lhs-dilated input padded by d (k - 1) on both sides
        full = _CONV_T[n](a, weight, None, strides, 0, 0, groups, dilations)
    sl = [slice(None), slice(None)]
    grow = []
    for i, (lo, hi) in enumerate(crop):
        size = full.shape[2 + i]
        sl.append(slice(max(lo, 0), size - max(hi, 0)))
        grow.append((max(-lo, 0), max(-hi, 0)))
    out = full[tuple(sl)]
    if any(g != (0, 0) for g in grow):
        out = TF.pad(out, _torch_pad(grow))
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * n)
    return _from_ncx(out, cf)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    fmt = "NCH" if data_format in ("NCL", "NCH") else "NHC"
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, fmt, 1,
                              "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, data_format,
                              2, "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, data_format,
                              3, "conv3d_transpose")
