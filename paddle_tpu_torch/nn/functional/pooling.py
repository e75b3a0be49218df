"""Pooling functionals (counterpart of
``paddle_tpu/nn/functional/pooling.py``).

The reference pools through ``lax.reduce_window``, an XLA op and not a TPU
kernel of the repo; the port pools through torch's pooling ops, as it
convolves through torch's convolutions. What the reference's windows are,
the port's are:

- **Padding.** A max pool is padded with the dtype's lowest value (minus
  infinity for floats) and an average pool with zeros, on any pad width.
  torch's own padding is used only where it means the same (symmetric
  pads of at most half the kernel, no ``ceil_mode``); otherwise the input
  is padded explicitly and pooled with none.
- **ceil_mode** extends the high pad so that the last partial window is
  pooled (``_pool_pads``), and keeps every window it makes: torch's
  ``ceil_mode`` drops a last window that starts in the padding.
- **Averages.** ``exclusive=True`` (the default) divides each window's sum
  by its count of input elements, ``exclusive=False`` by the kernel's
  size. ``divisor_override`` divides by itself (Paddle's meaning; the
  reference takes the argument and ignores it).
- **Masks.** ``return_mask`` gives each window's argmax as a flat index
  over the channel's unpadded spatial input (the first maximum in the
  window's row-major order wins a tie), which ``max_unpool*`` takes.
- **Adaptive bins** span ``[floor(j·in/out), ceil((j+1)·in/out))``, torch's
  adaptive bins too. The reference's adaptive max pools take
  ``return_mask`` and ignore it; the port's return the mask where asked.
- **Fractional** pools take the reference's bin edges from ``random_u``
  (Python's ``random.random()`` when it is None).
"""
from __future__ import annotations

import random as _pyrandom

import numpy as np
import torch
import torch.nn.functional as TF

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "max_pool1d", "max_pool2d", "max_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
    "lp_pool1d", "lp_pool2d", "max_unpool1d", "max_unpool2d", "max_unpool3d",
    "fractional_max_pool2d", "fractional_max_pool3d",
]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {2: TF.avg_pool2d, 3: TF.avg_pool3d}  # 1-d runs over a height of 1
_AMAX = {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d,
         3: TF.adaptive_max_pool3d}
_AAVG = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
         3: TF.adaptive_avg_pool3d}


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in (v if len(v) == n else list(v) * n)[:n])
    return (int(v),) * n


def _norm_pad(padding, n):
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


def _pool_pads(shape_sp, ks, st, pad, ceil_mode):
    """Per spatial axis (low, high) pads, the ceil-mode high extension
    included (the reference's geometry, shared with the masks)."""
    pads = [tuple(p) for p in pad]
    if ceil_mode:
        for i in range(len(pads)):
            size = shape_sp[i] + pads[i][0] + pads[i][1]
            rem = (size - ks[i]) % st[i]
            if rem:
                pads[i] = (pads[i][0], pads[i][1] + st[i] - rem)
    return pads


def _string_pads(padding, shape_sp, ks, st):
    """``"SAME"`` / ``"VALID"`` as (low, high) pairs, as XLA lays them."""
    if padding == "VALID":
        return [(0, 0)] * len(ks)
    if padding != "SAME":
        raise ValueError(f"bad padding {padding!r}")
    out = []
    for size, k, s in zip(shape_sp, ks, st):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        out.append((total // 2, total - total // 2))
    return out


def _lowest(dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return int(torch.iinfo(dtype).min)


def _to_channels_first(x, data_format):
    if data_format.startswith("NC"):
        return x, False
    return x.movedim(-1, 1), True


def _from_channels_first(x, moved):
    return x.movedim(1, -1) if moved else x


def _geometry(x, kernel, stride, padding, n, ceil_mode):
    """Kernel, stride and the (low, high) pads of the reference's windows
    over ``x`` (channels first)."""
    ks = _tuple(kernel, n)
    st = _tuple(stride if stride is not None else kernel, n)
    pad = _norm_pad(padding, n)
    shape_sp = tuple(x.shape[-n:])
    if isinstance(pad, str):
        return ks, st, _string_pads(pad, shape_sp, ks, st)
    return ks, st, _pool_pads(shape_sp, ks, st, pad, ceil_mode)


def _torch_pads(ks, pads):
    """torch's symmetric ``padding`` where it pools the same windows as
    explicit pads would (at most half the kernel), else None."""
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ks)):
        return tuple(lo for lo, _ in pads)
    return None


def _flat_pad(pads):
    """(low, high) pairs, first spatial axis first -> ``F.pad``'s order."""
    return [v for lo_hi in reversed(pads) for v in lo_hi]


def _max_pool(x, kernel, stride, padding, n, return_mask, ceil_mode,
              data_format):
    x, moved = _to_channels_first(x, data_format)
    ks, st, pads = _geometry(x, kernel, stride, padding, n, ceil_mode)
    tpad = _torch_pads(ks, pads)
    if tpad is not None:
        res = _MAX[n](x, ks, st, tpad, return_indices=return_mask)
        if not return_mask:
            return _from_channels_first(res, moved)
        out, idx = res
    else:
        xp = TF.pad(x, _flat_pad(pads), value=_lowest(x.dtype))
        res = _MAX[n](xp, ks, st, 0, return_indices=return_mask)
        if not return_mask:
            return _from_channels_first(res, moved)
        out, idx = res
        idx = _unpad_index(idx, xp.shape[-n:], x.shape[-n:], pads)
    return (_from_channels_first(out, moved),
            _from_channels_first(idx.to(torch.int32), moved))


def _unpad_index(idx, padded_sp, sp, pads):
    """Flat indices over the padded spatial input -> over the unpadded."""
    out = torch.zeros_like(idx)
    rest = idx
    for axis in reversed(range(len(sp))):
        coord = rest % padded_sp[axis] - pads[axis][0]
        rest = rest // padded_sp[axis]
        out = out + coord * int(np.prod(sp[axis + 1:]))
    return out


def _avg_pool(x, kernel, stride, padding, n, ceil_mode, exclusive,
              divisor_override, data_format):
    x, moved = _to_channels_first(x, data_format)
    ks, st, pads = _geometry(x, kernel, stride, padding, n, ceil_mode)
    tpad = _torch_pads(ks, pads)
    if tpad is not None:
        out = _AVG[n](x, ks, st, tpad, count_include_pad=not exclusive,
                      divisor_override=divisor_override)
        return _from_channels_first(out, moved)
    xp = TF.pad(x, _flat_pad(pads))
    if divisor_override is not None:
        out = _AVG[n](xp, ks, st, 0, divisor_override=divisor_override)
    elif not exclusive:
        out = _AVG[n](xp, ks, st, 0)
    else:
        sums = _AVG[n](xp, ks, st, 0, divisor_override=1)
        ones = TF.pad(torch.ones((1, 1) + tuple(x.shape[-n:]),
                                 dtype=x.dtype, device=x.device),
                      _flat_pad(pads))
        counts = _AVG[n](ones, ks, st, 0, divisor_override=1)
        out = sums / counts
    return _from_channels_first(out, moved)


# -- max and average pools ----------------------------------------------------

def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _max_pool(x, kernel_size, stride, padding, 1, return_mask,
                     ceil_mode, "NCL")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, 2, return_mask,
                     ceil_mode, data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, 3, return_mask,
                     ceil_mode, data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    # over a height of 1: torch's 1-d average takes no divisor
    k = _tuple(kernel_size, 1)[0]
    s = _tuple(stride if stride is not None else kernel_size, 1)[0]
    pad = _norm_pad(padding, 1)
    pad = pad if isinstance(pad, str) else [(0, 0)] + list(pad)
    return _avg_pool(x.unsqueeze(-2), (1, k), (1, s), pad, 2, ceil_mode,
                     exclusive, None, "NCHW").squeeze(-2)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, 2, ceil_mode,
                     exclusive, divisor_override, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, 3, ceil_mode,
                     exclusive, divisor_override, data_format)


# -- adaptive pools -----------------------------------------------------------

def _out_sizes(output_size, n):
    if isinstance(output_size, int):
        return (output_size,) * n
    return tuple(None if o is None else int(o) for o in output_size)


def _adaptive(x, output_size, n, mode, data_format, return_mask=False):
    x, moved = _to_channels_first(x, data_format)
    size = _out_sizes(output_size, n)
    if mode == "avg":
        return _from_channels_first(_AAVG[n](x, size), moved)
    res = _AMAX[n](x, size, return_indices=return_mask)
    if not return_mask:
        return _from_channels_first(res, moved)
    out, idx = res
    return (_from_channels_first(out, moved),
            _from_channels_first(idx.to(torch.int32), moved))


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "max", "NCL", return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "max", "NCHW", return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "max", "NCDHW", return_mask)


# -- power-average pools ------------------------------------------------------

def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    """``(sum over the window of |x|^p)^(1/p)``, as the reference: an
    average of ``|x|^p`` over the whole kernel, times its size."""
    p = float(norm_type)
    pooled = avg_pool1d(x.abs() ** p, kernel_size, stride, padding,
                        exclusive=False, ceil_mode=ceil_mode)
    return (pooled * _tuple(kernel_size, 1)[0]) ** (1.0 / p)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    p = float(norm_type)
    pooled = avg_pool2d(x.abs() ** p, kernel_size, stride, padding,
                        ceil_mode=ceil_mode, exclusive=False)
    ks = _tuple(kernel_size, 2)
    return (pooled * (ks[0] * ks[1])) ** (1.0 / p)


# -- unpooling ----------------------------------------------------------------

def _unpool(x, indices, sizes):
    """Scatter each value of ``x`` ``[N, C, *out]`` to its flat index
    over ``sizes`` (the spatial output), zeros elsewhere. An index outside
    the output (a window that lay wholly in the padding) is dropped, as
    the reference's scatter drops it."""
    n, c = x.shape[0], x.shape[1]
    size = int(np.prod(sizes))
    idx = indices.reshape(n, c, -1).long()
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    out = torch.zeros((n, c, size + 1), dtype=x.dtype, device=x.device)
    out = out.scatter(2, idx, x.reshape(n, c, -1))
    return out[:, :, :size].reshape((n, c) + tuple(sizes))


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    """Inverse of ``max_pool1d(return_mask=True)``: values scatter back to
    their argmax positions."""
    k = _tuple(kernel_size, 1)[0]
    s = _tuple(stride if stride is not None else kernel_size, 1)[0]
    p = _tuple(padding, 1)[0]
    length = (output_size[-1] if output_size is not None
              else (x.shape[-1] - 1) * s + k - 2 * p)
    return _unpool(x, indices, (length,))


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    ks = _tuple(kernel_size, 2)
    st = _tuple(stride if stride is not None else kernel_size, 2)
    if output_size is not None:
        sizes = (output_size[-2], output_size[-1])
    else:
        # as the reference: only an int padding is taken off
        p = padding if isinstance(padding, int) else 0
        sizes = tuple((o - 1) * s + k - 2 * p
                      for o, s, k in zip(x.shape[-2:], st, ks))
    return _unpool(x, indices, sizes)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    """Inverse of ``max_pool3d(return_mask=True)``: values scatter to their
    flat (d·H·W + h·W + w) argmax positions."""
    if data_format != "NCDHW":
        raise ValueError("max_unpool3d supports NCDHW only")
    ks = _tuple(kernel_size, 3)
    st = _tuple(stride if stride is not None else kernel_size, 3)
    p = _tuple(padding, 3)
    if output_size is not None:
        sizes = tuple(output_size[-3:])
    else:
        sizes = tuple((o - 1) * s + k - 2 * q
                      for o, s, k, q in zip(x.shape[-3:], st, ks, p))
    return _unpool(x, indices, sizes)


# -- fractional max pools -----------------------------------------------------

def _fractional_bounds(in_size, out_size, u):
    """Fractional pooling bin edges (Graham 2014, the reference's
    formulation): bin i spans [ceil(a·(i+u))-1, ceil(a·(i+1+u))-1) with
    a = in/out, the first starting at 0 and the last ending at in."""
    a = in_size / out_size
    idx = np.arange(out_size + 1)
    b = np.ceil(a * (idx + u)).astype(np.int64) - 1
    b[0] = 0
    b[-1] = in_size
    return b


def _fractional(x, output_size, n, random_u, return_mask):
    u = random_u if random_u is not None else _pyrandom.random()
    outs = _out_sizes(output_size, n)
    sp = tuple(x.shape[-n:])
    edges = [_fractional_bounds(s, o, u) for s, o in zip(sp, outs)]
    lead = x.shape[:2]
    vals, masks = [], []
    for cell in np.ndindex(*outs):
        window = x[(Ellipsis,) + tuple(
            slice(int(e[i]), int(e[i + 1])) for e, i in zip(edges, cell))]
        wsp = window.shape[-n:]
        v, k = window.reshape(lead + (-1,)).max(-1)
        vals.append(v)
        if return_mask:
            flat = torch.zeros_like(k)
            for axis in range(n):
                inner = int(np.prod(wsp[axis + 1:]))
                coord = (k // inner) % wsp[axis] + int(edges[axis][cell[axis]])
                flat = flat * sp[axis] + coord
            masks.append(flat)
    out = torch.stack(vals, -1).reshape(lead + outs)
    if return_mask:
        return out, torch.stack(masks, -1).reshape(lead + outs)
    return out


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional(x, output_size, 2, random_u, return_mask)


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional(x, output_size, 3, random_u, return_mask)
