"""Fused AdamW (counterpart of ``paddle_tpu/ops/fused_adamw.py``).

The kernel is ``ops/kernels/fused_adamw.cu``, a hand-written CUDA port of
the TPU kernel ``_adamw_kernel``: one streamed pass per parameter that
reads p/g/m/v once and writes p/m/v once, in place, with f32 arithmetic in
the reference's op order (``_AdamBase._moments``, ``_adam_delta`` and the
AdamW decay factor). The scalar prologue ``(lr_t, eps_eff, decay_f, skip)``
is built here, on the parameter's device, with the reference's expressions
(:208-220); nothing reads a device value back to the host. With
``sr_salts`` (two uint32 salts in an int64 device tensor) the bf16
writeback is the lowbias32 stochastic rounding of
``_stochastic_round_bf16`` over each element's C-order flat index within
its parameter. ``skip`` (a device bool) is the found-inf veto: p, m and v
keep their bits.

The plain version :func:`fused_adamw_update_plain` is the same function
in plain torch ops, one op per reference op, so it matches the kernel bit
for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernels

__all__ = ["fused_adamw_update", "fused_adamw_update_plain",
           "stochastic_round_bf16", "adamw_scalars", "fused_adamw_hbm_bytes",
           "unfused_adamw_hbm_bytes"]

_M32 = 0xFFFFFFFF


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def fused_adamw_hbm_bytes(size: int, p_dtype, g_dtype, m_dtype) -> int:
    """The kernel's device-memory traffic: one pass that reads p/g/m/v and
    writes p/m/v."""
    pb, gb, mb = _itemsize(p_dtype), _itemsize(g_dtype), _itemsize(m_dtype)
    return size * (pb + gb + 2 * mb) + size * (pb + 2 * mb)


def unfused_adamw_hbm_bytes(size: int, p_dtype, g_dtype, m_dtype) -> int:
    """Op-boundary traffic of the unfused update, counted as the reference
    counts it: a moment pass (read g, m, v; write m', v'; four f32
    intermediates written and read back) and an update pass (read p, m',
    v'; write p'; three f32 intermediates)."""
    f32 = 4
    pb, gb, mb = _itemsize(p_dtype), _itemsize(g_dtype), _itemsize(m_dtype)
    moment = size * (gb + 2 * mb + 2 * mb + 4 * 2 * f32)
    update = size * (pb + 2 * mb + pb + 3 * 2 * f32)
    return moment + update


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for ``a`` in ``[0, 2**32)`` held as int64,
    without leaving int64's range (uint32 wrap-around multiplication)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def stochastic_round_bf16(x: torch.Tensor, salts: torch.Tensor) -> torch.Tensor:
    """The reference's ``_stochastic_round_bf16`` with its two salts given:
    add 16 hash bits below the bf16 cut of the f32 value and truncate;
    non-finite values pass through. ``salts``: int64 ``[2]`` holding two
    uint32 values, on x's device."""
    xf = x.float()
    u = xf.view(torch.int32).to(torch.int64) & _M32
    i = torch.arange(xf.numel(), dtype=torch.int64, device=x.device).view(x.shape)
    s0, s1 = salts[0], salts[1]
    b = (_mul32(i, 0x9E3779B9) + s0) & _M32
    b = _mul32(b ^ (b >> 16), 0x7FEB352D)
    b = _mul32(b ^ (b >> 15), 0x846CA68B)
    b = ((b ^ (b >> 16)) + s1) & _M32
    r = (u + (b & 0xFFFF)) & 0xFFFF0000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(xf), r, xf).to(torch.bfloat16)


def adamw_scalars(*, lr, epsilon: float, beta1_pow: torch.Tensor,
                  beta2_pow: torch.Tensor, weight_decay: float = 0.0,
                  skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scalar prologue ``(lr_t, eps_eff, decay_f, skip)`` as an f32
    ``[4]`` tensor on the beta powers' device, from the reference's
    expressions: ``lr_t = lr * sqrt(1 - b2p) / (1 - b1p)`` and
    ``eps_eff = epsilon * sqrt(1 - b2p)`` in f32, ``decay_f`` rounded from
    the Python double ``1 - lr * weight_decay``."""
    b1p = beta1_pow.to(torch.float32)
    b2p = beta2_pow.to(torch.float32)
    dev = b1p.device
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    eps_eff = epsilon * torch.sqrt(1 - b2p)
    decay_f = torch.full((), 1.0 - lr * weight_decay, dtype=torch.float32,
                         device=dev)
    skip_f = (skip.to(device=dev, dtype=torch.float32) if skip is not None
              else torch.zeros((), dtype=torch.float32, device=dev))
    return torch.stack([lr_t.reshape(()), eps_eff.reshape(()), decay_f, skip_f])


def _check(p, g, m, v, sr_salts):
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"p/g/m/v shapes differ: {tuple(p.shape)}, "
                         f"{tuple(g.shape)}, {tuple(m.shape)}, {tuple(v.shape)}")
    if m.dtype != v.dtype:
        raise ValueError(f"m and v dtypes differ: {m.dtype}, {v.dtype}")
    if not (p.device == g.device == m.device == v.device):
        raise ValueError("p, g, m and v must lie on one device")
    if sr_salts is not None and p.dtype != torch.bfloat16:
        raise ValueError("stochastic-rounding writeback requires a bf16 param "
                         f"(got {p.dtype})")


def _update_plain(p, g, m, v, scalars, salts, beta1: float, beta2: float):
    """The kernel's arithmetic in plain torch ops, in place on p, m, v."""
    lr_t, eps_eff, decay_f = scalars[0], scalars[1], scalars[2]
    skip = scalars[3] != 0
    g32 = g.float()
    m_new = beta1 * m.float() + (1 - beta1) * g32
    v_new = beta2 * v.float() + (1 - beta2) * g32 * g32
    new = p.float() * decay_f - lr_t * m_new / (torch.sqrt(v_new) + eps_eff)
    out = (stochastic_round_bf16(new, salts) if salts is not None
           else new.to(p.dtype))
    # found-inf veto: select the original bits before anything lands
    p.copy_(torch.where(skip, p, out))
    m.copy_(torch.where(skip, m, m_new.to(m.dtype)))
    v.copy_(torch.where(skip, v, v_new.to(v.dtype)))


def fused_adamw_update_plain(p, g, m, v, *, lr, beta1: float, beta2: float,
                             epsilon: float, beta1_pow, beta2_pow,
                             weight_decay: float = 0.0, sr_salts=None,
                             skip=None):
    """Plain PyTorch version of :func:`fused_adamw_update`: the same
    arguments, the same in-place result, bit for bit."""
    _check(p, g, m, v, sr_salts)
    if p.numel():
        scalars = adamw_scalars(lr=lr, epsilon=epsilon, beta1_pow=beta1_pow,
                                beta2_pow=beta2_pow, weight_decay=weight_decay,
                                skip=skip)
        _update_plain(p, g, m, v, scalars, sr_salts, beta1, beta2)
    return p, m, v


@kernels.kernel_wrapper("fused_adamw")
def fused_adamw_update(p, g, m, v, *, lr, beta1: float, beta2: float,
                       epsilon: float, beta1_pow, beta2_pow,
                       weight_decay: float = 0.0, sr_salts=None, skip=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused AdamW step over one parameter, in place on p, m and v.

    p/g/m/v: one shape (m/v may store a narrower dtype); ``beta1_pow`` /
    ``beta2_pow``: the already-advanced f32 beta powers of this step, as
    device tensors; ``sr_salts``: int64 ``[2]`` (two uint32 salts) for the
    stochastic-rounding bf16 writeback (bf16 param only); ``skip``: a
    device bool, the found-inf veto. Returns ``(p, m, v)``. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    _check(p, g, m, v, sr_salts)
    if p.numel() == 0:
        return p, m, v
    scalars = adamw_scalars(lr=lr, epsilon=epsilon, beta1_pow=beta1_pow,
                            beta2_pow=beta2_pow, weight_decay=weight_decay,
                            skip=skip)
    if p.device.type == "cpu":
        _update_plain(p, g, m, v, scalars, sr_salts, beta1, beta2)
        return p, m, v
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw_update: unsupported device {p.device}")
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if p.dtype not in codes or g.dtype not in codes or m.dtype not in codes:
        raise ValueError(f"fused AdamW kernel takes f32/bf16 p, g, m, v; got "
                         f"{p.dtype}, {g.dtype}, {m.dtype}")
    if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused AdamW kernel updates p, m and v in place: "
                         "they must be contiguous")
    g = g.contiguous()
    salts = sr_salts
    if salts is not None and (salts.dtype != torch.int64 or salts.numel() != 2
                              or salts.device != p.device
                              or not salts.is_contiguous()):
        raise ValueError("sr_salts must be a contiguous int64 [2] tensor on "
                         "the param's device")
    err = kernels.load("fused_adamw").fused_adamw_launch(
        codes[p.dtype], codes[g.dtype], codes[m.dtype], int(salts is not None),
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        scalars.data_ptr(), None if salts is None else salts.data_ptr(),
        p.numel(), float(beta1), float(1 - beta1), float(beta2),
        float(1 - beta2), torch.cuda.current_stream(p.device).cuda_stream)
    kernels.check_launch("fused_adamw", err)
    fused_adamw_update.launches += 1
    return p, m, v
