"""Fused AdamW (counterpart of ``paddle_tpu/ops/fused_adamw.py``).

The kernel is ``ops/kernels/fused_adamw.cu``, a hand-written CUDA port of
the TPU kernel ``_adamw_kernel``: one streamed pass that reads p/g/m/v once
and writes p/m/v once, in place, with f32 arithmetic in the reference's op
order (``_AdamBase._moments``, ``_adam_delta`` and the AdamW decay factor).
Where the reference calls the TPU kernel once per parameter, the port
launches it once for many: :func:`fused_adamw_multi_update` updates T
tensors that share the (p, g, m dtype, SR) types in one launch, each with
its own scalar row and salts, exactly as T calls of
:func:`fused_adamw_update` would. The scalar prologue ``(lr_t, eps_eff,
decay_f, skip)`` is built here, on the parameters' device, with the
reference's expressions (:208-220), for one tensor (:func:`adamw_scalars`)
or for T at once (:func:`adamw_scalars_multi`, bitwise the same rows);
nothing reads a device value back to the host. With SR salts (two uint32
salts per tensor in an int64 device tensor) the bf16 writeback is the
lowbias32 stochastic rounding of ``_stochastic_round_bf16`` over each
element's C-order flat index within its parameter, plus an optional base
per tensor (``sr_base``: a shard's offset in its whole tensor, so a shard
on dimension 0 draws the bits its elements draw unsharded). ``skip`` (a device
bool) is the found-inf veto: p, m and v keep their bits.

The plain versions :func:`fused_adamw_update_plain` and
:func:`fused_adamw_multi_update_plain` are the same functions in plain
torch ops, one op per reference op, so they match the kernel bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple, Union

import torch

from . import kernels

__all__ = ["fused_adamw_update", "fused_adamw_update_plain",
           "fused_adamw_multi_update", "fused_adamw_multi_update_plain",
           "stochastic_round_bf16", "adamw_scalars", "adamw_scalars_multi",
           "fused_adamw_hbm_bytes", "unfused_adamw_hbm_bytes"]

_M32 = 0xFFFFFFFF
# tensors one launch takes (the kernel's parameter table holds 512)
MAX_TENSORS_PER_LAUNCH = 512


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


def stochastic_round_bf16(x: torch.Tensor, salts: torch.Tensor,
                          base: int = 0) -> torch.Tensor:
    """The reference's ``_stochastic_round_bf16`` with its two salts given:
    add 16 hash bits below the bf16 cut of the f32 value and truncate;
    non-finite values pass through. ``salts``: int64 ``[2]`` holding two
    uint32 values, on x's device; ``base``: the flat index of x's first
    element (0 for a whole tensor)."""
    xf = x.float()
    u = xf.view(torch.int32).to(torch.int64) & _M32
    i = (torch.arange(xf.numel(), dtype=torch.int64, device=x.device)
         + int(base)).view(x.shape) & _M32
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


def _const_vector(values: Sequence[float], device) -> torch.Tensor:
    """Host floats as an f32 device vector made by fills (one per run of
    equal values), so no host memory is copied: sound inside a CUDA-graph
    capture."""
    runs = []
    for x in values:
        if runs and runs[-1][0] == x:
            runs[-1][1] += 1
        else:
            runs.append([x, 1])
    parts = [torch.full((n,), x, dtype=torch.float32, device=device)
             for x, n in runs]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _lr_vector(lr, t: int, device) -> torch.Tensor:
    """A device learning rate (one f32 scalar, or T of them) as ``[T]``."""
    if isinstance(lr, torch.Tensor):
        v = lr.to(device=device, dtype=torch.float32).reshape(-1)
        return v.expand(t) if v.numel() == 1 else v
    return torch.stack([x.to(device=device, dtype=torch.float32).reshape(())
                        if isinstance(x, torch.Tensor) else
                        torch.full((), float(x), dtype=torch.float32,
                                   device=device) for x in lr])


def adamw_scalars_multi(*, lr, epsilon: float, beta1_pow: torch.Tensor,
                        beta2_pow: torch.Tensor,
                        weight_decay: Union[float, Sequence[float]] = 0.0,
                        skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scalar rows of T tensors at once, as an f32 ``[T, 4]`` tensor on
    the beta powers' device: ``beta1_pow`` / ``beta2_pow`` are ``[T]``,
    ``weight_decay`` one Python float or one per tensor, ``skip`` one
    device bool for all. ``lr`` is one Python float or one per tensor: row
    t is then bitwise what :func:`adamw_scalars` gives for tensor t (the
    same f32 ops elementwise, ``lr`` rounded to f32 as a Python scalar
    operand is, ``decay_f`` rounded to f32 from the Python double; the two
    host vectors travel in one pinned copy, so the host does not wait for
    the card). ``lr`` may instead be a device tensor (one f32 scalar, or
    ``[T]``, or a list of device scalars), as under ``jit.to_static``'s
    capture: then ``decay_f = 1 - lr * weight_decay`` is formed in f32 on
    the device, as the reference's compiled step forms it, and nothing
    is copied from the host."""
    b1p = beta1_pow.to(torch.float32).reshape(-1)
    b2p = beta2_pow.to(torch.float32).reshape(-1)
    t = b1p.numel()
    dev = b1p.device
    wds = ([float(weight_decay)] * t if isinstance(weight_decay, (int, float))
           else [float(y) for y in weight_decay])
    on_device = isinstance(lr, torch.Tensor) or (
        not isinstance(lr, (int, float))
        and any(isinstance(x, torch.Tensor) for x in lr))
    if on_device:
        lr_v = _lr_vector(lr, t, dev)
        n_lr = lr_v.numel()
    else:
        lrs = [float(lr)] * t if isinstance(lr, (int, float)) else [
            float(y) for y in lr]
        n_lr = len(lrs)
    if not (n_lr == len(wds) == t == b2p.numel()):
        raise ValueError(f"adamw_scalars_multi: {t} beta powers, {n_lr} "
                         f"learning rates, {len(wds)} weight decays")
    if on_device:
        decay_f = (1 - lr_v * _const_vector(wds, dev) if any(wds)
                   else torch.ones(t, dtype=torch.float32, device=dev))
    else:
        host = torch.tensor([lrs, [1.0 - a * w for a, w in zip(lrs, wds)]],
                            dtype=torch.float32)
        if dev.type == "cuda":
            host = host.pin_memory()
        lr_v, decay_f = host.to(dev, non_blocking=True)
    root = torch.sqrt(1 - b2p)
    lr_t = lr_v * root / (1 - b1p)
    eps_eff = epsilon * root
    skip_f = (skip.to(device=dev, dtype=torch.float32).reshape(()).expand(t)
              if skip is not None else torch.zeros_like(lr_t))
    return torch.stack([lr_t, eps_eff, decay_f, skip_f], dim=1)


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


def _update_plain(p, g, m, v, scalars, salts, beta1: float, beta2: float,
                  base: int = 0):
    """The kernel's arithmetic in plain torch ops, in place on p, m, v."""
    lr_t, eps_eff, decay_f = scalars[0], scalars[1], scalars[2]
    skip = scalars[3] != 0
    g32 = g.float()
    m_new = beta1 * m.float() + (1 - beta1) * g32
    v_new = beta2 * v.float() + (1 - beta2) * g32 * g32
    new = p.float() * decay_f - lr_t * m_new / (torch.sqrt(v_new) + eps_eff)
    out = (stochastic_round_bf16(new, salts, base) if salts is not None
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


def fused_adamw_multi_update_plain(ps, gs, ms, vs, *, scalars: torch.Tensor,
                                   beta1: float, beta2: float,
                                   sr_salts: Optional[torch.Tensor] = None,
                                   sr_base: Optional[Sequence[int]] = None):
    """Plain PyTorch version of :func:`fused_adamw_multi_update`: the T
    per-tensor plain updates, each with its scalar row, salts and base."""
    _check_multi(ps, gs, ms, vs, scalars, sr_salts, sr_base)
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        if p.numel():
            salts = None if sr_salts is None else sr_salts[i]
            _update_plain(p, g, m, v, scalars[i], salts, beta1, beta2,
                          0 if sr_base is None else sr_base[i])
    return ps, ms, vs


def _check_multi(ps, gs, ms, vs, scalars, sr_salts, sr_base=None):
    t = len(ps)
    if sr_base is not None and len(sr_base) != t:
        raise ValueError(f"fused AdamW: {len(sr_base)} SR bases for {t} "
                         "tensors")
    if not (len(gs) == len(ms) == len(vs) == t):
        raise ValueError(f"fused AdamW: {len(ps)} params, {len(gs)} grads, "
                         f"{len(ms)} and {len(vs)} moments")
    for p, g, m, v in zip(ps, gs, ms, vs):
        _check(p, g, m, v, sr_salts)
    if tuple(scalars.shape) != (t, 4) or scalars.dtype != torch.float32:
        raise ValueError(f"fused AdamW: scalars must be f32 [{t}, 4], got "
                         f"{scalars.dtype} {tuple(scalars.shape)}")
    if sr_salts is not None and (tuple(sr_salts.shape) != (t, 2)
                                 or sr_salts.dtype != torch.int64):
        raise ValueError(f"fused AdamW: sr_salts must be int64 [{t}, 2], got "
                         f"{sr_salts.dtype} {tuple(sr_salts.shape)}")


_CODES = {torch.float32: 0, torch.bfloat16: 1}


@kernels.kernel_wrapper("fused_adamw")
def fused_adamw_multi_update(ps: List[torch.Tensor], gs: List[torch.Tensor],
                             ms: List[torch.Tensor], vs: List[torch.Tensor], *,
                             scalars: torch.Tensor, beta1: float, beta2: float,
                             sr_salts: Optional[torch.Tensor] = None,
                             sr_base: Optional[Sequence[int]] = None):
    """One fused AdamW step over T tensors, in place on each p, m and v.

    ``ps``/``gs``/``ms``/``vs``: T tensors each (p_i, g_i, m_i, v_i of one
    shape); every p one dtype, every g one, every m and v one (the kernel's
    instantiation). ``scalars``: the f32 ``[T, 4]`` rows of
    :func:`adamw_scalars_multi`; ``sr_salts``: int64 ``[T, 2]`` (two uint32
    salts per tensor) for the stochastic-rounding bf16 writeback (bf16
    params only); ``sr_base``: T ints, each tensor's flat-index base for
    that writeback (default 0). Tensor i gets exactly what
    :func:`fused_adamw_update` gives it with row i and salts i. One launch per call, or one per 512
    tensors. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    _check_multi(ps, gs, ms, vs, scalars, sr_salts, sr_base)
    if not ps:
        return ps, ms, vs
    dev = ps[0].device
    if dev.type == "cpu":
        return fused_adamw_multi_update_plain(ps, gs, ms, vs, scalars=scalars,
                                              beta1=beta1, beta2=beta2,
                                              sr_salts=sr_salts,
                                              sr_base=sr_base)
    if dev.type != "cuda":
        raise ValueError(f"fused_adamw_multi_update: unsupported device {dev}")
    types = {(p.dtype, g.dtype, m.dtype) for p, g, m in zip(ps, gs, ms)}
    if len(types) != 1:
        raise ValueError(f"fused AdamW kernel takes one (p, g, m) dtype "
                         f"triple per launch; got {sorted(map(str, types))}")
    p_dt, g_dt, m_dt = types.pop()
    if p_dt not in _CODES or g_dt not in _CODES or m_dt not in _CODES:
        raise ValueError(f"fused AdamW kernel takes f32/bf16 p, g, m, v; got "
                         f"{p_dt}, {g_dt}, {m_dt}")
    for t in (scalars, sr_salts):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError("fused AdamW: scalars and sr_salts must be "
                             "contiguous on the params' device")
    rows, keep = [], []  # keep: contiguous grads alive until launched
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        if p.device != dev:
            raise ValueError("fused AdamW: every tensor on one device")
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
            raise ValueError("fused AdamW kernel updates p, m and v in place: "
                             "they must be contiguous")
        if p.numel():
            g = g.contiguous()
            keep.append(g)
            rows.append((i, (p.data_ptr(), g.data_ptr(), m.data_ptr(),
                             v.data_ptr(), p.numel(),
                             0 if sr_base is None else int(sr_base[i]))))
    lib = kernels.load("fused_adamw")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo in range(0, len(rows), MAX_TENSORS_PER_LAUNCH):
        part = rows[lo:lo + MAX_TENSORS_PER_LAUNCH]
        idx = [i for i, _ in part]
        if idx != list(range(idx[0], idx[0] + len(idx))):
            # rows of empty tensors left out: gather the others' rows
            idx = torch.tensor(idx, device=dev)
        else:
            idx = slice(idx[0], idx[0] + len(idx))
        sc, sl = scalars[idx], None if sr_salts is None else sr_salts[idx]
        table = (ctypes.c_longlong * (6 * len(part)))(
            *(x for _, row in part for x in row))
        err = lib.fused_adamw_multi_launch(
            _CODES[p_dt], _CODES[g_dt], _CODES[m_dt], int(sl is not None),
            table, len(part), sc.data_ptr(),
            None if sl is None else sl.data_ptr(), float(beta1),
            float(1 - beta1), float(beta2), float(1 - beta2), stream)
        kernels.check_launch("fused_adamw", err)
        fused_adamw_multi_update.launches += 1
        if kernels.OBSERVERS:
            kernels.report("fused_adamw", *(ps[i] for i, _ in part))
    return ps, ms, vs


def fused_adamw_update(p, g, m, v, *, lr, beta1: float, beta2: float,
                       epsilon: float, beta1_pow, beta2_pow,
                       weight_decay: float = 0.0, sr_salts=None, skip=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused AdamW step over one parameter, in place on p, m and v.

    p/g/m/v: one shape (m/v may store a narrower dtype); ``beta1_pow`` /
    ``beta2_pow``: the already-advanced f32 beta powers of this step, as
    device tensors; ``sr_salts``: int64 ``[2]`` (two uint32 salts) for the
    stochastic-rounding bf16 writeback (bf16 param only); ``skip``: a
    device bool, the found-inf veto. Returns ``(p, m, v)``. The kernel's
    one-tensor launch (:func:`fused_adamw_multi_update` with T=1): CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check(p, g, m, v, sr_salts)
    if p.numel() == 0:
        return p, m, v
    if sr_salts is not None and (sr_salts.dtype != torch.int64
                                 or sr_salts.numel() != 2):
        raise ValueError("sr_salts must be an int64 [2] tensor")
    scalars = adamw_scalars(lr=lr, epsilon=epsilon, beta1_pow=beta1_pow,
                            beta2_pow=beta2_pow, weight_decay=weight_decay,
                            skip=skip)
    fused_adamw_multi_update(
        [p], [g], [m], [v], scalars=scalars.reshape(1, 4), beta1=beta1,
        beta2=beta2,
        sr_salts=None if sr_salts is None else sr_salts.reshape(1, 2))
    return p, m, v
