"""Flash attention (counterpart of ``paddle_tpu/ops/flash_attention.py``).

Three hand-written CUDA kernels: the forward ``ops/kernels/
flash_attention_fwd.cu`` (port of the TPU kernel ``_fwd_kernel``) and the
backward pair in ``ops/kernels/flash_attention_bwd.cu`` (ports of
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``); bf16/f16 run on the tensor
cores through TMA and ``wgmma``, warp-specialised (the backward at
head_dim 64 and 128), the rest on the CUDA cores; :func:`_fwd_variant` and
:func:`_bwd_variant` pick the kernels up front from dtype and head_dim.
The forward keeps an online softmax with f32 running max / denominator /
accumulator, skips causal key tiles above the diagonal (offset
``sk - sq``), reads GQA kv heads by ``h // group`` without repeating K/V,
masks with ``NEG_INF = -1e30`` (fully masked rows come out as zeros) and
leaves an f32 logsumexp residual ``[B, H, Sq]``. The backward recomputes
the probabilities from that residual; ``delta = sum(out * dO)`` is formed
in f32 outside the kernels, and the dK/dV kernel sums each GQA group's
query heads in f32 and casts once.

Public layout is paddle's ``[B, S, H, D]``; the kernels read and write it
through strides. :class:`FlashAttention` is the autograd seam in place of
the reference's ``custom_vjp``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import kernels

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_fwd_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "FlashAttention", "NEG_INF"]

NEG_INF = -1e30


def flash_attention_fwd_plain(q, k, v, causal: bool = False,
                              scale: Optional[float] = None, p_dtype=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same function in f32, in one
    block. q ``[B, Sq, H, D]``, k/v ``[B, Sk, Hkv, D]`` -> (out in q's
    dtype ``[B, Sq, H, D]``, lse f32 ``[B, H, Sq]``). ``p_dtype`` rounds
    the probabilities to that dtype before ``P @ V``, the 2-byte kernels'
    rounding point (the chip gates' reference, run on f32 q/k/v)."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qh = q.transpose(1, 2).float()
    kh = k.transpose(1, 2).float()
    vh = v.transpose(1, 2).float()
    group = qh.shape[1] // kh.shape[1]
    if group > 1:
        kh = kh.repeat_interleave(group, dim=1)
        vh = vh.repeat_interleave(group, dim=1)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * s  # [B, H, Sq, Sk]
    sq, sk = logits.shape[-2], logits.shape[-1]
    mask = None
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    out = torch.matmul(p, vh) / safe
    lse = (m + torch.log(safe))[..., 0]
    return out.transpose(1, 2).to(q.dtype), lse


def _check(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,Sq,H,D] and k/v [B,Sk,Hkv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")


def _vector_aligned(t: torch.Tensor) -> bool:
    return (t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in t.stride()[:3]))


FWD_VARIANTS = ("wgmma", "cuda_core")


def _fwd_variant(dtype, d: int) -> str:
    """Which forward kernel takes ``dtype`` at head_dim ``d``, decided up
    front: 2-byte types on the tensor cores through TMA and ``wgmma``
    (``wgmma``), f32 on the CUDA cores (``cuda_core``). Raises for what no
    kernel takes."""
    if d not in kernels.HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {kernels.HEAD_DIMS}, "
                         f"got {d}")
    if dtype in (torch.bfloat16, torch.float16):
        return "wgmma"
    if dtype == torch.float32:
        return "cuda_core"
    raise ValueError(f"flash kernel takes f32/bf16/f16, got {dtype}")


@kernels.kernel_wrapper("flash_attention_fwd", FWD_VARIANTS)
def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: (out ``[B, Sq, H, D]``, lse f32 ``[B, H, Sq]``).
    CPU tensors take :func:`flash_attention_fwd_plain`; CUDA tensors launch
    the variant's kernel or raise."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    variant = _fwd_variant(q.dtype, d)
    code = kernels.dtype_code("flash_attention_fwd", q.dtype)
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError("flash kernel needs a unit stride on head_dim")
    if q.element_size() == 2:
        # TMA needs a 16-byte aligned base and 16-byte multiple strides
        q, k, v = (t if _vector_aligned(t)
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    lib = kernels.load("flash_attention_fwd")
    launch = (lib.flash_attention_fwd_wgmma_launch if variant == "wgmma"
              else lib.flash_attention_fwd_launch)
    err = launch(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, hkv, sq, sk, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        float(s), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch("flash_attention_fwd", err)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.variant_launches[variant] += 1
    return out, lse


def _bwd_plain_heads(q, k, v, do, lse, delta, causal: bool, scale: float,
                     p_dtype=None):
    """The backward in f32, one block, with dK/dV per query head: q/do
    ``[B, Sq, H, D]``, k/v ``[B, Sk, Hkv, D]``, lse/delta f32 ``[B, H, Sq]``
    -> f32 (dq ``[B, Sq, H, D]``, dk, dv ``[B, Sk, H, D]``). ``p_dtype``
    rounds P to that dtype before ``P^T @ dO`` and dS before ``dS @ K`` and
    ``dS^T @ Q``, the TPU kernels' rounding points."""
    qh = q.transpose(1, 2).float()
    kh = k.transpose(1, 2).float()
    vh = v.transpose(1, 2).float()
    doh = do.transpose(1, 2).float()
    group = qh.shape[1] // kh.shape[1]
    if group > 1:
        kh = kh.repeat_interleave(group, dim=1)
        vh = vh.repeat_interleave(group, dim=1)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale  # [B, H, Sq, Sk]
    mask = None
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        # fully masked rows have lse == NEG_INF -> exp(0) == 1: zero them
        p = p.masked_fill(~mask, 0.0)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    if p_dtype is not None:
        p, ds = p.to(p_dtype).float(), ds.to(p_dtype).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _delta(out, do) -> torch.Tensor:
    """``sum(out * dO)`` over head_dim in f32, ``[B, H, Sq]`` (the
    reference's :270, outside the kernels)."""
    return (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _sum_groups(d: torch.Tensor, hkv: int, dtype) -> torch.Tensor:
    """Per-query-head ``[B, Sk, H, D]`` -> ``[B, Sk, Hkv, D]`` in ``dtype``:
    each group summed in f32 and cast once (the reference sums its bf16
    per-head values, :372-373)."""
    b, sk, h, dd = d.shape
    if h == hkv:
        return d.to(dtype)
    return d.view(b, sk, hkv, h // hkv, dd).float().sum(3).to(dtype)


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal: bool = False,
                              scale: Optional[float] = None, p_dtype=None):
    """Plain PyTorch version of the backward kernels: the same function in
    f32, in one block. q/out/do ``[B, Sq, H, D]``, k/v ``[B, Sk, Hkv, D]``,
    lse f32 ``[B, H, Sq]`` -> (dq, dk, dv) in q's, k's and v's dtypes. P and
    dS stay f32 here where the kernels round them to the input dtype, unless
    ``p_dtype`` names that dtype (run on f32 inputs, the chip gates'
    reference)."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    dq, dk, dv = _bwd_plain_heads(q, k, v, do, lse, _delta(out, do), causal, s,
                                  p_dtype)
    hkv = k.shape[2]
    return dq.to(q.dtype), _sum_groups(dk, hkv, k.dtype), _sum_groups(dv, hkv, v.dtype)


BWD_VARIANTS = ("wgmma", "cuda_core")


def _bwd_variant(dtype, d: int) -> str:
    """Which backward kernels take ``dtype`` at head_dim ``d``, decided up
    front: 2-byte types at head_dim 64 and 128 on the tensor cores through
    TMA and ``wgmma`` (``wgmma``), f32 and head_dim 256 (whose dK + dV
    accumulators do not fit a warpgroup's registers) on the CUDA cores
    (``cuda_core``). Raises for what no kernel takes."""
    if d not in kernels.HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {kernels.HEAD_DIMS}, "
                         f"got {d}")
    if dtype in (torch.bfloat16, torch.float16):
        return "wgmma" if d <= 128 else "cuda_core"
    if dtype == torch.float32:
        return "cuda_core"
    raise ValueError(f"flash kernel takes f32/bf16/f16, got {dtype}")


def _strides(*ts) -> ctypes.Array:
    """(batch, seq, head) strides of each tensor, as the host array the
    backward launch functions read."""
    flat = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _bwd_inputs(name, q, k, v, do, lse, delta):
    """Checks shared by the two backward kernel wrappers; returns q, k, v,
    do made 16-byte aligned where the tensor-core kernels need it, and the
    variant (:func:`_bwd_variant`)."""
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{name}: dO {tuple(do.shape)} {do.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    b, sq, h, d = q.shape
    for t, what in ((lse, "lse"), (delta, "delta")):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be contiguous f32 "
                             f"[B, H, Sq] = {(b, h, sq)}")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    variant = _bwd_variant(q.dtype, d)
    for t in (q, k, v, do):
        if t.stride(3) != 1:
            raise ValueError("flash kernel needs a unit stride on head_dim")
    if q.element_size() == 2:
        q, k, v, do = (t if _vector_aligned(t)
                       else t.clone(memory_format=torch.contiguous_format)
                       for t in (q, k, v, do))
    return q, k, v, do, variant


@kernels.kernel_wrapper("flash_attention_bwd_dq", BWD_VARIANTS)
def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool,
                           scale: float) -> torch.Tensor:
    """Kernel wrapper: dQ ``[B, Sq, H, D]`` in q's dtype from q/do
    ``[B, Sq, H, D]``, k/v ``[B, Sk, Hkv, D]`` and f32 lse/delta
    ``[B, H, Sq]``. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return _bwd_plain_heads(q, k, v, do, lse, delta, causal, scale)[0].to(q.dtype)
    q, k, v, do, variant = _bwd_inputs("flash_attention_bwd_dq", q, k, v, do,
                                       lse, delta)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = kernels.load("flash_attention_bwd")
    launch = (lib.flash_attention_bwd_dq_wgmma_launch if variant == "wgmma"
              else lib.flash_attention_bwd_dq_launch)
    err = launch(
        kernels.dtype_code("flash_attention_bwd", q.dtype), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), None, b, h, hkv, sq, sk, d,
        _strides(q, k, v, do, dq, dq), float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch("flash_attention_bwd_dq", err)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.variant_launches[variant] += 1
    return dq


@kernels.kernel_wrapper("flash_attention_bwd_dkv", BWD_VARIANTS)
def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: (dK, dV) ``[B, Sk, Hkv, D]`` in the input dtype, each
    GQA group's query heads summed in f32 and cast once. CPU tensors take
    the plain version."""
    hkv = k.shape[2]
    if q.device.type == "cpu":
        _, dk, dv = _bwd_plain_heads(q, k, v, do, lse, delta, causal, scale)
        return _sum_groups(dk, hkv, k.dtype), _sum_groups(dv, hkv, v.dtype)
    q, k, v, do, variant = _bwd_inputs("flash_attention_bwd_dkv", q, k, v, do,
                                       lse, delta)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dk = torch.empty(b, sk, hkv, d, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    lib = kernels.load("flash_attention_bwd")
    launch = (lib.flash_attention_bwd_dkv_wgmma_launch if variant == "wgmma"
              else lib.flash_attention_bwd_dkv_launch)
    err = launch(
        kernels.dtype_code("flash_attention_bwd", q.dtype), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, hkv, sq, sk, d,
        _strides(q, k, v, do, dk, dv), float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch("flash_attention_bwd_dkv", err)
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.variant_launches[variant] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False,
                        scale: Optional[float] = None):
    """The reference's ``_fa_bwd``: (dq, dk, dv) in q's, k's and v's dtypes.
    CPU tensors take :func:`flash_attention_bwd_plain`; CUDA tensors launch
    the dQ and dK/dV kernels or raise."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal, scale)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    delta = _delta(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, s)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, s)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Autograd seam mirroring the reference's ``custom_vjp``: the forward
    kernel saves (q, k, v, out, lse); the backward runs the dQ and dK/dV
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, grad_out,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention on ``[B, S, H, D]``; GQA and causal masking."""
    return FlashAttention.apply(q, k, v, causal, scale)
