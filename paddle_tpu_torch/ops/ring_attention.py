"""Ring attention: sequence-parallel (sep) attention over a group of ranks
(counterpart of ``paddle_tpu/ops/ring_attention.py``).

The reference runs the ring as a ``lax.scan`` of ``lax.ppermute`` steps
inside ``shard_map``, in plain ``jnp`` einsums with f32 accumulation: it
holds no Pallas kernel, and neither does the port, whose ring is plain
torch ops between the port's differentiable ``communication.ppermute``
steps. Each rank holds one block of the sequence; its q block attends to
every kv block as the blocks pass around the ring, and the blocks merge
with the streaming log-sum-exp recurrence (flash attention's merge across
blocks):

    m' = max(m, m_t);  l' = l·e^{m-m'} + l_t·e^{m_t-m'}
    acc' = acc·e^{m-m'} + out_t·e^{m_t-m'}

Causal uses the block-triangular rule: ring step t brings the kv block of
rank (r - t) mod P; a block ahead of the q block is skipped, one behind it
attended in full, the diagonal one under the causal mask.

The backward is autograd's through the ring: each step's k and v travel as
one stacked tensor, so a step is one ``ppermute`` (one
``batch_isend_irecv``) whose backward is the reversed ``ppermute`` that
carries the gradients of the passed kv blocks back to the rank that owns
them, and every rank runs those backwards in the same order.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["ring_attention", "sep_parallel_attention"]

_NEG = -1e30


def _block(qh, kh, vh, sc, diag: bool):
    """One q block against one kv block, in f32: ``(out_t, m_t, l_t)``
    unnormalised (``[B, H, Sq, D]``, ``[B, H, Sq]``, ``[B, H, Sq]``)."""
    s = torch.matmul(qh, kh.transpose(-1, -2)) * sc
    if diag:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG)
    m_t = s.amax(-1)
    p = torch.exp(s - m_t[..., None])
    if diag:
        p = p.masked_fill(s <= _NEG / 2, 0.0)
    return torch.matmul(p, vh), m_t, p.sum(-1)


class _Depend(torch.autograd.Function):
    """``x`` itself, made to depend on ``dep``: the backward hands ``dep`` a
    zero gradient. A causal rank skips the blocks ahead of its own, yet
    every ``ppermute`` of the ring must run its backward on every rank (a
    peer waits for its exchange): the last kv block is attached to the
    output this way, so the whole chain of exchanges is in the graph."""

    @staticmethod
    def forward(ctx, x, dep):
        ctx.like = (dep.shape, dep.dtype, dep.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        shape, dtype, device = ctx.like
        return dx, torch.zeros(shape, dtype=dtype, device=device)


def ring_attention(q, k, v, group=None, causal: bool = False,
                   scale: Optional[float] = None):
    """Sequence-sharded attention over ``group``'s ring (default: one
    rank). ``q``/``k``/``v``: this rank's blocks ``[B, S_local, H, D]``
    (paddle layout), rank r holding positions ``[r·S_local, (r+1)·S_local)``.
    Returns ``[B, S_local, H, D]`` in q's dtype."""
    from ..distributed.communication import ppermute

    p_size = 1 if group is None else group.nranks
    rank = 0 if group is None else group.rank
    d = q.shape[-1]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    qh = q.transpose(1, 2).float()
    ring = [(i, (i + 1) % p_size) for i in range(p_size)]
    kv = torch.stack([k, v])
    m = l = acc = None
    for t in range(p_size):
        if t:
            kv = ppermute(kv, ring, group=group)
        src = (rank - t) % p_size
        if causal and src > rank:
            continue  # a block ahead of ours: masked out entirely
        kh = kv[0].transpose(1, 2).float()
        vh = kv[1].transpose(1, 2).float()
        out_t, m_t, l_t = _block(qh, kh, vh, sc, causal and src == rank)
        if m is None:
            m, l, acc = m_t, l_t, out_t
            continue
        m_new = torch.maximum(m, m_t)
        a = torch.exp(m - m_new)
        b = torch.exp(m_t - m_new)
        l = l * a + l_t * b
        acc = acc * a[..., None] + out_t * b[..., None]
        m = m_new
    if causal and p_size > 1 and kv.requires_grad:
        acc = _Depend.apply(acc, kv)
    out = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _sep_group(group, axis_name: str):
    if group is not None:
        return group
    from ..distributed.fleet.base.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return None
    return hcg._group(axis_name)


def sep_parallel_attention(q, k, v, group=None, axis_name: str = "sep",
                           causal: bool = False,
                           scale: Optional[float] = None):
    """Attention on the whole sequence with the sequence split over the sep
    group (default: the hybrid topology's group named ``axis_name``).
    ``q``/``k``/``v``: the global ``[B, S, H, D]`` on every rank of the
    group. Each rank takes its block of the sequence, runs the ring and
    all-gathers the output, Megatron's way: the slice is ``_ScatterToMP``
    (its backward all-gathers the blocks' gradients) and the gather
    ``_GatherFromMP`` (its backward takes the rank's block), so the rest of
    the model computes the same values on every rank of the group and its
    gradients come out equal there with no further reduction. With no
    group, or one rank, it is the ring on one block: plain attention."""
    g = _sep_group(group, axis_name)
    if g is None or g.nranks <= 1:
        return ring_attention(q, k, v, None, causal, scale)
    from ..distributed.fleet.layers.mpu.mp_layers import (_GatherFromMP,
                                                          _ScatterToMP)

    if q.shape[1] % g.nranks:
        raise ValueError(f"sep_parallel_attention: sequence length "
                         f"{q.shape[1]} does not divide over {g.nranks} ranks")
    ql, kl, vl = (_ScatterToMP.apply(x, g, 1) for x in (q, k, v))
    return _GatherFromMP.apply(ring_attention(ql, kl, vl, g, causal, scale),
                               g, 1)
