"""Attention functionals (counterpart of ``paddle_tpu/nn/functional/attention.py``).

One public entry, :func:`scaled_dot_product_attention`, on paddle's
``[batch, seq, heads, head_dim]`` layout. It dispatches to the hand-written
flash-attention forward kernel (``ops/flash_attention.py``) when the
tensors lie on the CUDA card and the shape qualifies, and to
:func:`_naive_attention` otherwise. The dispatch is decided up front from
the shapes, the device and the dropout rate; nothing is tried and then
abandoned.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...base.amp_state import amp_cast
from ...ops.kernels import HEAD_DIMS

__all__ = ["scaled_dot_product_attention"]


def _naive_attention(q, k, v, mask: Optional[torch.Tensor], causal: bool,
                     scale: Optional[float] = None, dropout_p: float = 0.0,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Plain path; q/k/v ``[B, S, H, D]``. GQA by repeating kv heads,
    logits in q's dtype then f32, ``-inf`` masking, softmax cast back to
    q's dtype, then (``dropout_p > 0``) each probability kept with
    probability ``1 - dropout_p`` and scaled by ``1 / (1 - dropout_p)`` in
    q's dtype, the keep mask drawn from ``generator`` — the reference's op
    order."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, S, D]
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if kh.shape[1] != qh.shape[1]:
        rep = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    logits = (torch.matmul(qh, kh.transpose(-1, -2)) * s).float()
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~cm, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0:
        keep = torch.rand(probs.shape, dtype=torch.float32, device=q.device,
                          generator=generator) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype, device=q.device))
    return torch.matmul(probs, vh).transpose(1, 2)


def _use_flash(q: torch.Tensor, mask, dropout_p: float) -> bool:
    """The reference's ``_use_pallas`` gate with the CUDA card in place of
    the TPU: no mask, no dropout, head_dim in {64, 128, 256}, seq % 128.
    The flash path is differentiable (forward and backward kernels), so
    training and inference take it alike."""
    if mask is not None or dropout_p > 0 or q.device.type != "cuda":
        return False
    return q.shape[-1] in HEAD_DIMS and q.shape[1] % 128 == 0


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True) -> torch.Tensor:
    """Input layout ``[B, S, H, D]``; kv heads may divide q heads (GQA).
    Dropout on the attention probabilities (``training`` only) takes the
    plain path, as in the reference, with its keep mask from the port's
    seeded generator of the query's device (``base.random``); at
    ``dropout_p == 0`` nothing is drawn."""
    if not training:
        dropout_p = 0.0
    query, key, value, attn_mask = amp_cast(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    if _use_flash(query, attn_mask, dropout_p):
        from ...ops.flash_attention import flash_attention

        return flash_attention(query, key, value, is_causal)
    gen = None
    if dropout_p > 0:
        from ...base.random import get_generator

        gen = get_generator(query.device)
    return _naive_attention(query, key, value, attn_mask, is_causal,
                            dropout_p=dropout_p, generator=gen)
