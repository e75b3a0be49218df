"""Greedy autoregressive generation with KV caches (counterpart of
``paddle_tpu/models/generation.py``).

Dense caches are ``[B, max_len, Hkv, D]`` pairs updated in place; paged
caches use the contiguous block-table layout (``block_size=``).
``decode_chunk=K`` runs K decode steps per host round trip with the
current token and the eos-finished mask kept on the device, in place of
the reference's ``lax.scan``. Sampling arrives with a later slice: JAX's
and torch's random streams never match, so only greedy decoding has a
parity contract.
"""
from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["alloc_kv_caches", "update_kv_cache", "generate"]


def alloc_kv_caches(num_layers, batch, max_len, num_kv_heads, head_dim, dtype,
                    device):
    shape = (batch, max_len, num_kv_heads, head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(num_layers)]


def update_kv_cache(kk, vv, kc, vc, cl, s: int):
    """Write the new ``[B, s, H, D]`` block at position ``cl`` (in place;
    the start is clamped so the block fits, as ``dynamic_update_slice``
    does) and return ``(k_cache, v_cache, mask)`` with the ``[1, 1, s,
    max_len]`` mask letting query i see keys ``<= cl + i``."""
    max_len = kc.shape[1]
    cl = int(cl)
    start = max(0, min(cl, max_len - s))
    kc[:, start:start + s] = kk.to(kc.dtype)
    vc[:, start:start + s] = vv.to(vc.dtype)
    k_idx = torch.arange(max_len, device=kk.device)[None, :]
    q_idx = cl + torch.arange(s, device=kk.device)[:, None]
    return kc, vc, (k_idx <= q_idx)[None, None]


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def generate(model, input_ids, max_new_tokens: int = 32,
             temperature: float = 0.0, eos_token_id: Optional[int] = None,
             block_size: Optional[int] = None,
             decode_chunk: Optional[int] = None,
             kv_dtype: Optional[str] = None) -> torch.Tensor:
    """Greedy continuation of ``input_ids`` ([B, S] int tensor on the
    model's device); returns ``[B, S + max_new_tokens]`` ids. Rows that
    emit ``eos_token_id`` repeat it thereafter. ``kv_dtype="int8"``
    (requires ``block_size``) quantizes the KV pools."""
    if temperature != 0:
        raise NotImplementedError(
            "sampling arrives with a later slice; the port decodes greedily")
    b, s = input_ids.shape
    if max_new_tokens <= 0:
        return input_ids
    max_len = s + max_new_tokens
    limit = getattr(getattr(model, "config", None), "max_position_embeddings", None)
    if limit is not None and max_len > limit:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) = {max_len} "
            f"exceeds the model's max_position_embeddings ({limit})")
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            caches = model.init_cache(b, max_len, block_size=block_size,
                                      kv_dtype=kv_dtype)
            logits, caches = model.forward_with_cache(input_ids, caches, 0)
            tok = _greedy(logits[:, -1])
            out: List[torch.Tensor] = [tok]
            finished = torch.zeros(b, dtype=torch.bool, device=tok.device)
            chunk = max(1, int(decode_chunk or 1))
            done = 1
            while done < max_new_tokens:
                k = min(chunk, max_new_tokens - done)
                for _ in range(k):  # tokens and eos state stay on the device
                    logits, caches = model.forward_with_cache(
                        tok.reshape(b, 1), caches, s + done - 1)
                    nxt = _greedy(logits[:, -1])
                    if eos_token_id is not None:
                        finished = finished | (tok == eos_token_id)
                        nxt = torch.where(finished, torch.full_like(nxt, eos_token_id), nxt)
                    tok = nxt
                    out.append(tok)
                    done += 1
                if (eos_token_id is not None and chunk > 1
                        and bool((finished | (tok == eos_token_id)).all())):
                    # every row finished: the rest is frozen eos
                    out.extend([tok] * (max_new_tokens - done))
                    break
            new = torch.stack(out, dim=1).to(input_ids.dtype)
            return torch.cat([input_ids, new], dim=1)
    finally:
        if was_training:
            model.train()
