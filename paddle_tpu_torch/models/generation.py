"""Autoregressive generation with KV caches (counterpart of
``paddle_tpu/models/generation.py``).

Dense caches are ``[B, max_len, Hkv, D]`` pairs updated in place; paged
caches use the contiguous block-table layout (``block_size=``). The caches,
the current token and the eos-finished mask are device buffers of a
cache state kept per signature on the model, and the prefill, decode and
(with ``speculative_k``) verify programs run over them. With ``use_jit``
(the default) each program is a ``jit.to_static`` function: on the card
the first call of a signature runs eagerly and the next ones replay a
captured CUDA graph; on the CPU they run eagerly. ``decode_chunk=K`` runs
K decode steps per host round trip through ``multi_step`` with the token
and the eos state kept on the device, in place of the reference's
``lax.scan``.

Sampling (``temperature > 0``, ``top_k``) draws from the port's seeded
generator of the logits' device (``base/random.py``), never from the
global one. JAX's threefry and torch's Philox streams never match, so only
greedy decoding has a token-parity contract with the reference; sampling
holds the reference's masking rule and its distribution.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

__all__ = ["alloc_kv_caches", "update_kv_cache", "generate"]


def alloc_kv_caches(num_layers, batch, max_len, num_kv_heads, head_dim, dtype,
                    device):
    shape = (batch, max_len, num_kv_heads, head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(num_layers)]


def update_kv_cache(kk, vv, kc, vc, cl, s: int):
    """Write the new ``[B, s, H, D]`` block at position ``cl`` (an int or
    a device scalar; in place, the start clamped so the block fits, as
    ``dynamic_update_slice`` does) and return ``(k_cache, v_cache, mask)``
    with the ``[1, 1, s, max_len]`` mask letting query i see keys ``<= cl +
    i``. No value comes back to the host, so the write can be captured."""
    max_len = kc.shape[1]
    dev = kk.device
    cl = torch.as_tensor(cl, device=dev).reshape(()).long()
    ar = torch.arange(s, device=dev)
    pos = torch.clamp(cl, 0, max_len - s) + ar
    kc.index_copy_(1, pos, kk.to(kc.dtype))
    vc.index_copy_(1, pos, vv.to(vc.dtype))
    k_idx = torch.arange(max_len, device=dev)[None, :]
    q_idx = cl + ar[:, None]
    return kc, vc, (k_idx <= q_idx)[None, None]


def _filter_logits(logits: torch.Tensor, temperature: float,
                   top_k: int) -> torch.Tensor:
    """The f32 logits a draw samples from: over the temperature, and with
    ``top_k > 0`` every value below the k-th largest set to ``-inf``."""
    lg = logits.float() / temperature
    if top_k > 0:
        k = min(int(top_k), lg.shape[-1])
        kth = torch.sort(lg, dim=-1).values[:, -k][:, None]
        lg = torch.where(lg < kth, torch.full_like(lg, float("-inf")), lg)
    return lg


def _sample(logits: torch.Tensor, temperature: float, top_k: int,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``[B, V]`` logits -> ``[B]`` int32 tokens; the argmax at temperature
    0. Otherwise the f32 logits over the temperature, with ``top_k > 0``
    masked by the reference's rule (``lg < kth`` -> ``-inf``, ``kth`` the
    k-th largest value: ties with it stay in), and one categorical draw
    per row from ``generator`` (default: the port's generator of the
    logits' device): ``argmax(p / e)`` with ``e ~ Exp(1)``, the draw
    ``torch.multinomial`` makes for one sample, without its host-side
    checks, so a captured step can take it."""
    if temperature == 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = _filter_logits(logits, temperature, top_k)
    if generator is None:
        from ..base.random import get_generator

        generator = get_generator(lg.device)
    probs = torch.softmax(lg, dim=-1)
    e = torch.empty_like(probs).exponential_(generator=generator)
    # masked entries (p == 0) are never drawn, whatever e is
    score = torch.where(probs > 0, probs / e, torch.full_like(probs, -1.0))
    return torch.argmax(score, dim=-1).to(torch.int32)


class _KVCacheState:
    """The caches of one signature and the decode loop's device state:
    the current token ``tok`` and the eos-finished mask ``finished``
    (``[B]`` each). Every buffer keeps its address for the state's life,
    so captured programs read and write them in place; :meth:`reset`
    zeroes them in place."""

    def __init__(self, model, batch, max_len, block_size=None,
                 kv_dtype=None):
        self.caches = model.init_cache(batch, max_len, block_size=block_size,
                                       kv_dtype=kv_dtype)
        dev = model.device
        self.tok = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.finished = torch.zeros(batch, dtype=torch.bool, device=dev)

    def _buffers(self):
        for c in self.caches:
            if isinstance(c, tuple) and not hasattr(c, "k_pool"):
                yield from c  # a dense (k, v) pair
            else:
                yield from (t for t in (c.k_pool, c.v_pool, c.k_scale,
                                        c.v_scale) if t is not None)
        yield self.tok
        yield self.finished

    def reset(self) -> None:
        for t in self._buffers():
            t.zero_()


def _get_compiled(model, b, s, max_len, temperature, top_k, use_jit,
                  block_size=None, chunked=False, eos_token_id=None,
                  kv_dtype=None, spec_k=None):
    """Build (or fetch) the cache state and the prefill/decode programs of
    this (batch, prompt length, max length, sampling, ...) signature.

    ``chunked=True`` builds a decode step that reads and writes the token
    and the eos-finished mask in the state's buffers instead of taking the
    token as an argument, so ``decode.multi_step`` runs K steps with no
    host round trip; eos joins the key. ``spec_k=K`` adds the speculative
    verify program (the cached step at width K+1 returning the argmax at
    every position) and the return grows to ``(state, prefill, decode,
    verify)``. With ``use_jit`` every program is a ``jit.to_static``
    function (``full_graph=True``: a step that cannot be captured raises).
    The store is an LRU of 4 signatures per model; a fetched entry's state
    is reset."""
    from .. import jit

    key = (b, s, max_len, temperature, top_k, use_jit, block_size,
           chunked, eos_token_id if chunked else None, kv_dtype, spec_k)
    store = model.__dict__.get("_generation_programs")
    if store is None:
        store = model.__dict__["_generation_programs"] = {}
    if key in store:
        entry = store.pop(key)  # re-insert as newest
        store[key] = entry
        entry[0].reset()
        return entry
    # each entry pins full caches and its captured graphs: bound the store
    while len(store) >= 4:
        store.pop(next(iter(store)))

    state = _KVCacheState(model, b, max_len, block_size=block_size,
                          kv_dtype=kv_dtype)

    def prefill(ids, cur_len):
        logits, _ = model.forward_with_cache(ids, state.caches, cur_len)
        tok = _sample(logits[:, -1], temperature, top_k)
        state.tok.copy_(tok)
        return tok

    if chunked:
        def decode(cur_len):
            prev = state.tok
            logits, _ = model.forward_with_cache(prev.reshape(b, 1),
                                                 state.caches, cur_len)
            tok = _sample(logits[:, -1], temperature, top_k)
            if eos_token_id is not None:
                fin = state.finished | (prev == eos_token_id)
                tok = torch.where(fin, torch.full_like(tok, eos_token_id),
                                  tok)
                state.finished.copy_(fin)
            state.tok.copy_(tok)
            return tok
    else:
        def decode(tok, cur_len):
            logits, _ = model.forward_with_cache(tok.reshape(b, 1),
                                                 state.caches, cur_len)
            return _sample(logits[:, -1], temperature, top_k)

    verify = None
    if spec_k:
        def verify(ids, cur_len):
            """Feed ``[B, spec_k + 1]`` candidate tokens at positions
            ``cur_len..``, write their KV, and return the greedy argmax at
            every position (the accept rule runs on the host on these
            ints; the logits stay on the device)."""
            logits, _ = model.forward_with_cache(ids, state.caches, cur_len)
            return torch.argmax(logits, dim=-1).to(torch.int32)

    if use_jit:
        prefill, decode = (jit.to_static(fn, layers=[model], full_graph=True)
                           for fn in (prefill, decode))
        if verify is not None:
            verify = jit.to_static(verify, layers=[model], full_graph=True)
    entry = ((state, prefill, decode) if verify is None
             else (state, prefill, decode, verify))
    store[key] = entry
    return entry


def _positions(start: int, n: int, device) -> torch.Tensor:
    """``[n]`` int32 positions ``start..`` on the device, in one upload;
    a program takes position i as the 0-d view ``[i]``."""
    return torch.arange(start, start + n, dtype=torch.int32).to(device)


def _decode_chunked(state, decode, first_tok, s, max_new_tokens,
                    chunk: int, eos_token_id) -> List[torch.Tensor]:
    """Drive the chunked decode: one regular call (``multi_step`` needs
    it), then ``multi_step`` runs of up to ``chunk`` steps. Returns the
    per-position ``[B]`` token tensors, eos rows frozen in the program."""
    out = [first_tok]
    pos = _positions(s, max_new_tokens, first_tok.device)  # pos[i] = s + i
    done = 1  # tokens emitted so far (prefill's)
    out.append(decode(pos[done - 1]))
    done += 1
    while done < max_new_tokens:
        k = min(chunk, max_new_tokens - done)
        if k == 1:
            out.append(decode(pos[done - 1]))
        else:
            out.extend(decode.multi_step(pos[done - 1:done - 1 + k]).unbind(0))
        done += k
        if eos_token_id is not None and bool(state.finished.all()):
            # every row finished: frozen eos for the rest, no dispatches
            out.extend([out[-1]] * (max_new_tokens - done))
            break
    return out


def _decode_speculative(decode, verify, input_ids, first_tok, s,
                        max_new_tokens, k, eos_token_id, proposer):
    """Drive speculative generation: per round, draft k tokens per row,
    ONE verify call scores all k+1 positions, and every row advances by
    the batch-minimum accepted prefix + 1 (a uniform advance keeps the
    scalar ``cur_len`` of the dense cache). Token-exact against the plain
    loop: accepted drafts equal the argmax by construction, and the tail
    (fewer than k+1 positions of budget left) and rounds where no row has
    a draft take the single step. Returns the ``[B]`` per-position host
    int32 arrays."""
    from ..inference.speculative import accept_length

    dev = first_tok.device
    b = int(input_ids.shape[0])
    prompt_np = input_ids.cpu().numpy().astype(np.int32)
    first_np = first_tok.cpu().numpy().astype(np.int32).reshape(b)
    hist = [list(prompt_np[r]) + [int(first_np[r])] for r in range(b)]
    finished = np.zeros((b,), bool)
    if eos_token_id is not None:
        finished |= first_np == eos_token_id
    out = [first_np]
    pos = _positions(s, max_new_tokens, dev)  # pos[i] = s + i
    done = 1
    while done < max_new_tokens:
        if eos_token_id is not None and finished.all():
            out.extend([out[-1]] * (max_new_tokens - done))
            break
        cur = pos[done - 1]  # position of the token out[-1] writes
        # tail: a k+1-wide verify would write KV past max_len
        no_spec = done + k > max_new_tokens
        if not no_spec:
            drafts = np.zeros((b, k), np.int32)
            any_draft = False
            for r in range(b):
                if finished[r]:
                    continue  # frozen; full accept forced below
                d = np.asarray(proposer.propose(
                    np.asarray(hist[r], np.int32), k),
                    np.int32).reshape(-1)[:k]
                drafts[r, :d.size] = d
                any_draft = any_draft or d.size > 0
            # no row has a draft: a k+1-wide verify would spend (k+1)x the
            # decode work to advance one token; take the plain step
            no_spec = not any_draft
        if no_spec:
            tok = decode(torch.from_numpy(out[-1]).to(dev), cur)
            t = tok.cpu().numpy().astype(np.int32).reshape(b)
            if eos_token_id is not None:
                t = np.where(finished, eos_token_id, t).astype(np.int32)
                finished = finished | (t == eos_token_id)
            for r in range(b):
                hist[r].append(int(t[r]))
            out.append(t)
            done += 1
            continue
        ids_step = np.concatenate([out[-1][:, None], drafts], axis=1)
        toks = verify(torch.from_numpy(ids_step).to(dev), cur)
        toks_np = toks.cpu().numpy().astype(np.int32)  # [B, k+1]
        # batch-minimum accept; finished rows must not drag it down
        acc = np.asarray([
            k if finished[r] else accept_length(drafts[r], toks_np[r, :-1])
            for r in range(b)])
        m = min(int(acc.min()) + 1, max_new_tokens - done)
        for j in range(m):
            t = toks_np[:, j]
            if eos_token_id is not None:
                t = np.where(finished, eos_token_id, t)
                finished = finished | (t == eos_token_id)
            for r in range(b):
                hist[r].append(int(t[r]))
            out.append(t.astype(np.int32))
        done += m
    return out


def generate(model, input_ids, max_new_tokens: int = 32,
             temperature: float = 0.0, top_k: int = 0,
             eos_token_id: Optional[int] = None, use_jit: bool = True,
             block_size: Optional[int] = None,
             decode_chunk: Optional[int] = None,
             kv_dtype: Optional[str] = None,
             speculative_k: Optional[int] = None,
             draft_proposer=None) -> torch.Tensor:
    """Continue ``input_ids`` ([B, S] int tensor on the model's device);
    returns ``[B, S + max_new_tokens]`` ids. Rows that emit
    ``eos_token_id`` repeat it thereafter.

    ``temperature > 0`` samples (``top_k > 0`` keeps the k largest logits,
    ties with the k-th included) from the port's generator of the device;
    0 is greedy. ``use_jit`` runs the programs through ``jit.to_static``
    (captured CUDA graphs on the card from a signature's second call).
    ``block_size`` gives the paged cache, ``kv_dtype="int8"`` (with
    ``block_size``) quantizes its pools. ``decode_chunk=K`` runs K decode
    steps per host round trip (with ``use_jit``). ``speculative_k=K``
    (greedy only) drafts K tokens per round with ``draft_proposer``
    (default :class:`~paddle_tpu_torch.inference.speculative.NgramProposer`)
    and verifies them in one call; tokens equal the plain loop's."""
    b, s = input_ids.shape
    if max_new_tokens <= 0:
        return input_ids
    if speculative_k is not None:
        if int(speculative_k) < 1:
            raise ValueError(
                f"speculative_k must be >= 1, got {speculative_k}")
        if temperature != 0:
            raise ValueError(
                "speculative decoding is greedy-only: the accept rule is "
                "argmax-prefix equality (temperature must be 0)")
        if decode_chunk:
            raise ValueError(
                "speculative_k and decode_chunk are alternative decode "
                "drivers — pass one, not both")
    max_len = s + max_new_tokens
    limit = getattr(getattr(model, "config", None), "max_position_embeddings", None)
    if limit is not None and max_len > limit:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) = {max_len} "
            f"exceeds the model's max_position_embeddings ({limit})")
    was_training = model.training
    model.eval()
    chunked = bool(decode_chunk) and use_jit and max_new_tokens > 2
    spec = None if speculative_k is None else min(
        int(speculative_k), max(max_new_tokens - 1, 1))
    dev = input_ids.device
    try:
        with torch.no_grad():
            zero = torch.zeros((), dtype=torch.int32).to(dev)
            if spec is not None:
                from ..inference.speculative import NgramProposer

                state, prefill, decode, verify = _get_compiled(
                    model, b, s, max_len, temperature, top_k, use_jit,
                    block_size=block_size, eos_token_id=eos_token_id,
                    kv_dtype=kv_dtype, spec_k=spec)
                tok = prefill(input_ids, zero)
                out = _decode_speculative(
                    decode, verify, input_ids, tok, s, max_new_tokens, spec,
                    eos_token_id,
                    draft_proposer if draft_proposer is not None
                    else NgramProposer())
                new = torch.from_numpy(np.stack(out, axis=1)).to(dev)
                return torch.cat([input_ids, new.to(input_ids.dtype)], dim=1)
            state, prefill, decode = _get_compiled(
                model, b, s, max_len, temperature, top_k, use_jit,
                block_size=block_size, chunked=chunked,
                eos_token_id=eos_token_id, kv_dtype=kv_dtype)
            tok = prefill(input_ids, zero)
            if chunked:
                out = _decode_chunked(state, decode, tok, s, max_new_tokens,
                                      int(decode_chunk), eos_token_id)
            else:
                out = [tok]
                pos = _positions(s, max_new_tokens, dev)  # pos[i] = s + i
                finished = torch.zeros(b, dtype=torch.bool, device=dev)
                for step_i in range(1, max_new_tokens):
                    tok = decode(tok, pos[step_i - 1])
                    if eos_token_id is not None:
                        # once a row emits eos, freeze it to eos thereafter
                        finished = finished | (out[-1] == eos_token_id)
                        tok = torch.where(
                            finished, torch.full_like(tok, eos_token_id), tok)
                    out.append(tok)
            new = torch.stack(out, dim=1).to(input_ids.dtype)
            return torch.cat([input_ids, new], dim=1)
    finally:
        if was_training:
            model.train()
