"""Continuous batching over the paged KV cache (counterpart of
``paddle_tpu/inference/serving.py:ContinuousBatchingEngine``).

A fixed pool of device blocks, a fixed number of batch slots, requests
admitted as slots and blocks free up, finished sequences evicted and their
blocks recycled.

- ONE decode program serves every engine iteration: tokens ``[B]``, the
  per-layer pools, block tables ``[B, max_blocks]`` and per-sequence
  ``cache_len`` ``[B]``. Slot membership changes only the table contents
  and lengths, never shapes. Each decode step runs the paged-decode kernel
  once per layer.
- Prefill admits prompt tokens into a slot; rows not taking part have
  their table pointed entirely at a reserved TRASH block, so their writes
  land in a sacrificial page and live sequences are untouched. The decode
  step writes every row too, so rows that are mid-prefill or inactive are
  pointed at the trash block for it.
- Whole-prompt prefill (default) runs one padded prefill of width
  ``prompt_pad`` per admission. Chunked prefill (``prefill_chunk=C``)
  feeds prompts C tokens at a time under ``max_num_batched_tokens`` real
  tokens per step: the decode round first, then chunks round-robin.
- ``decode_chunk=K`` runs K decode steps per host round trip — a Python
  loop with tokens, lengths and eos state kept on the device, in place of
  the reference's ``lax.scan``.
- The pools are updated in place (the JAX engine donates them).
- ``kv_dtype="int8"`` stores the KV pools in int8 with f32 per-token
  scale pools; each decode step then runs the int8 paged-decode kernel.
- ``prefix_cache=True`` keeps finished prompts' full KV blocks pinned in a
  :class:`PrefixCache`; a later prompt sharing a block-aligned prefix
  adopts them (ref-counted, copy-on-write) and prefills only the rest.

Greedy decoding only, so engine outputs are token-identical to isolated
``generate`` runs and to the JAX engine on the same weights. The
reference's admission control, speculative decoding, fp8, disaggregated
roles, overlap, cache tier, tenant namespaces, deadlines, tracing spans,
chaos sites and resource ledger arrive with later slices and raise
``NotImplementedError`` here when asked for.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.paged_attention import BlockManager, PagedLayerCache, PrefixCache

__all__ = ["GenRequest", "ContinuousBatchingEngine"]


@dataclass
class GenRequest:
    """One generation request: prompt ids + budget. ``times[i]`` is the
    ``perf_counter`` stamp when ``out[i]`` was produced; with ``t_submit``
    it gives time-to-first-token."""

    req_id: object
    prompt: np.ndarray  # [s] int
    max_new_tokens: int = 32
    out: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    times: List[float] = field(default_factory=list)

    def ttft(self) -> Optional[float]:
        """Seconds from submission to the first token (None if none)."""
        return self.times[0] - self.t_submit if self.times else None


class _Slot:
    __slots__ = ("req", "cache_len", "remaining", "prefill_pos")

    def __init__(self):
        self.req: Optional[GenRequest] = None
        self.cache_len = 0
        self.remaining = 0
        self.prefill_pos = 0  # prompt tokens written to KV so far

    @property
    def active(self):
        return self.req is not None

    @property
    def prefilling(self):
        return self.req is not None and self.prefill_pos < self.req.prompt.size

    @property
    def decode_ready(self):
        return (self.req is not None
                and self.prefill_pos >= self.req.prompt.size
                and bool(self.req.out))


# the reference's keywords whose features arrive with later slices, each
# with the value that means "off"
_LATER_ENGINE_ARGS = {
    "admission": None, "spec_decode_k": None, "draft_proposer": None,
    "fp8": False, "role": "unified", "overlap": False, "cache_tier": None,
    "tenant_namespaces": False, "shared_prefixes": None,
}
_LATER_REQUEST_ARGS = {
    "deadline": None, "priority": "interactive", "retries": 0, "trace": None,
    "tenant": "default",
}


def _refuse_later(kwargs: dict, offs: dict) -> None:
    for name, value in kwargs.items():
        if name not in offs:
            raise TypeError(f"unexpected keyword argument {name!r}")
        if value != offs[name]:
            raise NotImplementedError(
                f"{name}={value!r} arrives with a later slice of the port")


class ContinuousBatchingEngine:
    def __init__(self, model, *, max_batch: int, max_len: int,
                 block_size: int = 64, num_blocks: int,
                 prompt_pad: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 decode_chunk: int = 1,
                 prefill_chunk: Optional[int] = None,
                 max_num_batched_tokens: Optional[int] = None,
                 prefix_cache: bool = False,
                 kv_dtype: Optional[str] = None,
                 **later):
        """``num_blocks`` fixes the KV budget (the pool allocates one extra
        trash block); ``max_len`` bounds any sequence's positions;
        ``prompt_pad`` is the whole-prompt prefill width (default one
        block). ``decode_chunk=K`` runs K decode steps per dispatch when
        every active slot has at least K tokens of budget left (and, with a
        token budget, no slot is mid-prefill and active*K fits).
        ``prefill_chunk=C`` turns on chunked prefill with at most
        ``max_num_batched_tokens`` (default ``max_batch + C``) real tokens
        per step. ``prefix_cache=True`` turns on prefix KV reuse;
        ``kv_dtype="int8"`` quantizes the KV pools."""
        _refuse_later(later, _LATER_ENGINE_ARGS)
        self.model = model
        self.device = next(model.parameters()).device
        self.B = int(max_batch)
        self.block_size = int(block_size)
        self.max_len = int(max_len)
        self.prompt_pad = int(prompt_pad or block_size)
        if self.prompt_pad > self.max_len:
            raise ValueError("prompt_pad exceeds max_len")
        limit = getattr(getattr(model, "config", None),
                        "max_position_embeddings", None)
        if limit is not None and self.max_len > limit:
            raise ValueError(
                f"max_len ({self.max_len}) exceeds the model's "
                f"max_position_embeddings ({limit})")
        self.eos_token_id = eos_token_id
        self.manager = BlockManager(num_blocks, block_size)
        self.prefix_cache = (PrefixCache(block_size, manager=self.manager)
                             if prefix_cache else None)
        self.prefix_hit_tokens = 0
        self.prefix_forks = 0
        self._trash = num_blocks  # reserved sacrificial pool row
        self.max_blocks_per_seq = -(-self.max_len // block_size)

        self.prefill_chunk = None if prefill_chunk is None else int(prefill_chunk)
        if self.prefill_chunk is not None:
            if not 0 < self.prefill_chunk <= self.max_len:
                raise ValueError(
                    f"prefill_chunk must be in [1, max_len={self.max_len}], "
                    f"got {self.prefill_chunk}")
            if max_num_batched_tokens is None:
                max_num_batched_tokens = self.B + self.prefill_chunk
            self.max_num_batched_tokens = int(max_num_batched_tokens)
            floor = max(self.B, self.prefill_chunk)
            if self.max_num_batched_tokens < floor:
                raise ValueError(
                    f"max_num_batched_tokens={self.max_num_batched_tokens} "
                    f"must be >= max(max_batch, prefill_chunk)={floor}: a "
                    "decode round is one indivisible dispatch and a lone "
                    "prefill must be able to schedule one chunk")
        else:
            self.max_num_batched_tokens = None
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        self.kv_dtype = kv_dtype

        self._restore_training = model.training
        model.eval()
        caches = model.init_cache(
            self.B, self.max_len, block_size=block_size,
            num_blocks=num_blocks + 1,
            tables=np.full((self.B, self.max_blocks_per_seq), self._trash,
                           np.int32),
            kv_dtype=kv_dtype)
        # per layer (k, v), or (k, v, k_scale, v_scale) for int8 pools
        self._pools = [(c.k_pool, c.v_pool)
                       + (() if c.k_scale is None else (c.k_scale, c.v_scale))
                       for c in caches]
        self._tables = np.full((self.B, self.max_blocks_per_seq), self._trash,
                               np.int32)
        self._slots = [_Slot() for _ in range(self.B)]
        self._queue: List[GenRequest] = []
        self._completed: Dict[object, GenRequest] = {}
        self.decode_chunk = max(1, int(decode_chunk))
        self._rr = 0  # round-robin start for chunk scheduling fairness
        self.steps = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.n_dispatches = 0  # decode-phase dispatches
        self.decode_steps = 0  # model forward passes at width 1
        self.max_step_tokens = 0

    # -- device programs --------------------------------------------------
    def _h2d(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _caches(self, tables: torch.Tensor) -> List[PagedLayerCache]:
        return [PagedLayerCache(e[0], e[1], tables, False, *e[2:])
                for e in self._pools]

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy one physical block's KV, in place, in every layer's pools
        (scale rows included: a forked block's scales travel with its
        bytes) — the device half of a copy-on-write fork."""
        for entry in self._pools:
            for pool in entry:
                pool[:, dst] = pool[:, src]

    @torch.no_grad()
    def _prefill(self, ids, tables, cache_len, last_idx) -> torch.Tensor:
        """Returns the greedy token at ``last_idx`` per row ``[B]``: the
        one int per row the host reads from a prefill."""
        logits, _ = self.model.forward_with_cache(ids, self._caches(tables),
                                                  cache_len)
        rows = torch.arange(ids.shape[0], device=ids.device)
        return torch.argmax(logits[rows, last_idx.long()], dim=-1).to(torch.int32)

    @torch.no_grad()
    def _decode(self, tok, tables, cache_len, finished):
        """One decode step for every row; returns the next ``(tok,
        cache_len, finished)`` lanes. ``cache_len`` advances are clamped at
        ``max_len`` so idle rows never drift out of range."""
        logits, _ = self.model.forward_with_cache(
            tok[:, None], self._caches(tables), cache_len)
        self.decode_steps += 1
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        eos = self.eos_token_id
        if eos is not None:
            nxt = torch.where(finished, torch.full_like(nxt, eos), nxt)
            finished = finished | (nxt == eos)
        return nxt, torch.clamp(cache_len + 1, max=self.max_len), finished

    # -- public API ------------------------------------------------------
    @property
    def chunked(self) -> bool:
        return self.prefill_chunk is not None

    def add_request(self, req_id, prompt, max_new_tokens: int = 32,
                    **later) -> GenRequest:
        """Queue one prompt for ``max_new_tokens`` greedy tokens."""
        _refuse_later(later, _LATER_REQUEST_ARGS)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt length 0 not in [1, ...]")
        if not self.chunked and prompt.size > self.prompt_pad:
            raise ValueError(
                f"prompt length {prompt.size} not in [1, prompt_pad="
                f"{self.prompt_pad}] (enable prefill_chunk to serve "
                "prompts beyond the whole-prompt pad)")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        req = GenRequest(req_id, prompt, max_new_tokens,
                         t_submit=time.perf_counter())
        if self._blocks_needed(req) > self.manager.num_blocks:
            raise ValueError(
                f"request needs {self._blocks_needed(req)} blocks but the "
                f"pool only has {self.manager.num_blocks} — it could never "
                "be admitted")
        self._queue.append(req)
        return req

    @property
    def num_active(self):
        return sum(s.active for s in self._slots)

    @property
    def num_prefilling(self):
        return sum(s.prefilling for s in self._slots)

    def _blocks_needed(self, req) -> int:
        if self.chunked:
            total = int(req.prompt.size) + req.max_new_tokens
        else:
            total = max(int(req.prompt.size) + req.max_new_tokens,
                        self.prompt_pad)
        return self.manager.blocks_for(total)

    def _append_token(self, req: GenRequest, tok: int):
        req.out.append(tok)
        req.times.append(time.perf_counter())

    def prefix_stats(self) -> dict:
        """Prefix-cache counters (zeros when the cache is off).
        ``hit_rate`` is cached tokens over prompt tokens that entered a
        slot: the share of prefill work the cache saved. The tree's own
        lookup tallies count head-of-line re-probes, so only its shape
        keys are reported beside the engine's adopted-token count."""
        total = self.prefill_tokens + self.prefix_hit_tokens
        base = {
            "enabled": self.prefix_cache is not None,
            "hit_tokens": self.prefix_hit_tokens,
            "prefill_tokens": self.prefill_tokens,
            "forks": self.prefix_forks,
            "hit_rate": (self.prefix_hit_tokens / total) if total else 0.0,
        }
        if self.prefix_cache is not None:
            tree = self.prefix_cache.stats()
            base.update({k: tree[k] for k in
                         ("nodes", "lookups", "evicted_blocks")})
        return base

    def _reserve_blocks(self, req):
        """Block-availability half of slot binding, prefix-cache aware:
        look up the prompt's cached prefix, ADOPT those blocks, and check
        the shortfall against the free list, evicting LRU cache entries
        when it runs short. Returns ``(ok, cached_len, will_fork)``; on
        ``ok=False`` the adoption is undone (head-of-line wait).

        ``cached_len`` is capped at ``prompt.size - 1``: the first token
        comes from the last prompt position's logits, which only a real
        prefill produces, so a fully cached prompt recomputes one token —
        whose write lands inside the last shared block, which the caller
        must then fork (``will_fork``)."""
        psize = int(req.prompt.size)
        cached_len, cached_blocks = 0, []
        if self.prefix_cache is not None:
            cached_len, cached_blocks = self.prefix_cache.lookup(req.prompt)
            cached_len = min(cached_len, psize - 1)
        will_fork = bool(cached_len % self.block_size)
        need = (self._blocks_needed(req) - len(cached_blocks)
                + (1 if will_fork else 0))
        if cached_blocks:
            self.manager.adopt(req.req_id, cached_blocks)
        if need > self.manager.free_blocks and self.prefix_cache is not None:
            self.prefix_cache.evict(need - self.manager.free_blocks)
        if need > self.manager.free_blocks:
            if cached_blocks:
                self.manager.free_sequence(req.req_id)
            return False, 0, False
        return True, cached_len, will_fork

    def _admit(self) -> int:
        """Fill free slots from the queue while blocks last (FIFO,
        head-of-line). Whole-prompt mode runs one padded prefill per
        admission, of the prompt's un-cached remainder at offset
        ``cached_len``; chunked mode only binds the slot, reserves its
        full block budget and starts its chunks at ``cached_len``.
        Returns real tokens processed."""
        used = 0
        for slot_idx, slot in enumerate(self._slots):
            if not self._queue or slot.active:
                continue
            req = self._queue[0]
            ok, cached_len, will_fork = self._reserve_blocks(req)
            if not ok:
                break  # head-of-line; keep FIFO fairness
            self.manager.allocate(req.req_id,
                                  self._blocks_needed(req) * self.block_size)
            if will_fork:
                # the first write (position cached_len) lands inside the
                # last adopted block: copy it so its readers keep it
                old, new = self.manager.fork(
                    req.req_id, cached_len // self.block_size)
                if new != old:
                    self._copy_block(old, new)
                    self.prefix_forks += 1
            self.prefix_hit_tokens += cached_len
            blocks = self.manager.owned_blocks(req.req_id)
            row = self.manager.table_row(req.req_id, self.max_blocks_per_seq,
                                         fill=self._trash)
            self._tables[slot_idx] = row
            slot.req = req
            slot.remaining = req.max_new_tokens
            self._queue.pop(0)
            if self.chunked:
                slot.prefill_pos = cached_len
                slot.cache_len = cached_len
                continue

            psize = int(req.prompt.size)
            rem = psize - cached_len  # >= 1 by the cached_len cap
            slot.prefill_pos = psize
            slot.cache_len = psize
            # isolated prefill: only this row's table points at real
            # blocks; every other row scatters into the trash block
            iso = np.full_like(self._tables, self._trash)
            iso[slot_idx] = row
            ids = np.zeros((self.B, self.prompt_pad), np.int32)
            ids[slot_idx, :rem] = req.prompt[cached_len:]
            cl = np.zeros((self.B,), np.int32)
            cl[slot_idx] = cached_len
            last_idx = np.zeros((self.B,), np.int32)
            last_idx[slot_idx] = rem - 1
            firsts = self._prefill(self._h2d(ids), self._h2d(iso),
                                   self._h2d(cl), self._h2d(last_idx))
            used += rem
            self.prefill_tokens += rem
            if self.prefix_cache is not None:
                # pin the prompt's full blocks before a same-step finish
                # frees the sequence's own references
                self.prefix_cache.insert(req.prompt, blocks)
            self._apply_first_token(slot_idx, req, int(firsts[slot_idx]))
        return used

    def _finish_if_done(self, slot_idx, last_tok) -> bool:
        slot = self._slots[slot_idx]
        req = slot.req
        done = slot.remaining <= 0 or (
            self.eos_token_id is not None and last_tok == self.eos_token_id)
        if done:
            self.manager.free_sequence(req.req_id)
            self._tables[slot_idx] = self._trash
            self._completed[req.req_id] = req
            slot.req = None
        return done

    def _apply_first_token(self, slot_idx: int, req: GenRequest,
                           first: int) -> None:
        self._append_token(req, first)
        self._slots[slot_idx].remaining -= 1
        self._finish_if_done(slot_idx, first)

    def _apply_decode(self, toks: np.ndarray, rows) -> None:
        """Credit one decode dispatch's tokens ``[K, B]`` to its rows."""
        for i, req in rows:
            slot = self._slots[i]
            for j in range(toks.shape[0]):
                t = int(toks[j, i])
                self._append_token(req, t)
                slot.cache_len += 1
                slot.remaining -= 1
                self.decode_tokens += 1
                if self._finish_if_done(i, t):
                    break

    def _schedule_prefill(self, budget_left: int) -> Dict[int, int]:
        """Round-robin chunk scheduler: starting at the fairness pointer,
        grant each prefilling slot one ``prefill_chunk`` bite per pass
        until the budget cannot cover the next bite. {slot: real tokens}."""
        chunk = self.prefill_chunk
        order = sorted((i for i, s in enumerate(self._slots) if s.prefilling),
                       key=lambda i: (i - self._rr) % self.B)
        sched = {i: 0 for i in order}
        used, progress = 0, True
        while progress:
            progress = False
            for i in order:
                slot = self._slots[i]
                rem = slot.req.prompt.size - slot.prefill_pos - sched[i]
                if rem <= 0:
                    continue
                real = min(chunk, int(rem))
                if used + real > budget_left:
                    return {i: n for i, n in sched.items() if n}
                sched[i] += real
                used += real
                progress = True
        return {i: n for i, n in sched.items() if n}

    def _prefill_step(self, budget_left: int) -> int:
        """Run this step's scheduled prefill chunks: one batched dispatch
        per round, each chunk writing its KV at the slot's ``cache_len``;
        the slot whose final chunk lands gets its first token."""
        sched = self._schedule_prefill(budget_left)
        if not sched:
            return 0
        chunk = self.prefill_chunk
        used = 0
        while sched:
            ids = np.zeros((self.B, chunk), np.int32)
            cl = np.zeros((self.B,), np.int32)
            last_idx = np.zeros((self.B,), np.int32)
            iso = np.full_like(self._tables, self._trash)
            round_rows = []
            for i in list(sched):
                slot = self._slots[i]
                start = slot.prefill_pos
                real = min(chunk, slot.req.prompt.size - start, sched[i])
                ids[i, :real] = slot.req.prompt[start:start + real]
                cl[i] = start
                last_idx[i] = real - 1
                iso[i] = self._tables[i]
                round_rows.append((i, start, real))
                sched[i] -= real
                if sched[i] <= 0:
                    del sched[i]
            firsts = self._prefill(self._h2d(ids), self._h2d(iso),
                                   self._h2d(cl), self._h2d(last_idx))
            done_rows = []
            for i, start, real in round_rows:
                slot = self._slots[i]
                slot.prefill_pos = start + real
                slot.cache_len = slot.prefill_pos
                self.prefill_tokens += real
                used += real
                if slot.prefill_pos == slot.req.prompt.size:
                    if self.prefix_cache is not None:
                        # pin the finished prompt's full blocks before a
                        # same-chunk finish frees the sequence
                        self.prefix_cache.insert(
                            slot.req.prompt,
                            self.manager.owned_blocks(slot.req.req_id))
                    done_rows.append((i, slot.req))
            if done_rows:
                vals = firsts.cpu().numpy()  # [B] ints, not [B, chunk]
                for i, req in done_rows:
                    self._apply_first_token(i, req, int(vals[i]))
        self._rr = (self._rr + 1) % self.B
        return used

    def _decode_rows(self):
        return [i for i, s in enumerate(self._slots) if s.decode_ready]

    def _scan_gate(self, active, budget_left) -> bool:
        """A K-step chunk must fit every active slot's remaining budget and
        the step's token budget, and must not starve a mid-prefill slot."""
        k = self.decode_chunk
        return (k > 1
                and min(self._slots[i].remaining for i in active) >= k
                and (budget_left is None
                     or (len(active) * k <= budget_left
                         and self.num_prefilling == 0)))

    def _decode_step(self, budget_left: Optional[int]) -> int:
        """One decode round for every decode-phase slot (single step or a
        ``decode_chunk`` loop). Returns real tokens scheduled."""
        active = self._decode_rows()
        if not active:
            return 0
        tok = np.zeros((self.B,), np.int32)
        cl = np.zeros((self.B,), np.int32)
        fin = np.ones((self.B,), bool)
        for i in active:
            slot = self._slots[i]
            tok[i] = slot.req.out[-1]
            cl[i] = slot.cache_len
            fin[i] = False
        tables = self._tables
        if self.num_prefilling:
            # the decode step writes EVERY row's (tok, cl): rows mid-prefill
            # hold real tables now, so their dummy write would corrupt the
            # KV their first chunks laid down; point them at the trash block
            tables = self._tables.copy()
            for i, s in enumerate(self._slots):
                if s.prefilling:
                    tables[i] = self._trash
        tok_d, tab_d, cl_d, fin_d = (self._h2d(tok), self._h2d(tables),
                                     self._h2d(cl), self._h2d(fin))
        k = self.decode_chunk if self._scan_gate(active, budget_left) else 1
        outs = []
        for _ in range(k):
            tok_d, cl_d, fin_d = self._decode(tok_d, tab_d, cl_d, fin_d)
            outs.append(tok_d)
        self.n_dispatches += 1
        toks = torch.stack(outs).cpu().numpy()  # [K, B]
        self._apply_decode(toks, [(i, self._slots[i].req) for i in active])
        return len(active) * k

    def step(self) -> List[GenRequest]:
        """One engine iteration: admit, then the token-budgeted work — the
        decode round first, leftover budget spent on prefill chunks
        (whole-prompt mode prefills inside admission). Returns the
        requests completed this iteration."""
        before = set(self._completed)
        used = self._admit()
        budget = self.max_num_batched_tokens
        used += self._decode_step(None if budget is None else budget - used)
        if self.chunked:
            used += self._prefill_step(budget - used)
        self.steps += 1
        self.max_step_tokens = max(self.max_step_tokens, used)
        return [self._completed[r] for r in set(self._completed) - before]

    def run(self, max_steps: int = 100_000) -> Dict[object, GenRequest]:
        """Drain the queue + active slots; returns {req_id: GenRequest}."""
        while (self._queue or self.num_active) and max_steps > 0:
            self.step()
            max_steps -= 1
        if self._restore_training:
            self.model.train()
        return dict(self._completed)
