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
- The decode-phase programs (the single step, the ``decode_chunk`` K-step
  chunk and the speculative verify) are ``jit.to_static`` functions over
  persistent device buffers ``(tok, tables, cache_len, finished)`` (and
  the drafts): each reads them and writes its next ``(tok, cache_len,
  finished)`` into them in place. On the card the first call of each runs
  eagerly and the next captures it as a CUDA graph, which every later
  dispatch replays (the counterpart of the reference's ``jax.jit``); a
  program that cannot be captured raises. ``jit.enable_to_static(False)``
  runs them eagerly. Host counters a replay cannot bump (``decode_steps``,
  ``n_dispatches``, the kernels' launch counts) are added per dispatch.
- Prefill admits prompt tokens into a slot (eagerly); rows not taking part
  have their table pointed entirely at a reserved TRASH block, so their
  writes land in a sacrificial page and live sequences are untouched. The
  decode step writes every row too, so rows that are mid-prefill or
  inactive are pointed at the trash block for it.
- Whole-prompt prefill (default) runs one padded prefill of width
  ``prompt_pad`` per admission. Chunked prefill (``prefill_chunk=C``)
  feeds prompts C tokens at a time under ``max_num_batched_tokens`` real
  tokens per step: the decode round first, then chunks round-robin.
- ``decode_chunk=K`` runs K decode steps per dispatch, in one program
  with tokens, lengths and eos state kept on the device, in place of the
  reference's ``lax.scan``.
- The pools are updated in place (the JAX engine donates them).
- ``kv_dtype="int8"`` stores the KV pools in int8 with f32 per-token
  scale pools; each decode step then runs the int8 paged-decode kernel.
- ``prefix_cache=True`` keeps finished prompts' full KV blocks pinned in a
  :class:`PrefixCache`; a later prompt sharing a block-aligned prefix
  adopts them (ref-counted, copy-on-write) and prefills only the rest.
  ``tenant_namespaces=True`` keys the cache by the request's ``tenant``;
  ``shared_prefixes`` are token sequences (system prompts) every tenant
  may adopt from a shared namespace.
- ``spec_decode_k=K`` turns on speculative decoding: a
  :class:`~.speculative.DraftProposer` (default n-gram prompt lookup)
  drafts up to K tokens per decode-phase slot, and one verify dispatch
  (the prefill path at width K+1) scores all K+1 positions and computes
  each slot's greedy accepted length on the device. A round where no slot
  has a draft takes the plain decode path. Under a token budget a verify
  round charges K+1 per slot and yields to mid-prefill slots.
- ``overlap=True`` pipelines host and device (lag-1 scheduling): the
  dispatch of step N+1 consumes the persistent state step N's program
  wrote, with no host round trip; only slots that join or leave are
  re-uploaded (the dirty rows); each dispatch's token output is copied to
  a pinned host buffer (``non_blocking``, marked by a CUDA event) and
  parked in a FIFO ring, and the host harvests entry N while the device
  runs N+1. A slot finishing in entry N may be over-issued one dispatch:
  the extra token is discarded at harvest and its KV write lands behind
  the causal mask. Streams are token-identical to ``overlap=False``.

Greedy decoding only (as the reference's engine), so engine outputs are
token-identical to isolated ``generate`` runs and to the JAX engine on the
same weights. The reference's admission control, fp8 GEMMs, disaggregated
roles, cache tier, deadlines, priorities, tracing spans, ``load()``, chaos
sites and resource ledger arrive with later slices and raise
``NotImplementedError`` here when asked for.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import jit
from ..ops.paged_attention import BlockManager, PagedLayerCache, PrefixCache
from .speculative import DraftProposer, NgramProposer

__all__ = ["GenRequest", "ContinuousBatchingEngine"]


@dataclass
class GenRequest:
    """One generation request: prompt ids + budget. ``times[i]`` is the
    ``perf_counter`` stamp when ``out[i]`` was produced; with ``t_submit``
    it gives time-to-first-token. ``tenant`` selects the prefix-cache
    namespace when the engine keys the cache by tenant."""

    req_id: object
    prompt: np.ndarray  # [s] int
    max_new_tokens: int = 32
    out: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    times: List[float] = field(default_factory=list)
    tenant: str = "default"

    def ttft(self) -> Optional[float]:
        """Seconds from submission to the first token (None if none)."""
        return self.times[0] - self.t_submit if self.times else None


class _Slot:
    __slots__ = ("req", "cache_len", "remaining", "prefill_pos",
                 "pending_first")

    def __init__(self):
        self.req: Optional[GenRequest] = None
        self.cache_len = 0
        self.remaining = 0
        self.prefill_pos = 0  # prompt tokens written to KV so far
        # overlap mode: prefill done, but the first token still rides the
        # copy ring; the slot joins no decode dispatch until it lands
        self.pending_first = False

    @property
    def active(self):
        return self.req is not None

    @property
    def prefilling(self):
        return self.req is not None and self.prefill_pos < self.req.prompt.size

    @property
    def decode_ready(self):
        return (self.req is not None and not self.pending_first
                and self.prefill_pos >= self.req.prompt.size
                and bool(self.req.out))


class _RingEntry:
    """One dispatch whose tokens the host has not harvested yet: the
    pinned host copies of its outputs with the event that marks them, and
    the ``(slot, request[, real drafts])`` rows it served, taken at
    dispatch time (harvest credits the request the dispatch served, and
    discards the tokens of a row whose slot changed hands meanwhile)."""

    __slots__ = ("kind", "copies", "rows")

    def __init__(self, kind, copies, rows):
        self.kind = kind  # "decode" | "spec" | "first"
        self.copies = copies  # [(host tensor, event or None)]
        self.rows = rows


# the reference's keywords whose features arrive with later slices, each
# with the value that means "off"
_LATER_ENGINE_ARGS = {
    "admission": None, "fp8": False, "role": "unified", "cache_tier": None,
}
_LATER_REQUEST_ARGS = {
    "deadline": None, "priority": "interactive", "retries": 0, "trace": None,
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
                 spec_decode_k: Optional[int] = None,
                 draft_proposer: Optional[DraftProposer] = None,
                 kv_dtype: Optional[str] = None,
                 overlap: bool = False,
                 tenant_namespaces: bool = False,
                 shared_prefixes=None,
                 **later):
        """``num_blocks`` fixes the KV budget (the pool allocates one extra
        trash block); ``max_len`` bounds any sequence's positions;
        ``prompt_pad`` is the whole-prompt prefill width (default one
        block). ``decode_chunk=K`` runs K decode steps per dispatch when
        every active slot has at least K tokens of budget left (and, with a
        token budget, no slot is mid-prefill and active*K fits).
        ``prefill_chunk=C`` turns on chunked prefill with at most
        ``max_num_batched_tokens`` (default ``max_batch + C``) real tokens
        per step. ``prefix_cache=True`` turns on prefix KV reuse, keyed by
        tenant with ``tenant_namespaces=True`` (``shared_prefixes``: token
        sequences every tenant may adopt); ``kv_dtype="int8"`` quantizes
        the KV pools; ``spec_decode_k=K`` turns on speculative decoding
        with ``draft_proposer`` (default :class:`NgramProposer`);
        ``overlap=True`` pipelines host and device (module docstring)."""
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
        if tenant_namespaces and self.prefix_cache is None:
            raise ValueError("tenant_namespaces requires prefix_cache=True")
        self._tenant_ns = bool(tenant_namespaces)
        self._shared_prefixes = [np.asarray(p, np.int32).reshape(-1)
                                 for p in (shared_prefixes or ())]
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
        self.spec_k = None if spec_decode_k is None else int(spec_decode_k)
        if self.spec_k is not None and self.spec_k < 1:
            raise ValueError(f"spec_decode_k must be >= 1, got {self.spec_k}")
        self.proposer = (draft_proposer if draft_proposer is not None
                         else NgramProposer())
        self.spec_proposed = 0  # real draft tokens sent to verify
        self.spec_accepted = 0  # of those, greedy-accepted
        self.spec_emitted = 0  # tokens emitted by verify dispatches
        self.spec_dispatches = 0
        self.spec_slot_rounds = 0  # slot participations in verify dispatches

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

        # the decode-phase programs' persistent device state: every
        # program reads these buffers and writes its next (tok, cache_len,
        # finished) into them in place, so their addresses never change
        dev, B = self.device, self.B
        self._dtok = torch.zeros(B, dtype=torch.int32, device=dev)
        self._dtab = torch.full((B, self.max_blocks_per_seq), self._trash,
                                dtype=torch.int32, device=dev)
        self._dcl = torch.zeros(B, dtype=torch.int32, device=dev)
        self._dfin = torch.ones(B, dtype=torch.bool, device=dev)
        self._ddrafts = (None if self.spec_k is None else
                         torch.zeros((B, self.spec_k), dtype=torch.int32,
                                     device=dev))
        # full_graph=True: a program that cannot be captured raises
        self._decode_fn, self._chunk_fn, self._verify_fn = (
            jit.to_static(fn, layers=[model], full_graph=True)
            for fn in (self._decode_program, self._chunk_program,
                       self._verify_program))

        # host/device pipelining (overlap mode)
        self.overlap = bool(overlap)
        self.pipeline_depth = 1 if self.overlap else 0
        self._ring: deque = deque()  # in-flight _RingEntry FIFO
        self._dstate_live = False  # overlap: device state uploaded
        self._dirty: set = set()  # slot rows the device state must re-read
        self._rows_flushed = 0  # dirty-row uploads so far
        # host/device telemetry, tracked in both modes
        self.n_dispatches = 0  # decode-phase dispatches
        self.decode_steps = 0  # model forward passes at width 1
        self.host_blocked_s = 0.0  # seconds blocked on device->host reads
        self.busy_s = 0.0  # seconds inside step()
        self.ewma_blocked_frac: Optional[float] = None
        self.ewma_step_s: Optional[float] = None
        self.ewma_step_tokens: Optional[float] = None
        self.h2d_bytes = 0  # host->device upload bytes
        self.h2d_decode_bytes = 0  # ...on the decode-phase path
        self.d2h_bytes = 0  # device->host read bytes
        self._harvested_step = 0  # real tokens harvested this step
        self.steps = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.last_step_tokens = 0
        self.last_step_s = 0.0
        self.max_step_tokens = 0
        self._step_spec_overcharge = 0

    # -- host <-> device transfers ----------------------------------------
    def _staged(self, x, decode: bool) -> torch.Tensor:
        """``x`` as a host tensor ready to upload, its bytes counted
        (``decode=True``: on the decode-phase path). On the card the bytes
        go to pinned memory, from which the upload runs ``non_blocking``;
        the pinned block is not reused before that upload completes (the
        caching host allocator records it), so a later refill cannot
        corrupt an upload still in flight."""
        x = np.ascontiguousarray(x)
        self.h2d_bytes += int(x.nbytes)
        if decode:
            self.h2d_decode_bytes += int(x.nbytes)
        t = torch.from_numpy(x)
        return t.pin_memory() if self.device.type == "cuda" else t.clone()

    def _h2d(self, x, *, decode: bool = False) -> torch.Tensor:
        return self._staged(x, decode).to(self.device, non_blocking=True)

    def _h2d_into(self, dst: torch.Tensor, x, *, decode: bool = False):
        dst.copy_(self._staged(x, decode), non_blocking=True)

    def _start_d2h(self, t: torch.Tensor):
        """Start copying ``t`` to the host: a pinned buffer filled
        ``non_blocking`` behind the work that made ``t``, and the event
        that marks the copy's end."""
        if t.device.type != "cuda":
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _finish_d2h(self, copy) -> np.ndarray:
        """Wait for a started copy; the wait counts as host-blocked time."""
        host, ev = copy
        t0 = time.perf_counter()
        if ev is not None:
            ev.synchronize()
        out = host.numpy()
        self.host_blocked_s += time.perf_counter() - t0
        self.d2h_bytes += int(out.nbytes)
        return out

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        return self._finish_d2h(self._start_d2h(t))

    # -- device programs --------------------------------------------------
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

    def _step_lanes(self, tok, tables, cache_len, finished):
        """One decode step for every row; returns the next ``(tok,
        cache_len, finished)`` lanes. ``cache_len`` advances are clamped at
        ``max_len`` so idle rows never drift out of range."""
        logits, _ = self.model.forward_with_cache(
            tok[:, None], self._caches(tables), cache_len)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        eos = self.eos_token_id
        if eos is not None:
            nxt = torch.where(finished, torch.full_like(nxt, eos), nxt)
            finished = finished | (nxt == eos)
        return nxt, torch.clamp(cache_len + 1, max=self.max_len), finished

    def _set_state(self, tok, cache_len, finished) -> None:
        self._dtok.copy_(tok)
        self._dcl.copy_(cache_len)
        self._dfin.copy_(finished)

    @torch.no_grad()
    def _decode_program(self) -> torch.Tensor:
        """The single step over the persistent state; returns ``[B]``."""
        nxt, cl, fin = self._step_lanes(self._dtok, self._dtab, self._dcl,
                                        self._dfin)
        self._set_state(nxt, cl, fin)
        return nxt

    @torch.no_grad()
    def _chunk_program(self) -> torch.Tensor:
        """``decode_chunk`` steps over the persistent state; returns the
        tokens ``[K, B]``."""
        tok, cl, fin = self._dtok, self._dcl, self._dfin
        outs = []
        for _ in range(self.decode_chunk):
            tok, cl, fin = self._step_lanes(tok, self._dtab, cl, fin)
            outs.append(tok)
        self._set_state(tok, cl, fin)
        return torch.stack(outs)

    @torch.no_grad()
    def _verify_program(self) -> torch.Tensor:
        """One speculative verify: ids ``[tok, drafts]`` at width k+1
        through the prefill path, the argmax at every position, and each
        row's greedy accepted length ``acc`` (the cumulative product of
        draft/argmax matches). The continuation lanes — the token at
        position ``acc``, ``cache_len + acc + 1``, eos inside the accepted
        prefix — are written to the state on the device, so overlap mode
        chains verify rounds with no host round trip. Returns ``[B, k+2]``:
        the k+1 argmax tokens, then ``acc``."""
        tok, cl, fin, drafts = self._dtok, self._dcl, self._dfin, self._ddrafts
        ids = torch.cat([tok[:, None], drafts], dim=1)
        logits, _ = self.model.forward_with_cache(
            ids, self._caches(self._dtab), cl)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, k+1]
        ok = (drafts == toks[:, :-1]).to(torch.int32)
        acc = torch.cumprod(ok, dim=1).sum(dim=1)  # [B] int64, <= k
        rows = torch.arange(toks.shape[0], device=toks.device)
        nxt = toks[rows, acc]
        cl2 = torch.clamp(cl + acc.to(torch.int32) + 1, max=self.max_len)
        eos = self.eos_token_id
        if eos is not None:
            pos = torch.arange(toks.shape[1], device=toks.device)[None, :]
            hit = (toks == eos) & (pos <= acc[:, None])
            nxt = torch.where(fin, torch.full_like(nxt, eos), nxt)
            fin = fin | hit.any(dim=1)
        self._set_state(nxt, cl2, fin)
        return torch.cat([toks, acc.to(torch.int32)[:, None]], dim=1)

    # -- public API ------------------------------------------------------
    @property
    def chunked(self) -> bool:
        return self.prefill_chunk is not None

    def add_request(self, req_id, prompt, max_new_tokens: int = 32,
                    tenant: str = "default", **later) -> GenRequest:
        """Queue one prompt for ``max_new_tokens`` greedy tokens;
        ``tenant`` names the prefix-cache namespace (with
        ``tenant_namespaces=True``)."""
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
                         t_submit=time.perf_counter(), tenant=str(tenant))
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

    def spec_stats(self) -> dict:
        """Speculative-decoding counters (zeros when off). A slot in a
        verify dispatch emits at least one token where plain decode emits
        exactly one, so ``tokens_per_slot_round`` is the realized per-slot
        multiplier."""
        return {
            "enabled": self.spec_k is not None,
            "k": self.spec_k,
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "acceptance_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else 0.0),
            "dispatches": self.spec_dispatches,
            "emitted": self.spec_emitted,
            "tokens_per_slot_round": (
                self.spec_emitted / self.spec_slot_rounds
                if self.spec_slot_rounds else 0.0),
        }

    def overlap_stats(self) -> dict:
        """Host/device pipelining counters, tracked in both modes (the sync
        engine is the baseline): decode-phase dispatches, seconds blocked
        on device->host reads against seconds in ``step()``, tokens per
        dispatch, and the transfer byte ledgers."""
        toks = self.decode_tokens
        return {
            "enabled": self.overlap,
            "pipeline_depth": self.pipeline_depth,
            "in_flight": len(self._ring),
            "dispatches": self.n_dispatches,
            "host_blocked_s": self.host_blocked_s,
            "busy_s": self.busy_s,
            "host_blocked_frac": (self.host_blocked_s / self.busy_s
                                  if self.busy_s > 0 else 0.0),
            "overlap_frac": (1.0 - self.host_blocked_s / self.busy_s
                             if self.busy_s > 0 else 0.0),
            "tokens_per_dispatch": (toks / self.n_dispatches
                                    if self.n_dispatches else 0.0),
            "h2d_bytes": self.h2d_bytes,
            "h2d_decode_bytes": self.h2d_decode_bytes,
            "h2d_decode_bytes_per_token": (self.h2d_decode_bytes / toks
                                           if toks else 0.0),
            "d2h_bytes": self.d2h_bytes,
        }

    # -- prefix namespaces ---------------------------------------------------
    def _shared_prefix_len(self, prompt) -> int:
        """Longest registered shared prefix that prefixes ``prompt``,
        rounded down to full blocks (only full blocks enter the tree)."""
        best = 0
        psize = int(prompt.size)
        for sp in self._shared_prefixes:
            n = int(sp.size)
            if best < n <= psize and np.array_equal(prompt[:n], sp):
                best = n
        return (best // self.block_size) * self.block_size

    def _prefix_lookup(self, req):
        """The tenant's own tree, or the shared tree where it covers more
        of the prompt (the default tree without namespaces)."""
        if not self._tenant_ns:
            return self.prefix_cache.lookup(req.prompt)
        n_t, b_t = self.prefix_cache.lookup(req.prompt, ns=req.tenant)
        n_s, b_s = self.prefix_cache.lookup(req.prompt, ns="*")
        return (n_t, b_t) if n_t >= n_s else (n_s, b_s)

    def _prefix_insert(self, req, blocks) -> None:
        """Register a prefilled prompt's blocks under the tenant's
        namespace (or the default tree), and its registered shared prefix
        under the shared namespace: the same physical blocks, pinned once
        per tree, copy-on-write for every adopter."""
        ns = req.tenant if self._tenant_ns else None
        self.prefix_cache.insert(req.prompt, blocks, ns=ns)
        if self._tenant_ns:
            sh = self._shared_prefix_len(req.prompt)
            if sh:
                self.prefix_cache.insert(req.prompt[:sh],
                                         blocks[:sh // self.block_size],
                                         ns="*")

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
            cached_len, cached_blocks = self._prefix_lookup(req)
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
            slot.pending_first = False
            self._mark_dirty(slot_idx)
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
                self._prefix_insert(req, blocks)
            if self.overlap:
                # the first token rides the copy ring; until it lands the
                # slot joins no decode dispatch
                slot.pending_first = True
                self._push_entry("first", (firsts,), [(slot_idx, req)])
            else:
                first = int(self._fetch(firsts)[slot_idx])
                self._apply_first_token(slot_idx, req, first)
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
            slot.pending_first = False
            self._mark_dirty(slot_idx)
        return done

    def _apply_first_token(self, slot_idx: int, req: GenRequest,
                           first: int) -> int:
        """Host bookkeeping of a finished prefill's first token (inline in
        sync mode, at harvest in overlap mode). Returns tokens emitted: 0
        when the slot changed hands while the token was in flight."""
        slot = self._slots[slot_idx]
        if slot.req is not req:
            return 0
        slot.pending_first = False
        self._append_token(req, first)
        slot.remaining -= 1
        self._mark_dirty(slot_idx)
        self._finish_if_done(slot_idx, first)
        return 1

    def _apply_decode(self, toks: np.ndarray, rows) -> int:
        """Credit one decode dispatch's tokens ``[K, B]`` to its rows; a
        row whose request no longer owns its slot (finished or replaced
        after the dispatch: the over-issue of overlap mode) is skipped."""
        n = 0
        for i, req in rows:
            slot = self._slots[i]
            if slot.req is not req:
                continue
            for j in range(toks.shape[0]):
                t = int(toks[j, i])
                self._append_token(req, t)
                slot.cache_len += 1
                slot.remaining -= 1
                self.decode_tokens += 1
                n += 1
                if self._finish_if_done(i, t):
                    break
        return n

    def _apply_spec(self, toks: np.ndarray, acc: np.ndarray, rows) -> int:
        """Credit one verify dispatch: each row emits its accepted prefix
        and the token after it, clamped by its remaining budget, with the
        same ownership guard. The budget was charged k+1 positions a row;
        the difference from what was emitted goes to
        ``_step_spec_overcharge``."""
        self.spec_dispatches += 1
        emitted = charged = 0
        for i, req, n_real in rows:
            self.spec_slot_rounds += 1
            charged += self.spec_k + 1
            slot = self._slots[i]
            if slot.req is not req:
                continue
            m = min(int(acc[i]) + 1, slot.remaining)
            self.spec_proposed += n_real
            self.spec_accepted += min(int(acc[i]), n_real)
            for j in range(m):
                t = int(toks[i, j])
                self._append_token(req, t)
                slot.cache_len += 1
                slot.remaining -= 1
                self.decode_tokens += 1
                self.spec_emitted += 1
                emitted += 1
                if self._finish_if_done(i, t):
                    break
        self._step_spec_overcharge += charged - emitted
        return emitted

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
                        self._prefix_insert(
                            slot.req,
                            self.manager.owned_blocks(slot.req.req_id))
                    done_rows.append((i, slot.req))
            if done_rows:
                if self.overlap:
                    for i, _ in done_rows:
                        self._slots[i].pending_first = True
                        self._mark_dirty(i)
                    self._push_entry("first", (firsts,), done_rows)
                else:
                    vals = self._fetch(firsts)  # [B] ints, not [B, chunk]
                    for i, req in done_rows:
                        self._apply_first_token(i, req, int(vals[i]))
        self._rr = (self._rr + 1) % self.B
        return used

    def _decode_rows(self):
        return [i for i, s in enumerate(self._slots) if s.decode_ready]

    # -- speculative rounds ------------------------------------------------
    def _propose_drafts(self, active) -> Optional[tuple]:
        """Draft up to ``spec_k`` tokens per decode-phase slot from its
        whole history (prompt + generated). Returns ``(drafts [B, k] int32
        zero-padded, {slot: real draft count})``, or None when no slot has
        a draft (the round takes the plain decode path)."""
        drafts = np.zeros((self.B, self.spec_k), np.int32)
        n_real: Dict[int, int] = {}
        any_draft = False
        for i in active:
            req = self._slots[i].req
            hist = np.concatenate([req.prompt, np.asarray(req.out, np.int32)])
            d = np.asarray(self.proposer.propose(hist, self.spec_k),
                           np.int32).reshape(-1)[:self.spec_k]
            n_real[i] = int(d.size)
            if d.size:
                drafts[i, :d.size] = d
                any_draft = True
        return (drafts, n_real) if any_draft else None

    def _spec_rows(self, active, n_real):
        return [(i, self._slots[i].req, n_real.get(i, 0)) for i in active]

    def _spec_step(self, active, drafts, n_real) -> int:
        """One sync speculative round: the verify dispatch over the
        uploaded state, then the host's accept walk (1..k+1 tokens a
        slot). Returns the k+1 positions a slot the dispatch charged."""
        self._h2d_into(self._ddrafts, drafts, decode=True)
        out = self._verify_fn()
        self.n_dispatches += 1
        res = self._fetch(out)  # [B, k+2]: k+1 tokens, then acc
        self._apply_spec(res[:, :-1], res[:, -1],
                         self._spec_rows(active, n_real))
        return len(active) * (self.spec_k + 1)

    # -- decode rounds -----------------------------------------------------
    def _spec_gate(self, active, budget_left) -> bool:
        """Under a token budget a verify round charges active*(k+1): take
        plain decode instead while a slot is mid-prefill, so its chunks
        keep landing (the starvation guard of the K-step chunk)."""
        return self.spec_k is not None and (
            budget_left is None
            or (len(active) * (self.spec_k + 1) <= budget_left
                and self.num_prefilling == 0))

    def _scan_gate(self, active, budget_left) -> bool:
        """A K-step chunk must fit every active slot's remaining budget and
        the step's token budget, and must not starve a mid-prefill slot."""
        k = self.decode_chunk
        return (k > 1
                and min(self._slots[i].remaining for i in active) >= k
                and (budget_left is None
                     or (len(active) * k <= budget_left
                         and self.num_prefilling == 0)))

    def _run_decode(self, active, budget_left) -> tuple:
        """Launch the single step or the K-step chunk over the persistent
        state; returns ``(tokens [B] or [K, B] on the device, K)``."""
        if self._scan_gate(active, budget_left):
            out, k = self._chunk_fn(), self.decode_chunk
        else:
            out, k = self._decode_fn(), 1
        self.n_dispatches += 1
        self.decode_steps += k
        return out, k

    def _decode_step(self, budget_left: Optional[int]) -> int:
        """One sync decode round for every decode-phase slot (a
        speculative verify, a single step or a ``decode_chunk`` chunk):
        the state is uploaded whole, the tokens read back. Returns the
        real tokens scheduled."""
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
        for dst, x in ((self._dtok, tok), (self._dtab, tables),
                       (self._dcl, cl), (self._dfin, fin)):
            self._h2d_into(dst, x, decode=True)
        if self._spec_gate(active, budget_left):
            proposed = self._propose_drafts(active)
            if proposed is not None:
                return self._spec_step(active, *proposed)
        out, k = self._run_decode(active, budget_left)
        toks = self._fetch(out).reshape(k, self.B)
        self._apply_decode(toks, [(i, self._slots[i].req) for i in active])
        return len(active) * k

    # -- overlap mode: persistent device state and the copy ring ------------
    @property
    def _dstate(self):
        """The persistent device state ``(tok, tables, cache_len,
        finished)``."""
        return self._dtok, self._dtab, self._dcl, self._dfin

    def _mark_dirty(self, slot_idx: int) -> None:
        """A slot joined or left: its device row is stale until the next
        flush. Over-marking is harmless (the flush derives the row from
        host truth); under-marking is the fault the device-vs-host
        invariant test pins down."""
        if self.overlap:
            self._dirty.add(slot_idx)

    def _ensure_dstate(self) -> None:
        """Upload the initial device state (every row idle) once."""
        if self._dstate_live:
            return
        B, mb = self.B, self.max_blocks_per_seq
        for dst, x in ((self._dtok, np.zeros((B,), np.int32)),
                       (self._dtab, np.full((B, mb), self._trash, np.int32)),
                       (self._dcl, np.zeros((B,), np.int32)),
                       (self._dfin, np.ones((B,), bool))):
            self._h2d_into(dst, x, decode=True)
        self._dstate_live = True

    def _flush_dirty(self) -> None:
        """Write every dirty slot's row into the device state in place —
        the only steady-state upload of overlap mode (a batch that keeps
        decoding has no dirty rows). One upload a row: its table row,
        ``cache_len``, token and finished flag as int32. A row is live on
        the device iff the slot is decode-ready; every other row maps to
        the trash table and finished."""
        if not self.overlap or not self._dirty:
            return
        self._ensure_dstate()
        mb = self.max_blocks_per_seq
        for i in sorted(self._dirty):
            slot = self._slots[i]
            packed = np.empty((mb + 3,), np.int32)
            if slot.decode_ready:
                packed[:mb] = self._tables[i]
                packed[mb:] = (slot.cache_len, slot.req.out[-1], 0)
            else:
                packed[:mb] = self._trash
                packed[mb:] = (0, 0, 1)
            d = self._h2d(packed, decode=True)
            self._dtab[i].copy_(d[:mb])
            self._dcl[i].copy_(d[mb])
            self._dtok[i].copy_(d[mb + 1])
            self._dfin[i].copy_(d[mb + 2] != 0)
        self._rows_flushed += len(self._dirty)
        self._dirty.clear()

    def _push_entry(self, kind, outs, rows) -> None:
        """Park a dispatch's outputs on the ring: their copies to pinned
        host memory start now, behind the dispatch on the same stream and
        before any later dispatch, so a replay that reuses the program's
        output memory cannot overwrite them; the host reads them a step
        later."""
        self._ring.append(_RingEntry(
            kind, [self._start_d2h(t) for t in outs], rows))

    def _harvest(self, *, drain: bool = False) -> int:
        """Process ring entries down to ``pipeline_depth`` (all with
        ``drain=True``): wait for each entry's copies — usually done — and
        run the host bookkeeping the sync loop does inline. Returns the
        real tokens emitted, also added to ``_harvested_step``."""
        target = 0 if drain else self.pipeline_depth
        real = 0
        while len(self._ring) > target:
            e = self._ring.popleft()
            vals = [self._finish_d2h(c) for c in e.copies]
            if e.kind == "spec":
                real += self._apply_spec(vals[0][:, :-1], vals[0][:, -1],
                                         e.rows)
            elif e.kind == "decode":
                real += self._apply_decode(vals[0].reshape(-1, self.B),
                                           e.rows)
            else:  # "first": a prefill round's completing rows
                for i, req in e.rows:
                    real += self._apply_first_token(i, req, int(vals[0][i]))
        self._harvested_step += real
        return real

    def _dispatch_decode_async(self, budget_left: Optional[int]) -> int:
        """Issue this step's decode round from the persistent device state
        — no host reads, no per-step uploads of tables or lengths — and
        park its tokens on the ring. Mid-prefill and pending-first rows
        are already trash on the device. Returns the budget charged."""
        active = self._decode_rows()
        if not active:
            return 0
        if self._ring and self._spec_gate(active, budget_left):
            # a speculative round keeps one sync point: the proposer needs
            # the whole emitted history, and drafts against a tail that
            # lags the in-flight dispatch would miss their positions
            self._harvest(drain=True)
            self._flush_dirty()  # the harvest may have changed membership
            active = self._decode_rows()
            if not active:
                return 0
        self._ensure_dstate()
        if self._spec_gate(active, budget_left):
            proposed = self._propose_drafts(active)
            if proposed is not None:
                drafts, n_real = proposed
                self._h2d_into(self._ddrafts, drafts, decode=True)
                out = self._verify_fn()
                self.n_dispatches += 1
                self._push_entry("spec", (out,),
                                 self._spec_rows(active, n_real))
                return len(active) * (self.spec_k + 1)
        out, k = self._run_decode(active, budget_left)
        self._push_entry("decode", (out,),
                         [(i, self._slots[i].req) for i in active])
        return len(active) * k

    # -- the engine loop -----------------------------------------------------
    def step(self) -> List[GenRequest]:
        """One engine iteration. Sync mode: admit, then the token-budgeted
        work — the decode round first, leftover budget spent on prefill
        chunks (whole-prompt mode prefills inside admission). Overlap mode
        (lag-1): flush the dirty rows, dispatch this step's decode from
        the device state, then harvest the previous step's tokens and do
        the host's scheduling while the device runs. Returns the requests
        completed this iteration."""
        if self.overlap:
            return self._step_overlap()
        t0 = time.perf_counter()
        blocked0 = self.host_blocked_s
        before = set(self._completed)
        self._step_spec_overcharge = 0
        used = self._admit()
        budget = self.max_num_batched_tokens
        used += self._decode_step(None if budget is None else budget - used)
        if self.chunked:
            used += self._prefill_step(budget - used)
        self._finish_step(t0, blocked0, used,
                          used - self._step_spec_overcharge)
        return [self._completed[r] for r in set(self._completed) - before]

    def _step_overlap(self) -> List[GenRequest]:
        """The lag-1 iteration: step N+1's decode is issued before step
        N's tokens are processed. Membership changes (admissions, prefill
        completions, finishes) land in the dirty set and reach the device
        at the next step's flush, a dispatch boundary."""
        t0 = time.perf_counter()
        blocked0 = self.host_blocked_s
        before = set(self._completed)
        self._step_spec_overcharge = 0
        budget = self.max_num_batched_tokens
        self._harvested_step = 0
        self._flush_dirty()
        used = self._dispatch_decode_async(budget)
        # nothing dispatched: no compute to overlap with, so drain (a
        # pending-first token would otherwise wait behind a long prefill)
        self._harvest(drain=used == 0)
        a_used = self._admit()
        used += a_used
        pf = 0
        if self.chunked:
            pf = self._prefill_step(budget - used)
            used += pf
        if self._ring and not self.num_active and not self._queue:
            # idle with an over-issued dispatch in flight: read and discard
            self._harvest(drain=True)
        self._finish_step(t0, blocked0, used,
                          self._harvested_step + a_used + pf)
        return [self._completed[r] for r in set(self._completed) - before]

    def _finish_step(self, t0: float, blocked0: float, used: int,
                     real: int) -> None:
        """Per-step accounting: ``used`` is the budget charged (a verify
        round charges k+1 a slot), ``real`` the tokens that drained
        backlog; EWMAs of the step time, the tokens a step and the
        host-blocked share, over steps that did work."""
        self.steps += 1
        self.last_step_tokens = used
        self.max_step_tokens = max(self.max_step_tokens, used)
        self.last_step_s = time.perf_counter() - t0
        self.busy_s += self.last_step_s
        if used > 0 or real > 0:
            a = 0.3
            self.ewma_step_s = (self.last_step_s if self.ewma_step_s is None
                                else a * self.last_step_s
                                + (1 - a) * self.ewma_step_s)
            self.ewma_step_tokens = (float(real)
                                     if self.ewma_step_tokens is None
                                     else a * real
                                     + (1 - a) * self.ewma_step_tokens)
            blocked = self.host_blocked_s - blocked0
            frac = (min(blocked / self.last_step_s, 1.0)
                    if self.last_step_s > 0 else 0.0)
            self.ewma_blocked_frac = (frac if self.ewma_blocked_frac is None
                                      else a * frac
                                      + (1 - a) * self.ewma_blocked_frac)

    def run(self, max_steps: int = 100_000) -> Dict[object, GenRequest]:
        """Drain the queue + active slots; returns {req_id: GenRequest}."""
        while (self._queue or self.num_active) and max_steps > 0:
            self.step()
            max_steps -= 1
        if self._ring:
            # a dispatch for rows that all finished at the last harvest
            self._harvest(drain=True)
        if self._restore_training:
            self.model.train()
        return dict(self._completed)
