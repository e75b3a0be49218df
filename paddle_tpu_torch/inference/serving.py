"""Continuous batching over the paged KV cache (counterpart of
``paddle_tpu/inference/serving.py:ContinuousBatchingEngine``).

A fixed pool of device blocks, a fixed number of batch slots, requests
admitted as slots and blocks free up, finished sequences evicted and their
blocks recycled.

- Every device program is a ``jit.to_static`` function over persistent
  device buffers, the counterpart of the reference's ``jax.jit`` programs:
  the prefill program (ids ``[B, W]``, block tables, ``cache_len``, the
  last real position per row; ``W`` is ``prompt_pad``, or ``prefill_chunk``
  in chunked mode) returns only the ``[B]`` greedy tokens at those
  positions; the decode-phase programs (the single step, the
  ``decode_chunk`` K-step chunk and the speculative verify) read the
  persistent ``(tok, tables, cache_len, finished)`` (and the drafts) and
  write their next ``(tok, cache_len, finished)`` into them in place. On
  the card the first call of each runs eagerly and the next captures it
  as a CUDA graph, which every later dispatch replays; a program that
  cannot be captured raises. ``jit.enable_to_static(False)`` runs them
  eagerly. Host counters a replay cannot bump (``decode_steps``,
  ``n_dispatches``, the kernels' launch counts) are added per dispatch.
  ``warmed_up`` says when every program this configuration dispatches has
  been captured.
- Prefill admits prompt tokens into a slot; rows not taking part have
  their table pointed entirely at a reserved TRASH block, so their writes
  land in a sacrificial page and live sequences are untouched. The decode
  step writes every row too, so rows that are mid-prefill or inactive are
  pointed at the trash block for it.
- Whole-prompt prefill (default) runs one padded prefill of width
  ``prompt_pad`` per admission. Chunked prefill (``prefill_chunk=C``)
  feeds prompts C tokens at a time under ``max_num_batched_tokens`` real
  tokens per step: the decode round first, then chunks round-robin.
- ``decode_chunk=K`` runs K decode steps per dispatch, in one program
  with tokens, lengths and eos state kept on the device, in place of the
  reference's ``lax.scan``.
- The pools are updated in place (the JAX engine donates them) and never
  rebound: the captured graphs hold their addresses.
- ``kv_dtype="int8"`` stores the KV pools in int8 with f32 per-token
  scale pools; each decode step then runs the int8 paged-decode kernel.
- ``prefix_cache=True`` keeps finished prompts' full KV blocks pinned in a
  :class:`PrefixCache`; a later prompt sharing a block-aligned prefix
  adopts them (ref-counted, copy-on-write) and prefills only the rest.
  ``tenant_namespaces=True`` keys the cache by the request's ``tenant``;
  ``shared_prefixes`` are token sequences (system prompts) every tenant
  may adopt from a shared namespace. ``cache_tier=HostTier(...)`` writes
  each registered prefix through to host memory as a CRC-framed export
  and, when a prompt's radix hit is shorter than a spilled prefix, imports
  it back into fresh blocks of the same pools (in place) before the
  reservation.
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
  runs N+1. A slot finishing (or expiring) in entry N may be over-issued
  one dispatch: the extra token is discarded at harvest and its KV write
  lands behind the causal mask. Streams are token-identical to
  ``overlap=False``. Blocks freed while a dispatch is in flight are safe
  to reuse: every later use of them is a later launch on the same stream.

The front door (the reference's overload control): with
``admission=AdmissionConfig(...)`` submissions run through an
:class:`~.admission.AdmissionController` (admit, shed, or displace a
queued batch request), the waiting queue becomes a bounded priority queue
(interactive ahead of batch; WFQ tag, then remaining budget within a
class), and KV occupancy drives the degraded modes (pause new admissions,
clamp batch token grants). ``add_request(deadline=, priority=, retries=,
trace=)``: a request whose deadline lapses is expired in the queue, at
admission, or evicted mid-prefill or mid-decode, and its blocks recycle.
``load()`` is the live :class:`~.admission.EngineLoad`; ``fence()`` and
``requeue()`` are the supervisor's recovery hooks; ``drain_shed()``
returns the requests shed since the last drain.

Observability: the engine's counters live in the ``obs`` registry
(labels ``engine=<id>``); TTFT, inter-token latency and queue delay feed
its SLO histograms; each request's spans (admission, prefill, decode, and
with tracing on the dispatch and harvest spans) land in the trace ring.
Spans are opened and closed on the host, around the programs, never
inside a captured graph. Chaos sites: ``serving.submit`` (a ``drop``
sheds the submission), ``serving.step`` (a ``drop`` skips the iteration,
an ``error`` raises), and the tier's ``cache.spill``. With
``utils.resources.instrument_resources()`` on, engine slots and blocks are
accounted in the resource ledger.

Disaggregated prefill/decode (``role=``): ``role="prefill_only"`` makes a
prefill worker. Prompts admit and prefill as before, reserving blocks for
the prompt alone, but when a prompt's last chunk lands the slot is
released and the request parks handoff-ready (its first token attached,
its blocks still owned) until ``drain_prefilled()`` + ``export_kv()`` +
``release_handoff()`` (``inference/disagg.py``) or its deadline; the
engine never dispatches a decode program and captures only the prefill
one. ``role="decode_only"`` makes a decode worker: ``import_kv()`` writes
an exported prompt's pages into fresh blocks of its pools (in place),
binds a free slot and resumes decode at the cached offset; the row
reaches the persistent device state through the ordinary dirty-row
upload. A decode worker keeps the whole prefill path, so a router can
fall back to serving a prompt on it colocated.

Greedy decoding only (as the reference's engine), so engine outputs are
token-identical to isolated ``generate`` runs and to the JAX engine on the
same weights. ``fp8=True`` runs every Linear but the lm_head as an fp8
delayed-scaling GEMM (``amp/fp8.py``); the engine's model is in eval mode,
so every call scales just in time.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import jit
from .. import obs as _obs
from ..obs.metrics import MetricAttr, registry as _obs_registry
from ..ops.paged_attention import (BlockImportError, BlockManager,
                                   PagedLayerCache, PrefixCache)
from ..testing import chaos as _chaos
from ..utils import resources as _res
from ..utils.retries import Deadline
from .admission import (AdmissionConfig, AdmissionController, EngineLoad,
                        priority_rank)
from .speculative import DraftProposer, NgramProposer

__all__ = ["GenRequest", "ContinuousBatchingEngine", "EngineFenced"]


class EngineFenced(RuntimeError):
    """The engine was retired by its supervisor: a replacement owns its
    requests now, so this instance must not touch them again. ``step()``
    raises it once the fence is set."""


def _exec_lock_for(model) -> threading.Lock:
    """One lock per model, across engines: program dispatches (and the
    captures they may run) of engines sharing a model never overlap, and
    a dispatch that waited on the lock while its engine was fenced raises
    instead of running."""
    lock = getattr(model, "__serving_exec_lock__", None)
    if lock is None:
        lock = threading.Lock()
        model.__serving_exec_lock__ = lock
    return lock


@dataclass
class GenRequest:
    """One generation request: prompt ids + budget. ``deadline`` is the
    request's wall-clock budget (queue wait included): admission rejects
    it once expired, and a slot is evicted when it expires mid-prefill or
    mid-decode. ``status``: "ok" (finished normally), "expired" (whatever
    tokens it produced stay in ``out``), "shed" (rejected at admission;
    ``shed_reason`` says why). ``priority`` is the admission class
    ("interactive" | "batch"); ``retries`` counts supervisor recoveries;
    ``clamped`` records a degraded-mode ``max_new_tokens`` reduction.
    ``times[i]`` is the ``perf_counter`` stamp when ``out[i]`` was
    produced. ``tenant`` names the submitting tenant (prefix-cache
    namespace, SLO series); ``trace_id``/``span_id`` are its trace
    context."""

    req_id: object
    prompt: np.ndarray  # [s] int
    max_new_tokens: int = 32
    out: List[int] = field(default_factory=list)
    deadline: Optional[Deadline] = None
    status: str = "ok"
    t_submit: float = 0.0
    times: List[float] = field(default_factory=list)
    priority: str = "interactive"
    shed_reason: Optional[str] = None
    retries: int = 0
    clamped: bool = False
    tenant: str = "default"
    trace_id: Optional[str] = None
    span_id: Optional[str] = None

    def expired(self) -> bool:
        return self.deadline is not None and self.deadline.expired()

    def ttft(self) -> Optional[float]:
        """Seconds from submission to the first token (None if none)."""
        return self.times[0] - self.t_submit if self.times else None

    def inter_token_latencies(self) -> List[float]:
        return [b - a for a, b in zip(self.times, self.times[1:])]


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
    discards the tokens of a row whose slot changed hands meanwhile).
    ``span`` is the open dispatch span (issue to harvest)."""

    __slots__ = ("kind", "copies", "rows", "span")

    def __init__(self, kind, copies, rows):
        self.kind = kind  # "decode" | "spec" | "first"
        self.copies = copies  # [(host tensor, event or None)]
        self.rows = rows
        self.span = None


class _ShedCounts:
    """Dict-shaped view over the per-priority ``serving_shed_total``
    registry series: ``eng.n_shed["interactive"]``, ``.get()``,
    ``.items()`` and dict equality behave like a plain dict, while the
    counts live in the obs registry (labels ``engine=<id>,
    priority=<class>``)."""

    __slots__ = ("_labels", "_handles")

    def __init__(self, labels: dict):
        self._labels = dict(labels)
        self._handles: Dict[str, object] = {}
        for pri in ("interactive", "batch"):
            self[pri] = 0

    def _h(self, pri: str):
        h = self._handles.get(pri)
        if h is None:
            h = _obs_registry().counter(
                "serving_shed_total",
                {**self._labels, "priority": str(pri)},
                help="requests shed at admission, by priority class")
            self._handles[pri] = h
        return h

    def __getitem__(self, pri) -> int:
        return int(self._h(pri).value)

    def __setitem__(self, pri, v) -> None:
        self._h(pri).set_(float(v))

    def get(self, pri, default=0):
        h = self._handles.get(pri)
        return int(h.value) if h is not None else default

    def keys(self):
        return self._handles.keys()

    def values(self):
        return [int(h.value) for h in self._handles.values()]

    def items(self):
        return [(k, int(h.value)) for k, h in self._handles.items()]

    def __iter__(self):
        return iter(self._handles)

    def __len__(self) -> int:
        return len(self._handles)

    def __eq__(self, other):
        if isinstance(other, _ShedCounts):
            return dict(self.items()) == dict(other.items())
        if isinstance(other, dict):
            return dict(self.items()) == other
        return NotImplemented

    def __repr__(self) -> str:
        return repr(dict(self.items()))


_ROLES = ("unified", "prefill_only", "decode_only")

_ENGINE_IDS = itertools.count(1)


class ContinuousBatchingEngine:
    # every stats counter below is a registry-backed series (label
    # engine=<id>): ``self.steps += 1`` and outside writes
    # (``eng.ewma_step_s = None``) work as on plain attributes, while the
    # numbers live in the process-global obs registry
    n_imported = MetricAttr(
        "serving_kv_imported_total", as_int=True,
        help="decode side: requests entered via KV import")
    n_handed_off = MetricAttr(
        "serving_kv_handed_off_total", as_int=True,
        help="prefill side: KV exports released after ack")
    prefix_hit_tokens = MetricAttr(
        "serving_prefix_hit_tokens_total", as_int=True,
        help="prompt tokens served from the prefix cache")
    prefix_forks = MetricAttr(
        "serving_prefix_forks_total", as_int=True,
        help="copy-on-write block forks from adopted prefixes")
    spec_proposed = MetricAttr(
        "serving_spec_proposed_total", as_int=True,
        help="real draft tokens sent to verify")
    spec_accepted = MetricAttr(
        "serving_spec_accepted_total", as_int=True,
        help="draft tokens greedy-accepted by verify")
    spec_emitted = MetricAttr(
        "serving_spec_emitted_total", as_int=True,
        help="tokens emitted by verify dispatches")
    spec_dispatches = MetricAttr(
        "serving_spec_dispatches_total", as_int=True,
        help="speculative verify dispatches")
    spec_slot_rounds = MetricAttr(
        "serving_spec_slot_rounds_total", as_int=True,
        help="slot participations in verify dispatches")
    n_dispatches = MetricAttr(
        "serving_dispatches_total", as_int=True,
        help="decode-phase device dispatches")
    host_blocked_s = MetricAttr(
        "serving_host_blocked_seconds_total",
        help="cumulative seconds the host blocked on D2H fetches")
    busy_s = MetricAttr(
        "serving_busy_seconds_total",
        help="cumulative step() wall seconds")
    h2d_bytes = MetricAttr(
        "serving_h2d_bytes_total", as_int=True,
        help="host->device upload bytes")
    h2d_decode_bytes = MetricAttr(
        "serving_h2d_decode_bytes_total", as_int=True,
        help="host->device bytes on the decode-phase critical path")
    d2h_bytes = MetricAttr(
        "serving_d2h_bytes_total", as_int=True,
        help="device->host fetch bytes")
    steps = MetricAttr(
        "serving_steps_total", as_int=True, help="engine iterations")
    decode_tokens = MetricAttr(
        "serving_decode_tokens_total", as_int=True,
        help="decode-phase tokens emitted")
    prefill_tokens = MetricAttr(
        "serving_prefill_tokens_total", as_int=True,
        help="prompt tokens prefilled (cache hits excluded)")
    n_expired = MetricAttr(
        "serving_expired_total", as_int=True,
        help="accepted-then-expired requests (queue or in-flight)")
    ewma_blocked_frac = MetricAttr(
        "serving_host_blocked_frac", kind="gauge",
        help="EWMA of the per-step host-blocked fraction")
    ewma_step_s = MetricAttr(
        "serving_ewma_step_seconds", kind="gauge",
        help="EWMA of non-idle step wall time")
    ewma_step_tokens = MetricAttr(
        "serving_ewma_step_tokens", kind="gauge",
        help="EWMA of real tokens drained per non-idle step")

    def __init__(self, model, *, max_batch: int, max_len: int,
                 block_size: int = 64, num_blocks: int,
                 prompt_pad: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 decode_chunk: int = 1,
                 prefill_chunk: Optional[int] = None,
                 max_num_batched_tokens: Optional[int] = None,
                 admission: Optional[AdmissionConfig] = None,
                 prefix_cache: bool = False,
                 spec_decode_k: Optional[int] = None,
                 draft_proposer: Optional[DraftProposer] = None,
                 kv_dtype: Optional[str] = None,
                 fp8: bool = False,
                 role: str = "unified",
                 overlap: bool = False,
                 cache_tier=None,
                 tenant_namespaces: bool = False,
                 shared_prefixes=None):
        """``num_blocks`` fixes the KV budget (the pool allocates one extra
        trash block); ``max_len`` bounds any sequence's positions;
        ``prompt_pad`` is the whole-prompt prefill width (default one
        block). ``decode_chunk=K`` runs K decode steps per dispatch when
        every active slot has at least K tokens of budget left (and, with a
        token budget, no slot is mid-prefill and active*K fits).
        ``prefill_chunk=C`` turns on chunked prefill with at most
        ``max_num_batched_tokens`` (default ``max_batch + C``) real tokens
        per step. ``admission=AdmissionConfig(...)`` turns on overload
        control (module docstring). ``prefix_cache=True`` turns on prefix
        KV reuse, keyed by tenant with ``tenant_namespaces=True``
        (``shared_prefixes``: token sequences every tenant may adopt), with
        a host-RAM spill tier under it given ``cache_tier``;
        ``kv_dtype="int8"`` quantizes the KV pools; ``spec_decode_k=K``
        turns on speculative decoding with ``draft_proposer`` (default
        :class:`NgramProposer`); ``overlap=True`` pipelines host and device
        (module docstring). ``role`` places the engine in a disaggregated
        deployment: "unified" (everything), "prefill_only" (no decode
        dispatches; finished prefills park handoff-ready) or "decode_only"
        (takes ``import_kv`` handoffs; otherwise a unified engine, the
        colocated fallback). ``fp8=True`` swaps every Linear except the
        lm_head for an :class:`~..amp.fp8.Fp8Linear` before any program is
        built (``fp8_layers`` counts them)."""
        if role not in _ROLES:
            raise ValueError(
                f"role must be 'unified', 'prefill_only' or "
                f"'decode_only', got {role!r}")
        self.role = role
        # obs identity first: every MetricAttr write below routes into
        # registry series labeled engine=<id>
        self._obs_id = f"eng{next(_ENGINE_IDS)}"
        self._obs_labels = {"engine": self._obs_id}
        self._slo_hists: Dict[str, tuple] = {}
        self._c_tenant_req: Dict[str, object] = {}
        self._slo_handles("default")
        self._c_requests = _obs_registry().counter(
            "serving_requests_total", self._obs_labels,
            help="requests submitted (shed ones included)")
        # finished prefills awaiting export (prefill_only): req_id ->
        # GenRequest; the blocks stay owned under the req_id until
        # export_kv + release_handoff (or expiry)
        self._handoff_ready: Dict[object, GenRequest] = {}
        self.n_imported = 0  # decode side: requests entered via import
        self.n_handed_off = 0  # prefill side: exports released
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
        # the resource ledger when instrument_resources() is on, else None
        self._graft_ledger = _res.current()
        self.prefix_cache = (PrefixCache(block_size, manager=self.manager)
                             if prefix_cache else None)
        if cache_tier is not None and self.prefix_cache is None:
            raise ValueError("cache_tier requires prefix_cache=True")
        if tenant_namespaces and self.prefix_cache is None:
            raise ValueError("tenant_namespaces requires prefix_cache=True")
        self.cache_tier = cache_tier
        self._tenant_ns = bool(tenant_namespaces)
        self._shared_prefixes = [np.asarray(p, np.int32).reshape(-1)
                                 for p in (shared_prefixes or ())]
        self._tier_seq = 0
        self.tier_restores = 0
        self.tier_restore_tokens = 0
        self.tier_spill_bytes = 0  # bytes read from the device to spill
        self.tier_spill_s = 0.0  # host seconds those reads took
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
        # fp8 GEMMs: swap every Linear (except the lm_head: its logits feed
        # sampling, where fp8 costs measurable quality for one GEMM of
        # savings) for Fp8Linear before any program is built
        self.fp8 = bool(fp8)
        if self.fp8:
            from ..amp import convert_to_fp8

            self.fp8_layers = convert_to_fp8(
                model, exclude=lambda name: "lm_head" in name)
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

        # the programs' persistent device inputs: each program reads these
        # buffers (and the decode-phase ones write their next (tok,
        # cache_len, finished) into them in place), so their addresses
        # never change
        dev, B, mb = self.device, self.B, self.max_blocks_per_seq
        width = self.prefill_chunk if self.chunked else self.prompt_pad
        self._pids = torch.zeros((B, width), dtype=torch.int32, device=dev)
        self._ptab = torch.full((B, mb), self._trash, dtype=torch.int32,
                                device=dev)
        self._pcl = torch.zeros(B, dtype=torch.int32, device=dev)
        self._plast = torch.zeros(B, dtype=torch.int32, device=dev)
        self._dtok = torch.zeros(B, dtype=torch.int32, device=dev)
        self._dtab = torch.full((B, mb), self._trash, dtype=torch.int32,
                                device=dev)
        self._dcl = torch.zeros(B, dtype=torch.int32, device=dev)
        self._dfin = torch.ones(B, dtype=torch.bool, device=dev)
        self._ddrafts = (None if self.spec_k is None else
                         torch.zeros((B, self.spec_k), dtype=torch.int32,
                                     device=dev))
        # full_graph=True: a program that cannot be captured raises
        (self._prefill_fn, self._decode_fn, self._chunk_fn,
         self._verify_fn) = (
            jit.to_static(fn, layers=[model], full_graph=True)
            for fn in (self._prefill_program, self._decode_program,
                       self._chunk_program, self._verify_program))
        # capture events name each program after its engine
        # (obs.install_compile_events: graph_captures_total{program})
        for sf in (self._prefill_fn, self._decode_fn, self._chunk_fn,
                   self._verify_fn):
            sf.name = f"{self._obs_id}:{sf._fn.__name__}"

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
        self.ewma_blocked_frac = None
        self.h2d_bytes = 0  # host->device upload bytes
        self.h2d_decode_bytes = 0  # ...on the decode-phase path
        self.d2h_bytes = 0  # device->host read bytes
        self._harvested_step = 0  # real tokens harvested this step
        self.steps = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.last_step_tokens = 0
        self.max_step_tokens = 0
        self._step_spec_overcharge = 0
        # overload control and the supervision surface
        self.admission = (None if admission is None
                          else AdmissionController(admission))
        self.n_shed = _ShedCounts(self._obs_labels)
        self._pending_shed: List[GenRequest] = []  # sheds since the drain
        self.n_expired = 0  # accepted-then-expired (queue or in-flight)
        self.prefill_paused = False  # degraded mode: KV blocks scarce
        self.ewma_step_s = None
        self.ewma_step_tokens = None
        self.last_step_s = 0.0
        self._fenced = False
        self._exec_lock = _exec_lock_for(model)
        self._phases_run: set = set()  # programs dispatched so far

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

    def _run(self, fn, phase: str):
        """Dispatch one program under the model's execution lock, honoring
        the fence before and after (a dispatch that outlived its engine's
        retirement must not apply its results)."""
        with self._exec_lock:
            if self._fenced:
                raise EngineFenced(
                    "engine was retired by its supervisor while waiting "
                    "for the execution lock")
            out = fn()
        self._phases_run.add(phase)
        if self._fenced:
            raise EngineFenced(
                "engine was retired by its supervisor mid-dispatch")
        return out

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy one physical block's KV, in place, in every layer's pools
        (scale rows included: a forked block's scales travel with its
        bytes) — the device half of a copy-on-write fork."""
        for entry in self._pools:
            for pool in entry:
                pool[:, dst] = pool[:, src]

    @torch.no_grad()
    def _prefill_program(self) -> torch.Tensor:
        """One prefill over the persistent inputs (ids ``[B, W]``, tables,
        ``cache_len``, last real position per row); returns the greedy
        token at the last position per row ``[B]``: the one int per row
        the host reads from a prefill."""
        logits, _ = self.model.forward_with_cache(
            self._pids, self._caches(self._ptab), self._pcl)
        rows = torch.arange(self.B, device=logits.device)
        return torch.argmax(logits[rows, self._plast.long()],
                            dim=-1).to(torch.int32)

    def _prefill(self, ids, tables, cache_len, last_idx) -> torch.Tensor:
        """Upload one prefill's inputs into the persistent buffers and
        dispatch the prefill program; returns its ``[B]`` tokens on the
        device."""
        for dst, x in ((self._pids, ids), (self._ptab, tables),
                       (self._pcl, cache_len), (self._plast, last_idx)):
            self._h2d_into(dst, x)
        return self._run(self._prefill_fn, "prefill")

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

    def _program_ready(self, fn) -> bool:
        """No first-call work is left for ``fn``: it has been captured, or
        it never will be (CPU tensors, ``enable_to_static(False)``)."""
        return (bool(fn._graphs) or self.device.type != "cuda"
                or fn._eager())

    # -- public API ------------------------------------------------------
    @property
    def chunked(self) -> bool:
        return self.prefill_chunk is not None

    @property
    def warmed_up(self) -> bool:
        """True once every program this configuration can dispatch (the
        prefill and decode programs, and the K-step chunk when
        ``decode_chunk > 1``) has been dispatched and, on the card,
        captured: no first-call work remains. A supervisor keeps a step
        under its roomy warm-up budget until then. A prefill-only engine
        needs only the prefill program: it never dispatches decode."""
        need = {"prefill": self._prefill_fn}
        if self.role != "prefill_only":
            need["decode"] = self._decode_fn
            if self.decode_chunk > 1:
                need["decode_chunk"] = self._chunk_fn
        return all(name in self._phases_run and self._program_ready(fn)
                   for name, fn in need.items())

    def _slo_handles(self, tenant: str):
        """(ttft, itl, queue-delay) histogram handles for one tenant's
        series (labels ``engine=<id>, tenant=<t>``), cached so the
        per-token path pays one dict hit."""
        hs = self._slo_hists.get(tenant)
        if hs is None:
            reg = _obs_registry()
            lab = {**self._obs_labels, "tenant": str(tenant)}
            hs = (
                reg.histogram("serving_ttft_seconds", lab,
                              help="seconds from submission to first token"),
                reg.histogram("serving_itl_seconds", lab,
                              help="inter-token latency seconds"),
                reg.histogram("serving_queue_delay_seconds", lab,
                              help="seconds from submission to slot binding"),
            )
            self._slo_hists[tenant] = hs
        return hs

    def _tenant_requests(self, tenant: str):
        """Per-tenant submission counter handle
        (``serving_tenant_requests_total``)."""
        h = self._c_tenant_req.get(tenant)
        if h is None:
            h = _obs_registry().counter(
                "serving_tenant_requests_total",
                {**self._obs_labels, "tenant": str(tenant)},
                help="requests submitted, by tenant")
            self._c_tenant_req[tenant] = h
        return h

    def add_request(self, req_id, prompt, max_new_tokens: int = 32,
                    deadline=None, priority: str = "interactive",
                    retries: int = 0, trace=None,
                    tenant: str = "default") -> GenRequest:
        """Queue one prompt for ``max_new_tokens`` greedy tokens.
        ``deadline``: seconds or a ``Deadline``, the request's whole
        budget (queue wait included); None = no deadline. ``priority``:
        the admission class ("interactive" | "batch"), always recorded.
        ``retries`` seeds the recovery counter. ``trace``: an upstream
        trace context (a Span, a ``{"trace_id", "span_id"}`` dict, or an
        object carrying those); otherwise a fresh trace is minted.
        ``tenant`` names the prefix-cache namespace (with
        ``tenant_namespaces=True``) and labels the SLO series. With
        admission control a shed submission comes back with ``status ==
        "shed"`` (it also lands in the completed map)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        priority_rank(priority)  # validate before accepting anything
        if prompt.size == 0:
            raise ValueError("prompt length 0 not in [1, ...]")
        if not self.chunked and prompt.size > self.prompt_pad:
            raise ValueError(
                f"prompt length {prompt.size} not in [1, prompt_pad="
                f"{self.prompt_pad}] (enable prefill_chunk to serve "
                "prompts beyond the whole-prompt pad)")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        dl = None if deadline is None else Deadline.coerce(deadline)
        req = GenRequest(req_id, prompt, max_new_tokens, deadline=dl,
                         t_submit=time.perf_counter(), priority=priority,
                         retries=int(retries), tenant=str(tenant))
        if self._blocks_needed(req) > self.manager.num_blocks:
            raise ValueError(
                f"request needs {self._blocks_needed(req)} blocks but the "
                f"pool only has {self.manager.num_blocks} — it could never "
                "be admitted")
        ctx = _obs.trace_ctx(trace)
        req.trace_id = (ctx or {}).get("trace_id") or _obs.new_trace_id()
        self._c_requests.inc()
        self._tenant_requests(req.tenant).inc()
        with _obs.span("admission", trace_id=req.trace_id, parent=ctx,
                       tid="serve", req=str(req_id),
                       priority=priority, tenant=req.tenant) as sp:
            req.span_id = sp.span_id
            out = self._decide_admission(req)
            sp.args["verdict"] = ("shed" if out.status == "shed"
                                  else "admit")
        return out

    def _decide_admission(self, req: GenRequest) -> GenRequest:
        """The admission verdict (chaos gate + overload control), the body
        the request's root ``admission`` span wraps."""
        # chaos site: the front door (drop = the submission is shed)
        if not _chaos.inject("serving.submit"):
            return self._shed(req, "chaos-drop")
        if self.admission is None:
            self._queue.append(req)
            return req
        # expired queue entries must not count against the arrival
        self._expire_queued()
        # decide() reads a fresh load snapshot; tightening observations
        # run only from step() (the level hold is counted in engine
        # steps), but a drained engine never steps, so it relaxes here
        load = self.load()
        if load.active_slots == 0 and load.queue_depth == 0:
            self.admission.observe(load, allow_tighten=False)
        verdict, reason = self.admission.decide(req, load)
        if verdict == "shed":
            return self._shed(req, reason)
        if verdict == "displace":
            # queue full, arrival interactive: the worst queued batch
            # request (last in queue order) absorbs the shed
            victim = next((r for r in reversed(self._queue)
                           if priority_rank(r.priority) >= 1), None)
            if victim is not None:
                try:
                    self._queue.remove(victim)
                except ValueError:
                    victim = None
            if victim is not None:
                self._shed(victim, "displaced")
            elif len(self._queue) >= self.admission.config.max_queue:
                return self._shed(req, "queue-full")
        self._enqueue(req)
        return req

    def _shed(self, req: GenRequest, reason: str) -> GenRequest:
        req.status = "shed"
        req.shed_reason = reason
        self.n_shed[req.priority] = self.n_shed.get(req.priority, 0) + 1
        self._completed[req.req_id] = req
        self._pending_shed.append(req)
        return req

    def drain_shed(self) -> List[GenRequest]:
        """Return (and clear) the requests shed since the last drain.
        Sheds happen between steps, so no ``step()`` returns them."""
        out, self._pending_shed = self._pending_shed, []
        return out

    def _enqueue(self, req: GenRequest) -> None:
        """Priority insert: interactive ahead of batch; within a class the
        WFQ finish tag first (0.0 for every request when WFQ is off), then
        the tighter deadline (unbounded last, arrival order kept: the key
        is fixed at insert time)."""
        rem = (float("inf") if req.deadline is None
               else req.deadline.remaining())
        tag = 0.0
        if self.admission is not None and self.admission.wfq_enabled:
            start, tag = self.admission.wfq_tag(
                req.tenant, self.admission._cost(req))
            req._wfq_start = start
        req._okey = (priority_rank(req.priority), tag, rem)
        lo = 0
        while lo < len(self._queue) and self._queue[lo]._okey <= req._okey:
            lo += 1
        self._queue.insert(lo, req)

    def requeue(self, req: GenRequest) -> None:
        """Re-enter an already-accepted request (the supervisor's recovery
        path): no admission control, progress reset so this engine
        reproduces the whole output. A request this engine can never serve
        is shed instead of queued (it would block the queue forever)."""
        req.out, req.times, req.status = [], [], "ok"
        if not req.t_submit:
            req.t_submit = time.perf_counter()
        self._completed.pop(req.req_id, None)
        if (int(req.prompt.size) + req.max_new_tokens > self.max_len
                or self._blocks_needed(req) > self.manager.num_blocks
                or (not self.chunked
                    and int(req.prompt.size) > self.prompt_pad)):
            self._shed(req, "unservable-on-this-engine")
            return
        if self.admission is not None:
            self._enqueue(req)
        else:
            self._queue.append(req)

    def fence(self) -> None:
        """Retire this engine: every later ``step()`` raises
        :class:`EngineFenced`."""
        self._fenced = True

    def _kv_occupancy(self) -> float:
        """Allocated fraction of the KV block pool — the one definition the
        load signal and both degraded-mode watermarks share."""
        return 1.0 - self.manager.free_blocks / max(self.manager.num_blocks,
                                                    1)

    def load(self) -> EngineLoad:
        """Live load snapshot (the admission controller's input): queue
        depth and class mix, KV occupancy, committed-token backlog, and the
        measured service rate."""
        queue = list(self._queue)
        backlog = sum(int(r.prompt.size) + r.max_new_tokens for r in queue)
        backlog_inter = sum(int(r.prompt.size) + r.max_new_tokens
                            for r in queue
                            if priority_rank(r.priority) == 0)
        for slot in self._slots:
            req = slot.req
            if req is not None:
                ahead = (int(req.prompt.size) - slot.prefill_pos
                         + slot.remaining)
                backlog += ahead
                backlog_inter += ahead  # in-flight work delays everyone
        tps = self.ewma_step_tokens or float(
            self.max_num_batched_tokens or self.B)
        delay = (backlog / max(tps, 1e-9)) * (self.ewma_step_s or 0.0)
        cfg = self.admission.config if self.admission is not None else None
        reg = _obs_registry()
        qf = (len(queue) / cfg.max_queue
              if cfg is not None and cfg.max_queue else 0.0)
        reg.gauge("serving_queue_frac", self._obs_labels).set(qf)
        reg.gauge("serving_kv_occupancy", self._obs_labels).set(
            self._kv_occupancy())
        reg.gauge("serving_est_queue_delay_s", self._obs_labels).set(delay)
        return EngineLoad(
            queue_depth=len(queue),
            queue_limit=None if cfg is None else cfg.max_queue,
            queued_interactive=sum(
                priority_rank(r.priority) == 0 for r in queue),
            queued_batch=sum(priority_rank(r.priority) >= 1 for r in queue),
            token_backlog_interactive=backlog_inter,
            active_slots=self.num_active,
            max_batch=self.B,
            prefilling=self.num_prefilling,
            kv_free_blocks=self.manager.free_blocks,
            kv_total_blocks=self.manager.num_blocks,
            kv_occupancy=self._kv_occupancy(),
            token_backlog=backlog,
            tokens_per_step=tps,
            ewma_step_s=self.ewma_step_s,
            est_queue_delay_s=delay,
            admission_level=0 if self.admission is None
            else self.admission.level,
            prefill_paused=self.prefill_paused,
            n_shed_interactive=self.n_shed.get("interactive", 0),
            n_shed_batch=self.n_shed.get("batch", 0),
            n_expired=self.n_expired,
            host_blocked_frac=self.ewma_blocked_frac or 0.0,
            dispatch_depth=len(self._ring),
        )

    @property
    def num_active(self):
        return sum(s.active for s in self._slots)

    @property
    def num_prefilling(self):
        return sum(s.prefilling for s in self._slots)

    def _blocks_needed(self, req, max_new_tokens: Optional[int] = None) -> int:
        new = (req.max_new_tokens if max_new_tokens is None
               else int(max_new_tokens))
        if self.role == "prefill_only":
            # no decode happens here: the budget is the prompt alone (the
            # padded lanes past the owned blocks write into the trash row)
            new = 0
        if self.chunked:
            total = int(req.prompt.size) + new
        else:
            total = max(int(req.prompt.size) + new, self.prompt_pad)
        return self.manager.blocks_for(total)

    def _append_token(self, req: GenRequest, tok: int):
        req.out.append(tok)
        now = time.perf_counter()
        req.times.append(now)
        # the one token-emission point feeds TTFT and inter-token latency
        # on the request's tenant series
        h_ttft, h_itl, _ = self._slo_handles(req.tenant)
        if len(req.times) == 1:
            h_ttft.observe(now - req.t_submit)
        else:
            h_itl.observe(now - req.times[-2])

    @staticmethod
    def _finish_req_spans(req: GenRequest, **args) -> None:
        """Close the request's open prefill/decode spans (completion,
        expiry)."""
        for attr in ("_sp_prefill", "_sp_decode"):
            sp = getattr(req, attr, None)
            if sp is not None:
                _obs.finish_span(sp, **args)
                setattr(req, attr, None)

    def _expire(self, req: GenRequest) -> None:
        req.status = "expired"
        self.n_expired += 1
        self._finish_req_spans(req, error="expired")
        self._completed[req.req_id] = req

    def _expire_queued(self) -> None:
        """Every queued request whose deadline lapsed before its first
        prefill chunk finishes as ``expired`` here, at no token cost."""
        live = []
        for r in self._queue:
            if r.expired():
                self._expire(r)
            else:
                live.append(r)
        if len(live) != len(self._queue):
            self._queue[:] = live

    def _evict_expired(self) -> None:
        """Reclaim slots whose request's deadline passed, mid-prefill or
        mid-decode: free the blocks, point the row at the trash block, mark
        it dirty (overlap mode re-uploads it as trash at the next flush),
        and complete the request as expired. A ring entry still in flight
        for the row is discarded at harvest (its request no longer owns
        the slot); its device writes precede, on the same stream, every
        later launch that could touch the freed blocks."""
        for slot_idx, slot in enumerate(self._slots):
            if slot.active and slot.req.expired():
                self.manager.free_sequence(slot.req.req_id)
                self._tables[slot_idx] = self._trash
                self._expire(slot.req)
                if self._graft_ledger is not None:
                    self._graft_ledger.release("engine.slot",
                                               slot.req.req_id)
                slot.req = None
                slot.pending_first = False
                self._mark_dirty(slot_idx)
        # handoff-ready work whose budget lapsed before its export: the
        # blocks recycle and the request closes here
        for rid in [r for r, q in self._handoff_ready.items()
                    if q.expired()]:
            req = self._handoff_ready.pop(rid)
            self.manager.free_sequence(rid)
            if self._graft_ledger is not None:
                self._graft_ledger.release("handoff.hold", rid)
            self._expire(req)

    def prefix_stats(self) -> dict:
        """Prefix-cache counters (zeros when the cache is off).
        ``hit_rate`` is cached tokens over prompt tokens that entered a
        slot: the share of prefill work the cache saved. The tree's own
        lookup tallies count head-of-line re-probes, so only its shape
        keys are reported beside the engine's adopted-token count. With a
        host tier, ``tier`` holds its counters, the restores, and the
        spills' device-read bytes and seconds."""
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
        if self.cache_tier is not None:
            base["tier"] = dict(self.cache_tier.stats(),
                                restores=self.tier_restores,
                                restore_tokens=self.tier_restore_tokens,
                                spill_bytes=self.tier_spill_bytes,
                                spill_s=self.tier_spill_s)
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

    # -- prefix namespaces and the host tier ----------------------------------
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
        per tree, copy-on-write for every adopter. Then spill the
        full-block prefix to the host tier."""
        ns = req.tenant if self._tenant_ns else None
        self.prefix_cache.insert(req.prompt, blocks, ns=ns)
        if self._tenant_ns:
            sh = self._shared_prefix_len(req.prompt)
            if sh:
                self.prefix_cache.insert(req.prompt[:sh],
                                         blocks[:sh // self.block_size],
                                         ns="*")
        self._tier_spill(req, ns)

    def _tier_spill(self, req, ns) -> None:
        """Write-through: export the prompt's full blocks (a device read
        behind the prefill that wrote them, counted as host-blocked time
        and in ``tier_spill_bytes``/``tier_spill_s``) and store the frame;
        a registered shared prefix is stored under the shared namespace
        too. Best effort: a failed spill is a later miss, never an
        error."""
        if self.cache_tier is None:
            return
        full = (int(req.prompt.size) // self.block_size) * self.block_size
        if not full:
            return
        try:
            t0 = time.perf_counter()
            pages, scales, meta = self.manager.export_blocks(
                req.req_id, self._pools, num_tokens=full)
            dt = time.perf_counter() - t0
            self.tier_spill_s += dt
            self.host_blocked_s += dt
            self.tier_spill_bytes += int(pages.nbytes) + (
                0 if scales is None else int(scales.nbytes))
            self.cache_tier.put(ns, req.prompt[:full], pages, scales, meta)
            if self._tenant_ns:
                sh = self._shared_prefix_len(req.prompt)
                if sh:
                    k = sh // self.block_size
                    self.cache_tier.put(
                        "*", req.prompt[:sh], pages[:, :, :, :k],
                        None if scales is None else scales[:, :, :, :k],
                        dict(meta, num_blocks=k))
        except Exception:  # noqa: BLE001 - a failed spill is a miss
            pass

    def _tier_restore(self, req) -> None:
        """Read-through: when the host tier holds a longer prefix than the
        radix tree, import it into fresh blocks of the existing pools (in
        place, on the stream the programs run on) and pin it, so the
        adoption path treats it as an ordinary hit. Any failure (a
        CRC-rejected frame, a pool too full even after eviction) is a
        miss."""
        if self.cache_tier is None:
            return
        cached_len, _ = self._prefix_lookup(req)
        ns = req.tenant if self._tenant_ns else None
        hit = self.cache_tier.lookup(ns, req.prompt,
                                     block_size=self.block_size,
                                     min_tokens=cached_len)
        if hit is None and self._tenant_ns:
            hit = self.cache_tier.lookup("*", req.prompt,
                                         block_size=self.block_size,
                                         min_tokens=cached_len)
        if hit is None:
            return
        n_tokens, pages, scales, meta = hit
        need = int(meta["num_blocks"])
        if need > self.manager.free_blocks:
            self.prefix_cache.evict(need - self.manager.free_blocks)
        sid = ("__tier__", self._tier_seq)
        self._tier_seq += 1
        try:
            _, blocks = self.manager.import_blocks(sid, pages, scales, meta,
                                                   self._pools)
        except (BlockImportError, ValueError):
            return  # pool genuinely full, or a configuration drift: a miss
        # pin under the tree first (new nodes take their own refs), then
        # drop the import's ownership: the cache pins alone remain
        self.prefix_cache.insert(req.prompt[:n_tokens], blocks, ns=ns)
        self.manager.free_sequence(sid)
        self.tier_restores += 1
        self.tier_restore_tokens += int(n_tokens)

    def _reserve_blocks(self, req, eff_new: int):
        """Block-availability half of slot binding, prefix-cache aware:
        restore a longer prefix from the host tier, look up the prompt's
        cached prefix, ADOPT those blocks, and check the shortfall against
        the free list, evicting LRU cache entries when it runs short.
        Returns ``(ok, cached_len, will_fork)``; on ``ok=False`` the
        adoption is undone (head-of-line wait).

        ``cached_len`` is capped at ``prompt.size - 1``: the first token
        comes from the last prompt position's logits, which only a real
        prefill produces, so a fully cached prompt recomputes one token —
        whose write lands inside the last shared block, which the caller
        must then fork (``will_fork``)."""
        psize = int(req.prompt.size)
        cached_len, cached_blocks = 0, []
        if self.prefix_cache is not None:
            self._tier_restore(req)
            cached_len, cached_blocks = self._prefix_lookup(req)
            cached_len = min(cached_len, psize - 1)
        will_fork = bool(cached_len % self.block_size)
        need = (self._blocks_needed(req, eff_new) - len(cached_blocks)
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
        """Fill free slots from the queue while blocks last (queue order,
        head-of-line). Whole-prompt mode runs one padded prefill per
        admission, of the prompt's un-cached remainder at offset
        ``cached_len``; chunked mode only binds the slot, reserves its
        full block budget and starts its chunks at ``cached_len``.
        Returns real tokens processed.

        Degraded modes (admission control only): at KV occupancy above
        ``kv_pause_watermark`` new admissions pause (reclaimable cached
        prefixes are evicted first), and above ``kv_clamp_watermark``
        batch-class token grants are clamped to ``batch_clamp_tokens`` at
        slot binding."""
        cfg = self.admission.config if self.admission is not None else None
        if cfg is not None:
            if self._kv_occupancy() >= cfg.kv_pause_watermark:
                if self.prefix_cache is not None:
                    want = int(np.ceil(
                        (1.0 - cfg.kv_pause_watermark)
                        * self.manager.num_blocks)) + 1
                    self.prefix_cache.evict(
                        max(want - self.manager.free_blocks, 0))
                if self._kv_occupancy() >= cfg.kv_pause_watermark:
                    self.prefill_paused = True
                    return 0
            self.prefill_paused = False
        used = 0
        for slot_idx, slot in enumerate(self._slots):
            # a request expired while queued is not prefilled; each
            # request stays visible in the queue, a slot or the completed
            # map at every instant (expired or bound before it leaves)
            while self._queue and self._queue[0].expired():
                self._expire(self._queue[0])
                self._queue.pop(0)
            if not self._queue or slot.active:
                continue
            req = self._queue[0]
            # decide the clamp before the block check (under scarcity the
            # clamped footprint is what fits), apply it only once admitted
            clamp = (cfg is not None and cfg.batch_clamp_tokens is not None
                     and priority_rank(req.priority) >= 1
                     and req.max_new_tokens > cfg.batch_clamp_tokens
                     and self._kv_occupancy() >= cfg.kv_clamp_watermark)
            eff_new = cfg.batch_clamp_tokens if clamp else req.max_new_tokens
            ok, cached_len, will_fork = self._reserve_blocks(req, eff_new)
            if not ok:
                break  # head-of-line: keep the queue's order
            if clamp:
                req.max_new_tokens = int(cfg.batch_clamp_tokens)
                req.clamped = True
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
            if self._graft_ledger is not None:
                self._graft_ledger.acquire("engine.slot", req.req_id)
            slot.remaining = req.max_new_tokens
            slot.pending_first = False
            self._mark_dirty(slot_idx)
            self._slo_handles(req.tenant)[2].observe(
                time.perf_counter() - req.t_submit)
            req._sp_prefill = _obs.start_span(
                "prefill", parent=req, tid="serve",
                prompt_tokens=int(req.prompt.size),
                cached_tokens=int(cached_len))
            self._queue.pop(0)  # bound above: it leaves the queue last
            if self.admission is not None:
                # WFQ service feedback: virtual time advances to the start
                # tag of the request entering service
                self.admission.wfq_served(getattr(req, "_wfq_start", None))
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
            firsts = self._prefill(ids, iso, cl, last_idx)
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
            self._finish_req_spans(req, tokens=len(req.out))
            self._completed[req.req_id] = req
            slot.req = None
            if self._graft_ledger is not None:
                self._graft_ledger.release("engine.slot", req.req_id)
            slot.pending_first = False
            self._mark_dirty(slot_idx)
        return done

    def _apply_first_token(self, slot_idx: int, req: GenRequest,
                           first: int) -> int:
        """Host bookkeeping of a finished prefill's first token (inline in
        sync mode, at harvest in overlap mode). Returns tokens emitted: 0
        when the slot changed hands (or its request expired) while the
        token was in flight."""
        slot = self._slots[slot_idx]
        if slot.req is not req:
            return 0
        slot.pending_first = False
        sp = getattr(req, "_sp_prefill", None)
        if sp is not None:
            _obs.finish_span(sp)
            req._sp_prefill = None
        self._append_token(req, first)
        slot.remaining -= 1
        self._mark_dirty(slot_idx)
        if self.role != "prefill_only":
            # a prefill-only engine never decodes: the decode span opens on
            # the decode worker at the import
            req._sp_decode = _obs.start_span("decode", parent=req,
                                             tid="serve")
        if (not self._finish_if_done(slot_idx, first)
                and self.role == "prefill_only"):
            self._to_handoff(slot_idx)
        return 1

    def _apply_decode(self, toks: np.ndarray, rows) -> int:
        """Credit one decode dispatch's tokens ``[K, B]`` to its rows; a
        row whose request no longer owns its slot (finished, expired or
        replaced after the dispatch: overlap mode's over-issue) is
        skipped."""
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
                n += 1
                if self._finish_if_done(i, t):
                    break
        self.decode_tokens += n  # one registry write a dispatch
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
                emitted += 1
                if self._finish_if_done(i, t):
                    break
        self.decode_tokens += emitted
        self.spec_emitted += emitted
        self._step_spec_overcharge += charged - emitted
        return emitted

    # -- disaggregated prefill/decode handoff -----------------------------
    def _to_handoff(self, slot_idx: int) -> None:
        """Prefill-role slot release: the prompt's KV is complete and its
        first token attached, so the slot frees for the next prompt while
        the blocks stay owned under the req_id until ``export_kv`` +
        ``release_handoff`` (or the deadline). The row is trashed: no
        later dispatch touches the blocks being exported."""
        slot = self._slots[slot_idx]
        req = slot.req
        self._handoff_ready[req.req_id] = req
        self._tables[slot_idx] = self._trash
        slot.req = None
        if self._graft_ledger is not None:
            # the slot frees; the hold on the exported blocks begins
            self._graft_ledger.release("engine.slot", req.req_id)
            self._graft_ledger.acquire("handoff.hold", req.req_id)
        slot.pending_first = False
        self._mark_dirty(slot_idx)

    def drain_prefilled(self) -> List[GenRequest]:
        """Return (and claim) the requests whose prefill finished since the
        last drain. Each still owns its blocks: the caller calls
        ``export_kv`` then ``release_handoff`` (a transfer), or
        ``release_handoff`` alone (abandon: the blocks recycle, the caller
        re-routes the request)."""
        out = list(self._handoff_ready.values())
        self._handoff_ready.clear()
        return out

    def export_kv(self, req_id, kv_len: Optional[int] = None):
        """Gather a handoff-ready request's blocks into host arrays:
        ``(pages, scales, meta)`` as
        :meth:`~..ops.paged_attention.BlockManager.export_blocks` gives
        them, with ``meta["kv_len"]`` the positions written (``kv_len``,
        normally the prompt length). Idempotent: the blocks stay owned, so
        a failed transfer re-exports the same bytes; ``release_handoff``
        only once the transfer is acked. On the card the gather runs under
        the model's execution lock, so it never lands inside another
        engine's capture."""
        if not _chaos.inject("handoff.export"):
            raise ConnectionResetError(
                "chaos: KV export dropped (lost message)")
        if kv_len is None:
            kv_len = (len(self.manager.owned_blocks(req_id))
                      * self.block_size)
        with self._exec_lock:
            pages, scales, meta = self.manager.export_blocks(
                req_id, self._pools, num_tokens=int(kv_len))
        meta["kv_len"] = int(min(int(kv_len),
                                 meta["num_blocks"] * self.block_size))
        return pages, scales, meta

    def release_handoff(self, req_id) -> None:
        """Drop an exported request's blocks (transfer acked, or the
        handoff abandoned): they recycle through the ref-counted free, so
        prefix-cache pins survive."""
        self.manager.free_sequence(req_id)
        if self._graft_ledger is not None:
            self._graft_ledger.release("handoff.hold", req_id)
        self.n_handed_off += 1

    def import_kv(self, req: GenRequest, first_token: int,
                  pages, scales, meta) -> None:
        """Decode-side entry of a transferred prompt: write the exported
        pages into fresh blocks of this engine's pools (in place: the
        captured programs keep their addresses), bind a free slot, and
        resume decode at the cached offset with ``first_token`` already
        emitted (it came from the prefill engine's logits; the next decode
        dispatch writes its KV at position ``kv_len``, as a local
        prefill's first decode would).

        Raises :class:`~..ops.paged_attention.BlockImportError` (transient:
        retry under the request's deadline) when no slot or not enough
        free blocks are available now; ``ValueError`` for a configuration
        mismatch no retry can fix. A failed import leaves nothing
        behind."""
        if self._fenced:
            raise EngineFenced(
                "engine was retired by its supervisor; a replacement "
                "already owns the requests")
        psize = int(req.prompt.size)
        kv_len = int(meta.get("kv_len", meta["num_blocks"]
                              * self.block_size))
        if kv_len != psize:
            raise ValueError(
                f"import_kv: transferred kv_len {kv_len} != prompt "
                f"length {psize}")
        if psize + req.max_new_tokens > self.max_len:
            raise ValueError(
                "import_kv: prompt + max_new_tokens exceeds max_len")
        slot_idx = next(
            (i for i, s in enumerate(self._slots) if not s.active), None)
        if slot_idx is None:
            raise BlockImportError(
                "no free decode slot for the imported request")
        total = self.manager.blocks_for(psize + req.max_new_tokens)
        if total > self.manager.num_blocks:
            # permanent: this pool can never hold the request, so the
            # caller falls back to colocated serving instead of retrying
            raise ValueError(
                f"import_kv: needs {total} blocks to import + decode, "
                f"pool has {self.manager.num_blocks} TOTAL")
        if total > self.manager.free_blocks:
            raise BlockImportError(
                f"need {total} free blocks to import + decode, "
                f"{self.manager.free_blocks} free")
        with self._exec_lock:
            self.manager.import_blocks(req.req_id, pages, scales, meta,
                                       self._pools)
        try:
            self.manager.allocate(req.req_id, psize + req.max_new_tokens)
        except RuntimeError as e:  # raced another import on the tail
            self.manager.free_sequence(req.req_id)
            raise BlockImportError(str(e)) from None
        self._tables[slot_idx] = self.manager.table_row(
            req.req_id, self.max_blocks_per_seq, fill=self._trash)
        slot = self._slots[slot_idx]
        req.out, req.times, req.status = [], [], "ok"
        if not req.t_submit:
            req.t_submit = time.perf_counter()
        slot.req = req
        if self._graft_ledger is not None:
            self._graft_ledger.acquire("engine.slot", req.req_id)
        slot.prefill_pos = psize
        slot.cache_len = psize
        slot.remaining = req.max_new_tokens
        slot.pending_first = False
        self._append_token(req, int(first_token))
        slot.remaining -= 1
        self.n_imported += 1
        self._mark_dirty(slot_idx)
        # the decode leg parents under the context the handoff header
        # carried (set by the caller on req)
        req._sp_decode = _obs.start_span("decode", parent=req,
                                         tid="serve", imported=True)
        self._finish_if_done(slot_idx, int(first_token))

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
            firsts = self._prefill(ids, iso, cl, last_idx)
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

    def _dispatch_span(self, active, kind: str):
        """The sync dispatch span of a decode-phase round (tracing on)."""
        if not _obs.enabled():
            return None
        return _obs.start_span("dispatch", parent=self._slots[active[0]].req,
                               tid="device", kind=kind, rows=len(active))

    def _harvest_span(self, sp_d, kind: str):
        return (_obs.start_span("harvest", parent=sp_d, tid="serve",
                                kind=kind) if sp_d is not None else None)

    def _spec_step(self, active, drafts, n_real) -> int:
        """One sync speculative round: the verify dispatch over the
        uploaded state, then the host's accept walk (1..k+1 tokens a
        slot). Returns the k+1 positions a slot the dispatch charged."""
        sp_d = self._dispatch_span(active, "spec")
        self._h2d_into(self._ddrafts, drafts, decode=True)
        out = self._run(self._verify_fn, "spec_verify")
        self.n_dispatches += 1
        res = self._fetch(out)  # [B, k+2]: k+1 tokens, then acc
        _obs.finish_span(sp_d)
        hsp = self._harvest_span(sp_d, "spec")
        self._apply_spec(res[:, :-1], res[:, -1],
                         self._spec_rows(active, n_real))
        _obs.finish_span(hsp)
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
            out = self._run(self._chunk_fn, "decode_chunk")
            k = self.decode_chunk
        else:
            out, k = self._run(self._decode_fn, "decode"), 1
        self.n_dispatches += 1
        self.decode_steps += k
        return out, k

    def _decode_step(self, budget_left: Optional[int]) -> int:
        """One sync decode round for every decode-phase slot (a
        speculative verify, a single step or a ``decode_chunk`` chunk):
        the state is uploaded whole, the tokens read back. Returns the
        real tokens scheduled."""
        if self.role == "prefill_only":
            return 0  # decode belongs to the other pool
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
        sp_d = self._dispatch_span(active, "decode")
        out, k = self._run_decode(active, budget_left)
        toks = self._fetch(out).reshape(k, self.B)
        _obs.finish_span(sp_d)
        hsp = self._harvest_span(sp_d, "decode")
        self._apply_decode(toks, [(i, self._slots[i].req) for i in active])
        _obs.finish_span(hsp)
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
        later. With tracing on, a dispatch span opens here (issue) and
        closes at harvest."""
        e = _RingEntry(kind, [self._start_d2h(t) for t in outs], rows)
        if _obs.enabled():
            e.span = _obs.start_span(
                "dispatch", parent=(rows[0][1] if rows else None),
                tid="device", kind=kind, rows=len(rows))
        self._ring.append(e)

    def _harvest(self, *, drain: bool = False) -> int:
        """Process ring entries down to ``pipeline_depth`` (all with
        ``drain=True``): wait for each entry's copies — usually done — and
        run the host bookkeeping the sync loop does inline. Returns the
        real tokens emitted, also added to ``_harvested_step``."""
        target = 0 if drain else self.pipeline_depth
        real = 0
        while len(self._ring) > target:
            e = self._ring.popleft()
            _obs.finish_span(e.span)  # issue -> harvest pickup
            hsp = (self._harvest_span(e.span, e.kind)
                   if _obs.enabled() else None)
            got0 = real
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
            if hsp is not None:
                _obs.finish_span(hsp, tokens=real - got0)
        self._harvested_step += real
        return real

    def _dispatch_decode_async(self, budget_left: Optional[int]) -> int:
        """Issue this step's decode round from the persistent device state
        — no host reads, no per-step uploads of tables or lengths — and
        park its tokens on the ring. Mid-prefill and pending-first rows
        are already trash on the device. Returns the budget charged."""
        if self.role == "prefill_only":
            return 0
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
                out = self._run(self._verify_fn, "spec_verify")
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
        """One engine iteration. Sync mode: expire and evict lapsed
        requests, admit, then the token-budgeted work — the decode round
        first, leftover budget spent on prefill chunks (whole-prompt mode
        prefills inside admission). Overlap mode (lag-1): flush the dirty
        rows, dispatch this step's decode from the device state, then
        harvest the previous step's tokens and do the host's scheduling
        while the device runs. Returns the requests completed this
        iteration (expired ones included)."""
        if not _chaos.inject("serving.step"):
            return []  # a dropped iteration: no work this tick
        if self._fenced:
            raise EngineFenced(
                "engine was retired by its supervisor; a replacement "
                "already owns the requests")
        if self.overlap:
            return self._step_overlap()
        t0 = time.perf_counter()
        blocked0 = self.host_blocked_s
        before = set(self._completed)
        self._expire_queued()
        self._evict_expired()
        self._step_spec_overcharge = 0
        used = self._admit()
        budget = self.max_num_batched_tokens
        used += self._decode_step(None if budget is None else budget - used)
        if self.chunked:
            used += self._prefill_step(budget - used)
        self._finish_step(t0, blocked0, used,
                          used - self._step_spec_overcharge)
        if self.admission is not None:
            self.admission.observe(self.load())
        return [self._completed[r] for r in set(self._completed) - before]

    def _step_overlap(self) -> List[GenRequest]:
        """The lag-1 iteration: step N+1's decode is issued before step
        N's tokens are processed. Membership changes (admissions, prefill
        completions, finishes, evictions) land in the dirty set and reach
        the device at the next step's flush, a dispatch boundary."""
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
        self._expire_queued()
        self._evict_expired()
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
        if self.admission is not None:
            self.admission.observe(self.load())
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
        a = (self.admission.config.ewma_alpha
             if self.admission is not None else 0.3)
        if used > 0 or real > 0:
            # idle ticks are left out so a quiet engine does not decay its
            # measured capacity toward zero
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
