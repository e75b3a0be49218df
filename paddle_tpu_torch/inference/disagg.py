"""Disaggregated prefill/decode serving: crash-safe KV-block handoff
(counterpart of ``paddle_tpu/inference/disagg.py``, copied over the port's
engine, supervisor, cluster router, stores and flight recorder). The wire
format is the reference's byte for byte: bfloat16 pages travel as their
raw 16-bit patterns and are named ``"bfloat16"`` in the header, as the
reference's ``ml_dtypes`` arrays are, so a payload either package packs
the other unpacks and imports. On the card the export is one gather of
the request's blocks into pinned host memory, on the prefill engine's
side; the decode engine's import writes its pools in place, so its
captured programs keep reading the same addresses.

Chunked prefill time-slices ONE engine; the production
end-state (DistServe-style disaggregation, Mooncake's KV-centric
transfer) separates the phases into POOLS: prefill workers run
``role="prefill_only"`` engines and stream each finished prompt's KV
blocks to decode workers, so a 4096-token prefill never shares a
compiled program or a batch with latency-critical decode, and the two
pools scale independently. This module is the handoff layer between
them, engineered as a CRASH-ONLY protocol:

- **Idempotent** — a transfer is keyed by ``req_id``; a resend (nack,
  sender retry, router requeue) of an already-imported request is
  acked and dropped by the receiver, so at-least-once delivery serves
  exactly once.
- **Checksummed** — every store leg rides the KV store's
  length-prefixed CRC32 frame (``put_bytes``/``get_bytes``), the
  commit record carries a whole-payload CRC, and a corrupted or
  incomplete transfer is NACKED (transient) — the sender re-sends
  under its deadline; garbage is never imported.
- **Deadline-bounded** — every leg (export, part puts, commit, ack
  wait, import retry) runs under a :class:`Deadline` carved from the
  request's remaining budget, with :class:`RetryPolicy` backoff on
  transient failures.
- **Pipelining-transparent** — workers inherit the
  engine's async host/device pipeline through their ``engine_factory``
  (``overlap=True``; serving.py module docstring): a decode worker's
  hot loop then recycles sampled tokens on device and harvests through
  the copy ring, an imported request's slot reaches the persistent
  device state via the ordinary dirty-slot upload, and a prefill
  worker's handoff-ready parking simply happens one harvest later —
  ``pending()``/``pump()`` need no changes because a slot stays bound
  until its tokens land.
- **Survivable** — a prefill worker killed MID-handoff leaves parts
  without a commit; the decode side simply never imports the partial
  transfer, and the router's recovery (supervisor journal replay ∪ its
  own routing table, exactly the cluster.py design) requeues the
  request token-exact onto a surviving prefill worker — or, when the
  prefill pool is down, FALLS BACK to submitting the prompt directly
  to a decode worker, whose engine serves it colocated (chunked
  prefill): graceful degradation to the proven unified path instead of
  an outage.

Store layout (any :class:`~..distributed.store.KVStore`:
``TCPKVStore`` across hosts, ``MemKVStore`` in process) under
``disagg/<decode_id>/``::

    xfer/<sender>-<inc>-<seq>/part/<i>  CRC-framed payload slices
    xfer/<sender>-<inc>-<seq>/commit    JSON {req_id, parts, bytes, crc}
    ack/<sender>-<inc>-<seq>            "ok" | "corrupt:<reason>" (nack)

The commit record is written LAST: its absence is the partial-transfer
discard signal. Acks persist in the store, so a relaunched receiver
never re-imports what a previous incarnation verified. ``<inc>`` is a
random per-sender-INCARNATION nonce: seq counters restart at 0 in a
relaunched prefill worker, and without the nonce its first transfers
would collide with the previous incarnation's persisted acks — the
sender would read a stale "ok" for a payload the receiver never saw.

Chaos sites: ``handoff.export`` (engine export), ``handoff.transfer``
(every part/commit put — a byte site: ``corrupt`` flips a payload bit
the CRC framing must catch, ``kill`` mid-parts manufactures the
partial transfer), ``handoff.import`` (each committed transfer the
receiver verifies — ``drop`` defers it one poll).

Cross-role observability: each handoff leg is recorded in the
collective flight recorder (``handoff_send`` on the prefill side,
``handoff_recv`` on the decode side — rank-divergent by design, like
send/recv), and :class:`DisaggServer` attaches the flight-recorder
contract store, so a decode-worker hang dump names BOTH roles'
schedules, not just its own stacks.
"""
from __future__ import annotations

import json
import struct
import time
import uuid
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .. import obs as _obs
from ..obs import agg as _obs_agg
from ..distributed.communication import flight_recorder as _fr
from ..distributed.store import CorruptBlobError
from ..ops.paged_attention import BlockImportError
from ..testing import chaos as _chaos
from ..utils import resources as _res
from ..utils.retries import Deadline, RetryPolicy
from .cache_tier import _dtype_name, _np_dtype, _raw
from .cluster import make_record, remaining_budget, result_record
from .serving import EngineFenced, GenRequest
from .supervisor import Journal, ServingSupervisor

__all__ = [
    "HandoffPayload",
    "KVHandoffSender",
    "KVHandoffReceiver",
    "PrefillWorker",
    "DecodeWorker",
    "DisaggRouter",
    "DisaggServer",
]


def _handoff_transient(exc: BaseException) -> bool:
    """Transient taxonomy for handoff legs: transport errors (OSError
    covers reset/refused/timeout), corrupted/truncated frames
    (ValueError incl. CorruptBlobError — re-read/re-send fixes
    in-transit damage), and a destination pool/slot that is full RIGHT
    NOW (BlockImportError — decode drains continuously)."""
    return isinstance(exc, (OSError, ValueError, BlockImportError))



@dataclass
class HandoffPayload:
    """One finished prefill, ready to resume decoding elsewhere: the
    request identity/budget, the FIRST generated token (it came from
    the prefill logits — decode starts by writing its KV), and the raw
    KV pages + int8 scale rows from
    :meth:`~.serving.ContinuousBatchingEngine.export_kv`."""

    req_id: object
    prompt: np.ndarray
    first_token: int
    max_new_tokens: int
    priority: str
    deadline_unix: Optional[float]
    retries: int
    pages: np.ndarray
    scales: Optional[np.ndarray]
    meta: dict
    # carryable trace context ({"trace_id", "span_id"} or None): rides
    # the CRC-framed header so the decode worker's spans parent under
    # the prefill-side trace across the process boundary
    trace: Optional[dict] = None
    # tenant identity rides the handoff too: the decode-side
    # SLO histograms must land on the submitting tenant's series
    tenant: str = "default"

    @classmethod
    def from_request(cls, req: GenRequest, pages, scales,
                     meta) -> "HandoffPayload":
        expires = None
        if req.deadline is not None and req.deadline.budget is not None:
            expires = time.time() + req.deadline.remaining()
        return cls(
            req_id=req.req_id, prompt=np.asarray(req.prompt, np.int32),
            first_token=int(req.out[0]),
            max_new_tokens=int(req.max_new_tokens), priority=req.priority,
            deadline_unix=expires, retries=int(req.retries),
            pages=pages, scales=scales, meta=dict(meta),
            trace=_obs.trace_ctx(req), tenant=req.tenant)

    def remaining_budget(self) -> Optional[float]:
        return (None if self.deadline_unix is None
                else self.deadline_unix - time.time())

    def to_request(self) -> GenRequest:
        rem = self.remaining_budget()
        t = self.trace or {}
        return GenRequest(
            self.req_id, np.asarray(self.prompt, np.int32),
            int(self.max_new_tokens),
            deadline=None if rem is None else Deadline(max(rem, 0.0)),
            t_submit=time.perf_counter(), priority=self.priority,
            retries=int(self.retries), tenant=self.tenant,
            trace_id=t.get("trace_id"), span_id=t.get("span_id"))

    # -- wire format ----------------------------------------------------
    # !I header_len | header json | pages bytes | scales bytes
    # (each store leg is additionally CRC-framed by put_bytes; the
    # commit record carries a whole-payload CRC on top)

    def pack(self) -> bytes:
        header = {
            "req_id": self.req_id,
            "prompt": [int(t) for t in self.prompt],
            "first_token": int(self.first_token),
            "max_new_tokens": int(self.max_new_tokens),
            "priority": self.priority,
            "tenant": self.tenant,
            "deadline_unix": self.deadline_unix,
            "retries": int(self.retries),
            "trace": self.trace,
            "meta": self.meta,
            "pages": {"shape": list(self.pages.shape),
                      "dtype": _dtype_name(self.pages, self.meta)},
            "scales": None if self.scales is None else {
                "shape": list(self.scales.shape),
                "dtype": _dtype_name(self.scales, self.meta)},
        }
        hb = json.dumps(header).encode("utf-8")
        out = struct.pack("!I", len(hb)) + hb + _raw(self.pages).tobytes()
        if self.scales is not None:
            out += _raw(self.scales).tobytes()
        return out

    @classmethod
    def unpack(cls, data: bytes) -> "HandoffPayload":
        if len(data) < 4:
            raise ValueError("handoff payload truncated (no header)")
        (hlen,) = struct.unpack("!I", data[:4])
        if len(data) < 4 + hlen:
            raise ValueError("handoff payload truncated (torn header)")
        header = json.loads(data[4:4 + hlen].decode("utf-8"))
        pdt = _np_dtype(header["pages"]["dtype"])
        pshape = tuple(header["pages"]["shape"])
        psize = int(np.prod(pshape)) * pdt.itemsize
        body = data[4 + hlen:]
        want = psize
        sdt = sshape = None
        if header["scales"] is not None:
            sdt = _np_dtype(header["scales"]["dtype"])
            sshape = tuple(header["scales"]["shape"])
            want += int(np.prod(sshape)) * sdt.itemsize
        if len(body) != want:
            raise ValueError(
                f"handoff payload body is {len(body)} bytes, header "
                f"promises {want}")
        pages = np.frombuffer(body[:psize], dtype=pdt).reshape(pshape)
        scales = None
        if sshape is not None:
            scales = np.frombuffer(body[psize:], dtype=sdt).reshape(sshape)
        return cls(
            req_id=header["req_id"],
            prompt=np.asarray(header["prompt"], np.int32),
            first_token=int(header["first_token"]),
            max_new_tokens=int(header["max_new_tokens"]),
            priority=header.get("priority", "interactive"),
            deadline_unix=header.get("deadline_unix"),
            retries=int(header.get("retries", 0)),
            pages=pages, scales=scales, meta=dict(header["meta"]),
            trace=header.get("trace"),
            tenant=header.get("tenant", "default"))


# ---------------------------------------------------------------------------
# Transfer legs


class KVHandoffSender:
    """Prefill-side transfer leg: split the packed payload into
    CRC-framed parts, write the commit record LAST, wait for the
    receiver's ack — every put retried under the leg's deadline, a
    nack re-sent as a fresh transfer (idempotent by req_id)."""

    def __init__(self, store, channel: str, *, sender_id: str = "pf",
                 part_bytes: int = 1 << 20,
                 n_parts: Optional[int] = None,
                 max_resends: int = 3,
                 retry: Optional[RetryPolicy] = None):
        self.store = store
        self.channel = str(channel)
        self.ns = f"disagg/{self.channel}"
        self.sender_id = str(sender_id)
        self.part_bytes = int(part_bytes)
        self.n_parts = None if n_parts is None else max(1, int(n_parts))
        self.max_resends = int(max_resends)
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=4, base_delay=0.05, max_delay=1.0,
            transient=_handoff_transient)
        # per-incarnation nonce: a relaunched sender's seq counter
        # restarts at 0, and acks persist in the store by design — a
        # bare sender_id-seq would alias the previous incarnation's
        # settled transfers and falsely settle a fresh one off a stale
        # "ok" (the receiver having skipped it as already-acked)
        self.incarnation = uuid.uuid4().hex[:8]
        self._seq = 0
        self.n_sent = 0
        self.n_nacked = 0

    def _split(self, data: bytes) -> List[bytes]:
        if self.n_parts is not None:
            per = -(-len(data) // self.n_parts)
        else:
            per = self.part_bytes
        per = max(per, 1)
        return [data[i:i + per] for i in range(0, len(data), per)] or [b""]

    def send_handoff(self, payload: HandoffPayload,
                     deadline=None) -> str:
        """Post one payload (parts first, commit LAST — a crash in
        between leaves a partial transfer the receiver never imports)
        and return its transfer id. NON-BLOCKING past the store puts:
        the ack arrives asynchronously via :meth:`poll_ack` — in-
        process deployments pump sender and receiver from one thread,
        so a synchronous ack wait would deadlock by construction.
        Raises transient transport errors (already retried under
        ``deadline``) for the caller's policy to handle."""
        dl = Deadline.coerce(deadline if deadline is not None else 30.0)
        data = payload.pack()
        _fr.record("handoff_send", shape=tuple(payload.pages.shape),
                   dtype=_dtype_name(payload.pages, payload.meta),
                   group=f"disagg/{self.channel}",
                   detail=f"req={payload.req_id}")
        self._seq += 1
        seq = f"{self.sender_id}-{self.incarnation}-{self._seq:08d}"
        with _obs.span("handoff_send",
                       parent=_obs.trace_ctx(payload.trace),
                       tid="handoff", channel=self.channel, seq=seq,
                       req=str(payload.req_id), bytes=len(data)):
            self._put_transfer(seq, payload.req_id, data, dl)
        self.n_sent += 1
        return seq

    def poll_ack(self, seq: str) -> Optional[str]:
        """The receiver's verdict on a posted transfer: "ok",
        "corrupt:..." (nack — resend), or None while unsettled."""
        raw = self.store.get(f"{self.ns}/ack/{seq}")
        if raw and raw != "ok":
            self.n_nacked += 1
        return raw or None

    def _put_transfer(self, seq: str, req_id, data: bytes,
                      dl: Deadline) -> None:
        parts = self._split(data)
        for i, part in enumerate(parts):
            # chaos byte site: corrupt flips a bit (the CRC frame must
            # catch it downstream), drop loses this leg (the commit's
            # whole-payload check turns that into a nack), kill
            # mid-parts leaves the partial transfer
            mutated = _chaos.inject_bytes("handoff.transfer", part)
            if mutated is None:
                continue
            key = f"{self.ns}/xfer/{seq}/part/{i:04d}"
            self.retry.call(self.store.put_bytes, key, mutated,
                            deadline=dl, describe="handoff part put")
        commit = json.dumps({
            "req_id": req_id, "parts": len(parts), "bytes": len(data),
            "crc": zlib.crc32(data) & 0xFFFFFFFF,
        })
        mutated = _chaos.inject_bytes(
            "handoff.transfer", commit.encode("utf-8"))
        if mutated is None:
            raise ConnectionResetError(
                "chaos: handoff commit dropped (lost message)")
        self.retry.call(
            self.store.set, f"{self.ns}/xfer/{seq}/commit",
            mutated.decode("utf-8", errors="surrogateescape"),
            deadline=dl, describe="handoff commit put")


class KVHandoffReceiver:
    """Decode-side transfer leg: poll committed transfers, reassemble
    + verify (per-part CRC frames AND the commit's whole-payload CRC),
    nack damage, ack + return verified payloads — deduped by req_id so
    resends and requeues import at most once. Partial transfers (parts
    without a commit — a sender killed mid-handoff) are simply never
    looked at: discard by construction (and deleted from the store
    after ``orphan_grace`` seconds, since the dead sender can't)."""

    def __init__(self, store, channel: str, *,
                 orphan_grace: float = 60.0):
        self.store = store
        self.channel = str(channel)
        self.ns = f"disagg/{self.channel}"
        self.orphan_grace = float(orphan_grace)
        self._done_seqs: Set[str] = set()
        self._seen_reqs: Set = set()
        self._orphan_first_seen: Dict[str, float] = {}
        self.n_received = 0
        self.n_nacked = 0
        self.n_duplicates = 0
        self.n_orphans_gcd = 0

    def recv_handoff(self) -> List[HandoffPayload]:
        """One poll: every newly committed, verifying transfer comes
        back as a payload (acked); corrupt/incomplete ones are nacked
        for the sender to retry. Non-blocking — callers poll from
        their serve loop."""
        out: List[HandoffPayload] = []
        seqs: Set[str] = set()
        committed: Set[str] = set()
        for key in self.store.keys(self.ns + "/xfer/"):
            seqs.add(key[len(self.ns + "/xfer/"):].split("/", 1)[0])
            if key.endswith("/commit"):
                committed.add(key[len(self.ns + "/xfer/"):
                                  -len("/commit")])
        for seq in sorted(committed):
            if seq in self._done_seqs:
                continue
            if self.store.get(f"{self.ns}/ack/{seq}"):
                # a previous incarnation of this receiver settled it
                # (and died between the ack write and the GC)
                self._done_seqs.add(seq)
                self._gc(seq)
                continue
            if not _chaos.inject("handoff.import"):
                continue  # dropped: deferred to the next poll
            payload = self._settle(seq, f"{self.ns}/xfer/{seq}/commit")
            if payload is not None:
                out.append(payload)
        self._gc_orphans(seqs - committed)
        return out

    def _gc_orphans(self, uncommitted: Set[str]) -> None:
        """Parts with no commit are a sender killed mid-handoff (or a
        commit put that never landed) — the dead sender can't clean
        them up, so the receiver does, after a grace window generous
        vs any live sender's part-upload time. GC'ing a slow-but-ALIVE
        sender is safe (crash-only: its commit then assembles against
        missing parts, nacks, and the sender re-sends fresh); leaking
        is not — each orphan pins MB-scale KV bytes in the store
        forever and inflates every later poll's key scan."""
        now = time.monotonic()
        for seq in list(self._orphan_first_seen):
            if seq not in uncommitted:
                del self._orphan_first_seen[seq]  # committed or gone
        for seq in uncommitted:
            if seq in self._done_seqs:
                continue
            first = self._orphan_first_seen.setdefault(seq, now)
            if now - first > self.orphan_grace:
                self._gc(seq)
                del self._orphan_first_seen[seq]
                self.n_orphans_gcd += 1

    def _settle(self, seq: str, commit_key: str
                ) -> Optional[HandoffPayload]:
        # the span starts BEFORE the trace context is known (it rides
        # the payload being assembled); Span is mutable, so the parent
        # is attached once the header verifies
        sp = _obs.start_span("handoff_recv", tid="handoff",
                             channel=self.channel, seq=seq)
        try:
            payload = self._assemble(seq, commit_key)
        except (CorruptBlobError, ValueError, KeyError) as e:
            # damage is TRANSIENT: nack so the sender's RetryPolicy
            # re-sends instead of the importer swallowing garbage
            # (as a FRESH transfer — this seq's records are garbage)
            self._done_seqs.add(seq)
            self.store.set(f"{self.ns}/ack/{seq}",
                           f"corrupt:{type(e).__name__}: {e}"[:200])
            self.n_nacked += 1
            self._gc(seq)
            _obs.finish_span(sp, verdict="nack",
                             error=type(e).__name__)
            return None
        t = payload.trace or {}
        if t.get("trace_id"):
            sp.trace_id = t["trace_id"]
            sp.parent_id = t.get("span_id")
        self._done_seqs.add(seq)
        self.store.set(f"{self.ns}/ack/{seq}", "ok")
        self._gc(seq)
        if payload.req_id in self._seen_reqs:
            self.n_duplicates += 1  # resend of an imported request
            _obs.finish_span(sp, verdict="duplicate")
            return None
        self._seen_reqs.add(payload.req_id)
        self.n_received += 1
        _fr.record("handoff_recv", shape=tuple(payload.pages.shape),
                   dtype=_dtype_name(payload.pages, payload.meta),
                   group=f"disagg/{self.channel}",
                   detail=f"req={payload.req_id}")
        _obs.finish_span(sp, verdict="ok", req=str(payload.req_id),
                         bytes=int(payload.pages.nbytes))
        return payload

    def _assemble(self, seq: str,
                  commit_key: str) -> HandoffPayload:
        raw = self.store.get(commit_key)
        if raw is None:
            raise ValueError(f"commit {seq} vanished")
        commit = json.loads(raw)
        n_parts = int(commit["parts"])
        chunks = []
        for i in range(n_parts):
            part = self.store.get_bytes(f"{self.ns}/xfer/{seq}/part/{i:04d}")
            if part is None:
                raise ValueError(f"transfer {seq}: part {i} missing")
            chunks.append(part)
        data = b"".join(chunks)
        if len(data) != int(commit["bytes"]):
            raise ValueError(
                f"transfer {seq}: reassembled {len(data)} bytes, commit "
                f"promises {commit['bytes']}")
        if (zlib.crc32(data) & 0xFFFFFFFF) != int(commit["crc"]):
            raise CorruptBlobError(
                f"transfer {seq}: whole-payload CRC mismatch")
        return HandoffPayload.unpack(data)

    def _gc(self, seq: str) -> None:
        """Best-effort cleanup of a settled transfer's whole record
        (parts AND commit; the persisted ACK is the durable idempotence
        record a relaunch reads). Without this the receiver's poll
        scans every commit it ever settled, so the decode hot path's
        store round trip would grow with lifetime transfer count."""
        try:
            for key in self.store.keys(f"{self.ns}/xfer/{seq}/"):
                self.store.delete(key)
        except Exception:  # noqa: BLE001 — cleanup must not fail a poll
            pass


# ---------------------------------------------------------------------------
# Workers (pump-driven; DisaggServer wraps one in a process loop)


class PrefillWorker:
    """A supervised ``role="prefill_only"`` engine plus the sender side
    of the handoff: each pump steps the engine, drains finished
    prefills, exports + sends them (each under a deadline carved from
    the request's remaining budget), marks delivered ones
    "transferred" in the journal, and surfaces failures as
    ``handoff_failed`` records the router turns into colocated
    fallback — a transfer that can't make it never strands a request."""

    def __init__(self, worker_id: str, engine_factory, store,
                 decode_ids: Sequence[str], *,
                 journal_dir: Optional[str] = None,
                 handoff_budget: float = 30.0,
                 sender_kwargs: Optional[dict] = None,
                 **supervisor_kwargs):
        self.replica_id = str(worker_id)
        self.journal_dir = journal_dir
        self.handoff_budget = float(handoff_budget)
        self.supervisor = ServingSupervisor(
            engine_factory, journal_dir=journal_dir, **supervisor_kwargs)
        if self.supervisor.engine.role != "prefill_only":
            raise ValueError(
                "PrefillWorker needs a role='prefill_only' engine "
                f"factory (got role={self.supervisor.engine.role!r})")
        kw = dict(sender_kwargs or {})
        kw.setdefault("sender_id", self.replica_id)
        self.senders = [KVHandoffSender(store, did, **kw)
                        for did in decode_ids]
        self._rr = 0
        # ack-timeout circuit breaker: a decode channel whose transfer
        # just timed out is skipped for one handoff_budget window, so
        # a dead decode worker doesn't keep eating every N-th handoff's
        # full 30s ack wait (any verdict — ok OR nack — re-closes it)
        self._down_until: Dict[str, float] = {}
        self._dead = False
        self._published: Set = set()
        self._markers: List[dict] = []  # transferred / handoff_failed
        # posted transfers awaiting the receiver's verdict:
        # req_id -> {req, payload, sender, seq, dl, resends}
        self._outstanding: Dict[object, dict] = {}
        self._graft_ledger = _res.current()
        self.export_retry = RetryPolicy(
            max_attempts=3, base_delay=0.02, max_delay=0.5,
            transient=_handoff_transient)

    # -- router-handle surface ------------------------------------------
    def alive(self) -> bool:
        return not self._dead

    def kill(self) -> None:
        self._dead = True

    def stop(self, deadline: Optional[Deadline] = None) -> None:
        del deadline
        self._dead = True

    def submit(self, rec: dict) -> None:
        self.supervisor.submit(
            rec["req_id"], np.asarray(rec["prompt"], np.int32),
            int(rec["max_new_tokens"]),
            deadline=remaining_budget(rec),
            priority=rec.get("priority", "interactive"),
            retries=int(rec.get("retries", 0)),
            trace=rec.get("trace"),
            tenant=rec.get("tenant", "default"))

    def pending(self) -> bool:
        return (not self._dead) and (
            self.supervisor.pending
            or bool(self.supervisor.engine._handoff_ready)
            or bool(self._outstanding))

    def active(self) -> bool:
        """Engine-side work RIGHT NOW — unlike :meth:`pending`, an
        outstanding transfer merely awaiting its ack doesn't count, so
        a serve loop can sleep between ack polls instead of spinning
        on the store."""
        return (not self._dead) and (
            self.supervisor.pending
            or bool(self.supervisor.engine._handoff_ready))

    def load(self) -> Optional[dict]:
        eng = self.supervisor.engine
        d = eng.load().as_dict()
        d["role"] = "prefill"
        d["handed_off"] = eng.n_handed_off
        return d

    def poll_completed(self) -> List[dict]:
        """Final results settled AT the prefill side (eos-on-first-
        token, shed, expired) plus the routing markers: "transferred"
        (the decode side owns it now — carries ``target``) and
        "handoff_failed" (the router should fall back)."""
        out, self._markers = list(self._markers), []
        for rid, r in list(self.supervisor.results.items()):
            if rid in self._published or r.status == "transferred":
                continue
            self._published.add(rid)
            out.append(result_record(rid, r.status, r.out,
                               shed_reason=r.shed_reason,
                               times=list(r.times)))
        return out

    # -- the pump --------------------------------------------------------
    def pump(self, deadline: Optional[Deadline] = None) -> None:
        del deadline  # per-handoff budgets bound every leg below
        if self._dead:
            return
        if self.supervisor.pending:
            self.supervisor.step()
        eng = self.supervisor.engine
        for req in eng.drain_prefilled():
            self._begin_handoff(eng, req)
        self._check_acks()

    def _pick_sender(self) -> KVHandoffSender:
        """Round-robin over decode channels, skipping any inside its
        ack-timeout cooldown; when EVERY channel is cooling down, take
        the round-robin pick anyway (a wrong guess costs one budget,
        stranding the handoff costs the request)."""
        now = time.monotonic()
        for _ in range(len(self.senders)):
            s = self.senders[self._rr % len(self.senders)]
            self._rr += 1
            if self._down_until.get(s.channel, 0.0) <= now:
                return s
        s = self.senders[self._rr % len(self.senders)]
        self._rr += 1
        return s

    def _fail(self, req: GenRequest, why: str) -> None:
        self._markers.append(result_record(
            req.req_id, "handoff_failed", reason=why[:200]))

    def _begin_handoff(self, eng, req: GenRequest) -> None:
        """Export + post one finished prefill. The export is gathered
        to HOST arrays and the blocks released immediately — resends
        reuse the packed payload, so a supervisor engine rebuild
        between post and ack cannot strand the transfer."""
        if req.expired():
            eng.release_handoff(req.req_id)
            req.status = "expired"
            self.supervisor._finish(req)
            return
        budget = self.handoff_budget
        if req.deadline is not None and req.deadline.budget is not None:
            budget = min(budget, req.deadline.remaining())
        dl = Deadline(budget)
        sender = self._pick_sender()
        try:
            pages, scales, meta = self.export_retry.call(
                eng.export_kv, req.req_id, kv_len=int(req.prompt.size),
                deadline=dl, describe="KV export")
        except (OSError, ValueError, TimeoutError,
                BlockImportError) as e:
            eng.release_handoff(req.req_id)
            self._fail(req, f"export: {type(e).__name__}: {e}")
            return
        payload = HandoffPayload.from_request(req, pages, scales, meta)
        eng.release_handoff(req.req_id)
        try:
            seq = sender.send_handoff(payload, deadline=dl)
        except (OSError, ValueError, TimeoutError) as e:
            self._fail(req, f"transfer: {type(e).__name__}: {e}")
            return
        self._outstanding[req.req_id] = {
            "req": req, "payload": payload, "sender": sender,
            "seq": seq, "dl": dl, "resends": 0}
        if self._graft_ledger is not None:
            self._graft_ledger.acquire("handoff.part", req.req_id)

    def _drop_outstanding(self, rid) -> None:
        """Every settle path funnels through here so the leak ledger's
        ``handoff.part`` entry can never outlive the tracking dict."""
        del self._outstanding[rid]
        if self._graft_ledger is not None:
            self._graft_ledger.release("handoff.part", rid)

    def _check_acks(self) -> None:
        """Settle posted transfers: ok → journal "transferred" + tell
        the router; nack → resend (idempotent by req_id) while budget
        remains; deadline → handoff_failed (the router falls back to
        colocated serving)."""
        for rid, st in list(self._outstanding.items()):
            channel = st["sender"].channel
            try:
                verdict = st["sender"].poll_ack(st["seq"])
            except (OSError, ValueError) as e:
                verdict = None
                if st["dl"].expired():
                    self._drop_outstanding(rid)
                    self._down_until[channel] = (
                        time.monotonic() + self.handoff_budget)
                    self._fail(st["req"],
                               f"ack: {type(e).__name__}: {e}")
                    continue
            if verdict == "ok":
                self._drop_outstanding(rid)
                self._down_until.pop(channel, None)
                self.supervisor.mark_transferred(st["req"])
                self._markers.append(result_record(
                    rid, "transferred", target=channel))
            elif verdict is None:
                if st["dl"].expired():
                    self._drop_outstanding(rid)
                    self._down_until[channel] = (
                        time.monotonic() + self.handoff_budget)
                    self._fail(st["req"], "ack wait exceeded the "
                                          "handoff deadline budget")
            else:  # nacked: damage in transit — resend the same bytes
                self._down_until.pop(channel, None)  # channel is alive
                st["resends"] += 1
                if (st["resends"] > st["sender"].max_resends
                        or st["dl"].expired()):
                    self._drop_outstanding(rid)
                    self._fail(st["req"], f"nacked {st['resends']}x: "
                                          f"{verdict}")
                    continue
                try:
                    st["seq"] = st["sender"].send_handoff(
                        st["payload"], deadline=st["dl"])
                except (OSError, ValueError, TimeoutError) as e:
                    self._drop_outstanding(rid)
                    self._fail(st["req"],
                               f"resend: {type(e).__name__}: {e}")


class DecodeWorker:
    """A supervised decode engine plus the receiver side: each pump
    polls verified transfers, imports them (journaled, so a relaunch
    re-serves by colocated prefill), retries pool-full imports under
    the request's remaining budget, and steps the engine. Direct
    ``submit`` is the colocated-FALLBACK front door — behaviourally the
    proven unified engine."""

    def __init__(self, worker_id: str, engine_factory, store, *,
                 journal_dir: Optional[str] = None,
                 steps_per_pump: int = 1,
                 **supervisor_kwargs):
        self.replica_id = str(worker_id)
        self.journal_dir = journal_dir
        # decode steps between store interactions: raising this trades
        # handoff-ingest latency for inter-token latency (the serve
        # loop's store round trips stop punctuating every decode step)
        self.steps_per_pump = max(1, int(steps_per_pump))
        self.supervisor = ServingSupervisor(
            engine_factory, journal_dir=journal_dir, **supervisor_kwargs)
        self.receiver = KVHandoffReceiver(store, worker_id)
        self._pending_imports: List[HandoffPayload] = []
        self._dead = False
        self._published: Set = set()
        self._expired: List[dict] = []

    # -- router-handle surface ------------------------------------------
    def alive(self) -> bool:
        return not self._dead

    def kill(self) -> None:
        self._dead = True

    def stop(self, deadline: Optional[Deadline] = None) -> None:
        del deadline
        self._dead = True

    def _knows(self, rid) -> bool:
        """At-least-once delivery meets one engine: a requeue/fallback
        clone of a request this worker is ALREADY serving (itself, or
        via an earlier import) must be dropped — two live owners of one
        req_id would collide in the BlockManager."""
        if rid in self.supervisor.results:
            return True
        if any(p.req_id == rid for p in self._pending_imports):
            return True
        eng = self.supervisor.engine
        if eng.manager.owned_blocks(rid):
            return True
        return any(r.req_id == rid for r in list(eng._queue))

    def submit(self, rec: dict) -> None:
        """Colocated fallback: a plain admission-controlled submission
        — the engine prefills it itself (chunked when configured).
        Idempotent per req_id: a clone of in-flight work is dropped."""
        if self._knows(rec["req_id"]):
            return
        self.supervisor.submit(
            rec["req_id"], np.asarray(rec["prompt"], np.int32),
            int(rec["max_new_tokens"]),
            deadline=remaining_budget(rec),
            priority=rec.get("priority", "interactive"),
            retries=int(rec.get("retries", 0)),
            trace=rec.get("trace"),
            tenant=rec.get("tenant", "default"))

    def pending(self) -> bool:
        return (not self._dead) and (
            self.supervisor.pending or bool(self._pending_imports))

    def active(self) -> bool:
        """Engine-side work RIGHT NOW — a pool-full import parked for
        retry doesn't count (the pool frees as the engine steps, which
        :attr:`supervisor.pending` already covers), so a serve loop
        can sleep instead of spinning on the store."""
        return (not self._dead) and self.supervisor.pending

    def load(self) -> Optional[dict]:
        eng = self.supervisor.engine
        d = eng.load().as_dict()
        d["role"] = "decode"
        d["imported"] = eng.n_imported
        d["pending_imports"] = len(self._pending_imports)
        return d

    def poll_completed(self) -> List[dict]:
        out, self._expired = list(self._expired), []
        for rid, r in list(self.supervisor.results.items()):
            if rid in self._published:
                continue
            self._published.add(rid)
            # per-token perf_counter stamps ride along: differences
            # within one worker process are valid inter-token
            # latencies, which is what the disagg bench reports
            out.append(result_record(rid, r.status, r.out,
                               shed_reason=r.shed_reason,
                               times=list(r.times)))
        return out

    # -- the pump --------------------------------------------------------
    def pump(self, deadline: Optional[Deadline] = None) -> None:
        del deadline  # the supervisor's step budget bounds each step
        if self._dead:
            return
        self._pending_imports.extend(self.receiver.recv_handoff())
        self._try_imports()
        for _ in range(self.steps_per_pump):
            if not self.supervisor.pending:
                break
            self.supervisor.step()

    def _try_imports(self) -> None:
        still: List[HandoffPayload] = []
        pending, self._pending_imports = self._pending_imports, []
        for p in pending:
            rem = p.remaining_budget()
            if rem is not None and rem <= 0:
                # the budget died in transit: close at zero token cost
                self._expired.append(result_record(p.req_id, "expired"))
                continue
            if self._knows(p.req_id):
                continue  # already serving it colocated (or finished)
            req = p.to_request()
            try:
                self.supervisor.engine.import_kv(
                    req, p.first_token, p.pages, p.scales, p.meta)
            except (BlockImportError, EngineFenced):
                still.append(p)  # transient: retry next pump
                continue
            except ValueError:
                # config skew (block size / layers / quantization /
                # max_len) — NO retry can import this payload here, but
                # the prompt rode along: serve it colocated (the engine
                # re-prefills; token-exact under greedy) instead of
                # letting one misrouted request crash the whole worker
                self.supervisor.submit(
                    req.req_id, req.prompt, req.max_new_tokens,
                    deadline=rem, priority=req.priority,
                    retries=req.retries, trace=req, tenant=req.tenant)
                continue
            self.supervisor.submit_imported(req)
        self._pending_imports = still


# ---------------------------------------------------------------------------
# The router: two pools + crash-only recovery + graceful degradation


class DisaggRouter:
    """Front door over a prefill pool and a decode pool. Placement is
    least-routed over LIVE prefill workers; when the prefill pool is
    EMPTY (or a transfer fails its budget) the request goes straight to
    a decode worker's colocated front door — graceful degradation, not
    an outage. Recovery is the cluster.py design: a dead worker's
    supervisor journal is replayed + compacted and unioned with the
    router's own routing table; survivors get the work token-exact with
    only the remaining deadline budget; repeat offenders quarantine
    per REQUEST."""

    def __init__(self, prefill_workers: Sequence,
                 decode_workers: Sequence, *,
                 max_request_retries: int = 2):
        if not decode_workers:
            raise ValueError("need at least one decode worker")
        self.prefill = list(prefill_workers)
        self.decode = list(decode_workers)
        self.max_request_retries = int(max_request_retries)
        self._decode_idx = {w.replica_id: i
                            for i, w in enumerate(self.decode)}
        # req_id -> (record, ("prefill"|"decode"|"decode?", idx))
        # "decode?" = transferred but target marker not yet seen
        self.inflight: Dict[object, Tuple[dict, Tuple[str, int]]] = {}
        self.orphans: Dict[object, dict] = {}
        self.results: Dict[object, dict] = {}
        self.retries: Dict[object, int] = {}
        self.poisoned_ids: List[object] = []
        self.dead_prefill: Set[int] = set()
        self.dead_decode: Set[int] = set()
        self.n_routed_prefill = [0] * len(self.prefill)
        self.n_routed_decode = [0] * len(self.decode)
        self.n_fallback = 0
        self.n_handoff_failed = 0
        self.n_recoveries = 0
        self.events: List[tuple] = []

    # -- placement -------------------------------------------------------
    def _live_prefill(self, exclude: Sequence[int] = ()) -> List[int]:
        return [i for i, w in enumerate(self.prefill)
                if i not in self.dead_prefill and i not in exclude
                and w.alive()]

    def _live_decode(self) -> List[int]:
        return [i for i, w in enumerate(self.decode)
                if i not in self.dead_decode and w.alive()]

    def submit(self, req_id, prompt, max_new_tokens: int = 32, *,
               deadline=None, priority: str = "interactive",
               trace=None, tenant: str = "default") -> Tuple[str, int]:
        """Route one request; returns ``(pool, index)`` — pool is
        "prefill" normally, "decode" when the prefill pool is down
        (colocated fallback). Results arrive via :meth:`poll` /
        :meth:`run`, keyed by ``req_id``, across any worker deaths.
        ``tenant`` rides the wire record and the handoff header."""
        with _obs.span("route", parent=_obs.trace_ctx(trace),
                       tid="router", req=str(req_id),
                       tenant=str(tenant)) as sp:
            rec = make_record(req_id, prompt, max_new_tokens,
                              deadline=deadline, priority=priority,
                              tenant=tenant,
                              retries=self.retries.get(req_id, 0),
                              trace=sp.ctx())
            pool, idx = self._place(rec)
            sp.args["pool"], sp.args["worker"] = pool, idx
        return pool, idx

    def _place(self, rec: dict,
               exclude_prefill: Sequence[int] = ()) -> Tuple[str, int]:
        live = self._live_prefill(exclude_prefill)
        if live:
            idx = min(live, key=lambda i: (self.n_routed_prefill[i], i))
            self.prefill[idx].submit(rec)
            self.n_routed_prefill[idx] += 1
            self.inflight[rec["req_id"]] = (rec, ("prefill", idx))
            return "prefill", idx
        return self._place_fallback(rec)

    def _place_fallback(self, rec: dict) -> Tuple[str, int]:
        live = self._live_decode()
        if not live:
            self.orphans[rec["req_id"]] = rec
            return "orphan", -1
        idx = min(live, key=lambda i: (self.n_routed_decode[i], i))
        self.decode[idx].submit(rec)
        self.n_routed_decode[idx] += 1
        self.n_fallback += 1
        self.inflight[rec["req_id"]] = (rec, ("decode", idx))
        return "decode", idx

    # -- harvest ---------------------------------------------------------
    def poll(self) -> List[dict]:
        new: List[dict] = []
        for pool, workers, dead in (("prefill", self.prefill,
                                     self.dead_prefill),
                                    ("decode", self.decode,
                                     self.dead_decode)):
            for i, w in enumerate(workers):
                if i in dead:
                    continue
                try:
                    done = w.poll_completed()
                except Exception:  # noqa: BLE001 — store blip
                    continue
                for rec in done:
                    new.extend(self._ingest(rec))
        return new

    def _ingest(self, rec: dict) -> List[dict]:
        rid = rec["req_id"]
        status = rec.get("status")
        if status == "transferred":
            # a baton pass, not a result: the decode pool owns it now
            if rid in self.inflight:
                old_rec, _ = self.inflight[rid]
                target = self._decode_idx.get(rec.get("target"), -1)
                kind = "decode" if target >= 0 else "decode?"
                self.inflight[rid] = (old_rec, (kind, target))
            return []
        if status == "handoff_failed":
            # the transfer lost; re-place colocated (not a worker
            # death — no retry penalty, the prompt just re-prefills)
            if rid in self.inflight and rid not in self.results:
                old_rec, _ = self.inflight.pop(rid)
                self.n_handoff_failed += 1
                self._place_fallback(old_rec)
            return []
        if rid in self.results:
            return []
        self.results[rid] = rec
        self.inflight.pop(rid, None)
        return [rec]

    # -- failure handling ------------------------------------------------
    def check_workers(self) -> None:
        for i, w in enumerate(self.prefill):
            if i not in self.dead_prefill and not w.alive():
                self.recover_prefill(i)
        for i, w in enumerate(self.decode):
            if i not in self.dead_decode and not w.alive():
                self.recover_decode(i)

    def _journal_pending(self, worker) -> Dict[object, dict]:
        """Replay + compact a dead worker's journal; harvest completed
        records; return the pending ones. "transferred" completions are
        a baton pass — NOT harvested as results, NOT pending here (the
        decode side owns them; the router table already tracks it)."""
        pending: Dict[object, dict] = {}
        if worker.journal_dir is None:
            return pending
        journal = Journal(worker.journal_dir)
        pend, completed = journal.replay()
        journal.compact(pend, completed)
        for rid, rec in completed.items():
            if rec.get("status") == "transferred":
                ent = self.inflight.get(rid)
                if ent is not None and ent[1][0] == "prefill":
                    self.inflight[rid] = (ent[0], ("decode?", -1))
                continue
            if rid not in self.results:
                self.results[rid] = result_record(
                    rid, rec.get("status", "ok"), rec.get("out", []))
                self.inflight.pop(rid, None)
        pending.update(pend)
        return pending

    def _requeue(self, pending: Dict[object, dict],
                 exclude_prefill: Sequence[int] = ()) -> Tuple[int, int]:
        n_requeued = n_poisoned = 0
        for rid, rec in pending.items():
            if rid in self.results:
                continue
            self.inflight.pop(rid, None)
            remaining = remaining_budget(rec)
            if remaining is not None and remaining <= 0:
                self.results[rid] = result_record(rid, "expired")
                continue
            retries = max(self.retries.get(rid, 0),
                          int(rec.get("retries", 0))) + 1
            self.retries[rid] = retries
            if retries > self.max_request_retries:
                self.results[rid] = result_record(rid, "poisoned")
                self.poisoned_ids.append(rid)
                n_poisoned += 1
                continue
            new_rec = dict(rec)
            new_rec.pop("type", None)
            new_rec["retries"] = retries
            self._place(new_rec, exclude_prefill=exclude_prefill)
            n_requeued += 1
        return n_requeued, n_poisoned

    def recover_prefill(self, idx: int) -> None:
        """Crash-only prefill-worker recovery: journal replay ∪ the
        router's own table covers every accepted-but-unfinished request
        (mailed-never-pulled included); survivors take them token-exact
        with only the remaining budget — or the decode pool serves them
        colocated when no prefill worker is left."""
        w = self.prefill[idx]
        self.dead_prefill.add(idx)
        self.n_recoveries += 1
        try:
            for rec in w.poll_completed():
                self._ingest(rec)
        except Exception:  # noqa: BLE001 — the store may be gone too
            pass
        pending = self._journal_pending(w)
        for rid, (rec, where) in list(self.inflight.items()):
            if where == ("prefill", idx) and rid not in pending:
                pending[rid] = rec
        n_req, n_poi = self._requeue(pending, exclude_prefill=(idx,))
        self.events.append(
            ("prefill-dead", w.replica_id, n_req, n_poi))

    def recover_decode(self, idx: int) -> None:
        """Decode-worker death: its KV dies with it, so journal-pending
        (imports + fallback submissions) ∪ router-table entries
        targeting it re-enter the FULL pipeline (prefill pool again, or
        a surviving decode colocated). Unknown-target transfers
        ("decode?" — the marker never reached us) are requeued too:
        idempotent transfer + first-result-wins make the duplicate
        harmless if the target was actually a survivor."""
        w = self.decode[idx]
        self.dead_decode.add(idx)
        self.n_recoveries += 1
        try:
            for rec in w.poll_completed():
                self._ingest(rec)
        except Exception:  # noqa: BLE001
            pass
        pending = self._journal_pending(w)
        for rid, (rec, where) in list(self.inflight.items()):
            if where in (("decode", idx), ("decode?", -1)) \
                    and rid not in pending:
                pending[rid] = rec
        n_req, n_poi = self._requeue(pending)
        self.events.append(
            ("decode-dead", w.replica_id, n_req, n_poi))

    def _place_orphans(self) -> None:
        for rid, rec in list(self.orphans.items()):
            remaining = remaining_budget(rec)
            if remaining is not None and remaining <= 0:
                del self.orphans[rid]
                self.results[rid] = result_record(rid, "expired")
                continue
            pool, _ = self._place(rec)
            if pool == "orphan":
                return  # still nobody home
            del self.orphans[rid]

    # -- drive loop ------------------------------------------------------
    def step(self) -> List[dict]:
        for i, w in enumerate(self.prefill):
            if i not in self.dead_prefill:
                w.pump()
        for i, w in enumerate(self.decode):
            if i not in self.dead_decode:
                w.pump()
        out = self.poll()
        self.check_workers()
        if self.orphans:
            self._place_orphans()
        return out

    def run(self, deadline=None, poll_interval: float = 0.02) -> dict:
        dl = Deadline.coerce(deadline)
        while (self.inflight or self.orphans) and not dl.expired():
            got = self.step()
            if got:
                continue
            if any(w.pending() for i, w in enumerate(self.prefill)
                   if i not in self.dead_prefill) or \
                    any(w.pending() for i, w in enumerate(self.decode)
                        if i not in self.dead_decode):
                continue  # local work ready to pump: no sleep
            if dl.budget is None:
                time.sleep(poll_interval)
            else:
                dl.sleep(poll_interval)
        return dict(self.results)

    def stop(self, deadline=None) -> None:
        dl = Deadline.coerce(deadline)
        for w in self.prefill + self.decode:
            w.stop(deadline=dl.sub(fraction=0.5))

    def health(self) -> dict:
        def entry(w, i, dead):
            alive = i not in dead and w.alive()
            e = {"replica_id": w.replica_id, "alive": alive}
            if alive:
                try:
                    e["load"] = w.load()
                except Exception:  # noqa: BLE001 — best-effort snapshot
                    e["load"] = None
            return e

        return _obs.health_envelope("disagg", {
            "prefill": [entry(w, i, self.dead_prefill)
                        for i, w in enumerate(self.prefill)],
            "decode": [entry(w, i, self.dead_decode)
                       for i, w in enumerate(self.decode)],
            "inflight": len(self.inflight),
            "orphans": len(self.orphans),
            "results": len(self.results),
            "poisoned": list(self.poisoned_ids),
            "fallback": self.n_fallback,
            "handoff_failed": self.n_handoff_failed,
            "recoveries": self.n_recoveries,
        })


# ---------------------------------------------------------------------------
# Process mode


class DisaggServer:
    """Process-mode serve loop for EITHER role: wraps a
    :class:`PrefillWorker` / :class:`DecodeWorker`, pulls request
    records from the router's mailbox (``cluster/<id>/req/NNN`` — the
    same schema :class:`~.cluster.ProcessReplica`
    speaks, so the router reuses that handle unchanged), pumps the
    worker, and publishes results / load / heartbeats. Also attaches
    the flight-recorder contract so a hang dump on either side names
    BOTH roles' schedules. The default contract topology (prefill =
    rank 0, decode = rank 1, world 2) fits the canonical one-prefill +
    one-decode pair ONLY — deployments with several workers per role
    must pass explicit ``contract_rank``/``contract_world`` (e.g. an
    enumeration over the whole deployment) or same-role workers would
    publish their schedules under the same rank key and clobber each
    other exactly when the dump is needed."""

    ROLE_RANKS = {"prefill": 0, "decode": 1}

    def __init__(self, store, worker, *, poll_interval: float = 0.02,
                 contract_rank: Optional[int] = None,
                 contract_world: int = 2):
        self.store = store
        self.worker = worker
        self.replica_id = worker.replica_id
        self.ns = f"cluster/{self.replica_id}"
        self.poll_interval = float(poll_interval)
        self._taken: Set[str] = set()
        self._hb = 0
        self._pub_seq = 0
        self._pub_nonce = uuid.uuid4().hex[:6]
        if contract_rank is None:
            role = ("prefill" if isinstance(worker, PrefillWorker)
                    else "decode")
            contract_rank = self.ROLE_RANKS[role]
        _fr.attach_contract(store, int(contract_rank),
                            int(contract_world))
        # fleet-obs publication: disagg workers were the one
        # serve loop NOT publishing their registry/trace ring, so the
        # fleet snapshot (and the absence rules) could not see them
        self._obs_pub = _obs_agg.Publisher(
            store, f"rep-{self.replica_id}")

    def _pull(self) -> int:
        n = 0
        for key in sorted(self.store.keys(self.ns + "/req/")):
            if key in self._taken:
                continue
            raw = self.store.get(key)
            if raw is None:
                continue
            self._taken.add(key)
            rec = json.loads(raw)
            sup = self.worker.supervisor
            rid = rec["req_id"]
            # skip a submission a relaunch already replayed — but a
            # router REQUEUE of work this worker already served (the
            # decode side died after our baton pass) carries a BUMPED
            # retries count and must be accepted, not dropped forever
            if (rid in sup.journaled_ids
                    and int(rec.get("retries", 0))
                    <= sup.journaled_retries.get(rid, 0)):
                continue
            self.worker.submit(rec)
            n += 1
        return n

    def _publish(self) -> None:
        for rec in self.worker.poll_completed():
            # per-ATTEMPT key: one request can legitimately publish
            # several records ("transferred", then "handoff_failed"
            # after a requeue, then a final result) and ProcessReplica
            # dedups by key — a fixed done/<rid> slot would swallow
            # every record after the first; the nonce keeps keys fresh
            # across worker relaunches too
            self._pub_seq += 1
            self.store.set(
                f"{self.ns}/done/{rec['req_id']}@{self._pub_nonce}"
                f"-{self._pub_seq:06d}", json.dumps(rec))
        load = self.worker.load()
        if load is not None:
            self.store.set(self.ns + "/load", json.dumps(load))
        self._hb += 1
        self.store.set(self.ns + "/hb", str(self._hb))
        self._obs_pub.maybe_publish()
        _obs.default_manager().maybe_evaluate(
            min_interval_s=self._obs_pub.interval_s)

    def serve(self, deadline=None) -> None:
        """Serve until ``stop`` is posted or the Deadline runs out;
        every blocking edge bounded (store ops carry their own per-op
        budget, idle waits go through ``Deadline.sleep``)."""
        dl = Deadline.coerce(deadline)
        self._publish()  # first heartbeat: visible before any work
        try:
            while not dl.expired():
                if self.store.get(self.ns + "/stop"):
                    break
                took = self._pull()
                self.worker.pump()
                # sleep whenever only store-side waits remain (an
                # outstanding ack, a pool-full import retry): pending()
                # counts those, but polling them at full speed would
                # hammer the store with no engine work to show for it
                if not (took or self.worker.active()):
                    if dl.budget is None:
                        time.sleep(self.poll_interval)
                    else:
                        dl.sleep(self.poll_interval)
                self._publish()
            self._publish()
        finally:
            try:
                self._obs_pub.publish()  # final full-registry flush
            except Exception:
                pass  # the store may be the thing that died
