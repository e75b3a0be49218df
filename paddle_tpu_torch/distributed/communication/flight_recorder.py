"""Collective flight recorder — the runtime half of graft-verify
(counterpart of ``paddle_tpu/distributed/communication/flight_recorder.py``,
copied: stdlib only, over the port's ``base.flags``, ``testing.chaos`` and
``utils.retries``; ``CollectiveScheduleMismatch`` comes from the port's
``analysis.sanitizers``). It records every collective of
``distributed.communication`` and the disaggregated handoff legs
(``handoff_send``/``handoff_recv``).

Static schedule verification (COLL002/COLL003) proves agreement where
the call graph is analyzable; everything else — data-dependent
schedules, third-party code, genuine races — needs runtime evidence.
Modeled on PyTorch's NCCL Flight Recorder: every eager collective in
multi-controller mode appends a :class:`CollectiveSignature`
(sequence number, op, shape/dtype, group, peer) to a fixed-size
per-rank ring buffer (``FLAGS comm_flight_recorder_len`` entries), so
that

- the **CommWatchdog's dump stage** prints the last-N ring entries of
  this rank alongside the stack dump (and, when a contract store is
  attached, a best-effort schedule diff against every peer that has
  published) — a real hang produces a *schedule diff*, not just
  stacks;
- the :func:`collective_contract` sanitizer (re-exported from
  the reference's ``analysis.sanitizers``) cross-checks the recorded
  schedules of all ranks through a shared KV store (TCPKVStore /
  FileKVStore) and raises :class:`CollectiveScheduleMismatch` naming
  BOTH ranks' last-N schedules when they diverge — the test-time proof
  that a reordered collective would have deadlocked.

Chaos site ``comm.reorder``: a ``drop`` fault here defers the current
collective's signature behind the NEXT one recorded on this rank —
the deterministic way for a test to manufacture exactly the swapped
schedule the static rules flag (see ``testing/chaos.py``).

Recording is cheap (a deque append under a lock) and stdlib-only.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ...base import flags as _flags
from ...testing import chaos as _chaos
from ...utils.retries import Deadline

__all__ = [
    "CollectiveSignature",
    "FlightRecorder",
    "recorder",
    "record",
    "reset",
    "attach_contract",
    "register_dump_extra",
    "unregister_dump_extra",
    "contract",
    "schedule_diff",
    "dump_on_watchdog",
]

# ops whose signatures are legitimately rank-divergent (the two
# endpoints of a transfer record mirrored entries) — the cross-rank
# contract skips them; COLL003 owns their static pairing. The disagg
# KV-handoff legs (inference/disagg.py) are the cross-ROLE analogue:
# the prefill side records handoff_send where the decode side records
# handoff_recv, so a hang dump can name both roles' schedules without
# the contract calling the asymmetry a divergence. ``train_step`` is
# the training supervisor's per-step telemetry beacon
# (training/telemetry.py): its detail carries per-rank step times and
# gradient fingerprints — divergent by nature, but exactly what a hang
# dump should print (the last steps each rank completed, and how slow).
_RANK_DIVERGENT_OPS = ("send", "recv", "handoff_send", "handoff_recv",
                       "train_step")


@dataclass(frozen=True)
class CollectiveSignature:
    seq: int            # per-rank issue counter (1-based)
    op: str             # all_reduce[sum] / all_gather / broadcast / ...
    shape: Tuple[int, ...]
    dtype: str
    group: str          # group/axis the op runs over
    peer: Optional[int] = None   # p2p endpoint / broadcast src
    detail: str = ""    # op params every rank must agree on (src, perm)
    t: float = 0.0      # host wall clock at issue time

    def key(self) -> Tuple:
        """The rank-invariant part: what every rank must agree on."""
        return (self.op, self.shape, self.dtype, self.group, self.detail)

    def format(self) -> str:
        s = f"#{self.seq} {self.op} {self.dtype}{list(self.shape)} " \
            f"group={self.group}"
        if self.peer is not None:
            s += f" peer={self.peer}"
        if self.detail:
            s += f" {self.detail}"
        return s

    def to_json(self) -> Dict:
        return {"seq": self.seq, "op": self.op,
                "shape": list(self.shape), "dtype": self.dtype,
                "group": self.group, "peer": self.peer,
                "detail": self.detail, "t": self.t}

    @classmethod
    def from_json(cls, d: Dict) -> "CollectiveSignature":
        return cls(seq=int(d["seq"]), op=d["op"],
                   shape=tuple(d["shape"]), dtype=d["dtype"],
                   group=d["group"], peer=d.get("peer"),
                   detail=d.get("detail", ""), t=float(d.get("t", 0.0)))


class FlightRecorder:
    """Fixed-size ring of the collectives this rank issued, in issue
    order. Signatures are appended BEFORE the collective executes, so
    a hang still shows the op the rank is stuck in."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = int(_flags.flag("comm_flight_recorder_len"))
        self.capacity = max(1, capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._pending: List[Tuple] = []  # comm.reorder deferral FIFO
        self._contract_round = 0
        self._lock = threading.Lock()

    def record(self, op: str, shape: Tuple[int, ...] = (),
               dtype: str = "", group: str = "world",
               peer: Optional[int] = None, detail: str = "") -> None:
        entry = (op, tuple(int(d) for d in shape), str(dtype),
                 str(group), peer, detail)
        # chaos site comm.reorder: a drop DEFERS this signature until
        # the next NON-deferred collective on this rank (FIFO, so
        # consecutive drops each take effect instead of silently
        # cancelling) — the injected schedule swap the contract and
        # COLL002 must catch
        deferred = not _chaos.inject("comm.reorder")
        with self._lock:
            if deferred:
                self._pending.append(entry)
                return
            self._append(entry)
            self._flush_pending_locked()

    def _append(self, entry: Tuple) -> None:
        op, shape, dtype, group, peer, detail = entry
        self._seq += 1
        self._ring.append(CollectiveSignature(
            seq=self._seq, op=op, shape=shape, dtype=dtype,
            group=group, peer=peer, detail=detail, t=time.time()))

    def _flush_pending_locked(self) -> None:
        while self._pending:
            self._append(self._pending.pop(0))

    def snapshot(self, last_n: Optional[int] = None
                 ) -> List[CollectiveSignature]:
        """The last-N recorded signatures (deferred entries flushed
        first — a snapshot is a synchronization point)."""
        with self._lock:
            self._flush_pending_locked()
            entries = list(self._ring)
        if last_n is not None:
            entries = entries[-last_n:]
        return entries

    def next_contract_round(self) -> int:
        with self._lock:
            self._contract_round += 1
            return self._contract_round

    def dump(self, file, last_n: Optional[int] = None,
             header: str = "CollectiveFlightRecorder") -> None:
        entries = self.snapshot(last_n)
        file.write(f"{header}: last {len(entries)} collective(s) "
                   "issued by this rank (most recent last):\n")
        if not entries:
            file.write("  (no collectives recorded)\n")
        for sig in entries:
            file.write(f"  {sig.format()}\n")


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()
# (store, rank, world_size) when a contract has been attached — lets
# the watchdog publish/fetch schedules while the process still can
_contract_binding: Optional[Tuple] = None
# extra sections appended to the watchdog dump: fn(file) callables
# registered by subsystems with hang-relevant evidence of their own
# (training.telemetry names persistent stragglers here, so a hang dump
# answers "WHO is slow", not just "we are hung")
_dump_extras: List = []


def register_dump_extra(fn) -> None:
    """Append ``fn(file)`` to the watchdog dump. Re-registering the
    same callable is a no-op; :func:`unregister_dump_extra` removes one
    (retired subsystem instances must not keep writing stale evidence
    into dumps — or be retained forever); :func:`reset` clears all."""
    if fn not in _dump_extras:
        _dump_extras.append(fn)


def unregister_dump_extra(fn) -> None:
    try:
        _dump_extras.remove(fn)
    except ValueError:
        pass


def recorder() -> FlightRecorder:
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def record(op: str, shape: Tuple[int, ...] = (), dtype: str = "",
           group: str = "world", peer: Optional[int] = None,
           detail: str = "") -> None:
    """Module-level sugar used by the instrumented collective sites."""
    recorder().record(op, shape, dtype, group, peer, detail)


def reset() -> None:
    """Drop the recorder, contract binding and dump extras (tests)."""
    global _recorder, _contract_binding
    with _recorder_lock:
        _recorder = None
        _contract_binding = None
        del _dump_extras[:]


def attach_contract(store, rank: int, world_size: int) -> None:
    """Register the KV store the watchdog may use to publish/fetch
    schedules at dump time. :func:`contract` attaches automatically."""
    global _contract_binding
    _contract_binding = (store, int(rank), int(world_size))


# ---------------------------------------------------------------------------
# Cross-rank schedule comparison


def schedule_diff(schedules: Dict[int, List[CollectiveSignature]]
                  ) -> Optional[str]:
    """Human-readable divergence report across per-rank schedules, or
    None when every rank agrees. Point-to-point entries (send/recv)
    are skipped — their signatures are rank-divergent by design. The
    compare is positional from the start of each (filtered) list;
    hang-dump diffs taken from WRAPPED rings with asymmetric p2p
    volume may therefore misalign — every printed entry carries its
    per-rank ``#seq`` so the reader can re-align by hand (the
    contract path pre-filters before trimming and is immune)."""
    comparable = {
        r: [s for s in sched if s.op not in _RANK_DIVERGENT_OPS]
        for r, sched in schedules.items()
    }
    if len(comparable) < 2:
        return None
    ref_rank = min(comparable)
    ref = comparable[ref_rank]
    divergences = []
    for r in sorted(comparable):
        if r == ref_rank:
            continue
        other = comparable[r]
        pos = None
        for i, (a, b) in enumerate(zip(ref, other)):
            if a.key() != b.key():
                pos = i
                break
        if pos is None and len(ref) != len(other):
            pos = min(len(ref), len(other))
        if pos is not None:
            a = ref[pos].format() if pos < len(ref) else "(nothing)"
            b = other[pos].format() if pos < len(other) else "(nothing)"
            divergences.append(
                f"rank {ref_rank} and rank {r} diverge at schedule "
                f"position {pos}:\n"
                f"  rank {ref_rank}: {a}\n"
                f"  rank {r}: {b}")
    if not divergences:
        return None
    lines = divergences
    lines.append("full recorded schedules:")
    for r in sorted(schedules):
        lines.append(f"  rank {r}:")
        entries = schedules[r]
        if not entries:
            lines.append("    (no collectives recorded)")
        for sig in entries:
            lines.append(f"    {sig.format()}")
    return "\n".join(lines)


def contract(store, rank: int, world_size: int, *, last_n: int = 32,
             deadline=None, recorder_: Optional[FlightRecorder] = None,
             tag: str = "default") -> Dict[int, List[CollectiveSignature]]:
    """Cross-check this rank's recorded schedule against every peer
    through ``store`` (any ``distributed.store.KVStore``). Publishes
    the local last-N schedule, waits (under ``deadline``, default 30 s)
    for all peers' rounds, and raises
    ``analysis.sanitizers.CollectiveScheduleMismatch`` — naming every
    rank's schedule — on divergence. Every rank must call this the
    same number of times (the contract is itself a collective), and
    round ids count per INCARNATION: after a rank relaunch, pass a
    fresh ``tag=`` (or a fresh store) so the new incarnation's round 1
    doesn't read a key a previous incarnation published. Returns the
    per-rank schedules on agreement."""
    from ...analysis.sanitizers import CollectiveScheduleMismatch

    rec = recorder_ if recorder_ is not None else recorder()
    attach_contract(store, rank, world_size)
    round_id = rec.next_contract_round()
    # filter rank-divergent entries BEFORE trimming: asymmetric (but
    # legal) p2p activity must not shift the comparison windows of
    # different ranks against each other
    mine = [s for s in rec.snapshot()
            if s.op not in _RANK_DIVERGENT_OPS][-last_n:]
    store.set(f"graft/fr/{tag}/{round_id}/{rank}",
              json.dumps([s.to_json() for s in mine]))
    dl = Deadline.coerce(deadline) if deadline is not None \
        else Deadline(30.0)
    schedules: Dict[int, List[CollectiveSignature]] = {rank: mine}
    for r in range(world_size):
        if r == rank:
            continue
        key = f"graft/fr/{tag}/{round_id}/{r}"
        while True:
            raw = store.get(key)
            if raw:
                schedules[r] = [CollectiveSignature.from_json(d)
                                for d in json.loads(raw)]
                break
            dl.check(f"collective_contract: waiting for rank {r}'s "
                     f"schedule (round {round_id})")
            time.sleep(0.05)
    diff = schedule_diff(schedules)
    if diff is not None:
        raise CollectiveScheduleMismatch(
            "collective_contract: cross-rank collective schedule "
            f"divergence (round {round_id}, last {last_n}):\n{diff}")
    return schedules


# grace the hang-dump worker gets for a FAST store before the dump
# stage returns; a slower exchange keeps running detached and prints
# its diff whenever the store answers (the watchdog's monitor thread —
# the abort safety net and every other wait's ladder — never blocks
# longer than this)
_HANG_DUMP_GRACE_S = 0.5
# a peer schedule published longer ago than this is labeled stale — it
# likely belongs to a previous incident (the store outlives aborted
# incarnations and fr_hang keys are never deleted)
_HANG_DUMP_STALE_S = 300.0


def _hang_dump_exchange(store, rank: int, world_size: int,
                        mine: List[CollectiveSignature], file):
    """Publish this rank's schedule, fetch peers', and WRITE the diff
    section — runs entirely on a scrap daemon thread so a slow/dead
    store never stalls the watchdog's monitor thread (a late diff
    simply prints when the store finally answers; if the abort stage
    kills the process first, the diff was unobtainable in time
    anyway)."""
    try:
        store.set(f"graft/fr_hang/{rank}", json.dumps({
            "published_at": time.time(),
            "schedule": [s.to_json() for s in mine]}))
        schedules = {rank: mine}
        stale = []
        for r in range(world_size):
            if r == rank:
                continue
            raw = store.get(f"graft/fr_hang/{r}")
            if not raw:
                continue
            data = json.loads(raw)
            if isinstance(data, dict):
                age = time.time() - float(data.get("published_at", 0.0))
                entries = data.get("schedule", [])
            else:  # bare-list publishers (age unknown)
                age, entries = float("inf"), data
            schedules[r] = [CollectiveSignature.from_json(d)
                            for d in entries]
            if age > _HANG_DUMP_STALE_S:
                stale.append(r)
        out = [
            f"CollectiveFlightRecorder: hang-dump schedules published "
            f"by ranks {sorted(schedules)} (of {world_size})"
        ]
        if stale:
            out.append(
                f"WARNING: rank(s) {stale} published their schedules "
                f"over {_HANG_DUMP_STALE_S:.0f}s ago — possibly a "
                "PREVIOUS incident's dump; treat their diff lines "
                "with suspicion")
        diff = schedule_diff(schedules)
        if diff is not None:
            out.append("cross-rank schedule diff:\n" + diff)
        elif len(schedules) > 1:
            out.append(
                "published schedules agree — the hang is not a "
                "schedule divergence among the ranks above")
            # still print WHAT each rank issued: for a cross-role hang
            # (disagg handoff legs are rank-divergent and excluded from
            # the diff) the peer's last ops are the evidence — e.g. a
            # decode worker stuck because the prefill role stopped
            # sending shows exactly where the sender's schedule ends
            out.append("published schedules:")
            for r in sorted(schedules):
                out.append(f"  rank {r}:")
                entries = schedules[r]
                if not entries:
                    out.append("    (no collectives recorded)")
                for sig in entries:
                    out.append(f"    {sig.format()}")
        file.write("\n".join(out) + "\n")
    except Exception as e:  # noqa: BLE001 — diagnostics must not raise
        try:
            file.write(f"CollectiveFlightRecorder: peer schedule "
                       f"exchange failed "
                       f"({type(e).__name__}: {e})\n")
        except Exception:  # noqa: BLE001
            pass


def dump_on_watchdog(file) -> None:
    """Called by the CommWatchdog's stack-dump stage: print this
    rank's ring synchronously; with a contract store attached, kick
    off the publish + peer schedule diff on a daemon thread (waiting
    at most ``_HANG_DUMP_GRACE_S`` so a healthy store prints inline)
    — a real cross-rank hang yields a schedule diff while both
    processes are still alive to produce one, and a dead store cannot
    delay the watchdog's abort ladder. Peer schedules older than
    ``_HANG_DUMP_STALE_S`` are labeled as likely belonging to a
    previous incident."""
    rec = recorder()
    rec.dump(file, header="CollectiveFlightRecorder (watchdog dump)")
    for extra in list(_dump_extras):
        try:
            extra(file)
        except Exception as e:  # noqa: BLE001 — diagnostics must not raise
            try:
                file.write(f"CollectiveFlightRecorder: dump extra "
                           f"{getattr(extra, '__qualname__', extra)!r} "
                           f"failed ({type(e).__name__}: {e})\n")
            except Exception:  # noqa: BLE001
                pass
    binding = _contract_binding
    if binding is None:
        return
    store, rank, world_size = binding
    worker = threading.Thread(
        target=_hang_dump_exchange,
        args=(store, rank, world_size, rec.snapshot(), file),
        daemon=True)
    worker.start()
    worker.join(_HANG_DUMP_GRACE_S)
    if worker.is_alive():
        file.write(
            "CollectiveFlightRecorder: peer schedule exchange still "
            "in flight (slow store?) — the diff will print when it "
            "lands; not delaying the watchdog ladder\n")
