"""Cross-rank training telemetry: straggler and SDC detection
(counterpart of ``paddle_tpu/training/telemetry.py``, copied: host code
over the port's store, flight recorder and metrics registry).

MegaScale-style per-rank diagnosis: every step each rank publishes a
tiny record — ``(step, step_time, ewma_step_time, gradient
fingerprint)`` — through the shared KV store, and mirrors it into the
collective flight recorder ring (op ``train_step``, rank-divergent by
design) so a CommWatchdog hang dump shows the last steps every rank
completed and how long they took.

Two detectors read the exchange:

- **SDC (silent data corruption)** — data-parallel replicas compute
  bit-identical gradients from identical state + data, so their
  gradient-norm FINGERPRINTS must agree at every step. A fingerprint
  that diverges from the dp-group consensus at the same step is the
  signature of a corrupted gradient (bad HBM bit, broken reduction,
  diverged replica) that loss values alone would never reveal. The
  verdict names the suspect rank(s); the supervisor treats it as an
  anomaly (recompute-or-rollback).
- **Straggler** — each record carries the rank's EWMA step time; a rank
  whose EWMA exceeds ``straggler_factor`` × the cross-rank median for
  ``straggler_patience`` consecutive checks is a persistent straggler.
  The verdict is exposed in ``health()`` and — via the flight
  recorder's dump-extra hook — NAMED in the CommWatchdog hang dump, so
  a hang investigation answers "who is slow", not just "we are hung".

The exchange is deliberately non-blocking: one ``dump()`` round trip
per check, stale records (older than ``stale_s`` on the store's clock)
ignored. A dead peer makes the exchange less informative, never makes
it wedge training — liveness is the ElasticManager's job.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..distributed.communication import flight_recorder as _fr
from ..distributed.store import KVStore
from ..obs.metrics import registry as _obs_registry
from ..utils.retries import Deadline, RetryPolicy

__all__ = ["TrainTelemetry", "TelemetryVerdict", "grad_fingerprint"]


def grad_fingerprint(grad_norm) -> str:
    """Bit-exact fingerprint of a gradient statistic: the f32 bit
    pattern, hex. dp replicas running the same step on the same data
    must agree EXACTLY (same kernels, same inputs); any tolerance
    would let a slowly-diverging replica hide inside it."""
    return np.float32(grad_norm).tobytes().hex()


@dataclass
class TelemetryVerdict:
    """One check()'s conclusion. ``sdc_suspects`` — ranks whose
    fingerprint left the dp consensus this step (self included when WE
    are the minority; the supervisor only rolls back when SELF is a
    suspect — the recompute-or-rollback remedy is the suspect's);
    ``stragglers`` — ranks persistently slower than the median;
    ``peers_seen`` — ranks with a fresh record."""

    step: int
    sdc_suspects: List[int] = field(default_factory=list)
    stragglers: List[int] = field(default_factory=list)
    peers_seen: List[int] = field(default_factory=list)
    detail: str = ""

    @property
    def sdc(self) -> bool:
        return bool(self.sdc_suspects)


class TrainTelemetry:
    """``ring_len`` — each rank's store record keeps its last-N per-step
    entries, so free-running ranks within N steps of each other still
    compare fingerprints at EXACTLY the same step. ``lockstep=True``
    additionally makes :meth:`check` wait (under
    ``lockstep_deadline_s``) until every dp peer has reached the
    checked step — deterministic detection latency at the cost of
    pacing to the slowest rank; a dead peer only ever costs the
    deadline, never a wedge."""

    def __init__(self, store: KVStore, rank: int, world_size: int, *,
                 tag: str = "trainsnap", dp_group: Optional[List[int]] = None,
                 straggler_factor: float = 2.0, straggler_patience: int = 5,
                 stale_s: float = 120.0, deadline_s: float = 10.0,
                 ring_len: int = 16, lockstep: bool = False,
                 lockstep_deadline_s: float = 10.0,
                 retry: Optional[RetryPolicy] = None):
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.tag = tag
        # the ranks whose fingerprints must agree with ours (default:
        # everyone — pure dp). Hybrid meshes pass their dp replica group.
        self.dp_group = sorted(dp_group) if dp_group is not None \
            else list(range(world_size))
        self.straggler_factor = float(straggler_factor)
        self.straggler_patience = int(straggler_patience)
        self.stale_s = float(stale_s)
        self.deadline_s = float(deadline_s)
        self.ring_len = max(1, int(ring_len))
        self.lockstep = bool(lockstep)
        self.lockstep_deadline_s = float(lockstep_deadline_s)
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=0.5,
            transient=(OSError, ValueError))
        self._ring: List[dict] = []
        self._ewma_dt: Optional[float] = None
        self._outlier_streak: Dict[int, int] = {}
        self._stragglers: List[int] = []
        self.last_verdict: Optional[TelemetryVerdict] = None
        self.n_published = 0
        self.epoch = 0  # rollbacks so far (note_rollback)
        # obs registry mirror: step times land in a shared
        # histogram so `python -m paddle_tpu_torch.obs dump` shows training
        # latency percentiles without reaching into the store rings
        self._h_step = _obs_registry().histogram(
            "train_step_seconds", {"tag": self.tag, "rank": self.rank},
            help="per-rank training step wall time")
        # persistent stragglers get NAMED in the watchdog hang dump;
        # close() unregisters (a rebuilt supervisor incarnation must not
        # leave its dead telemetry writing stale verdicts into dumps)
        _fr.register_dump_extra(self._dump_extra)

    def close(self) -> None:
        """Detach from the watchdog dump. Call when retiring this
        telemetry instance (e.g. rebuilding the supervisor after
        ``TrainingGaveUp``); safe to call twice."""
        _fr.unregister_dump_extra(self._dump_extra)

    def _key(self, rank: Optional[int] = None) -> str:
        r = self.rank if rank is None else rank
        return f"{self.tag}/tele/{r}"

    # -- publish ---------------------------------------------------------
    def publish(self, step: int, step_time: float, fingerprint: str):
        """One store write + one flight-recorder append per step. Store
        errors are swallowed after the retry budget — telemetry must
        never take a healthy step down with it."""
        self._ewma_dt = (step_time if self._ewma_dt is None
                         else self._ewma_dt + 0.2 * (step_time
                                                     - self._ewma_dt))
        self._h_step.observe(float(step_time))
        rec = {"step": int(step), "dt": float(step_time),
               "ewma_dt": float(self._ewma_dt), "fp": fingerprint,
               "epoch": self.epoch}
        _fr.record("train_step", group=f"{self.tag}/dp",
                   detail=f"step={step} dt={step_time * 1e3:.1f}ms "
                          f"fp={fingerprint}")
        # the ring REPLACES a replayed step's entry (post-rollback the
        # clean fingerprint supersedes the anomalous one at that step)
        self._ring = [r for r in self._ring if r["step"] != rec["step"]]
        self._ring.append(rec)
        del self._ring[:-self.ring_len]
        try:
            self.retry.call(
                lambda: self.store.set(
                    self._key(), json.dumps({"ring": self._ring})),
                deadline=Deadline(self.deadline_s),
                describe="telemetry publish")
            self.n_published += 1
        except (OSError, ValueError, RuntimeError, TimeoutError):
            pass

    def note_rollback(self) -> None:
        """This rank rolled back: its records from now on carry the next
        epoch. Under ``lockstep``, a check waits for and compares only
        peer records of at least this rank's epoch, so dp replicas that
        roll back together (the two-replica SDC verdict) compare their
        replays with each other, never a replay with a peer's abandoned
        record of the same step. The reference has no epochs: its replicas
        never wait on each other's replays."""
        self.epoch += 1

    # -- check -----------------------------------------------------------
    def _fetch_rings(self) -> Dict[int, List[dict]]:
        """One dump() round trip -> per-rank record rings (stale and
        malformed entries dropped)."""
        try:
            entries = self.retry.call(
                lambda: self.store.dump(f"{self.tag}/tele/"),
                deadline=Deadline(self.deadline_s),
                describe="telemetry dump")
        except (OSError, ValueError, RuntimeError, TimeoutError):
            return {}
        rings: Dict[int, List[dict]] = {}
        prefix = f"{self.tag}/tele/"
        for key, val, age in entries:
            if age > self.stale_s:
                continue  # a dead rank's last words — not evidence
            try:
                r = int(key[len(prefix):])
                ring = json.loads(val).get("ring", [])
                if isinstance(ring, list):
                    rings[r] = ring
            except (ValueError, KeyError, AttributeError):
                continue
        return rings

    def high_water(self) -> Optional[int]:
        """The max step ANY rank ever published under this tag — stale
        entries included on purpose: a killed rank's last words are
        exactly the evidence a relaunched incarnation needs to charge
        its replayed steps to the rollback goodput bucket instead of
        counting them as fresh progress."""
        try:
            entries = self.retry.call(
                lambda: self.store.dump(f"{self.tag}/tele/"),
                deadline=Deadline(self.deadline_s),
                describe="telemetry high-water dump")
        except (OSError, ValueError, RuntimeError, TimeoutError):
            return None
        best = None
        for _key, val, _age in entries:
            try:
                for rec in json.loads(val).get("ring", []):
                    s = int(rec.get("step", -1))
                    if best is None or s > best:
                        best = s
            except (ValueError, KeyError, AttributeError, TypeError):
                continue
        return best

    def wait_for_peers(self, step: int, deadline=None) -> bool:
        """Block (bounded) until every dp peer has published a record
        at/past ``step``; False when the deadline lapsed first — a dead
        peer costs the budget, never a wedge."""
        dl = Deadline.coerce(deadline) if deadline is not None \
            else Deadline(self.lockstep_deadline_s)
        others = [r for r in self.dp_group if r != self.rank]
        while True:
            rings = self._fetch_rings()
            ready = [r for r in others
                     if any(rec.get("step", -1) >= step
                            and rec.get("epoch", 0) >= self.epoch
                            for rec in rings.get(r, ()))]
            if len(ready) == len(others):
                return True
            if dl.expired():
                return False
            dl.sleep(0.02)

    def check(self, step: int, fingerprint: Optional[str] = None
              ) -> TelemetryVerdict:
        """Compare fresh peer records. SDC is only judged among records
        AT ``step`` (a peer mid-step simply hasn't published yet — not
        a divergence): 2 divergent replicas are unattributable so BOTH
        are suspects; with >=3 the majority fingerprint is the
        consensus and the minority the suspects — every rank computes
        the same suspect set. Straggling is judged on the EWMAs
        whatever step each peer is on."""
        verdict = TelemetryVerdict(step=int(step))
        if self.lockstep:
            self.wait_for_peers(step)
        rings = self._fetch_rings()
        verdict.peers_seen = sorted(rings)
        records = {r: ring[-1] for r, ring in rings.items() if ring}
        # -- SDC: dp-group fingerprint consensus at THIS step ----------
        same_step: Dict[int, dict] = {}
        for r, ring in rings.items():
            if r not in self.dp_group:
                continue
            for rec in ring:
                if rec.get("step") == step and rec.get("fp") and not (
                        self.lockstep and rec.get("epoch", 0) < self.epoch):
                    same_step[r] = rec
        if fingerprint is not None:
            same_step[self.rank] = {"fp": fingerprint, "step": step}
        if len(same_step) >= 2:
            counts: Dict[str, int] = {}
            for rec in same_step.values():
                counts[rec["fp"]] = counts.get(rec["fp"], 0) + 1
            if len(counts) > 1 and len(same_step) == 2:
                # two replicas disagreeing cannot attribute the fault —
                # BOTH recompute (rollback+replay is clean for the
                # healthy rank and curative for the corrupt one)
                verdict.sdc_suspects = sorted(same_step)
                verdict.detail = (
                    f"step {step}: fingerprints {counts} — 2-replica "
                    "divergence, unattributable: both recompute")
            elif len(counts) > 1:
                # >=3 replicas: the majority fingerprint is the
                # consensus (ties broken toward the lowest rank holding
                # one, so every rank names the same suspects)
                consensus = max(
                    counts,
                    key=lambda fp: (counts[fp], -min(
                        r for r, rec in same_step.items()
                        if rec["fp"] == fp)))
                verdict.sdc_suspects = sorted(
                    r for r, rec in same_step.items()
                    if rec["fp"] != consensus)
                verdict.detail = (
                    f"step {step}: fingerprints {counts} — suspect "
                    f"rank(s) {verdict.sdc_suspects} off the consensus")
        # -- stragglers: persistent EWMA outliers ----------------------
        ewmas = {r: float(rec["ewma_dt"]) for r, rec in records.items()
                 if "ewma_dt" in rec}
        if len(ewmas) >= 2:
            for r, e in ewmas.items():
                # leave-one-out median: judging a rank against a median
                # it participates in lets a single slow rank drag the
                # reference up (fatal at world=2, where the midpoint
                # halves any outlier's apparent factor)
                others = [v for rr, v in ewmas.items() if rr != r]
                ref = float(np.median(others))
                if ref > 0 and e > self.straggler_factor * ref:
                    self._outlier_streak[r] = \
                        self._outlier_streak.get(r, 0) + 1
                else:
                    self._outlier_streak[r] = 0
            self._stragglers = sorted(
                r for r, n in self._outlier_streak.items()
                if n >= self.straggler_patience)
            verdict.stragglers = list(self._stragglers)
        self.last_verdict = verdict
        return verdict

    def stragglers(self) -> List[int]:
        return list(self._stragglers)

    # -- watchdog dump hook ----------------------------------------------
    def _dump_extra(self, file):
        if self._stragglers:
            file.write(
                f"TrainTelemetry: rank(s) {self._stragglers} are "
                f"PERSISTENT stragglers (> {self.straggler_factor}x the "
                f"median EWMA step time for >= {self.straggler_patience} "
                "consecutive checks) — the hang's likeliest origin\n")
        if self.last_verdict is not None and self.last_verdict.sdc:
            file.write(
                f"TrainTelemetry: SDC suspicion at step "
                f"{self.last_verdict.step}: {self.last_verdict.detail}\n")
