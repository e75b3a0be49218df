"""Counterpart of ``paddle_tpu/testing/chaos.py``, copied: the same
``PADDLE_CHAOS`` spec and the same seed give the same decisions as the
reference's (both draw from ``random.Random``). Of the sites listed below
the port's serving engine runs ``serving.submit``, ``serving.step``,
``cache.spill`` and ``leak.hold``; the others belong to modules not
ported yet.

Deterministic fault injection — the chaos harness.

Robustness claims ("the heartbeat survives a store reset", "a torn save
never blocks resume", "a hung attempt forfeits only its share of the
budget") are only provable if the fault fires exactly where and when
the test scheduled it. This module provides that: instrumented sites in
the framework call :func:`inject(site)`; an installed
:class:`ChaosSchedule` decides — deterministically, from an explicit
(site, invocation-index) plan or a seeded per-site Bernoulli stream —
whether that invocation hangs, resets, drops, slows, errors, or kills
the process.

Instrumented sites (grep for ``chaos.inject``):

- ``store.request``      — every TCPKVStore request (reset/hang/slow)
- ``elastic.heartbeat``  — each membership beat (drop = lose the beat)
- ``ckpt.write``         — entering an auto-checkpoint save
- ``ckpt.publish``       — just before the atomic rename (kill here
  leaves a torn tmp dir that resume() must skip)
- ``serving.step``       — each engine iteration
- ``serving.submit``     — each ``add_request`` front-door entry
  (drop = the submission is shed at admission)
- ``serving.loop``       — each supervisor tick (inference/supervisor)
- ``cluster.route``      — each router placement decision
  (inference/cluster.py); a ``drop`` here deterministically MISROUTES
  the request to the next live replica — the correctness-under-
  misroute envelope the router tests pin down
- ``bench.attempt``      — the bench child, before any JAX import
- ``bench.probe``        — the bench preflight device-enumeration
  child, before any JAX import (indexed by probe attempt)
- ``comm.reorder``       — each collective flight-recorder append
  (``distributed/communication/flight_recorder.py``); a ``drop``
  here DEFERS that collective's signature until the next
  non-deferred one on this rank (FIFO across consecutive drops) —
  the deterministic schedule swap ``collective_contract`` and the
  COLL002 detector must catch
- ``handoff.export``     — each KV-block export on a prefill-role
  engine (inference/serving.py ``export_kv``)
- ``handoff.transfer``   — each store write of a handoff transfer leg
  (part puts and the commit record, inference/disagg.py); a byte
  site — ``corrupt`` flips a payload bit, ``drop`` loses the leg,
  ``kill`` mid-parts leaves the partial transfer the decode side
  must discard
- ``handoff.import``     — each committed transfer the decode side
  verifies + imports (inference/disagg.py); a ``drop`` defers the
  import to the next poll
- ``train.step``         — opt-in: training loops/test workers call it
- ``train.nan``          — each supervised training step
  (training/supervisor.py); a ``drop`` poisons that step's batch with
  NaN — loss/grads go non-finite and the optimizer step corrupts the
  params, exactly what anomaly-triggered rollback must undo
- ``train.spike``        — each supervised training step; a ``drop``
  scales the batch so the loss spikes finite-but-huge — the EWMA+MAD
  gate's case (non-finite checks never fire)
- ``train.sdc``          — each supervised training step; a ``drop``
  perturbs one batch element slightly — loss stays plausible but the
  gradient fingerprint diverges from the dp peers', the silent-data-
  corruption shape only cross-rank fingerprint exchange catches
- ``ckpt.peer``          — each peer-snapshot publish leg
  (training/peer_snapshot.py); a byte site — ``corrupt`` flips a
  payload bit (the put_bytes CRC framing must catch it at restore),
  ``drop`` loses the publish (recovery falls to an older tier)
- ``train.kill_rank.<r>`` — each supervised training step, suffixed
  with the supervisor's rank (training/supervisor.py); a no-arg
  ``kill`` scheduled at step N SIGKILLs exactly rank ``<r>`` at its
  N-th executed step — the pod-scale "one worker dies mid-pretrain"
  fault the elastic kill-and-resume proof injects. Other ranks'
  schedules never match the suffix, so a single shared PADDLE_CHAOS
  spec names its victim
- ``elastic.remesh``     — each ``ElasticManager.world_changed()``
  membership comparison (fleet/elastic); a ``drop`` FORCES the
  re-mesh decision true even with a stable world — exercises the
  re-mesh/recompile path without actually losing a node
- ``thread.preempt``     — each ``TracedLock`` release
  (utils/locks.py, only when the lock sanitizer is active); a
  ``slow`` stretches the critical section right before the drop —
  the seeded preemption that shakes latent lock-order interleavings
  out of the chaos-driven tests. The release itself always happens
  (``drop`` is ignored)
- ``scale.spawn``        — each autoscaler replica spawn
  (inference/autoscale.py); ``drop`` or ``error`` fails the spawn —
  the controller backs off exponentially (bounded), keeps its loop,
  and withholds its heartbeat so an ``AbsenceRule`` pages: never a
  crash-loop
- ``scale.drain``        — each autoscaler drain start
  (inference/autoscale.py); a ``drop`` SIGKILLs the victim MID-DRAIN
  (``InProcessReplica.kill``) — the router's journal-∪-table
  recovery must requeue its accepted work with zero losses
- ``cache.spill``        — each host-tier prefix-KV frame store
  (inference/cache_tier.py); a byte site — ``corrupt`` flips a
  payload bit (the CRC check rejects the frame at lookup: a cache
  miss, never a wrong-token serve), ``drop`` loses the spill
- ``leak.hold``          — each ``ResourceLedger`` release
  (utils/resources.py, only when the leak sanitizer is active); a
  ``drop`` DEFERS that accounting decrement — the underlying
  release still happens, but the ledger now shows an outstanding
  resource that ``leak_check()`` must catch: the sanitizer proving
  it would catch a real missed release

Faults (``Fault.kind``): ``hang``/``slow`` (sleep ``arg`` seconds;
``hang`` requires a positive arg), ``reset`` (raise
ConnectionResetError), ``error`` (raise RuntimeError), ``drop``
(inject returns False — the site skips the operation), ``kill``
(``os._exit(int(arg))`` with an explicit code; with no arg, SIGKILL —
the rc < 0 shape a real worker death has), ``corrupt`` (byte sites
only, via :func:`inject_bytes`: flip bit ``arg`` of the payload —
the fault CRC framing must catch; plain ``inject`` treats it as a
no-op).

Subprocess transport: ``PADDLE_CHAOS`` holds a spec string (see
:meth:`ChaosSchedule.to_spec`); the first ``inject`` call in a process
auto-installs it, so workers need zero harness code beyond their own
``inject`` sites. Stdlib-only by design — loadable by path from the
bench supervisor before any framework import.
"""
from __future__ import annotations

import os
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Fault",
    "ChaosClock",
    "ChaosSchedule",
    "ChaosMonkey",
    "install",
    "uninstall",
    "active",
    "inject",
    "inject_bytes",
    "monkey",
]

_KINDS = ("hang", "slow", "reset", "error", "drop", "kill", "corrupt")


@dataclass(frozen=True)
class Fault:
    kind: str  # one of _KINDS
    arg: float = 0.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "hang" and self.arg <= 0:
            # hang:0 would sleep zero seconds — a silent no-op that lets
            # a "survives a hang" test pass vacuously
            raise ValueError("hang needs a positive duration arg "
                             "(e.g. 'site@1=hang:30')")


class ChaosClock:
    """A virtual monotonic clock: ``now()`` only advances via
    ``sleep``/``advance``. Deadlines built on it expire exactly when the
    test says time passed — no real waiting, no flaky margins."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    __call__ = now

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._t += float(seconds)

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)


class ChaosSchedule:
    """What fires where. Two deterministic sources, explicit plan wins:

    - ``at(site, index, kind, arg)`` — fault the index-th invocation
      (1-based) of ``site``.
    - ``every(site, n, kind, arg)`` — fault every n-th invocation.
    - ``with_probability(site, p, kind, arg)`` — seeded Bernoulli per
      invocation; the draw depends only on (seed, site, index), so the
      pattern is reproducible regardless of thread timing or call
      order across sites.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._plan: Dict[Tuple[str, int], Fault] = {}
        self._every: Dict[str, Tuple[int, Fault]] = {}
        self._prob: Dict[str, Tuple[float, Fault]] = {}

    # -- plan makers (chainable) -----------------------------------------
    def at(self, site: str, index: int, kind: str,
           arg: float = 0.0) -> "ChaosSchedule":
        if index < 1:
            raise ValueError("invocation indexes are 1-based")
        self._plan[(site, int(index))] = Fault(kind, float(arg))
        return self

    def every(self, site: str, n: int, kind: str,
              arg: float = 0.0) -> "ChaosSchedule":
        if n < 1:
            raise ValueError("n must be >= 1")
        self._every[site] = (int(n), Fault(kind, float(arg)))
        return self

    def with_probability(self, site: str, p: float, kind: str,
                         arg: float = 0.0) -> "ChaosSchedule":
        if not 0.0 <= p <= 1.0:
            raise ValueError("p must be in [0, 1]")
        self._prob[site] = (float(p), Fault(kind, float(arg)))
        return self

    # -- lookup ---------------------------------------------------------
    def fault_for(self, site: str, index: int) -> Optional[Fault]:
        hit = self._plan.get((site, index))
        if hit is not None:
            return hit
        ev = self._every.get(site)
        if ev is not None and index % ev[0] == 0:
            return ev[1]
        pr = self._prob.get(site)
        if pr is not None:
            p, fault = pr
            # draw keyed by (seed, site, index): independent of call
            # order, identical across processes with the same seed
            if random.Random(f"{self.seed}:{site}:{index}").random() < p:
                return fault
        return None

    # -- env transport --------------------------------------------------
    # spec grammar (';'-separated clauses):
    #   seed=S
    #   site@IDX=kind:arg      explicit invocation
    #   site/N=kind:arg        every N-th invocation
    #   site%P=kind:arg        seeded Bernoulli(P)
    def to_spec(self) -> str:
        parts = [f"seed={self.seed}"]
        for (site, idx), f in sorted(self._plan.items()):
            parts.append(f"{site}@{idx}={f.kind}:{f.arg}")
        for site, (n, f) in sorted(self._every.items()):
            parts.append(f"{site}/{n}={f.kind}:{f.arg}")
        for site, (p, f) in sorted(self._prob.items()):
            parts.append(f"{site}%{p}={f.kind}:{f.arg}")
        return ";".join(parts)

    @classmethod
    def from_spec(cls, spec: str) -> "ChaosSchedule":
        sched = cls()
        for clause in filter(None, (c.strip() for c in spec.split(";"))):
            key, _, val = clause.partition("=")
            if key == "seed":
                sched.seed = int(val)
                continue
            kind, _, arg_s = val.partition(":")
            arg = float(arg_s) if arg_s else 0.0
            if "@" in key:
                site, idx = key.rsplit("@", 1)
                sched.at(site, int(idx), kind, arg)
            elif "/" in key:
                site, n = key.rsplit("/", 1)
                sched.every(site, int(n), kind, arg)
            elif "%" in key:
                site, p = key.rsplit("%", 1)
                sched.with_probability(site, float(p), kind, arg)
            else:
                raise ValueError(f"bad chaos clause {clause!r}")
        return sched


@dataclass
class ChaosMonkey:
    """An installed schedule plus the observability the tests assert on:
    per-site invocation counts and the log of fired faults."""

    schedule: ChaosSchedule
    clock: Optional[ChaosClock] = None
    counts: Dict[str, int] = field(default_factory=dict)
    events: List[Tuple[str, int, str]] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def fire(self, site: str, index: Optional[int] = None) -> bool:
        """Apply the scheduled fault (if any) for this invocation.
        Returns False when the site should SKIP its operation (drop);
        True otherwise. May raise or exit per the fault kind.
        ``index`` overrides the per-process invocation counter — sites
        that restart in a fresh process each round (the bench child)
        pass their attempt number so schedules still line up."""
        fault = self._draw(site, index)
        if fault is None or fault.kind == "corrupt":
            return True  # corrupt is meaningful only at byte sites
        return self._act(site, fault)

    def fire_bytes(self, site: str, data: bytes,
                   index: Optional[int] = None) -> Optional[bytes]:
        """:meth:`fire` for byte-payload sites: returns the payload
        (bit-flipped under a ``corrupt`` fault — bit ``arg`` counted
        from the payload start), or None on a ``drop`` (the site loses
        the message). Other kinds behave exactly like :meth:`fire`."""
        fault = self._draw(site, index)
        if fault is None:
            return data
        if fault.kind == "corrupt":
            bit = int(fault.arg) % max(len(data) * 8, 1)
            out = bytearray(data)
            if out:
                out[bit // 8] ^= 1 << (bit % 8)
            return bytes(out)
        return data if self._act(site, fault) else None

    def _draw(self, site: str, index: Optional[int]) -> Optional[Fault]:
        with self._lock:
            idx = index if index is not None else self.counts.get(site, 0) + 1
            self.counts[site] = idx
            fault = self.schedule.fault_for(site, idx)
            if fault is not None:
                self.events.append((site, idx, fault.kind))
        return fault

    def _act(self, site: str, fault: Fault) -> bool:
        idx = self.counts.get(site, 0)
        if fault.kind in ("hang", "slow"):
            (self.clock.sleep if self.clock is not None
             else time.sleep)(fault.arg)
            return True
        if fault.kind == "reset":
            raise ConnectionResetError(
                f"chaos: injected connection reset at {site}#{idx}")
        if fault.kind == "error":
            raise RuntimeError(f"chaos: injected error at {site}#{idx}")
        if fault.kind == "drop":
            return False
        if fault.kind == "kill":
            if fault.arg:
                os._exit(int(fault.arg))  # explicit exit code
            # no arg: die like real hardware — a signal, so supervisors
            # observe rc < 0 (the transient classification a genuine
            # worker death gets), not a clean-looking positive exit
            import signal

            os.kill(os.getpid(), signal.SIGKILL)
        return True  # pragma: no cover — _KINDS is exhaustive


_monkey: Optional[ChaosMonkey] = None
_env_checked = False


def install(schedule: ChaosSchedule,
            clock: Optional[ChaosClock] = None) -> ChaosMonkey:
    global _monkey
    _monkey = ChaosMonkey(schedule=schedule, clock=clock)
    return _monkey


def uninstall() -> None:
    global _monkey, _env_checked
    _monkey = None
    _env_checked = True  # an explicit uninstall also disables env pickup


def monkey() -> Optional[ChaosMonkey]:
    return _monkey


@contextmanager
def active(schedule: ChaosSchedule, clock: Optional[ChaosClock] = None):
    mk = install(schedule, clock)
    try:
        yield mk
    finally:
        uninstall()


def inject(site: str, index: Optional[int] = None) -> bool:
    """Called by instrumented sites. No-op (returns True) unless a
    schedule is installed — in-process via :func:`install`, or picked up
    once from the ``PADDLE_CHAOS`` env spec (subprocess workers)."""
    global _env_checked, _monkey
    if _monkey is None:
        if _env_checked:
            return True
        _env_checked = True
        spec = os.environ.get("PADDLE_CHAOS")
        if not spec:
            return True
        _monkey = ChaosMonkey(schedule=ChaosSchedule.from_spec(spec))
    return _monkey.fire(site, index)


def inject_bytes(site: str, data: bytes,
                 index: Optional[int] = None) -> Optional[bytes]:
    """:func:`inject` for byte-payload sites (the KV handoff transfer
    legs): returns the payload — bit-flipped under a ``corrupt``
    fault — or None when the site should DROP the message. No-op
    (returns ``data``) unless a schedule is installed."""
    global _env_checked, _monkey
    if _monkey is None:
        if _env_checked:
            return data
        _env_checked = True
        spec = os.environ.get("PADDLE_CHAOS")
        if not spec:
            return data
        _monkey = ChaosMonkey(schedule=ChaosSchedule.from_spec(spec))
    return _monkey.fire_bytes(site, data, index)
