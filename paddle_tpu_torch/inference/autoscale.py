"""Closed-loop fleet autoscaling driven by SLO burn-rate alerts
(counterpart of ``paddle_tpu/inference/autoscale.py``, copied over the
port's ``obs.alerts``, router and chaos sites).

Per-tenant burn rates, error budgets, absence detection and fleet
snapshots are the *sense* side of fleet operation. This module is the
*act* side: a :class:`FleetAutoscaler` that owns a
:class:`~paddle_tpu_torch.inference.cluster.ClusterRouter`'s replica set and
closes the loop on the alert engine itself.

Controller state machine (one action per ``step``)::

      STEADY ── short-window BurnRateRule fires ──────────▶ SCALE-UP
        ▲        (spawn via replica_factory; chaos          │
        │         `scale.spawn` drop/error = bounded        │
        │         exponential backoff, heartbeat withheld   │
        │         so an AbsenceRule sees the stall —        │
        │         never a crash-loop)                       │
        │                                                   ▼
      DRAIN ◀── budget_remaining_frac recovered past     STEADY
        │        `recover_budget_frac` AND held
        │        `recover_hold_s` AND cooldown passed
        │
        ├── drained (no inflight, queue empty) ──▶ retire (forfeit the
        │                                          replica's radix tree;
        │                                          the host tier keeps
        │                                          its spilled prefixes)
        └── dies mid-drain (chaos `scale.drain`) ─▶ router recovery:
                                                   journal-∪-table
                                                   requeue, zero
                                                   accepted requests
                                                   lost

Why the alert engine is the control signal: the multi-window burn-rate
rules (Google SRE Workbook policy) already encode "is the SLO
in danger *now*" with flap suppression — re-deriving that from raw
latencies in the controller would just be a worse copy. Scale-up keys
off any firing burn alert (the short window makes it fast); scale-down
keys off the *budget* annotation recovering past hysteresis and
holding there, so a transient lull inside an incident never sheds
capacity. A feed-forward term (the loadgen ``TraceSpec`` diurnal/burst
shape, or any ``now -> expected-rate-multiple`` callable) raises the
replica floor BEFORE a predictable peak arrives — feedback alone
always pays one breach per ramp.

Disaggregated fleets (``AutoscalerConfig(disagg=True)``): the next
spawn's role steers by measured pressure — prefill pressure (chunk
backlog: queued-work delay estimate + prefilling slots) against decode
pressure (slot occupancy + step-latency EWMA, the ITL proxy) — so the
prefill:decode pool ratio follows the workload's prompt/generation mix
instead of being frozen at deploy time.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..obs.alerts import AbsenceRule, ThresholdRule
from ..obs.metrics import registry as _reg
from ..testing import chaos as _chaos

__all__ = ["AutoscalerConfig", "FleetAutoscaler"]


@dataclass
class AutoscalerConfig:
    """Controller knobs. The hysteresis pair — breach fires scale-up,
    but scale-down additionally needs the error budget back above
    ``recover_budget_frac`` for ``recover_hold_s`` — is what keeps the
    controller from oscillating at the SLO boundary."""

    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_cooldown_s: float = 1.0
    scale_down_cooldown_s: float = 5.0
    # scale-down hysteresis: budget_remaining_frac must exceed this...
    recover_budget_frac: float = 0.5
    # ...continuously for this long before a drain may start
    recover_hold_s: float = 3.0
    # bounded exponential backoff after a failed spawn
    spawn_backoff_s: float = 0.5
    spawn_backoff_max_s: float = 8.0
    # a draining replica that cannot quiesce within this window is
    # treated as crashed (recovery requeues its accepted work)
    drain_timeout_s: float = 30.0
    # feed-forward: floor = ceil(min_replicas * rate_multiple * headroom)
    feedforward_headroom: float = 1.0
    # alert evaluation cadence inside step() (0 = every step)
    evaluate_interval_s: float = 0.25
    # disaggregated fleets: steer the next spawn's role by prefill vs
    # decode pressure; >1 biases toward prefill workers
    disagg: bool = False
    prefill_decode_bias: float = 1.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if not 0.0 < self.recover_budget_frac < 1.0:
            raise ValueError("recover_budget_frac must be in (0, 1)")
        if self.spawn_backoff_s <= 0 or self.spawn_backoff_max_s \
                < self.spawn_backoff_s:
            raise ValueError("spawn backoff bounds must satisfy "
                             "0 < spawn_backoff_s <= spawn_backoff_max_s")


def _squash(x: Optional[float]) -> float:
    x = float(x or 0.0)
    return x / (1.0 + x)


class FleetAutoscaler:
    """SLO-burn-driven replica controller over a
    :class:`~paddle_tpu_torch.inference.cluster.ClusterRouter`.

    ``replica_factory(replica_id)`` (or ``(replica_id, role=...)`` with
    ``disagg=True``) builds one replica transport; the controller joins
    it via ``router.add_replica``. ``alerts`` is the
    :class:`~paddle_tpu_torch.obs.alerts.AlertManager` holding the fleet's
    :class:`BurnRateRule`s — the controller reads its statuses and
    ticks ``maybe_evaluate`` itself, so a bench or single-process
    deployment needs no separate evaluation loop. ``feedforward`` is an
    optional ``now -> expected-rate-multiple`` callable (see
    ``benchmarks.loadgen.feedforward_from_spec``).

    Drive it either by calling :meth:`step` from an existing loop or
    via the background thread (:meth:`start`/:meth:`stop`). All mutable
    state is guarded by one lock; every public method is thread-safe.
    """

    SOURCE = "autoscaler"

    def __init__(self, router, replica_factory: Callable, *,
                 config: Optional[AutoscalerConfig] = None,
                 alerts=None,
                 feedforward: Optional[Callable[[float], float]] = None,
                 clock=time.monotonic):
        self.router = router
        self.replica_factory = replica_factory
        self.config = config if config is not None else AutoscalerConfig()
        self.alerts = alerts
        self.feedforward = feedforward
        self._clock = clock
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._last_scale_up = -math.inf
        self._last_scale_down = -math.inf
        self._recovered_since: Optional[float] = None
        self._spawn_fail_streak = 0
        self._spawn_retry_at = -math.inf
        self._spawn_seq = 0
        self._last_healthy: Optional[float] = None
        self._last_step_t: Optional[float] = None
        self._draining: Dict[int, float] = {}  # idx -> drain start
        self.replica_seconds = 0.0
        self.decisions: List[dict] = []
        reg = _reg()
        self._reg = reg
        self._g_replicas = reg.gauge(
            "autoscale_replicas",
            help="replicas accepting NEW placements (live minus "
                 "draining)")
        self._g_desired = reg.gauge(
            "autoscale_desired_replicas",
            help="controller's current replica target")
        self._g_fail = reg.gauge(
            "autoscale_spawn_consecutive_failures",
            help="consecutive failed spawn attempts (0 = healthy)")

    # -- alert-side helpers ---------------------------------------------
    def alert_rules(self, *, heartbeat_max_age_s: float = 10.0) -> list:
        """Rules making the controller's OWN failure modes page: a
        spawn crash-loop (consecutive-failure gauge > 0) and controller
        silence (the withheld heartbeat, via an AbsenceRule over source
        ``autoscaler`` — feed :meth:`heartbeat_age` into
        ``AlertManager.evaluate(ages=...)``)."""
        return [
            ThresholdRule(
                "autoscale_spawn_failing",
                "autoscale_spawn_consecutive_failures",
                threshold=0.0, op=">", stat="value",
                severity="critical"),
            AbsenceRule("autoscale_silent", source=self.SOURCE,
                        max_age_s=heartbeat_max_age_s),
        ]

    def heartbeat_age(self, now: Optional[float] = None) -> float:
        """Seconds since the controller last completed a HEALTHY step
        (healthy = no unresolved spawn failure). While a spawn is
        failing the heartbeat is withheld, so an
        ``AbsenceRule(source="autoscaler")`` fires — the satellite
        contract: spawn failure is alert-visible, never a crash-loop."""
        with self._lock:
            now = self._clock() if now is None else float(now)
            if self._spawn_fail_streak > 0 or self._last_healthy is None:
                return math.inf
            return max(now - self._last_healthy, 0.0)

    # -- fleet introspection --------------------------------------------
    def _live_idxs(self) -> List[int]:
        return [i for i, rep in enumerate(self.router.replicas)
                if i not in self.router.dead and rep.alive()]

    def _burn_signal(self):
        """(breach, worst budget_remaining_frac) from the manager's
        burn statuses. Only burn rules annotate a budget, so the filter
        is structural — no rule-name convention needed."""
        if self.alerts is None:
            return False, None
        breach, budget = False, None
        for st in self.alerts.statuses():
            ann = st.get("annotations") or {}
            if "budget_remaining_frac" not in ann:
                continue
            if st.get("state") == "firing":
                breach = True
            b = float(ann["budget_remaining_frac"])
            budget = b if budget is None else min(budget, b)
        return breach, budget

    def _floor(self, now: float) -> int:
        floor = self.config.min_replicas
        if self.feedforward is not None:
            try:
                mult = max(float(self.feedforward(now)), 0.0)
            except Exception:  # noqa: BLE001 — a broken hint never
                mult = 1.0     # takes the controller down with it
            floor = max(floor, math.ceil(
                self.config.min_replicas * mult
                * self.config.feedforward_headroom))
        return min(floor, self.config.max_replicas)

    # -- the control step ------------------------------------------------
    def step(self, now: Optional[float] = None) -> dict:
        """One control tick: integrate replica-seconds, sweep drains,
        evaluate alerts, then at most ONE scaling action. Returns the
        decision record (also appended to ``decisions``)."""
        with self._lock:
            now = self._clock() if now is None else float(now)
            cfg = self.config
            live = self._live_idxs()
            if self._last_step_t is not None:
                self.replica_seconds += len(live) * max(
                    now - self._last_step_t, 0.0)
            self._last_step_t = now
            if self.alerts is not None:
                try:
                    self.alerts.maybe_evaluate(
                        min_interval_s=cfg.evaluate_interval_s)
                except Exception:  # noqa: BLE001 — a broken rule set
                    pass           # must not stop the control loop
            self._sweep_drains(now)
            live = self._live_idxs()
            placeable = [i for i in live if i not in self._draining]
            breach, budget = self._burn_signal()
            floor = self._floor(now)
            desired = len(placeable)
            action = "hold"
            if breach:
                self._recovered_since = None
            if len(placeable) < floor:
                desired = floor
                action = self._try_spawn(now, reason="feedforward-floor")
            elif breach and len(placeable) < cfg.max_replicas \
                    and now - self._last_scale_up >= cfg.scale_up_cooldown_s:
                desired = len(placeable) + 1
                action = self._try_spawn(now, reason="burn-breach")
            elif (not breach and not self._draining
                    and len(placeable) > floor):
                recovered = budget is None \
                    or budget >= cfg.recover_budget_frac
                if recovered:
                    if self._recovered_since is None:
                        self._recovered_since = now
                    if (now - self._recovered_since >= cfg.recover_hold_s
                            and now - self._last_scale_down
                            >= cfg.scale_down_cooldown_s):
                        desired = len(placeable) - 1
                        action = self._start_drain(now)
                else:
                    self._recovered_since = None
            if self._spawn_fail_streak == 0:
                self._last_healthy = now
            self._g_replicas.set(float(len(placeable)))
            self._g_desired.set(float(desired))
            rec = {"t": now, "action": action, "live": len(live),
                   "placeable": len(placeable), "desired": desired,
                   "floor": floor, "breach": breach,
                   "budget_remaining_frac": budget,
                   "draining": sorted(self._draining),
                   "replica_seconds": self.replica_seconds}
            if action != "hold":
                self.decisions.append(rec)
            return rec

    def _count(self, action: str) -> None:
        self._reg.counter(
            "autoscale_decisions_total", {"action": action},
            help="autoscaler actions by kind").inc()

    # -- scale-up --------------------------------------------------------
    def _try_spawn(self, now: float, *, reason: str) -> str:
        cfg = self.config
        if now < self._spawn_retry_at:
            return "spawn-backoff"
        role = self._pick_role() if cfg.disagg else None
        rid = f"auto{self._spawn_seq}"
        try:
            # chaos site: spawn failure (drop or error) — the
            # controller backs off exponentially (bounded) and stays
            # in its loop; the withheld heartbeat + failure gauge make
            # the stall alert-visible
            if not _chaos.inject("scale.spawn"):
                raise RuntimeError("chaos: spawn dropped")
            rep = (self.replica_factory(rid) if role is None
                   else self.replica_factory(rid, role=role))
        except Exception as e:  # noqa: BLE001 — ANY spawn failure backs
            self._spawn_fail_streak += 1
            self._g_fail.set(float(self._spawn_fail_streak))
            backoff = min(
                cfg.spawn_backoff_s * (2 ** (self._spawn_fail_streak - 1)),
                cfg.spawn_backoff_max_s)
            self._spawn_retry_at = now + backoff
            self._count("spawn-failed")
            self.decisions.append(
                {"t": now, "action": "spawn-failed", "reason": reason,
                 "error": str(e), "backoff_s": backoff,
                 "streak": self._spawn_fail_streak})
            return "spawn-failed"
        self._spawn_seq += 1
        self._spawn_fail_streak = 0
        self._g_fail.set(0.0)
        self._spawn_retry_at = now
        idx = self.router.add_replica(rep)
        # a spawn outranks any in-progress drain of the same capacity
        if idx in self._draining:  # pragma: no cover — fresh index
            del self._draining[idx]
        self._last_scale_up = now
        self._recovered_since = None
        self._count("scale-up")
        self.decisions.append(
            {"t": now, "action": "scale-up", "reason": reason,
             "replica": rep.replica_id, "index": idx, "role": role})
        return "scale-up"

    def _pick_role(self) -> str:
        """Disagg pool-ratio steering: compare fleet-wide prefill
        pressure (queued-chunk backlog / delay estimate + prefilling
        slots) against decode pressure (slot occupancy + the ITL proxy,
        step-latency EWMA); spawn the starved side."""
        prefill_p = decode_p = 0.0
        for i in self._live_idxs():
            try:
                d = self.router.replicas[i].load() or {}
            except Exception:  # noqa: BLE001 — unreadable load: skip
                continue
            mb = max(int(d.get("max_batch") or 1), 1)
            prefill_p += (_squash(d.get("est_queue_delay_s"))
                          + int(d.get("prefilling") or 0) / mb)
            decode_p += (int(d.get("active_slots") or 0) / mb
                         + _squash(d.get("ewma_step_s")))
        if prefill_p * self.config.prefill_decode_bias >= decode_p:
            return "prefill"
        return "decode"

    # -- scale-down ------------------------------------------------------
    def _start_drain(self, now: float) -> str:
        victim = self._pick_drain_victim()
        if victim is None:
            return "hold"
        self.router.mark_draining(victim)
        self._draining[victim] = now
        self._last_scale_down = now
        self._count("drain-start")
        self.decisions.append(
            {"t": now, "action": "drain-start", "index": victim,
             "replica": self.router.replicas[victim].replica_id})
        # chaos site: a drop here is a SIGKILL MID-DRAIN — the replica
        # dies with accepted work still on it. The router's liveness
        # sweep then runs journal-∪-table recovery; the acceptance
        # proof is that zero accepted requests are lost even so.
        if not _chaos.inject("scale.drain"):
            try:
                self.router.replicas[victim].kill()
            except Exception:  # noqa: BLE001 — no kill hook: the
                pass           # timeout path recovers it instead
        return "drain-start"

    def _pick_drain_victim(self) -> Optional[int]:
        """Prefix-cache-aware victim choice: forfeit the replica whose
        radix tree is worth the least (fewest cached nodes, then
        fewest routed requests, then the newest index) — the cheapest
        tree to re-warm on the survivors."""
        cands = [i for i in self._live_idxs() if i not in self._draining]
        if len(cands) <= 1:
            return None

        def value(i):
            nodes = 0
            try:
                pf = (self.router.replicas[i].load() or {}).get(
                    "prefix") or {}
                nodes = int(pf.get("nodes") or 0)
            except Exception:  # noqa: BLE001 — unreadable load scores 0
                pass
            return (nodes, self.router.n_routed[i], -i)

        return min(cands, key=value)

    def _sweep_drains(self, now: float) -> None:
        for idx, since in list(self._draining.items()):
            rep = self.router.replicas[idx]
            if idx in self.router.dead or not rep.alive():
                # died mid-drain: the router's check_replicas owns the
                # recovery (journal ∪ table requeue); nothing to retire
                del self._draining[idx]
                self._count("drain-died")
                self.decisions.append(
                    {"t": now, "action": "drain-died", "index": idx})
                continue
            if self.router.drained(idx):
                self.router.retire_replica(idx)
                del self._draining[idx]
                self._last_scale_down = now
                self._count("scale-down")
                self.decisions.append(
                    {"t": now, "action": "scale-down", "index": idx,
                     "replica": rep.replica_id})
            elif now - since > self.config.drain_timeout_s:
                # cannot quiesce (a stuck session keeps following it):
                # crash-only fallback — recover requeues its accepted
                # work onto survivors, then the replica is stopped
                del self._draining[idx]
                self.router.recover_replica(idx)
                try:
                    rep.stop()
                except Exception:  # noqa: BLE001 — best-effort stop
                    pass
                self._count("drain-timeout")
                self.decisions.append(
                    {"t": now, "action": "drain-timeout", "index": idx})

    # -- background serve loop -------------------------------------------
    def start(self, interval_s: float = 0.25) -> None:
        """Run :meth:`step` on a daemon thread every ``interval_s``."""
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("autoscaler already started")
            self._stop_evt = threading.Event()
            self._thread = threading.Thread(
                target=self._serve, args=(float(interval_s),),
                name="paddle-tpu-torch-autoscaler", daemon=True)
            self._thread.start()

    def _serve(self, interval_s: float) -> None:
        while not self._stop_evt.wait(interval_s):
            try:
                self.step()
            except Exception:  # noqa: BLE001 — the control loop must
                # survive any single bad tick (a dying replica's load()
                # mid-teardown, a racing router mutation); the next
                # tick re-reads everything from scratch
                continue

    def stop(self) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
            self._stop_evt.set()
        if thread is not None:
            thread.join(timeout=10.0)

    # -- observability ---------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "live": len(self._live_idxs()),
                "draining": sorted(self._draining),
                "replica_seconds": self.replica_seconds,
                "spawn_fail_streak": self._spawn_fail_streak,
                "decisions": len(self.decisions),
                "min_replicas": self.config.min_replicas,
                "max_replicas": self.config.max_replicas,
            }
