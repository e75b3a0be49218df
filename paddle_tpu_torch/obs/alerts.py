"""Declarative, deterministic alert engine over the obs stack
(counterpart of ``paddle_tpu/obs/alerts.py``, copied; the journal's
``schema`` name is the reference's).

The registry, traces, SLO attainment and fleet aggregation are the
sensing half. This module WATCHES those signals. Three rule
kinds, evaluated over a live registry snapshot or a merged fleet
registry (:mod:`.agg`):

- :class:`ThresholdRule` — compare any counter/gauge/histogram series
  (``stat``: a gauge/counter ``value``, a cross-series ``total``, a
  histogram percentile ``p50/p95/p99``/``count``, or a windowed
  per-second ``rate`` of a counter) against a bound.
- :class:`AbsenceRule` — a publisher that goes silent is itself an
  alert: grades publication AGE from the fleet store's
  ``published_unix`` stamps; a source that vanishes entirely keeps
  alerting (the manager remembers every source it has ever seen).
- :class:`BurnRateRule` — multi-window SLO burn rate over the
  TTFT/ITL/queue-delay histograms, Google-SRE style: with objective
  ``o`` the error budget is ``1 - o``; the burn rate over a window is
  ``(bad / total) / (1 - o)`` (1.0 = spending exactly the budget).
  The rule fires only when EVERY configured ``(window_s, factor)``
  breaches — the long window proves sustained damage, the short
  window proves it is still happening (fast reset). Latency targets
  resolve per (tenant, priority) from an :class:`~.slo.SLOSpec`, and
  the rule fans out per tenant label automatically.

Alerts carry a full lifecycle so flapping signals don't flap alerts:
``inactive → pending`` on breach, ``pending → firing`` only after the
condition holds ``for_s`` (a flap during pending returns to inactive
with NO event), ``firing → resolved`` only after the condition stays
clear ``resolve_for_s`` (hysteresis; ``resolve_threshold`` optionally
widens the clear band). Transitions are pure functions of the
evaluation clock — pass explicit ``now`` values and the lifecycle
replays byte-identically.

Firing/resolve transitions emit three ways at once: a trace instant
(``alert_firing``/``alert_resolved``) into the span ring, a JSONL
journal record (``journal_path`` / ``PADDLE_ALERT_JOURNAL``), and the
``obs_alerts_fired_total`` / ``obs_alerts_resolved_total`` counters in
the local registry (so the FLEET snapshot shows every replica's alert
activity). Every ``health()`` envelope carries the default manager's
compact summary.

CLI: ``python -m paddle_tpu_torch.obs alerts STORE`` (rc 1 when firing)
and ``python -m paddle_tpu_torch.obs top STORE`` (live fleet dashboard).
"""
from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import metrics as _metrics
from . import trace as _trace
from .metrics import Histogram, MetricsRegistry
from .slo import SLOSpec

__all__ = [
    "ALERT_SCHEMA",
    "burn_rate",
    "budget_remaining_frac",
    "ThresholdRule",
    "AbsenceRule",
    "BurnRateRule",
    "DEFAULT_BURN_WINDOWS",
    "burn_rules_from_slo",
    "default_serving_rules",
    "default_training_rules",
    "AlertManager",
    "default_manager",
    "set_default_manager",
    "health_summary",
]

ALERT_SCHEMA = "paddle_tpu.obs.alert/1"

# (window_s, burn factor) pairs — ALL must breach. 5 min of sustained
# burn plus a still-hot 1 min window: sized to this framework's
# in-process serve loops rather than month-long SLO periods.
DEFAULT_BURN_WINDOWS: Tuple[Tuple[float, float], ...] = (
    (300.0, 14.4), (60.0, 14.4))

# which SLOClass field grades which SLO histogram
_SLO_FIELD = {
    "serving_ttft_seconds": "ttft_s",
    "serving_itl_seconds": "itl_p95_s",
}


# ---------------------------------------------------------------------------
# shared error-budget arithmetic (loadgen's report columns pin against
# these exact functions — one arithmetic, two surfaces)


def burn_rate(bad: float, total: float, objective: float) -> float:
    """How fast the error budget is being spent: observed error rate
    over allowed error rate. 1.0 = spending exactly the budget; 14.4 =
    a 30-day budget gone in 50 h. 0 when there is no traffic."""
    if total <= 0:
        return 0.0
    allowed = 1.0 - float(objective)
    if allowed <= 0.0:
        return math.inf if bad > 0 else 0.0
    return (float(bad) / float(total)) / allowed


def budget_remaining_frac(bad: float, total: float,
                          objective: float) -> float:
    """Fraction of the error budget left over the accounted window:
    1.0 untouched, 0.0 exactly spent, negative = overspent."""
    if total <= 0:
        return 1.0
    allowed = 1.0 - float(objective)
    if allowed <= 0.0:
        return 0.0 if bad > 0 else 1.0
    return 1.0 - (float(bad) / float(total)) / allowed


# ---------------------------------------------------------------------------
# rules


def _cmp(value: float, op: str, threshold: float) -> bool:
    if op == ">":
        return value > threshold
    if op == ">=":
        return value >= threshold
    if op == "<":
        return value < threshold
    if op == "<=":
        return value <= threshold
    raise ValueError(f"unknown op {op!r} (want > >= < <=)")


@dataclass(frozen=True)
class ThresholdRule:
    """Compare one stat of a registry metric against a bound.

    ``stat``: ``"total"`` (sum across series — counters/gauges),
    ``"value"`` (each series separately, or one series via
    ``labels``), ``"count"``/``"p50"``/``"p95"``/``"p99"`` (histogram
    series), ``"rate"`` (per-second increase of the cross-series
    total over the trailing ``window_s``)."""

    name: str
    metric: str
    threshold: float
    op: str = ">"
    stat: str = "total"
    labels: Optional[dict] = None
    window_s: float = 60.0
    for_s: float = 0.0
    resolve_for_s: float = 0.0
    resolve_threshold: Optional[float] = None
    severity: str = "warning"
    description: str = ""

    def to_dict(self) -> dict:
        return {"kind": "threshold", "name": self.name,
                "metric": self.metric, "op": self.op,
                "threshold": self.threshold, "stat": self.stat,
                "for_s": self.for_s, "resolve_for_s": self.resolve_for_s,
                "severity": self.severity}


@dataclass(frozen=True)
class AbsenceRule:
    """A publication that stops arriving. Grades per-source age (now
    minus ``published_unix``); ``source=None`` watches every source the
    manager has ever seen — including ones that later disappear from
    the store entirely (age = +inf)."""

    name: str
    source: Optional[str] = None
    max_age_s: float = 5.0
    for_s: float = 0.0
    resolve_for_s: float = 0.0
    severity: str = "critical"
    description: str = ""

    def to_dict(self) -> dict:
        return {"kind": "absence", "name": self.name,
                "source": self.source, "max_age_s": self.max_age_s,
                "for_s": self.for_s, "resolve_for_s": self.resolve_for_s,
                "severity": self.severity}


@dataclass(frozen=True)
class BurnRateRule:
    """Multi-window SLO burn over one SLO histogram. ``bad`` =
    observations over the latency target (:meth:`Histogram.count_over`),
    ``total`` = all observations; both deltas over each window from the
    manager's sample history. Fires when every window's burn >= its
    factor. Target: explicit ``threshold_s``, else resolved per
    (tenant, ``priority``) from ``slo`` (tenant overrides apply —
    that's the per-(tenant, priority) error-budget accounting)."""

    name: str
    metric: str
    objective: float = 0.99
    threshold_s: Optional[float] = None
    slo: Optional[SLOSpec] = None
    tenant: Optional[str] = None
    priority: str = "interactive"
    windows: Tuple[Tuple[float, float], ...] = DEFAULT_BURN_WINDOWS
    for_s: float = 0.0
    resolve_for_s: float = 0.0
    severity: str = "page"
    description: str = ""

    def target_for(self, tenant: str) -> Optional[float]:
        if self.threshold_s is not None:
            return float(self.threshold_s)
        if self.slo is None:
            return None
        cls = self.slo.resolve(tenant, self.priority)
        fld = _SLO_FIELD.get(self.metric)
        if fld is None:
            return None
        return getattr(cls, fld)

    def to_dict(self) -> dict:
        return {"kind": "burn_rate", "name": self.name,
                "metric": self.metric, "objective": self.objective,
                "threshold_s": self.threshold_s, "tenant": self.tenant,
                "priority": self.priority,
                "windows": [list(w) for w in self.windows],
                "for_s": self.for_s, "resolve_for_s": self.resolve_for_s,
                "severity": self.severity}


def burn_rules_from_slo(spec: SLOSpec, *, objective: float = 0.99,
                        windows: Tuple[Tuple[float, float], ...]
                        = DEFAULT_BURN_WINDOWS,
                        priority: str = "interactive",
                        for_s: float = 0.0,
                        resolve_for_s: float = 0.0,
                        severity: str = "page") -> List[BurnRateRule]:
    """One burn-rate rule per SLO histogram the spec constrains. Each
    rule carries the spec itself, so per-tenant target overrides
    resolve lazily as tenants appear in the metric's label sets."""
    out: List[BurnRateRule] = []
    for metric, fld in sorted(_SLO_FIELD.items()):
        default = spec.resolve("__default__", priority)
        if getattr(default, fld) is None and not spec.per_tenant:
            continue
        out.append(BurnRateRule(
            name=f"slo_burn_{metric}", metric=metric,
            objective=objective, slo=spec, priority=priority,
            windows=windows, for_s=for_s, resolve_for_s=resolve_for_s,
            severity=severity))
    return out


def default_serving_rules(*, slo: Optional[SLOSpec] = None,
                          objective: float = 0.99,
                          absence_age_s: float = 5.0,
                          queue_frac_max: float = 0.95) -> list:
    """The serving fleet's stock rule set: silenced-replica absence,
    sustained queue saturation, plus (when a spec is given) the SLO
    burn-rate rules."""
    rules: list = [
        AbsenceRule("replica_silent", max_age_s=absence_age_s,
                    severity="critical",
                    description="a fleet source stopped publishing"),
        ThresholdRule("queue_saturated", "serving_queue_frac",
                      threshold=queue_frac_max, op=">", stat="value",
                      for_s=5.0, resolve_threshold=0.8,
                      severity="warning",
                      description="admission queue near capacity"),
    ]
    if slo is not None:
        rules.extend(burn_rules_from_slo(slo, objective=objective))
    return rules


def default_training_rules(*, max_rollbacks_per_min: float = 3.0,
                           goodput_floor: float = 0.5) -> list:
    """Training-supervisor stock rules: rollback storms (windowed
    rate), goodput_frac floor, and any rank the straggler detector has
    currently flagged."""
    return [
        ThresholdRule("train_rollback_storm", "training_rollbacks_total",
                      threshold=max_rollbacks_per_min / 60.0, op=">",
                      stat="rate", window_s=60.0, resolve_for_s=30.0,
                      severity="critical",
                      description="anomaly rollbacks faster than budget"),
        ThresholdRule("train_goodput_low", "training_goodput_frac",
                      threshold=goodput_floor, op="<", stat="value",
                      for_s=10.0, resolve_for_s=10.0,
                      severity="warning",
                      description="productive fraction of wall time low"),
        ThresholdRule("train_straggler", "training_straggler_ranks",
                      threshold=0.5, op=">", stat="total",
                      severity="warning",
                      description="straggler detector verdict active"),
    ]


# ---------------------------------------------------------------------------
# lifecycle


class _Status:
    """Mutable per-(rule, series) alert state."""

    __slots__ = ("rule", "labels", "state", "pending_since", "fired_at",
                 "clear_since", "resolved_at", "value", "threshold",
                 "annotations")

    def __init__(self, rule, labels: dict):
        self.rule = rule
        self.labels = dict(labels)
        self.state = "inactive"
        self.pending_since = None
        self.fired_at = None
        self.clear_since = None
        self.resolved_at = None
        self.value = None
        self.threshold = None
        self.annotations: dict = {}

    def to_dict(self) -> dict:
        def _r(v):
            return None if v is None else round(float(v), 6)

        return {
            "rule": self.rule.name,
            "severity": self.rule.severity,
            "labels": dict(sorted(self.labels.items())),
            "state": self.state,
            "value": _r(self.value),
            "threshold": _r(self.threshold),
            "pending_since": _r(self.pending_since),
            "fired_at": _r(self.fired_at),
            "resolved_at": _r(self.resolved_at),
            "annotations": self.annotations,
        }


@dataclass
class _Signal:
    """One evaluated (rule, series) condition for this tick."""

    rule: object
    labels: dict
    breach: bool
    value: float
    threshold: float
    hold: Optional[bool] = None  # breach under the resolve threshold
    annotations: dict = field(default_factory=dict)


class AlertManager:
    """Evaluates a rule set against registry/fleet state and owns every
    alert's lifecycle, sample history, journal, and emission."""

    def __init__(self, rules=(), *, journal_path: Optional[str] = None,
                 emit_trace: bool = True, emit_metrics: bool = True,
                 history_len: int = 4096):
        self.rules: list = list(rules)
        self.journal_path = (journal_path
                             or os.environ.get("PADDLE_ALERT_JOURNAL"))
        self.emit_trace = emit_trace
        self.emit_metrics = emit_metrics
        self.events: List[dict] = []  # bounded transition log
        self._history_len = int(history_len)
        self._states: Dict[Tuple[str, Tuple], _Status] = {}
        self._hist: Dict[Tuple[str, Tuple], deque] = {}
        self._known_sources: set = set()
        self._last_now = -math.inf
        self._last_eval_mono = -math.inf

    def add_rule(self, rule) -> "AlertManager":
        self.rules.append(rule)
        return self

    # -- evaluation ------------------------------------------------------

    def evaluate(self, *, registry: Optional[MetricsRegistry] = None,
                 now: Optional[float] = None,
                 ages: Optional[Dict[str, float]] = None) -> List[dict]:
        """One evaluation tick. ``now`` defaults to wall time; explicit
        values are clamped monotonic so test clocks and wall clocks can
        interleave. ``ages`` (source -> seconds since last publication)
        feeds the absence rules; without it they are skipped, not
        cleared. Returns the non-inactive alerts."""
        reg = registry if registry is not None else _metrics.registry()
        if now is None:
            now = time.time()
        now = max(float(now), self._last_now)
        self._last_now = now
        self._last_eval_mono = time.monotonic()
        signals: List[_Signal] = []
        for rule in self.rules:
            if isinstance(rule, AbsenceRule):
                if ages is not None:
                    signals.extend(self._absence_signals(rule, ages, now))
            elif isinstance(rule, BurnRateRule):
                signals.extend(self._burn_signals(rule, reg, now))
            else:
                signals.extend(self._threshold_signals(rule, reg, now))
        seen = set()
        for sig in signals:
            key = (sig.rule.name,
                   tuple(sorted(sig.labels.items())))
            seen.add(key)
            st = self._states.get(key)
            if st is None:
                st = self._states[key] = _Status(sig.rule, sig.labels)
            st.value = sig.value
            st.threshold = sig.threshold
            st.annotations = sig.annotations
            self._step(st, sig, now)
        # a series that vanished (registry reset, tenant gone) clears —
        # but an absence status on a tick with no ages was SKIPPED, not
        # graded clear: a registry-only tick must not resolve it
        for key, st in self._states.items():
            if key in seen or st.state in ("inactive", "resolved"):
                continue
            if ages is None and isinstance(st.rule, AbsenceRule):
                continue
            gone = _Signal(st.rule, st.labels, breach=False,
                           value=st.value or 0.0,
                           threshold=st.threshold or 0.0)
            self._step(st, gone, now)
        return self.active()

    def evaluate_fleet(self, store, *, prefix: str = "obs",
                       now: Optional[float] = None) -> List[dict]:
        """Evaluate over the MERGED fleet registry plus per-source
        publication ages — threshold and burn rules see fleet-wide
        series, absence rules see who went quiet."""
        from . import agg as _agg

        states = _agg.collect(store, prefix=prefix)
        reg = _agg.merge_states(states)
        wall = time.time()
        ages = {}
        for sid, st in states.items():
            pub = st.get("published_unix")
            ages[sid] = (math.inf if pub is None
                         else max(0.0, wall - float(pub)))
        return self.evaluate(registry=reg, now=now, ages=ages)

    def maybe_evaluate(self, *, min_interval_s: float = 0.25) -> None:
        """Rate-limited tick for hot paths (health() calls, serve
        loops): evaluates at most every ``min_interval_s``."""
        if time.monotonic() - self._last_eval_mono < min_interval_s:
            return
        self.evaluate()

    # -- signal builders -------------------------------------------------

    def _samples(self, key: Tuple[str, Tuple]) -> deque:
        d = self._hist.get(key)
        if d is None:
            d = self._hist[key] = deque(maxlen=self._history_len)
        return d

    @staticmethod
    def _windowed(samples, now: float, window_s: float):
        """The newest sample at least ``window_s`` old (fall back to
        the oldest) — the reference point for windowed deltas."""
        ref = None
        for s in samples:  # oldest -> newest
            if s[0] <= now - window_s:
                ref = s
            else:
                break
        return ref if ref is not None else (samples[0] if samples
                                            else None)

    def _threshold_signals(self, rule: ThresholdRule,
                           reg: MetricsRegistry,
                           now: float) -> List[_Signal]:
        out: List[_Signal] = []

        def sig(labels: dict, value: Optional[float],
                ann: Optional[dict] = None):
            if value is None:
                return
            breach = _cmp(value, rule.op, rule.threshold)
            hold = (breach if rule.resolve_threshold is None
                    else _cmp(value, rule.op, rule.resolve_threshold))
            out.append(_Signal(rule, labels, breach, float(value),
                               float(rule.threshold), hold=hold,
                               annotations=ann or {}))

        if rule.stat == "total":
            m = reg._metrics.get(rule.metric)
            if m is not None:
                sig({"metric": rule.metric}, reg.total(rule.metric))
        elif rule.stat == "rate":
            m = reg._metrics.get(rule.metric)
            if m is None:
                return out
            key = (rule.name, (("metric", rule.metric),))
            samples = self._samples(key)
            total = reg.total(rule.metric)
            samples.append((now, total))
            ref = self._windowed(samples, now, rule.window_s)
            dt = now - ref[0] if ref else 0.0
            rate = (total - ref[1]) / dt if ref and dt > 0 else 0.0
            sig({"metric": rule.metric}, rate,
                {"window_s": rule.window_s, "total": total})
        else:
            m = reg._metrics.get(rule.metric)
            if m is None:
                return out
            want = (None if rule.labels is None
                    else _metrics.labels_of(rule.labels))
            for labels, h in sorted(m.series.items()):
                if want is not None and labels != want:
                    continue
                lab = dict(labels)
                if lab.get("obs_overflow") == "true":
                    continue
                lab["metric"] = rule.metric
                if isinstance(h, Histogram):
                    v = (h.count if rule.stat == "count"
                         else h.percentile(float(rule.stat[1:])))
                else:
                    v = h.value
                if isinstance(v, (int, float)):
                    sig(lab, float(v))
        return out

    def _absence_signals(self, rule: AbsenceRule,
                         ages: Dict[str, float],
                         now: float) -> List[_Signal]:
        self._known_sources.update(ages)
        targets = ([rule.source] if rule.source
                   else sorted(self._known_sources))
        out = []
        for sid in targets:
            age = ages.get(sid)
            if age is None:
                if sid in self._known_sources:
                    age = math.inf  # vanished from the store entirely
                else:
                    continue  # explicit source never seen yet
            breach = age > rule.max_age_s
            out.append(_Signal(
                rule, {"source": sid}, breach,
                value=(age if math.isfinite(age) else -1.0),
                threshold=float(rule.max_age_s),
                annotations=({"vanished": True}
                             if not math.isfinite(age) else {})))
        return out

    def _burn_signals(self, rule: BurnRateRule, reg: MetricsRegistry,
                      now: float) -> List[_Signal]:
        m = reg._metrics.get(rule.metric)
        if m is None:
            return []
        per_tenant: Dict[str, Histogram] = {}
        for labels, h in m.series.items():
            lab = dict(labels)
            if lab.get("obs_overflow") == "true":
                continue
            t = lab.get("tenant", "default")
            if rule.tenant is not None and t != rule.tenant:
                continue
            per_tenant.setdefault(t, Histogram()).merge(h)
        out: List[_Signal] = []
        for tenant in sorted(per_tenant):
            target = rule.target_for(tenant)
            if target is None:
                continue
            h = per_tenant[tenant]
            bad = h.count_over(target)
            total = h.count
            key = (rule.name, (("metric", rule.metric),
                               ("tenant", tenant)))
            samples = self._samples(key)
            samples.append((now, bad, total))
            burns: Dict[str, float] = {}
            ratios: List[float] = []
            for window_s, factor in rule.windows:
                ref = self._windowed(samples, now, window_s)
                dbad = bad - ref[1] if ref else 0
                dtotal = total - ref[2] if ref else 0
                b = burn_rate(dbad, dtotal, rule.objective)
                burns[f"{window_s:g}s"] = round(b, 6)
                ratios.append((b / factor) if factor > 0
                              else (math.inf if b > 0 else 0.0))
            # the binding window: breach iff the WEAKEST window breaches
            value = min(ratios) if ratios else 0.0
            breach = value >= 1.0
            out.append(_Signal(
                rule, {"metric": rule.metric, "tenant": tenant},
                breach, value=value, threshold=1.0,
                annotations={
                    "objective": rule.objective,
                    "target_s": target,
                    "burn": burns,
                    "bad_total": bad,
                    "observed_total": total,
                    "budget_remaining_frac": round(
                        budget_remaining_frac(bad, total,
                                              rule.objective), 6),
                }))
        return out

    # -- the state machine ----------------------------------------------

    def _step(self, st: _Status, sig: _Signal, now: float) -> None:
        breach = sig.breach
        hold = sig.hold if sig.hold is not None else breach
        if st.state in ("inactive", "resolved") and breach:
            st.state = "pending"
            st.pending_since = now
            st.clear_since = None
        if st.state == "pending":
            if not hold:
                # flap during the hold window: back to inactive, NO
                # event — this is the flap-proofing
                st.state = "inactive"
                st.pending_since = None
                return
            if now - st.pending_since >= st.rule.for_s:
                st.state = "firing"
                st.fired_at = now
                st.resolved_at = None
                self._emit("firing", st, now)
        if st.state == "firing":
            if hold:
                st.clear_since = None
                return
            if st.clear_since is None:
                st.clear_since = now
            if now - st.clear_since >= st.rule.resolve_for_s:
                st.state = "resolved"
                st.resolved_at = now
                st.pending_since = None
                st.clear_since = None
                self._emit("resolved", st, now)

    def _emit(self, event: str, st: _Status, now: float) -> None:
        rec = {
            "schema": ALERT_SCHEMA,
            "t": round(now, 6),
            "event": event,
            "rule": st.rule.name,
            "severity": st.rule.severity,
            "labels": dict(sorted(st.labels.items())),
            "value": None if st.value is None else round(st.value, 6),
            "threshold": (None if st.threshold is None
                          else round(st.threshold, 6)),
        }
        self.events.append(rec)
        if len(self.events) > 1024:
            del self.events[:len(self.events) - 1024]
        if self.journal_path:
            try:
                with open(self.journal_path, "a",
                          encoding="utf-8") as fh:
                    fh.write(json.dumps(rec, sort_keys=True) + "\n")
            except OSError:
                pass
        if self.emit_trace:
            _trace.instant(f"alert_{event}", tid="alerts",
                           rule=st.rule.name,
                           severity=st.rule.severity,
                           labels=dict(sorted(st.labels.items())),
                           value=rec["value"])
        if self.emit_metrics:
            name = ("obs_alerts_fired_total" if event == "firing"
                    else "obs_alerts_resolved_total")
            _metrics.registry().counter(
                name, {"rule": st.rule.name,
                       "severity": st.rule.severity}).inc()

    # -- views -----------------------------------------------------------

    def statuses(self) -> List[dict]:
        return [self._states[k].to_dict()
                for k in sorted(self._states)]

    def active(self) -> List[dict]:
        """Every non-inactive alert (pending / firing / resolved —
        resolved stays visible until its next breach)."""
        return [d for d in self.statuses() if d["state"] != "inactive"]

    def firing(self) -> List[dict]:
        return [d for d in self.statuses() if d["state"] == "firing"]

    def summary(self, *, max_active: int = 8) -> dict:
        """The compact dict the health() envelopes embed."""
        counts = {"pending": 0, "firing": 0, "resolved": 0}
        active = []
        for d in self.statuses():
            if d["state"] in counts:
                counts[d["state"]] += 1
            if d["state"] in ("pending", "firing"):
                active.append({"rule": d["rule"], "state": d["state"],
                               "severity": d["severity"],
                               "labels": d["labels"],
                               "value": d["value"]})
        active.sort(key=lambda a: (a["state"] != "firing", a["rule"],
                                   sorted(a["labels"].items())))
        return {"rules": len(self.rules), **counts,
                "active": active[:max_active]}


# ---------------------------------------------------------------------------
# the process-default manager (what health() envelopes report)

_DEFAULT: Optional[AlertManager] = None

_EMPTY_SUMMARY = {"rules": 0, "pending": 0, "firing": 0,
                  "resolved": 0, "active": []}


def default_manager() -> AlertManager:
    """The process-wide manager; created empty on first use. Serve
    loops add their stock rules to it and tick it; every health()
    envelope embeds its summary."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = AlertManager()
    return _DEFAULT


def set_default_manager(m: Optional[AlertManager]) -> \
        Optional[AlertManager]:
    """Swap the process-default manager (tests); returns the old one."""
    global _DEFAULT
    old, _DEFAULT = _DEFAULT, m
    return old


def health_summary() -> dict:
    """What ``health_envelope`` embeds: a cheap static dict when no
    manager/rules exist; otherwise a rate-limited evaluation tick plus
    the compact summary."""
    m = _DEFAULT
    if m is None:
        return dict(_EMPTY_SUMMARY)
    if m.rules:
        m.maybe_evaluate()
    return m.summary()
