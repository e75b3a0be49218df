"""Counterpart of ``paddle_tpu/obs/metrics.py``, copied.

Process-global metrics registry: counters, gauges, log-bucketed
histograms.

Every runtime stats surface in the repo (``EngineLoad``,
``prefix_stats()``, ``spec_stats()``, ``overlap_stats()``, the
``health()`` envelopes, ``TrainTelemetry`` step times) reads through
here: the legacy call signatures keep returning their historical keys,
but the numbers underneath live in ONE registry the benches, the dump
CLI, and the future autoscaler all see. Design constraints, in order:

- **Cheap hot path.** A counter increment is one attribute add on a
  handle the caller fetched once at construction time — no dict lookup,
  no lock (CPython attribute stores are atomic enough for statistics;
  we never read-modify-write across threads with invariants at stake).
  Histogram observe is one ``log2`` + a dict bump.
- **Labels are frozen tuples.** A series is keyed by
  ``(("engine", "eng3"), ("priority", "batch"))`` — sorted, hashable,
  no string formatting on the hot path.
- **Bounded cardinality, unbounded correctness.** Each metric admits at
  most ``max_series`` label sets into the EXPORTED set; later label
  sets still get fully functional private handles (so a caller's own
  reads — the parity contract — never degrade), but exports aggregate
  them into one ``obs_overflow="true"`` series instead of growing
  without bound.
- **Deterministic snapshots.** ``snapshot()`` sorts metrics and series,
  so two calls over the same state serialize identically — JSONL diffs
  and test pins stay stable.

Exports: ``snapshot()`` (plain dict), ``snapshot_jsonl(path)``
(append-one-line durable log), ``expose_text()`` (Prometheus text
exposition, histogram buckets included), and the
``python -m paddle_tpu_torch.obs dump`` CLI over any of them. The schema
names keep the reference's ``paddle_tpu.obs.metrics`` strings, so both
packages' snapshots compare equal.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricAttr",
    "MetricsRegistry",
    "registry",
    "labels_of",
]

LabelPairs = Tuple[Tuple[str, str], ...]

# log-bucketed histogram resolution: 4 buckets per octave (factor
# 2**(1/4) ≈ 1.19 between bounds) — ≤ ~9% relative error at the
# geometric bucket midpoint, fine for latency percentiles
_BUCKETS_PER_OCTAVE = 4


def labels_of(labels) -> LabelPairs:
    """Normalize a labels argument (dict / iterable of pairs / None)
    into the canonical sorted tuple-of-pairs form."""
    if not labels:
        return ()
    if isinstance(labels, dict):
        items: Iterable = labels.items()
    else:
        items = labels
    return tuple(sorted((str(k), str(v)) for k, v in items))


class Counter:
    """Monotonic counter handle for ONE label set. ``inc`` is the hot
    path; fetch the handle once, not per event."""

    __slots__ = ("_v",)

    def __init__(self):
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        self._v += n

    @property
    def value(self) -> float:
        return self._v

    def set_(self, v: float) -> None:
        """Test/restore seam (journal replay, engine rebuild): counters
        are monotonic for callers, but a crash-recovery path may need
        to re-seed a rebuilt engine's view."""
        self._v = float(v)


class Gauge:
    """Last-write-wins scalar. ``None`` is a legal value (EWMAs start
    unset); ``None`` series are skipped by the Prometheus exposition
    but preserved in JSON snapshots."""

    __slots__ = ("_v",)

    def __init__(self):
        self._v = None

    def set(self, v) -> None:
        self._v = v

    def inc(self, n: float = 1.0) -> None:
        self._v = (self._v or 0.0) + n

    @property
    def value(self):
        return self._v


class Histogram:
    """Log-bucketed histogram handle: O(1) observe, percentile read by
    bucket walk. Bucket ``i`` spans ``(2**((i-1)/4), 2**(i/4)]``;
    non-positive observations land in a dedicated zero bucket."""

    __slots__ = ("_counts", "_zero", "_n", "_sum", "_min", "_max")

    def __init__(self):
        self._counts: Dict[int, int] = {}
        self._zero = 0
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self._n += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if v <= 0.0:
            self._zero += 1
            return
        i = math.ceil(_BUCKETS_PER_OCTAVE * math.log2(v))
        self._counts[i] = self._counts.get(i, 0) + 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, p: float) -> Optional[float]:
        """Approximate p-th percentile (p in [0, 100]); None when
        empty. Error bounded by the bucket width (~±9%)."""
        if self._n == 0:
            return None
        rank = max(1, math.ceil(self._n * p / 100.0))
        seen = self._zero
        if rank <= seen:
            return 0.0
        for i in sorted(self._counts):
            seen += self._counts[i]
            if rank <= seen:
                # geometric midpoint of the bucket, clamped into the
                # observed range so tail percentiles never exceed max
                mid = 2.0 ** ((i - 0.5) / _BUCKETS_PER_OCTAVE)
                return min(max(mid, self._min), self._max)
        return self._max

    @property
    def p50(self) -> Optional[float]:
        return self.percentile(50)

    @property
    def p95(self) -> Optional[float]:
        return self.percentile(95)

    @property
    def p99(self) -> Optional[float]:
        return self.percentile(99)

    def count_over(self, threshold: float) -> int:
        """Observations strictly above ``threshold``, counted from
        buckets that lie WHOLLY above it — the straddling bucket is
        excluded, so the result under-counts by at most that one
        bucket's population (~9% band). When ``threshold`` is an exact
        bucket bound (``2**(k/4)``), the count is exact: the alert
        engine's burn-rate rules read SLO violations through this."""
        t = float(threshold)
        if t < 0.0:
            return self._n
        if t == 0.0:
            return self._n - self._zero
        j = _BUCKETS_PER_OCTAVE * math.log2(t)
        # bucket i spans (2**((i-1)/4), 2**(i/4)]: wholly above t iff
        # its lower bound >= t, i.e. i >= j + 1 (epsilon absorbs the
        # log2 round-trip on exact bounds)
        i_min = math.ceil(j - 1e-9) + 1
        return sum(c for i, c in self._counts.items() if i >= i_min)

    def bounds_counts(self) -> List[Tuple[float, int]]:
        """(upper_bound, count) per non-empty bucket, ascending — the
        Prometheus ``le`` exposition reads this."""
        out: List[Tuple[float, int]] = []
        if self._zero:
            out.append((0.0, self._zero))
        for i in sorted(self._counts):
            out.append((2.0 ** (i / _BUCKETS_PER_OCTAVE),
                        self._counts[i]))
        return out

    def to_dict(self) -> dict:
        return {
            "count": self._n,
            "sum": self._sum,
            "min": None if self._n == 0 else self._min,
            "max": None if self._n == 0 else self._max,
            "p50": self.p50,
            "p95": self.p95,
            "p99": self.p99,
        }

    # -- full-fidelity state (fleet aggregation) ------------------------
    # ``to_dict`` is the human/summary view and DROPS the buckets; the
    # aggregator needs them back, so cross-process publication rides
    # ``state_dict``/``merge_state`` instead.

    def state_dict(self) -> dict:
        """JSON-safe full state: buckets included, so a remote copy can
        be bucket-merged losslessly (unlike ``to_dict``)."""
        return {
            "counts": {str(i): c for i, c in sorted(self._counts.items())},
            "zero": self._zero,
            "n": self._n,
            "sum": self._sum,
            "min": None if self._n == 0 else self._min,
            "max": None if self._n == 0 else self._max,
        }

    def merge_state(self, state: dict) -> None:
        """Bucket-merge a ``state_dict`` into this histogram: counts
        add, min/max widen — the union stream's histogram, exactly."""
        for i, c in state.get("counts", {}).items():
            i = int(i)
            self._counts[i] = self._counts.get(i, 0) + int(c)
        self._zero += int(state.get("zero", 0))
        self._n += int(state.get("n", 0))
        self._sum += float(state.get("sum", 0.0))
        lo, hi = state.get("min"), state.get("max")
        if lo is not None and lo < self._min:
            self._min = float(lo)
        if hi is not None and hi > self._max:
            self._max = float(hi)

    def merge(self, other: "Histogram") -> None:
        self.merge_state(other.state_dict())

    @classmethod
    def from_state(cls, state: dict) -> "Histogram":
        h = cls()
        h.merge_state(state)
        return h


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Metric:
    """One named metric: kind + help + its admitted series, plus the
    overflow handles past the cardinality cap."""

    def __init__(self, name: str, kind: str, help_: str,
                 max_series: int):
        self.name = name
        self.kind = kind
        self.help = help_
        self.max_series = max_series
        self.series: Dict[LabelPairs, object] = {}
        self.overflow: List[object] = []

    def get(self, labels: LabelPairs, lock: threading.Lock):
        h = self.series.get(labels)
        if h is not None:
            return h
        with lock:
            h = self.series.get(labels)
            if h is not None:
                return h
            h = _KINDS[self.kind]()
            if len(self.series) < self.max_series:
                self.series[labels] = h
            else:
                # past the cap: the CALLER still gets a fully live
                # handle (its own reads stay exact); only the exported
                # series set stops growing
                self.overflow.append(h)
        return h


class MetricsRegistry:
    """The process-global metric store. ``counter()``/``gauge()``/
    ``histogram()`` return per-label-set handles; snapshot/exposition
    walk every admitted series deterministically."""

    def __init__(self, *, max_series: int = 512):
        self.max_series = int(max_series)
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    # -- handle acquisition (construction-time, not hot path) -----------
    def _get(self, name: str, kind: str, labels, help_: str,
             max_series: Optional[int]):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = _Metric(name, kind, help_,
                                max_series or self.max_series)
                    self._metrics[name] = m
        if m.kind != kind:
            raise ValueError(
                f"metric {name!r} is a {m.kind}, not a {kind}")
        return m.get(labels_of(labels), self._lock)

    def counter(self, name: str, labels=None, *, help: str = "",
                max_series: Optional[int] = None) -> Counter:
        return self._get(name, "counter", labels, help, max_series)

    def gauge(self, name: str, labels=None, *, help: str = "",
              max_series: Optional[int] = None) -> Gauge:
        return self._get(name, "gauge", labels, help, max_series)

    def histogram(self, name: str, labels=None, *, help: str = "",
                  max_series: Optional[int] = None) -> Histogram:
        return self._get(name, "histogram", labels, help, max_series)

    # -- introspection ---------------------------------------------------
    def names(self) -> List[str]:
        return sorted(self._metrics)

    def series_count(self, name: str) -> int:
        m = self._metrics.get(name)
        return 0 if m is None else len(m.series)

    def value(self, name: str, labels=None):
        """Read one series' value (counter/gauge scalar, histogram
        dict); None when the metric or series does not exist."""
        m = self._metrics.get(name)
        if m is None:
            return None
        h = m.series.get(labels_of(labels))
        if h is None:
            return None
        if isinstance(h, Histogram):
            return h.to_dict()
        return h.value

    def total(self, name: str) -> float:
        """Sum of a counter/gauge metric across every series (overflow
        handles included) — the health() envelopes read these."""
        m = self._metrics.get(name)
        if m is None:
            return 0.0
        out = 0.0
        for h in list(m.series.values()) + list(m.overflow):
            v = getattr(h, "value", None)
            if isinstance(v, (int, float)):
                out += v
        return out

    # -- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Deterministic plain-dict snapshot of every admitted series
        (overflow aggregated into one marked series per metric)."""
        out: Dict[str, dict] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            series = []
            for labels in sorted(m.series):
                h = m.series[labels]
                v = h.to_dict() if isinstance(h, Histogram) else h.value
                series.append({"labels": dict(labels), "value": v})
            if m.overflow:
                agg = sum(h.value for h in m.overflow
                          if isinstance(getattr(h, "value", None),
                                        (int, float)))
                series.append({"labels": {"obs_overflow": "true"},
                               "value": agg,
                               "dropped_series": len(m.overflow)})
            out[name] = {"kind": m.kind, "help": m.help,
                         "series": series}
        return {"schema": "paddle_tpu.obs.metrics/1", "metrics": out}

    def dump_state(self) -> dict:
        """Full-fidelity export for cross-process aggregation: unlike
        ``snapshot()`` (whose histograms collapse to summary stats),
        this keeps every histogram's buckets and the raw overflow
        handles, so a remote aggregator can bucket-merge losslessly.
        Schema ``paddle_tpu.obs.metrics/state1``."""
        def _state(h):
            return (h.state_dict() if isinstance(h, Histogram)
                    else h.value)

        out: Dict[str, dict] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            series = [{"labels": dict(labels),
                       "state": _state(m.series[labels])}
                      for labels in sorted(m.series)]
            out[name] = {"kind": m.kind, "help": m.help,
                         "series": series,
                         "overflow": [_state(h) for h in m.overflow]}
        return {"schema": "paddle_tpu.obs.metrics/state1", "metrics": out}

    def snapshot_jsonl(self, path: str) -> dict:
        """Append one JSON line (the snapshot) to ``path``; returns the
        snapshot. The dump CLI renders these files."""
        snap = self.snapshot()
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(snap, sort_keys=True) + "\n")
        return snap

    def expose_text(self) -> str:
        """Prometheus text exposition (counters/gauges as samples,
        histograms as cumulative ``_bucket``/``_sum``/``_count``)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for labels in sorted(m.series):
                h = m.series[labels]
                if isinstance(h, Histogram):
                    cum = 0
                    for bound, cnt in h.bounds_counts():
                        cum += cnt
                        lab = _prom_labels(labels + (("le", repr(bound)),))
                        lines.append(f"{name}_bucket{lab} {cum}")
                    lab = _prom_labels(labels + (("le", "+Inf"),))
                    lines.append(f"{name}_bucket{lab} {h.count}")
                    lines.append(
                        f"{name}_sum{_prom_labels(labels)} {h.sum}")
                    lines.append(
                        f"{name}_count{_prom_labels(labels)} {h.count}")
                    continue
                v = h.value
                if v is None:
                    continue
                lines.append(f"{name}{_prom_labels(labels)} {v}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every metric — test isolation only."""
        with self._lock:
            self._metrics.clear()


def _prom_labels(labels: LabelPairs) -> str:
    if not labels:
        return ""
    body = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in labels)
    return "{" + body + "}"


class MetricAttr:
    """Class-level descriptor: a registry-backed instance attribute.

    The legacy stats surfaces are plain counters mutated in place
    (``self.steps += 1``) and occasionally written from OUTSIDE the
    owning object (the overload bench resets ``eng.ewma_step_s = None``)
    — a data descriptor keeps every such site byte-identical while the
    number itself lives in a registry series labeled by the instance's
    ``_obs_labels`` dict (which must exist before the first access).
    ``kind`` is "counter" (optionally ``as_int`` for surfaces that
    always held ints) or "gauge" (``None`` is a legal value)."""

    __slots__ = ("_metric", "_kind", "_as_int", "_help", "_slot")

    def __init__(self, metric: str, *, kind: str = "counter",
                 as_int: bool = False, help: str = ""):
        if kind not in ("counter", "gauge"):
            raise ValueError(f"MetricAttr kind must be counter|gauge, "
                             f"got {kind!r}")
        self._metric = metric
        self._kind = kind
        self._as_int = as_int
        self._help = help
        self._slot = f"_obsh_{metric}"

    def __set_name__(self, owner, name):  # the attr name is cosmetic
        pass

    def _bind(self, obj):
        reg = _REGISTRY
        labels = getattr(obj, "_obs_labels", None)
        get = reg.counter if self._kind == "counter" else reg.gauge
        h = get(self._metric, labels, help=self._help)
        obj.__dict__[self._slot] = h
        return h

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        h = obj.__dict__.get(self._slot)
        if h is None:
            h = self._bind(obj)
        v = h.value
        if self._kind == "counter" and self._as_int:
            return int(v)
        return v

    def __set__(self, obj, v):
        h = obj.__dict__.get(self._slot)
        if h is None:
            h = self._bind(obj)
        if self._kind == "counter":
            h.set_(float(v))
        else:
            h.set(v)


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every stats surface reads through."""
    return _REGISTRY
