"""Fleet aggregation over any KVStore (counterpart of
``paddle_tpu/obs/agg.py``, copied over the port's ``obs.metrics`` and
``obs.trace``; the published states and the ``schema`` name are the
reference's, so either package's aggregator reads the other's sources).

Each process is observable alone: a metrics registry, a trace ring, SLO
histograms. This module makes the FLEET observable: each
replica/worker periodically publishes a CRC-framed, full-fidelity
registry dump (histogram buckets included — ``snapshot()`` collapses
them, ``dump_state()`` keeps them) and its trace-ring dump under
``obs/<source>/`` in whatever store the deployment already shares
(Mem/File/TCP); an aggregator — the ``fleet_summary()`` API or
the reference's ``obs agg`` CLI — merges them into one fleet snapshot
and one stitched trace.

Merge semantics, per metric name:

- **counters** — summed across sources for identical label sets (two
  workers both label their engine ``eng0``; the fleet total is the sum,
  which is the number that means anything fleet-wide).
- **gauges** — last-write-wins scalars cannot be summed meaningfully,
  so each source's series keeps its value under an added
  ``obs_source=<id>`` label.
- **histograms** — bucket-merged (counts add, min/max widen): the
  merged percentiles are exactly the union stream's percentiles within
  bucket resolution, because the buckets are identical log buckets in
  every process.

Overflow handles (past the registry cardinality cap) are merged into
one ``obs_overflow="true"`` series per metric so nothing is silently
dropped. The merged result is materialized into a fresh
:class:`~.metrics.MetricsRegistry`, so every existing
reader (``snapshot()``, ``expose_text()``, ``total()``)
works on the fleet view unchanged.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

from . import metrics as _metrics
from . import trace as _trace
from .metrics import Histogram, MetricsRegistry

__all__ = [
    "publish",
    "Publisher",
    "sources",
    "collect",
    "merge_states",
    "fleet_snapshot",
    "fleet_summary",
    "fleet_trace",
]

_PREFIX = "obs"


def _metrics_key(prefix: str, source_id: str) -> str:
    return f"{prefix}/{source_id}/metrics"


def _trace_key(prefix: str, source_id: str) -> str:
    return f"{prefix}/{source_id}/trace"


def publish(store, source_id: str, *, prefix: str = _PREFIX,
            registry: Optional[MetricsRegistry] = None,
            ring=None) -> None:
    """Publish this process's registry dump and trace-ring dump under
    ``<prefix>/<source_id>/`` — CRC-framed (``put_bytes``), so a torn
    or bit-flipped blob surfaces as :class:`CorruptBlobError` at the
    aggregator instead of a silently wrong fleet number."""
    reg = registry if registry is not None else _metrics.registry()
    rg = ring if ring is not None else _trace.ring()
    state = reg.dump_state()
    state["source"] = str(source_id)
    state["published_unix"] = time.time()
    store.put_bytes(_metrics_key(prefix, source_id),
                    json.dumps(state, sort_keys=True).encode("utf-8"))
    store.put_bytes(_trace_key(prefix, source_id),
                    json.dumps(rg.dump()).encode("utf-8"))


class Publisher:
    """Periodic publication wrapper for serve loops: call
    ``maybe_publish()`` as often as you like — it republishes at most
    every ``interval_s`` (publication walks the whole registry, so it
    must not ride a 50 Hz poll loop at full rate), and ``publish()``
    forces a final flush at exit."""

    def __init__(self, store, source_id: str, *, prefix: str = _PREFIX,
                 interval_s: float = 0.5):
        self.store = store
        self.source_id = str(source_id)
        self.prefix = prefix
        self.interval_s = float(interval_s)
        self._last = 0.0

    def maybe_publish(self) -> bool:
        now = time.monotonic()
        if now - self._last < self.interval_s:
            return False
        self.publish()
        return True

    def publish(self) -> None:
        self._last = time.monotonic()
        publish(self.store, self.source_id, prefix=self.prefix)


def sources(store, *, prefix: str = _PREFIX) -> List[str]:
    """Source ids that have published a metrics dump, sorted."""
    lead = prefix + "/"
    out = set()
    for key in store.keys(lead):
        rest = key[len(lead):]
        if rest.endswith("/metrics"):
            out.add(rest[:-len("/metrics")])
    return sorted(out)


def collect(store, *, prefix: str = _PREFIX) -> Dict[str, dict]:
    """source_id -> its published ``dump_state()`` dict. A source whose
    blob is missing (raced with its first publish) is skipped; a
    CORRUPT blob raises — a wrong fleet total is worse than no total."""
    out: Dict[str, dict] = {}
    for sid in sources(store, prefix=prefix):
        raw = store.get_bytes(_metrics_key(prefix, sid))
        if raw is None:
            continue
        out[sid] = json.loads(raw.decode("utf-8"))
    return out


def merge_states(states: Dict[str, dict]) -> MetricsRegistry:
    """Merge per-source ``dump_state()`` dicts into a fresh registry:
    counters summed, gauges kept per-source (``obs_source`` label),
    histograms bucket-merged; overflow folded into one
    ``obs_overflow="true"`` series per metric."""
    reg = MetricsRegistry()
    for sid in sorted(states):
        st = states[sid]
        for name, m in sorted(st.get("metrics", {}).items()):
            kind, help_ = m["kind"], m.get("help", "")
            series: List[Tuple[dict, object]] = [
                (s["labels"], s["state"]) for s in m.get("series", ())]
            for ov in m.get("overflow", ()):
                series.append(({"obs_overflow": "true"}, ov))
            for labels, state in series:
                if kind == "counter":
                    h = reg.counter(name, labels, help=help_)
                    h.inc(float(state or 0.0))
                elif kind == "gauge":
                    lab = (labels if "obs_overflow" in labels
                           else {**labels, "obs_source": sid})
                    reg.gauge(name, lab, help=help_).set(state)
                else:
                    h = reg.histogram(name, labels, help=help_)
                    h.merge_state(state)
    return reg


def fleet_snapshot(store, *, prefix: str = _PREFIX) -> dict:
    """One merged fleet snapshot (the normal ``snapshot()`` schema, so
    the dump CLI and every snapshot reader render it unchanged) plus
    the contributing ``sources`` list."""
    states = collect(store, prefix=prefix)
    snap = merge_states(states).snapshot()
    snap["sources"] = sorted(states)
    return snap


def fleet_summary(store, *, prefix: str = _PREFIX) -> dict:
    """The fleet-wide SLO/health digest: counter totals summed across
    processes plus the merged SLO histograms, overall and per tenant."""
    from . import SLO_HISTOGRAMS  # package __init__ imports this module's
    # sibling; importing lazily keeps the module graph acyclic
    states = collect(store, prefix=prefix)
    reg = merge_states(states)
    totals = {}
    for name in reg.names():
        m = reg._metrics[name]
        if m.kind == "counter":
            totals[name] = reg.total(name)
    slo: Dict[str, dict] = {}
    tenants: Dict[str, Dict[str, Histogram]] = {}
    for name in SLO_HISTOGRAMS:
        agg = Histogram()
        m = reg._metrics.get(name)
        if m is not None:
            for labels, h in m.series.items():
                agg.merge(h)
                t = dict(labels).get("tenant", "default")
                tenants.setdefault(t, {}).setdefault(
                    name, Histogram()).merge(h)
        slo[name] = agg.to_dict()
    return {
        "schema": "paddle_tpu.obs.agg/1",
        "sources": sorted(states),
        "totals": totals,
        "slo": slo,
        "tenants": {
            t: {name: h.to_dict() for name, h in sorted(per.items())}
            for t, per in sorted(tenants.items())
        },
    }


def fleet_trace(store, *, prefix: str = _PREFIX,
                trace_id: Optional[str] = None,
                extra_dumps: Optional[List[list]] = None) -> list:
    """Stitch every published trace-ring dump (plus any local
    ``extra_dumps``, e.g. the driver's own ring) into one Chrome-trace
    event list, optionally filtered to one ``trace_id``."""
    dumps: List[list] = list(extra_dumps or [])
    for sid in sources(store, prefix=prefix):
        raw = store.get_bytes(_trace_key(prefix, sid))
        if raw is None:
            continue
        dumps.append(json.loads(raw.decode("utf-8")))
    return _trace.stitch_traces(dumps, trace_id=trace_id)
