"""SLO specification + attainment accounting (counterpart of
``paddle_tpu/obs/slo.py``, copied; the report's ``schema`` name is the
reference's, so both packages serialize equal reports to equal bytes).

The measurement half of an open-loop load harness: given finished
requests — anything
shaped like :class:`~paddle_tpu_torch.inference.serving.GenRequest`
(``tenant``/``priority``/``status``/``t_submit``/``times``/``out``) or
the equivalent plain dict — and an :class:`SLOSpec`, compute per-tenant
percentile tables, attainment fractions, and **goodput-under-SLO**
(tokens from SLO-meeting requests / wall time), the metric the serving
papers this stack follows (Sarathi-Serve, DistServe) grade schedulers
by. Closed-loop tok/s rewards a scheduler that starves the tail;
goodput-under-SLO does not.

A request MEETS its SLO iff its submission was served
(``status == "ok"``) and every configured target holds:

- ``ttft_s``    — time to first token ≤ target
- ``itl_p95_s`` — the request's own p95 inter-token latency ≤ target
  (p95, not max: one GC pause should not void 200 good tokens; not
  mean: a bursty stream that averages well still reads badly)
- ``e2e_s``     — last-token wall time since submission ≤ target

Unset targets don't constrain. Reports are deterministic: percentiles
are nearest-rank over sorted lists (no interpolation ambiguity),
floats round to 6 digits, keys sort — two runs over the same inputs
serialize byte-identically.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

__all__ = [
    "SLOClass",
    "SLOSpec",
    "RequestLatency",
    "attainment_report",
    "report_json",
    "pct",
]


def pct(xs: Sequence[float], p: float) -> Optional[float]:
    """Nearest-rank percentile (deterministic, no interpolation):
    the ceil(n*p/100)-th smallest value. None on empty input."""
    if not xs:
        return None
    xs = sorted(xs)
    rank = max(1, math.ceil(len(xs) * p / 100.0))
    return float(xs[rank - 1])


def _r(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(float(v), 6)


@dataclass(frozen=True)
class SLOClass:
    """One target set. ``None`` fields don't constrain."""

    ttft_s: Optional[float] = None
    itl_p95_s: Optional[float] = None
    e2e_s: Optional[float] = None

    def overlay(self, other: Optional["SLOClass"]) -> "SLOClass":
        """Field-wise override: ``other``'s set fields win."""
        if other is None:
            return self
        return SLOClass(
            ttft_s=other.ttft_s if other.ttft_s is not None else self.ttft_s,
            itl_p95_s=(other.itl_p95_s if other.itl_p95_s is not None
                       else self.itl_p95_s),
            e2e_s=other.e2e_s if other.e2e_s is not None else self.e2e_s,
        )

    def to_dict(self) -> dict:
        return {"ttft_s": _r(self.ttft_s), "itl_p95_s": _r(self.itl_p95_s),
                "e2e_s": _r(self.e2e_s)}


@dataclass
class SLOSpec:
    """Targets resolved per (tenant, priority): start from ``default``,
    overlay the priority class's overrides, then the tenant's — a paying
    tenant's tighter TTFT beats its traffic class's."""

    default: SLOClass = field(default_factory=SLOClass)
    per_priority: Dict[str, SLOClass] = field(default_factory=dict)
    per_tenant: Dict[str, SLOClass] = field(default_factory=dict)

    def resolve(self, tenant: str, priority: str) -> SLOClass:
        out = self.default.overlay(self.per_priority.get(priority))
        return out.overlay(self.per_tenant.get(tenant))

    def to_dict(self) -> dict:
        return {
            "default": self.default.to_dict(),
            "per_priority": {k: v.to_dict()
                             for k, v in sorted(self.per_priority.items())},
            "per_tenant": {k: v.to_dict()
                           for k, v in sorted(self.per_tenant.items())},
        }


@dataclass
class RequestLatency:
    """The per-request facts attainment needs, extracted once from a
    GenRequest-shaped object or dict (``times[i]`` = perf_counter stamp
    of token ``i``; ``t_submit`` same clock)."""

    req_id: object
    tenant: str
    priority: str
    status: str
    tokens: int
    ttft: Optional[float]
    itl_p95: Optional[float]
    e2e: Optional[float]

    @classmethod
    def of(cls, req) -> "RequestLatency":
        get = (req.get if isinstance(req, dict)
               else lambda k, d=None: getattr(req, k, d))
        times = list(get("times") or ())
        t_submit = float(get("t_submit") or 0.0)
        out = get("out") or ()
        itls = [b - a for a, b in zip(times, times[1:])]
        return cls(
            req_id=get("req_id"),
            tenant=str(get("tenant") or "default"),
            priority=str(get("priority") or "interactive"),
            status=str(get("status") or "ok"),
            tokens=len(out),
            ttft=(times[0] - t_submit) if times else None,
            itl_p95=pct(itls, 95),
            e2e=(times[-1] - t_submit) if times else None,
        )

    def meets(self, slo: SLOClass) -> Dict[str, bool]:
        """Per-dimension verdicts plus the conjunction under ``all``.
        A non-ok request fails outright; an unset target passes; a set
        target with no measurement (no tokens) fails."""
        ok = self.status == "ok"

        def dim(target, value):
            if target is None:
                return ok
            return ok and value is not None and value <= target

        v = {
            "ttft": dim(slo.ttft_s, self.ttft),
            "itl": dim(slo.itl_p95_s, self.itl_p95),
            "e2e": dim(slo.e2e_s, self.e2e),
        }
        v["all"] = all(v.values())
        return v


def _table(reqs: List[RequestLatency], spec: SLOSpec,
           wall_s: float) -> dict:
    """One cohort's row: counts, percentile tables, attainment
    fractions, goodput."""
    n = len(reqs)
    statuses: Dict[str, int] = {}
    for r in reqs:
        statuses[r.status] = statuses.get(r.status, 0) + 1
    ttfts = [r.ttft for r in reqs if r.ttft is not None]
    itls = [r.itl_p95 for r in reqs if r.itl_p95 is not None]
    e2es = [r.e2e for r in reqs if r.e2e is not None]
    met = {"ttft": 0, "itl": 0, "e2e": 0, "all": 0}
    tokens_ok = 0
    tokens_total = sum(r.tokens for r in reqs)
    for r in reqs:
        v = r.meets(spec.resolve(r.tenant, r.priority))
        for k in met:
            met[k] += int(v[k])
        if v["all"]:
            tokens_ok += r.tokens
    return {
        "requests": n,
        "statuses": dict(sorted(statuses.items())),
        "tokens": tokens_total,
        "tokens_within_slo": tokens_ok,
        "ttft": {"p50": _r(pct(ttfts, 50)), "p95": _r(pct(ttfts, 95)),
                 "p99": _r(pct(ttfts, 99))},
        # the ITL table is over per-request p95s — the same quantity
        # the attainment verdict uses, so table and fraction agree
        "itl_p95": {"p50": _r(pct(itls, 50)), "p95": _r(pct(itls, 95)),
                    "p99": _r(pct(itls, 99))},
        "e2e": {"p50": _r(pct(e2es, 50)), "p99": _r(pct(e2es, 99))},
        "attainment": {k: _r(met[k] / n) if n else None for k in
                       ("ttft", "itl", "e2e", "all")},
        "goodput_tokens_per_s": _r(tokens_ok / wall_s) if wall_s > 0
        else None,
    }


def attainment_report(requests, spec: SLOSpec, wall_s: float,
                      *, extra: Optional[dict] = None) -> dict:
    """The run report: overall + per-tenant + per-priority attainment
    tables and goodput-under-SLO, schema ``paddle_tpu.obs.slo/1``.
    ``requests`` is any iterable of GenRequest-shaped objects/dicts;
    ``wall_s`` is the measured driving-loop wall time."""
    lats = [RequestLatency.of(r) for r in requests]
    by_tenant: Dict[str, List[RequestLatency]] = {}
    by_priority: Dict[str, List[RequestLatency]] = {}
    for r in lats:
        by_tenant.setdefault(r.tenant, []).append(r)
        by_priority.setdefault(r.priority, []).append(r)
    rep = {
        "schema": "paddle_tpu.obs.slo/1",
        "spec": spec.to_dict(),
        "wall_s": _r(wall_s),
        "overall": _table(lats, spec, wall_s),
        "tenants": {t: _table(rs, spec, wall_s)
                    for t, rs in sorted(by_tenant.items())},
        "priorities": {p: _table(rs, spec, wall_s)
                       for p, rs in sorted(by_priority.items())},
    }
    if extra:
        rep["extra"] = extra
    return rep


def report_json(report: dict) -> str:
    """Canonical serialization — sorted keys, no float noise beyond the
    rounding already applied — so equal runs produce equal bytes."""
    return json.dumps(report, sort_keys=True, indent=2)
