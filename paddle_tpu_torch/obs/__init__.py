"""paddle_tpu_torch.obs — observability: metrics and traces (counterpart of
``paddle_tpu/obs``).

- **Metrics** (:mod:`.metrics`): a process-global registry of named
  counters / gauges / log-bucketed histograms with frozen-tuple labels.
  The serving engine's stats surfaces (``load()``, ``prefix_stats()``,
  ``spec_stats()``, ``overlap_stats()``, the shed counts) are views over
  this registry. Built-in SLO histograms: ``serving_ttft_seconds``,
  ``serving_itl_seconds``, ``serving_queue_delay_seconds``, with
  p50/p95/p99 accessors (:func:`slo_summary`).
- **Traces** (:mod:`.trace`): per-request spans (admission, prefill,
  decode, dispatch, harvest) carried on ``GenRequest``, collected in a
  bounded per-process ring, exported as Chrome trace-event JSON.

The engine records spans on the host, around its dispatches and
harvests: a captured CUDA graph records nothing, and turning tracing on
adds no graph and changes no stream.

- **Fleet aggregation** (:mod:`.agg`): each serve loop publishes its
  registry and trace ring into the deployment's KV store; ``collect`` /
  ``fleet_summary`` / ``fleet_trace`` merge them.
- **Health envelope** (:func:`health_envelope`): the shared top-level keys
  every ``health()`` surface (supervisor, routers) carries, the
  process-default alert manager's compact summary among them.
- **Capture events** (:mod:`.compile`): CUDA-graph captures of the
  ``jit.to_static`` programs counted by program name, the port's
  counterpart of the reference's XLA compile events.
- **Reaction** (:mod:`.alerts`, :mod:`.slo`, :mod:`.regress`):
  declarative alert rules (thresholds, publisher absence, multi-window
  SLO burn rates with per-(tenant, priority) error budgets) with a
  deterministic pending -> firing -> resolved lifecycle; SLO attainment
  reports; the schema'd bench ledger and its regression sentinel.

CLI: ``python -m paddle_tpu_torch.obs dump|prom|trace|agg|alerts|top|regress``.
"""
from . import alerts
from .alerts import (
    AbsenceRule,
    AlertManager,
    BurnRateRule,
    ThresholdRule,
    budget_remaining_frac,
    burn_rate,
    burn_rules_from_slo,
    default_manager,
    default_serving_rules,
    default_training_rules,
    set_default_manager,
)
from .compile import (
    compile_events_installed,
    install_compile_events,
    uninstall_compile_events,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricAttr,
    MetricsRegistry,
    labels_of,
    registry,
)
from .regress import (
    bench_record,
    detect_regressions,
    load_ledger,
    polarity_of,
)
from .trace import (
    Span,
    TraceRing,
    enabled,
    export_chrome_trace,
    finish_span,
    instant,
    new_trace_id,
    ring,
    set_enabled,
    set_process_label,
    span,
    start_span,
    stitch_traces,
    trace_ctx,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricAttr", "MetricsRegistry",
    "registry", "labels_of",
    "Span", "TraceRing", "new_trace_id", "span", "start_span",
    "finish_span", "instant", "trace_ctx", "ring", "set_enabled",
    "enabled", "set_process_label", "export_chrome_trace",
    "stitch_traces", "SLO_HISTOGRAMS", "slo_summary", "tenant_slo_table",
    "HEALTH_SCHEMA_VERSION", "HEALTH_COMMON_KEYS", "health_envelope",
    "install_compile_events", "uninstall_compile_events",
    "compile_events_installed",
    "ThresholdRule", "AbsenceRule", "BurnRateRule", "AlertManager",
    "burn_rate", "budget_remaining_frac", "burn_rules_from_slo",
    "default_serving_rules", "default_training_rules",
    "default_manager", "set_default_manager",
    "bench_record", "load_ledger", "detect_regressions", "polarity_of",
]

# SLO histograms the serving engine feeds (seconds)
SLO_HISTOGRAMS = (
    "serving_ttft_seconds",
    "serving_itl_seconds",
    "serving_queue_delay_seconds",
)


def slo_summary(*, by_tenant: bool = False) -> dict:
    """p50/p95/p99 + count for the built-in TTFT / inter-token-latency
    / queue-delay histograms, aggregated over every label set. The SLO
    series carry a ``tenant`` label (default tenant ``"default"``), so
    the label sets PARTITION the observations and the merged totals
    stay exact. ``by_tenant=True`` adds a ``"tenants"`` key: per-tenant
    sub-summaries (same shape per metric), with every past-the-cap
    overflow handle folded into one ``"(overflow)"`` tenant."""
    out = {}
    tenants: dict = {}
    reg = registry()
    for name in SLO_HISTOGRAMS:
        agg = Histogram()
        m = reg._metrics.get(name)
        if m is not None:
            for labels, h in list(m.series.items()):
                agg.merge(h)
                if by_tenant:
                    t = dict(labels).get("tenant", "default")
                    bucket = tenants.setdefault(t, {}).setdefault(
                        name, Histogram())
                    bucket.merge(h)
            for h in list(m.overflow):
                agg.merge(h)
                if by_tenant:
                    bucket = tenants.setdefault("(overflow)", {}).setdefault(
                        name, Histogram())
                    bucket.merge(h)
        out[name] = agg.to_dict()
    if by_tenant:
        out["tenants"] = {
            t: {name: h.to_dict() for name, h in sorted(per.items())}
            for t, per in sorted(tenants.items())
        }
    return out


def tenant_slo_table() -> dict:
    """Compact per-tenant SLO view for the health() surfaces: requests
    submitted (``serving_tenant_requests_total``) plus TTFT/ITL p50 and
    p99 per tenant. Tenants past the registry cardinality cap fold into
    ``"(overflow)"``."""
    full = slo_summary(by_tenant=True)
    reg = registry()
    req_by_tenant: dict = {}
    m = reg._metrics.get("serving_tenant_requests_total")
    if m is not None:
        for labels, h in list(m.series.items()):
            t = dict(labels).get("tenant", "default")
            req_by_tenant[t] = req_by_tenant.get(t, 0) + int(h.value)
        if m.overflow:
            req_by_tenant["(overflow)"] = req_by_tenant.get(
                "(overflow)", 0) + int(sum(h.value for h in m.overflow))
    out = {}
    for t in sorted(set(full.get("tenants", {})) | set(req_by_tenant)):
        per = full.get("tenants", {}).get(t, {})
        ttft = per.get("serving_ttft_seconds", {})
        itl = per.get("serving_itl_seconds", {})
        out[t] = {
            "requests": req_by_tenant.get(t, 0),
            "ttft_p50": ttft.get("p50"), "ttft_p99": ttft.get("p99"),
            "itl_p50": itl.get("p50"), "itl_p99": itl.get("p99"),
        }
    return out


# the shared health() envelope: every health() surface wraps its own
# payload with these versioned, registry-sourced top-level keys
HEALTH_SCHEMA_VERSION = 1
HEALTH_COMMON_KEYS = ("schema_version", "kind", "shed_total",
                      "expired_total", "requests_total", "alerts")


def health_envelope(kind: str, payload: dict) -> dict:
    """Wrap one surface's health payload with the shared envelope keys,
    the process-default alert manager's compact summary included (the
    empty summary while no manager exists). The payload's own keys stay
    at the top level; the envelope's win on collision only for
    ``schema_version``/``kind``."""
    reg = registry()
    out = dict(payload)
    out["schema_version"] = HEALTH_SCHEMA_VERSION
    out["kind"] = str(kind)
    out["shed_total"] = int(reg.total("serving_shed_total"))
    out["expired_total"] = int(reg.total("serving_expired_total"))
    out["requests_total"] = int(reg.total("serving_requests_total"))
    out["alerts"] = alerts.health_summary()
    return out
