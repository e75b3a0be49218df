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

Not ported yet (the control-plane slice): the reference's ``alerts``,
``slo``, ``regress``, ``agg`` and ``compile`` modules, the ``health()``
envelope and the ``python -m paddle_tpu.obs`` CLI.
"""
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricAttr,
    MetricsRegistry,
    labels_of,
    registry,
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
    "stitch_traces", "SLO_HISTOGRAMS", "slo_summary",
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
