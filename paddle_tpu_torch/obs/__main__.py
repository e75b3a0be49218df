"""``python -m paddle_tpu_torch.obs`` — render observability state
(counterpart of ``paddle_tpu/obs/__main__.py``, copied: the same
subcommands, options and exit codes).

Subcommands::

    dump  [file.jsonl]   # JSON metrics snapshot (current process, or
                         # the LAST line of a snapshot_jsonl file)
    prom  [file.jsonl]   # Prometheus text exposition of the same
    trace [out.json]     # Chrome trace-event JSON from this process's
                         # ring (mostly useful with --stitch)
    trace --stitch a.json b.json ... [-o out.json] [--trace-id ID]
                         # merge per-worker ring dumps by trace_id
    agg STORE [--prefix obs] [--summary] [--trace-out f] [--trace-id ID]
                         # fleet aggregation: merge every
                         # obs/<id>/ publication in a KVStore (STORE is
                         # tcp://host:port or a FileKVStore directory)
                         # into one snapshot — counters summed, gauges
                         # per-source, histograms bucket-merged —
                         # optionally also the stitched fleet trace
    alerts STORE [--ttft-slo S] [--objective O] [--absence-age S]
                 [--rules] [--state]
                         # evaluate the stock serving rule set over the
                         # fleet; rc 1 when anything FIRES
    top STORE [--interval S] [--once]
                         # live text dashboard off the same store:
                         # per-source freshness, fleet totals,
                         # per-tenant SLO percentiles, active alerts
    regress --ledger FILE... [--window N] [--mad-k K] [--min-rel F]
            [--min-baseline N] [--json]
                         # bench-ledger regression sentinel: rc 1 on a
                         # detected regression (the CI bench gate),
                         # rc 0 on ok/improvement/insufficient data

A fresh interpreter has an empty registry, so ``dump``/``prom``
without a file mostly matter for smoke tests; the file forms are the
operational path (workers append snapshots via
``registry().snapshot_jsonl(path)`` and dump their rings at exit).
"""
from __future__ import annotations

import argparse
import json
import sys

from .metrics import registry
from .trace import export_chrome_trace, ring, stitch_traces


def _load_last_snapshot(path: str) -> dict:
    last = None
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                last = line
    if last is None:
        raise SystemExit(f"{path}: no snapshot lines")
    return json.loads(last)


def _snap_to_text(snap: dict) -> str:
    """Prometheus-ish text from a JSON snapshot (file path: we only
    have the serialized values, not live histograms)."""
    lines = []
    for name in sorted(snap.get("metrics", {})):
        m = snap["metrics"][name]
        lines.append(f"# TYPE {name} {m.get('kind', 'untyped')}")
        for s in m.get("series", []):
            labels = s.get("labels", {})
            body = ",".join(f'{k}="{v}"'
                            for k, v in sorted(labels.items()))
            lab = "{" + body + "}" if body else ""
            v = s.get("value")
            if isinstance(v, dict):  # serialized histogram
                for kk in ("count", "sum", "p50", "p95", "p99"):
                    if v.get(kk) is not None:
                        lines.append(f"{name}_{kk}{lab} {v[kk]}")
            elif v is not None:
                lines.append(f"{name}{lab} {v}")
    return "\n".join(lines) + "\n"


def _serving_rules(ttft_slo, objective, absence_age):
    from . import alerts as _alerts
    from .slo import SLOClass, SLOSpec

    spec = None
    if ttft_slo is not None:
        spec = SLOSpec(default=SLOClass(ttft_s=float(ttft_slo)))
    return _alerts.default_serving_rules(
        slo=spec, objective=objective, absence_age_s=absence_age)


def _cmd_alerts(args) -> int:
    from . import alerts as _alerts
    from ..distributed.store import make_store

    rules = _serving_rules(args.ttft_slo, args.objective,
                           args.absence_age)
    if args.rules:
        print(json.dumps([r.to_dict() for r in rules], indent=2,
                         sort_keys=True))
        return 0
    mgr = _alerts.AlertManager(rules, emit_trace=False)
    store = make_store(args.store)
    mgr.evaluate_fleet(store, prefix=args.prefix)
    doc = mgr.statuses() if args.state else mgr.active()
    print(json.dumps(doc, indent=2, sort_keys=True))
    return 1 if mgr.firing() else 0


def _fmt_ms(v):
    return "-" if v is None else f"{1e3 * v:8.1f}"


def _top_frame(store, prefix, mgr) -> str:
    """One dashboard frame: source freshness, fleet counter totals,
    per-tenant SLO percentiles, active alerts."""
    import time as _time

    from . import agg

    states = agg.collect(store, prefix=prefix)
    summ = agg.fleet_summary(store, prefix=prefix)
    now = _time.time()
    lines = [f"paddle_tpu_torch.obs top — {len(states)} source(s)  "
             f"{_time.strftime('%H:%M:%S')}"]
    lines.append("")
    lines.append(f"{'SOURCE':<20} {'AGE_S':>7}")
    for sid in sorted(states):
        pub = states[sid].get("published_unix")
        age = "-" if pub is None else f"{max(0.0, now - pub):7.1f}"
        lines.append(f"{sid:<20} {age:>7}")
    lines.append("")
    totals = summ.get("totals", {})
    if totals:
        lines.append("FLEET TOTALS")
        for name in sorted(totals):
            lines.append(f"  {name:<44} {totals[name]:>12g}")
        lines.append("")
    tenants = summ.get("tenants", {})
    if tenants:
        lines.append(f"{'TENANT':<14} {'TTFT_P50MS':>10} "
                     f"{'TTFT_P99MS':>10} {'ITL_P99MS':>10} {'N':>8}")
        for t in sorted(tenants):
            per = tenants[t]
            ttft = per.get("serving_ttft_seconds", {})
            itl = per.get("serving_itl_seconds", {})
            lines.append(
                f"{t:<14} {_fmt_ms(ttft.get('p50')):>10} "
                f"{_fmt_ms(ttft.get('p99')):>10} "
                f"{_fmt_ms(itl.get('p99')):>10} "
                f"{ttft.get('count', 0):>8}")
        lines.append("")
    if mgr is not None:
        mgr.evaluate_fleet(store, prefix=prefix)
        active = mgr.active()
        lines.append(f"ALERTS ({len(active)} active)")
        for a in active:
            lab = ",".join(f"{k}={v}"
                           for k, v in sorted(a["labels"].items()))
            lines.append(f"  [{a['state']:^8}] {a['rule']:<28} "
                         f"{a['severity']:<8} {lab}")
    return "\n".join(lines)


def _cmd_top(args) -> int:
    import time as _time

    from . import alerts as _alerts
    from ..distributed.store import make_store

    store = make_store(args.store)
    mgr = _alerts.AlertManager(
        _serving_rules(args.ttft_slo, args.objective, 5.0),
        emit_trace=False)
    if args.once:
        print(_top_frame(store, args.prefix, mgr))
        return 0
    try:
        while True:
            frame = _top_frame(store, args.prefix, mgr)
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            _time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        return 0


def _cmd_regress(args) -> int:
    from . import regress as _regress

    records = _regress.load_ledger(args.ledger)
    verdicts = _regress.detect_regressions(
        records, baseline_window=args.window, mad_k=args.mad_k,
        min_rel=args.min_rel, min_baseline=args.min_baseline)
    if args.json:
        print(json.dumps(verdicts, indent=2, sort_keys=True))
    elif verdicts:
        print(_regress.format_verdicts(verdicts))
    else:
        print("regress: no graded records in "
              f"{len(args.ledger)} ledger file(s)")
    bad = [v for v in verdicts if v["verdict"] == "regression"]
    if bad:
        print(f"regress: {len(bad)} regression(s) detected",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump", help="JSON metrics snapshot")
    d.add_argument("file", nargs="?", help="snapshot JSONL to render "
                   "(default: current process registry)")
    p = sub.add_parser("prom", help="Prometheus text exposition")
    p.add_argument("file", nargs="?")
    t = sub.add_parser("trace", help="Chrome trace-event JSON")
    t.add_argument("dumps", nargs="*",
                   help="with --stitch: per-worker ring-dump JSON files")
    t.add_argument("--stitch", action="store_true",
                   help="merge ring-dump files instead of exporting "
                        "this process's ring")
    t.add_argument("--trace-id", default=None,
                   help="restrict the stitch to one trace")
    t.add_argument("-o", "--out", default=None,
                   help="write the Chrome trace JSON here "
                        "(default: stdout)")
    a = sub.add_parser("agg", help="merge fleet publications from a "
                                   "KVStore into one snapshot")
    a.add_argument("store", help="store location: tcp://host:port or a "
                                 "FileKVStore directory")
    a.add_argument("--prefix", default="obs",
                   help="publication key prefix (default: obs)")
    a.add_argument("--summary", action="store_true",
                   help="print the fleet SLO/counter digest "
                        "(fleet_summary) instead of the merged snapshot")
    a.add_argument("--trace-out", default=None,
                   help="also write the stitched fleet Chrome trace here")
    a.add_argument("--trace-id", default=None,
                   help="restrict the stitched trace to one trace id")
    al = sub.add_parser("alerts", help="evaluate the stock serving "
                                       "alert rules over a fleet store")
    al.add_argument("store", help="tcp://host:port or a FileKVStore dir")
    al.add_argument("--prefix", default="obs")
    al.add_argument("--ttft-slo", type=float, default=None,
                    help="TTFT target (s): enables the SLO burn-rate "
                         "rules")
    al.add_argument("--objective", type=float, default=0.99,
                    help="SLO objective for the error budget "
                         "(default 0.99)")
    al.add_argument("--absence-age", type=float, default=5.0,
                    help="max publication age before a source counts "
                         "as silent (default 5s)")
    al.add_argument("--rules", action="store_true",
                    help="print the rule set as JSON and exit 0")
    al.add_argument("--state", action="store_true",
                    help="print every tracked alert state, not just "
                         "the active ones")
    tp = sub.add_parser("top", help="live fleet text dashboard")
    tp.add_argument("store", help="tcp://host:port or a FileKVStore dir")
    tp.add_argument("--prefix", default="obs")
    tp.add_argument("--interval", type=float, default=2.0)
    tp.add_argument("--once", action="store_true",
                    help="render one frame and exit (no screen clear)")
    tp.add_argument("--ttft-slo", type=float, default=None)
    tp.add_argument("--objective", type=float, default=0.99)
    rg = sub.add_parser("regress", help="bench-ledger regression "
                                        "sentinel (CI gate)")
    rg.add_argument("--ledger", nargs="+", required=True,
                    help="ledger JSONL files and/or driver "
                         "BENCH_r0N.json round files, oldest first")
    rg.add_argument("--window", type=int, default=8,
                    help="baseline window size (default 8)")
    rg.add_argument("--mad-k", type=float, default=4.0)
    rg.add_argument("--min-rel", type=float, default=0.05)
    rg.add_argument("--min-baseline", type=int, default=3)
    rg.add_argument("--json", action="store_true",
                    help="print the verdicts as JSON")
    args = ap.parse_args(argv)

    if args.cmd == "dump":
        snap = (_load_last_snapshot(args.file) if args.file
                else registry().snapshot())
        print(json.dumps(snap, indent=2, sort_keys=True))
        return 0
    if args.cmd == "prom":
        if args.file:
            sys.stdout.write(_snap_to_text(_load_last_snapshot(args.file)))
        else:
            sys.stdout.write(registry().expose_text())
        return 0
    if args.cmd == "agg":
        from ..distributed.store import make_store
        from . import agg

        store = make_store(args.store)
        doc = (agg.fleet_summary(store, prefix=args.prefix)
               if args.summary
               else agg.fleet_snapshot(store, prefix=args.prefix))
        print(json.dumps(doc, indent=2, sort_keys=True))
        if args.trace_out:
            events = agg.fleet_trace(store, prefix=args.prefix,
                                     trace_id=args.trace_id)
            export_chrome_trace(events, path=args.trace_out)
        return 0
    if args.cmd == "alerts":
        return _cmd_alerts(args)
    if args.cmd == "top":
        return _cmd_top(args)
    if args.cmd == "regress":
        return _cmd_regress(args)
    # trace
    if args.stitch:
        dumps = []
        for fp in args.dumps:
            with open(fp, encoding="utf-8") as fh:
                dumps.append(json.load(fh))
        events = stitch_traces(dumps, trace_id=args.trace_id)
    else:
        events = ring().dump()
    doc = export_chrome_trace(events, path=args.out)
    if args.out is None:
        print(json.dumps({"traceEvents": doc}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
