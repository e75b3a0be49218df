"""Bench ledger + statistical perf-regression sentinel (counterpart of
``paddle_tpu/obs/regress.py``, copied; the record's ``schema`` name is
the reference's, so either package reads the other's ledgers).

A benchmark ends by printing one JSON metric line. This module gives
the line a schema and a home:

- :func:`bench_record` — the one shared emitter. Builds a
  ``paddle_tpu.bench/1`` record (bench name, metric, value, unit,
  config, host, timestamp), prints it (flushed, driver-parsable: the
  legacy ``"metric"``/``"value"``/``"unit"``/``"extra"`` keys stay at
  the top level) and appends it to the **bench ledger** — an
  append-only JSONL file named by ``ledger_path`` or the
  ``BENCH_LEDGER`` env var.
- :func:`load_ledger` — reads ledgers back. Accepts both the schema'd
  JSONL and the measurement driver's ``BENCH_r0N.json`` round files
  (``{n, cmd, rc, tail, parsed}``): a round whose ``parsed`` metric
  line is non-null contributes one record; failed/unparsed rounds are
  skipped, not errors.
- :func:`detect_regressions` — the sentinel. Per (bench, metric,
  config, host) group: candidate = newest record, baseline = the
  trailing window before it. Robust center/spread (trimmed mean +
  scaled MAD — one outlier round must not widen the gate), and a
  direction-aware verdict from per-metric **polarity**: tok/s up is
  good, p99 down is good. A candidate beyond
  ``max(mad_k * MAD, min_rel * |center|)`` in the BAD direction is a
  regression; beyond it in the good direction is an improvement;
  groups with fewer than ``min_baseline`` baseline points return
  ``insufficient_data`` (quiet — a 2-point history cannot gate).

CLI: ``python -m paddle_tpu_torch.obs regress --ledger FILE...`` exits 1 on
any regression, 0 otherwise — the CI bench gate.
"""
from __future__ import annotations

import json
import os
import socket
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "BENCH_SCHEMA",
    "bench_record",
    "load_ledger",
    "polarity_of",
    "trimmed_mean",
    "mad",
    "detect_regressions",
]

BENCH_SCHEMA = "paddle_tpu.bench/1"

# scale factor that makes the MAD a consistent estimator of the stddev
# under normality — the usual robust-statistics constant
_MAD_SCALE = 1.4826


# ---------------------------------------------------------------------------
# emission


def bench_record(bench: str, metric: str, value, unit: str = "", *,
                 extra: Optional[dict] = None,
                 config: Optional[dict] = None,
                 ledger_path: Optional[str] = None,
                 emit: bool = True,
                 line_prefix: str = "",
                 **fields) -> dict:
    """Build, print and ledger one bench metric record.

    The printed line keeps the legacy driver contract — a single JSON
    object with ``metric``/``value``/``unit``(/``extra``) at the top
    level — and adds the schema'd bookkeeping keys. Extra top-level
    fields the caller's old line carried (``vs_baseline``, ``error``,
    ``row``...) pass through ``**fields`` unchanged. ``emit=False``
    ledgers without printing; ``line_prefix`` preserves framed
    protocols (``BENCH_ROW ...``)."""
    rec: Dict[str, object] = {
        "schema": BENCH_SCHEMA,
        "bench": str(bench),
        "metric": str(metric),
        "value": None if value is None else float(value),
        "unit": str(unit),
    }
    if extra is not None:
        rec["extra"] = extra
    if config is not None:
        rec["config"] = config
    for k, v in fields.items():
        rec.setdefault(k, v)
    rec["host"] = socket.gethostname()
    rec["recorded_unix"] = time.time()
    if emit:
        print(line_prefix + json.dumps(rec), flush=True)
    path = ledger_path or os.environ.get("BENCH_LEDGER")
    if path:
        try:
            with open(path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
        except OSError:
            pass  # an unwritable ledger must never fail the bench run
    return rec


# ---------------------------------------------------------------------------
# loading


def _from_round_file(doc: dict, path: str) -> Optional[dict]:
    """Convert one driver round file (``{n, cmd, rc, tail, parsed}``)
    into a ledger record; None when the round carried no parsed
    metric line (failed / timed-out rounds)."""
    parsed = doc.get("parsed")
    if not isinstance(parsed, dict) or "metric" not in parsed:
        return None
    if not isinstance(parsed.get("value"), (int, float)):
        return None
    return {
        "schema": BENCH_SCHEMA,
        "bench": str(parsed.get("bench", "bench")),
        "metric": str(parsed["metric"]),
        "value": float(parsed["value"]),
        "unit": str(parsed.get("unit", "")),
        "round": doc.get("n"),
        "source_file": os.path.basename(path),
    }


def _normalize(doc: dict, path: str) -> Optional[dict]:
    if "parsed" in doc and "metric" not in doc:
        return _from_round_file(doc, path)
    if "metric" in doc and isinstance(doc.get("value"), (int, float)):
        out = dict(doc)
        out.setdefault("bench", str(doc.get("bench", "bench")))
        out.setdefault("source_file", os.path.basename(path))
        return out
    return None


def load_ledger(paths: Sequence[str]) -> List[dict]:
    """Read ledger records from ``paths`` in order. Each file may be a
    JSONL ledger, a single JSON record, a JSON list of records, or a
    driver round file; lines/files that carry no usable metric are
    skipped silently (the sentinel grades what exists)."""
    out: List[dict] = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        docs: List[dict] = []
        try:
            whole = json.loads(text)
            if isinstance(whole, list):
                docs = [d for d in whole if isinstance(d, dict)]
            elif isinstance(whole, dict):
                docs = [whole]
        except ValueError:
            for line in text.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue
                if isinstance(doc, dict):
                    docs.append(doc)
        for doc in docs:
            rec = _normalize(doc, path)
            if rec is not None:
                out.append(rec)
    return out


# ---------------------------------------------------------------------------
# polarity


# explicit metric-name registry wins over the token heuristics
_POLARITY: Dict[str, str] = {
    "loadgen_goodput_under_slo": "up",
    "llama_train_tokens_per_sec_per_chip": "up",
}

_UP_TOKENS = ("tok", "throughput", "goodput", "mfu", "hit_rate",
              "speedup", "attainment", "accept", "per_sec", "per_s",
              "qps", "bandwidth", "samples")
_DOWN_TOKENS = ("latency", "ttft", "itl", "delay", "overhead",
                "blocked", "stall", "p999", "p99", "p95", "p50",
                "_ms", "_s", "seconds", "time")


def polarity_of(metric: str, record: Optional[dict] = None) -> str:
    """``"up"`` (bigger is better) or ``"down"`` (smaller is better).
    Resolution order: the record's own ``polarity`` field, the explicit
    registry, then name-token heuristics (up-tokens checked first so
    ``tokens_per_sec`` beats its ``_s`` suffix); unknown names default
    to ``"up"`` — the common case for bench headline numbers."""
    if record is not None:
        p = record.get("polarity")
        if p in ("up", "down"):
            return p
    m = str(metric).lower()
    if m in _POLARITY:
        return _POLARITY[m]
    for tok in _UP_TOKENS:
        if tok in m:
            return "up"
    for tok in _DOWN_TOKENS:
        if tok in m:
            return "down"
    return "up"


# ---------------------------------------------------------------------------
# robust statistics


def trimmed_mean(xs: Sequence[float], trim_frac: float = 0.2) -> float:
    """Mean of the middle (1 - 2*trim_frac) of the sorted sample; the
    ends (``floor(n * trim_frac)`` each side) are dropped so a single
    bad round cannot drag the baseline center."""
    xs = sorted(float(x) for x in xs)
    if not xs:
        raise ValueError("trimmed_mean of empty sequence")
    k = int(len(xs) * trim_frac)
    core = xs[k:len(xs) - k] or xs
    return sum(core) / len(core)


def mad(xs: Sequence[float], center: Optional[float] = None) -> float:
    """Median absolute deviation, scaled by 1.4826 to estimate sigma."""
    xs = [float(x) for x in xs]
    if not xs:
        raise ValueError("mad of empty sequence")
    if center is None:
        s = sorted(xs)
        mid = len(s) // 2
        center = (s[mid] if len(s) % 2
                  else 0.5 * (s[mid - 1] + s[mid]))
    dev = sorted(abs(x - center) for x in xs)
    mid = len(dev) // 2
    med = dev[mid] if len(dev) % 2 else 0.5 * (dev[mid - 1] + dev[mid])
    return _MAD_SCALE * med


def _config_sig(rec: dict) -> str:
    cfg = rec.get("config")
    if not cfg:
        return ""
    return json.dumps(cfg, sort_keys=True)


def _group_key(rec: dict) -> Tuple[str, str, str, str]:
    return (str(rec.get("bench", "")), str(rec.get("metric", "")),
            _config_sig(rec), str(rec.get("host", "")))


def detect_regressions(records: Sequence[dict], *,
                       baseline_window: int = 8,
                       trim_frac: float = 0.2,
                       mad_k: float = 4.0,
                       min_rel: float = 0.05,
                       min_baseline: int = 3) -> List[dict]:
    """Grade the NEWEST record of every (bench, metric, config, host)
    group against its trailing baseline window. Returns one verdict
    dict per group (sorted by group key), ``verdict`` in
    ``{"ok", "improvement", "regression", "insufficient_data"}``.

    The gate is ``max(mad_k * scaledMAD, min_rel * |center|)``: the
    MAD term adapts to the metric's own run-to-run noise, the relative
    floor stops a freakishly quiet baseline (MAD 0 after trimming)
    from flagging sub-percent wiggle."""
    groups: Dict[Tuple[str, str, str, str], List[dict]] = {}
    for rec in records:
        if not isinstance(rec.get("value"), (int, float)):
            continue
        groups.setdefault(_group_key(rec), []).append(rec)
    out: List[dict] = []
    for key in sorted(groups):
        recs = groups[key]
        bench, metric, cfg, host = key
        cand = recs[-1]
        base = recs[:-1][-baseline_window:]
        verdict = {
            "bench": bench, "metric": metric, "host": host,
            "config": cfg or None,
            "polarity": polarity_of(metric, cand),
            "n_baseline": len(base),
            "candidate": float(cand["value"]),
        }
        if len(base) < min_baseline:
            verdict.update(verdict="insufficient_data", center=None,
                           threshold=None, delta=None)
            out.append(verdict)
            continue
        vals = [float(r["value"]) for r in base]
        center = trimmed_mean(vals, trim_frac)
        spread = mad(vals)
        threshold = max(mad_k * spread, min_rel * abs(center))
        delta = float(cand["value"]) - center
        verdict.update(center=center, mad=spread, threshold=threshold,
                       delta=delta)
        good_delta = delta if verdict["polarity"] == "up" else -delta
        if good_delta < -threshold:
            verdict["verdict"] = "regression"
        elif good_delta > threshold:
            verdict["verdict"] = "improvement"
        else:
            verdict["verdict"] = "ok"
        out.append(verdict)
    return out


def format_verdicts(verdicts: Sequence[dict]) -> str:
    """Human-readable one-line-per-group report for the CLI."""
    lines = []
    for v in verdicts:
        mark = {"regression": "REGRESSION", "improvement": "improved",
                "ok": "ok", "insufficient_data": "insufficient"}[
            v["verdict"]]
        where = v["metric"] + (f" [{v['config']}]" if v["config"] else "")
        if v["verdict"] == "insufficient_data":
            lines.append(f"{mark:>11}  {v['bench']}/{where}  "
                         f"candidate={v['candidate']:g} "
                         f"(baseline n={v['n_baseline']})")
        else:
            lines.append(
                f"{mark:>11}  {v['bench']}/{where}  "
                f"candidate={v['candidate']:g} center={v['center']:g} "
                f"delta={v['delta']:+g} gate=±{v['threshold']:g} "
                f"({v['polarity']}-is-good, n={v['n_baseline']})")
    return "\n".join(lines)
