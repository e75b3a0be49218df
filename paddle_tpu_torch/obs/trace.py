"""Counterpart of ``paddle_tpu/obs/trace.py``, copied. Spans are host
objects: the serving engine opens and closes them around its dispatches
and harvests, outside any captured CUDA graph.

Per-request distributed tracing: Dapper-style spans in a bounded
per-process ring, exportable as Chrome trace-event JSON (loadable in
Perfetto / ``chrome://tracing``), stitchable across processes.

Model:

- A **trace** is one request's journey, identified by ``trace_id`` — a
  random 16-hex id minted at admission and carried on ``GenRequest``,
  the cluster wire records, and the disagg handoff payload header, so
  a decode-worker span parents correctly across the process boundary.
- A **span** is one named leg (``admission``, ``route``, ``prefill``,
  ``handoff_send``, ``handoff_recv``, ``decode``, ``dispatch``,
  ``harvest``) with a start time, a duration, and a parent span id.
  Use the :func:`span` context manager for synchronous legs and the
  explicit :func:`start_span`/:func:`finish_span` pair for async legs
  (the overlap copy ring issues a dispatch span at submit time and
  finishes it at harvest, possibly many steps later).
- An **instant** is a zero-duration event (watchdog escalation,
  rollback, chaos injection, XLA compile start) that lands on the same
  timeline as the request spans.

Recording is a deque append — bounded (``TraceRing``), allocation-light,
and togglable: :func:`set_enabled(False)` turns every record into a
no-op while keeping id propagation intact, which is what the
``serving_throughput.py --obs`` A/B measures. Timestamps are wall-clock
(``time.time()``) so per-worker ring dumps from different processes
merge on one axis; :func:`stitch_traces` unions dumps and
:func:`export_chrome_trace` renders either a single ring or a stitched
set.
"""
from __future__ import annotations

import collections
import json
import os
import random
import threading
import time
from typing import Dict, Iterable, List, Optional

__all__ = [
    "Span",
    "TraceRing",
    "new_trace_id",
    "span",
    "start_span",
    "finish_span",
    "instant",
    "trace_ctx",
    "ring",
    "set_enabled",
    "enabled",
    "set_process_label",
    "export_chrome_trace",
    "stitch_traces",
]


# ids need uniqueness, not unpredictability: the random module's C
# PRNG (urandom-seeded at import, reseeded after fork below) skips the
# per-span os.urandom syscall — ids are minted on the serving hot path
_ID_RNG = random.Random()


def new_trace_id() -> str:
    return "%016x" % _ID_RNG.getrandbits(64)


def _new_span_id() -> str:
    return "%012x" % _ID_RNG.getrandbits(48)


class Span:
    """One in-flight or finished span. Mutable on purpose: async legs
    hold the object open across steps and attach result args at
    finish."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id",
                 "dur", "ph", "tid", "args", "_t0")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], tid: str, args: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self._t0 = time.perf_counter()
        self.dur = None
        self.ph = "X"
        self.tid = tid
        self.args = args

    @property
    def ts(self) -> float:
        # wall-clock start derived from the per-process anchor: one
        # clock read per span instead of two, still mergeable across
        # process rings (drift over a serve window is visualization-
        # negligible)
        return _WALL0 + self._t0

    def ctx(self) -> dict:
        """The carryable context: what rides a wire record / handoff
        header so the far side can parent its spans under this one."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def to_dict(self) -> dict:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "ts": self.ts, "dur": self.dur, "ph": self.ph,
            "proc": _PROC_LABEL, "pid": _PID, "tid": self.tid,
            "args": self.args,
        }


class TraceRing:
    """Bounded ring of FINISHED events (spans + instants)."""

    def __init__(self, capacity: int = 8192):
        self._ring = collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self.n_recorded = 0

    @property
    def n_dropped(self) -> int:
        # derived, not tracked: keeps record() to an append + counter
        return max(0, self.n_recorded - self._ring.maxlen)

    def record(self, event) -> None:
        # lock-free hot path: deque.append is GIL-atomic (maxlen evicts
        # inside the same bytecode op) and the counter is advisory —
        # the lock guards only the dump/clear snapshots. Accepts a dict
        # OR a finished Span — Spans materialize lazily at dump() so
        # the serving step never pays the 11-key dict build
        self._ring.append(event)
        self.n_recorded += 1

    def dump(self) -> List[dict]:
        with self._lock:
            return [e.to_dict() if isinstance(e, Span) else e
                    for e in self._ring]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.n_recorded = 0

    def __len__(self) -> int:
        return len(self._ring)


_RING = TraceRing()
_ENABLED = True
# wall-clock anchor for Span.ts: ts = _WALL0 + perf_counter()
_WALL0 = time.time() - time.perf_counter()
_PID = os.getpid()
_PROC_LABEL = f"pid{_PID}"


def _refork():  # keep cached pid + id stream honest in forked workers
    global _PID, _PROC_LABEL
    old, _PID = _PID, os.getpid()
    if _PROC_LABEL == f"pid{old}":
        _PROC_LABEL = f"pid{_PID}"
    _ID_RNG.seed(os.urandom(16))


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_refork)


def ring() -> TraceRing:
    return _RING


def set_enabled(on: bool) -> bool:
    """Toggle span/instant RECORDING (id propagation stays on so a
    re-enable mid-request still stitches). Returns the previous
    state."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(on)
    return prev


def enabled() -> bool:
    return _ENABLED


def set_process_label(label: str) -> None:
    """Name this process's track in exported timelines (e.g. the
    disagg worker id instead of a bare pid)."""
    global _PROC_LABEL
    _PROC_LABEL = str(label)


def trace_ctx(obj) -> Optional[dict]:
    """Extract a carryable trace context from a Span, a context dict,
    or an object with ``trace_id``/``span_id`` attributes (GenRequest);
    None when the object carries no trace."""
    if obj is None:
        return None
    if isinstance(obj, Span):
        return obj.ctx()
    if isinstance(obj, dict):
        tid = obj.get("trace_id")
        return {"trace_id": tid, "span_id": obj.get("span_id")} \
            if tid else None
    tid = getattr(obj, "trace_id", None)
    if not tid:
        return None
    return {"trace_id": tid, "span_id": getattr(obj, "span_id", None)}


def _resolve_parent(trace_id, parent):
    ctx = trace_ctx(parent)
    if ctx is not None:
        return ctx["trace_id"], ctx.get("span_id")
    return trace_id, None


def start_span(name: str, *, trace_id: Optional[str] = None,
               parent=None, tid: str = "main", **args) -> Span:
    """Open a span. ``parent`` may be a Span, a carried context dict,
    or any object with trace_id/span_id attributes; when it carries a
    trace the span joins it, otherwise ``trace_id`` (or a fresh id) is
    used. Always returns a usable Span — recording is decided at
    finish time."""
    ptrace, pspan = _resolve_parent(trace_id, parent)
    return Span(name, ptrace or new_trace_id(), _new_span_id(), pspan,
                tid, args)


def finish_span(sp: Optional[Span], **args) -> Optional[Span]:
    """Close a span and record it (when tracing is enabled). Extra
    kwargs merge into the span's args. Idempotent-ish: a second finish
    records a second event, so callers own at-most-once."""
    if sp is None:
        return None
    sp.dur = time.perf_counter() - sp._t0
    if args:
        sp.args.update(args)
    if _ENABLED:
        _RING.record(sp)
    return sp


class _SpanCtx:
    __slots__ = ("_span",)

    def __init__(self, sp: Span):
        self._span = sp

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._span.args.setdefault("error", exc_type.__name__)
        finish_span(self._span)
        return False


def span(name: str, *, trace_id: Optional[str] = None, parent=None,
         tid: str = "main", **args) -> _SpanCtx:
    """Context-manager form for synchronous legs::

        with obs.span("route", parent=req) as sp:
            ...
    """
    return _SpanCtx(start_span(name, trace_id=trace_id, parent=parent,
                               tid=tid, **args))


def instant(name: str, *, trace_id: Optional[str] = None, parent=None,
            tid: str = "main", **args) -> None:
    """Record a zero-duration event (watchdog/rollback/chaos/compile
    markers) on the same timeline as the spans."""
    if not _ENABLED:
        return
    ptrace, pspan = _resolve_parent(trace_id, parent)
    sp = Span(name, ptrace or "", _new_span_id(), pspan, tid, args)
    sp.ph = "i"
    sp.dur = 0.0
    _RING.record(sp)


# ---------------------------------------------------------------------------
# Export / cross-process stitch


def stitch_traces(dumps: Iterable[List[dict]],
                  trace_id: Optional[str] = None) -> List[dict]:
    """Union per-worker ring dumps into one event list sorted by
    timestamp, optionally filtered to a single ``trace_id`` — the
    cross-process merge a 2-process disagg deployment needs to see one
    request's admission→handoff→decode tree on one timeline."""
    merged: List[dict] = []
    for d in dumps:
        for ev in d:
            if trace_id is None or ev.get("trace_id") == trace_id:
                merged.append(ev)
    merged.sort(key=lambda e: (e.get("ts", 0.0), e.get("span_id", "")))
    return merged


def export_chrome_trace(events: Optional[List[dict]] = None,
                        path: Optional[str] = None) -> List[dict]:
    """Render ring events (default: this process's ring) as Chrome
    trace-event JSON objects; optionally write ``{"traceEvents": ...}``
    to ``path`` for Perfetto. Span events use phase "X"
    (complete), instants phase "i"; trace/span/parent ids ride in
    ``args`` so the tree is reconstructable from the file alone."""
    if events is None:
        events = _RING.dump()
    procs: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    out: List[dict] = []
    meta: List[dict] = []
    for ev in events:
        proc = str(ev.get("proc", ev.get("pid", 0)))
        if proc not in procs:
            procs[proc] = len(procs) + 1
            meta.append({"ph": "M", "name": "process_name",
                         "pid": procs[proc], "tid": 0,
                         "args": {"name": proc}})
        pid = procs[proc]
        tkey = (proc, str(ev.get("tid", "main")))
        if tkey not in tids:
            tids[tkey] = len([k for k in tids if k[0] == proc]) + 1
            meta.append({"ph": "M", "name": "thread_name",
                         "pid": pid, "tid": tids[tkey],
                         "args": {"name": tkey[1]}})
        entry = {
            "name": ev["name"],
            "cat": "obs",
            "ph": ev.get("ph", "X"),
            "ts": ev["ts"] * 1e6,
            "pid": pid,
            "tid": tids[tkey],
            "args": {
                "trace_id": ev.get("trace_id"),
                "span_id": ev.get("span_id"),
                "parent_id": ev.get("parent_id"),
                **(ev.get("args") or {}),
            },
        }
        if entry["ph"] == "X":
            entry["dur"] = max(ev.get("dur") or 0.0, 0.0) * 1e6
        else:
            entry["s"] = "p"
        out.append(entry)
    doc = meta + out
    if path is not None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"traceEvents": doc,
                       "displayTimeUnit": "ms"}, fh)
    return doc
