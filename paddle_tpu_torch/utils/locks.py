"""graft-race runtime half — a lockdep-style lock-order sanitizer
(counterpart of ``paddle_tpu/utils/locks.py``, copied over the port's
chaos sites, metrics registry and flight recorder).

``TracedLock`` is a drop-in ``threading.Lock``/``RLock`` replacement
that records, per thread, the set of held locks and their acquisition
sites, and maintains a global lock-ORDER graph (edge A -> B: some
thread held A while acquiring B, stamped with the stack that first
recorded it). Acquiring in an order that closes a cycle raises
:class:`LockOrderViolation` naming BOTH stacks — the one recorded
when the opposite order was first taken and the current one — BEFORE
blocking, so the seeded two-lock inversion tests (and a real inverted
pair in production) fail loudly instead of deadlocking silently.

Like the kernel's lockdep, ordering is tracked per lock CLASS (the
construction site, or an explicit ``name=``), not per instance: two
instance locks born on the same line share an order discipline.

Extras wired into the existing observability stack (all lazy — this
module stays importable with nothing but the stdlib):

- max hold-times per lock class are pushed to the obs registry gauge
  ``lock_hold_seconds_max{lock=...}``;
- a ``flight_recorder.register_dump_extra`` hook renders every
  thread's held locks + pending acquisition into CommWatchdog /
  supervisor hang dumps — a hung pod names its deadlock;
- every release first passes the ``thread.preempt`` chaos site, so a
  seeded schedule can stretch critical sections and shake out latent
  interleavings (the release itself ALWAYS happens — ``drop`` merely
  returns False).

Default OFF: framework code constructs plain ``threading.Lock``s.
:func:`instrument_locks` monkey-patches the ``threading.Lock`` /
``threading.RLock`` factories so locks constructed AFTER the call are
traced (the 2-process serving proofs enable it via
``PADDLE_LOCK_SANITIZER=1``); :func:`uninstrument_locks` restores
them. When off, the hot path pays nothing.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple

import _thread

__all__ = [
    "LockOrderViolation",
    "TracedLock",
    "instrument_locks",
    "uninstrument_locks",
    "held_locks",
    "lock_order_edges",
    "max_hold_times",
    "violation_count",
    "reset",
]

# real factories, bound BEFORE any patching can occur
_ALLOCATE = _thread.allocate_lock
_REAL_RLOCK = threading.RLock


class LockOrderViolation(RuntimeError):
    """Two lock classes were acquired in both orders (A then B, and B
    then A) — a deadlock waiting for the right interleaving."""


# -- global sanitizer state (guarded by _state_mu; the sanitizer's own
# lock is a raw _thread lock so it can never trace itself) ------------
_state_mu = _ALLOCATE()
_graph: Dict[str, Set[str]] = {}  # lock class -> classes acquired under it
_edge_stacks: Dict[Tuple[str, str], str] = {}  # first stack per edge
_threads: Dict[int, dict] = {}  # ident -> {"held": [...], "pending": ...}
_hold_max: Dict[str, float] = {}  # lock class -> max hold seconds
_violations = [0]


def _caller_frame(skip: int = 2):
    """First frame OUTSIDE this module (skipping __enter__/acquire
    wrappers), so sites point at user code."""
    f = sys._getframe(skip)
    while f.f_back is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    return f


def _stack(skip: int = 2) -> str:
    return "".join(traceback.format_stack(
        _caller_frame(skip + 1), limit=12))


def _site(skip: int = 2) -> str:
    f = _caller_frame(skip + 1)
    return (f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno} "
            f"in {f.f_code.co_name}")


def _thread_state() -> dict:
    ident = threading.get_ident()
    st = _threads.get(ident)
    if st is None:
        st = {"held": [], "pending": None}
        with _state_mu:
            _threads.setdefault(ident, st)
            st = _threads[ident]
    return st


def _reaches(src: str, dst: str) -> Optional[List[str]]:
    """DFS in the order graph: the edge path src -> ... -> dst, or
    None. Called under _state_mu."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in sorted(_graph.get(node, ())):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _chaos_preempt() -> None:
    """The ``thread.preempt`` chaos site: a seeded schedule stretches
    the critical section right before the lock is dropped (``drop``'s
    False return is deliberately ignored — the release itself is
    never skipped; the caller runs it in a ``finally``)."""
    try:
        from ..testing import chaos
    except Exception:  # pragma: no cover — stdlib-only contexts
        return
    chaos.inject("thread.preempt")


class _HeldRecord:
    __slots__ = ("lock", "name", "site", "t0", "count")

    def __init__(self, lock: "TracedLock", site: str):
        self.lock = lock
        self.name = lock.name
        self.site = site
        self.t0 = time.monotonic()
        self.count = 1


class TracedLock:
    """Drop-in Lock/RLock wrapper with lockdep-style order checking.
    Supports the full Lock protocol (``acquire(blocking, timeout)`` /
    ``release`` / ``locked`` / context manager), so it also survives
    being wrapped by ``threading.Condition``."""

    def __init__(self, name: Optional[str] = None,
                 reentrant: bool = False, _depth: int = 2):
        self._lk = _REAL_RLOCK() if reentrant else _ALLOCATE()
        self._reentrant = reentrant
        if name is None:
            f = sys._getframe(_depth - 1)
            name = (f"{'RLock' if reentrant else 'Lock'}@"
                    f"{os.path.basename(f.f_code.co_filename)}:"
                    f"{f.f_lineno}")
        self.name = name

    # -- acquire -------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        st = _thread_state()
        for rec in st["held"]:
            if rec.lock is self:  # reentrant re-acquire: no new edge
                ok = self._lk.acquire(blocking, timeout)
                if ok:
                    rec.count += 1
                return ok
        site = _site()
        with _state_mu:
            for rec in st["held"]:
                if rec.name == self.name:
                    continue  # same class, different instance: no edge
                path = _reaches(self.name, rec.name)
                if path is not None:
                    first = _edge_stacks.get(
                        (path[0], path[1]), "(stack not recorded)")
                    _violations[0] += 1
                    chain = " -> ".join(f"`{n}`" for n in path)
                    raise LockOrderViolation(
                        f"lock-order inversion: acquiring `{self.name}` "
                        f"while holding `{rec.name}`, but the opposite "
                        f"order {chain} is already established.\n"
                        f"--- established order: `{path[0]}` held while "
                        f"acquiring `{path[1]}` at ---\n{first}"
                        f"--- this thread ({threading.current_thread().name}): "
                        f"holding `{rec.name}` (acquired at {rec.site}), "
                        f"acquiring `{self.name}` at ---\n{_stack()}")
                edge = (rec.name, self.name)
                if edge not in _edge_stacks:
                    # full stacks are captured ONLY when a NEW edge (or
                    # a violation) appears — steady state re-walks known
                    # edges and pays a single-frame site lookup per
                    # acquire, which is what keeps instrumented serving
                    # steps within the <2% overhead budget
                    _edge_stacks[edge] = _stack()
                    _graph.setdefault(rec.name, set()).add(self.name)
            st["pending"] = (self.name, site, time.monotonic())
        try:
            if timeout != -1:
                ok = self._lk.acquire(blocking, timeout)
            elif blocking:
                ok = self._lk.acquire()
            else:
                ok = self._lk.acquire(False)
        finally:
            st["pending"] = None
        if ok:
            st["held"].append(_HeldRecord(self, site))
        return ok

    # -- release -------------------------------------------------------
    def release(self) -> None:
        st = _thread_state()
        for i in range(len(st["held"]) - 1, -1, -1):
            rec = st["held"][i]
            if rec.lock is self:
                rec.count -= 1
                if rec.count == 0:
                    del st["held"][i]
                    self._note_hold(time.monotonic() - rec.t0)
                break
        try:
            _chaos_preempt()
        finally:
            self._lk.release()

    def _note_hold(self, dt: float) -> None:
        with _state_mu:
            if dt <= _hold_max.get(self.name, 0.0):
                return
            _hold_max[self.name] = dt
        try:
            from ..obs.metrics import registry

            registry().gauge("lock_hold_seconds_max",
                             {"lock": self.name}).set(dt)
        except Exception:  # obs may be absent/uninitialized
            pass

    # -- Condition protocol --------------------------------------------
    # threading.Condition probes these on its lock; delegating to the
    # real RLock keeps wait() semantics exact for recursive locks (the
    # held RECORD stays during the wait — the bookkeeping re-syncs at
    # _acquire_restore, and order edges are only ever added by our own
    # acquire(), so no false cycles result)
    def _is_owned(self) -> bool:
        owned = getattr(self._lk, "_is_owned", None)
        if owned is not None:
            return owned()
        if self._lk.acquire(False):
            self._lk.release()
            return False
        return True

    def __getattr__(self, attr: str):
        if attr in ("_release_save", "_acquire_restore"):
            return getattr(self._lk, attr)
        raise AttributeError(attr)

    # -- protocol ------------------------------------------------------
    def locked(self) -> bool:
        probe = getattr(self._lk, "locked", None)
        if probe is not None:
            return probe()
        if self._lk.acquire(False):  # RLock pre-3.14 has no .locked()
            self._lk.release()
            return False
        return True

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TracedLock {self.name}>"


# -- factory patching -------------------------------------------------
_instrumented = [False]


def _lock_factory():
    return TracedLock(_depth=3)


def _rlock_factory():
    return TracedLock(reentrant=True, _depth=3)


def instrument_locks() -> bool:
    """Patch ``threading.Lock``/``threading.RLock`` so locks built
    from here on are traced; also registers the held-locks hang-dump
    hook. Idempotent; returns True when newly installed."""
    if _instrumented[0]:
        return False
    try:
        # imported before the factories are patched: a module-level lock
        # its import builds would stay traced, and pass the
        # ``thread.preempt`` chaos site, after ``uninstrument_locks()``
        from ..distributed.communication.flight_recorder import (
            register_dump_extra,
        )
    except Exception:  # flight recorder optional at this layer
        register_dump_extra = None
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    _instrumented[0] = True
    if register_dump_extra is not None:
        register_dump_extra(_dump_held_locks)
    return True


def uninstrument_locks() -> None:
    """Restore the real factories (existing TracedLocks keep working)."""
    if not _instrumented[0]:
        return
    threading.Lock = _ALLOCATE
    threading.RLock = _REAL_RLOCK
    _instrumented[0] = False
    try:
        from ..distributed.communication.flight_recorder import (
            unregister_dump_extra,
        )

        unregister_dump_extra(_dump_held_locks)
    except Exception:
        pass


# -- introspection / test API -----------------------------------------
def held_locks() -> Dict[str, List[Tuple[str, str, float]]]:
    """thread name -> [(lock class, acquisition site, held seconds)]."""
    names = {t.ident: t.name for t in threading.enumerate()}
    now = time.monotonic()
    out: Dict[str, List[Tuple[str, str, float]]] = {}
    with _state_mu:
        for ident, st in _threads.items():
            if st["held"]:
                out[names.get(ident, str(ident))] = [
                    (r.name, r.site, now - r.t0) for r in st["held"]]
    return out


def lock_order_edges() -> Dict[Tuple[str, str], str]:
    with _state_mu:
        return dict(_edge_stacks)


def max_hold_times() -> Dict[str, float]:
    with _state_mu:
        return dict(_hold_max)


def violation_count() -> int:
    return _violations[0]


def reset() -> None:
    """Clear the order graph / held sets / hold-time maxima (tests)."""
    with _state_mu:
        _graph.clear()
        _edge_stacks.clear()
        _threads.clear()
        _hold_max.clear()
        _violations[0] = 0


def _dump_held_locks(file) -> None:
    """flight_recorder dump extra: every thread's held locks and the
    acquisition it is blocked on — a hung pod names its deadlock."""
    names = {t.ident: t.name for t in threading.enumerate()}
    now = time.monotonic()
    with _state_mu:
        snap = [(ident, list(st["held"]), st["pending"])
                for ident, st in sorted(_threads.items())]
    lines = ["", "-- graft-race: per-thread held locks --"]
    busy = False
    for ident, held, pending in snap:
        if not held and pending is None:
            continue
        busy = True
        lines.append(f"thread {names.get(ident, ident)}:")
        for r in held:
            lines.append(f"  holds `{r.name}` for {now - r.t0:.3f}s "
                         f"(acquired at {r.site})")
        if pending is not None:
            pname, psite, pt0 = pending
            lines.append(f"  WAITING for `{pname}` since "
                         f"{now - pt0:.3f}s at {psite}")
    if not busy:
        lines.append("(no locks held)")
    file.write("\n".join(lines) + "\n")
