"""graft-own runtime half — a resource-accounting leak sanitizer.

:class:`ResourceLedger` mirrors every acquire/release of the serving
stack's ref-counted resources — KV blocks (``BlockManager``), engine
slots, disagg handoff holds, outstanding transfer records, host-tier
frames — each stamped with the acquisition site, so
:meth:`~ResourceLedger.leak_check` can name WHERE every outstanding
resource was taken, and :meth:`~ResourceLedger.verify` can assert the
conservation invariant against a live ``BlockManager``:

    free + live-referenced == pool total
    ledger per-block refcounts == the manager's reference table

The ledger catches at RUN time what name-based static analysis
cannot see — callbacks, ``getattr`` dispatch, resources threaded
through retry helpers.

Instrumentation is factory-stamped: :func:`instrument_resources` wraps
``BlockManager``'s five reference primitives (``allocate``/``adopt``/
``fork``/``ref``/``release`` — ``free_sequence`` and
``import_blocks`` delegate to those, so wrapping them too would
double-count) and stamps every BlockManager / engine / host tier
constructed AFTER the call with ``self._graft_ledger``; objects built
while the sanitizer is off carry ``None`` and pay one attribute check
per operation.

Every ledger release first passes the ``leak.hold`` chaos site: a
seeded ``drop`` DEFERS that accounting decrement (the underlying
release itself always happens), manufacturing exactly the outstanding
record ``leak_check()`` must catch — the sanitizer's own smoke test.

Wired into the observability stack (lazily — this module stays
importable with nothing but the stdlib): the ``kv_blocks_outstanding``
gauge tracks live ledger-counted blocks and ``resource_leaks_total``
counts entries a failed ``leak_check`` named; a
``flight_recorder.register_dump_extra`` hook renders outstanding
resources (blocks, slots, handoff holds and transfers) into hang dumps.

Counterpart of ``paddle_tpu/utils/resources.py``, copied, wrapping the
port's ``BlockManager``.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import _thread

__all__ = [
    "ResourceLeakError",
    "ResourceLedger",
    "instrument_resources",
    "uninstrument_resources",
    "current",
]

_state_mu = _thread.allocate_lock()


class ResourceLeakError(AssertionError):
    """Outstanding resources at a leak checkpoint, or a conservation
    violation between the ledger and a BlockManager's own tables."""


def _caller_frame(skip: int = 2):
    """First frame outside this module AND outside the instrumented
    primitive (paged_attention wrappers call through here), so sites
    point at the serving code that took the resource."""
    f = sys._getframe(skip)
    while f.f_back is not None and (
            f.f_code.co_filename == __file__
            or f.f_code.co_filename.endswith("paged_attention.py")):
        f = f.f_back
    return f


def _site(skip: int = 2) -> str:
    f = _caller_frame(skip + 1)
    return (f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno} "
            f"in {f.f_code.co_name}")


def _chaos_hold() -> bool:
    """The ``leak.hold`` chaos site: a seeded ``drop`` returns False
    and the caller SKIPS one accounting decrement — an artificial
    deferred release the sanitizer must then report."""
    try:
        from ..testing import chaos
    except Exception:  # pragma: no cover — stdlib-only contexts
        return True
    return chaos.inject("leak.hold")


class _Entry:
    __slots__ = ("site", "t0", "n")

    def __init__(self, site: str):
        self.site = site
        self.t0 = time.monotonic()
        self.n = 0


class ResourceLedger:
    """Refcounted acquire/release accounting keyed ``(kind, key)``.

    ``kind`` is one of the graft-own resource kinds (``kv.block``,
    ``engine.slot``, ``handoff.hold``, ``handoff.part``,
    ``host.frame``); ``key`` identifies the instance — for KV blocks
    ``(id(manager), physical_block)``, so two managers' block 7 never
    collide. The entry keeps the FIRST acquisition site (the
    steady-state re-acquire of a shared block pays no stack walk) and
    a live count; the entry dies when the count returns to zero."""

    def __init__(self) -> None:
        self._live: Dict[Tuple[str, object], _Entry] = {}
        self._violations: List[str] = []
        self._kv_gauge = [-1]

    # -- accounting ----------------------------------------------------
    def acquire(self, kind: str, key, site: Optional[str] = None,
                n: int = 1) -> None:
        with _state_mu:
            e = self._live.get((kind, key))
            if e is None:
                e = _Entry(site if site is not None else _site())
                self._live[(kind, key)] = e
            e.n += n
        if kind == "kv.block":
            self._push_kv_gauge()

    def release(self, kind: str, key, n: int = 1) -> None:
        """Drop ``n`` references. A release the ledger never saw
        acquired is recorded as a violation (it would drive a real
        refcount negative) rather than raised — the underlying
        operation already happened; ``leak_check`` surfaces it."""
        if not _chaos_hold():
            return  # chaos-deferred decrement: now visibly leaked
        with _state_mu:
            e = self._live.get((kind, key))
            if e is None or e.n < n:
                self._violations.append(
                    f"release without acquire: {kind} {key!r} at "
                    f"{_site()}")
                if e is not None:
                    del self._live[(kind, key)]
            else:
                e.n -= n
                if e.n == 0:
                    del self._live[(kind, key)]
        if kind == "kv.block":
            self._push_kv_gauge()

    # -- checks --------------------------------------------------------
    def outstanding(self, kind: Optional[str] = None
                    ) -> List[Tuple[str, object, int, str]]:
        """``(kind, key, live count, acquisition site)`` per entry."""
        with _state_mu:
            return sorted(
                (k, key, e.n, e.site)
                for (k, key), e in self._live.items()
                if kind is None or k == kind)

    def violation_count(self) -> int:
        with _state_mu:
            return len(self._violations)

    def leak_check(self, ignore: Tuple[str, ...] = ()) -> int:
        """Assert nothing is outstanding (``ignore`` skips kinds that
        legitimately live for the process — e.g. ``host.frame`` cache
        state at worker exit). Raises :class:`ResourceLeakError`
        naming every entry's acquisition site; returns 0 when clean."""
        leaks = [x for x in self.outstanding() if x[0] not in ignore]
        with _state_mu:
            viol = list(self._violations)
        if not leaks and not viol:
            return 0
        self._count_leaks(len(leaks) + len(viol))
        lines = [f"{len(leaks)} outstanding resource(s), "
                 f"{len(viol)} accounting violation(s):"]
        for kind, key, n, site in leaks:
            lines.append(
                f"  LEAKED {kind} {key!r} (live count {n}) — "
                f"acquired at {site}")
        lines.extend(f"  {v}" for v in viol)
        raise ResourceLeakError("\n".join(lines))

    def verify(self, manager) -> None:
        """Conservation against a live ``BlockManager``:
        ``free + live-referenced == total``, the ledger's per-block
        counts equal the manager's reference table exactly, and every
        block-table reference is backed by a live refcount."""
        acct = manager.accounting()
        if acct["free"] + len(acct["refs"]) != acct["total"]:
            raise ResourceLeakError(
                f"block conservation violated: {acct['free']} free + "
                f"{len(acct['refs'])} live != pool total "
                f"{acct['total']}")
        table_refs: Dict[int, int] = {}
        for blocks in acct["owned"].values():
            for b in blocks:
                table_refs[b] = table_refs.get(b, 0) + 1
        for b, c in table_refs.items():
            if acct["refs"].get(b, 0) < c:
                raise ResourceLeakError(
                    f"block {b} appears {c}x in block tables but "
                    f"holds {acct['refs'].get(b, 0)} refs")
        with _state_mu:
            mine = {key[1]: e.n for (k, key), e in self._live.items()
                    if k == "kv.block" and isinstance(key, tuple)
                    and key[0] == id(manager)}
        if mine != acct["refs"]:
            extra = {b: n for b, n in mine.items()
                     if acct["refs"].get(b) != n}
            missing = {b: n for b, n in acct["refs"].items()
                       if mine.get(b) != n}
            raise ResourceLeakError(
                "ledger refcounts diverge from the manager's table: "
                f"ledger-side {extra}, manager-side {missing}")

    def reset(self) -> None:
        with _state_mu:
            self._live.clear()
            self._violations.clear()

    # -- obs (lazy; absent/uninitialized registries are fine) ----------
    def _push_kv_gauge(self) -> None:
        with _state_mu:
            val = sum(1 for (k, _key) in self._live if k == "kv.block")
            if val == self._kv_gauge[0]:
                return
            self._kv_gauge[0] = val
        try:
            from ..obs.metrics import registry

            registry().gauge("kv_blocks_outstanding", {}).set(val)
        except Exception:
            pass

    @staticmethod
    def _count_leaks(n: int) -> None:
        try:
            from ..obs.metrics import registry

            registry().counter("resource_leaks_total", {}).inc(n)
        except Exception:
            pass


# -- BlockManager instrumentation -------------------------------------
_instrumented = [False]
_current: List[Optional[ResourceLedger]] = [None]
_real: Dict[str, object] = {}


def current() -> Optional[ResourceLedger]:
    """The active ledger (None when the sanitizer is off). Engine /
    host-tier constructors stamp this onto ``self._graft_ledger`` so
    per-request hooks gate on one attribute load."""
    return _current[0]


def _wrapped_init(real):
    def __init__(self, *a, **kw):
        real(self, *a, **kw)
        self._graft_ledger = _current[0]
    return __init__


def _wrapped_allocate(real):
    def allocate(self, seq_id, num_tokens):
        led = getattr(self, "_graft_ledger", None)
        if led is None:
            return real(self, seq_id, num_tokens)
        before = len(self._free)
        out = real(self, seq_id, num_tokens)
        n_new = before - len(self._free)
        if n_new > 0:
            site = _site()
            for b in out[len(out) - n_new:]:
                led.acquire("kv.block", (id(self), int(b)), site=site)
        return out
    return allocate


def _wrapped_adopt(real):
    def adopt(self, seq_id, blocks):
        led = getattr(self, "_graft_ledger", None)
        out = real(self, seq_id, blocks)
        if led is not None:
            site = _site()
            for b in blocks:
                led.acquire("kv.block", (id(self), int(b)), site=site)
        return out
    return adopt


def _wrapped_fork(real):
    def fork(self, seq_id, logical_index):
        led = getattr(self, "_graft_ledger", None)
        old, new = real(self, seq_id, logical_index)
        if led is not None and new != old:
            # one reference moved: the sequence's ref leaves `old`
            # and lands on the fresh private block
            led.acquire("kv.block", (id(self), int(new)), site=_site())
            led.release("kv.block", (id(self), int(old)))
        return old, new
    return fork


def _wrapped_ref(real):
    def ref(self, block):
        out = real(self, block)
        led = getattr(self, "_graft_ledger", None)
        if led is not None:
            led.acquire("kv.block", (id(self), int(block)))
        return out
    return ref


def _wrapped_release(real):
    def release(self, block):
        out = real(self, block)  # raises on dead blocks BEFORE we count
        led = getattr(self, "_graft_ledger", None)
        if led is not None:
            led.release("kv.block", (id(self), int(block)))
        return out
    return release


_WRAPPERS = {
    "__init__": _wrapped_init,
    "allocate": _wrapped_allocate,
    "adopt": _wrapped_adopt,
    "fork": _wrapped_fork,
    "ref": _wrapped_ref,
    "release": _wrapped_release,
}


def instrument_resources() -> ResourceLedger:
    """Install the ledger and wrap ``BlockManager``'s reference
    primitives; managers/engines/tiers constructed AFTER this call are
    stamped with the ledger. Idempotent — returns the active ledger."""
    if _instrumented[0]:
        return _current[0]
    from ..ops.paged_attention import BlockManager

    ledger = ResourceLedger()
    _current[0] = ledger
    for name, wrap in _WRAPPERS.items():
        real = BlockManager.__dict__[name]
        _real[name] = real
        setattr(BlockManager, name, wrap(real))
    _instrumented[0] = True
    try:
        from ..distributed.communication.flight_recorder import (
            register_dump_extra,
        )

        register_dump_extra(_dump_outstanding)
    except Exception:  # flight recorder optional at this layer
        pass
    return ledger


def uninstrument_resources() -> None:
    """Restore the real primitives and drop the ledger (managers
    stamped earlier keep their reference, but the restored methods no
    longer consult it)."""
    if not _instrumented[0]:
        return
    from ..ops.paged_attention import BlockManager

    for name, real in _real.items():
        setattr(BlockManager, name, real)
    _real.clear()
    _current[0] = None
    _instrumented[0] = False
    try:
        from ..distributed.communication.flight_recorder import (
            unregister_dump_extra,
        )

        unregister_dump_extra(_dump_outstanding)
    except Exception:
        pass


def _dump_outstanding(file) -> None:
    """flight_recorder dump extra: every outstanding resource and its
    acquisition site — a hung pod names what it never gave back."""
    led = _current[0]
    lines = ["", "-- graft-own: outstanding resources --"]
    if led is None:
        lines.append("(leak sanitizer off)")
    else:
        now = time.monotonic()
        with _state_mu:
            snap = [(k, key, e.n, e.site, now - e.t0)
                    for (k, key), e in sorted(
                        led._live.items(), key=lambda kv: str(kv[0]))]
        if not snap:
            lines.append("(nothing outstanding)")
        for k, key, n, site, age in snap[:200]:
            lines.append(f"  {k} {key!r} n={n} for {age:.3f}s "
                         f"(acquired at {site})")
        if len(snap) > 200:
            lines.append(f"  ... and {len(snap) - 200} more")
    file.write("\n".join(lines) + "\n")

