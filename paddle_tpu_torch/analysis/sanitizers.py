"""Counterpart of ``paddle_tpu/analysis/sanitizers.py``: the exception the
collective flight recorder's ``contract`` raises, and the runtime
sanitizers re-exported lazily from ``utils/``.

The lock-order sanitizer lives in ``paddle_tpu_torch/utils/locks.py``:
:class:`TracedLock` records per-thread held-lock sets and acquisition
sites, keeps the runtime lock-order graph, and raises
:class:`LockOrderViolation` naming both stacks the moment two locks are
taken in inverted order; :func:`instrument_locks` patches the
``threading.Lock``/``RLock`` factories so a whole process runs under it.
The resource-leak sanitizer lives in ``paddle_tpu_torch/utils/
resources.py`` (:class:`ResourceLedger`, :func:`instrument_resources`).
"""
from __future__ import annotations

__all__ = ["CollectiveScheduleMismatch", "LockOrderViolation", "TracedLock",
           "instrument_locks", "uninstrument_locks", "ResourceLeakError",
           "ResourceLedger", "instrument_resources", "uninstrument_resources"]

_LOCK_SANITIZER_API = ("LockOrderViolation", "TracedLock",
                       "instrument_locks", "uninstrument_locks")
_LEAK_SANITIZER_API = ("ResourceLeakError", "ResourceLedger",
                       "instrument_resources", "uninstrument_resources")


def __getattr__(name: str):
    # the runtime sanitizers live in utils/ (stdlib-only, usable without
    # the analysis package); re-exported lazily so importing one never
    # drags the other in
    if name in _LOCK_SANITIZER_API:
        from ..utils import locks as _locks

        return getattr(_locks, name)
    if name in _LEAK_SANITIZER_API:
        from ..utils import resources as _resources

        return getattr(_resources, name)
    raise AttributeError(name)


class CollectiveScheduleMismatch(AssertionError):
    """Two ranks recorded different collective schedules — the
    runtime-confirmed COLL002 deadlock shape. The message names every
    rank's last-N recorded schedule and the first diverging entry."""
