"""Counterpart of ``paddle_tpu/analysis/sanitizers.py``: the exception the
collective flight recorder's ``contract`` raises, ``collective_contract``
(the recorder's cross-rank schedule check), and the runtime sanitizers
re-exported lazily from ``utils/``.

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

__all__ = ["CollectiveScheduleMismatch", "collective_contract", "LockOrderViolation", "TracedLock",
           "instrument_locks", "uninstrument_locks", "ResourceLeakError",
           "ResourceLedger", "instrument_resources", "uninstrument_resources"]

_LOCK_SANITIZER_API = ("LockOrderViolation", "TracedLock",
                       "instrument_locks", "uninstrument_locks")
_LEAK_SANITIZER_API = ("ResourceLeakError", "ResourceLedger",
                       "instrument_resources", "uninstrument_resources")


def collective_contract(store, rank, world_size, *, last_n=32,
                        deadline=None, recorder=None, tag="default"):
    """Cross-check the collective flight recorder's schedule against every
    peer through ``store`` (``distributed.store``'s KV stores). Raises
    :class:`CollectiveScheduleMismatch` on divergence; returns the per-rank
    schedules on agreement. Every rank calls it the same number of times
    (it is itself a synchronization point); ``deadline`` bounds the wait
    for the peers' schedules (default 30 s)."""
    from ..distributed.communication import flight_recorder as _fr

    return _fr.contract(store, rank, world_size, last_n=last_n,
                        deadline=deadline, recorder_=recorder, tag=tag)


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
