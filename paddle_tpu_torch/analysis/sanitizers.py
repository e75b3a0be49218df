"""Counterpart of ``paddle_tpu/analysis/sanitizers.py``, holding only the
exception the collective flight recorder's ``contract`` raises."""
from __future__ import annotations

__all__ = ["CollectiveScheduleMismatch"]


class CollectiveScheduleMismatch(AssertionError):
    """Two ranks recorded different collective schedules — the
    runtime-confirmed COLL002 deadlock shape. The message names every
    rank's last-N recorded schedule and the first diverging entry."""
