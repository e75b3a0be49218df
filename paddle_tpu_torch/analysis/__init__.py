"""Runtime sanitizers (counterpart of ``paddle_tpu/analysis``). Only
:class:`~.sanitizers.CollectiveScheduleMismatch` is ported so far: the
flight recorder's ``contract`` raises it. The static rules and the rest
of the sanitizers are a later slice."""
from .sanitizers import CollectiveScheduleMismatch

__all__ = ["CollectiveScheduleMismatch"]
