"""Counterpart of ``paddle_tpu/utils/retries.py``, copied: the port keeps
its own copy of this stdlib-only module.

Deadline budgets + retry policies — the shared fault-tolerance layer.

Every blocking surface in the framework (bench supervisor, TCP KV
store, comm watchdog, elastic manager, serving engine) used to carry
its own hardcoded timeout; a single hung operation could then outlive
the caller's window (BENCH_r05: one 1800s attempt timeout ate the whole
benchmark capture). This module replaces those ad-hoc constants with one
audited discipline:

- :class:`Deadline` — an ABSOLUTE wall-clock budget. Built-in consumers
  (bench supervisor, store, watchdog, elastic, serving) each receive a
  whole Deadline and bound every blocking step against it; CALLERS
  dividing one job budget across phases carve slices with ``sub()``
  (which inherits the parent's clock and can never outlive it), e.g.
  ``register(deadline=job.sub(fraction=0.25))``.
- :class:`RetryPolicy` — exponential backoff with optional
  deterministic jitter and a transient-vs-fatal classifier, bounded by
  a Deadline: retrying never extends past the budget.
- :func:`classify_text` — the shared infrastructure-error taxonomy
  (backend bring-up failures, connection loss, gRPC UNAVAILABLE) used
  by the bench supervisor and anything else that classifies stderr.

Intentionally stdlib-only: ``bench.py``'s supervisor loads this file by
path before any framework/JAX import so a broken backend can never take
the retry layer down with it.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Iterable, Optional, Tuple

__all__ = [
    "BudgetExceeded",
    "Deadline",
    "RetryPolicy",
    "classify_text",
    "TRANSIENT_PATTERNS",
    "FATAL_OVERRIDES",
]


class BudgetExceeded(TimeoutError):
    """A Deadline ran out (subclass of TimeoutError/OSError so existing
    ``except OSError`` / ``except TimeoutError`` handlers keep working)."""


def _now(clock) -> float:
    """Clock values: a plain callable (time.monotonic) or an object with
    ``now()`` (e.g. testing.chaos.ChaosClock)."""
    now = getattr(clock, "now", None)
    return now() if now is not None else clock()


class Deadline:
    """Absolute wall-clock budget that nested operations split/inherit.

    ``Deadline(None)`` is unbounded (remaining() == inf, never expires);
    every bounded deadline records its original ``budget`` so callers
    can reason in fractions (the watchdog ladder fires at fractions of
    the wait's deadline). ``clock`` is injectable for deterministic
    chaos tests.
    """

    __slots__ = ("budget", "_start", "_end", "_clock", "parent")

    def __init__(self, seconds: Optional[float] = None, *, clock=None,
                 parent: Optional["Deadline"] = None):
        self._clock = clock if clock is not None else (
            parent._clock if parent is not None else time.monotonic
        )
        self._start = _now(self._clock)
        self.budget = None if seconds is None else max(0.0, float(seconds))
        self._end = None if self.budget is None else self._start + self.budget
        self.parent = parent

    # -- constructors ---------------------------------------------------
    @classmethod
    def unbounded(cls, *, clock=None) -> "Deadline":
        return cls(None, clock=clock)

    @classmethod
    def coerce(cls, value, *, clock=None) -> "Deadline":
        """None → unbounded; a number → Deadline(seconds); a Deadline
        passes through (so APIs accept either)."""
        if value is None:
            return cls(None, clock=clock)
        if isinstance(value, Deadline):
            return value
        return cls(float(value), clock=clock)

    # -- queries --------------------------------------------------------
    def remaining(self) -> float:
        if self._end is None:
            return float("inf")
        return max(0.0, self._end - _now(self._clock))

    def elapsed(self) -> float:
        return _now(self._clock) - self._start

    def expired(self) -> bool:
        return self._end is not None and _now(self._clock) >= self._end

    def fraction_consumed(self) -> float:
        """elapsed/budget in [0, inf); 0.0 for unbounded deadlines."""
        if self.budget is None:
            return 0.0
        if self.budget <= 0.0:
            return float("inf")
        return self.elapsed() / self.budget

    def timeout(self, default: Optional[float] = None,
                floor: float = 0.0) -> Optional[float]:
        """A value usable as a socket/subprocess timeout: the smaller of
        ``default`` and the remaining budget (never below ``floor``).
        Returns None (block forever) only when both are unbounded."""
        if self._end is None:
            return default
        rem = self.remaining()
        if default is not None:
            rem = min(rem, float(default))
        return max(float(floor), rem)

    def check(self, what: str = "operation") -> None:
        if self.expired():
            raise BudgetExceeded(
                f"{what} exceeded its deadline "
                f"({self.budget:.3f}s budget, {self.elapsed():.3f}s elapsed)"
            )

    # -- splitting ------------------------------------------------------
    def sub(self, seconds: Optional[float] = None,
            fraction: Optional[float] = None) -> "Deadline":
        """A child deadline capped by this one. ``fraction`` takes that
        share of the REMAINING budget; ``seconds`` asks for an absolute
        slice (still clipped to the parent). With neither, the child
        simply mirrors the parent's remaining budget."""
        rem = self.remaining()
        if fraction is not None:
            want = None if rem == float("inf") else rem * float(fraction)
        else:
            want = seconds
        if rem == float("inf"):
            budget = want
        else:
            budget = rem if want is None else min(float(want), rem)
        return Deadline(budget, clock=self._clock, parent=self)

    def sleep(self, seconds: float) -> float:
        """Sleep min(seconds, remaining); returns the time actually
        slept. Uses the clock's own ``sleep`` when it has one (chaos
        clocks advance virtually)."""
        span = min(float(seconds), self.remaining())
        if span <= 0:
            return 0.0
        sleeper = getattr(self._clock, "sleep", time.sleep)
        sleeper(span)
        return span

    def __repr__(self):
        if self.budget is None:
            return "Deadline(unbounded)"
        return (f"Deadline(budget={self.budget:.3f}s, "
                f"remaining={self.remaining():.3f}s)")


# ---------------------------------------------------------------------------
# Transient-vs-fatal classification (shared with bench.py's supervisor).
# lowercase substrings marking a failure as transient infrastructure
# (worth retrying) rather than a real bug in the caller or framework.
TRANSIENT_PATTERNS: Tuple[str, ...] = (
    "unable to initialize backend",
    "failed to connect",
    "connection refused",
    "connection reset",
    "broken pipe",
    "socket closed",
    "unavailable:",  # gRPC status prefix ("UNAVAILABLE: ..."), not the
    # bare word — a traceback merely containing "unavailable" is a bug
    "deadline exceeded",
    "grant unclaimed",
)

# checked BEFORE the transient list: these ride inside "Unable to
# initialize backend ..." messages but mean the backend plugin was never
# registered in this process — no retry can fix that
FATAL_OVERRIDES: Tuple[str, ...] = ("not in the list of known backends",)


def classify_text(text: str) -> str:
    """'transient' | 'fatal' for a stderr/exception string."""
    t = (text or "").lower()
    if any(p in t for p in FATAL_OVERRIDES):
        return "fatal"
    if any(p in t for p in TRANSIENT_PATTERNS):
        return "transient"
    return "fatal"


class RetryPolicy:
    """Exponential backoff + jitter + transient classification, bounded
    by a Deadline.

    ``transient`` is the exception classifier: a tuple of exception
    types, or a callable ``exc -> bool``. ``seed`` makes the jitter
    stream deterministic (chaos tests); ``sleep`` is injectable the same
    way. ConnectionResetError raised with a fatal message still counts
    as transient — types win over text for exceptions; ``classify_text``
    is for subprocess stderr where only text survives.
    """

    def __init__(
        self,
        max_attempts: int = 5,
        base_delay: float = 0.5,
        max_delay: float = 30.0,
        multiplier: float = 2.0,
        jitter: float = 0.0,
        transient=(ConnectionError, TimeoutError, InterruptedError),
        seed: Optional[int] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self._transient = transient
        self._rng = random.Random(seed)
        self._sleep = sleep

    def is_transient(self, exc: BaseException) -> bool:
        if callable(self._transient) and not isinstance(self._transient,
                                                        (tuple, type)):
            return bool(self._transient(exc))
        return isinstance(exc, self._transient)

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based: the delay
        after the attempt-th failure)."""
        d = min(self.base_delay * self.multiplier ** (attempt - 1),
                self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * self._rng.random()
        return d

    def delays(self) -> Iterable[float]:
        for attempt in range(1, self.max_attempts):
            yield self.delay(attempt)

    def call(self, fn: Callable, *args, deadline: Optional[Deadline] = None,
             describe: str = "", **kw):
        """Run ``fn`` with retries on transient errors; never past the
        deadline. Fatal errors propagate immediately; exhaustion
        re-raises the last transient error (chained under
        BudgetExceeded when the budget, not the attempt count, ran out).
        """
        dl = Deadline.coerce(deadline)
        what = describe or getattr(fn, "__name__", "operation")
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            if dl.expired():
                break
            try:
                return fn(*args, **kw)
            except BaseException as e:  # noqa: BLE001 — reclassified below
                if not self.is_transient(e):
                    raise
                last = e
                if attempt >= self.max_attempts:
                    break
                # backoff through the policy's own sleeper (injectable),
                # clamped so it can never outlive the deadline
                span = min(self.delay(attempt), dl.remaining())
                if span > 0:
                    self._sleep(span)
                elif dl.expired():
                    break
        if last is not None and not dl.expired():
            raise last
        raise BudgetExceeded(
            f"{what} did not succeed within its deadline "
            f"({dl.elapsed():.3f}s elapsed, last error: {last!r})"
        ) from last
