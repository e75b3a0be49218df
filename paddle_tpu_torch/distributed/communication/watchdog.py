"""Collective watchdog (counterpart of
``paddle_tpu/distributed/communication/watchdog.py``, copied over the port's
``base.flags``, ``utils.retries`` and ``utils.log``).

Redesign of the reference's comm-task watchdog (ref:
paddle/fluid/distributed/collective/process_group_nccl.cc NCCL watchdog
thread; common/flags.cc FLAGS_pg_timeout): a daemon watches each blocking
host wait the port makes on a collective (a sync collective's call, a
task's ``wait()``, a ``barrier``) and escalates it up an ACTION LADDER at
fractions of its deadline (``FLAGS comm_timeout_s``):

  1. **warn** at ``FLAGS comm_warn_fraction`` (default 0.5) — a log line
     naming the wait, so a slow-but-alive peer shows up in logs long
     before teardown;
  2. **dump** at ``FLAGS comm_dump_fraction`` (default 0.75) — an
     all-thread stack dump and the flight recorder's last collective
     signatures (with a schedule diff when a contract store is attached),
     while the process is still alive to dump them;
  3. **abort** at 1.0 — if ``FLAGS comm_abort_on_timeout`` is set,
     ``os._exit(124)`` so the launcher relaunches the job.

Every collective of ``distributed.communication`` runs its host wait under
:func:`watch`.
"""
from __future__ import annotations

import faulthandler
import itertools
import os
import sys
import threading
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Tuple

from ...base import flags as _flags
from ...utils.retries import Deadline

_EXIT_CODE = 124  # conventional timeout exit; elastic treats any death as a scale event

# ladder stages in escalation order: (name, fraction-flag); abort always
# fires at the full deadline
_STAGES = (("warn", "comm_warn_fraction"), ("dump", "comm_dump_fraction"),
           ("abort", None))


class CommWatchdog:
    """Singleton daemon watching registered host-side collective waits."""

    _instance: Optional["CommWatchdog"] = None
    _lock = threading.Lock()

    def __init__(self):
        # wid -> (description, Deadline); the Deadline is fixed at
        # watch() entry so a mid-wait flag change cannot un-expire it
        self._waits: Dict[int, Tuple[str, Deadline]] = {}
        self._ids = itertools.count()
        self._mu = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._kick = threading.Event()  # wakes the daemon on new registrations
        self._stage_reached: Dict[int, int] = {}  # wid -> ladder index
        # test seams: _on_timeout replaces the dump+abort actions (abort
        # stage routes to it); _on_stage observes/replaces EVERY stage
        self._on_timeout: Optional[Callable[[str, float], None]] = None
        self._on_stage: Optional[Callable[[str, str, float], None]] = None

    @classmethod
    def instance(cls) -> "CommWatchdog":
        with cls._lock:
            if cls._instance is None:
                cls._instance = CommWatchdog()
            return cls._instance

    # -- registration --------------------------------------------------
    @contextmanager
    def watch(self, desc: str, deadline: Optional[Deadline] = None):
        """Run a blocking wait under watchdog supervision. The wait's
        budget is ``deadline`` (when the caller already has one) or a
        fresh Deadline of ``FLAGS comm_timeout_s``."""
        wid = next(self._ids)
        dl = deadline if deadline is not None else Deadline(
            float(_flags.flag("comm_timeout_s")))
        with self._mu:
            self._waits[wid] = (desc, dl)
        self._ensure_thread()
        self._kick.set()  # re-evaluate the poll interval for this wait
        try:
            yield dl
        finally:
            with self._mu:
                self._waits.pop(wid, None)
                self._stage_reached.pop(wid, None)

    # -- daemon --------------------------------------------------------
    def _ensure_thread(self):
        with self._mu:  # two first-waiters racing here must not fork two daemons
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="paddle_tpu_comm_watchdog", daemon=True
                )
                self._thread.start()

    def _fractions(self):
        # clamp to [0, 1]: a fraction flag set past 1.0 must not gate
        # the ABORT stage behind an unreachable threshold (the ladder
        # escalates in order, so an unreachable early stage would
        # silently disable the relaunch safety net)
        fr = []
        for _name, flag in _STAGES:
            fr.append(1.0 if flag is None
                      else min(max(float(_flags.flag(flag)), 0.0), 1.0))
        return fr

    def _poll_interval(self) -> float:
        # resolve the smallest gap between ladder stages, not just the
        # final deadline (warn at 0.5x needs finer polling than x/4),
        # against the SHORTEST registered budget — a caller-supplied
        # 0.2s Deadline under an hours-long flag still gets fine polls
        timeout = float(_flags.flag("comm_timeout_s"))
        with self._mu:
            budgets = [dl.budget for _, dl in self._waits.values()
                       if dl.budget is not None]
        ref = min(budgets + [timeout])
        fracs = sorted(set(self._fractions()))
        gap = min([fracs[0]] + [b - a for a, b in zip(fracs, fracs[1:])])
        return max(0.02, min(5.0, ref * max(gap, 0.125) / 2.0))

    def _run(self):
        while not self._stop.is_set():
            self._kick.wait(self._poll_interval())
            self._kick.clear()
            if self._stop.is_set():
                break
            fracs = self._fractions()
            fired = []
            with self._mu:
                for wid, (desc, dl) in self._waits.items():
                    consumed = dl.fraction_consumed()
                    reached = self._stage_reached.get(wid, 0)
                    # escalate through every stage the wait has crossed
                    # (a long poll gap must not skip the dump)
                    while (reached < len(_STAGES)
                           and consumed >= fracs[reached]):
                        fired.append((_STAGES[reached][0], desc,
                                      dl.elapsed()))
                        reached += 1
                        self._stage_reached[wid] = reached
            for stage, desc, age in fired:
                self._fire(stage, desc, age)

    def _fire(self, stage: str, desc: str, age: float):
        if self._on_stage is not None:
            self._on_stage(stage, desc, age)
            return
        if stage == "abort" and self._on_timeout is not None:
            self._on_timeout(desc, age)
            return
        from ...utils import log as _log

        if stage == "warn":
            if self._on_timeout is not None:
                return  # the seam replaces ALL real actions, warn included
            msg = (
                f"CommWatchdog: wait '{desc}' has consumed "
                f"{float(_flags.flag('comm_warn_fraction')):.0%} of its "
                f"deadline ({age:.1f}s); a peer host may be slow or dead."
            )
            _log.warning(msg)
            sys.stderr.write(msg + "\n")
        elif stage == "dump":
            if self._on_timeout is not None:
                return  # seam replaces the dump+abort actions
            msg = (
                f"CommWatchdog: wait '{desc}' at "
                f"{float(_flags.flag('comm_dump_fraction')):.0%} of its "
                f"deadline ({age:.1f}s) — dumping all-thread stacks."
            )
            _log.warning(msg)
            sys.stderr.write(msg + "\n")
            faulthandler.dump_traceback(all_threads=True, file=sys.stderr)
            # the analogue of the reference dumping its comm trace
            # buffer: the last-N collective signatures this rank issued
            # (and, when a contract store is attached, a schedule diff
            # against every peer that published) — a real cross-rank
            # hang yields a SCHEDULE DIFF, not just stacks
            try:
                from .flight_recorder import dump_on_watchdog

                dump_on_watchdog(sys.stderr)
            except Exception:  # noqa: BLE001 — diagnostics must not raise
                pass
        elif stage == "abort":
            msg = (
                f"CommWatchdog: wait '{desc}' exceeded its deadline "
                f"({age:.1f}s); a peer host is likely dead or the device "
                "hung."
            )
            _log.warning(msg)
            sys.stderr.write(msg + "\n")
            if bool(_flags.flag("comm_abort_on_timeout")):
                sys.stderr.write(
                    f"CommWatchdog: aborting (exit {_EXIT_CODE}) for relaunch\n"
                )
                sys.stderr.flush()
                os._exit(_EXIT_CODE)

    def stop(self):
        self._stop.set()
        self._kick.set()
        # `_thread` is guarded by `_mu` (see _ensure_thread): take the
        # handoff under the lock so a stop() racing a watch() cannot
        # observe a half-installed daemon — but join OUTSIDE it, since
        # the daemon itself takes `_mu` in _poll_interval and would
        # stall the join until its timeout
        with self._mu:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=1.0)


def watch(desc: str, deadline: Optional[Deadline] = None):
    """Context manager: supervise a blocking wait (module-level sugar)."""
    return CommWatchdog.instance().watch(desc, deadline)
