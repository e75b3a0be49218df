"""Self-healing supervision for the serving engine: crash-only
recovery without losing accepted work (counterpart of
``paddle_tpu/inference/supervisor.py``, copied over the port's engine;
the journal's records are the reference's, so either package replays
the other's journal).

On the card the engine's programs are CUDA graphs captured at their
first dispatches, and here those dispatches run on the supervisor's
step thread. Each capture runs under the model's execution lock, in
``thread_local`` capture mode (``jit.StaticFunction._capture``), so the
router's work on other threads cannot invalidate it, and a generation
abandoned mid-step (a hang) is fenced: its engine dispatches nothing
after the fence, so it cannot replay into buffers of a retired engine
that a replacement might still read.

A single hung or poison request must not take the serving loop down
with it. The recovery shape follows MegaScale-style in-flight health
checking plus crash-only design: detect a sick step fast (a watchdog
ladder over every ``engine.step()``, reusing the warn → stack-dump →
escalate pattern of ``CommWatchdog`` and the ``Deadline`` budget from
``utils/retries``), then REBUILD instead of untangling — tear the
engine down, construct a fresh one from the same factory, and requeue
every accepted-but-unfinished request. Greedy decoding makes requeued
survivors token-exact: the rebuilt engine reproduces their full output
from scratch, identical to an isolated ``generate()`` run.

Fault taxonomy (what :meth:`ServingSupervisor.step` does per outcome):

- **crash** — ``engine.step()`` raised. Recover in place: fence the old
  engine, rebuild, requeue. Every request in a slot at crash time is
  *blamed* (``retries`` += 1); one whose count exceeds
  ``max_request_retries`` is quarantined with ``status="poisoned"``
  instead of being requeued, so a deterministic engine-killer cannot
  crash-loop the service while healthy requests starve.
- **hang** — the step exceeded ``step_budget``. The stepping thread
  cannot be interrupted, so it is ABANDONED: the old engine is fenced
  (when the thread ever wakes, ``step()`` raises ``EngineFenced``
  before touching anything) and a fresh engine + runner take over.
  With ``escalate="exit"`` the supervisor instead dies loudly
  (``os._exit(124)``) for an external relaunch — the right mode when a
  hang means a wedged device rather than a wedged request.
- **kill / power loss** — the process is gone; in-process recovery is
  impossible by definition. With ``journal_dir`` set, every accepted
  submission and every completion is appended (fsync'd JSONL) to a
  journal; the relaunched supervisor replays it, restores finished
  results, and requeues the rest — accepted work survives the crash.

``health()`` returns a structured snapshot (supervisor state + the
engine's ``load()``) for routers and tests.
"""
from __future__ import annotations

import faulthandler
import json
import os
import sys
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import obs as _obs
from ..testing import chaos as _chaos
from ..utils.retries import Deadline
from .serving import GenRequest

__all__ = ["ServingSupervisor", "SupervisorGaveUp", "Journal"]


class SupervisorGaveUp(RuntimeError):
    """Too many consecutive failed recoveries — the fault is not a
    request, it is the engine/factory itself; surface it instead of
    crash-looping forever."""


class _StepRunner(threading.Thread):
    """Owns one engine generation. The supervisor triggers steps and
    waits under its own Deadline; a hung generation is abandoned (the
    thread parks itself once retired — or raises ``EngineFenced`` the
    moment the fenced engine is stepped again)."""

    def __init__(self, engine):
        super().__init__(name="paddle_tpu_torch_serving_step", daemon=True)
        self.engine = engine
        self._go = threading.Event()
        self._done = threading.Event()
        self._quit = False
        self.result: Optional[list] = None
        self.error: Optional[BaseException] = None
        self.start()

    def run(self):
        while True:
            # bounded poll so a retired runner always exits
            if not self._go.wait(timeout=0.25):
                if self._quit:
                    return
                continue
            self._go.clear()
            if self._quit:
                return
            try:
                self.result, self.error = self.engine.step(), None
            except BaseException as e:  # noqa: BLE001 — supervisor triages
                self.result, self.error = None, e
            self._done.set()

    def begin(self):
        self.result, self.error = None, None
        self._done.clear()
        self._go.set()

    def wait(self, timeout: float) -> bool:
        return self._done.wait(timeout=timeout)

    def retire(self):
        self._quit = True
        # wake the poll: the thread exits now, not at its next timeout
        self._go.set()


def _retire_all(runners: list) -> None:
    """A dropped supervisor's finalizer: its step threads exit instead of
    polling (and passing the lock sanitizer's chaos site) for the rest of
    the process."""
    for r in runners:
        r.retire()


class _Journal:
    """Append-only JSONL of accepted submissions and completions.
    Each record is flushed + fsync'd so an ``os._exit``-style death
    loses at most the record being written; replay tolerates a torn
    final line. ``compact()`` (run at every resume) rewrites the file
    to one record per live request — relaunch cost is bounded by the
    CURRENT workload, not the lifetime request history. Long-term
    retention of completed results beyond a relaunch cycle is the
    operator's policy, not the journal's. ``req_id``s must be
    JSON-serializable."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "serving-journal.jsonl")

    def replay(self) -> Tuple[Dict[object, dict], Dict[object, dict]]:
        pending: Dict[object, dict] = {}
        completed: Dict[object, dict] = {}
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except OSError:
            return pending, completed
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail from a mid-append death
            rid = rec.get("req_id")
            if rec.get("type") == "submit":
                pending[rid] = rec
            elif rec.get("type") == "complete":
                completed[rid] = rec
                pending.pop(rid, None)
        return pending, completed

    def compact(self, pending: Dict[object, dict],
                completed: Dict[object, dict]) -> None:
        """Atomically rewrite the journal from a replay result: drops
        torn lines, superseded duplicates, and any bloat a long first
        life accumulated."""
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w") as f:
                for rec in list(pending.values()) + list(completed.values()):
                    f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except OSError:
            # compaction is an optimization: the append-only file is
            # still the source of truth if the rewrite fails
            try:
                os.remove(tmp)
            except OSError:
                pass

    def _append(self, rec: dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def submit(self, req: GenRequest):
        # the deadline is journaled as an ABSOLUTE wall-clock expiry:
        # a relaunch grants the request only its REMAINING budget (a
        # client that timed out during the outage must not have full
        # prefill+decode tokens spent on it). Deadlines on virtual test
        # clocks serialize approximately — wall time is the only clock
        # two processes share.
        expires = None
        if req.deadline is not None and req.deadline.budget is not None:
            expires = time.time() + req.deadline.remaining()
        self._append({
            "type": "submit", "req_id": req.req_id,
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "priority": req.priority,
            "tenant": req.tenant,
            "deadline_unix": expires,
            # prior recoveries travel WITH the request: a cluster
            # router replaying this journal onto a surviving replica
            # must count engine deaths per request, not per replica
            "retries": int(req.retries),
        })

    def complete(self, req: GenRequest):
        self._append({
            "type": "complete", "req_id": req.req_id,
            "status": req.status, "out": [int(t) for t in req.out],
        })


class ServingSupervisor:
    """Run a :class:`ContinuousBatchingEngine` under a step watchdog
    with crash-only recovery.

    ``engine_factory`` is a zero-arg callable returning a fresh engine
    over the same model/config — recovery calls it again. Completed
    requests are harvested into ``results`` every step, so they survive
    any number of engine teardowns.
    """

    def __init__(self, engine_factory: Callable[[], object], *,
                 step_budget: Optional[float] = None,
                 warn_fraction: float = 0.5,
                 dump_fraction: float = 0.75,
                 dump_stacks: bool = True,
                 warmup_budget: Optional[float] = 120.0,
                 warmup_max_steps: int = 64,
                 max_request_retries: int = 2,
                 max_consecutive_failures: int = 8,
                 journal_dir: Optional[str] = None,
                 escalate: str = "rebuild"):
        if escalate not in ("rebuild", "exit"):
            raise ValueError("escalate must be 'rebuild' or 'exit'")
        if not 0.0 < warn_fraction <= dump_fraction <= 1.0:
            raise ValueError(
                "need 0 < warn_fraction <= dump_fraction <= 1")
        self._factory = engine_factory
        self.step_budget = None if step_budget is None else float(step_budget)
        self.warn_fraction = float(warn_fraction)
        self.dump_fraction = float(dump_fraction)
        self.dump_stacks = bool(dump_stacks)
        # until the engine reports ``warmed_up`` — every program
        # dispatched and captured — steps run under the roomy
        # ``warmup_budget`` instead of ``step_budget``: programs are
        # captured lazily at their first dispatches (chunked mode
        # captures decode many steps after step 1), warn/dump/hang
        # would misfire on legitimate capture latency, and each
        # recovery captures again so the cascade would be unrecoverable. The
        # warmup budget stays FINITE so a permanently wedged dispatch —
        # which also keeps the model's exec lock and therefore stalls
        # every replacement's first step — ends in SupervisorGaveUp
        # instead of an invisible deadlock; None opts into unbounded
        # warmup.
        self.warmup_budget = (None if warmup_budget is None
                              else float(warmup_budget))
        if (self.warmup_budget is not None and step_budget is not None
                and self.warmup_budget < float(step_budget)):
            self.warmup_budget = float(step_budget)
        # ...and the grace is itself bounded: a workload that never
        # dispatches some phase (max_new_tokens=1 never decodes) must
        # not leave hang detection at the roomy budget forever — after
        # warmup_max_steps GRANTS of the roomy budget per incarnation
        # the strict budget applies regardless
        self.warmup_max_steps = int(warmup_max_steps)
        self.max_request_retries = int(max_request_retries)
        self.max_consecutive_failures = int(max_consecutive_failures)
        self.escalate = escalate
        self.results: Dict[object, GenRequest] = {}
        self.poisoned_ids: List[object] = []
        self.restarts = 0
        # shed/expired counters accumulated from RETIRED engine
        # incarnations (each rebuild starts a fresh engine whose own
        # counters begin at zero; health() reports the running totals
        # so alerting never sees a reset at exactly the wrong moment)
        self._prior_shed = {"interactive": 0, "batch": 0}
        self._prior_expired = 0
        self.events: List[tuple] = []  # (kind, detail) observability log
        self._failures = 0  # consecutive recoveries without progress
        self._journaled_done: set = set()
        self.journal = None if journal_dir is None else _Journal(journal_dir)
        self.journaled_ids: set = set()
        # highest retries value journaled per id: lets a mailbox-fed
        # server distinguish a stale re-read of a consumed submission
        # (same retries — skip) from a router REQUEUE of work this
        # worker already served (router bumps retries — accept)
        self.journaled_retries: Dict[object, int] = {}
        # warmup-budget grants this incarnation (vs engine.steps: a
        # role engine's missing phase — e.g. a decode_only worker's
        # colocated-fallback prefill — can first compile long after
        # step warmup_max_steps, and must still get the compile grace)
        self._warmup_grants = 0
        self.engine = engine_factory()
        # every step thread this supervisor started; retired when the
        # supervisor is collected without close()
        self._runners: List[_StepRunner] = []
        weakref.finalize(self, _retire_all, self._runners)
        self._runner = self._new_runner()
        if self.journal is not None:
            self._resume_from_journal()

    # -- journal resume -------------------------------------------------
    def _resume_from_journal(self):
        pending, completed = self.journal.replay()
        self.journal.compact(pending, completed)
        self.journaled_ids = set(pending) | set(completed)
        for rid, rec in list(pending.items()) + list(completed.items()):
            self.journaled_retries[rid] = max(
                self.journaled_retries.get(rid, 0),
                int(rec.get("retries", 0)))
        for rid, rec in completed.items():
            req = GenRequest(rid, np.zeros(0, np.int32))
            req.status, req.out = rec.get("status", "ok"), rec.get("out", [])
            self.results[rid] = req
            self._journaled_done.add(rid)
            if req.status == "poisoned":
                self.poisoned_ids.append(rid)
        for rid, rec in pending.items():
            expires = rec.get("deadline_unix")
            remaining = None if expires is None else expires - time.time()
            req = GenRequest(
                rid, np.asarray(rec["prompt"], np.int32),
                int(rec["max_new_tokens"]),
                deadline=None if remaining is None else Deadline(remaining),
                priority=rec.get("priority", "interactive"),
                tenant=rec.get("tenant", "default"),
                retries=int(rec.get("retries", 0)))
            if remaining is not None and remaining <= 0:
                # the budget ran out during the outage: close it as
                # expired at zero token cost instead of serving a
                # client that already gave up
                req.status = "expired"
                self._finish(req)
                continue
            # accepted in a previous life: a relaunch must not re-run
            # admission control over work the front door already took
            self.engine.requeue(req)
        # requeue sheds work this engine can never serve (e.g. the
        # relaunch shrank the pool): close those journal entries now
        for r in self.engine.drain_shed():
            self._finish(r)
        if pending or completed:
            self.events.append(("resume", len(pending), len(completed)))

    # -- submission -----------------------------------------------------
    def submit(self, req_id, prompt, max_new_tokens: int = 32, *,
               deadline=None, priority: str = "interactive",
               retries: int = 0, trace=None,
               tenant: str = "default") -> GenRequest:
        """Front door: runs the engine's admission control. Shed
        submissions are recorded as results immediately; accepted ones
        are journaled (when journaling) so a crash cannot lose them.
        ``retries`` seeds the recovery counter for work resubmitted by
        a cluster router after another replica's death.

        The returned handle reflects the SUBMISSION (status at the
        front door, shed_reason). Do not poll it for completion across
        recoveries: a rebuild requeues detached clones, so the final
        state of every request lives in ``results`` / ``run()``'s
        return value, keyed by ``req_id``."""
        req = self.engine.add_request(
            req_id, prompt, max_new_tokens, deadline=deadline,
            priority=priority, retries=retries, trace=trace,
            tenant=tenant)
        self.journaled_ids.add(req_id)
        self.journaled_retries[req_id] = max(
            self.journaled_retries.get(req_id, 0), int(retries))
        if req.status != "shed" and self.journal is not None:
            self.journal.submit(req)
        # harvest every shed this submission caused: the request itself
        # and/or a queue-full displacement VICTIM that was accepted
        # earlier — victims never appear in a step() return, and
        # leaving their journal entry pending would make a relaunch
        # re-execute work the front door shed
        for r in self.engine.drain_shed():
            self._finish(r)
        return req

    def _finish(self, req: GenRequest):
        self.results[req.req_id] = req
        if self.journal is not None and req.req_id not in self._journaled_done:
            self._journaled_done.add(req.req_id)
            self.journal.complete(req)

    # -- disaggregated-serving hooks ------------------------------------
    def submit_imported(self, req: GenRequest) -> None:
        """Journal a request that entered the engine OUTSIDE the front
        door (a disagg KV import bypasses ``add_request``): a relaunch
        of this decode worker replays it and — the KV pages having died
        with the process — serves it by colocated re-prefill,
        token-exact. No-op without a journal."""
        self.journaled_ids.add(req.req_id)
        self.journaled_retries[req.req_id] = max(
            self.journaled_retries.get(req.req_id, 0), int(req.retries))
        if self.journal is not None:
            self.journal.submit(req)

    def mark_transferred(self, req: GenRequest) -> None:
        """Close a prefill-role request's journal entry once its KV
        handoff was ACKED: ownership moved to the decode pool, so a
        relaunch of THIS worker must not re-prefill it (the router's
        own table still covers a later decode-side death). Recorded as
        a ``complete`` with status "transferred" — routers treat that
        status as a baton pass, not a final result."""
        if self.journal is not None \
                and req.req_id not in self._journaled_done:
            self._journaled_done.add(req.req_id)
            was = req.status
            req.status = "transferred"
            self.journal.complete(req)
            req.status = was

    # -- the supervised loop --------------------------------------------
    @property
    def pending(self) -> bool:
        return bool(self.engine._queue or self.engine.num_active)

    def _step_budget(self):
        """Strict ``step_budget``, or ``warmup_budget`` while compiled
        phases are still missing. Counted in GRANTS, not engine steps:
        a role engine's missing phase (e.g. a decode_only worker's
        colocated-fallback prefill) can first compile thousands of
        steps in, and must still get the compile grace — while the
        grant cap keeps a permanently wedged dispatch escalating."""
        budget = self.step_budget
        if (budget is not None and not self.engine.warmed_up
                and self._warmup_grants < self.warmup_max_steps):
            self._warmup_grants += 1
            budget = self.warmup_budget
        return budget

    def step(self) -> list:
        """One supervised engine iteration: run ``engine.step()`` on
        the runner thread, escalate warn → dump → recover at fractions
        of ``step_budget`` (the CommWatchdog ladder under the step's
        Deadline), and triage any raise as an engine failure."""
        if not _chaos.inject("serving.loop"):
            return []  # dropped supervisor tick
        runner = self._runner
        budget = self._step_budget()
        dl = Deadline(budget)
        runner.begin()
        stages = ((self.warn_fraction, "warn"),
                  (self.dump_fraction, "dump"), (1.0, "hung"))
        si = 0
        finished = False
        while not finished:
            if budget is None:
                finished = runner.wait(timeout=dl.timeout(60.0))
                continue
            target = budget * stages[si][0]
            span = max(target - dl.elapsed(), 0.001)
            finished = runner.wait(timeout=span)
            if finished:
                break
            stage = stages[si][1]
            si += 1
            age = dl.elapsed()
            if stage == "warn":
                self._note("warn", f"step at {age:.3f}s of "
                                   f"{budget:.3f}s budget")
            elif stage == "dump":
                self._note("dump", f"step at {age:.3f}s — dumping stacks")
                if self.dump_stacks:
                    faulthandler.dump_traceback(
                        all_threads=True, file=sys.stderr)
                    # disagg: a decode-worker hang is only debuggable
                    # against the PREFILL side's schedule — with a
                    # handoff contract attached, the flight-recorder
                    # dump names BOTH roles' recorded schedules
                    try:
                        from ..distributed.communication import (
                            flight_recorder as _fr,
                        )

                        _fr.dump_on_watchdog(sys.stderr)
                    except Exception:  # noqa: BLE001 — diagnostics only
                        pass
            else:  # hung: the full budget elapsed
                self._note("hung", f"step exceeded its {budget:.3f}"
                                   "s budget")
                if self.escalate == "exit":
                    sys.stderr.write(
                        "ServingSupervisor: step hung; exiting 124 for "
                        "external relaunch\n")
                    sys.stderr.flush()
                    os._exit(124)
                return self._recover(reason="hang", exc=None)
        if runner.error is not None:
            return self._recover(reason="crash", exc=runner.error)
        self._failures = 0
        out = runner.result or []
        for r in out:
            self._finish(r)
        return out

    def run(self, max_steps: int = 100_000) -> Dict[object, GenRequest]:
        """Drive the engine until idle (or ``max_steps``); returns the
        harvested ``{req_id: GenRequest}`` across every engine
        incarnation — shed, expired, poisoned and ok alike."""
        while self.pending and max_steps > 0:
            self.step()
            max_steps -= 1
        # safety net: anything that completed outside a step() return
        # (e.g. shed between steps) still lands in the result map
        for r in self.engine.drain_shed():
            self._finish(r)
        for r in list(self.engine._completed.values()):
            if r.req_id not in self.results:
                self._finish(r)
        return dict(self.results)

    # -- recovery -------------------------------------------------------
    def _recover(self, *, reason: str, exc: Optional[BaseException]) -> list:
        eng = self.engine
        eng.fence()
        # snapshot the async pipeline's in-flight depth AT the fence:
        # entries dispatched but never harvested die with this engine —
        # their rows' requests are still visible in the slot snapshot
        # below (a slot stays bound until its tokens are harvested), so
        # the requeue replays them from scratch, token-exact; the depth
        # is recorded so operators can see a crash landed mid-pipeline
        inflight_dispatches = len(getattr(eng, "_ring", ()))
        self._runner.retire()
        self.restarts += 1
        self._failures += 1
        if self._failures > self.max_consecutive_failures:
            raise SupervisorGaveUp(
                f"{self._failures} consecutive failed recoveries "
                f"(last: {reason})") from exc
        # Iterate SNAPSHOTS throughout: a hang-path step thread may
        # still be finishing inside the old engine concurrently (the
        # fence stops it at the next checkpoint, not instantaneously),
        # and a live dict/slot must not be read while it mutates.
        # Snapshot order matters: queue first, slots second, completed
        # LAST — a request can only move forward (queue → slot →
        # completed), so this order can DUPLICATE a request mid-
        # transition but never lose one; duplicates are dropped below.
        queued_snap = list(eng._queue)
        inflight_snap = [r for r in [s.req for s in eng._slots]
                         if r is not None]
        # prefill-role engines park finished prefills handoff-ready
        # (out of both queue and slots) until the handoff layer drains
        # them: their KV dies with this engine, so they recover exactly
        # like in-flight work — requeued for a fresh prefill
        inflight_snap += list(getattr(eng, "_handoff_ready", {}).values())
        # harvest whatever completed before the fault (incl. shed and
        # expired requests only present in the engine's map)
        harvested = set()
        for req in list(eng._completed.values()):
            harvested.add(req.req_id)
            if req.req_id not in self.results:
                self._finish(req)
        # DETACH by cloning: the old engine (and a possibly-still-hung
        # step thread inside it) keeps its own request objects — any
        # late mutation lands on orphans, never on the requests the
        # replacement engine now owns
        inflight = [self._clone(r) for r in inflight_snap
                    if r.req_id not in harvested]
        inflight_ids = {r.req_id for r in inflight}
        queued = [self._clone(r) for r in queued_snap
                  if r.req_id not in harvested
                  and r.req_id not in inflight_ids]
        survivors = []
        for req in inflight:
            req.retries += 1
            if req.retries > self.max_request_retries:
                # this request was in a slot for every one of its
                # retries + 1 engine deaths: quarantine it
                req.status = "poisoned"
                self.poisoned_ids.append(req.req_id)
                self._finish(req)
            else:
                survivors.append(req)
        detail = (f"{reason}: restart #{self.restarts}, requeue "
                  f"{len(survivors)} in-flight + {len(queued)} queued, "
                  f"poisoned {len(inflight) - len(survivors)}")
        if inflight_dispatches:
            detail += (f", {inflight_dispatches} un-harvested pipeline "
                       "dispatch(es) dropped")
        if exc is not None:
            detail += f" ({exc!r})"
        self._note("recover", detail)
        for k, v in eng.n_shed.items():
            self._prior_shed[k] = self._prior_shed.get(k, 0) + v
        self._prior_expired += eng.n_expired
        self.engine = self._factory()
        self._runner = self._new_runner()
        self._warmup_grants = 0  # fresh incarnation: fresh compile grace
        for req in survivors:  # longest-waiting work first
            self.engine.requeue(req)
        for req in queued:
            self.engine.requeue(req)
        # requeue sheds work the rebuilt engine can never serve (a
        # factory whose config shrank) — close those out here: they
        # enter _completed between steps, so no step() would ever
        # return them
        for r in self.engine.drain_shed():
            self._finish(r)
        return []

    def _new_runner(self) -> _StepRunner:
        self._runners[:] = [r for r in self._runners if r.is_alive()]
        runner = _StepRunner(self.engine)
        self._runners.append(runner)
        return runner

    def close(self) -> None:
        """Retire the step thread and drop the engine, so its pools and
        captured graphs are freed once nothing else holds it (a replica
        that died or retired holds no device memory, as a dead process
        would not). ``results`` stay readable; nothing may step the
        supervisor afterwards."""
        runner = self._runner
        if runner is not None:
            runner.retire()
            runner.engine = None
        self._runner = None
        self.engine = None

    @staticmethod
    def _clone(req: GenRequest) -> GenRequest:
        """A fresh GenRequest carrying the submission (identity, prompt,
        budget, class, retry count) but none of the old engine's
        generation state — ``requeue`` resets that anyway; what matters
        is the fresh OBJECT, so the orphaned engine cannot reach it."""
        return GenRequest(
            req.req_id, req.prompt, req.max_new_tokens,
            deadline=req.deadline, t_submit=req.t_submit,
            priority=req.priority, retries=req.retries,
            clamped=req.clamped, tenant=req.tenant,
            trace_id=req.trace_id, span_id=req.span_id)

    def _note(self, kind: str, detail: str):
        self.events.append((kind, detail))
        # watchdog/recovery escalations land on the obs timeline as
        # instant events beside the request spans
        _obs.instant(f"supervisor_{kind}", tid="supervisor",
                     detail=detail)
        if kind in ("warn", "dump", "hung"):
            sys.stderr.write(f"ServingSupervisor: {detail}\n")

    # -- health surface -------------------------------------------------
    def health(self) -> dict:
        """Structured snapshot for routers/probes: supervisor state,
        restart/poison counts, and the live engine load signal. Wrapped
        in the shared, registry-sourced :func:`~..obs
        .health_envelope` (``schema_version``/``kind``/...), so every
        health() surface carries the same top-level keys."""
        status_counts: Dict[str, int] = {}
        for r in self.results.values():
            status_counts[r.status] = status_counts.get(r.status, 0) + 1
        eng = self.engine
        return _obs.health_envelope("supervisor", {
            "state": "serving" if self.pending else "idle",
            "restarts": self.restarts,
            "consecutive_failures": self._failures,
            "poisoned": list(self.poisoned_ids),
            "completed": status_counts,
            "step_budget_s": self.step_budget,
            "last_step_s": eng.last_step_s,
            "journaling": self.journal is not None,
            # running totals across every engine incarnation (the
            # current engine's load() counters restart at each rebuild)
            "total_shed": {
                k: self._prior_shed.get(k, 0) + eng.n_shed.get(k, 0)
                for k in set(self._prior_shed) | set(eng.n_shed)},
            "total_expired": self._prior_expired + eng.n_expired,
            "load": eng.load().as_dict(),
            # async-pipeline occupancy: zeros/disabled on
            # engines without the overlap machinery
            "overlap": (eng.overlap_stats()
                        if hasattr(eng, "overlap_stats")
                        else {"enabled": False}),
            # per-tenant SLO view: one hot tenant's pain is
            # visible here instead of averaged into the fleet totals
            "tenants": _obs.tenant_slo_table(),
        })


# Public alias: the cluster router (inference/cluster.py) replays a dead
# replica's journal through the same reader/compactor the in-process
# resume path uses — one journal format, two recovery scopes.
Journal = _Journal
