"""Cluster serving: a replica router with prefix-cache-aware scheduling
(counterpart of ``paddle_tpu/inference/cluster.py``, copied over the
port's supervisor, engine and stores; the wire records are the
reference's). A replica's serve loop ticks the process's alert rules at
the cadence it publishes its registry.

One :class:`~.serving.ContinuousBatchingEngine` is
deep but narrow — "millions of users" means a FLEET of engine replicas
(one per chip/host) behind a router. This module is that router plus
the two replica transports it fronts:

- :class:`InProcessReplica` — a :class:`ServingSupervisor` in this
  process (the bench / single-host shape; also the unit-test harness
  for the routing and recovery logic).
- :class:`ProcessReplica` + :class:`ReplicaServer` — a REAL process
  boundary over the existing
  :class:`~..distributed.store.TCPKVStore`: the router mails
  request records into the store, the replica worker
  (:class:`ReplicaServer`, run in its own process like the
  ``_mc_worker`` machinery runs trainers) polls them into its local
  supervisor, serves, and mails results + a live load snapshot +
  heartbeats back.

Placement (:meth:`ClusterRouter.route`) scores every live replica from
the SAME :class:`~.admission.EngineLoad` signal the
admission controller uses — queue pressure, KV-block occupancy,
token-backlog-derived queueing delay, step-latency EWMA — minus an
AFFINITY bonus with two sources:

- **session affinity**: a request carrying ``session=`` is pulled
  toward the replica that last served that session (its KV/prefix
  state lives there);
- **prefix affinity**: the router keeps a per-replica radix tree
  (matcher-mode :class:`~..ops.paged_attention.PrefixCache`)
  over the BLOCK-ALIGNED token prefixes it has routed; a prompt whose
  prefix a replica has already seen scores toward that replica, where
  the engine-side prefix cache (ref-counted copy-on-write KV blocks)
  turns the affinity into actual skipped prefill work. Routing
  prefix-blind would halve the hit rate at 2 replicas — affinity is
  what makes per-replica caches compose into a cluster-level cache.

Failure handling is replica-level crash-only recovery, the
:class:`ServingSupervisor` design one level up: a replica that stops
heartbeating / whose process died is never repaired in place. Its
fsync'd journal is replayed + compacted (the same
:class:`~.supervisor.Journal` format the
in-process resume uses), completed work is harvested, and every
accepted-but-unfinished request requeues onto the SURVIVORS —
token-exact under greedy decode, deadlines carrying only the remaining
wall-clock budget. Poison quarantine stays per REQUEST: a request whose
replica died more than ``max_request_retries`` times is quarantined
(``status="poisoned"``) instead of being allowed to hunt the fleet.

Chaos site ``cluster.route`` (a ``drop`` fault) deterministically
MISROUTES a placement to the next live replica — correctness (token
exactness, completion) must never depend on the scorer's choice, only
efficiency may.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .. import obs as _obs
from ..obs import agg as _obs_agg
from ..ops.paged_attention import PrefixCache
from ..testing import chaos as _chaos
from ..utils.retries import Deadline
from .serving import GenRequest  # noqa: F401  (result/record contract)
from .supervisor import Journal, ServingSupervisor

__all__ = [
    "ClusterRouter",
    "InProcessReplica",
    "ProcessReplica",
    "ReplicaServer",
    "NoLiveReplica",
]


class NoLiveReplica(RuntimeError):
    """Every replica is dead or excluded — nothing can take the work."""


def make_record(req_id, prompt, max_new_tokens: int = 32, *,
                deadline=None, priority: str = "interactive",
                session: Optional[str] = None, retries: int = 0,
                trace=None, tenant: str = "default") -> dict:
    """The wire/journal-compatible request record. The deadline is
    carried as an ABSOLUTE unix expiry (wall time is the only clock two
    processes share) so every hop — router -> store -> replica ->
    journal -> requeue — grants only the REMAINING budget. ``trace``
    (a ``{"trace_id", "span_id"}`` dict or anything
    :func:`~..obs.trace_ctx` accepts) rides the record so the
    receiving worker's spans parent under the submitter's."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    expires = None
    if deadline is not None:
        dl = Deadline.coerce(deadline)
        if dl.budget is not None:
            expires = time.time() + dl.remaining()
    return {
        "req_id": req_id,
        "prompt": [int(t) for t in prompt],
        "max_new_tokens": int(max_new_tokens),
        "priority": priority,
        "tenant": str(tenant),
        "deadline_unix": expires,
        "session": session,
        "retries": int(retries),
        "trace": _obs.trace_ctx(trace),
    }


def _remaining_budget(rec: dict) -> Optional[float]:
    """None = unbounded; <= 0 = already expired."""
    expires = rec.get("deadline_unix")
    return None if expires is None else expires - time.time()


def _result(req_id, status: str, out=(), **extra) -> dict:
    rec = {"req_id": req_id, "status": status,
           "out": [int(t) for t in out]}
    rec.update(extra)
    return rec


# the disagg handoff router (inference/disagg.py) speaks the same
# record/result/remaining-budget wire contract — one format from the
# cluster router through the journal to the prefill/decode pools
result_record = _result
remaining_budget = _remaining_budget


# ---------------------------------------------------------------------------
# Replica transports


class InProcessReplica:
    """A supervised engine in THIS process. ``journal_dir`` makes its
    accepted work recoverable by the router exactly like a process
    replica's; ``kill()`` is the fault hook tests/operators use to take
    it out of rotation (the router then runs journal recovery). A killed
    or stopped replica drops its engine (``ServingSupervisor.close``), so
    its KV pools and captured graphs are freed as a dead process's would
    be; its harvested results stay readable."""

    def __init__(self, replica_id: str, engine_factory, *,
                 journal_dir: Optional[str] = None, **supervisor_kwargs):
        self.replica_id = str(replica_id)
        self.journal_dir = journal_dir
        self.supervisor = ServingSupervisor(
            engine_factory, journal_dir=journal_dir, **supervisor_kwargs)
        self._dead = False
        self._published: Set = set()

    def alive(self) -> bool:
        return not self._dead

    def kill(self) -> None:
        """Simulate replica death: no further pumps; pending work is
        recovered by the router from the journal / its routing table."""
        self._dead = True
        self.supervisor.close()

    def submit(self, rec: dict) -> None:
        self.supervisor.submit(
            rec["req_id"], np.asarray(rec["prompt"], np.int32),
            int(rec["max_new_tokens"]),
            deadline=_remaining_budget(rec),
            priority=rec.get("priority", "interactive"),
            retries=int(rec.get("retries", 0)),
            trace=rec.get("trace"),
            tenant=rec.get("tenant", "default"))

    def poll_completed(self) -> List[dict]:
        out = []
        for rid, r in list(self.supervisor.results.items()):
            if rid in self._published:
                continue
            self._published.add(rid)
            out.append(_result(rid, r.status, r.out,
                               shed_reason=r.shed_reason))
        return out

    def load(self) -> Optional[dict]:
        """The engine's load and prefix stats; None once the replica was
        killed or stopped (its engine is freed)."""
        eng = self.supervisor.engine
        if eng is None:
            return None
        d = eng.load().as_dict()
        d["prefix"] = eng.prefix_stats()
        return d

    def pending(self) -> bool:
        return (not self._dead) and self.supervisor.pending

    def pump(self, deadline: Optional[Deadline] = None) -> None:
        """Drive one supervised engine step (no-op when idle/dead)."""
        del deadline  # the supervisor's own step_budget bounds the step
        if not self._dead and self.supervisor.pending:
            self.supervisor.step()

    def stop(self, deadline: Optional[Deadline] = None) -> None:
        del deadline
        self._dead = True
        self.supervisor.close()


class ProcessReplica:
    """Router-side handle for a replica served by a
    :class:`ReplicaServer` in ANOTHER process, over a shared KV store.

    Store schema under ``cluster/<replica_id>/``::

        req/<seq>   one JSON request record per submission (ordered)
        done/<id>   one JSON result record per finished request
        load        latest EngineLoad.as_dict() + prefix stats
        hb          heartbeat counter (liveness = the BACKEND-clock age
                    of this key via ``store.dump`` — immune to clock
                    skew between router and replica hosts)
        stop        set by the router to shut the worker down

    ``proc`` (a Popen-style object with ``poll()``) makes liveness
    exact for locally-spawned workers; without it the heartbeat age
    alone decides."""

    def __init__(self, store, replica_id: str, *,
                 journal_dir: Optional[str] = None, proc=None,
                 heartbeat_timeout: float = 15.0):
        self.store = store
        self.replica_id = str(replica_id)
        self.ns = f"cluster/{self.replica_id}"
        self.journal_dir = journal_dir
        self.proc = proc
        self.heartbeat_timeout = float(heartbeat_timeout)
        self._seq = 0
        self._seen_done: Set[str] = set()

    def alive(self) -> bool:
        if self.proc is not None and self.proc.poll() is not None:
            return False
        try:
            ents = self.store.dump(self.ns + "/hb")
        except Exception:  # noqa: BLE001 — store blip != replica death
            return True
        if not ents:
            # not heartbeating YET (still importing/compiling): only a
            # dead process handle can prove death this early
            return True
        return ents[0][2] <= self.heartbeat_timeout

    def submit(self, rec: dict) -> None:
        self.store.set(f"{self.ns}/req/{self._seq:08d}", json.dumps(rec))
        self._seq += 1

    def poll_completed(self) -> List[dict]:
        out = []
        for key in self.store.keys(self.ns + "/done/"):
            if key in self._seen_done:
                continue
            raw = self.store.get(key)
            if raw is None:
                continue
            self._seen_done.add(key)
            out.append(json.loads(raw))
        return out

    def load(self) -> Optional[dict]:
        raw = self.store.get(self.ns + "/load")
        return None if raw is None else json.loads(raw)

    def pending(self) -> bool:
        return False  # the worker pumps itself; run() polls results

    def pump(self, deadline: Optional[Deadline] = None) -> None:
        del deadline  # nothing to drive from here

    def stop(self, deadline: Optional[Deadline] = None) -> None:
        """Ask the worker to exit; reap the process handle if we own
        one (bounded by ``deadline``, default 10s)."""
        dl = Deadline.coerce(deadline)
        try:
            self.store.set(self.ns + "/stop", "1")
        except Exception:  # noqa: BLE001 — store may already be down
            pass
        if self.proc is not None:
            try:
                self.proc.wait(timeout=dl.timeout(10.0, floor=0.1))
            except Exception:  # noqa: BLE001 — still running: kill it
                self.proc.kill()


class ReplicaServer:
    """The replica-side serve loop for process-mode clustering: polls
    request records from the store into a local supervised engine,
    steps it, and publishes results / load / heartbeats. Crash-safe by
    construction — every accepted submission is journaled by the
    supervisor BEFORE it is served, so the router (or a relaunch of
    this worker over the same ``journal_dir``) can always reconstruct
    accepted-but-unfinished work."""

    def __init__(self, store, replica_id: str, engine_factory, *,
                 journal_dir: str, poll_interval: float = 0.02,
                 obs_publish_interval: float = 0.5,
                 **supervisor_kwargs):
        self.store = store
        self.replica_id = str(replica_id)
        self.ns = f"cluster/{self.replica_id}"
        self.poll_interval = float(poll_interval)
        self.supervisor = ServingSupervisor(
            engine_factory, journal_dir=journal_dir, **supervisor_kwargs)
        self._taken: Set[str] = set()
        self._published: Set = set()
        self._hb = 0
        # fleet observability: this worker's registry dump +
        # trace ring publish under obs/rep-<id>/ in the SAME store the
        # cluster protocol already shares, rate-limited off the poll loop
        self._obs_pub = _obs_agg.Publisher(
            store, f"rep-{self.replica_id}",
            interval_s=float(obs_publish_interval))

    def _pull(self) -> int:
        """Ingest new request records; returns how many."""
        n = 0
        for key in sorted(self.store.keys(self.ns + "/req/")):
            if key in self._taken:
                continue
            raw = self.store.get(key)
            if raw is None:
                continue
            self._taken.add(key)
            rec = json.loads(raw)
            rid = rec["req_id"]
            if rid in self.supervisor.journaled_ids:
                continue  # a relaunch already replayed this submission
            self.supervisor.submit(
                rid, np.asarray(rec["prompt"], np.int32),
                int(rec["max_new_tokens"]),
                deadline=_remaining_budget(rec),
                priority=rec.get("priority", "interactive"),
                retries=int(rec.get("retries", 0)),
                trace=rec.get("trace"),
                tenant=rec.get("tenant", "default"))
            n += 1
        return n

    def _publish(self) -> None:
        for rid, r in list(self.supervisor.results.items()):
            if rid in self._published:
                continue
            self._published.add(rid)
            self.store.set(f"{self.ns}/done/{rid}", json.dumps(
                _result(rid, r.status, r.out, shed_reason=r.shed_reason)))
        eng = self.supervisor.engine
        d = eng.load().as_dict()
        d["prefix"] = eng.prefix_stats()
        self.store.set(self.ns + "/load", json.dumps(d))
        self._hb += 1
        self.store.set(self.ns + "/hb", str(self._hb))
        self._obs_pub.maybe_publish()
        # tick the local alert rules at the cadence the registry is
        # published: a replica's own burn-rate / queue alerts fire here
        # and ride the next publication fleet-wide
        _obs.default_manager().maybe_evaluate(
            min_interval_s=self._obs_pub.interval_s)

    def serve(self, deadline=None) -> None:
        """Serve until ``stop`` is posted or the Deadline runs out.
        Every blocking edge is bounded: store ops carry their own
        per-op budget, idle waits go through ``Deadline.sleep``.

        At exit — normal stop, deadline, or a crash unwinding through
        here — the final registry dump is flushed to the store and, when
        ``CLUSTER_TRACE_DUMP`` names a file, the trace ring is dumped
        there the way ``DISAGG_TRACE_DUMP`` does for disagg workers, so
        cluster-mode runs stitch complete traces."""
        dl = Deadline.coerce(deadline)
        try:
            self._publish()  # first heartbeat: visible before any work
            while not dl.expired():
                if self.store.get(self.ns + "/stop"):
                    break
                took = self._pull()
                if self.supervisor.pending:
                    self.supervisor.step()
                elif not took:
                    if dl.budget is None:
                        time.sleep(self.poll_interval)
                    else:
                        dl.sleep(self.poll_interval)
                self._publish()
            self._publish()
        finally:
            try:
                self._obs_pub.publish()
            except Exception:
                pass  # the store may be the thing that died
            dump_path = os.environ.get("CLUSTER_TRACE_DUMP")
            if dump_path:
                with open(dump_path, "w", encoding="utf-8") as fh:
                    json.dump(_obs.ring().dump(), fh)


# ---------------------------------------------------------------------------
# The router


class ClusterRouter:
    """Route requests across replicas by load + session/prefix
    affinity; recover a dead replica's accepted work onto survivors.

    ``replicas`` is a sequence of transports (:class:`InProcessReplica`
    / :class:`ProcessReplica` / anything with their surface).
    ``block_size`` should match the engines' KV block size — the
    router's prefix trees index block-aligned chunks so its affinity
    estimate predicts the engine-side cache hit exactly.

    Scoring (lower wins)::

        busy     = wq * queue_frac + wkv * kv_occupancy
                 + wd * squash(est_queue_delay_s)
                 + wl * squash(ewma_step_s)
                 + wb * host_blocked_frac
        score    = busy - affinity_weight * prefix_fraction
                        - session_weight  * session_match

    ``host_blocked_frac`` is the replica engine's measured
    fraction of step time spent BLOCKED on device fetches: a host-bound
    replica (sync fetch loop, or an overlap pipeline that degraded to
    draining) services its queue slower than its depth suggests, so it
    scores as busier at equal queue/KV occupancy.

    ``squash(x) = x / (1 + x)`` keeps unbounded seconds-valued signals
    commensurable with the [0, 1] fractions without magic scale
    constants. Ties break toward the replica with fewer routed
    requests, then the lower index — deterministic placement for
    deterministic tests."""

    def __init__(self, replicas: Sequence, *, block_size: int = 16,
                 max_request_retries: int = 2,
                 affinity_weight: float = 1.0,
                 session_weight: float = 1.0,
                 queue_weight: float = 1.0, kv_weight: float = 1.0,
                 delay_weight: float = 1.0, latency_weight: float = 0.25,
                 blocked_weight: float = 0.5,
                 max_prefix_nodes: int = 4096):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas = list(replicas)
        self.block_size = int(block_size)
        self.max_request_retries = int(max_request_retries)
        self.affinity_weight = float(affinity_weight)
        self.session_weight = float(session_weight)
        self.queue_weight = float(queue_weight)
        self.kv_weight = float(kv_weight)
        self.delay_weight = float(delay_weight)
        self.latency_weight = float(latency_weight)
        self.blocked_weight = float(blocked_weight)
        self._max_prefix_nodes = int(max_prefix_nodes)
        self._prefix = [PrefixCache(self.block_size,
                                    max_nodes=self._max_prefix_nodes)
                        for _ in self.replicas]
        self._sessions: Dict[str, int] = {}
        # replicas being scaled down: zero-capacity for NEW placements,
        # but session follow-ups still land on them (their KV/prefix
        # state is there) until the autoscaler retires them
        self.draining: Set[int] = set()
        self.inflight: Dict[object, Tuple[dict, int]] = {}
        # accepted records with NO live replica to take them (a total-
        # outage window): parked here, re-placed by every step() until
        # a replica comes back — never silently dropped
        self.orphans: Dict[object, dict] = {}
        self.results: Dict[object, dict] = {}
        self.retries: Dict[object, int] = {}
        self.poisoned_ids: List[object] = []
        self.dead: Set[int] = set()
        self.n_routed = [0] * len(self.replicas)
        self.n_misroutes = 0
        self.n_recoveries = 0
        self.events: List[tuple] = []

    # -- placement -------------------------------------------------------
    def _live(self, exclude: Sequence[int] = ()) -> List[int]:
        return [i for i, rep in enumerate(self.replicas)
                if i not in self.dead and i not in exclude and rep.alive()]

    @staticmethod
    def _squash(x: Optional[float]) -> float:
        x = float(x or 0.0)
        return x / (1.0 + x)

    def _score(self, idx: int, load: Optional[dict], prompt,
               session: Optional[str]) -> float:
        if load is None:
            busy = 1.0  # unknown load: neither favourite nor pariah
        else:
            qlim = load.get("queue_limit") or 16
            busy = (
                self.queue_weight
                * (load.get("queue_depth", 0) / float(qlim))
                + self.kv_weight * float(load.get("kv_occupancy", 0.0))
                + self.delay_weight
                * self._squash(load.get("est_queue_delay_s"))
                + self.latency_weight
                * self._squash(load.get("ewma_step_s"))
                + self.blocked_weight
                * float(load.get("host_blocked_frac", 0.0)))
        affinity = 0.0
        if session is not None and self._sessions.get(session) == idx:
            affinity += self.session_weight
        matched, _ = self._prefix[idx].lookup(prompt)
        affinity += self.affinity_weight * (
            matched / max(len(prompt), 1))
        return busy - affinity

    def route(self, prompt, *, session: Optional[str] = None,
              exclude: Sequence[int] = ()) -> int:
        """Pick a replica for ``prompt``. Raises :class:`NoLiveReplica`
        when nothing is alive. Chaos site ``cluster.route``: a ``drop``
        fault deterministically misroutes to the next live replica —
        the correctness envelope the router tests pin down."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        live = self._live(exclude)
        if not live:
            raise NoLiveReplica(
                f"no live replica ({len(self.replicas)} configured, "
                f"{sorted(self.dead)} dead, {list(exclude)} excluded)")
        # a draining replica is ZERO-capacity for new placements — only
        # a session already pinned to it may follow (its KV/prefix
        # state lives there, and re-placing follow-ups elsewhere would
        # keep the drain from ever finishing the conversation). If the
        # whole fleet is draining, serve anyway: drain is a preference,
        # refusal is an outage.
        cands = [i for i in live if i not in self.draining]
        pinned = self._sessions.get(session) if session is not None \
            else None
        if pinned is not None and pinned in live \
                and pinned in self.draining:
            cands.append(pinned)
        if not cands:
            cands = live
        loads = {i: self.replicas[i].load() for i in cands}
        best = min(cands, key=lambda i: (
            self._score(i, loads[i], prompt, session),
            self.n_routed[i], i))
        if not _chaos.inject("cluster.route"):
            best = live[(live.index(best) + 1) % len(live)]
            self.n_misroutes += 1
        return best

    # -- submission ------------------------------------------------------
    def submit(self, req_id, prompt, max_new_tokens: int = 32, *,
               deadline=None, priority: str = "interactive",
               session: Optional[str] = None, trace=None,
               tenant: str = "default") -> int:
        """Route + dispatch one request; returns the replica index it
        was placed on. Results arrive via :meth:`poll` / :meth:`run`,
        keyed by ``req_id`` — across any number of replica deaths.
        ``trace`` joins an upstream trace; otherwise a fresh one is
        minted here so the replica's admission span parents under this
        ``route`` span. ``tenant`` rides the wire record end-to-end
        (replica admission, journal, requeue-on-death)."""
        with _obs.span("route", parent=_obs.trace_ctx(trace),
                       tid="router", req=str(req_id),
                       tenant=str(tenant)) as sp:
            rec = make_record(
                req_id, prompt, max_new_tokens, deadline=deadline,
                priority=priority, session=session, tenant=tenant,
                retries=self.retries.get(req_id, 0), trace=sp.ctx())
            idx = self.route(rec["prompt"], session=session)
            sp.args["replica"] = self.replicas[idx].replica_id
        self._dispatch(rec, idx)
        return idx

    def _dispatch(self, rec: dict, idx: int) -> None:
        self.replicas[idx].submit(rec)
        self.inflight[rec["req_id"]] = (rec, idx)
        self.n_routed[idx] += 1
        self._prefix[idx].insert(rec["prompt"])
        if rec.get("session"):
            self._sessions[rec["session"]] = idx

    # -- harvest ---------------------------------------------------------
    def poll(self) -> List[dict]:
        """Collect newly completed results from every live replica."""
        new = []
        for i, rep in enumerate(self.replicas):
            if i in self.dead:
                continue
            try:
                done = rep.poll_completed()
            except Exception:  # noqa: BLE001 — a dying replica's store
                continue  # blip; liveness checking owns the verdict
            for rec in done:
                rid = rec["req_id"]
                if rid in self.results:
                    continue
                self.results[rid] = rec
                self.inflight.pop(rid, None)
                new.append(rec)
        return new

    # -- failure handling ------------------------------------------------
    def check_replicas(self) -> List[int]:
        """Liveness sweep; runs recovery for each newly-dead replica.
        Returns the indices recovered this call."""
        recovered = []
        for i, rep in enumerate(self.replicas):
            if i not in self.dead and not rep.alive():
                self.recover_replica(i)
                recovered.append(i)
        return recovered

    def recover_replica(self, idx: int) -> None:
        """Crash-only, replica-level recovery (the supervisor's design
        one level up): harvest anything the dead replica published,
        replay + compact its journal, close already-expired work at
        zero cost, quarantine repeat offenders, and requeue the rest
        onto surviving replicas with only their remaining deadline
        budget. The union of journal-pending and the router's own
        routing table covers the mailed-but-never-pulled window, so an
        accepted request can never be lost between the two."""
        rep = self.replicas[idx]
        self.dead.add(idx)
        self.draining.discard(idx)  # a mid-drain death is just a death
        self.n_recoveries += 1
        try:  # last published results (process replicas: still in store)
            for rec in rep.poll_completed():
                rid = rec["req_id"]
                if rid not in self.results:
                    self.results[rid] = rec
                    self.inflight.pop(rid, None)
        except Exception:  # noqa: BLE001 — the store may be gone too
            pass
        pending: Dict[object, dict] = {}
        if rep.journal_dir is not None:
            journal = Journal(rep.journal_dir)
            pending, completed = journal.replay()
            journal.compact(pending, completed)
            for rid, rec in completed.items():
                if rid not in self.results:
                    self.results[rid] = _result(
                        rid, rec.get("status", "ok"), rec.get("out", []))
                    self.inflight.pop(rid, None)
        # union with the router's table: records mailed to the store
        # the worker never pulled have no journal entry yet
        for rid, (rec, where) in list(self.inflight.items()):
            if where == idx and rid not in pending:
                pending[rid] = rec
        n_requeued = n_poisoned = 0
        for rid, rec in pending.items():
            if rid in self.results:
                continue
            self.inflight.pop(rid, None)
            remaining = _remaining_budget(rec)
            if remaining is not None and remaining <= 0:
                # the budget died with the replica: close at zero cost
                self.results[rid] = _result(rid, "expired")
                continue
            retries = max(self.retries.get(rid, 0),
                          int(rec.get("retries", 0))) + 1
            self.retries[rid] = retries
            if retries > self.max_request_retries:
                self.results[rid] = _result(rid, "poisoned")
                self.poisoned_ids.append(rid)
                n_poisoned += 1
                continue
            new_rec = {k: v for k, v in rec.items() if k != "type"}
            new_rec.setdefault("session", None)
            new_rec["retries"] = retries
            try:
                target = self.route(new_rec["prompt"],
                                    session=new_rec.get("session"),
                                    exclude=(idx,))
            except NoLiveReplica:
                # nobody can take it RIGHT NOW (total outage / every
                # survivor mid-compile): park it — step() retries
                # placement until a replica is live again
                self.orphans[rid] = new_rec
                continue
            self._dispatch(new_rec, target)
            n_requeued += 1
        self.events.append(("replica-dead", rep.replica_id,
                            n_requeued, n_poisoned))

    def _place_orphans(self) -> int:
        """Re-place parked records once replicas are live; returns how
        many found a home (expired orphans close at zero cost)."""
        placed = 0
        for rid, rec in list(self.orphans.items()):
            remaining = _remaining_budget(rec)
            if remaining is not None and remaining <= 0:
                del self.orphans[rid]
                self.results[rid] = _result(rid, "expired")
                continue
            try:
                target = self.route(rec["prompt"],
                                    session=rec.get("session"))
            except NoLiveReplica:
                return placed  # still nobody home; keep them parked
            del self.orphans[rid]
            self._dispatch(rec, target)
            placed += 1
        return placed

    # -- fleet membership (the autoscaler's surface) ---------------------
    def add_replica(self, rep) -> int:
        """Join a freshly spawned replica to the rotation; returns its
        index. The router starts it with an empty prefix tree and zero
        routed count — affinity warms up as traffic lands."""
        self.replicas.append(rep)
        self._prefix.append(PrefixCache(self.block_size,
                                        max_nodes=self._max_prefix_nodes))
        self.n_routed.append(0)
        idx = len(self.replicas) - 1
        self.events.append(("replica-added", rep.replica_id))
        return idx

    def mark_draining(self, idx: int) -> None:
        """Take ``idx`` out of NEW-placement rotation (in-flight work
        and session follow-ups keep landing on it)."""
        idx = int(idx)
        if idx in self.dead:
            raise ValueError(f"replica {idx} is dead, cannot drain")
        self.draining.add(idx)
        self.events.append(("replica-draining",
                            self.replicas[idx].replica_id))

    def clear_draining(self, idx: int) -> None:
        """Cancel a drain (scale-up won the race): back in rotation."""
        self.draining.discard(int(idx))

    def inflight_on(self, idx: int) -> int:
        """Router-table entries currently placed on ``idx``."""
        idx = int(idx)
        return sum(1 for _, where in self.inflight.values()
                   if where == idx)

    def drained(self, idx: int) -> bool:
        """True when a draining replica has quiesced: nothing in the
        routing table points at it and its local queue is empty — safe
        to retire without recovery."""
        idx = int(idx)
        if self.inflight_on(idx):
            return False
        try:
            return not self.replicas[idx].pending()
        except Exception:  # noqa: BLE001 — an unreachable replica is
            return True    # not quiescable; retire falls back to kill

    def retire_replica(self, idx: int, deadline=None) -> None:
        """Remove a QUIESCED draining replica from the fleet: its
        prefix tree is forfeited (the radix state dies with it — the
        cluster-level cache re-warms on the survivors), pinned sessions
        are released for re-placement, and NO recovery runs — a clean
        drain has nothing to recover. A replica that dies mid-drain
        instead goes through :meth:`recover_replica` like any other
        death (journal-∪-table requeue; zero accepted requests lost)."""
        idx = int(idx)
        rep = self.replicas[idx]
        self.draining.discard(idx)
        self.dead.add(idx)
        self._prefix[idx].clear()
        self._sessions = {s: i for s, i in self._sessions.items()
                          if i != idx}
        try:
            rep.stop(deadline=deadline)
        except Exception:  # noqa: BLE001 — already-gone is fine here
            pass
        self.events.append(("replica-retired", rep.replica_id))

    # -- the drive loop --------------------------------------------------
    def step(self) -> List[dict]:
        """One router tick: pump in-process replicas, harvest results,
        sweep liveness (dead replicas recover onto survivors)."""
        for i, rep in enumerate(self.replicas):
            if i not in self.dead:
                rep.pump()
        out = self.poll()
        self.check_replicas()
        if self.orphans:
            self._place_orphans()
        return out

    def run(self, deadline=None, poll_interval: float = 0.02) -> dict:
        """Drive until every submitted request has a result (or the
        Deadline runs out); returns ``{req_id: result-record}``."""
        dl = Deadline.coerce(deadline)
        while (self.inflight or self.orphans) and not dl.expired():
            got = self.step()
            if got:
                continue
            if any(rep.pending() for i, rep in enumerate(self.replicas)
                   if i not in self.dead):
                continue  # local work ready to pump: no sleep
            if dl.budget is None:
                time.sleep(poll_interval)
            else:
                dl.sleep(poll_interval)
        return dict(self.results)

    def stop(self, deadline=None) -> None:
        """Shut every live replica down (bounded per replica)."""
        dl = Deadline.coerce(deadline)
        for i, rep in enumerate(self.replicas):
            if i not in self.dead:
                rep.stop(deadline=dl.sub(fraction=0.5))

    # -- observability ---------------------------------------------------
    def prefix_hit_rate(self) -> float:
        """Cluster-wide engine-side prefix hit rate: cached prompt
        tokens / prompt tokens that entered a slot, summed over live
        replicas (0.0 when none publish prefix stats — e.g. a worker
        that died before its first snapshot)."""
        hit = tot = 0
        for i, rep in enumerate(self.replicas):
            if i in self.dead:
                continue
            pf = ((rep.load() or {}).get("prefix") or {})
            if pf.get("enabled"):
                hit += pf.get("hit_tokens", 0)
                tot += pf.get("hit_tokens", 0) + pf.get(
                    "prefill_tokens", 0)
        return hit / tot if tot else 0.0

    def health(self) -> dict:
        reps = []
        for i, rep in enumerate(self.replicas):
            alive = i not in self.dead and rep.alive()
            entry = {"replica_id": rep.replica_id, "alive": alive,
                     "routed": self.n_routed[i]}
            if alive:
                try:
                    entry["load"] = rep.load()
                except Exception:  # noqa: BLE001 — snapshot best-effort
                    entry["load"] = None
            reps.append(entry)
        return _obs.health_envelope("router", {
            "replicas": reps,
            "dead": sorted(self.dead),
            "draining": sorted(self.draining),
            "inflight": len(self.inflight),
            "orphans": len(self.orphans),
            "results": len(self.results),
            "poisoned": list(self.poisoned_ids),
            "misroutes": self.n_misroutes,
            "recoveries": self.n_recoveries,
            "sessions": len(self._sessions),
            # per-tenant SLO view — in-process replicas only
            # (process replicas' registries live behind obs/agg)
            "tenants": _obs.tenant_slo_table(),
        })
