"""Elastic training manager — node liveness, scale events, rank
reassignment (counterpart of ``paddle_tpu/distributed/fleet/elastic``,
copied: host code over the port's stores).

ref: python/paddle/distributed/fleet/elastic/manager.py:124
(ElasticManager: etcd leases + watches, rank reassignment, relaunch via
ELASTIC_EXIT_CODE) and elastic/collective.py.

As in the JAX package, membership lives in a pluggable KV store
(distributed/store.py). Two backends: a **shared directory**
(NFS or another shared mount; no etcd is needed) and a **TCP store**
(``tcp://host:port`` — multi-node clusters WITHOUT a shared
filesystem; the launcher/master runs TCPStoreServer, replacing the
reference's etcd. ref: manager.py:124 etcd leases+watches). Each node
renews a timestamped heartbeat entry; the manager derives the alive
set, detects scale-up/down against the expected world, and reassigns
dense ranks deterministically (lexicographic by node id — every node
computes the same assignment with no coordinator). On a membership
change the watchdog reports ELASTIC_EXIT_CODE so the launcher
(distributed.launch, which already restarts on nonzero exits)
relaunches with the new world — same division of labor as the
reference.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from ....testing import chaos as _chaos
from ....utils.retries import Deadline
from ...store import KVStore, make_store

__all__ = ["ElasticManager", "ELASTIC_EXIT_CODE"]

ELASTIC_EXIT_CODE = 101  # ref: manager.py ELASTIC_EXIT_CODE


class ElasticManager:
    """Heartbeat + membership over a shared directory.

    Parameters mirror the reference where meaningful: ``np`` is the
    expected node count ("min:max" accepted), ``elastic_timeout`` the
    grace period for the world to assemble or a dead node to be
    declared.
    """

    def __init__(self, store_dir: str | KVStore, node_id: Optional[str] = None,
                 np=1, heartbeat_interval: float = 2.0,
                 elastic_timeout: float = 30.0,
                 max_beat_failures: Optional[int] = None):
        """``store_dir``: a shared-directory path, a ``tcp://host:port``
        store location, or a KVStore instance."""
        self.store_dir = store_dir if isinstance(store_dir, str) else None
        self.store = (
            store_dir if isinstance(store_dir, KVStore) else make_store(store_dir)
        )
        self.node_id = node_id or f"{os.uname().nodename}-{os.getpid()}"
        if isinstance(np, str) and ":" in np:
            lo, hi = np.split(":")
            self.min_np, self.max_np = int(lo), int(hi)
        else:
            self.min_np = self.max_np = int(np)
        self.heartbeat_interval = heartbeat_interval
        self.elastic_timeout = elastic_timeout
        self._hb_key = f"nodes/{self.node_id}"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._registered_world: Optional[List[str]] = None
        self.need_sync = False
        # heartbeat self-diagnosis: a beat thread that cannot reach the
        # store for longer than the eviction window is functionally a
        # dead node — peers have already (or will imminently) evict it,
        # so keeping a zombie thread silently retrying just hides the
        # failure from the trainer. Default threshold ≈ the number of
        # beats that fit in elastic_timeout (min 3): self-declared death
        # lines up with peer-declared death.
        if max_beat_failures is None:
            max_beat_failures = max(
                3, int(elastic_timeout / max(heartbeat_interval, 1e-6)))
        self.max_beat_failures = int(max_beat_failures)
        self._beat_failures = 0
        self._last_beat_error: Optional[BaseException] = None
        self._dead = False
        # distinct re-mesh decisions (real membership changes and
        # chaos-forced ones alike) — surfaced via health()
        self.remesh_events = 0
        self._remesh_latched = False

    # -- membership ----------------------------------------------------
    def _beat(self):
        if not _chaos.inject("elastic.heartbeat"):
            return  # dropped by a chaos schedule — peers see the entry age
        self.store.set(
            self._hb_key, json.dumps({"node": self.node_id, "ts": time.time()})
        )

    def alive_nodes(self) -> List[str]:
        """Alive members, capped at max_np (surplus joiners are held
        out deterministically — lexicographically first max_np win,
        ref: manager.py world-size ceiling).

        Liveness uses the STORE's entry ages (file mtime / TCP-server
        receive time) via one dump() round trip — immune to cross-node
        clock skew and O(1) connections per scan."""
        out = [
            key[len("nodes/"):]
            for key, _val, age in self.store.dump("nodes/")
            if age <= self.elastic_timeout
        ]
        return sorted(out)[: self.max_np]

    def rank_mapping(self) -> Dict[str, int]:
        """Deterministic dense ranks over the REGISTERED world snapshot
        (sorted node ids → 0..N-1). Ranks never shift mid-run; a
        membership change instead triggers watch() → relaunch, after
        which every node re-registers and re-derives the new mapping
        (ref: manager._update_hosts)."""
        world = self._registered_world or self.alive_nodes()
        return {n: i for i, n in enumerate(world)}

    def rank(self) -> int:
        return self.rank_mapping().get(self.node_id, -1)

    # -- lifecycle -----------------------------------------------------
    def register(self, deadline: Optional[Deadline] = None):
        """Join + start heartbeating (ref: manager.py start).

        Blocks until ≥ min_np nodes are alive AND the alive set is
        stable across two consecutive reads one heartbeat apart, so
        concurrently-joining nodes converge on the same world snapshot.
        ``deadline`` bounds the whole assembly (default: a fresh
        Deadline of ``elastic_timeout``); a caller threading its own
        budget down passes it here and assembly never outlives it.
        """
        dl = (deadline if deadline is not None
              else Deadline(self.elastic_timeout))
        self._beat()
        prev = None
        while True:
            cur = self.alive_nodes()
            if len(cur) >= self.min_np and cur == prev:
                break
            if dl.expired():
                if len(cur) < self.min_np:
                    raise TimeoutError(
                        f"only {len(cur)}/{self.min_np} nodes joined "
                        f"within {dl.budget}s"
                    )
                break  # settled-enough: membership kept churning
            prev = cur
            dl.sleep(self.heartbeat_interval)
            self._beat()
        # adopt the snapshot the stability loop validated — a re-read
        # here could race a late joiner and diverge across nodes
        self._registered_world = cur

        def loop():
            while not self._stop.wait(self.heartbeat_interval):
                # a transient store error (TCP reset, brief master
                # overload) must not kill the heartbeat — a dead beat
                # thread gets a healthy node evicted. But REPEATED
                # failures past max_beat_failures mean the node cannot
                # advertise liveness at all: mark self dead, keep the
                # last error for health(), and stop beating (silently
                # retrying forever would hide the failure from the
                # trainer while peers evict us anyway).
                try:
                    self._beat()
                    self._beat_failures = 0
                    if self.world_changed():
                        self.need_sync = True
                except (OSError, ValueError, RuntimeError) as e:
                    # OSError: connect/reset; ValueError: truncated
                    # response mid-close; RuntimeError: server-side error
                    self._beat_failures += 1
                    self._last_beat_error = e
                    if self._beat_failures >= self.max_beat_failures:
                        self._dead = True
                        return
                    continue

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self._registered_world

    def world_changed(self) -> bool:
        # chaos-forced re-mesh decision (site ``elastic.remesh``): the
        # membership is intact but the manager reports change, driving
        # the full watch() → relaunch → re-register recompile path
        forced = not _chaos.inject("elastic.remesh")
        changed = forced or (self._registered_world is not None and (
            self.alive_nodes() != self._registered_world
        ))
        # count re-mesh EVENTS, not polls: watch() re-asks every beat
        # once the world diverges, so latch until it settles again
        if changed and not self._remesh_latched:
            self.remesh_events += 1
        self._remesh_latched = changed
        return changed

    def watch(self, deadline: Optional[Deadline] = None) -> int:
        """Block until membership changes; returns ELASTIC_EXIT_CODE
        (ref: manager.py watch → exit for relaunch). With a ``deadline``
        the watch returns 0 when the budget expires with membership
        intact — callers driving a bounded supervision loop regain
        control instead of blocking forever."""
        dl = deadline if deadline is not None else Deadline.unbounded()
        while not self.world_changed():
            if self._stop.is_set() or dl.expired():
                return 0
            dl.sleep(self.heartbeat_interval)
        return ELASTIC_EXIT_CODE

    def should_shrink(self) -> bool:
        return len(self.alive_nodes()) < self.min_np

    def health(self) -> dict:
        """Structured liveness self-report: whether THIS node is still
        advertising (beat thread alive and under the failure threshold),
        how many consecutive beats have failed, and the last beat error
        — the surface the training supervisor and tests read instead of
        inferring node health from peers' eviction decisions."""
        beating = (self._thread is not None and self._thread.is_alive()
                   and not self._stop.is_set())
        return {
            "node_id": self.node_id,
            "alive": not self._dead and beating,
            "dead": self._dead,
            "beating": beating,
            "consecutive_beat_failures": self._beat_failures,
            "last_beat_error": (None if self._last_beat_error is None
                                else repr(self._last_beat_error)),
            "max_beat_failures": self.max_beat_failures,
            "registered_world": self._registered_world,
            "rank": self.rank(),
            "world_size": (len(self._registered_world)
                           if self._registered_world is not None else 0),
            "remesh_events": self.remesh_events,
        }

    def exit(self):
        """Leave cleanly (ref: manager.py exit): stop beating, remove
        the heartbeat so peers see the departure immediately."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.heartbeat_interval * 2)
        try:
            self.store.delete(self._hb_key)
        except OSError:
            pass
