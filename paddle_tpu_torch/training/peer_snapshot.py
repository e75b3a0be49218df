"""Peer-replicated in-memory checkpoints over a KV store (counterpart of
``paddle_tpu/training/peer_snapshot.py``, copied: the protocol is host
code, and the port keeps it byte for byte — the same keys, envelope, meta
and pruning, so either package's replicator reads the other's publishes).

Gemini/CheckFreq shape: every ``snapshot_interval`` steps each rank
mirrors its (sharded) training state to a PEER rank's host RAM, so a
killed-and-relaunched rank restores at memory speed without touching
disk. Here "a peer's host RAM" is mediated by the shared KV store
(``distributed/store.py``): in TCP mode the payload physically lives in
the store server's RAM on another host; the ring assignment
``peer = (rank + 1) % world`` is recorded in the key namespace so a
future direct-transport backend can place the bytes on that exact host
without changing the protocol.

Publish protocol (crash-only, torn-publish-proof):

1. ``<tag>/snap/<rank>/data/<step>``  — an INNER whole-payload CRC32
   envelope around the serialized payload, shipped via ``put_bytes``
   (which adds the length-prefixed + CRC32 frame). Two CRCs on
   purpose, like the disagg handoff's part-frames + whole-payload
   commit: the outer frame catches corruption in the store/transport,
   the inner envelope — computed BEFORE the ``ckpt.peer`` chaos
   site — catches corruption on the way in, so a bit flip anywhere
   surfaces as a verification failure at fetch, never as garbage
   state;
2. ``<tag>/snap/<rank>/meta``         — JSON ``{step, payload_bytes,
   nonce}``, written LAST. A writer killed between (1) and (2) leaves
   the previous meta pointing at the previous (still present) data key
   — the reader can never observe a half-published snapshot;
3. the superseded data key is deleted after the meta flips.

``fetch()`` is verified-or-nothing: a missing/corrupt/short payload
returns the next-older intact publish (or None), so the recovery tier
comparison in the supervisor only ever sees restorable snapshots.

Chaos site ``ckpt.peer`` wraps every publish leg: ``corrupt`` flips a
payload bit (the CRC framing must catch it at fetch), ``drop`` loses
that leg (recovery falls back to an older tier).

Every blocking store leg threads a ``Deadline`` (DDL001/DDL002
discipline) — a slow store can delay a snapshot, never wedge training.
"""
from __future__ import annotations

import binascii
import json
import os
import struct
import threading
import time
from typing import Optional, Tuple

from ..distributed.store import CorruptBlobError, KVStore
from ..testing import chaos as _chaos
from ..utils.retries import Deadline, RetryPolicy

__all__ = ["PeerReplicator"]


class PeerReplicator:
    """Async snapshot mirroring for one rank.

    Parameters: ``store`` — any :class:`KVStore`; ``rank``/``world_size``
    — this rank's slot in the ring (``peer`` = the rank whose RAM holds
    our replica); ``tag`` — key namespace (one per job, so relaunched
    jobs don't read a previous job's snapshots); ``deadline_s`` — total
    budget per publish/fetch; ``keep`` — how many superseded data keys
    to retain (older ones are deleted; >=1 keeps a fallback for a
    corrupt newest payload).
    """

    def __init__(self, store: KVStore, rank: int, world_size: int, *,
                 tag: str = "trainsnap", deadline_s: float = 30.0,
                 keep: int = 1, retry: Optional[RetryPolicy] = None):
        if world_size < 1:
            raise ValueError("world_size must be >= 1")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside [0, {world_size})")
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.tag = tag
        self.deadline_s = float(deadline_s)
        self.keep = max(1, int(keep))
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=4, base_delay=0.05, max_delay=1.0,
            transient=(OSError, ValueError))
        # per-incarnation nonce: a relaunched rank's publishes must be
        # distinguishable from its previous life's (meta carries it)
        self._nonce = f"{os.getpid()}-{int(time.time() * 1000) & 0xFFFFFF}"
        self._worker: Optional[threading.Thread] = None
        self._publish_error: Optional[BaseException] = None
        self.n_published = 0
        self.last_published_step: Optional[int] = None

    # -- key scheme ------------------------------------------------------
    @property
    def peer(self) -> int:
        """The rank whose host RAM holds THIS rank's replica."""
        return (self.rank + 1) % self.world_size

    def _meta_key(self, rank: Optional[int] = None) -> str:
        r = self.rank if rank is None else rank
        return f"{self.tag}/snap/{r}/meta"

    def _data_key(self, step: int, rank: Optional[int] = None) -> str:
        r = self.rank if rank is None else rank
        return f"{self.tag}/snap/{r}/data/{step}"

    # -- publish ---------------------------------------------------------
    def publish(self, step: int, payload, *, block: bool = False):
        """Mirror the serialized snapshot for ``step`` to the peer
        tier. ``payload`` is bytes OR a zero-arg callable returning
        bytes — the callable form defers serialization (the host copy +
        pickle) onto the worker thread, so the train thread only hands
        over the captured snapshot (device clones, never live tensors). Async by default; a previous
        in-flight publish is drained first (one at a time, newest
        wins). ``block=True`` publishes inline (tests, final snapshot
        before exit)."""
        self.drain()  # drain + surface a previous publish's error
        if block:
            self._publish(int(step), payload)
            self._raise_publish_error()
            return
        self._worker = threading.Thread(
            target=self._publish, args=(int(step), payload),
            name="paddle_tpu_torch_peer_snapshot", daemon=True)
        self._worker.start()

    def _publish(self, step: int, payload):
        dl = Deadline(self.deadline_s)
        try:
            if callable(payload):
                payload = payload()
            # inner whole-payload CRC, sealed BEFORE the chaos site:
            # corruption between here and the store is provable at fetch
            envelope = struct.pack(
                "!I", binascii.crc32(payload) & 0xFFFFFFFF) + payload
            data = _chaos.inject_bytes("ckpt.peer", envelope)
            if data is None:
                return  # dropped leg: this interval's mirror is lost
            self.retry.call(
                lambda: self.store.put_bytes(self._data_key(step), data),
                deadline=dl, describe="peer snapshot data put")
            if not _chaos.inject("ckpt.peer"):
                return  # dropped meta: previous publish stays current
            meta = json.dumps({"step": step, "payload_bytes": len(payload),
                               "nonce": self._nonce})
            self.retry.call(
                lambda: self.store.set(self._meta_key(), meta),
                deadline=dl, describe="peer snapshot meta put")
            self.n_published += 1
            self.last_published_step = step
            self._prune(step, dl)
        except BaseException as e:  # noqa: BLE001 — reported on next publish
            self._publish_error = e

    def _prune(self, newest_step: int, dl: Deadline):
        """Delete superseded data keys beyond ``keep`` — the peer's RAM
        holds a bounded number of replicas, not the run's history."""
        try:
            prefix = f"{self.tag}/snap/{self.rank}/data/"
            steps = sorted(
                int(k[len(prefix):]) for k in self.store.keys(prefix)
                if k[len(prefix):].isdigit())
            live = [s for s in steps if s <= newest_step][:-1 - self.keep]
            for s in live:
                dl.check("peer snapshot prune")
                self.store.delete(self._data_key(s))
        except (OSError, ValueError, RuntimeError, TimeoutError):
            pass  # pruning is hygiene; never fail a publish over it

    def drain(self):
        """Drain the in-flight publish; raises if it failed (a final
        pre-exit mirror failing silently would strand the relaunch on a
        stale tier with no indication). The join is BOUNDED by the
        publish deadline (+ scheduling slack): every store leg inside
        the worker runs under ``Deadline(deadline_s)``, so a join that
        outlives it means a wedge worth surfacing, not waiting on."""
        if self._worker is not None:
            self._worker.join(self.deadline_s + 5.0)
            alive, self._worker = self._worker.is_alive(), None
            if alive:
                raise RuntimeError(
                    "peer snapshot publish wedged past its deadline "
                    f"({self.deadline_s}s) — abandoning the worker")
        self._raise_publish_error()

    # API symmetry with AutoCheckpoint.wait (same drain-the-async-save
    # contract); assignment, not a def, so callers can use either name
    wait = drain

    def _raise_publish_error(self):
        if self._publish_error is not None:
            err, self._publish_error = self._publish_error, None
            raise RuntimeError(f"peer snapshot publish failed: {err!r}") \
                from err

    # -- fetch -----------------------------------------------------------
    def latest_step(self, rank: Optional[int] = None) -> Optional[int]:
        """Step of the newest PUBLISHED snapshot for ``rank`` (default:
        self — the relaunched-rank read), or None. Reads only the meta
        record; the payload is verified at :meth:`fetch`."""
        dl = Deadline(self.deadline_s)
        try:
            raw = self.retry.call(
                lambda: self.store.get(self._meta_key(rank)),
                deadline=dl, describe="peer snapshot meta get")
        except (OSError, ValueError, RuntimeError, TimeoutError):
            return None
        if not raw:
            return None
        try:
            return int(json.loads(raw)["step"])
        except (ValueError, KeyError, TypeError):
            return None

    def ranks(self) -> list:
        """Every rank with a committed meta under this tag — the SAVED
        world, which after an elastic shrink can be LARGER than the
        current ``world_size`` (a relaunched smaller fleet still needs
        all the old ranks' shard payloads to assemble full state)."""
        out = set()
        try:
            for k in self.store.keys(f"{self.tag}/snap/"):
                parts = k.split("/")
                if parts and parts[-1] == "meta" and parts[-2].isdigit():
                    out.add(int(parts[-2]))
        except (OSError, ValueError, RuntimeError, TimeoutError):
            return []
        return sorted(out)

    def fetch_at(self, rank: int, step: int) -> Optional[bytes]:
        """The VERIFIED payload for EXACTLY ``step`` of ``rank``, or
        None. The sharded restore gathers a consistent cut — every
        rank at the same step — so unlike :meth:`fetch` there is no
        older-tier fallback: a missing/corrupt payload at the cut step
        means this cut is unusable, full stop."""
        dl = Deadline(self.deadline_s)
        meta_step = self.latest_step(rank)
        if meta_step is None or meta_step < step:
            return None  # not committed: a torn or missing publish
        try:
            envelope = self.retry.call(
                lambda: self.store.get_bytes(self._data_key(step, rank)),
                deadline=dl, describe="peer snapshot data get")
        except (CorruptBlobError, OSError, ValueError, RuntimeError,
                TimeoutError):
            return None
        if envelope is None or len(envelope) < 4:
            return None
        (want,) = struct.unpack("!I", envelope[:4])
        payload = envelope[4:]
        if binascii.crc32(payload) & 0xFFFFFFFF != want:
            return None
        return payload

    def fetch(self, rank: Optional[int] = None
              ) -> Optional[Tuple[int, bytes]]:
        """The newest VERIFIED (step, payload) for ``rank`` (default:
        self), or None. A corrupt/short/missing newest payload falls
        back to the next-older retained data key — verified-or-nothing,
        so the caller can trust any returned bytes survived the CRC
        frame and the meta's length record."""
        dl = Deadline(self.deadline_s)
        r = self.rank if rank is None else rank
        meta_step = self.latest_step(r)
        prefix = f"{self.tag}/snap/{r}/data/"
        try:
            steps = sorted(
                (int(k[len(prefix):]) for k in self.store.keys(prefix)
                 if k[len(prefix):].isdigit()), reverse=True)
        except (OSError, ValueError, RuntimeError):
            return None
        # only steps the meta has COMMITTED are restorable (a data key
        # newer than meta.step is a torn publish mid-flight)
        steps = [s for s in steps if meta_step is not None
                 and s <= meta_step]
        for s in steps:
            dl.check("peer snapshot fetch")
            try:
                envelope = self.retry.call(
                    lambda key=self._data_key(s, r): self.store.get_bytes(
                        key),
                    deadline=dl, describe="peer snapshot data get")
            except CorruptBlobError:
                continue  # outer frame proven corrupt: try next-older
            except (OSError, ValueError, RuntimeError, TimeoutError):
                return None
            if envelope is None:
                continue
            if len(envelope) < 4:
                continue
            (want,) = struct.unpack("!I", envelope[:4])
            payload = envelope[4:]
            if binascii.crc32(payload) & 0xFFFFFFFF != want:
                continue  # inner envelope proven corrupt: next-older
            return s, payload
        return None
