"""Rendezvous / membership KV stores (counterpart of
``paddle_tpu/distributed/store.py``, copied: pure stdlib over the port's
``testing.chaos`` and ``utils.retries``). The CRC frame of
``put_bytes``/``get_bytes`` is byte-identical to the reference's, so a
blob one package writes the other reads, and a ``TCPKVStore`` of either
package talks to the other's ``TCPStoreServer``.

ref: the reference rendezvous layer — etcd leases+watches for elastic
(fleet/elastic/manager.py:124), TCPStore for collective bootstrap
(paddle/fluid/distributed/store/tcp_store.h). Equivalents:

- ``FileKVStore``: a shared directory (NFS / GCS-fuse). Atomic per-key
  files; zero extra infrastructure.
- ``TCPKVStore`` + ``TCPStoreServer``: a small line-JSON socket store
  for multi-node clusters WITHOUT a shared filesystem — the master
  node (rank 0 / launcher) runs the server, everyone connects by
  ``tcp://host:port``. Values are strings. A client keeps one
  connection open and sends its requests down it one line at a time;
  the server answers every line of a connection until the client
  closes it, so a one-request client (the reference's) is served too.

``make_store`` turns a location string into a store: a filesystem path
-> FileKVStore, ``tcp://host:port`` -> TCPKVStore. Both back
fleet.elastic membership and distributed.rpc worker discovery.

Trusted-cluster protocol (like the reference's brpc/etcd usage): no
auth, do not expose the port beyond the cluster network.
"""
from __future__ import annotations

import base64
import binascii
import json
import os
import socket
import struct
import threading
import time
import urllib.parse
from typing import Dict, List, Optional

from ..testing import chaos as _chaos
from ..utils.retries import Deadline, RetryPolicy

__all__ = [
    "KVStore", "FileKVStore", "MemKVStore", "TCPKVStore", "TCPStoreServer",
    "CorruptBlobError", "make_store",
]


class CorruptBlobError(ValueError):
    """A ``get_bytes`` frame failed its length/CRC32 check. Subclasses
    ValueError ON PURPOSE: the store retry classifiers already treat
    ValueError as transient (a truncated line-JSON reply), and a
    corrupted blob has the same remedy — re-read/re-send — so
    ``RetryPolicy`` retries it instead of a caller importing garbage."""


class KVStore:
    """Interface: string keys/values, prefix listing, numeric add."""

    def set(self, key: str, value: str) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[str]:
        raise NotImplementedError

    def keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def add(self, key: str, amount: int = 1) -> int:
        """Atomic-enough counter (single-writer-per-key or server-side)."""
        raise NotImplementedError

    def set_if_absent(self, key: str, value: str) -> bool:
        """Atomically claim ``key``: set it iff unset. Returns True when
        THIS caller won the claim. Backs duplicate-rank detection in
        distributed.rpc — check-then-set races must lose loudly."""
        raise NotImplementedError

    def dump(self, prefix: str = "") -> List[tuple]:
        """[(key, value, age_seconds)] for every key under prefix, in ONE
        backend round trip, with ages measured on the BACKEND's clock
        (file mtime / server receive time) — so liveness comparisons are
        immune to cross-node wall-clock skew."""
        raise NotImplementedError

    # -- bulk blobs (KV-block handoff hygiene) --------------------------
    # Store values are strings (the TCP transport is line-JSON), so raw
    # bytes ride base64 inside a LENGTH-PREFIXED, CRC32-TAILED frame:
    #
    #     b64( !I payload_len | payload | !I crc32(payload) )
    #
    # get_bytes verifies both before returning — a truncated or
    # bit-flipped value surfaces as CorruptBlobError (transient) rather
    # than silently handing garbage to an importer. Implemented on the
    # base class over set/get so every backend gets the same frame.

    def put_bytes(self, key: str, data: bytes) -> None:
        frame = (struct.pack("!I", len(data)) + data
                 + struct.pack("!I", binascii.crc32(data) & 0xFFFFFFFF))
        self._set_text(key, base64.b64encode(frame))

    def get_bytes(self, key: str) -> Optional[bytes]:
        raw = self._get_text(key)
        if raw is None:
            return None
        try:
            if isinstance(raw, str):
                raw = raw.encode("ascii")
            frame = base64.b64decode(raw, validate=True)
        except (ValueError, binascii.Error) as e:
            raise CorruptBlobError(
                f"blob {key!r}: not a base64 frame ({e})") from None
        if len(frame) < 8:
            raise CorruptBlobError(
                f"blob {key!r}: frame too short ({len(frame)} bytes)")
        (n,) = struct.unpack("!I", frame[:4])
        if len(frame) != n + 8:
            raise CorruptBlobError(
                f"blob {key!r}: length prefix says {n} payload bytes, "
                f"frame holds {len(frame) - 8}")
        payload = frame[4:4 + n]
        (want,) = struct.unpack("!I", frame[4 + n:])
        got = binascii.crc32(payload) & 0xFFFFFFFF
        if got != want:
            raise CorruptBlobError(
                f"blob {key!r}: CRC32 mismatch (stored {want:#010x}, "
                f"computed {got:#010x})")
        return payload

    # a blob's base64 text as bytes: the stored value is the same string,
    # and a backend that can move bytes without a str round trip (the TCP
    # client) overrides these
    def _set_text(self, key: str, text: bytes) -> None:
        self.set(key, text.decode("ascii"))

    def _get_text(self, key: str):
        """The value as ``str``, or as ``bytes`` where the backend read
        it as bytes; None when unset."""
        return self.get(key)


class MemKVStore(KVStore):
    """In-process dict-backed store: the zero-infrastructure transport
    for single-process tests and the disagg handoff's in-process-queue
    mode. Thread-safe; ``dump`` ages come from per-key set times."""

    def __init__(self):
        self._data: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._data[key] = (value, time.time())

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            ent = self._data.get(key)
        return None if ent is None else ent[0]

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    def dump(self, prefix: str = "") -> List[tuple]:
        now = time.time()
        with self._lock:
            return [(k, v, now - ts)
                    for k, (v, ts) in sorted(self._data.items())
                    if k.startswith(prefix)]

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def add(self, key: str, amount: int = 1) -> int:
        with self._lock:
            cur = int(self._data.get(key, ("0", 0.0))[0]) + amount
            self._data[key] = (str(cur), time.time())
            return cur

    def set_if_absent(self, key: str, value: str) -> bool:
        with self._lock:
            if key in self._data:
                return False
            self._data[key] = (value, time.time())
            return True


class FileKVStore(KVStore):
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, urllib.parse.quote(key, safe=""))

    def set(self, key: str, value: str) -> None:
        tmp = self._path(key) + ".tmp"
        with open(tmp, "w") as f:
            f.write(value)
        os.replace(tmp, self._path(key))

    def get(self, key: str) -> Optional[str]:
        try:
            with open(self._path(key)) as f:
                return f.read()
        except OSError:
            return None

    def _set_text(self, key: str, text: bytes) -> None:
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(text)
        os.replace(tmp, self._path(key))

    def _get_text(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def keys(self, prefix: str = "") -> List[str]:
        out = []
        for name in os.listdir(self.root):
            if name.endswith((".tmp", ".lock", ".probe")):
                continue
            key = urllib.parse.unquote(name)
            if key.startswith(prefix):
                out.append(key)
        return sorted(out)

    def dump(self, prefix: str = "") -> List[tuple]:
        now = time.time()
        out = []
        for key in self.keys(prefix):
            try:
                age = now - os.path.getmtime(self._path(key))
                with open(self._path(key)) as f:
                    out.append((key, f.read(), age))
            except OSError:
                continue
        return out

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except OSError:
            pass

    def _backend_age(self, path: str, token: str) -> float:
        """Age of ``path`` measured on the BACKEND's clock: touch a
        per-caller probe file and diff the two mtimes — immune to
        client-vs-fileserver wall-clock skew (the same reason dump()
        reports backend ages)."""
        probe = path + "." + token + ".probe"
        try:
            with open(probe, "w"):
                pass
            return os.path.getmtime(probe) - os.path.getmtime(path)
        finally:
            try:
                os.remove(probe)
            except OSError:
                pass

    def _acquire(self, lock_path: str, deadline: float = 30.0) -> str:
        """O_CREAT|O_EXCL lock file with retry — exclusive create is
        atomic even on NFS/GCS-fuse where flock is advisory or absent.
        The lock records the holder's token; release only removes a
        lock the caller still owns, so a waiter that broke a stale lock
        cannot have its fresh lock deleted by the old holder, and a
        stale break re-checks the recorded token first so one breaker
        cannot delete another breaker's fresh lock. Staleness is
        probed at most once per second (the probe costs ~4 backend
        round trips; the cheap O_EXCL retry stays at 10ms). A holder
        that stalls past ``deadline`` without crashing can still race
        the breaker in the final read-vs-remove window — add() remains
        "atomic-enough", not a consensus protocol."""
        import uuid

        token = uuid.uuid4().hex
        end = time.monotonic() + deadline
        last_probe = float("-inf")
        while True:
            try:
                fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                with os.fdopen(fd, "w") as f:
                    f.write(token)
                return token
            except FileExistsError:
                pass
            if time.monotonic() - last_probe >= 1.0:
                last_probe = time.monotonic()
                try:
                    with open(lock_path) as f:
                        holder = f.read()
                    if self._backend_age(lock_path, token) > deadline:
                        if self._break_stale(lock_path, holder, token):
                            continue
                except OSError:
                    pass  # lock released / fs hiccup — retry below
            if time.monotonic() > end:
                raise TimeoutError(f"lock {lock_path} held too long")
            time.sleep(0.01)

    def _break_stale(self, lock_path: str, stale_token: str,
                     my_token: str) -> bool:
        """Break a stale lock ATOMICALLY: claim it by os.replace into a
        per-breaker path (only one breaker's replace finds the source),
        then confirm the captured content really is the stale holder.
        If a FRESH lock was displaced instead (holder changed between
        the age check and the replace), restore it with os.link —
        atomic, fails-if-exists, never overwrites a newer lock. The
        irreducible residual: three parties racing inside one backend
        round trip can still strand a fresh holder; see _acquire's
        "atomic-enough" disclaimer."""
        bpath = lock_path + "." + my_token + ".breaking"
        try:
            os.replace(lock_path, bpath)
        except OSError:
            return False  # another breaker got there first
        try:
            with open(bpath) as f:
                captured = f.read()
            if captured == stale_token:
                return True  # broke the stale lock
            try:
                os.link(bpath, lock_path)  # put the fresh lock back
            except OSError:
                pass  # someone re-created meanwhile; their lock stands
            return False
        finally:
            try:
                os.remove(bpath)
            except OSError:
                pass

    def _release(self, lock_path: str, token: str) -> None:
        try:
            with open(lock_path) as f:
                if f.read() != token:
                    return  # someone broke our (stale) lock; not ours now
            os.remove(lock_path)
        except OSError:
            pass

    def add(self, key: str, amount: int = 1) -> int:
        lock_path = self._path(key) + ".lock"
        token = self._acquire(lock_path)
        try:
            cur = int(self.get(key) or 0) + amount
            self.set(key, str(cur))
        finally:
            self._release(lock_path, token)
        return cur

    def set_if_absent(self, key: str, value: str) -> bool:
        # write the value to a tmp first, then CLAIM by hard-linking it
        # to the final path — link(2) is atomic and fails if the target
        # exists, so the key is never visible empty (readers racing a
        # plain O_EXCL-create-then-write could observe "")
        import uuid

        tmp = self._path(key) + "." + uuid.uuid4().hex + ".tmp"
        with open(tmp, "w") as f:
            f.write(value)
        try:
            os.link(tmp, self._path(key))
            return True
        except FileExistsError:
            return False
        except OSError:
            # hard links unsupported (gcsfuse) — fall back to exclusive
            # create + write: the CLAIM stays atomic, but a racing
            # reader can briefly observe the key empty on this backend,
            # and a claimant killed between create and write leaves an
            # empty file. Recover from the latter: a lost claim whose
            # key is still empty after 30s (backend clock) is a dead
            # claimant — remove it and retry once.
            for retry in (True, False):
                try:
                    fd = os.open(
                        self._path(key), os.O_CREAT | os.O_EXCL | os.O_WRONLY
                    )
                except FileExistsError:
                    if retry and self.get(key) == "":
                        try:
                            if self._backend_age(
                                self._path(key), uuid.uuid4().hex
                            ) > 30.0:
                                os.remove(self._path(key))
                                continue
                        except OSError:
                            pass
                    return False
                try:
                    with os.fdopen(fd, "w") as f:
                        f.write(value)
                except BaseException:
                    # write failed (ENOSPC/…): don't poison the key
                    try:
                        os.remove(self._path(key))
                    except OSError:
                        pass
                    raise
                return True
            return False
        finally:
            os.remove(tmp)


# the socket files' buffer: a line (a request or a reply) is read in
# buffer-sized receives, each of which gives up the GIL and must win it
# back; at the default 8 KiB a 1.5 GB value (a peer snapshot in base64) is
# ~190,000 of them, which a busy Python thread in the same process turns
# into minutes
_LINE_BUFFER = 1 << 22

# Large values (a blob's base64 text) skip the JSON codec, whose scan of a
# 1.5 GB string costs seconds, and the lines stay the bytes json.dumps
# writes, so either package's client and server read them. A string of
# "plain" characters (printable ASCII but the quote and the backslash) is
# its own JSON text between quotes: json.dumps escapes nothing in it, and
# json.loads reads the same characters back.
_PLAIN = bytes(c for c in range(0x20, 0x7F) if c not in b'"\\')
_SET_HEAD, _SET_VALUE, _TAIL = b'{"op": "set", "k": ', b', "v": "', b'"}\n'
_GOT_HEAD = b'{"ok": true, "v": "'


def _is_plain(text: bytes) -> bool:
    return not text.translate(None, _PLAIN)


def _set_line(key: str, text: bytes) -> bytes:
    """``json.dumps({"op": "set", "k": key, "v": text})`` plus its newline,
    for plain ``text``, without scanning it."""
    return _SET_HEAD + json.dumps(key).encode("ascii") + _SET_VALUE + text \
        + _TAIL


def _parse_line(line: bytes):
    """A request line as json.loads reads it; a set of a plain value is
    taken apart without the codec."""
    if line.startswith(_SET_HEAD) and line.endswith(_TAIL):
        # an unescaped '"v": "' ends the key: a JSON string holds a quote
        # only as an escape
        at = line.find(_SET_VALUE, len(_SET_HEAD))
        text = line[at + len(_SET_VALUE):-len(_TAIL)] if at > 0 else None
        if text is not None and _is_plain(text):
            try:
                key = json.loads(line[len(_SET_HEAD):at])
            except ValueError:
                key = None  # not json.dumps' layout: the codec decides
            if isinstance(key, str):
                return {"op": "set", "k": key, "v": text.decode("ascii")}
    return json.loads(line)


def _reply_line(resp: dict) -> bytes:
    """``json.dumps(resp)`` plus its newline; a reply holding one plain
    string value is written without scanning it."""
    v = resp.get("v")
    if list(resp) == ["ok", "v"] and resp["ok"] is True and \
            isinstance(v, str) and v.isascii():
        text = v.encode("ascii")
        if _is_plain(text):
            return _GOT_HEAD + text + _TAIL
    return json.dumps(resp).encode("ascii") + b"\n"


class TCPStoreServer:
    """Line-JSON KV server. Start on the master, stop() when done."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._data: Dict[str, str] = {}
        # request-dedup: rid -> result, so a client retrying a
        # NON-IDEMPOTENT op (add, set_if_absent) whose RESPONSE was lost
        # replays the cached answer instead of re-applying — exact-count
        # barriers stay exact and the claim winner stays the winner.
        # Bounded FIFO.
        self._add_seen: Dict[str, object] = {}
        self._add_order: List[str] = []
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._conns: set = set()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _remember(self, rid: str, result) -> None:
        self._add_seen[rid] = result
        self._add_order.append(rid)
        while len(self._add_order) > 4096:
            self._add_seen.pop(self._add_order.pop(0), None)

    def _serve(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(
                target=self._handle, args=(conn,), daemon=True
            ).start()
        self._sock.close()

    def _handle(self, conn):
        # one thread per connection, answering its lines until EOF: a
        # connection per request would leave a TIME_WAIT socket and a
        # thread start behind every heartbeat and poll
        with self._lock:
            self._conns.add(conn)
        try:
            with conn, conn.makefile("rwb", buffering=_LINE_BUFFER) as f:
                for line in f:
                    req = _parse_line(line)
                    op = req.get("op")
                    now = time.time()
                    try:
                        resp = self._dispatch(op, req, now)
                    except Exception as e:  # noqa: BLE001 — to the client
                        resp = {"ok": False,
                                "err": f"{type(e).__name__}: {e}"}
                    f.write(_reply_line(resp))
                    f.flush()
        except (OSError, ValueError):
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)

    def _dispatch(self, op, req, now):
        with self._lock:
            if op == "set":
                # stamped with the SERVER clock so dump() ages are
                # mutually comparable across skewed client clocks
                self._data[req["k"]] = (req["v"], now)
                return {"ok": True}
            if op == "get":
                ent = self._data.get(req["k"])
                return {"ok": True, "v": None if ent is None else ent[0]}
            if op == "keys":
                p = req.get("prefix", "")
                return {"ok": True,
                        "v": sorted(k for k in self._data if k.startswith(p))}
            if op == "dump":
                p = req.get("prefix", "")
                return {"ok": True, "v": [
                    (k, v, now - ts)
                    for k, (v, ts) in sorted(self._data.items())
                    if k.startswith(p)
                ]}
            if op == "delete":
                self._data.pop(req["k"], None)
                return {"ok": True}
            if op == "set_if_absent":
                rid = req.get("rid")
                if rid is not None and rid in self._add_seen:
                    return {"ok": True, "v": self._add_seen[rid]}
                won = req["k"] not in self._data
                if won:
                    self._data[req["k"]] = (req["v"], now)
                if rid is not None:
                    self._remember(rid, won)
                return {"ok": True, "v": won}
            if op == "add":
                rid = req.get("rid")
                if rid is not None and rid in self._add_seen:
                    return {"ok": True, "v": self._add_seen[rid]}
                ent = self._data.get(req["k"])
                cur = int(ent[0] if ent else "0") + int(req["amount"])
                self._data[req["k"]] = (str(cur), now)
                if rid is not None:
                    self._remember(rid, cur)
                return {"ok": True, "v": cur}
            return {"ok": False, "err": f"bad op {op!r}"}

    def stop(self):
        self._stop.set()
        self._thread.join(2.0)
        with self._lock:
            conns = list(self._conns)
        for conn in conns:  # a stopped server answers no open connection
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class TCPKVStore(KVStore):
    """One open connection per client, with reconnect-with-backoff: a
    connection reset / refused / timeout (master briefly overloaded,
    TCP blip, server restarting) retries under the op's Deadline
    instead of raising straight into the caller's heartbeat loop. A
    kept connection the server has closed since the last request is
    reopened at once (a one-request server closes every connection
    after its answer).

    ``timeout`` is the TOTAL per-operation budget (a Deadline); each
    connection attempt gets the remaining slice. ``add`` carries a
    request id the server dedups, so a retried increment whose first
    response was lost stays EXACTLY-once (rpc barriers count exact
    arrivals); everything else is idempotent under retry by nature.
    """

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 retry: Optional[RetryPolicy] = None):
        self.host, self.port, self.timeout = host, port, timeout
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=4, base_delay=0.1, max_delay=2.0,
            transient=self._is_transient)
        self._conn = self._file = None
        self._io_lock = threading.Lock()

    @staticmethod
    def _is_transient(exc: BaseException) -> bool:
        # OSError covers reset/refused/timeout; ValueError: empty or
        # truncated line-JSON response — the server closed mid-reply.
        # RuntimeError (server-side op error) is NOT transient: the
        # request reached a healthy server and the op itself failed.
        return isinstance(exc, (OSError, ValueError))

    def _req_once(self, payload: dict, timeout: Optional[float],
                  line: Optional[bytes] = None, text: bool = False):
        """One request: ``payload`` as its JSON line, or ``line`` as it
        is. With ``text``, a reply holding a plain string value gives it
        as bytes, read without the JSON codec."""
        if not _chaos.inject("store.request"):
            # a dropped request is a LOST MESSAGE, not an empty reply:
            # surface it as a transient error so the retry layer (and
            # wait_alive) see a failure, never a fabricated response
            raise ConnectionResetError(
                "chaos: store request dropped (lost message)")
        if line is None:
            line = json.dumps(payload).encode("ascii") + b"\n"
        with self._io_lock:
            # the kept connection first; a fresh one if the server has
            # closed the kept one since the last request
            for fresh in ((False, True) if self._conn is not None
                          else (True,)):
                if fresh:
                    self._close()
                    self._conn = socket.create_connection(
                        (self.host, self.port), timeout=timeout)
                    self._file = self._conn.makefile(
                        "rb", buffering=_LINE_BUFFER)
                try:
                    self._conn.settimeout(timeout)
                    self._conn.sendall(line)
                    raw = self._file.readline()
                except TimeoutError:
                    self._close()  # a late answer would meet the next ask
                    raise
                except OSError:
                    if fresh:
                        self._close()
                        raise
                    continue
                if raw or fresh:
                    break
            if text and raw.startswith(_GOT_HEAD) and raw.endswith(_TAIL):
                # json.dumps escapes with a backslash: none, nothing escaped
                value = raw[len(_GOT_HEAD):-len(_TAIL)]
                if b"\\" not in value:
                    return value
            try:
                resp = json.loads(raw)
            except ValueError:
                self._close()
                raise
        if not resp.get("ok"):
            raise RuntimeError(f"TCP store error: {resp.get('err')}")
        return resp.get("v")

    def _close(self) -> None:
        for h in (self._file, self._conn):
            if h is not None:
                try:
                    h.close()
                except OSError:
                    pass
        self._conn = self._file = None

    def _req(self, _deadline: Optional[Deadline] = None, _line=None,
             _text=False, **payload):
        dl = (_deadline if _deadline is not None
              else Deadline(self.timeout))
        return self.retry.call(
            lambda: self._req_once(payload, dl.timeout(self.timeout,
                                                       floor=0.05),
                                   _line, _text),
            deadline=dl, describe=f"TCP store {payload.get('op')}")

    def set(self, key: str, value: str) -> None:
        self._req(op="set", k=key, v=value)

    def get(self, key: str) -> Optional[str]:
        return self._req(op="get", k=key)

    def _set_text(self, key: str, text: bytes) -> None:
        self._req(op="set", _line=_set_line(key, text))

    def _get_text(self, key: str):
        return self._req(op="get", k=key, _text=True)

    def keys(self, prefix: str = "") -> List[str]:
        return self._req(op="keys", prefix=prefix)

    def dump(self, prefix: str = "") -> List[tuple]:
        return [tuple(e) for e in self._req(op="dump", prefix=prefix)]

    def delete(self, key: str) -> None:
        self._req(op="delete", k=key)

    def add(self, key: str, amount: int = 1) -> int:
        # a request id makes the increment EXACTLY-once under retry: if
        # the server applied it but the reply was lost, the retried
        # request replays the cached result instead of re-incrementing
        # (rpc barriers count exact arrivals)
        import uuid

        return self._req(op="add", k=key, amount=amount,
                         rid=uuid.uuid4().hex)

    def set_if_absent(self, key: str, value: str) -> bool:
        # same lost-reply hazard as add: without the rid, a retried
        # claim finds its OWN key present and tells the rightful winner
        # it lost (duplicate-rank detection would then abort the winner)
        import uuid

        return bool(self._req(op="set_if_absent", k=key, v=value,
                              rid=uuid.uuid4().hex))

    def wait_alive(self, deadline=30.0) -> None:
        """Block until the server answers; ``deadline`` is seconds or a
        Deadline. ONE retry discipline: a flat-backoff RetryPolicy over
        the raw probe, bounded by the deadline alone (no second loop
        stacked on _req's own retries), treating every transient —
        connect failures AND truncated mid-restart replies — alike."""
        dl = Deadline.coerce(deadline)
        probe = RetryPolicy(max_attempts=1_000_000, base_delay=0.2,
                            multiplier=1.0, transient=self._is_transient)
        try:
            probe.call(
                lambda: self._req_once(
                    {"op": "get", "k": "__ping__"},
                    dl.timeout(self.timeout, floor=0.05)),
                deadline=dl, describe="TCP store ping")
        except (OSError, ValueError):
            # transient exhaustion == the deadline ran out (attempts are
            # effectively unbounded); server-side RuntimeError means the
            # server IS alive and propagates as before
            raise TimeoutError(
                f"TCP store {self.host}:{self.port} not reachable "
                f"within {dl.budget}s"
            ) from None


def make_store(location: str) -> KVStore:
    """Path -> FileKVStore; tcp://host:port -> TCPKVStore."""
    if location.startswith("tcp://"):
        hostport = location[len("tcp://"):]
        host, port = hostport.rsplit(":", 1)
        return TCPKVStore(host, int(port))
    return FileKVStore(location)
