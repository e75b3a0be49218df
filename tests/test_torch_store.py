"""Port parity: the KV stores (``distributed/store.py``) against the JAX
package's.

Held exactly: the same operations give the same answers on every backend;
the CRC-framed blobs of ``put_bytes`` are byte-identical, and a frame one
package writes the other reads (both ways, over a shared directory and
over each other's TCP server); damaged frames raise ``CorruptBlobError``
with the same message; the ``store.request`` chaos site retries the same
way. The reference's elastic-membership and RPC cases need modules the
port does not have yet (``fleet.elastic``, ``distributed.rpc``).
"""
import base64
import socket

import pytest

from paddle_tpu.distributed import store as jstore
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch.distributed import store as tstore
from paddle_tpu_torch.testing import chaos as tchaos
from paddle_tpu_torch.utils.retries import BudgetExceeded


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    tchaos.uninstall()
    jchaos.uninstall()


def _stores(mod, kind, tmp_path):
    """(store, server or None) of package ``mod``."""
    if kind == "file":
        return mod.FileKVStore(str(tmp_path / mod.__name__)), None
    if kind == "mem":
        return mod.MemKVStore(), None
    server = mod.TCPStoreServer(host="127.0.0.1")
    return mod.TCPKVStore("127.0.0.1", server.port), server


def _script(store):
    """The reference's round-trip scenario plus the blob and claim ops;
    returns everything it observed."""
    seen = [store.get("missing")]
    store.set("a/b", "v1")
    store.set("a/c", "v2")
    store.set("z", "v3")
    seen += [store.get("a/b"), store.keys("a/")]
    store.delete("a/b")
    seen += [store.get("a/b"), store.add("count", 2), store.add("count", 3)]
    seen += [store.set_if_absent("claim", "x"),
             store.set_if_absent("claim", "y"), store.get("claim")]
    data = bytes(range(256)) * 41
    store.put_bytes("blob", data)
    store.put_bytes("empty", b"")
    seen += [store.get_bytes("blob") == data, store.get_bytes("empty"),
             store.get_bytes("absent"), store.get("blob")]
    seen.append([(k, v) for k, v, _ in store.dump("a/")])
    return seen


@pytest.mark.parametrize("kind", ["file", "tcp", "mem"])
def test_roundtrip_matches_reference(tmp_path, kind):
    got = []
    for mod in (tstore, jstore):
        store, server = _stores(mod, kind, tmp_path)
        try:
            got.append(_script(store))
        finally:
            if server:
                server.stop()
    assert got[0] == got[1]
    assert got[0][:3] == [None, "v1", ["a/b", "a/c"]]


def test_make_store(tmp_path):
    assert isinstance(tstore.make_store(str(tmp_path)), tstore.FileKVStore)
    s = tstore.make_store("tcp://1.2.3.4:555")
    assert isinstance(s, tstore.TCPKVStore) and s.port == 555


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_frames_cross_packages(tmp_path, writer):
    """A blob put by one package over a shared directory, and through the
    other package's TCP server, is read back exactly by the other; the
    stored frames are the same string."""
    w, r = (tstore, jstore) if writer == "port" else (jstore, tstore)
    payloads = {"p0": b"", "p1": b"\x00\xff" * 4097,
                "p2": bytes(range(256)) * 300}
    wf = w.FileKVStore(str(tmp_path / "shared"))
    rf = r.FileKVStore(str(tmp_path / "shared"))
    for k, v in payloads.items():
        wf.put_bytes(k, v)
    assert {k: rf.get_bytes(k) for k in payloads} == payloads
    other = r.MemKVStore()
    for k, v in payloads.items():
        other.put_bytes(k, v)
        assert other.get(k) == wf.get(k)  # byte-identical frames
    server = r.TCPStoreServer(host="127.0.0.1")
    try:
        wc = w.TCPKVStore("127.0.0.1", server.port)
        rc = r.TCPKVStore("127.0.0.1", server.port)
        for k, v in payloads.items():
            wc.put_bytes(k, v)
            assert rc.get_bytes(k) == v
        assert sorted(rc.keys("p")) == sorted(payloads)
        assert wc.add("n", 4) == 4 and rc.add("n", 1) == 5
    finally:
        server.stop()


def _damaged(mod):
    store = mod.MemKVStore()
    store.put_bytes("b", b"payload bytes" * 50)
    frame = bytearray(base64.b64decode(store.get("b")))
    frame[100] ^= 0x10
    msgs = []
    for raw in (base64.b64encode(bytes(frame)).decode(),
                store.get("b")[: len(store.get("b")) // 2],
                "!!not base64!!", base64.b64encode(b"abc").decode()):
        store.set("x", raw)
        with pytest.raises(mod.CorruptBlobError) as e:
            store.get_bytes("x")
        msgs.append(str(e.value))
    return msgs


def test_damaged_frames_raise_the_same_errors():
    got, want = _damaged(tstore), _damaged(jstore)
    assert got == want
    assert "CRC32 mismatch" in got[0]
    assert tstore.TCPKVStore._is_transient(tstore.CorruptBlobError("x"))
    assert tstore.TCPKVStore._is_transient(ConnectionResetError("x"))
    assert not tstore.TCPKVStore._is_transient(KeyError("x"))


def test_store_request_chaos_site_retries_like_the_reference():
    """A ``reset`` and a ``drop`` at ``store.request`` are transient: the
    client retries under its deadline and the op lands; both packages
    record the same fired faults."""
    events = []
    for mod, ch in ((tstore, tchaos), (jstore, jchaos)):
        server = mod.TCPStoreServer(host="127.0.0.1")
        try:
            sched = (ch.ChaosSchedule().at("store.request", 1, "reset")
                     .at("store.request", 3, "drop"))
            with ch.active(sched) as mk:
                c = mod.TCPKVStore("127.0.0.1", server.port)
                c.set("k", "v")
                assert c.get("k") == "v"
                events.append(list(mk.events))
        finally:
            server.stop()
    assert events[0] == events[1]
    assert [e[2] for e in events[0]] == ["reset", "drop"]


def test_tcp_client_gives_up_on_a_dead_server():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    c = tstore.TCPKVStore("127.0.0.1", port, timeout=0.2)
    with pytest.raises(Exception) as e:
        c.get("k")
    assert isinstance(e.value, (OSError, TimeoutError)) or \
        "budget" in str(e.value).lower()


def test_tcp_client_keeps_one_connection():
    """A client sends every request down one kept connection; one the
    server has dropped is reopened, and a stopped server answers no open
    connection."""
    server = tstore.TCPStoreServer(host="127.0.0.1")
    c = tstore.TCPKVStore("127.0.0.1", server.port, timeout=0.5)
    try:
        c.set("k", "v")
        conn = c._conn
        for i in range(50):
            c.set(f"k{i}", str(i))
        assert [c.get(f"k{i}") for i in range(50)] == \
            [str(i) for i in range(50)]
        assert c._conn is conn and len(server._conns) == 1
        for s in list(server._conns):
            s.shutdown(socket.SHUT_RDWR)
        assert c.get("k") == "v" and c._conn is not conn
    finally:
        server.stop()
    with pytest.raises(BudgetExceeded, match="ConnectionRefusedError"):
        c.get("k")


_TRICKY = ["", "plain text", 'a "quoted" value', "back\\slash", "tab\tnew\nline",
           "del\x7f", "café", "☃ snow", "k\u0000nul"]


def test_blob_lines_are_the_bytes_json_dumps_writes():
    """The TCP store writes a blob's base64 text and reads it back without
    the JSON codec: its set line and its get reply are the bytes json.dumps
    gives, a line the codec reads the same, and a value the codec would
    escape takes the codec's path."""
    import json

    text = base64.b64encode(bytes(range(256)) * 9)
    for key in ("blob", 'k"ey', "pé/\\x"):
        line = tstore._set_line(key, text)
        assert line == json.dumps(
            {"op": "set", "k": key, "v": text.decode()}).encode() + b"\n"
        assert tstore._parse_line(line) == json.loads(line)
    for value in _TRICKY + [text.decode()]:
        for key in ("k", 'k"', "k, \"v\": \"x"):
            line = json.dumps({"op": "set", "k": key, "v": value}).encode() \
                + b"\n"
            assert tstore._parse_line(line) == json.loads(line)
        for resp in ({"ok": True, "v": value}, {"v": value, "ok": True},
                     {"ok": False, "err": value}):
            assert tstore._reply_line(resp) == \
                json.dumps(resp).encode() + b"\n"
    for resp in ({"ok": True, "v": None}, {"ok": True, "v": ["a", "b"]},
                 {"ok": True, "v": 3}, {"ok": True}):
        assert tstore._reply_line(resp) == json.dumps(resp).encode() + b"\n"


@pytest.mark.parametrize("server_pkg", ["port", "reference"])
def test_tcp_values_and_blobs_cross_the_fast_path(server_pkg):
    """Values the codec escapes and blobs larger than the socket buffers
    go both ways between the port's client and either package's server,
    and the reference's client reads what the port's client put."""
    srv_mod = tstore if server_pkg == "port" else jstore
    server = srv_mod.TCPStoreServer(host="127.0.0.1")
    try:
        tc = tstore.TCPKVStore("127.0.0.1", server.port)
        jc = jstore.TCPKVStore("127.0.0.1", server.port)
        for i, v in enumerate(_TRICKY):
            tc.set(f"v{i}", v)
            assert tc.get(f"v{i}") == v and jc.get(f"v{i}") == v
        blob = bytes(range(256)) * 24_577  # ~6.3 MB: past the 4 MiB buffer
        tc.put_bytes("big", blob)
        assert tc.get_bytes("big") == blob and jc.get_bytes("big") == blob
        jc.put_bytes("small", b"\x00\x01")
        assert tc.get_bytes("small") == b"\x00\x01"
        tc.set("odd", 'not "base64"')
        with pytest.raises(tstore.CorruptBlobError):
            tc.get_bytes("odd")
        assert tc.get_bytes("absent") is None
    finally:
        server.stop()
