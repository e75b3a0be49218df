"""Port parity: the collective flight recorder
(``distributed/communication/flight_recorder.py``) against the JAX
package's.

Every scenario runs in both packages (each with its own recorder, chaos
monkey and stores) and must give the same text: the ring's contents, the
``comm.reorder`` deferrals, schedule diffs, contract verdicts and hang
dumps, exactly. Hang dumps with a peer's schedule and the supervisor's dump
stage, the resource ledger's section in a dump (the hook
``utils/resources.py`` registers), and a two-process contract over a
``TCPKVStore`` are held too. The reference's ``CommWatchdog`` stage and
its ``_fr_worker.py`` processes need collectives the port does not have
yet; the port's counterparts are the supervisor's dump stage and a worker
that records the same schedules.
"""
import io
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from paddle_tpu.distributed import store as jstore
from paddle_tpu.distributed.communication import flight_recorder as jfr
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch.analysis import CollectiveScheduleMismatch
from paddle_tpu_torch.base import flags as tflags
from paddle_tpu_torch.distributed import store as tstore
from paddle_tpu_torch.distributed.communication import flight_recorder as tfr
from paddle_tpu_torch.testing import chaos as tchaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": (tfr, tchaos, tstore), "reference": (jfr, jchaos, jstore)}


@pytest.fixture(autouse=True)
def _fresh_recorders():
    for fr, ch, _ in PKGS.values():
        fr.reset()
    yield
    for fr, ch, _ in PKGS.values():
        fr.reset()
        ch.uninstall()


def _both(scenario):
    """Run ``scenario(fr, chaos, store_module)`` in both packages; the port's
    result must equal the reference's. Returns the port's."""
    got = {name: scenario(*mods) for name, mods in PKGS.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def _filled(fr, ops, capacity=16):
    rec = fr.FlightRecorder(capacity=capacity)
    for op in ops:
        rec.record(op, (2,), "float32")
    return rec


def _fmt(sigs):
    return [s.format() for s in sigs]


# -- ring mechanics ----------------------------------------------------------


def test_records_signatures_in_issue_order():
    def scen(fr, ch, st):
        rec = fr.FlightRecorder(capacity=8)
        rec.record("all_reduce[sum]", (4, 2), "float32")
        rec.record("broadcast", (4,), "int32", detail="src=1")
        sigs = rec.snapshot()
        return ([(s.seq, s.op, s.shape, s.dtype) for s in sigs], _fmt(sigs),
                [dict(s.to_json(), t=0) for s in sigs])

    out = _both(scen)
    assert out[0][0] == (1, "all_reduce[sum]", (4, 2), "float32")
    assert "src=1" in out[1][1]


def test_ring_keeps_only_last_capacity_entries():
    def scen(fr, ch, st):
        rec = fr.FlightRecorder(capacity=4)
        for i in range(10):
            rec.record("barrier", (), "", detail=f"n={i}")
        return ([s.seq for s in rec.snapshot()],
                rec.snapshot(last_n=2)[0].seq)

    assert _both(scen) == ([7, 8, 9, 10], 9)


def test_capacity_defaults_to_the_flag():
    old = tflags.flag("comm_flight_recorder_len")
    assert old == 128  # the reference's default
    try:
        tflags.set_flags({"comm_flight_recorder_len": 7})
        assert tfr.FlightRecorder().capacity == 7
    finally:
        tflags.set_flags({"comm_flight_recorder_len": old})


@pytest.mark.parametrize("plan", ["swap", "fifo", "snapshot"])
def test_reorder_chaos_defers_like_the_reference(plan):
    def scen(fr, ch, st):
        rec = fr.FlightRecorder(capacity=8)
        sched = ch.ChaosSchedule().at("comm.reorder", 1, "drop")
        if plan == "fifo":
            sched = sched.at("comm.reorder", 2, "drop")
        with ch.active(sched) as mk:
            rec.record("all_reduce[sum]", (2,), "float32")
            if plan == "snapshot":
                # a snapshot is a synchronization point
                return [s.op for s in rec.snapshot()], list(mk.events)
            rec.record("broadcast", (2,), "float32", detail="src=0")
            if plan == "fifo":
                rec.record("c")
        return [s.op for s in rec.snapshot()], list(mk.events)

    ops, _ = _both(scen)
    assert ops == {"swap": ["broadcast", "all_reduce[sum]"],
                   "fifo": ["c", "all_reduce[sum]", "broadcast"],
                   "snapshot": ["all_reduce[sum]"]}[plan]


# -- schedule diff and contract ----------------------------------------------


@pytest.mark.parametrize("case", ["agree", "swap", "short", "p2p"])
def test_schedule_diff_text_matches(case):
    def scen(fr, ch, st):
        if case == "p2p":
            ra = fr.FlightRecorder(capacity=8)
            ra.record("send", (2,), "float32", peer=1)
            ra.record("all_reduce[sum]", (2,), "float32")
            rb = fr.FlightRecorder(capacity=8)
            rb.record("recv", peer=0)
            rb.record("handoff_recv", (2,), "float32")
            rb.record("all_reduce[sum]", (2,), "float32")
            return fr.schedule_diff({0: ra.snapshot(), 1: rb.snapshot()})
        a = ["all_reduce[sum]", "broadcast"]
        b = {"agree": a, "swap": a[::-1], "short": a[:1]}[case]
        return fr.schedule_diff({0: _filled(fr, a).snapshot(),
                                 1: _filled(fr, b).snapshot()})

    diff = _both(scen)
    if case in ("agree", "p2p"):
        assert diff is None
    else:
        assert "full recorded schedules" in diff
        assert ("(nothing)" in diff) == (case == "short")


def _pair(fr, store, r0, r1, **kw):
    res = {}

    def run(rank, rec):
        try:
            res[rank] = fr.contract(store, rank, 2, recorder_=rec,
                                    deadline=20.0, **kw)
        except Exception as e:  # noqa: BLE001 - compared below
            res[rank] = e
    ts = [threading.Thread(target=run, args=(0, r0)),
          threading.Thread(target=run, args=(1, r1))]
    [t.start() for t in ts]
    [t.join() for t in ts]
    return res


def _verdict(res):
    return {r: (type(v).__name__, str(v)) if isinstance(v, Exception)
            else {k: _fmt(s) for k, s in v.items()} for r, v in res.items()}


@pytest.mark.parametrize("case", ["agree", "diverge", "asymmetric_p2p"])
def test_contract_verdicts_match(tmp_path, case):
    def scen(fr, ch, st):
        store = st.FileKVStore(str(tmp_path / fr.__name__ / case))
        a = ["all_reduce[sum]", "broadcast"]
        if case == "asymmetric_p2p":
            r0, r1 = (fr.FlightRecorder(capacity=64) for _ in range(2))
            for r in (r0, r1):
                for _ in range(4):
                    r.record("all_reduce[sum]", (2,), "float32")
            r0.record("send", (2,), "float32", peer=1)
            r0.record("handoff_send", (2,), "float32")
            r1.record("recv", peer=0)
            return _verdict(_pair(fr, store, r0, r1, last_n=4))
        b = a if case == "agree" else a[::-1]
        return _verdict(_pair(fr, store, _filled(fr, a), _filled(fr, b)))

    out = _both(scen)
    if case == "diverge":
        for rank in (0, 1):
            name, msg = out[rank]
            assert name == "CollectiveScheduleMismatch"
            assert "rank 0:" in msg and "rank 1:" in msg
    else:
        assert all(isinstance(v, dict) for v in out.values())


def test_contract_raises_the_ports_mismatch_class(tmp_path):
    store = tstore.FileKVStore(str(tmp_path))
    res = _pair(tfr, store, _filled(tfr, ["a", "b"]), _filled(tfr, ["b", "a"]))
    assert all(isinstance(v, CollectiveScheduleMismatch)
               for v in res.values())
    assert issubclass(CollectiveScheduleMismatch, AssertionError)


def test_contract_times_out_on_missing_peer(tmp_path):
    from paddle_tpu_torch.utils.retries import BudgetExceeded

    store = tstore.FileKVStore(str(tmp_path))
    with pytest.raises(BudgetExceeded, match="rank 1"):
        tfr.contract(store, 0, 2, deadline=0.3,
                     recorder_=_filled(tfr, ["broadcast"]))


# -- hang dumps ----------------------------------------------------------------


def test_dump_on_watchdog_prints_the_local_ring():
    def scen(fr, ch, st):
        fr.record("all_reduce[sum]", (8,), "float32")
        fr.record("broadcast", (8,), "float32", detail="src=0")
        buf = io.StringIO()
        fr.dump_on_watchdog(buf)
        return buf.getvalue()

    out = _both(scen)
    assert "#1 all_reduce[sum]" in out and "#2 broadcast" in out


def _dump_with_peer(fr, st, peer_ops, age, tmp):
    store = st.FileKVStore(tmp)
    peer = _filled(fr, peer_ops)
    store.set("graft/fr_hang/1", json.dumps({
        "published_at": time.time() - age,
        "schedule": [s.to_json() for s in peer.snapshot()]}))
    fr.record("all_reduce[sum]", (2,), "float32")
    fr.record("broadcast", (2,), "float32")
    fr.attach_contract(store, 0, 2)
    buf = io.StringIO()
    fr.dump_on_watchdog(buf)
    return buf.getvalue(), bool(store.get("graft/fr_hang/0"))


@pytest.mark.parametrize("age", [0.0, 3600.0], ids=["fresh", "stale"])
def test_dump_diffs_against_a_published_peer(tmp_path, age):
    def scen(fr, ch, st):
        return _dump_with_peer(fr, st, ["broadcast", "all_reduce[sum]"],
                               age, str(tmp_path / fr.__name__))

    text, published = _both(scen)
    assert published and "cross-rank schedule diff" in text
    assert ("PREVIOUS incident" in text) == (age > 0)


def test_dump_names_both_roles_of_a_handoff():
    """A decode worker's hang dump with the handoff contract attached
    prints the prefill role's schedule too, and the mirrored handoff legs
    are not called a divergence."""
    def scen(fr, ch, st):
        store = st.MemKVStore()
        pf_ring = fr.FlightRecorder(capacity=8)
        pf_ring.record("handoff_send", shape=(2, 2, 2, 1, 8, 4),
                       dtype="float32", group="disagg/dx0", detail="req=q0")
        store.set("graft/fr_hang/0", json.dumps({
            "published_at": time.time(),
            "schedule": [s.to_json() for s in pf_ring.snapshot()]}))
        fr.record("handoff_recv", shape=(2, 2, 2, 1, 8, 4),
                  dtype="float32", group="disagg/dx0", detail="req=q0")
        fr.attach_contract(store, 1, 2)
        buf = io.StringIO()
        fr.dump_on_watchdog(buf)
        return buf.getvalue()

    out = _both(scen)
    assert "handoff_recv" in out and "handoff_send" in out
    assert "schedules agree" in out


def test_outstanding_resources_ride_the_hang_dump():
    """With the resource ledger on, a hang dump names every outstanding
    block, slot and handoff hold with its acquisition site."""
    from paddle_tpu_torch.ops.paged_attention import BlockManager
    from paddle_tpu_torch.utils import resources

    led = resources.instrument_resources()
    try:
        mgr = BlockManager(8, 8)
        mgr.allocate("s0", 8)
        led.acquire("handoff.hold", "s0")
        buf = io.StringIO()
        tfr.dump_on_watchdog(buf)
        text = buf.getvalue()
        assert "-- graft-own: outstanding resources --" in text
        assert "kv.block" in text and "handoff.hold 's0'" in text
        assert "acquired at" in text
    finally:
        resources.uninstrument_resources()
    buf = io.StringIO()
    tfr.dump_on_watchdog(buf)
    assert "graft-own" not in buf.getvalue()  # the hook left with it


def test_supervisor_dump_stage_includes_the_ring(monkeypatch, capsys):
    """The supervisor's watchdog ladder dumps the flight recorder at its
    dump stage (the port's counterpart of the CommWatchdog wiring)."""
    import faulthandler

    from paddle_tpu_torch.inference.supervisor import ServingSupervisor

    monkeypatch.setattr(faulthandler, "dump_traceback", lambda **kw: None)

    class Slow:
        warmed_up = True
        _queue, num_active, _completed = [], 0, {}
        n_shed, n_expired, last_step_s = {}, 0, 0.0

        def step(self):
            time.sleep(0.3)
            return []

        def fence(self):
            pass

        def drain_shed(self):
            return []

    tfr.record("all_reduce[sum]", (2,), "float32")
    sup = ServingSupervisor(Slow, step_budget=0.2, dump_fraction=0.5,
                            warn_fraction=0.25, max_consecutive_failures=0)
    with pytest.raises(Exception):
        sup.step()
    err = capsys.readouterr().err
    assert "CollectiveFlightRecorder" in err and "all_reduce[sum]" in err


_WORKER = """
import sys
from paddle_tpu_torch.distributed.communication import flight_recorder as fr
from paddle_tpu_torch.distributed.store import TCPKVStore
from paddle_tpu_torch.analysis import CollectiveScheduleMismatch
rank, port = int(sys.argv[1]), int(sys.argv[2])
fr.record("all_reduce[sum]", (4,), "float32")
fr.record("broadcast", (4,), "float32", detail="src=0")
try:
    fr.contract(TCPKVStore("127.0.0.1", port), rank, 2, deadline=60.0)
except CollectiveScheduleMismatch as e:
    print(f"CONTRACT_MISMATCH rank {rank}\\n{e}", flush=True)
    sys.exit(3)
print(f"CONTRACT_OK rank {rank}", flush=True)
"""


@pytest.mark.parametrize("chaos_on_rank1", [False, True],
                         ids=["identical", "reordered"])
def test_two_process_contract_over_tcp(chaos_on_rank1):
    """Two processes record the same program; with ``comm.reorder`` on
    rank 1 both report the divergence naming both ranks' schedules."""
    server = tstore.TCPStoreServer(host="127.0.0.1")
    procs = []
    try:
        for rank in (0, 1):
            env = dict(os.environ)
            env.pop("PADDLE_CHAOS", None)
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            if rank == 1 and chaos_on_rank1:
                env["PADDLE_CHAOS"] = "comm.reorder@1=drop"
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(rank), str(server.port)],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        detail = f"rank{rank} rc={p.returncode}\n{out}\n{err}"
        if chaos_on_rank1:
            assert p.returncode == 3, detail
            assert f"CONTRACT_MISMATCH rank {rank}" in out, detail
            assert "rank 0:" in out and "rank 1:" in out, detail
        else:
            assert p.returncode == 0, detail
            assert f"CONTRACT_OK rank {rank}" in out, detail
