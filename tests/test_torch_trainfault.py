"""Port parity: fault-tolerant training (``paddle_tpu_torch/training``)
against the JAX package's ``paddle_tpu/training``.

- Exact, each scenario run in both packages: the health word, the
  anomaly detector's decisions and statistics, ``DataCursor``'s mapping,
  the peer tier's keys, meta and fallbacks (and each package reads the
  other's publishes), and telemetry's verdicts.
- Within the port, bitwise: a run with an injected NaN, spike or SDC rolls
  back to the loss of an uninjected run, eager and under ``to_static``.
- Against the reference: the supervised loss stream of ``LlamaConfig.tiny()``
  in f32 with the reference's weights and the same batches, with a NaN
  injected in both, to 1e-4 (f32 through two layers, sums in other orders),
  with the same rollbacks.
- Port-only hazards: a snapshot taken before more in-place steps still
  holds its step's values, and the two-process kill and peer resume
  through ``paddle_tpu_torch.testing.trainfault_worker``.
"""
import io
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import training as jtraining
from paddle_tpu.distributed import store as jstore
from paddle_tpu.distributed.communication import flight_recorder as jfr
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch import training as ttraining
from paddle_tpu_torch.distributed import store as tstore
from paddle_tpu_torch.distributed.communication import flight_recorder as tfr
from paddle_tpu_torch.testing import chaos as tchaos
from paddle_tpu_torch.testing.trainfault_worker import build_rig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": SimpleNamespace(tr=ttraining, st=tstore, chaos=tchaos,
                                fr=tfr),
        "reference": SimpleNamespace(tr=jtraining, st=jstore, chaos=jchaos,
                                     fr=jfr)}
ATOL = 1e-4  # the Llama stream: f32 through two layers, sums in other orders


@pytest.fixture(autouse=True)
def _clean():
    yield
    for P in PKGS.values():
        P.chaos.uninstall()
        P.fr.reset()


def _both(scenario):
    got = {name: scenario(P) for name, P in PKGS.items()}
    assert got["port"] == got["reference"]
    return got["port"]


# -- the health word, the detector, the cursor (exact) --------------------------
def test_health_word_matches_reference():
    import jax.numpy as jnp

    cases = [(1.25, 3.5), (float("nan"), float("inf")), (2.0, None),
             (1.0, 0.0)]
    for loss, gn in cases:
        t = ttraining.pack_health(torch.tensor(loss),
                                  None if gn is None else torch.tensor(gn))
        j = jtraining.pack_health(jnp.asarray(loss),
                                  None if gn is None else jnp.asarray(gn))
        assert t.dtype == torch.float32 and tuple(t.shape) == (5,)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert repr(ttraining.unpack_health(t)) == repr(
            jtraining.unpack_health(j))
    # a loss-only pack has no fingerprintable gradient norm
    assert ttraining.unpack_health(ttraining.pack_health(
        torch.tensor(1.0)))[1] is None


def test_detector_decisions_and_stats_match_reference():
    rng = np.random.RandomState(3)
    stream = list(np.abs(rng.randn(60)) * 0.1 + np.linspace(4.0, 2.0, 60))
    stream[20] = 90.0  # a spike
    stream[31] = float("nan")
    stream[44] = 2.6  # an uptick under the relative floor

    def scen(P):
        det = P.tr.AnomalyDetector(warmup_steps=6, spike_k=8.0)
        out = []
        for i, x in enumerate(stream):
            if i in (50, 51, 52, 53, 54):
                det.notify_scaler_skip(i)
            gn = None if i % 3 else float(x) * 2.0
            a = det.observe(float(x), gn)
            out.append(None if a is None else str(a))
        return out, det.snapshot()

    out, snap = _both(scen)
    assert sum(a is not None for a in out) == snap["n_anomalies"] == 2


def test_data_cursor_matches_reference():
    def scen(P):
        c = P.tr.DataCursor(lambda i: i)
        out = [c.batch(s) for s in (1, 2, 3)]
        c.quarantine(3)
        out.append([c.index(s) for s in (1, 2, 3, 4)])
        c.quarantine(5)
        out.append([c.index(s) for s in (2, 3, 4)])
        c2 = P.tr.DataCursor(lambda i: i)
        c2.set_state_dict(c.state_dict())
        return out, c2.quarantined

    assert _both(scen) == ([1, 2, 3, [1, 2, 4, 5], [2, 4, 6]], [3, 5])


# -- the port's rig: rollback within the port, bitwise ------------------------------
def _rig(poison=(), lr_sched=False):
    model, opt, batch_fn, step_fn = build_rig(torch.device("cpu"))
    scheds = []
    if lr_sched:
        from paddle_tpu_torch.optimizer.lr import StepDecay

        sched = StepDecay(learning_rate=1e-2, step_size=10)
        opt._learning_rate = sched
        scheds.append(sched)
        inner = step_fn

        def step_fn(batch, _s=inner):
            out = _s(batch)
            sched.step()
            return out

    def data(i):
        x, y = batch_fn(i)
        return (x * np.float32("nan"), y) if i in poison else (x, y)

    return model, opt, scheds, data, step_fn


def _sup(store=None, rank=0, world=1, tag="tf", **kw):
    model, opt, scheds, data, step_fn = _rig(kw.pop("poison", ()),
                                             kw.pop("lr_sched", False))
    peer = ttraining.PeerReplicator(store, rank, world, tag=tag) \
        if store is not None else None
    return ttraining.TrainingSupervisor(
        step_fn, data, layers=[model], optimizers=[opt],
        lr_schedulers=scheds, snapshot_interval=kw.pop("snapshot_interval",
                                                       5),
        peer=peer, **kw)


@pytest.mark.parametrize("site,at,kind", [
    ("train.nan", 17, "loss_nonfinite"), ("train.spike", 20, "loss_spike")])
def test_injected_fault_rolls_back_to_bitwise_loss(site, at, kind):
    clean = _sup().run(30)
    assert clean["rollbacks"] == 0
    sup = _sup()
    with tchaos.active(tchaos.ChaosSchedule().at(site, at, "drop")):
        rep = sup.run(30)
    assert rep["rollbacks"] == 1 and rep["anomalies"][0][1].startswith(kind)
    assert rep["final_loss"] == clean["final_loss"]


def test_rollback_restores_moments_and_lr_scheduler():
    clean = _sup(lr_sched=True).run(30)
    sup = _sup(lr_sched=True)
    with tchaos.active(tchaos.ChaosSchedule().at("train.nan", 12, "drop")):
        rep = sup.run(30)
    assert rep["rollbacks"] == 1
    assert rep["final_loss"] == clean["final_loss"]
    assert sup.lr_schedulers[0].last_epoch == 30


def test_poison_batches_quarantined_and_budget():
    rep = _sup(poison=(17,)).run(30)
    assert rep["quarantined"] == [17] and rep["rollbacks"] == 3
    assert np.isfinite(rep["final_loss"])
    rep = _sup(poison=(17, 19), snapshot_interval=10,
               rollback_budget=12).run(30)
    assert rep["quarantined"] == [17, 19]
    with pytest.raises(ttraining.TrainingGaveUp, match="budget exhausted"):
        _sup(poison=(17,), max_rollback_retries=100,
             rollback_budget=3).run(30)
    sup = _sup()
    with pytest.raises(ttraining.TrainingGaveUp, match="nothing to roll"):
        sup._handle_anomaly(1, ttraining.Anomaly("loss_nonfinite"))
    with pytest.raises(ValueError, match="multiple of"):
        _sup(snapshot_interval=10, peer_interval=3,
             store=tstore.MemKVStore())


def test_rollback_under_to_static_matches_eager_clean_run():
    """The step under ``jit.to_static`` in the CPU stand-in of a capture
    (``testing.capture.cpu_capture``): the rollback copies into the live
    tensors, so the replays reuse the one program and the loss is the
    clean run's."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.testing.capture import cpu_capture

    def rig():
        model, opt, batch_fn, _ = build_rig(torch.device("cpu"))

        def body(x, y):
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return ttraining.pack_health(loss)

        sf = jit.to_static(body, layers=[model], optimizers=[opt])
        sup = ttraining.TrainingSupervisor(
            lambda b: sf(torch.as_tensor(b[0]), torch.as_tensor(b[1])),
            batch_fn, layers=[model], optimizers=[opt], snapshot_interval=5)
        return sup, sf

    with cpu_capture():
        clean = rig()[0].run(20)
        sup, sf = rig()
        with tchaos.active(tchaos.ChaosSchedule().at("train.nan", 12,
                                                     "drop")):
            rep = sup.run(20)
    assert rep["rollbacks"] == 1
    assert rep["final_loss"] == clean["final_loss"]
    assert len(sf._graphs) == 1


def test_snapshot_holds_its_step_after_more_in_place_steps():
    """Port-only hazard: parameters and moments are written in place, so a
    snapshot that kept references would follow the live tensors."""
    sup = _sup()
    sup.run(5)
    step, snap = sup._snapshots[-1]
    frozen = {k: v.clone() for k, v in snap["model"][0].items()}
    moments = {k: v.clone() for k, v in snap["optim"][0].items()
               if torch.is_tensor(v)}
    sup.run(9)
    assert step == 5
    for k, v in frozen.items():
        assert torch.equal(snap["model"][0][k], v)
        assert not torch.equal(sup.layers[0].state_dict()[k], v)
    for k, v in moments.items():
        assert torch.equal(snap["optim"][0][k], v)


# -- against the reference: the Llama stream ---------------------------------------
def _llama_run(P, port, steps, spec):
    from paddle_tpu.models import LlamaConfig as JConfig
    from paddle_tpu.models import LlamaForCausalLM as JLlama
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils import load_jax_params

    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    rng = np.random.RandomState(11)
    data = [(np.ones((1,), np.float32),
             rng.randint(0, 256, (2, 16)).astype(np.int64))
            for _ in range(steps)]
    losses = {}
    if port:
        m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        load_jax_params(m, {n: np.asarray(p._data)
                            for n, p in jm.named_parameters()})
        opt = AdamW(learning_rate=1e-3, parameters=m.parameters())

        def step(b):
            ids = torch.from_numpy(b[1])
            loss = m.loss(ids, torch.roll(ids, -1, 1)) * \
                torch.from_numpy(b[0]).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses[len(losses)] = float(loss.detach())
            return loss
    else:
        import paddle_tpu.optimizer as jopt

        m = jm
        opt = jopt.AdamW(learning_rate=1e-3, parameters=m.parameters())

        def step(b):
            ids = paddle.to_tensor(b[1])
            labels = paddle.to_tensor(np.roll(b[1], -1, 1))
            loss = m.loss(ids, labels) * paddle.to_tensor(b[0]).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses[len(losses)] = float(loss.numpy())
            return loss

    sup = P.tr.TrainingSupervisor(
        step, lambda i: data[i - 1], layers=[m], optimizers=[opt],
        snapshot_interval=3,
        detector=P.tr.AnomalyDetector(warmup_steps=3))
    sched = P.chaos.ChaosSchedule()
    for site, at in spec:
        sched = sched.at(site, at, "drop")
    with P.chaos.active(sched):
        rep = sup.run(steps)
    return [losses[k] for k in sorted(losses)], rep


@pytest.mark.parametrize("spec", [(), (("train.nan", 5),),
                                  (("train.spike", 7),)],
                         ids=["clean", "nan", "spike"])
def test_llama_loss_stream_matches_reference(spec):
    got = {name: _llama_run(P, name == "port", 8, spec)
           for name, P in PKGS.items()}
    (tl, trep), (jl, jrep) = got["port"], got["reference"]
    assert trep["rollbacks"] == jrep["rollbacks"] == len(spec)
    assert [a[0] for a in trep["anomalies"]] == \
        [a[0] for a in jrep["anomalies"]]
    assert [a[1].split(":")[0] for a in trep["anomalies"]] == \
        [a[1].split(":")[0] for a in jrep["anomalies"]]
    assert len(tl) == len(jl)
    finite = [i for i, x in enumerate(jl) if np.isfinite(x) and x < 1e3]
    np.testing.assert_allclose(np.array(tl)[finite], np.array(jl)[finite],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(trep["final_loss"], jrep["final_loss"],
                               atol=ATOL, rtol=0)


# -- the peer tier (exact, both packages; each reads the other's) ------------------
def test_peer_protocol_matches_reference():
    def scen(P):
        out = []
        store = P.st.MemKVStore()
        rep = P.tr.PeerReplicator(store, 0, 2, tag="t1", keep=1)
        rep.publish(5, b"p5", block=True)
        out.append((rep.peer, rep.latest_step(), rep.fetch()))
        for s in (10, 15):
            rep.publish(s, f"p{s}".encode(), block=True)
        out.append((rep.fetch(), sorted(store.keys("t1/snap/0/data/"))))
        # a dropped meta leg leaves the previous publish current
        with P.chaos.active(P.chaos.ChaosSchedule().at("ckpt.peer", 2,
                                                        "drop")):
            rep.publish(20, b"p20", block=True)
        out.append((rep.latest_step(), rep.fetch()))
        # a corrupt data leg fails the inner CRC: the older replica wins
        with P.chaos.active(P.chaos.ChaosSchedule().at("ckpt.peer", 1,
                                                        "corrupt", 17)):
            rep.publish(25, b"bit-flipped-en-route", block=True)
        out.append((rep.latest_step(), rep.fetch(), rep.fetch_at(0, 25),
                    rep.fetch_at(0, 15), rep.ranks()))
        # a dropped data leg loses the whole publish
        with P.chaos.active(P.chaos.ChaosSchedule().at("ckpt.peer", 1,
                                                        "drop")):
            rep.publish(30, b"p30", block=True)
        out.append(rep.fetch())
        return out

    _both(scen)


def test_each_package_reads_the_others_publishes():
    for writer, reader in (("port", "reference"), ("reference", "port")):
        W, R = PKGS[writer], PKGS[reader]
        store = W.st.MemKVStore()
        W.tr.PeerReplicator(store, 1, 2, tag="x").publish(
            7, b"payload-7", block=True)
        got = R.tr.PeerReplicator(store, 0, 2, tag="x").fetch(rank=1)
        assert got == (7, b"payload-7")


# -- two tiers ---------------------------------------------------------------------
def _disk_sup(tmp_path, store=None, tag="two", keep=1):
    from paddle_tpu_torch.incubate.checkpoint import AutoCheckpoint

    model, opt, _, data, step_fn = _rig()
    ac = AutoCheckpoint(str(tmp_path), layers=[model], optimizers=[opt],
                        save_interval_steps=10, async_save=False)
    peer = None if store is None else ttraining.PeerReplicator(
        store, 0, 1, tag=tag, keep=keep)
    return ttraining.TrainingSupervisor(
        step_fn, data, layers=[model], optimizers=[opt],
        snapshot_interval=5, peer=peer, auto_checkpoint=ac)


def test_resume_prefers_peer_then_disk(tmp_path):
    ref = _sup().run(30)
    store = tstore.MemKVStore()
    sup = _disk_sup(tmp_path / "a", store)
    sup.run(20)
    sup.peer.wait()
    sup2 = _disk_sup(tmp_path / "a", store)
    assert sup2.resume() == 21  # the peer tier (step 20) ties disk: RAM wins
    assert any(k == "resume" and "peer RAM" in d for k, d in sup2.events)
    assert sup2.run(30)["final_loss"] == ref["final_loss"]
    # every peer payload vandalized: the verified disk tier (step 30 now)
    # restores, the same state the peer tier held
    for key in store.keys("two/snap/0/data/"):
        store.set(key, "not-a-valid-frame")
    sup3 = _disk_sup(tmp_path / "a", store)
    assert sup3.resume() == 31
    assert any(k == "resume" and "disk" in d for k, d in sup3.events)
    for k, v in sup3.layers[0].state_dict().items():
        assert torch.equal(v, sup2.layers[0].state_dict()[k])
    assert _disk_sup(tmp_path / "fresh").resume() == 1


def test_stale_peer_replica_loses_to_fresher_disk(tmp_path):
    ref = _sup().run(30)
    store = tstore.MemKVStore()
    sup = _disk_sup(tmp_path, store, tag="stale", keep=2)
    sup.run(20)
    sup.peer.wait()
    store.set("stale/snap/0/data/20", "garbage")
    sup2 = _disk_sup(tmp_path, store, tag="stale", keep=2)
    assert sup2.resume() == 21
    assert any(k == "resume_peer_stale" for k, _ in sup2.events)
    assert any(k == "resume" and "disk" in d for k, d in sup2.events)
    assert sup2.run(30)["final_loss"] == ref["final_loss"]


# -- telemetry ----------------------------------------------------------------------
def test_telemetry_verdicts_match_reference():
    def scen(P):
        store = P.st.MemKVStore()
        ts = [P.tr.TrainTelemetry(store, r, 3, tag="maj") for r in range(3)]
        for t, fp in zip(ts, ("aaaa", "bbbb", "aaaa")):
            t.publish(7, 0.1, fp)
        out = [ts[0].check(7, "aaaa").sdc_suspects,
               ts[1].check(7, "bbbb").sdc_suspects]
        two = [P.tr.TrainTelemetry(store, r, 2, tag="two") for r in range(2)]
        two[0].publish(3, 0.1, "x")
        two[1].publish(3, 0.1, "y")
        out.append(two[0].check(3, "x").sdc_suspects)
        fast = P.tr.TrainTelemetry(store, 0, 2, tag="strag",
                                   straggler_factor=2.0,
                                   straggler_patience=3)
        slow = P.tr.TrainTelemetry(store, 1, 2, tag="strag")
        for step in range(1, 8):
            fast.publish(step, 0.01, "x")
            slow.publish(step, 0.2, "x")
            out.append(fast.check(step).stragglers)
        buf = io.StringIO()
        P.fr.dump_on_watchdog(buf)
        out.append("PERSISTENT straggler" in buf.getvalue()
                   and "train_step" in buf.getvalue())
        fast.close()
        buf = io.StringIO()
        P.fr.dump_on_watchdog(buf)
        out.append("PERSISTENT straggler" in buf.getvalue())
        out.append(fast.high_water())
        dead = P.tr.TrainTelemetry(store, 0, 2, tag="dead", lockstep=True,
                                   lockstep_deadline_s=0.2)
        dead.publish(3, 0.01, "x")
        out.append(dead.check(3, "x").sdc)
        return out

    out = _both(scen)
    assert out[:3] == [[1], [1], [0, 1]] and out[-4:] == [True, False, 7,
                                                         False]


def test_two_replica_sdc_detected_and_healed_bitwise():
    store = tstore.MemKVStore()

    def build(rank):
        model, opt, _, data, step_fn = _rig()
        tele = ttraining.TrainTelemetry(store, rank, 2, tag="sdc",
                                        straggler_patience=10_000)
        return ttraining.TrainingSupervisor(
            step_fn, data, layers=[model], optimizers=[opt],
            snapshot_interval=5, telemetry=tele)

    clean = _sup().run(20)
    s0, s1 = build(0), build(1)
    for step in range(1, 21):
        s0.run(step)
        if step == 12:
            with tchaos.active(tchaos.ChaosSchedule().at("train.sdc", 1,
                                                         "drop")):
                s1.run(step)
        else:
            s1.run(step)
    assert s1.rollbacks == 1 and any("sdc" in a[1] for a in s1.anomalies)
    assert s0.report()["final_loss"] == clean["final_loss"]
    assert s1.report()["final_loss"] == clean["final_loss"]


def test_lockstep_epochs_compare_replays_only():
    """Port-only: under lockstep, records carry the rank's rollback epoch;
    after a rollback a check waits for (and compares only) peer records of
    the new epoch, never the abandoned record of the same step."""
    store = tstore.MemKVStore()
    t0 = ttraining.TrainTelemetry(store, 0, 2, tag="ep", lockstep=True,
                                  lockstep_deadline_s=0.3)
    t1 = ttraining.TrainTelemetry(store, 1, 2, tag="ep", lockstep=True,
                                  lockstep_deadline_s=0.3)
    t0.publish(3, 0.01, "bad")
    t1.publish(3, 0.01, "good")
    assert t0.check(3, "bad").sdc_suspects == [0, 1]
    t0.note_rollback()
    t1.note_rollback()
    t0.publish(3, 0.01, "good")
    # t1's record of step 3 is the abandoned epoch's: not compared
    assert not t0.check(3, "good").sdc
    assert t0.wait_for_peers(3) is False
    t1.publish(3, 0.01, "good")
    assert t0.wait_for_peers(3) is True and not t0.check(3, "good").sdc


# -- two processes: a NaN on rank 0, rank 1 killed and resumed from peer RAM -------
def _spawn(rank, addr, total, tag, spec=None):
    env = dict(os.environ)
    env.pop("PADDLE_CHAOS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update({"TF_DEVICE": "cpu", "TF_STORE": addr, "TF_RANK": str(rank),
                "TF_WORLD": "2", "TF_TOTAL": str(total), "TF_TAG": tag})
    if spec:
        env["PADDLE_CHAOS"] = spec
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.testing.trainfault_worker"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish(proc, timeout=240):
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


def _hex(stdout):
    for line in stdout.splitlines():
        if "final_hex=" in line:
            return line.split("final_hex=")[1].split()[0]
    return None


def test_two_process_nan_and_kill_recover_to_clean_loss():
    srv = tstore.TCPStoreServer(host="127.0.0.1")
    addr = f"127.0.0.1:{srv.port}"
    try:
        clean = _spawn(0, addr, 24, "clean")
        p0 = _spawn(0, addr, 24, "fault", "train.nan@8=drop")
        p1 = _spawn(1, addr, 24, "fault", "train.step@14=kill:19")
        rc1, o1, e1 = _finish(p1)
        assert rc1 == 19, (rc1, e1[-2000:])
        assert _hex(o1) is None
        p1b = _spawn(1, addr, 24, "fault")
        rc1b, o1b, e1b = _finish(p1b)
        rc0, o0, e0 = _finish(p0)
        rcc, oc, ec = _finish(clean)
        assert rcc == 0 and rc0 == 0 and rc1b == 0, (ec[-2000:], e0[-2000:],
                                                     e1b[-2000:])
        assert "resumed step=11 tier=peer" in o1b, o1b
        assert "rollbacks=1" in o0
        assert _hex(o0) == _hex(o1b) == _hex(oc) is not None
    finally:
        srv.stop()
