"""Port parity: the disk tier (``incubate/checkpoint/auto_checkpoint.py``)
against the JAX package's.

Each scenario runs in both packages on a ``Linear(4, 3)`` with the same
weights (the reference's carried into the port) and the same batches:
the checkpoints kept, the steps resumed, the quarantines and the torn
saves skipped are equal, and the restored weights agree to 1e-6 (f32
AdamW steps, the same expressions in other orders). Each package resumes
the other's checkpoint directory. Port-only: an async save (and a
synchronous one) holds its step's values while the parameters are written
in place before the writer runs, and a resume copies into the live tensors
(their addresses stay).
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.framework import io as jfio
from paddle_tpu.incubate import checkpoint as jckpt
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch.framework import io as tfio
from paddle_tpu_torch.incubate import checkpoint as tckpt
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.testing import chaos as tchaos
from paddle_tpu_torch.utils import load_jax_params

TOL = 1e-6


def _jax_model():
    paddle.seed(0)
    return jnn.Linear(4, 3)


class _Port:
    name = "port"
    ck, chaos, fio = tckpt, tchaos, tfio

    @staticmethod
    def make(tmp_path, **kw):
        jm = _jax_model()
        m = Linear(4, 3, device="cpu", dtype=torch.float32)
        load_jax_params(m, {n: np.asarray(p._data)
                            for n, p in jm.named_parameters()})
        o = AdamW(learning_rate=0.01, parameters=m.parameters())
        return m, o, tckpt.AutoCheckpoint(str(tmp_path), layers=[m],
                                          optimizers=[o], **kw)

    @staticmethod
    def step(m, o, x, y):
        loss = TF.cross_entropy(m(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        o.step()
        o.clear_grad()
        return float(loss.detach())

    @staticmethod
    def weight(m):
        return m.weight.detach().numpy().copy()


class _Ref:
    name = "reference"
    ck, chaos, fio = jckpt, jchaos, jfio

    @staticmethod
    def make(tmp_path, **kw):
        m = _jax_model()
        o = jopt.AdamW(learning_rate=0.01, parameters=m.parameters())
        return m, o, jckpt.AutoCheckpoint(str(tmp_path), layers=[m],
                                          optimizers=[o], **kw)

    @staticmethod
    def step(m, o, x, y):
        loss = JF.cross_entropy(m(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        o.step()
        o.clear_grad()
        return float(loss)

    @staticmethod
    def weight(m):
        return np.asarray(m.weight._data).copy()


PKGS = (_Port, _Ref)


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    tchaos.uninstall()
    jchaos.uninstall()


def _train(P, m, o, ac, start, n):
    rng = np.random.RandomState(7)
    out = []
    for step in range(start, start + n):
        x = rng.randn(8, 4).astype(np.float32)
        y = rng.randint(0, 3, (8,)).astype(np.int64)
        out.append(P.step(m, o, x, y))
        ac.step(step)
    return out


def _both(scen, tmp_path):
    got = {P.name: scen(P, tmp_path / P.name) for P in PKGS}
    return got["port"], got["reference"]


def _same(t, j):
    """Equal, with the float leaves (losses, weights) to TOL."""
    if isinstance(t, dict):
        assert set(t) == set(j)
        for k in t:
            _same(t[k], j[k])
    elif isinstance(t, (list, tuple)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _same(a, b)
    elif isinstance(t, (float, np.ndarray, np.floating)):
        np.testing.assert_allclose(t, j, atol=TOL, rtol=0)
    else:
        assert t == j


def test_interval_save_keep_last_k_and_resume(tmp_path):
    def scen(P, d):
        m, o, ac = P.make(d, save_interval_steps=5, async_save=False)
        out = [ac.resume()]
        out.append(_train(P, m, o, ac, 0, 12))
        out.append([s for s, _ in ac._list_ckpts()])
        m2, o2, ac2 = P.make(d, save_interval_steps=5, async_save=False)
        out += [ac2.resume(), P.weight(m2), ac2.latest_step()]
        m3, o3, ac3 = P.make(d / "k", save_interval_steps=2, keep_last_k=2,
                             async_save=False)
        _train(P, m3, o3, ac3, 0, 11)
        out.append([s for s, _ in ac3._list_ckpts()])
        m4, o4, ac4 = P.make(d / "async", save_interval_steps=3)
        _train(P, m4, o4, ac4, 0, 7)
        ac4.wait()
        out.append([s for s, _ in ac4._list_ckpts()])
        return out

    t, j = _both(scen, tmp_path)
    _same(t, j)
    assert t[0] == 0 and t[2] == [5, 10] and t[3] == 11 and t[6] == [8, 10]


def test_torn_truncated_and_flipped_checkpoints(tmp_path):
    def scen(P, d):
        out = []
        m, o, ac = P.make(d / "torn", save_interval_steps=4,
                          async_save=False)
        _train(P, m, o, ac, 0, 9)
        os.remove(os.path.join(ac._list_ckpts()[-1][1], "meta.json"))
        out.append(P.make(d / "torn", save_interval_steps=4,
                          async_save=False)[2].resume())
        m, o, ac = P.make(d / "trunc", save_interval_steps=1,
                          async_save=False)
        _train(P, m, o, ac, 0, 3)
        payload = os.path.join(ac._list_ckpts()[-1][1], "state.pdparams")
        data = open(payload, "rb").read()
        with open(payload, "wb") as f:
            f.write(data[: len(data) // 2])
        m2, _, ac2 = P.make(d / "trunc", save_interval_steps=1,
                            async_save=False)
        out.append(ac2.resume())
        out.append(sorted(n.split(".")[0] for n in os.listdir(d / "trunc")
                          if n.endswith(".corrupt")))
        out.append(P.make(d / "trunc", save_interval_steps=1,
                          async_save=False)[2].resume())
        out.append(P.weight(m2))
        step, path = ac2._list_ckpts()[-1]
        meta = json.load(open(os.path.join(path, "meta.json")))
        out.append(sorted(meta))
        raw = bytearray(open(os.path.join(path, "state.pdparams"),
                             "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        with open(os.path.join(path, "state.pdparams"), "wb") as f:
            f.write(bytes(raw))
        out.append(ac2._verify(path))
        return out

    t, j = _both(scen, tmp_path)
    _same(t, j)
    assert t[:2] == [5, 2] and t[2] == ["ckpt-000000000002"] and t[3] == 2
    assert t[5] == ["crc32", "done", "payload_bytes", "step", "time"]
    assert t[6] is False


def test_chaos_write_and_publish_sites(tmp_path):
    def scen(P, d):
        m, o, ac = P.make(d, save_interval_steps=1, async_save=False)
        with P.chaos.active(P.chaos.ChaosSchedule()
                            .at("ckpt.write", 2, "drop")
                            .at("ckpt.publish", 3, "drop")):
            _train(P, m, o, ac, 0, 5)
        names = sorted(n.split(".")[0] for n in os.listdir(d))
        return [s for s, _ in ac._list_ckpts()], names

    t, j = _both(scen, tmp_path)
    assert t == j and t[0] == [1, 3]


def test_extra_state_rng_cursor_and_epoch_range(tmp_path):
    def scen(P, d):
        holder = {"lr_step": 42}
        m, o, ac = P.make(d, save_interval_steps=1, async_save=False,
                          extra_state=lambda: dict(holder),
                          set_extra_state=holder.update)
        _train(P, m, o, ac, 0, 2)
        holder["lr_step"] = 0
        m2, o2, ac2 = P.make(d, save_interval_steps=1, async_save=False,
                             extra_state=lambda: dict(holder),
                             set_extra_state=holder.update)
        out = [ac2.resume(), holder["lr_step"]]
        seen = []
        rng = P.ck.TrainEpochRange(4, str(d / "ep"), layers=[m],
                                   optimizers=[o], async_save=False)
        for epoch in rng:
            seen.append(epoch)
            if epoch == 1:
                break
        rng2 = P.ck.TrainEpochRange(4, str(d / "ep"), layers=[m],
                                    optimizers=[o], async_save=False)
        out += [seen, rng2.start_epoch, list(rng2)]
        return out

    t, j = _both(scen, tmp_path)
    assert t == j == [2, 42, [0, 1], 1, [1, 2, 3]]


def test_each_package_resumes_the_others_checkpoint(tmp_path):
    """The layers' weights cross. The generators' states do not (JAX keys
    against torch generator states: the streams never agree), nor do the
    optimizers' (the reference keys moments by its global tensor names,
    the port by parameter position), so the checkpoints here hold the
    layer alone."""
    for writer, reader in ((_Port, _Ref), (_Ref, _Port)):
        d = tmp_path / writer.name
        m, o, ac = writer.make(d, save_interval_steps=3, async_save=False,
                               track_rng=False)
        ac.optimizers = []
        _train(writer, m, o, ac, 0, 4)
        m2, o2, ac2 = reader.make(d, save_interval_steps=3,
                                  async_save=False, track_rng=False)
        ac2.optimizers = []
        assert ac2.resume() == 4
        np.testing.assert_allclose(reader.weight(m2), writer.weight(m),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("async_save", [True, False], ids=["async", "sync"])
def test_capture_holds_its_step_under_in_place_writes(tmp_path, async_save):
    """Port-only: the writer runs after the parameters and moments were
    written in place (the next steps); the checkpoint holds the saved
    step's values, and the resume copies into the live tensors."""
    m, o, ac = _Port.make(tmp_path, save_interval_steps=1,
                          async_save=async_save)
    _train(_Port, m, o, ac, 0, 1)
    ac.wait()
    w_before = _Port.weight(m)
    moments = {k: v.clone() for k, v in o.state_dict().items()
               if torch.is_tensor(v)}
    gate = threading.Event()
    orig = tfio.save

    def slow_save(obj, path, *a, **k):
        gate.wait(5.0)
        return orig(obj, path, *a, **k)

    tfio.save = slow_save
    try:
        if not async_save:
            gate.set()
        ac.save_now(1)
        with torch.no_grad():  # the next steps, in place
            m.weight.mul_(0.0)
            for t in o._accumulators["moment1"].values():
                t.add_(1.0)
        gate.set()
        ac.wait()
    finally:
        tfio.save = orig
    m2, o2, ac2 = _Port.make(tmp_path / "r", save_interval_steps=1)
    ac2.dir = str(tmp_path)
    _train(_Port, m2, o2, ac2, 0, 1)  # the accumulators exist
    ptr = m2.weight.data_ptr()
    mptr = {k: t.data_ptr() for k, t in o2._accumulators["moment1"].items()}
    assert ac2.resume() == 2
    np.testing.assert_array_equal(_Port.weight(m2), w_before)
    for k, v in o2.state_dict().items():
        if torch.is_tensor(v):
            assert torch.equal(v, moments[k]), k
    assert m2.weight.data_ptr() == ptr
    assert {k: t.data_ptr() for k, t in
            o2._accumulators["moment1"].items()} == mptr


def test_wait_raises_a_failed_save(tmp_path):
    m, o, ac = _Port.make(tmp_path, save_interval_steps=1)
    orig = tfio.save
    tfio.save = lambda *a, **k: (_ for _ in ()).throw(OSError("disk full"))
    try:
        ac.save_now(1)
        with pytest.raises(RuntimeError, match="disk full"):
            ac.wait()
    finally:
        tfio.save = orig


def test_needs_a_directory(monkeypatch):
    monkeypatch.delenv(tckpt.ELASTIC_AUTO_CHECKPOINT_DIR, raising=False)
    with pytest.raises(ValueError, match="directory"):
        tckpt.AutoCheckpoint(None)
    assert tckpt.ELASTIC_AUTO_CHECKPOINT_DIR == \
        jckpt.ELASTIC_AUTO_CHECKPOINT_DIR
    assert set(tckpt.__all__) == set(jckpt.__all__)
