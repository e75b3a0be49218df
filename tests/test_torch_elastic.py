"""Port parity: the elastic manager (``distributed/fleet/elastic``) against
the JAX package's, and the port's elastic relaunches.

- Exact, each scenario run in both packages over its own shared
  directory: registration, dense rank mappings, scale-down and scale-up
  detection, the ``max_np`` ceiling, dead-node expiry, ``watch``'s exit
  code, the chaos-forced re-mesh, and the heartbeat's self-diagnosis.
- Two gloo ranks register one node each and agree on the mapping.
- The relaunches (processes, CPU): ``testing/elastic_worker.py`` (DP over
  gloo, rank 1 killed, the job relaunched from rank 0's checkpoint) ends
  on the uninterrupted run's loss; ``testing/elastic_shard_worker.py``
  (stage 3 on two ranks with sharded peer payloads, rank 1 SIGKILLed, the
  relaunch at world 1 resharding from the peer tier) ends bitwise on an
  uninterrupted world-1 run's loss.
"""
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from paddle_tpu.distributed.fleet import elastic as jelastic
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu.utils.retries import Deadline as JDeadline
from paddle_tpu_torch.distributed.fleet import elastic as telastic
from paddle_tpu_torch.distributed.store import TCPKVStore, TCPStoreServer
from paddle_tpu_torch.testing import chaos as tchaos
from paddle_tpu_torch.utils.retries import Deadline

import torch_ckpt_ranks
from torch_dist_ranks import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": SimpleNamespace(el=telastic, chaos=tchaos, dl=Deadline),
        "reference": SimpleNamespace(el=jelastic, chaos=jchaos,
                                     dl=JDeadline)}


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    tchaos.uninstall()
    jchaos.uninstall()


def _both(scen, tmp_path):
    got = {name: scen(P, tmp_path / name) for name, P in PKGS.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def _mgr(P, root, node, **kw):
    kw.setdefault("heartbeat_interval", 0.1)
    kw.setdefault("elastic_timeout", 2.0)
    return P.el.ElasticManager(str(root), node_id=node, **kw)


def test_membership_and_rank_mappings_match_reference(tmp_path):
    def scen(P, d):
        out = [P.el.ELASTIC_EXIT_CODE]
        a, b = _mgr(P, d / "1", "node-a", np=2), _mgr(P, d / "1", "node-b",
                                                       np=2)
        b._beat()
        out += [a.register(), b.register(), a.rank(), b.rank()]
        a.exit()
        b.exit()
        with pytest.raises(TimeoutError):
            _mgr(P, d / "2", "solo", np=3, elastic_timeout=0.3).register()
        a, b = (_mgr(P, d / "3", n, np="1:2") for n in ("node-a", "node-b"))
        b._beat()
        a.register()
        b.register()
        out.append(a.world_changed())
        b.exit()
        out += [a.world_changed(), a.watch(), a.should_shrink(),
                a.health()["remesh_events"]]
        a.exit()
        a = _mgr(P, d / "4", "node-a", np="1:4")
        a.register()
        c = _mgr(P, d / "4", "node-c", np="1:4")
        c._beat()
        out += [a.world_changed(), a.rank_mapping()]
        a.exit()
        a2 = _mgr(P, d / "4", "node-a", np="1:4")
        a2.register()
        c.register()
        out += [a2.rank_mapping(), c.rank_mapping()]
        a2.exit()
        c.exit()
        for name in ("node-a", "node-b", "node-c"):
            _mgr(P, d / "5", name, np="1:2")._beat()
        a = _mgr(P, d / "5", "node-a", np="1:2")
        out += [a.register(), a.rank_mapping(),
                _mgr(P, d / "5", "node-c", np="1:2").rank()]
        a.exit()
        a = _mgr(P, d / "6", "node-a", np=1, elastic_timeout=0.3)
        ghost = _mgr(P, d / "6", "node-ghost", np=1, elastic_timeout=0.3)
        ghost._beat()
        a.register()
        time.sleep(0.5)
        out.append("node-ghost" in a.alive_nodes())
        with P.chaos.active(P.chaos.ChaosSchedule().at("elastic.remesh", 1,
                                                        "drop")):
            out.append(a.world_changed())
        out.append(a.watch(deadline=P.dl(0.2)))
        h = a.health()
        out += [h["alive"], h["world_size"], h["rank"], h["remesh_events"],
                sorted(h)]
        a.exit()
        return out

    out = _both(scen, tmp_path)
    assert out[1:5] == [["node-a", "node-b"], ["node-a", "node-b"], 0, 1]


def test_heartbeat_self_diagnosis_matches_reference(tmp_path):
    def scen(P, d):
        m = _mgr(P, d, "node-a", np=1, heartbeat_interval=0.02,
                 max_beat_failures=3)
        m.register()
        try:
            out = [m.health()["alive"]]
            with P.chaos.active(P.chaos.ChaosSchedule().every(
                    "elastic.heartbeat", 1, "error")):
                end = time.time() + 5.0
                while not m.health()["dead"] and time.time() < end:
                    time.sleep(0.02)
            h = m.health()
            m._thread.join(2.0)
            out += [h["dead"], h["alive"], h["consecutive_beat_failures"] >= 3,
                    "injected error" in h["last_beat_error"],
                    m._thread.is_alive()]
            return out
        finally:
            m.exit()

    assert _both(scen, tmp_path) == [True, True, False, True, True, False]


def test_tcp_store_membership():
    srv = TCPStoreServer(host="127.0.0.1")
    try:
        addr = f"tcp://127.0.0.1:{srv.port}"
        a = telastic.ElasticManager(addr, node_id="n0", np=2,
                                    heartbeat_interval=0.05,
                                    elastic_timeout=5.0)
        b = telastic.ElasticManager(
            TCPKVStore("127.0.0.1", srv.port), node_id="n1", np=2,
            heartbeat_interval=0.05, elastic_timeout=5.0)
        b._beat()
        assert a.register() == b.register() == ["n0", "n1"]
        assert a.rank_mapping() == {"n0": 0, "n1": 1} and b.rank() == 1
        b.exit()
        assert a.world_changed()
        a.exit()
    finally:
        srv.stop()


def test_two_gloo_ranks_agree_on_the_mapping(tmp_path):
    got = run_ranks(torch_ckpt_ranks.elastic_register, 2, tmp_path,
                    args=("node", str(tmp_path)))
    assert got[0]["world"] == got[1]["world"] == ["node0", "node1"]
    assert got[0]["mapping"] == got[1]["mapping"] == {"node0": 0, "node1": 1}
    assert [g["rank"] for g in got] == [0, 1]


def _env(**kw):
    env = dict(os.environ)
    env.pop("PADDLE_CHAOS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _launch(script, log_dir, env, nproc=2):
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc", str(nproc), "--max_restart", "0", "--log_dir",
         str(log_dir), "--job_id", "el", script],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=420)


def _logs(log_dir, n=2):
    out = {}
    for r in range(n):
        p = os.path.join(log_dir, f"el.rank{r}.log")
        out[r] = open(p).read() if os.path.exists(p) else "<missing>"
    return out


def test_dp_kill_and_relaunch_resumes_to_the_uninterrupted_loss(tmp_path):
    script = os.path.join(REPO, "paddle_tpu_torch", "testing",
                          "elastic_worker.py")
    total = 10
    env = _env(ELASTIC_DEVICE="cpu", ELASTIC_TOTAL=total,
               ELASTIC_KILL_STEP=-1, ELASTIC_DIR=tmp_path / "ref")
    os.makedirs(tmp_path / "ref")
    p = _launch(script, tmp_path / "ref_logs", env)
    logs = _logs(tmp_path / "ref_logs")
    assert p.returncode == 0, (p.stderr[-1500:], logs[0][-1500:])
    want = re.search(r"final_loss=([0-9.]+)", logs[0]).group(1)
    os.makedirs(tmp_path / "el")
    env = _env(ELASTIC_DEVICE="cpu", ELASTIC_TOTAL=total,
               ELASTIC_KILL_STEP=6, ELASTIC_DIR=tmp_path / "el")
    p1 = _launch(script, tmp_path / "w1", env)
    logs1 = _logs(tmp_path / "w1")
    assert p1.returncode != 0
    assert "simulated failure at step 6" in logs1[1], logs1[1][-1500:]
    assert open(tmp_path / "el" / "ckpt.step").read() == "4"
    p2 = _launch(script, tmp_path / "w2", env)
    logs2 = _logs(tmp_path / "w2")
    assert p2.returncode == 0, (p2.stderr[-1500:], logs2[0][-1500:])
    assert "resumed at step 4" in logs2[0]
    assert re.search(r"final_loss=([0-9.]+)", logs2[0]).group(1) == want


def test_sharded_kill_and_world_one_resume_bitwise(tmp_path):
    script = os.path.join(REPO, "paddle_tpu_torch", "testing",
                          "elastic_shard_worker.py")

    def solo(scratch, settle=0.0):
        env = _env(ELASTIC_DEVICE="cpu", ELASTIC_SHARD_MODE="solo",
                   ELASTIC_DIR=scratch, TOTAL_STEPS=8,
                   ELASTIC_SETTLE_S=settle)
        return subprocess.run([sys.executable, "-u", script], env=env,
                              cwd=REPO, capture_output=True, text=True,
                              timeout=300)

    ref = solo(str(tmp_path / "ref"))
    assert ref.returncode == 0, ref.stdout[-3000:] + ref.stderr[-3000:]
    ref_hex = re.search(r"final_loss_hex=([0-9a-f]{8})", ref.stdout).group(1)
    pod = str(tmp_path / "pod")
    env = _env(ELASTIC_DEVICE="cpu", ELASTIC_SHARD_MODE="dist",
               ELASTIC_DIR=pod, TOTAL_STEPS=8,
               PADDLE_CHAOS="train.kill_rank.1@6=kill")
    p = _launch(script, tmp_path / "logs", env)
    logs = _logs(tmp_path / "logs")
    detail = f"rc={p.returncode}\n" + "".join(
        f"\n--- rank{r} ---\n{logs[r][-2500:]}" for r in logs)
    assert p.returncode != 0, detail
    for r in (0, 1):
        assert f"rank {r}: ELASTIC world=2" in logs[r], detail
        assert f"ESHARD_OK rank {r}" not in logs[r], detail
    res = solo(pod, settle=2.0)
    out = res.stdout
    assert res.returncode == 0, out[-3000:] + res.stderr[-3000:]
    assert "ELASTIC world=1" in out
    assert "RESUME next_step=5" in out and "gather_ranks=[0, 1]" in out, out
    assert "reshard_resumes=1" in out
    assert re.search(r"final_loss_hex=([0-9a-f]{8})", out).group(1) == ref_hex
    assert float(re.search(r"rollback=([0-9.]+)", out).group(1)) > 0.0
