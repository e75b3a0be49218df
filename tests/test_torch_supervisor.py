"""Port parity: the serving supervisor (``inference/supervisor.py``) against
the JAX package's.

Each scenario of the reference's ``tests/test_supervisor.py`` runs in both
packages, on ``LlamaConfig.tiny()`` in f32 with the reference's weights
carried into the port, each package with its own chaos monkey under the
same schedule. Held exactly: statuses, token streams, restarts, retry
counts, poisoned ids, watchdog event kinds, journals (either package
replays the other's), and the health snapshot's keys and counts. The
kill-and-relaunch case runs the port's worker process
(``python -m paddle_tpu_torch.testing.supervisor_worker``) on the CPU and
holds it against the port's own ``generate`` on the same seeded weights.
Port only: a generation abandoned mid-dispatch never writes into the
retired engine's buffers after the fence, and the captured programs'
dispatches all run under the model's execution lock.
"""
import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import admission as jadm
from paddle_tpu.inference import supervisor as jsup
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch.inference import admission as tadm
from paddle_tpu_torch.inference import supervisor as tsup
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                EngineFenced)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, generate
from paddle_tpu_torch.testing import chaos as tchaos
from paddle_tpu_torch.utils import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    tchaos.uninstall()
    jchaos.uninstall()


@pytest.fixture(scope="module")
def pk():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return {"port": SimpleNamespace(Engine=ContinuousBatchingEngine,
                                    sup=tsup, chaos=tchaos, adm=tadm,
                                    model=tm),
            "reference": SimpleNamespace(Engine=JEngine, sup=jsup,
                                         chaos=jchaos, adm=jadm, model=jm)}


def _both(pk, scenario):
    got = {name: scenario(P) for name, P in pk.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def _factory(P, **kw):
    args = dict(max_batch=1, max_len=32, block_size=8, num_blocks=4,
                prompt_pad=8)
    args.update(kw)
    return lambda: P.Engine(P.model, **args)


def _res(res):
    return {str(k): (r.status, [int(t) for t in r.out], int(r.retries))
            for k, r in res.items()}


def _generate(model, prompt, n):
    ids = torch.from_numpy(np.asarray(prompt, np.int64)[None])
    return generate(model, ids, max_new_tokens=n)[0, len(prompt):].tolist()


def test_crash_rebuild_requeues_token_exact(pk):
    rng = np.random.RandomState(0)
    p1, p2 = rng.randint(0, 250, (4,)), rng.randint(0, 250, (5,))

    def scen(P):
        with P.chaos.active(P.chaos.ChaosSchedule().at(
                "serving.step", 2, "error")):
            sup = P.sup.ServingSupervisor(_factory(P))
            sup.submit("x", p1, 4)
            sup.submit("y", p2, 3)
            res = sup.run()
        return _res(res), sup.restarts, sup.health()["state"]

    res, restarts, state = _both(pk, scen)
    assert restarts == 1 and state == "idle"
    assert res["x"] == ("ok", _generate(pk["port"].model, p1, 4), 1)
    assert res["y"][:2] == ("ok", _generate(pk["port"].model, p2, 3))


def test_hang_beyond_watchdog_budget_recovers_token_exact(pk):
    rng = np.random.RandomState(1)
    p1, p2 = rng.randint(0, 250, (4,)), rng.randint(0, 250, (6,))

    def scen(P):
        with P.chaos.active(P.chaos.ChaosSchedule().at(
                "serving.step", 2, "hang", 0.6)):
            sup = P.sup.ServingSupervisor(_factory(P), step_budget=0.1,
                                          dump_stacks=False)
            sup.submit("x", p1, 4)
            sup.submit("y", p2, 3)
            res = sup.run()
        kinds = [e[0] for e in sup.events]
        return (_res(res), sup.restarts, kinds.count("hung"),
                "warn" in kinds and "dump" in kinds)

    res, restarts, hung, ladder = _both(pk, scen)
    assert restarts == 1 and hung == 1 and ladder
    assert res["x"][:2] == ("ok", _generate(pk["port"].model, p1, 4))


def test_poison_request_quarantined_others_complete(pk):
    rng = np.random.RandomState(2)
    p = rng.randint(0, 250, (4,))
    pa, pb = rng.randint(0, 250, (5,)), rng.randint(0, 250, (6,))

    def scen(P):
        sched = (P.chaos.ChaosSchedule().at("serving.step", 2, "error")
                 .at("serving.step", 4, "error"))
        with P.chaos.active(sched):
            sup = P.sup.ServingSupervisor(_factory(P), max_request_retries=1)
            sup.submit("P", p, 3)
            sup.submit("A", pa, 3)
            sup.submit("B", pb, 4)
            res = sup.run()
        return (_res(res), sup.restarts, list(sup.poisoned_ids),
                sup.health()["poisoned"])

    res, restarts, poisoned, health = _both(pk, scen)
    assert restarts == 2 and poisoned == health == ["P"]
    assert res["P"][0] == "poisoned"
    assert res["B"][:2] == ("ok", _generate(pk["port"].model, pb, 4))


def test_gives_up_after_consecutive_failures(pk):
    p = np.random.RandomState(3).randint(0, 250, (4,))

    def scen(P):
        with P.chaos.active(P.chaos.ChaosSchedule().every(
                "serving.step", 1, "error")):
            sup = P.sup.ServingSupervisor(_factory(P),
                                          max_consecutive_failures=3)
            sup.submit("x", p, 4)
            with pytest.raises(P.sup.SupervisorGaveUp,
                               match="consecutive") as e:
                sup.run()
        return str(e.value).split("(")[0], sup.restarts

    assert _both(pk, scen)[1] == 4


def test_shed_and_displaced_requests_land_in_results_and_journal(pk,
                                                                 tmp_path):
    p = np.random.RandomState(4).randint(0, 250, (4,))

    def scen(P):
        sup = P.sup.ServingSupervisor(_factory(
            P, admission=P.adm.AdmissionConfig(max_queue=2), max_batch=2,
            num_blocks=8))
        sup.submit("a", p, 3)
        sup.submit("b", p, 3, priority="batch")
        shed = sup.submit("c", p, 3, priority="batch")
        res = _res(sup.run())
        jdir = str(tmp_path / type(P.model).__module__)

        def factory():
            return _factory(P, admission=P.adm.AdmissionConfig(max_queue=1),
                            max_batch=1, num_blocks=4)()

        sup = P.sup.ServingSupervisor(factory, journal_dir=jdir)
        sup.submit("victim", p, 3, priority="batch")
        disp = sup.submit("vip", p, 3, priority="interactive")
        victim = (sup.results["victim"].status,
                  sup.results["victim"].shed_reason)
        res2 = _res(sup.run())
        sup2 = P.sup.ServingSupervisor(factory, journal_dir=jdir)
        return (shed.status, res, disp.status, victim, res2,
                sup2.pending, _res(sup2.results))

    out = _both(pk, scen)
    assert out[0] == "shed" and out[1]["c"][0] == "shed"
    assert out[3] == ("shed", "displaced") and not out[5]
    assert out[4]["vip"][:2] == ("ok", _generate(pk["port"].model, p, 3))


def test_journal_replay_rules_match(pk, tmp_path):
    """An expired journaled request closes at zero cost, an unservable one
    is shed instead of parked, a torn tail is skipped; each package
    replays the journal the other wrote."""
    def write(J, d):
        j = J._Journal(d)
        j._append({"type": "submit", "req_id": "dead", "prompt": [1, 2],
                   "max_new_tokens": 4, "priority": "interactive",
                   "deadline_unix": time.time() - 1.0})
        j._append({"type": "submit", "req_id": "big",
                   "prompt": list(range(20)), "max_new_tokens": 4,
                   "priority": "batch", "deadline_unix": None})
        j._append({"type": "submit", "req_id": "live", "prompt": [5, 6, 7],
                   "max_new_tokens": 3, "priority": "interactive",
                   "deadline_unix": None, "retries": 1})
        with open(j.path, "a") as f:
            f.write('{"type": "complete", "req_id": "live", "sta')  # torn

    out = {}
    for name, P in pk.items():
        for writer in (jsup, tsup):
            d = str(tmp_path / f"{name}-{writer.__name__}")
            write(writer, d)
            pending, completed = P.sup._Journal(d).replay()
            sup = P.sup.ServingSupervisor(_factory(P), journal_dir=d)
            first = (sorted(map(str, pending)), sorted(completed),
                     _res(sup.results))
            res = _res(sup.run())
            sup2 = P.sup.ServingSupervisor(_factory(P), journal_dir=d)
            out[name, writer.__name__] = (first, res, sup2.pending,
                                          _res(sup2.results))
    vals = list(out.values())
    assert all(v == vals[0] for v in vals), out
    first, res, pending2, res2 = vals[0]
    assert first[2]["dead"] == ("expired", [], 0)
    assert first[2]["big"][0] == "shed"
    assert res["live"][:2] == ("ok", _generate(pk["port"].model, [5, 6, 7],
                                               3))
    assert not pending2
    assert {k: v[:2] for k, v in res2.items()} == \
        {k: v[:2] for k, v in res.items()}


def test_kill_relaunch_journal_resume_token_exact(pk, tmp_path):
    """The port's worker process dies at a scheduled ``kill`` in
    ``serving.step``; its relaunch replays the journal and finishes every
    request token-exact (against the port's generate on the weights the
    worker draws from the same seed)."""
    from paddle_tpu_torch.testing.supervisor_worker import requests

    def run(spec=None):
        env = dict(os.environ)
        env.pop("PADDLE_CHAOS", None)
        env.update(SUP_DIR=str(tmp_path), SUP_NREQ="4", SUP_DEVICE="cpu",
                   PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        if spec:
            env["PADDLE_CHAOS"] = spec
        return subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.testing.supervisor_worker"],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=240)

    pt_seed(0)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    want = {rid: _generate(model, p, n) for rid, p, n in requests(4)}
    w1 = run("serving.step@3=kill:21")
    assert w1.returncode == 21, (w1.returncode, w1.stderr[-2000:])
    assert not w1.stdout.strip()
    recs = [json.loads(line) for line in
            (tmp_path / "serving-journal.jsonl").read_text().splitlines()]
    assert sum(r["type"] == "submit" for r in recs) == 4
    # the reference reads the port's journal
    pending, completed = jsup._Journal(str(tmp_path)).replay()
    assert set(pending) | set(completed) == set(want)
    w2 = run()
    assert w2.returncode == 0, w2.stderr[-2000:]
    results = json.loads(w2.stdout.strip().splitlines()[-1])["results"]
    assert {rid: (r["status"], r["out"]) for rid, r in results.items()} == \
        {rid: ("ok", toks) for rid, toks in want.items()}


@pytest.mark.parametrize("worker,prefix", [
    ("supervisor_worker", "SUP"), ("disagg_worker", "DISAGG"),
    ("router_worker", "ROUTER")])
def test_worker_asked_for_cuda_without_a_card_raises(tmp_path, worker,
                                                     prefix):
    """Each worker process asked for ``cuda`` on a machine without a card
    raises before it does anything; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=REPO, SUP_DIR=str(tmp_path),
               DISAGG_JOURNAL_DIR=str(tmp_path),
               ROUTER_JOURNAL_DIR=str(tmp_path))
    env[f"{prefix}_DEVICE"] = "cuda"
    r = subprocess.run(
        [sys.executable, "-m", f"paddle_tpu_torch.testing.{worker}"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr
    assert list(tmp_path.iterdir()) == []


def test_fixed_seed_chaos_schedule_identical_across_runs_and_packages(pk):
    rng = np.random.RandomState(9)
    prompts = {i: rng.randint(0, 250, (3 + i % 3,)) for i in range(8)}

    def scen(P):
        sched = (P.chaos.ChaosSchedule(seed=11)
                 .with_probability("serving.submit", 0.4, "drop")
                 .with_probability("serving.step", 0.3, "drop"))
        with P.chaos.active(sched) as mk:
            eng = P.Engine(P.model, max_batch=2, max_len=32, block_size=8,
                           num_blocks=8, prompt_pad=8)
            for i, p in prompts.items():
                eng.add_request(i, p, max_new_tokens=3)
            done = eng.run(max_steps=300)
            events = list(mk.events)
        return events, _res(done)

    ev, out = _both(pk, scen)
    assert {e[0] for e in ev} == {"serving.submit", "serving.step"}
    assert any(s == "shed" for s, _, _ in out.values())
    s = (tchaos.ChaosSchedule(seed=3)
         .with_probability("serving.submit", 0.25, "drop")
         .at("serving.loop", 4, "error"))
    r = tchaos.ChaosSchedule.from_spec(s.to_spec())
    assert r.to_spec() == s.to_spec()
    assert r.fault_for("serving.loop", 4).kind == "error"


def test_dropped_supervisor_tick_is_a_noop(pk):
    p = np.random.RandomState(6).randint(0, 250, (4,))

    def scen(P):
        with P.chaos.active(P.chaos.ChaosSchedule().at(
                "serving.loop", 2, "drop")) as mk:
            sup = P.sup.ServingSupervisor(_factory(P))
            sup.submit("x", p, 3)
            res = sup.run()
        return (("serving.loop", 2, "drop") in mk.events, _res(res),
                sup.restarts)

    fired, res, restarts = _both(pk, scen)
    assert fired and restarts == 0
    assert res["x"][:2] == ("ok", _generate(pk["port"].model, p, 3))


_VOLATILE = ("last_step_s", "load", "overlap", "tenants", "alerts",
             "shed_total", "expired_total", "requests_total")


def test_health_snapshot_shape(pk):
    p = np.random.RandomState(7).randint(0, 250, (4,))

    def scen(P):
        sup = P.sup.ServingSupervisor(_factory(P), step_budget=30.0)
        sup.submit("x", p, 3)
        h = sup.health()
        q = h["load"]["queue_depth"]
        sup.run()
        h2 = sup.health()
        return (sorted(h), q, sorted(h["load"]),
                {k: v for k, v in h.items() if k not in _VOLATILE},
                {k: v for k, v in h2.items() if k not in _VOLATILE})

    keys, q, load_keys, h, h2 = _both(pk, scen)
    assert q == 1 and h["state"] == "serving" and h["step_budget_s"] == 30.0
    assert h2["state"] == "idle" and h2["completed"] == {"ok": 1}
    assert {"schema_version", "kind", "alerts"} <= set(keys)


def test_overlap_crash_mid_pipeline_recovers_token_exact(pk):
    """A crash with a dispatch in flight on the copy ring: the rebuilt
    overlap engine replays the request from scratch, token-exact."""
    rng = np.random.RandomState(8)
    p1, p2 = rng.randint(0, 250, (4,)), rng.randint(0, 250, (6,))

    def scen(P):
        with P.chaos.active(P.chaos.ChaosSchedule().at(
                "serving.step", 4, "error")):
            sup = P.sup.ServingSupervisor(_factory(
                P, overlap=True, max_batch=2, num_blocks=8))
            sup.submit("x", p1, 6)
            sup.submit("y", p2, 5)
            res = sup.run()
        return _res(res), sup.restarts, [e[0] for e in sup.events]

    res, restarts, kinds = _both(pk, scen)
    assert restarts == 1 and kinds == ["recover"]
    assert res["x"][:2] == ("ok", _generate(pk["port"].model, p1, 6))


def test_abandoned_generation_cannot_dispatch_into_the_fenced_engine(pk):
    """The first engine's step wedges on the host, just before its decode
    dispatch, past the watchdog budget: the supervisor fences that engine
    and serves everything on a replacement, token-exact. When the wedged
    thread wakes, its dispatch meets the fence and raises
    ``EngineFenced``: no program of the fenced engine runs after the
    fence, so nothing of its device state changes. Every dispatch holds
    the model's execution lock."""
    model = pk["port"].model
    p1 = np.random.RandomState(10).randint(0, 250, (5,))
    woke = threading.Event()
    dispatched = []
    engines = []
    snaps = []

    def factory():
        eng = ContinuousBatchingEngine(model, max_batch=1, max_len=32,
                                       block_size=8, num_blocks=4,
                                       prompt_pad=8)
        idx = len(engines)
        inner_fn, inner_run = eng._decode_fn, eng._run_decode

        def decode_fn():
            assert eng._exec_lock.locked()  # dispatch under the lock
            dispatched.append(idx)
            return inner_fn()

        # warmed_up reads the program's capture state
        decode_fn._graphs, decode_fn._eager = inner_fn._graphs, inner_fn._eager

        def run_decode(*a):
            if idx == 0 and not woke.is_set():
                snaps.append([t.clone() for t in eng._dstate])
                time.sleep(1.5)  # wedged on the host, past the budget
                woke.set()
            return inner_run(*a)

        eng._decode_fn, eng._run_decode = decode_fn, run_decode
        engines.append(eng)
        return eng

    sup = tsup.ServingSupervisor(factory, step_budget=0.5,
                                 warmup_budget=0.5, dump_stacks=False)
    sup.submit("x", p1, 4)
    out = sup.run()
    assert woke.wait(5.0)
    time.sleep(0.2)
    first = engines[0]
    assert sup.restarts == 1 and first._fenced and len(engines) == 2
    assert out["x"].status == "ok"
    assert out["x"].out == _generate(model, p1, 4)
    assert 0 not in dispatched and 1 in dispatched
    assert all(torch.equal(a, b) for a, b in zip(snaps[0], first._dstate))
    with pytest.raises(EngineFenced):
        first.step()
