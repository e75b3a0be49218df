"""Port parity: the fleet autoscaler (``inference/autoscale.py``) and the
router's draining surface against the JAX package's.

The reference's ``tests/test_autoscale.py`` controller and draining cases
run in both packages over the same fake replicas and scripted alert feeds
with explicit clocks: the decision records, placements and router states
must be equal. The drain-kill case serves a real three-replica fleet per
package on ``LlamaConfig.tiny()`` in f32 (the reference's weights carried
into the port) with chaos killing the drain victim mid-drain: nothing
accepted is lost, both packages give the same streams and decisions, and
the port's killed and retired replicas free their engines. It runs under
the port's lock sanitizer, which must record no inversion.

The last case runs ``chip_smoke.py``'s phase 15 (``autoscale_phase``)
on the CPU at a tiny size, so its gates and its flow are checked here
before the card runs them at full width.
"""
import gc
import importlib.util
import math
import os
import sys
import weakref
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import autoscale as jas
from paddle_tpu.inference import cluster as jcl
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.obs import alerts as jal
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch.inference import autoscale as tas
from paddle_tpu_torch.inference import cluster as tcl
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.obs import alerts as tal
from paddle_tpu_torch.testing import chaos as tchaos
from paddle_tpu_torch.utils import load_jax_params, locks

PKGS = {"port": SimpleNamespace(a=tas, cl=tcl, al=tal, chaos=tchaos),
        "reference": SimpleNamespace(a=jas, cl=jcl, al=jal, chaos=jchaos)}


@pytest.fixture(autouse=True)
def _clean():
    yield
    tchaos.uninstall()
    jchaos.uninstall()


def _both(scenario):
    got = {name: scenario(P) for name, P in PKGS.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def _retire_step_threads(reps, timeout=5.0):
    """Retire every replica's step thread and wait for it to end. The
    reference's ``InProcessReplica.stop`` leaves its thread polling for the
    rest of the process; one started while the port's lock sanitizer was
    installed would pass the port's ``thread.preempt`` chaos site on every
    poll, inside whatever chaos test the worker runs next."""
    runners = []
    for rep in reps:
        rep.stop()
        runner = getattr(rep.supervisor, "_runner", None)
        if runner is not None:
            runner.retire()
            runner._go.set()
            runners.append(runner)
    for runner in runners:
        runner.join(timeout)
    assert not any(r.is_alive() for r in runners)


def _idle_load():
    return {"queue_depth": 0, "queue_limit": 8, "kv_occupancy": 0.0,
            "est_queue_delay_s": 0.0, "ewma_step_s": None}


class _FakeReplica:
    """Static load, scripted liveness, records submissions; ``busy`` keeps
    :meth:`pending` true so a drain never quiesces."""

    def __init__(self, replica_id, load=None, busy=False):
        self.replica_id = replica_id
        self.journal_dir = None
        self._load = load if load is not None else _idle_load()
        self._dead = False
        self._busy = busy
        self.submitted = []

    def alive(self):
        return not self._dead

    def kill(self):
        self._dead = True

    def submit(self, rec):
        self.submitted.append(rec)

    def poll_completed(self):
        return []

    def load(self):
        return self._load

    def pending(self):
        return self._busy

    def pump(self, deadline=None):
        pass

    def stop(self, deadline=None):
        self._dead = True


class _ScriptedAlerts:
    """One burn status whose state and budget the test scripts."""

    def __init__(self, firing=False, budget=1.0):
        self.firing = firing
        self.budget = budget

    def maybe_evaluate(self, *, min_interval_s=0.25):
        pass

    def statuses(self):
        return [{"state": "firing" if self.firing else "inactive",
                 "annotations": {"budget_remaining_frac": self.budget}}]


def _fleet(P, n=1, alerts=None, feedforward=None, **cfg_over):
    cfg_kw = dict(min_replicas=1, max_replicas=3, scale_up_cooldown_s=1.0,
                  scale_down_cooldown_s=0.0, recover_budget_frac=0.5,
                  recover_hold_s=1.0, spawn_backoff_s=0.5,
                  drain_timeout_s=30.0, evaluate_interval_s=0.0)
    cfg_kw.update(cfg_over)
    router = P.cl.ClusterRouter([_FakeReplica(f"r{i}") for i in range(n)],
                                block_size=4)
    scaler = P.a.FleetAutoscaler(
        router, lambda rid: _FakeReplica(rid),
        config=P.a.AutoscalerConfig(**cfg_kw), alerts=alerts,
        feedforward=feedforward, clock=lambda: 0.0)
    return router, scaler


def _state(router, scaler):
    return {"decisions": scaler.decisions, "snapshot": scaler.snapshot(),
            "replicas": [r.replica_id for r in router.replicas],
            "dead": sorted(router.dead), "draining": sorted(router.draining),
            "events": router.events}


class TestController:
    def test_burn_breach_scales_up_under_cooldown(self):
        def scen(P):
            router, scaler = _fleet(P, 1, alerts=_ScriptedAlerts(True, -0.5))
            acts = [scaler.step(now=t)["action"] for t in (0.0, 0.5, 1.5,
                                                           3.0)]
            return acts, _state(router, scaler)

        acts, st = _both(scen)
        assert acts == ["scale-up", "hold", "scale-up", "hold"]
        assert len(st["replicas"]) == 3

    def test_scale_down_needs_budget_hold(self):
        def scen(P):
            al = _ScriptedAlerts(firing=False, budget=0.1)
            router, scaler = _fleet(P, 2, alerts=al)
            acts = []
            for t, b in ((0.0, 0.1), (1.0, 0.9), (1.5, 0.9), (1.8, 0.2),
                         (2.0, 0.9), (2.5, 0.9), (3.1, 0.9), (3.2, 0.9)):
                al.budget = b
                acts.append(scaler.step(now=t)["action"])
            return acts, len(scaler._live_idxs()), _state(router, scaler)

        acts, live, st = _both(scen)
        assert acts[:6] == ["hold"] * 6 and acts[6] == "drain-start"
        assert "scale-down" in [d["action"] for d in st["decisions"]]
        assert live == 1

    def test_min_replicas_floor_never_drained(self):
        def scen(P):
            router, scaler = _fleet(P, 1, alerts=_ScriptedAlerts())
            return ([scaler.step(now=t)["action"] for t in (0., 2., 4., 6.)],
                    _state(router, scaler))

        acts, st = _both(scen)
        assert acts == ["hold"] * 4 and st["draining"] == []

    def test_feedforward_floor_prewarms(self):
        def scen(P):
            router, scaler = _fleet(P, 1, alerts=_ScriptedAlerts(),
                                    feedforward=lambda now: 3.0,
                                    feedforward_headroom=1.0)
            acts = [scaler.step(now=t)["action"] for t in (0.0, 0.1, 0.2)]
            scaler.feedforward = lambda now: 1 / 0
            return acts, scaler.step(now=0.3)["floor"], _state(router, scaler)

        acts, floor, st = _both(scen)
        assert acts == ["scale-up", "scale-up", "hold"] and floor == 1
        assert {d["reason"] for d in st["decisions"]
                if d["action"] == "scale-up" and "reason" in d} == \
            {"feedforward-floor"}

    def test_spawn_chaos_backs_off_and_pages(self):
        def scen(P):
            P.chaos.install(P.chaos.ChaosSchedule(seed=1).every(
                "scale.spawn", 1, "drop"))
            router, scaler = _fleet(
                P, 1, alerts=_ScriptedAlerts(), feedforward=lambda now: 2.0,
                feedforward_headroom=1.0, spawn_backoff_s=0.5,
                spawn_backoff_max_s=2.0)
            acts = [scaler.step(now=t)["action"] for t in (0.0, 0.1, 0.6)]
            age = scaler.heartbeat_age(1.0)
            mgr = P.al.AlertManager(
                scaler.alert_rules(heartbeat_max_age_s=5.0), emit_trace=False,
                emit_metrics=False)
            mgr.evaluate(now=100.0, ages={"autoscaler": age})
            firing = sorted(a["rule"] for a in mgr.firing())
            P.chaos.uninstall()
            acts.append(scaler.step(now=2.0)["action"])
            mgr.evaluate(now=101.0,
                         ages={"autoscaler": scaler.heartbeat_age(2.0)})
            return (acts, age, firing, sorted(a["rule"] for a in mgr.firing()),
                    scaler.heartbeat_age(2.0), _state(router, scaler))

        acts, age, firing, after, hb, st = _both(scen)
        assert acts == ["spawn-failed", "spawn-backoff", "spawn-failed",
                        "scale-up"]
        assert age == math.inf and hb == 0.0
        assert firing == ["autoscale_silent", "autoscale_spawn_failing"]
        assert "autoscale_silent" not in after
        assert [d["backoff_s"] for d in st["decisions"]
                if d["action"] == "spawn-failed" and "backoff_s" in d] == \
            [0.5, 1.0]

    def test_drain_timeout_falls_back_to_recovery(self):
        def scen(P):
            router, scaler = _fleet(P, 2, alerts=_ScriptedAlerts(),
                                    recover_hold_s=0.0, drain_timeout_s=5.0)
            for rep in router.replicas:
                rep._busy = True
            recs = [scaler.step(now=t) for t in (0.0, 2.0, 6.0)]
            return ([r["action"] for r in recs], recs[0]["draining"],
                    router.health()["draining"], _state(router, scaler))

        acts, victim, draining, st = _both(scen)
        assert acts[0] == "drain-start" and draining == []
        assert "drain-timeout" in [d["action"] for d in st["decisions"]]
        assert victim[0] in st["dead"]

    def test_mid_drain_death_hands_off_to_router_recovery(self):
        def scen(P):
            router, scaler = _fleet(P, 2, alerts=_ScriptedAlerts(),
                                    recover_hold_s=0.0)
            P.chaos.install(P.chaos.ChaosSchedule(seed=2).at(
                "scale.drain", 1, "drop"))
            rec = scaler.step(now=0.0)
            victim = rec["draining"][0]
            killed = not router.replicas[victim].alive()
            scaler.step(now=0.1)
            return rec["action"], killed, _state(router, scaler)

        action, killed, st = _both(scen)
        assert action == "drain-start" and killed
        assert "drain-died" in [d["action"] for d in st["decisions"]]
        assert st["snapshot"]["draining"] == []


class TestRouterDraining:
    def test_draining_blocks_new_but_keeps_session_followups(self):
        def scen(P):
            router = P.cl.ClusterRouter([_FakeReplica("a"),
                                         _FakeReplica("b")], block_size=4)
            out = [router.submit("s0", np.arange(4), session="conv")]
            router.mark_draining(0)
            out.append(router.submit("s1", np.arange(4), session="conv"))
            out += [router.submit(f"n{i}", np.arange(8) + i)
                    for i in range(3)]
            draining = router.health()["draining"]
            router.clear_draining(0)
            return out, draining, router.health()["draining"]

        assert _both(scen) == ([0, 0, 1, 1, 1], [0], [])

    def test_all_draining_still_serves(self):
        def scen(P):
            router = P.cl.ClusterRouter([_FakeReplica("a"),
                                         _FakeReplica("b")], block_size=4)
            router.mark_draining(0)
            router.mark_draining(1)
            return router.submit("x", np.arange(4))

        assert _both(scen) in (0, 1)

    def test_drained_and_retire(self):
        def scen(P):
            reps = [_FakeReplica("a"), _FakeReplica("b", busy=True)]
            router = P.cl.ClusterRouter(reps, block_size=4)
            router.submit("q", np.arange(4), session="sess")
            idx = router._sessions["sess"]
            out = [idx, router.drained(idx)]
            router.inflight.clear()
            out += [router.drained(0), router.drained(1)]
            router.mark_draining(0)
            router.retire_replica(0)
            return (out, sorted(router.dead), router.health()["draining"],
                    router._prefix[0].stats()["nodes"],
                    dict(router._sessions), router.events)

        out, dead, draining, nodes, sessions, events = _both(scen)
        assert out == [0, False, True, False]
        assert dead == [0] and draining == [] and nodes == 0
        assert "sess" not in sessions


# ---------------------------------------------------------------------------
# real engines: the drain victim killed mid-drain loses nothing


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    pt_seed(0)
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    tm.eval()
    return {"port": (tm, ContinuousBatchingEngine),
            "reference": (jm, JEngine)}


class TestDrainKillZeroLoss:
    def test_mid_drain_kill_loses_zero_accepted_requests(self, tmp_path,
                                                        models):
        engines = {}

        def scen(P):
            port = P.a is tas
            model, Engine = models["port" if port else "reference"]

            def factory():
                eng = Engine(model, max_batch=1, max_len=32, block_size=8,
                             num_blocks=8, prompt_pad=8)
                if port:
                    engines[eng._obs_id] = weakref.ref(eng)
                return eng

            root = tmp_path / ("port" if port else "reference")
            reps = [P.cl.InProcessReplica(f"r{i}", factory,
                                          journal_dir=str(root / f"r{i}"))
                    for i in range(3)]
            router = P.cl.ClusterRouter(reps, block_size=8)
            rng = np.random.RandomState(7)
            ids = []
            for sess in ("left", "mid", "right"):
                for j in range(3):
                    rid = f"{sess}{j}"
                    ids.append(rid)
                    router.submit(rid, rng.randint(0, 250, (5 + j,)),
                                  max_new_tokens=3, session=sess)
            placed = sorted(router._sessions.values())
            P.chaos.install(P.chaos.ChaosSchedule(seed=3).at(
                "scale.drain", 1, "drop"))
            scaler = P.a.FleetAutoscaler(
                router, lambda rid: _FakeReplica(rid),
                config=P.a.AutoscalerConfig(
                    min_replicas=1, max_replicas=3, recover_hold_s=0.0,
                    scale_down_cooldown_s=0.0, evaluate_interval_s=0.0),
                alerts=_ScriptedAlerts(), clock=lambda: 0.0)
            rec = scaler.step(now=0.0)
            victim = rec["draining"][0]
            held = router.inflight_on(victim)
            killed = not router.replicas[victim].alive()
            res = router.run(deadline=300)
            t = 1.0
            scaler.step(now=t)
            while len(scaler._live_idxs()) > 1 or scaler._draining:
                router.step()
                t += 1.0
                scaler.step(now=t)
                assert t < 20.0
            # up to the death: later victims follow the requeued work, which
            # the router places by measured step times
            acts = [d["action"] for d in scaler.decisions]
            died = acts.index("drain-died") + 1 if "drain-died" in acts else 0
            ev = [e[0] for e in router.events]
            dead = ev.index("replica-dead") + 1 if "replica-dead" in ev else 0
            out = ({rid: (res[rid]["status"], res[rid]["out"]) for rid in ids},
                   placed, victim, held, killed, router.n_recoveries,
                   router.poisoned_ids, scaler.decisions[:died],
                   router.events[:dead], len(scaler._live_idxs()),
                   acts.count("scale-down"))
            router.stop()
            _retire_step_threads(reps)
            return out

        locks.reset()
        locks.instrument_locks()
        try:
            res, placed, victim, held, killed, recoveries, poisoned, \
                decisions, events, live, retired = _both(scen)
            assert locks.violation_count() == 0
        finally:
            locks.uninstrument_locks()
            locks.reset()
        assert placed == [0, 1, 2] and killed and held == 3
        assert all(st == "ok" and len(out) == 3 for st, out in res.values())
        assert recoveries == 1 and poisoned == []
        assert decisions[-1]["action"] == "drain-died"
        assert events[-1][0] == "replica-dead" and (live, retired) == (1, 1)
        gc.collect()
        # every port engine is freed once its replica was killed, retired
        # or stopped
        assert [k for k, ref in engines.items() if ref() is not None] == []

    def test_killed_replica_frees_its_engine_and_keeps_results(self, models):
        model, Engine = models["port"]
        rep = tcl.InProcessReplica(
            "solo", lambda: Engine(model, max_batch=1, max_len=32,
                                   block_size=8, num_blocks=8, prompt_pad=8))
        ref = weakref.ref(rep.supervisor.engine)
        rep.submit(tcl.make_record("a", np.arange(5), 3))
        while rep.pending():
            rep.pump()
        rep.kill()
        gc.collect()
        assert ref() is None and not rep.alive() and not rep.pending()
        assert [(r["req_id"], r["status"]) for r in rep.poll_completed()] == \
            [("a", "ok")]

    def test_killed_replica_reads_as_no_load_before_the_sweep(self, models):
        model, Engine = models["port"]
        reps = [tcl.InProcessReplica(
            f"r{i}", lambda: Engine(model, max_batch=1, max_len=32,
                                    block_size=8, num_blocks=8,
                                    prompt_pad=24, prefix_cache=True))
                for i in range(2)]
        router = tcl.ClusterRouter(reps, block_size=8)
        for rid in ("a", "b"):  # "b" repeats "a"'s prompt: a prefix hit
            router.submit(rid, np.arange(17), 3)
            router.run(deadline=60.0)
        assert router.prefix_hit_rate() > 0.0
        for rep in reps:
            rep.kill()
        # no check_replicas sweep yet: the killed replicas' engines are
        # freed, and their loads read as unpublished
        assert [rep.load() for rep in reps] == [None, None]
        assert router.prefix_hit_rate() == 0.0
        assert [r["alive"] for r in router.health()["replicas"]] == \
            [False, False]


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 15, rehearsed on the CPU

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128)
TINY_ENGINE = dict(max_batch=4, max_len=64, block_size=8, prefill_chunk=16,
                   num_blocks=40, prefix_cache=True)
TINY_TRACE = dict(seed=0, n_requests=12, duration_s=3.0, tenants=3,
                  burst_factor=4.0, burst_frac=0.2, prompt_len_median=10.0,
                  prompt_len_sigma=0.5, prompt_len_max=24,
                  output_len_median=6.0, output_len_sigma=0.5,
                  output_len_max=12)


def test_chip_phase_15_gates_hold_on_the_cpu(capsys, monkeypatch):
    import torch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name = "_torch_autoscale_chip_smoke"
    cs = sys.modules.get(name)
    if cs is None:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(repo, "chip_smoke.py"))
        cs = importlib.util.module_from_spec(spec)
        sys.modules[name] = cs
        spec.loader.exec_module(cs)
    # the phase's model and engine at a tiny size
    monkeypatch.setattr(cs, "LLAMA_542M", TINY)
    monkeypatch.setattr(cs, "PREFIX_SERVE", TINY_ENGINE)
    old = tal.set_default_manager(None)
    try:
        counts = cs.autoscale_phase(
            torch, np, torch.device("cpu"), SimpleNamespace(seed=0), "cpu",
            trace_kw=TINY_TRACE)
        restored = tal._DEFAULT is None  # the phase puts back what it found
    finally:
        tal.set_default_manager(old)
    out = capsys.readouterr().out
    assert "peak 3 live replicas" in out and "statuses {'ok': 12}" in out
    assert "engines freed 2 of 2" in out and "phase 15(c) capacity" in out
    assert counts["paged_decode_attention"] == 0  # CPU: no kernel launch
    assert restored and not locks._instrumented[0]
