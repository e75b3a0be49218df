"""Port parity: the cluster router (``inference/cluster.py``) against the JAX
package's.

The scorer and recovery units of the reference's ``tests/test_cluster.py``
run over the same fake replicas in both packages, and the in-process
clusters run two supervised engines per package on ``LlamaConfig.tiny()``
in f32 with the reference's weights carried into the port. Held exactly:
placements, routed counts, misroutes, retries, poisoned ids, orphans,
results and token streams, prefix hit rates, recovery events, and the wire
records (``make_record``), which either package's journal and store read.
The process-level kill runs the port's replica worker
(``python -m paddle_tpu_torch.testing.router_worker``) on the CPU, in the
reference's ``slow`` lane.
"""
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import cluster as jcl
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch.inference import cluster as tcl
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, generate
from paddle_tpu_torch.testing import chaos as tchaos
from paddle_tpu_torch.utils import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": SimpleNamespace(cl=tcl, chaos=tchaos),
        "reference": SimpleNamespace(cl=jcl, chaos=jchaos)}


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    tchaos.uninstall()
    jchaos.uninstall()


def _both(scenario, pkgs=PKGS):
    got = {name: scenario(P) for name, P in pkgs.items()}
    assert got["port"] == got["reference"]
    return got["port"]


class _FakeReplica:
    """Records submissions, serves a static load snapshot, dies on
    command (the reference test's stand-in)."""

    def __init__(self, replica_id, load=None):
        self.replica_id = replica_id
        self.journal_dir = None
        self._load = load
        self._dead = False
        self.submitted = []

    def alive(self):
        return not self._dead

    def submit(self, rec):
        self.submitted.append(rec)

    def poll_completed(self):
        return []

    def load(self):
        return self._load

    def pending(self):
        return False

    def pump(self, deadline=None):
        pass

    def stop(self, deadline=None):
        self._dead = True


def _idle():
    return {"queue_depth": 0, "queue_limit": 8, "kv_occupancy": 0.0,
            "est_queue_delay_s": 0.0, "ewma_step_s": None}


def _busy():
    return {"queue_depth": 8, "queue_limit": 8, "kv_occupancy": 0.9,
            "est_queue_delay_s": 4.0, "ewma_step_s": 0.5}


def _ids(recs):
    return [r["req_id"] for r in recs]


def test_placement_and_affinity_match():
    def scen(P):
        out = {}
        r = P.cl.ClusterRouter([_FakeReplica("busy", _busy()),
                                _FakeReplica("idle", _idle())], block_size=4)
        out["load"] = [r.submit(f"q{i}", np.arange(6 + i)) for i in range(4)]
        out["load_routed"] = list(r.n_routed)
        r = P.cl.ClusterRouter([_FakeReplica("a", _idle()),
                                _FakeReplica("b", _idle())], block_size=4)
        prefix = list(range(100, 112))
        out["prefix"] = [r.submit("p0", prefix + [1, 2])] + [
            r.submit(f"p{i}", prefix + [i * 7]) for i in range(1, 4)] + [
            r.submit("other", list(range(40)))]
        out["hit_rate"] = r.prefix_hit_rate()
        r = P.cl.ClusterRouter([_FakeReplica("a", _idle()),
                                _FakeReplica("b", _idle())], block_size=4)
        out["session"] = [r.submit(f"s{i}", np.arange(5) + 50 * i,
                                   session="alice") for i in range(4)]
        return out

    out = _both(scen)
    assert out["load"] == [1, 1, 1, 1] and out["load_routed"] == [0, 4]
    first = out["prefix"][0]
    assert out["prefix"][1:4] == [first] * 3 and out["prefix"][4] == 1 - first
    assert len(set(out["session"])) == 1


def test_chaos_misroute_and_no_live_replica():
    def scen(P):
        r = P.cl.ClusterRouter([_FakeReplica("busy", _busy()),
                                _FakeReplica("idle", _idle())], block_size=4)
        with P.chaos.active(P.chaos.ChaosSchedule().at(
                "cluster.route", 1, "drop")):
            got = [r.submit("q", np.arange(4)), r.submit("q2", np.arange(4))]
        rep = _FakeReplica("only", _idle())
        lone = P.cl.ClusterRouter([rep], block_size=4)
        rep._dead = True
        with pytest.raises(P.cl.NoLiveReplica):
            lone.route([1, 2, 3])
        return got, r.n_misroutes

    assert _both(scen) == ([0, 1], 1)


@pytest.mark.parametrize("case", ["requeue", "poison", "outage", "expired"])
def test_recovery_from_the_routing_table_matches(case):
    def scen(P):
        a, b = _FakeReplica("a", _idle()), _FakeReplica("b", _idle())
        r = P.cl.ClusterRouter([a, b], block_size=4,
                               max_request_retries=0 if case == "poison"
                               else 2)
        if case == "expired":
            rec = P.cl.make_record("late", np.arange(4), 4, deadline=0.0)
            idx = r.route(rec["prompt"])
            r._dispatch(rec, idx)
            time.sleep(0.01)
            r.replicas[idx]._dead = True
            r.check_replicas()
            return (r.results, len([x for x in a.submitted + b.submitted
                                    if x["req_id"] == "late"]))
        where = {rid: r.submit(rid, np.arange(4) + i)
                 for i, rid in enumerate(["x", "y", "z", "w"])}
        a._dead = True
        if case == "outage":
            b._dead = True
            r.recover_replica(0)
            parked = (sorted(r.orphans), r.health()["orphans"],
                      len(b.submitted))
            b._dead = False
            r.step()
            return (where, parked, sorted(r.orphans), _ids(b.submitted),
                    dict(r.retries), {k: v[1] for k, v in r.inflight.items()})
        dead = r.check_replicas()
        return (where, dead, sorted(r.dead), _ids(b.submitted),
                dict(r.retries), {k: v[1] for k, v in r.inflight.items()},
                {k: v["status"] for k, v in r.results.items()},
                sorted(r.poisoned_ids), r.health()["recoveries"])

    out = _both(scen)
    if case == "expired":
        assert out == ({"late": {"req_id": "late", "status": "expired",
                                 "out": []}}, 1)
        return
    victims = [rid for rid, idx in out[0].items() if idx == 0]
    assert victims
    if case == "requeue":
        assert out[1] == [0] and set(victims) <= set(out[3])
        assert all(out[4][v] == 1 and out[5][v] == 1 for v in victims)
    elif case == "poison":
        assert sorted(victims) == out[7]
        assert all(out[6][v] == "poisoned" for v in victims)
    else:
        assert out[1][0] == sorted(victims) and out[2] == []


def test_wire_records_cross_packages():
    rec_t = tcl.make_record("r", [1, 2], 8, deadline=30.0, priority="batch",
                            session="s", retries=1, tenant="t")
    rec_j = jcl.make_record("r", [1, 2], 8, deadline=30.0, priority="batch",
                            session="s", retries=1, tenant="t")
    assert set(rec_t) == set(rec_j)
    assert {k: v for k, v in rec_t.items()
            if k not in ("deadline_unix", "trace")} == \
        {k: v for k, v in rec_j.items() if k not in ("deadline_unix", "trace")}
    assert 25.0 < tcl.remaining_budget(rec_t) <= 30.0
    assert json.loads(json.dumps(rec_t)) == rec_t
    assert tcl.result_record("r", "ok", [3], target="dx0") == \
        jcl.result_record("r", "ok", [3], target="dx0")


@pytest.fixture(scope="module")
def engines():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return {"port": SimpleNamespace(cl=tcl, Engine=ContinuousBatchingEngine,
                                    model=tm),
            "reference": SimpleNamespace(cl=jcl, Engine=JEngine, model=jm)}


def _generate(model, prompt, n):
    ids = torch.from_numpy(np.asarray(prompt, np.int64)[None])
    return generate(model, ids, max_new_tokens=n)[0, len(prompt):].tolist()


def test_prefix_affinity_yields_engine_cache_hits_token_exact(engines):
    rng = np.random.RandomState(11)
    fam_a, fam_b = rng.randint(0, 250, (16,)), rng.randint(0, 250, (16,))
    prompts = {f"q{i}": np.concatenate([fam_a if i % 2 == 0 else fam_b,
                                        rng.randint(0, 250, (3 + i,))])
               for i in range(6)}

    def scen(P):
        def factory():
            return P.Engine(P.model, max_batch=1, max_len=64, block_size=8,
                            num_blocks=16, prompt_pad=24, prefix_cache=True)

        reps = [P.cl.InProcessReplica(f"r{i}", factory) for i in range(2)]
        router = P.cl.ClusterRouter(reps, block_size=8)
        for rid, p in prompts.items():
            router.submit(rid, p, max_new_tokens=4)
        res = router.run(deadline=300)
        return ({k: (v["status"], v["out"]) for k, v in res.items()},
                router.prefix_hit_rate(),
                [rep.load()["prefix"]["hit_tokens"] for rep in reps],
                router.health()["dead"], list(router.n_routed))

    res, rate, hits, dead, routed = _both(scen, engines)
    for rid, p in prompts.items():
        assert res[rid] == ("ok", _generate(engines["port"].model, p, 4))
    assert rate > 0.2 and all(h > 0 for h in hits) and dead == []


def test_replica_death_requeues_journaled_backlog(engines, tmp_path):
    rng = np.random.RandomState(12)
    prompts = {"q0": rng.randint(0, 250, (5,))}
    for i in range(1, 4):
        prompts[f"q{i}"] = rng.randint(0, 250, (3 + i,))

    def scen(P):
        def factory():
            return P.Engine(P.model, max_batch=1, max_len=32, block_size=8,
                            num_blocks=8, prompt_pad=8)

        root = tmp_path / type(P.model).__module__
        reps = [P.cl.InProcessReplica(f"r{i}", factory,
                                      journal_dir=str(root / f"r{i}"))
                for i in range(2)]
        router = P.cl.ClusterRouter(reps, block_size=8)
        where = [router.submit(rid, p, max_new_tokens=4, session="pinned")
                 for rid, p in prompts.items()]
        router.step()
        reps[where[0]].kill()
        res = router.run(deadline=300)
        return (where, sorted(router.dead),
                {k: (v["status"], v["out"]) for k, v in res.items()},
                [e[:2] for e in router.events])

    where, dead, res, events = _both(scen, engines)
    assert len(set(where)) == 1 and dead == [where[0]]
    for rid, p in prompts.items():
        assert res[rid] == ("ok", _generate(engines["port"].model, p, 4))
    assert events == [("replica-dead", f"r{where[0]}")]


def test_health_envelope_keys_match(engines):
    def scen(P):
        rep = _FakeReplica("a", _idle())
        h = P.cl.ClusterRouter([rep], block_size=4).health()
        return sorted(h), h["kind"], h["schema_version"], h["alerts"]

    out = _both(scen)
    assert out[1] == "router" and out[2] == 1


@pytest.mark.slow
def test_kill_one_replica_mid_stream_zero_lost_requests(tmp_path):
    """Two port replica processes behind the router over a TCPKVStore; one
    dies to a scheduled ``kill`` mid-stream; the router's journal replay
    finishes every accepted request on the survivor, token-exact, and the
    survivor exits with nothing outstanding."""
    from paddle_tpu_torch.distributed.store import TCPKVStore, TCPStoreServer
    from paddle_tpu_torch.utils.retries import Deadline

    server = TCPStoreServer("127.0.0.1", 0)
    procs, logs = [], []
    try:
        reps = []
        for rid, spec in (("r0", "serving.step@4=kill"), ("r1", None)):
            env = dict(os.environ)
            env.pop("PADDLE_CHAOS", None)
            env.update({
                "ROUTER_DEVICE": "cpu",
                "ROUTER_STORE_PORT": str(server.port),
                "ROUTER_REPLICA_ID": rid,
                "ROUTER_JOURNAL_DIR": str(tmp_path / rid),
                "ROUTER_BUDGET": "240",
                "PADDLE_LEAK_SANITIZER": "1",
                "PYTHONPATH": REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""),
            })
            if spec:
                env["PADDLE_CHAOS"] = spec
            log = open(tmp_path / f"{rid}.log", "w")
            logs.append(log)
            p = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.testing.router_worker"],
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
            procs.append(p)
            reps.append(tcl.ProcessReplica(
                TCPKVStore("127.0.0.1", server.port), rid,
                journal_dir=str(tmp_path / rid), proc=p))
        router = tcl.ClusterRouter(reps, block_size=8)
        dl = Deadline(180)
        store = TCPKVStore("127.0.0.1", server.port)
        while not dl.expired() and not all(
                store.get(f"cluster/{r}/hb") for r in ("r0", "r1")):
            time.sleep(0.25)
        rng = np.random.RandomState(9)
        shared = rng.randint(0, 250, (16,))
        prompts = {}
        for i in range(8):
            prompts[f"q{i}"] = (
                np.concatenate([shared, rng.randint(0, 250, (3 + i % 3,))])
                if i < 6 else rng.randint(0, 250, (4 + i % 3,)))
        for rid, p in prompts.items():
            router.submit(rid, p, max_new_tokens=4)
        res = router.run(deadline=240)
        assert router.dead, "the chaos kill never fired"
        pt_seed(0)
        model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        for rid, p in prompts.items():
            assert rid in res, f"request {rid} was lost"
            assert (res[rid]["status"], res[rid]["out"]) == \
                ("ok", _generate(model, p, 4)), rid
        ev = [e for e in router.events if e[0] == "replica-dead"]
        assert len(ev) == 1 and ev[0][1] == "r0"
        assert router.prefix_hit_rate() > 0
        router.stop(deadline=20.0)
        procs[1].wait(timeout=60)
        text = (tmp_path / "r1.log").read_text()
        assert procs[1].returncode == 0, text[-2000:]
        assert "leak-sanitizer: clean" in text
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
        for log in logs:
            log.close()
        server.stop()


# -- fleet aggregation (obs/agg.py) and the health envelope --------------------


def _registry(metrics, tag, itl):
    reg = metrics.MetricsRegistry()
    reg.counter("serving_requests_total", {"engine": "eng0"},
                help="requests").inc(3)
    reg.gauge("queue_depth", {"engine": "eng0"}).set(len(itl))
    h = reg.histogram("serving_itl_seconds", {"engine": "eng0", "tenant": tag})
    for v in itl:
        h.observe(v)
    return reg


def _aggs():
    from paddle_tpu.distributed import store as jstore
    from paddle_tpu.obs import agg as jagg
    from paddle_tpu.obs import metrics as jmetrics
    from paddle_tpu_torch.distributed import store as tstore
    from paddle_tpu_torch.obs import agg as tagg
    from paddle_tpu_torch.obs import metrics as tmetrics

    return {"port": SimpleNamespace(agg=tagg, metrics=tmetrics, st=tstore),
            "reference": SimpleNamespace(agg=jagg, metrics=jmetrics,
                                         st=jstore)}


@pytest.mark.parametrize("publisher", ["port", "reference"])
def test_fleet_aggregation_matches_across_packages(publisher):
    """Sources published by either package merge to the same fleet view in
    both: counters sum, gauges split per source, histograms bucket-merge;
    a damaged blob raises instead of giving wrong totals."""
    pkgs = _aggs()
    pub = pkgs[publisher]
    store = pub.st.MemKVStore()
    pub.agg.publish(store, "w0", registry=_registry(pub.metrics, "acme",
                                                    [0.01, 0.02, 0.04]))
    pub.agg.publish(store, "w1", registry=_registry(pub.metrics, "acme",
                                                    [0.1, 0.2]))

    def scen(P):
        reg = P.agg.merge_states(P.agg.collect(store))
        summ = P.agg.fleet_summary(store)
        return (P.agg.sources(store), reg.snapshot(),
                P.agg.fleet_snapshot(store)["sources"], summ)

    sources, snap, fsrc, summ = _both(scen, pkgs)
    assert sources == fsrc == ["w0", "w1"]
    assert summ["schema"] == "paddle_tpu.obs.agg/1"
    assert summ["totals"]["serving_requests_total"] == 6.0
    assert summ["tenants"]["acme"]["serving_itl_seconds"]["count"] == 5
    store.set("obs/w0/metrics", "not-a-crc-frame")
    with pytest.raises(pub.st.CorruptBlobError, match="not a base64"):
        pkgs["port"].agg.collect(store)


def test_publisher_and_fleet_trace():
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.distributed.store import MemKVStore
    from paddle_tpu_torch.obs import agg

    store = MemKVStore()
    was = obs.set_enabled(True)
    try:
        with obs.span("route", tid="router", req="q") as sp:
            pass
        pub = agg.Publisher(store, "rep-a", interval_s=0.0)
        assert pub.maybe_publish()
        events = agg.fleet_trace(store, trace_id=sp.trace_id)
        assert [e["name"] for e in events if e.get("ph") == "X"] == ["route"]
    finally:
        obs.set_enabled(was)


def test_every_health_surface_shares_the_envelope():
    from paddle_tpu import obs as jobs
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.distributed.store import MemKVStore
    from paddle_tpu_torch.inference.disagg import (DecodeWorker, DisaggRouter,
                                                   PrefillWorker)
    from paddle_tpu_torch.inference.supervisor import ServingSupervisor

    assert obs.HEALTH_COMMON_KEYS == jobs.HEALTH_COMMON_KEYS
    assert obs.HEALTH_SCHEMA_VERSION == jobs.HEALTH_SCHEMA_VERSION
    pt_seed(0)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")

    def engine(role="unified"):
        return ContinuousBatchingEngine(model, max_batch=1, max_len=32,
                                        block_size=8, num_blocks=4,
                                        prompt_pad=8, role=role)

    store = MemKVStore()
    shapes = {
        "supervisor": ServingSupervisor(engine).health(),
        "router": tcl.ClusterRouter([tcl.InProcessReplica("r0", engine)])
        .health(),
        "disagg": DisaggRouter(
            [PrefillWorker("pf0", lambda: engine("prefill_only"), store,
                           ["dx0"])],
            [DecodeWorker("dx0", lambda: engine("decode_only"), store)])
        .health()}
    for kind, h in shapes.items():
        assert set(obs.HEALTH_COMMON_KEYS) <= set(h), kind
        assert h["kind"] == kind and h["schema_version"] == 1
        assert isinstance(h["shed_total"], int)
        assert h["alerts"]["firing"] == 0
    assert "restarts" in shapes["supervisor"]
    assert "replicas" in shapes["router"]
    assert "prefill" in shapes["disagg"] and "decode" in shapes["disagg"]
