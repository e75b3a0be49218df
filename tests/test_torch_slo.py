"""Port parity: SLO attainment reports (``obs/slo.py``) against the JAX
package's, and ``chip_smoke.py``'s copy of the open-loop schedule
generator against ``benchmarks/loadgen.py``'s.

The reference's ``tests/test_slo.py`` attainment cases run in both
packages on the same synthetic requests, and ``report_json`` must give
equal bytes. The open-loop drive plays a seeded schedule into the port's
engine and the reference's (the reference's weights carried into the
port): the streams are equal, and both packages grade the port's records
to the same bytes. The schedule copy must serialize byte-equal to
loadgen's for phase 15's spec and for loadgen's defaults.
"""
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.obs import slo as jslo
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.obs import slo as tslo
from paddle_tpu_torch.utils import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLO = {"port": tslo, "reference": jslo}


def _load(name, path):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses resolve through sys.modules
    spec.loader.exec_module(mod)
    return mod


def _loadgen():
    return _load("_torch_slo_loadgen",
                 os.path.join(REPO, "benchmarks", "loadgen.py"))


def _chip_smoke():
    return _load("_torch_slo_chip_smoke", os.path.join(REPO, "chip_smoke.py"))


def _both(scenario):
    got = {name: scenario(S) for name, S in SLO.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def _req(rid, tenant, priority, t0, token_times, status="ok"):
    return {"req_id": rid, "tenant": tenant, "priority": priority,
            "status": status, "t_submit": t0, "times": token_times,
            "out": list(range(len(token_times)))}


def _spec(S):
    return S.SLOSpec(default=S.SLOClass(ttft_s=0.5, itl_p95_s=0.2, e2e_s=2.0))


class TestAttainmentMath:
    def test_verdicts_per_dimension(self):
        reqs = [_req("a", "t0", "interactive", 10.0, [10.1, 10.2, 10.3]),
                _req("b", "t0", "interactive", 10.0, [11.0, 11.1]),
                _req("c", "t0", "interactive", 10.0, [], status="shed")]

        def scen(S):
            spec = _spec(S)
            return [S.RequestLatency.of(r).meets(
                spec.resolve("t0", "interactive")) for r in reqs]

        good, slow_first, shed = _both(scen)
        assert good == {"ttft": True, "itl": True, "e2e": True, "all": True}
        assert not slow_first["ttft"] and slow_first["itl"]
        assert not shed["all"]

    def test_unset_passes_set_without_measurement_fails(self):
        empty = _req("d", "t0", "interactive", 0.0, [])
        out = _both(lambda S: (
            S.RequestLatency.of(empty).meets(S.SLOClass())["all"],
            S.RequestLatency.of(empty).meets(S.SLOClass(ttft_s=1.0))["all"]))
        assert out == (True, False)

    def test_tenant_override_beats_priority(self):
        def scen(S):
            spec = S.SLOSpec(default=S.SLOClass(ttft_s=1.0),
                             per_priority={"batch": S.SLOClass(ttft_s=5.0)},
                             per_tenant={"vip": S.SLOClass(ttft_s=0.1)})
            return ([spec.resolve(t, p).ttft_s for t, p in
                     (("vip", "batch"), ("other", "batch"),
                      ("other", "interactive"))], spec.to_dict())

        assert _both(scen)[0] == [0.1, 5.0, 1.0]

    def test_goodput_counts_only_slo_meeting_tokens(self):
        reqs = [_req("a", "t0", "interactive", 0.0, [0.1, 0.2, 0.3]),
                _req("b", "t1", "interactive", 0.0, [1.0, 1.1])]
        rep = _both(lambda S: S.attainment_report(reqs, _spec(S), wall_s=2.0))
        ov = rep["overall"]
        assert (ov["requests"], ov["tokens"], ov["tokens_within_slo"]) == \
            (2, 5, 3)
        assert ov["attainment"]["all"] == 0.5
        assert ov["goodput_tokens_per_s"] == 1.5
        assert rep["tenants"]["t1"]["attainment"]["ttft"] == 0.0

    def test_report_json_bytes_equal(self):
        rng = np.random.RandomState(4)
        reqs = []
        for i in range(40):
            t0 = float(rng.uniform(0, 5))
            n = int(rng.randint(0, 6))
            times = list(np.cumsum(rng.exponential(0.1, n)) + t0 + 0.05)
            reqs.append(_req(f"r{i}", f"tenant{i % 3}",
                             "batch" if i % 4 == 0 else "interactive", t0,
                             [float(t) for t in times],
                             status="shed" if i % 9 == 0 else "ok"))

        def scen(S):
            spec = S.SLOSpec(
                default=S.SLOClass(ttft_s=0.3, itl_p95_s=0.2, e2e_s=1.0),
                per_priority={"batch": S.SLOClass(ttft_s=2.0)},
                per_tenant={"tenant0": S.SLOClass(ttft_s=0.1)})
            return S.report_json(S.attainment_report(
                reqs, spec, wall_s=6.0, extra={"seed": 4}))

        text = _both(scen)
        assert json.loads(text)["schema"] == "paddle_tpu.obs.slo/1"

    def test_nearest_rank_percentile(self):
        xs = [1.0, 2.0, 3.0, 4.0]
        assert _both(lambda S: [S.pct(xs, 50), S.pct(xs, 100),
                                S.pct([], 50)]) == [2.0, 4.0, None]


# ---------------------------------------------------------------------------
# the open-loop drive


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


class TestOpenLoopDrive:
    def test_engine_front_door_produces_graded_report(self, models):
        lg = _loadgen()
        spec = lg.TraceSpec(seed=2, n_requests=6, duration_s=0.6, tenants=2,
                            prompt_len_median=4.0, prompt_len_max=7,
                            output_len_median=3.0, output_len_max=4)
        schedule = lg.generate_schedule(spec)
        runs = {}
        for name, (model, Engine) in models.items():
            eng = Engine(model, max_batch=2, max_len=32, block_size=8,
                         num_blocks=10, prompt_pad=8)
            recs, wall = lg.run_schedule(lg.EngineFront(eng), schedule,
                                         vocab_size=256, drain_s=120.0)
            runs[name] = (eng, recs, wall)
        eng, recs, wall = runs["port"]
        assert [r.out for r in recs] == [r.out for r in runs["reference"][1]]
        assert tobs.registry().value(
            "serving_requests_total", {"engine": eng._obs_id}) == 6.0

        def scen(S):
            slo_spec = S.SLOSpec(default=S.SLOClass(ttft_s=30.0, e2e_s=60.0))
            return S.report_json(S.attainment_report(
                recs, slo_spec, wall, extra={"trace_spec": spec.to_dict()}))

        rep = json.loads(_both(scen))
        ov = rep["overall"]
        assert ov["requests"] == 6 and ov["statuses"] == {"ok": 6}
        assert ov["ttft"]["p99"] is not None
        assert ov["goodput_tokens_per_s"] > 0
        assert set(rep["tenants"]) <= {"tenant0", "tenant1"}


# ---------------------------------------------------------------------------
# chip_smoke.py's copy of the schedule generator


class TestScheduleCopy:
    def test_phase15_spec_serializes_byte_equal_to_loadgen(self):
        lg, cs = _loadgen(), _chip_smoke()
        for seed in (0, 1, 7):
            kw = cs.autoscale_trace_kwargs(seed)
            want = lg.TraceSpec(**kw)
            got = cs.TraceSpec(**kw)
            assert cs.schedule_json(got, cs.generate_schedule(got)) == \
                lg.schedule_json(want, lg.generate_schedule(want))
        # loadgen's own defaults and its smoke shape
        for kw in ({}, {"seed": 3, "n_requests": 24, "duration_s": 4.0,
                        "tenants": 3}):
            assert cs.schedule_json(
                cs.TraceSpec(**kw), cs.generate_schedule(cs.TraceSpec(**kw))
            ) == lg.schedule_json(lg.TraceSpec(**kw),
                                  lg.generate_schedule(lg.TraceSpec(**kw)))

    def test_phase15_spec_is_loadgens_autoscale_shape(self):
        kw = _chip_smoke().autoscale_trace_kwargs(5)
        assert (kw["seed"], kw["n_requests"], kw["duration_s"],
                kw["tenants"], kw["burst_factor"], kw["burst_frac"]) == \
            (5, 60, 10.0, 3, 4.0, 0.2)
        assert (kw["prompt_len_median"], kw["prompt_len_max"],
                kw["output_len_median"], kw["output_len_max"]) == \
            (256.0, 512, 24.0, 48)

    def test_feedforward_envelope_equal(self):
        lg, cs = _loadgen(), _chip_smoke()
        kw = cs.autoscale_trace_kwargs(0)
        f_lg = lg.feedforward_from_spec(lg.TraceSpec(**kw))
        f_cs = cs.feedforward_from_spec(cs.TraceSpec(**kw))
        ts = [i * 0.05 for i in range(400)]
        assert [f_cs(t) for t in ts] == [f_lg(t) for t in ts]
        assert max(f_cs(t) for t in ts) > 1.0
        assert all(math.isfinite(f_cs(t)) for t in ts)
