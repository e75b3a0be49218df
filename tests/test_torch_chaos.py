"""Port parity: the chaos harness (``testing/chaos.py``) and the serving
engine's chaos sites against the JAX package's.

The same seed and plan give the same decisions (both draw from
``random.Random`` keyed by (seed, site, index)); the specs round-trip the
same; the engine's ``serving.submit`` drop, ``serving.step`` drop and
error, and the host tier's ``cache.spill`` corrupt behave as the
reference engine's, on the same weights, token for token.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import cache_tier as jtier
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu.utils.retries import Deadline as JDeadline
from paddle_tpu_torch.inference import ContinuousBatchingEngine, HostTier
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.testing import chaos as tchaos
from paddle_tpu_torch.utils import load_jax_params
from paddle_tpu_torch.utils.retries import Deadline

SITES = ("serving.step", "serving.submit", "cache.spill", "leak.hold")


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    tchaos.uninstall()
    jchaos.uninstall()


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _schedules(seed):
    out = []
    for ch in (tchaos, jchaos):
        s = (ch.ChaosSchedule(seed=seed)
             .at("serving.step", 3, "drop")
             .every("cache.spill", 4, "corrupt", 9)
             .with_probability("serving.submit", 0.3, "drop")
             .with_probability("leak.hold", 0.5, "drop"))
        out.append(s)
    return out


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_seeded_schedules_decide_identically(seed):
    ts, js = _schedules(seed)
    assert ts.to_spec() == js.to_spec()
    for site in SITES:
        for i in range(1, 400):
            a, b = ts.fault_for(site, i), js.fault_for(site, i)
            assert (a is None) == (b is None), (site, i)
            if a is not None:
                assert (a.kind, a.arg) == (b.kind, b.arg)
    rt = tchaos.ChaosSchedule.from_spec(js.to_spec())
    assert rt.to_spec() == js.to_spec()


@pytest.mark.parametrize("kind", ["drop", "corrupt", "reset", "error"])
def test_injection_counts_and_fired_events_match(kind):
    """The installed monkeys count invocations and log fired faults the
    same way, and the byte site flips the same bit."""
    logs = []
    payload = bytes(range(64))
    for ch in (tchaos, jchaos):
        sched = (ch.ChaosSchedule(seed=3)
                 .with_probability("serving.step", 0.4, kind, 5))
        fired = []
        with ch.active(sched) as mk:
            for _ in range(50):
                try:
                    fired.append(ch.inject("serving.step"))
                except (ConnectionResetError, RuntimeError) as e:
                    fired.append(type(e).__name__)
            ch.uninstall()
            bs = ch.ChaosSchedule(seed=3).every("cache.spill", 2, "corrupt",
                                                37)
            ch.install(bs)
            flips = [ch.inject_bytes("cache.spill", payload)
                     for _ in range(4)]
            logs.append((fired, dict(mk.counts), list(mk.events), flips))
    assert logs[0][0] == logs[1][0] and logs[0][3] == logs[1][3]
    assert logs[0][1] == logs[1][1] and logs[0][2] == logs[1][2]
    assert tchaos.inject("serving.step") is True  # uninstalled: a no-op


def _engines(models, **kw):
    jm, tm = models
    args = dict(max_batch=2, max_len=32, block_size=8, num_blocks=8,
                prompt_pad=8)
    args.update(kw)
    jt = kw.pop("tier", False)
    args.pop("tier", None)
    j = JEngine(jm, cache_tier=jtier.HostTier() if jt else None, **args)
    t = ContinuousBatchingEngine(tm, cache_tier=HostTier() if jt else None,
                                 **args)
    return j, t


def _outcome(done):
    return {rid: (r.status, r.shed_reason, [int(x) for x in r.out])
            for rid, r in done.items()}


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_engine_sites_submit_and_step_match_reference(models, overlap):
    """``serving.submit`` drops shed the submission ("chaos-drop");
    ``serving.step`` drops skip an iteration and errors raise out of
    ``step()`` without corrupting the engine: the streams, the shed
    reasons and the step counts equal the reference's."""
    j, t = _engines(models, overlap=overlap)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 250, (int(rng.randint(3, 8)),))
               for _ in range(6)]
    runs = []
    for eng, ch in ((j, jchaos), (t, tchaos)):
        sched = (ch.ChaosSchedule(seed=2)
                 .with_probability("serving.submit", 0.34, "drop")
                 .at("serving.step", 2, "drop")
                 .at("serving.step", 4, "drop")
                 .at("serving.step", 5, "error"))
        errors = 0
        with ch.active(sched) as mk:
            for i, p in enumerate(prompts):
                eng.add_request(i, p, 5)
            for _ in range(200):
                if not (eng._queue or eng.num_active):
                    break
                try:
                    eng.step()
                except RuntimeError:
                    errors += 1
            eng.run()
            runs.append((_outcome(eng._completed), errors, eng.steps,
                         dict(mk.counts)))
    assert runs[0] == runs[1]
    out, errors, _, _ = runs[1]
    assert errors == 1
    assert {r[1] for r in out.values()} >= {"chaos-drop", None}
    assert t.manager.free_blocks == 8


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_cache_spill_corruption_is_a_miss_as_in_reference(models, kv_dtype):
    """Every other spilled frame is corrupted: each corrupt frame a later
    prompt probes is rejected by its CRC (a miss, recomputed), never
    served, so the streams still equal a clean engine's and the
    reference's, with the same restores and rejections."""
    rng = np.random.RandomState(13)
    prompts = [rng.randint(0, 250, (17,)) for _ in range(4)]
    kw = dict(max_batch=1, num_blocks=8, prompt_pad=24, prefix_cache=True,
              kv_dtype=kv_dtype, tier=True)
    j, t = _engines(models, **kw)
    clean_j, _ = _engines(models, **dict(kw, tier=False))
    res = []
    for eng, ch in ((j, jchaos), (t, tchaos)):
        with ch.active(ch.ChaosSchedule(seed=4)
                       .every("cache.spill", 2, "corrupt", 200)):
            for tag in ("warm", "replay"):
                for i, p in enumerate(prompts):
                    eng.add_request(f"{tag}{i}", p, 4)
                    eng.run()
        res.append((_outcome(eng._completed), eng.prefix_stats()["tier"]))
    for tag in ("warm", "replay"):
        for i, p in enumerate(prompts):
            clean_j.add_request(f"{tag}{i}", p, 4)
            clean_j.run()
    assert res[1][0] == res[0][0] == _outcome(clean_j._completed)
    tst, jst = res[1][1], res[0][1]
    for k, v in jst.items():
        assert tst[k] == v, k
    assert tst["corrupt_rejected"] >= 1 and tst["restores"] >= 1


def test_step_chaos_with_deadlines_matches_reference(models):
    """Dropped iterations let deadlines lapse between steps exactly as in
    the reference: the same requests expire, with the same tokens."""
    clock = {"t": 0.0}
    j, t = _engines(models)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 250, (5,)) for _ in range(4)]
    res = []
    for eng, ch, Dl in ((j, jchaos, JDeadline), (t, tchaos, Deadline)):
        clock["t"] = 0.0
        with ch.active(ch.ChaosSchedule(seed=9).every("serving.step", 3,
                                                      "drop")):
            for i, p in enumerate(prompts):
                eng.add_request(i, p, 6, deadline=Dl(
                    2.0 + 3 * i, clock=lambda: clock["t"]))
            for _ in range(40):
                clock["t"] += 0.5
                eng.step()
        eng.run()
        res.append(_outcome(eng._completed))
    assert res[0] == res[1]
    assert {r[0] for r in res[1].values()} == {"ok", "expired"}


def test_dropped_supervisor_leaves_no_step_thread_at_the_chaos_sites(models):
    """A supervisor dropped without ``close()`` retires its step thread. The
    thread used to poll for the rest of the process; one started while the
    port's lock sanitizer was installed held a traced lock, so each poll
    passed the ``thread.preempt`` site of whatever chaos monkey a later test
    installed (the engine-sites test above, in a six-worker run)."""
    import gc
    import threading
    import time

    from paddle_tpu_torch.inference.supervisor import ServingSupervisor
    from paddle_tpu_torch.utils import locks

    _, tm = models
    locks.instrument_locks()
    try:
        sup = ServingSupervisor(lambda: ContinuousBatchingEngine(
            tm, max_batch=1, max_len=32, block_size=8, num_blocks=8,
            prompt_pad=8))
        runner = sup._runner
    finally:
        locks.uninstrument_locks()
        locks.reset()
    del sup
    gc.collect()
    with tchaos.active(tchaos.ChaosSchedule(seed=1)) as mk:
        runner.join(2.0)
        time.sleep(0.6)  # longer than two of the step thread's polls
    assert not runner.is_alive()
    assert "thread.preempt" not in mk.counts
    assert not any(t.name == "paddle_tpu_torch_serving_step"
                   for t in threading.enumerate())


def test_engine_sites_hold_after_the_sanitized_fleet_test():
    """The order that failed: the autoscale file's sanitized drain-kill case
    (both packages' fleets, under the port's lock sanitizer) first, then
    the engine-sites cases, in one process."""
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly",
         "tests/test_torch_autoscale.py::TestDrainKillZeroLoss::"
         "test_mid_drain_kill_loses_zero_accepted_requests",
         "tests/test_torch_chaos.py::"
         "test_engine_sites_submit_and_step_match_reference"],
        cwd=os.path.dirname(here), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert "3 passed" in proc.stdout, proc.stdout[-3000:]
