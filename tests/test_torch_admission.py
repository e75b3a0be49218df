"""Port parity: overload control — the admission controller, the engine's
front door (deadlines, priorities, shedding, the bounded priority queue,
degraded modes, ``load()``), deadline eviction in sync and overlap mode,
and ``fence()``/``requeue()`` — against the JAX package's.

Controller cases drive both controllers with one injected clock and loads
built by hand, so verdicts, reasons, levels, WFQ tags and bucket levels
must agree exactly. Engine cases compare what does not depend on measured
speed: statuses, shed reasons, shed counts by class, queue order, the
deterministic ``load()`` fields, and token streams (f32 on the CPU).
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import admission as jadm
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import GenRequest as JRequest
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.utils.retries import Deadline as JDeadline
from paddle_tpu_torch.inference import (AdmissionConfig, AdmissionController,
                                        ContinuousBatchingEngine, EngineFenced,
                                        EngineLoad, GenRequest, TenantPolicy)
from paddle_tpu_torch.inference import admission as tadm
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.utils import load_jax_params
from paddle_tpu_torch.utils.retries import Deadline


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return jm, tm


class Clock:
    """One fake clock both packages' deadlines and controllers read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# -- the controller ----------------------------------------------------------

_LOAD_FIELDS = ("queue_depth", "queued_interactive", "queued_batch",
                "token_backlog", "token_backlog_interactive",
                "tokens_per_step", "ewma_step_s", "est_queue_delay_s")


def _random_load(rng, limit):
    d = dict(queue_depth=int(rng.randint(0, limit + 2)),
             queued_interactive=int(rng.randint(0, 4)),
             queued_batch=int(rng.randint(0, 4)),
             token_backlog=int(rng.randint(0, 400)),
             token_backlog_interactive=int(rng.randint(0, 200)),
             tokens_per_step=float(rng.choice([4.0, 10.0, 32.0])),
             ewma_step_s=(None if rng.rand() < 0.2
                          else float(rng.choice([0.05, 0.5, 1.0]))),
             est_queue_delay_s=float(rng.choice([0.0, 0.4, 2.0, 9.0])),
             queue_limit=limit if rng.rand() < 0.8 else None)
    return d


@pytest.mark.parametrize("seed,cfg", [
    (0, dict(max_queue=4)),
    (1, dict(max_queue=8, high_watermark=0.5, target_delay_s=1.0,
             level_hold=2, ewma_alpha=0.5)),
    (2, dict(max_queue=6, target_delay_s=0.5, level_hold=1,
             feasibility_margin=1.5, low_watermark=0.25)),
    (3, dict(max_queue=8, wfq=True,
             tenants={"hot": TenantPolicy(weight=1.0, rate_tokens_per_s=40.0,
                                          burst_tokens=60.0),
                      "*": TenantPolicy(weight=2.0)})),
    (4, dict(max_queue=5, deadline_feasibility=False,
             tenants={"a": TenantPolicy(rate_tokens_per_s=25.0)})),
], ids=["queue", "watermark_level", "feasibility", "wfq_quota", "quota"])
def test_controller_decisions_match_reference(seed, cfg):
    """A seeded script of submissions, loads, observations and service
    feedback drives both controllers on one clock: every verdict, reason,
    level, delay EWMA, WFQ tag, bucket level and snapshot agrees."""
    clock = Clock()
    tcfg = dict(cfg)
    jcfg = dict(cfg)
    if "tenants" in cfg:
        jcfg["tenants"] = {k: jadm.TenantPolicy(**vars(v))
                           for k, v in cfg["tenants"].items()}
    tc = AdmissionController(AdmissionConfig(**tcfg), clock=clock)
    jc = jadm.AdmissionController(jadm.AdmissionConfig(**jcfg), clock=clock)
    rng = np.random.RandomState(seed)
    limit = cfg["max_queue"]
    for step in range(160):
        clock.t += float(rng.choice([0.0, 0.1, 0.7]))
        ld = _random_load(rng, limit)
        tl, jl = EngineLoad(**ld), jadm.EngineLoad(**ld)
        op = rng.randint(0, 4)
        if op == 0:
            tight = bool(rng.rand() < 0.5)
            tc.observe(tl, allow_tighten=tight)
            jc.observe(jl, allow_tighten=tight)
        elif op == 1 and (tc.wfq_enabled or jc.wfq_enabled):
            tenant = str(rng.choice(["hot", "a", "b"]))
            cost = float(rng.randint(8, 64))
            assert tc.wfq_tag(tenant, cost) == jc.wfq_tag(tenant, cost)
            start = float(rng.rand() * 50)
            tc.wfq_served(start)
            jc.wfq_served(start)
        else:
            pri = str(rng.choice(["interactive", "batch"]))
            tenant = str(rng.choice(["hot", "a", "b", "default"]))
            plen, gen = int(rng.randint(1, 40)), int(rng.randint(1, 40))
            budget = (None if rng.rand() < 0.3
                      else float(rng.choice([0.05, 1.0, 3.0, 30.0])))
            reqs = []
            for Req, Dl in ((GenRequest, Deadline), (JRequest, JDeadline)):
                r = Req(f"r{step}", np.zeros(plen, np.int32), gen,
                        deadline=None if budget is None
                        else Dl(budget, clock=clock),
                        priority=pri, tenant=tenant)
                reqs.append(r)
            if rng.rand() < 0.2:
                clock.t += 0.5  # some deadlines lapse before the decision
            got, want = tc.decide(reqs[0], tl), jc.decide(reqs[1], jl)
            assert got == want, (step, got, want)
        assert tc.level == jc.level
        assert tc.delay_ewma == jc.delay_ewma
        assert tc.score(tl) == jc.score(jl)
        assert tc.snapshot() == jc.snapshot()
    assert tc.n_quota_shed == jc.n_quota_shed


def test_priority_rank_and_config_validation_match_reference():
    for p in ("interactive", "batch"):
        assert tadm.priority_rank(p) == jadm.priority_rank(p)
    for bad in ("urgent", ""):
        with pytest.raises(ValueError, match="unknown priority"):
            tadm.priority_rank(bad)
    for kw, msg in ((dict(max_queue=0), "max_queue"),
                    (dict(ewma_alpha=0.0), "ewma_alpha"),
                    (dict(low_watermark=0.9, high_watermark=0.8),
                     "low_watermark")):
        with pytest.raises(ValueError, match=msg):
            AdmissionConfig(**kw)
        with pytest.raises(ValueError, match=msg):
            jadm.AdmissionConfig(**kw)
    with pytest.raises(ValueError, match="weight"):
        TenantPolicy(weight=0.0)
    assert EngineLoad(queue_depth=3, queue_limit=4).queue_frac == 0.75
    assert EngineLoad().as_dict() == jadm.EngineLoad().as_dict()


# -- the engine's front door -------------------------------------------------

_DET_LOAD = ("queue_depth", "queue_limit", "queued_interactive",
             "queued_batch", "token_backlog_interactive", "active_slots",
             "max_batch", "prefilling", "kv_free_blocks", "kv_total_blocks",
             "kv_occupancy", "token_backlog", "tokens_per_step",
             "admission_level", "prefill_paused", "n_shed_interactive",
             "n_shed_batch", "n_expired", "dispatch_depth")


def _pair(models, admission=None, **kw):
    """The JAX engine and the port's over one configuration."""
    jm, tm = models
    args = dict(max_batch=2, max_len=32, block_size=8, num_blocks=8,
                prompt_pad=8)
    args.update(kw)
    j = JEngine(jm, admission=None if admission is None
                else jadm.AdmissionConfig(**admission), **args)
    t = ContinuousBatchingEngine(tm, admission=None if admission is None
                                 else AdmissionConfig(**admission), **args)
    return j, t


def _same_load(j, t):
    a, b = j.load().as_dict(), t.load().as_dict()
    assert {k: a[k] for k in _DET_LOAD} == {k: b[k] for k in _DET_LOAD}


def _outcome(done):
    return {rid: (r.status, r.shed_reason, [int(x) for x in r.out],
                  r.clamped) for rid, r in done.items()}


def _both(j, t, fn):
    """Apply ``fn(engine, Deadline)`` to both engines; return both results."""
    return fn(j, JDeadline), fn(t, Deadline)


SCENARIOS = {
    # the bounded queue sheds the excess at submit; the rest serve exactly
    "queue_full": (dict(max_queue=2), dict(max_batch=1, num_blocks=4),
                   [("sub", i, 0, 5, 3, "batch", 60.0) for i in range(8)]),
    # an interactive arrival displaces the worst queued batch request
    "displace": (dict(max_queue=2), dict(max_batch=1, num_blocks=4),
                 [("sub", "b1", 1, 4, 3, "batch", None),
                  ("sub", "b2", 1, 4, 3, "batch", None),
                  ("sub", "i1", 1, 4, 3, "interactive", None)]),
    # within a class: tighter deadline first, unbounded last
    "ordering": (dict(max_queue=8), {},
                 [("sub", "loose", 2, 4, 2, "batch", 100.0),
                  ("sub", "tight", 2, 4, 2, "batch", 5.0),
                  ("sub", "none", 2, 4, 2, "batch", None),
                  ("sub", "i", 2, 4, 2, "interactive", None)]),
    # KV scarcity pauses admission, which resumes once blocks free up
    "pause": (dict(kv_pause_watermark=0.4), dict(max_batch=2, num_blocks=4),
              [("sub", "a", 4, 4, 13, "interactive", None), ("step",),
               ("sub", "b", 5, 5, 3, "interactive", None), ("step",)]),
    # the clamp admits a batch request at its clamped grant under pressure
    "clamp": (dict(kv_clamp_watermark=0.5, batch_clamp_tokens=4),
              dict(max_batch=2, num_blocks=4),
              [("sub", "a", 9, 4, 13, "interactive", None), ("step",),
               ("sub", "b", 10, 4, 20, "batch", None), ("step",)]),
    # a flood interleaved with service: sheds by class, no expiries
    "flood": (dict(max_queue=2, deadline_feasibility=False),
              dict(max_batch=1, num_blocks=4),
              [op for i in range(12) for op in (
                  ("sub", i, 20 + i, 4, 4,
                   "interactive" if i % 3 == 0 else "batch", 60.0),
                  ("step",))]),
    # chunked prefill behind a watermark with tenants under WFQ
    "chunked_wfq": (dict(max_queue=6, high_watermark=0.5, wfq=True),
                    dict(prefill_chunk=4, max_num_batched_tokens=8),
                    [("sub", i, 40 + i, 6 + i % 5, 3,
                      "batch" if i % 2 else "interactive", None,
                      "ab"[i % 2]) for i in range(9)]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_front_door_matches_reference(models, name):
    admission, kw, ops = SCENARIOS[name]
    frozen = Clock()  # remaining budgets (the queue's order key) stay put
    j, t = _pair(models, admission, **kw)
    for op in ops:
        if op[0] == "step":
            j.step()
            t.step()
        else:
            _, rid, seed, plen, new, pri, ddl = op[:7]
            tenant = op[7] if len(op) > 7 else "default"
            p = np.random.RandomState(seed).randint(0, 250, (plen,))
            rj, rt = _both(j, t, lambda e, Dl: e.add_request(
                rid, p, new, priority=pri, tenant=tenant,
                deadline=None if ddl is None else Dl(ddl, clock=frozen)))
            assert (rt.status, rt.shed_reason) == (rj.status, rj.shed_reason)
        assert [r.req_id for r in t._queue] == [r.req_id for r in j._queue]
        assert t.prefill_paused == j.prefill_paused
        _same_load(j, t)
    assert [r.req_id for r in t.drain_shed()] == [
        r.req_id for r in j.drain_shed()]
    dj, dt = j.run(), t.run()
    assert _outcome(dt) == _outcome(dj)
    assert t.n_shed == dict(j.n_shed.items())
    assert t.n_expired == j.n_expired == 0
    _same_load(j, t)
    assert t.manager.free_blocks == t.manager.num_blocks


def test_chaos_submit_drop_and_expiry_at_submit_match_reference(models):
    from paddle_tpu.testing import chaos as jchaos
    from paddle_tpu_torch.testing import chaos as tchaos

    clock = Clock()
    j, t = _pair(models, dict(max_queue=4))
    p = np.random.RandomState(7).randint(0, 250, (4,))
    try:
        for ch in (jchaos, tchaos):
            ch.install(ch.ChaosSchedule().at("serving.submit", 2, "drop"))
        res = []
        for e, Dl in ((j, JDeadline), (t, Deadline)):
            r1 = e.add_request("r1", p, 2)
            r2 = e.add_request("r2", p, 2)
            r3 = e.add_request("r3", p, 2, deadline=Dl(1.0, clock=clock))
            res.append([(r.status, r.shed_reason) for r in (r1, r2, r3)])
        assert res[0] == res[1]
        assert res[1][1] == ("shed", "chaos-drop")
    finally:
        jchaos.uninstall()
        tchaos.uninstall()
    clock.t = 5.0
    late = [e.add_request("late", p, 2, deadline=Dl(1.0, clock=lambda: 0.0))
            for e, Dl in ((j, JDeadline), (t, Deadline))]
    assert [r.status for r in late] == ["ok", "ok"]
    dead = [e.add_request("dead", p, 2, deadline=Dl(0.0, clock=clock))
            for e, Dl in ((j, JDeadline), (t, Deadline))]
    assert [(r.status, r.shed_reason) for r in dead] == [
        ("shed", "expired-at-submit")] * 2
    assert _outcome(t.run()) == _outcome(j.run())


# -- deadlines: queued, mid-prefill, mid-decode; sync and overlap ------------

@pytest.mark.parametrize("kw", [
    dict(prompt_pad=8),
    dict(prompt_pad=8, overlap=True),
    dict(prefill_chunk=4, max_num_batched_tokens=6),
    dict(prefill_chunk=4, max_num_batched_tokens=6, overlap=True),
    dict(prompt_pad=8, decode_chunk=3, overlap=True),
], ids=["sync", "overlap", "chunked", "chunked_overlap", "chunk3_overlap"])
def test_deadline_eviction_matches_reference(models, kw):
    """Requests expire in the queue, mid-prefill (chunked) and mid-decode
    (with a dispatch of theirs still on the ring in overlap mode): each
    ends ``expired`` with the reference's tokens, gains no token after its
    expiry, its blocks recycle into the next admission, and the survivors'
    streams equal the reference's."""
    clock = Clock()
    j, t = _pair(models, max_batch=2, num_blocks=6, **kw)
    rng = np.random.RandomState(8)
    reqs = [("stuck", rng.randint(0, 250, (7,)), 12, 1.0),
            ("live", rng.randint(0, 250, (5,)), 6, None),
            ("slow", rng.randint(0, 250, (8,)), 10, 3.0),
            ("queued", rng.randint(0, 250, (6,)), 5, 0.5),
            ("next", rng.randint(0, 250, (6,)), 5, None)]
    for e, Dl in ((j, JDeadline), (t, Deadline)):
        for rid, p, new, ddl in reqs:
            e.add_request(rid, p, new, deadline=None if ddl is None
                          else Dl(ddl, clock=clock))
    at_expiry = {}
    for tick in range(60):
        if tick in (1, 3, 6):
            clock.t += 1.0
        j.step()
        t.step()
        for rid, r in t._completed.items():
            if r.status == "expired":
                at_expiry.setdefault(rid, len(r.out))
        assert {rid: r.status for rid, r in t._completed.items()} == {
            rid: r.status for rid, r in j._completed.items()}, tick
        assert [len(r.out) for r in t._completed.values()] == [
            len(j._completed[rid].out) for rid in t._completed]
        if not (j._queue or j.num_active or t._queue or t.num_active):
            break
    dj, dt = j.run(), t.run()
    assert _outcome(dt) == _outcome(dj)
    assert {rid for rid, r in dt.items() if r.status == "expired"} == {
        "stuck", "queued", "slow"}
    for rid, n in at_expiry.items():
        assert len(dt[rid].out) == n  # nothing credited after the expiry
    assert dt["queued"].out == []  # expired in the queue
    if "prefill_chunk" in kw:
        assert dt["stuck"].out == []  # evicted mid-prefill
    assert dt["slow"].out  # evicted mid-decode
    assert t.n_expired == j.n_expired == 3
    assert t.manager.free_blocks == 6 and not t._ring


def test_overlap_expiry_discards_the_in_flight_tokens(models):
    """Overlap mode: a slot's request expires while a dispatch that
    served it is still on the ring. The harvest drops that dispatch's
    token for the row, the row is re-uploaded as trash, and the next
    request admitted into the recycled blocks decodes exactly."""
    jm, tm = models
    clock = Clock()
    eng = ContinuousBatchingEngine(tm, max_batch=1, max_len=32, block_size=8,
                                   num_blocks=2, prompt_pad=8, overlap=True)
    rng = np.random.RandomState(9)
    p1, p2 = rng.randint(0, 250, (6,)), rng.randint(0, 250, (5,))
    r1 = eng.add_request("a", p1, 10, deadline=Deadline(1.0, clock=clock))
    while len(r1.out) < 3:
        eng.step()
    assert eng._ring and eng._ring[-1].rows[0][1] is r1  # in flight
    clock.t = 2.0
    eng.add_request("b", p2, 4)
    eng.step()  # dispatch, harvest the older entry, then evict "a"
    assert r1.status == "expired" and eng._slots[0].req is not r1
    n = len(r1.out)
    assert eng._ring[0].rows[0][1] is r1  # its last dispatch, unharvested
    done = eng.run()
    assert len(done["a"].out) == n
    ref = JEngine(jm, max_batch=1, max_len=32, block_size=8, num_blocks=2,
                  prompt_pad=8)
    ref.add_request("b", p2, 4)
    assert done["b"].out == ref.run()["b"].out
    assert eng.manager.free_blocks == 2


def test_fence_then_requeue_into_a_new_engine(models):
    """The supervisor's recovery path: a fenced engine refuses to step;
    its accepted work (queued and in flight) is requeued into a fresh
    engine, bypassing admission, and reproduces the reference's streams;
    a request the new engine can never serve is shed."""
    jm, tm = models
    rng = np.random.RandomState(10)
    prompts = {i: rng.randint(0, 250, (4 + i,)) for i in range(4)}
    old = ContinuousBatchingEngine(tm, max_batch=2, max_len=32, block_size=8,
                                   num_blocks=8, prompt_pad=8,
                                   admission=AdmissionConfig(max_queue=4))
    for i, p in prompts.items():
        old.add_request(i, p, 5, priority="batch" if i % 2 else "interactive")
    old.step()
    old.step()
    old.fence()
    with pytest.raises(EngineFenced):
        old.step()
    live = [s.req for s in old._slots if s.req is not None] + list(old._queue)
    assert len(live) == 4 and any(r.out for r in live)
    new = ContinuousBatchingEngine(tm, max_batch=2, max_len=32, block_size=8,
                                   num_blocks=8, prompt_pad=8,
                                   admission=AdmissionConfig(max_queue=1))
    for r in live:
        new.requeue(r)
    assert len(new._queue) == 4  # accepted work is never shed for load
    big = GenRequest("big", np.zeros(9, np.int32), 3)
    new.requeue(big)
    assert big.status == "shed"
    assert big.shed_reason == "unservable-on-this-engine"
    done = new.run()
    ref = JEngine(jm, max_batch=2, max_len=32, block_size=8, num_blocks=8,
                  prompt_pad=8)
    for i, p in prompts.items():
        ref.add_request(i, p, 5)
    want = ref.run()
    for i in prompts:
        assert done[i].status == "ok" and done[i].out == want[i].out
    assert [r.req_id for r in new.drain_shed()] == ["big"]
    assert new.drain_shed() == []
