"""Port parity: the resource ledger (``utils/resources.py``) over the port's
``BlockManager`` and serving engine, against the JAX package's ledger over
its own.

Both ledgers see the same acquisitions and releases (blocks, engine slots,
host-tier frames) for the same work; ``verify()`` holds the ledger against
the manager after an engine run; a ``leak.hold``-deferred release is named
by ``leak_check()`` with its acquisition site.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import cache_tier as jtier
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.ops.paged_attention import BlockManager as JManager
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu.utils import resources as jres
from paddle_tpu.utils.retries import Deadline as JDeadline
from paddle_tpu_torch.inference import ContinuousBatchingEngine, HostTier
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.paged_attention import BlockManager
from paddle_tpu_torch.testing import chaos as tchaos
from paddle_tpu_torch.utils import load_jax_params
from paddle_tpu_torch.utils import resources as tres
from paddle_tpu_torch.utils.retries import Deadline


@pytest.fixture(autouse=True)
def _pristine():
    """The ledgers patch the managers class-wide: each test starts and
    leaves both packages uninstrumented."""
    for r in (tres, jres):
        r.uninstrument_resources()
    yield
    for r in (tres, jres):
        r.uninstrument_resources()
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


def _view(led, mgr=None):
    """Outstanding entries without the manager's ``id()`` and sites."""
    out = []
    for kind, key, n, _site in led.outstanding():
        if kind == "kv.block":
            assert mgr is None or key[0] == id(mgr)
            key = key[1]
        out.append((kind, repr(key), n))
    return sorted(out)


def test_manager_lifecycle_matches_reference():
    views = []
    for res, Mgr in ((tres, BlockManager), (jres, JManager)):
        led = res.instrument_resources()
        assert res.current() is led and res.instrument_resources() is led
        mgr = Mgr(8, 8)
        steps = []
        blocks = mgr.allocate("s0", 16)
        mgr.allocate("s1", 24)
        mgr.adopt("s2", blocks)
        mgr.fork("s2", 1)
        mgr.ref(blocks[0])
        led.verify(mgr)
        steps.append(_view(led, mgr))
        mgr.free_sequence("s0")
        mgr.release(blocks[0])
        led.verify(mgr)
        steps.append(_view(led, mgr))
        for s in ("s1", "s2"):
            mgr.free_sequence(s)
        steps.append((led.leak_check(), led.violation_count()))
        views.append(steps)
        res.uninstrument_resources()
    assert views[0] == views[1]


def test_instrumentation_patches_and_restores_the_port_manager():
    orig = BlockManager.__dict__["allocate"]
    led = tres.instrument_resources()
    assert BlockManager.__dict__["allocate"] is not orig
    tres.uninstrument_resources()
    assert BlockManager.__dict__["allocate"] is orig
    assert tres.current() is None
    BlockManager(4, 8).allocate("s0", 8)  # built while off: never counted
    assert led.outstanding() == []


def test_leak_names_its_site_and_verify_catches_divergence():
    led = tres.instrument_resources()
    mgr = BlockManager(8, 8)
    mgr.allocate("s0", 16)
    with pytest.raises(tres.ResourceLeakError) as ei:
        led.leak_check()
    msg = str(ei.value)
    assert "2 outstanding resource(s)" in msg and "LEAKED kv.block" in msg
    assert "test_torch_resources.py" in msg
    assert "in test_leak_names_its_site_and_verify_catches_divergence" in msg
    b = mgr.accounting()["owned"]["s0"][0]
    led.release("kv.block", (id(mgr), b))  # the ledger now lies by one ref
    with pytest.raises(tres.ResourceLeakError, match="diverge"):
        led.verify(mgr)
    mgr._free.pop()  # and the manager's own free list breaks
    with pytest.raises(tres.ResourceLeakError, match="conservation"):
        led.verify(mgr)
    led.release("engine.slot", "phantom")
    assert led.violation_count() == 1


@pytest.mark.parametrize("kw", [
    dict(prompt_pad=16),
    dict(prefill_chunk=4, max_num_batched_tokens=6, overlap=True,
         kv_dtype="int8"),
], ids=["whole", "chunked_overlap_int8"])
def test_engine_run_is_conserved_as_in_reference(models, kw):
    """An engine run with the prefix cache, a host tier, a deadline
    eviction and COW forks: the ledger verifies against the manager
    mid-run and after, holds the same entries as the reference's, and is
    clean once the cache's pins are cleared (host frames live on with the
    tier)."""
    jm, tm = models
    rng = np.random.RandomState(3)
    base = rng.randint(0, 250, (9,))
    prompts = [np.concatenate([base, rng.randint(0, 250, (3,))]),
               base.copy(), base.copy(), rng.randint(0, 250, (6,))]
    clock = {"t": 0.0}
    views = []
    for res, Eng, Tier, Dl, model in (
            (tres, ContinuousBatchingEngine, HostTier, Deadline, tm),
            (jres, JEngine, jtier.HostTier, JDeadline, jm)):
        led = res.instrument_resources()
        clock["t"] = 0.0
        eng = Eng(model, max_batch=2, max_len=32, block_size=4, num_blocks=16,
                  prefix_cache=True, cache_tier=Tier(), **kw)
        for i, p in enumerate(prompts):
            eng.add_request(i, p, 5, deadline=Dl(
                2.0, clock=lambda: clock["t"]) if i == 3 else None)
        seen = []
        for tick in range(80):
            if tick == 2:
                clock["t"] = 5.0  # request 3 expires in flight or queued
            eng.step()
            led.verify(eng.manager)
            seen.append(_view(led))
            if not (eng._queue or eng.num_active):
                break
        eng.run()
        led.verify(eng.manager)
        seen.append(_view(led))
        eng.prefix_cache.clear()
        seen.append(led.leak_check(ignore=("host.frame",)))
        assert {r.status for r in eng._completed.values()} == {
            "ok", "expired"}
        views.append(seen)
        res.uninstrument_resources()
    assert views[0] == views[1]


def test_leak_hold_deferral_is_named_after_an_engine_run(models):
    """``leak.hold`` drops one ledger decrement (the release itself
    happens): the pool is whole, and ``leak_check()`` names the deferred
    resource and where it was taken."""
    _, tm = models
    led = tres.instrument_resources()
    eng = ContinuousBatchingEngine(tm, max_batch=2, max_len=32, block_size=8,
                                   num_blocks=8, prompt_pad=8)
    with tchaos.active(tchaos.ChaosSchedule().at("leak.hold", 2, "drop")) \
            as mk:
        eng.add_request("a", np.arange(5), 4)
        eng.run()
    assert ("leak.hold", 2, "drop") in mk.events
    assert eng.manager.free_blocks == 8
    with pytest.raises(tres.ResourceLeakError) as ei:
        led.leak_check()
    assert "LEAKED" in str(ei.value) and "acquired at" in str(ei.value)
    assert "serving.py" in str(ei.value)
