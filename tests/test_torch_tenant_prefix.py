"""Port parity: tenant prefix namespaces (``tenant_namespaces=True``,
``shared_prefixes``, ``add_request(tenant=)``) against the JAX package's
engine with the same keywords, on ``LlamaConfig.tiny()`` with carried
weights.

Token streams, ``prefix_stats()`` and the block manager's ``accounting()``
must agree exactly; one tenant never adopts another's blocks, and a
registered shared prefix is adopted across tenants.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.utils import load_jax_params

_RNG = np.random.RandomState(11)
_SYSTEM = _RNG.randint(0, 250, (16,))  # two blocks of 8: shared by all
_PRIVATE = _RNG.randint(0, 250, (16,))  # tenant a's own document
# (req_id, tenant, prompt); max_batch=1 runs them one after another, so
# every earlier prompt's blocks are in the cache when the next is admitted
_WORK = [
    ("a0", "a", np.concatenate([_PRIVATE, _RNG.randint(0, 250, (3,))])),
    ("b0", "b", np.concatenate([_PRIVATE, _RNG.randint(0, 250, (5,))])),
    ("a1", "a", np.concatenate([_PRIVATE, _RNG.randint(0, 250, (4,))])),
    ("a2", "a", np.concatenate([_SYSTEM, _RNG.randint(0, 250, (6,))])),
    ("b1", "b", np.concatenate([_SYSTEM, _RNG.randint(0, 250, (2,))])),
    ("c0", "c", _SYSTEM.copy()),  # fully cached: forks its last block
    ("b2", "b", np.concatenate([_SYSTEM[:8], _RNG.randint(0, 250, (9,))])),
]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _serve(engine_cls, model, **kw):
    eng = engine_cls(model, max_batch=1, max_len=48, block_size=8,
                     num_blocks=24, prefix_cache=True, **kw)
    hits = {}
    for rid, tenant, prompt in _WORK:
        before = eng.prefix_stats()["hit_tokens"]
        eng.add_request(rid, prompt, max_new_tokens=4, tenant=tenant)
        done = eng.run()
        hits[rid] = eng.prefix_stats()["hit_tokens"] - before
    return {r: list(map(int, done[r].out)) for r in done}, hits, eng


_CASES = {
    "whole": dict(prompt_pad=32),
    "chunked": dict(prefill_chunk=8, max_num_batched_tokens=9),
    "int8_overlap": dict(prompt_pad=32, kv_dtype="int8", overlap=True),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_tenant_namespaces_match_reference(models, case):
    jm, tm = models
    kw = dict(_CASES[case], tenant_namespaces=True,
              shared_prefixes=[_SYSTEM])
    want, want_hits, jeng = _serve(JEngine, jm, **kw)
    got, hits, eng = _serve(ContinuousBatchingEngine, tm, **kw)
    assert got == want
    assert hits == want_hits
    assert eng.prefix_stats() == jeng.prefix_stats()
    assert eng.manager.accounting() == jeng.manager.accounting()
    # b0 shares a's private document but not a's namespace; a1 adopts it
    assert hits["b0"] == 0 and hits["a1"] == 16
    # the system prompt was registered by a2 and is adopted across tenants
    assert hits["b1"] == 16 and hits["c0"] == 15 and hits["b2"] == 8
    assert eng.prefix_stats()["forks"] == 1


def test_without_namespaces_tenants_share(models):
    _, tm = models
    _, hits, _ = _serve(ContinuousBatchingEngine, tm, prompt_pad=32)
    assert hits["b0"] == 16  # one tree: b adopts a's document


def test_shared_prefix_needs_registration(models):
    """Without ``shared_prefixes`` the system prompt stays in the tenant
    that prefilled it."""
    jm, tm = models
    kw = dict(prompt_pad=32, tenant_namespaces=True)
    want, want_hits, jeng = _serve(JEngine, jm, **kw)
    got, hits, eng = _serve(ContinuousBatchingEngine, tm, **kw)
    assert got == want and hits == want_hits
    assert eng.manager.accounting() == jeng.manager.accounting()
    assert hits["b1"] == hits["c0"] == 0
    assert hits["b2"] == 8  # b's own tree holds b1's copy of it
