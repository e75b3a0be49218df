"""Port parity: the port's ``ContinuousBatchingEngine`` with int8 KV pools
and the prefix cache against the JAX package's engine, on
``LlamaConfig.tiny()`` with carried weights.

Greedy token streams, ``prefix_stats()`` and the block manager's
``accounting()`` must agree exactly (f32 on the CPU; the logits agree to
~1e-6, far inside any argmax margin of these prompts).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.utils import load_jax_params


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _serve(engine_cls, model, prompts, budgets, **kw):
    eng = engine_cls(model, **kw)
    for rid, p in prompts.items():
        eng.add_request(rid, p, max_new_tokens=budgets[rid])
    done = eng.run()
    return eng, {rid: list(map(int, r.out)) for rid, r in done.items()}


def _family_prompts(seed, n_prefix, tails, repeats=()):
    """Prompts sharing two prefixes (alternating), then exact repeats of
    the prompts named in ``repeats`` (a block-multiple repeat is fully
    cached and forks its last block)."""
    rng = np.random.RandomState(seed)
    fams = [rng.randint(0, 250, (n_prefix,)) for _ in range(2)]
    prompts = {i: np.concatenate([fams[i % 2], rng.randint(0, 250, (t,))])
               for i, t in enumerate(tails)}
    for r in repeats:
        prompts[f"again{r}"] = prompts[r].copy()
    return prompts


WHOLE = dict(max_batch=2, max_len=64, block_size=8, num_blocks=20,
             prompt_pad=32)
CHUNKED = dict(max_batch=2, max_len=64, block_size=8, num_blocks=20,
               prefill_chunk=8, max_num_batched_tokens=10)
CASES = {
    "int8_whole": (_family_prompts(0, 5, (6, 11, 3, 14)), WHOLE,
                   dict(kv_dtype="int8")),
    "int8_chunked": (_family_prompts(1, 5, (6, 19, 3, 14)), CHUNKED,
                     dict(kv_dtype="int8")),
    "prefix_whole": (_family_prompts(2, 16, (5, 3, 7, 0, 9)), WHOLE,
                     dict(prefix_cache=True)),
    "prefix_chunked": (_family_prompts(3, 16, (5, 3, 7, 0, 9)), CHUNKED,
                       dict(prefix_cache=True)),
    "prefix_int8_whole": (_family_prompts(4, 16, (5, 3, 7, 1, 9)), WHOLE,
                          dict(prefix_cache=True, kv_dtype="int8")),
    "prefix_int8_chunked": (_family_prompts(5, 16, (5, 3, 7, 1, 9)), CHUNKED,
                            dict(prefix_cache=True, kv_dtype="int8")),
    # prompts of 24 and 16 tokens repeated: fully cached, they fork
    "fork_int8": (_family_prompts(6, 16, (8, 0, 3), repeats=(0, 1)), WHOLE,
                  dict(prefix_cache=True, kv_dtype="int8")),
    "fork_chunked": (_family_prompts(7, 16, (8, 0, 3), repeats=(0, 1)),
                     CHUNKED, dict(prefix_cache=True)),
    # 7 blocks: each request needs 3-4, so cached prefixes must be evicted
    "evict_int8": (_family_prompts(8, 8, (9, 4, 12, 1, 6, 10)),
                   dict(WHOLE, num_blocks=7, prompt_pad=24),
                   dict(prefix_cache=True, kv_dtype="int8")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_engine(models, case):
    jm, tm = models
    prompts, base, kw = CASES[case]
    budgets = {rid: 4 + i % 3 for i, rid in enumerate(prompts)}
    jeng, want = _serve(JEngine, jm, prompts, budgets, **base, **kw)
    eng, got = _serve(ContinuousBatchingEngine, tm, prompts, budgets,
                      **base, **kw)
    assert got == want
    assert eng.prefix_stats() == jeng.prefix_stats()
    assert eng.manager.accounting() == jeng.manager.accounting()
    acc = eng.manager.accounting()
    # every block is free or pinned by the cache alone: nothing leaked
    assert acc["free"] + len(acc["refs"]) == acc["total"]
    assert acc["owned"] == {} and set(acc["refs"].values()) <= {1}
    st = eng.prefix_stats()
    if kw.get("prefix_cache"):
        assert st["hit_tokens"] > 0
    if case.startswith("fork"):
        assert st["forks"] == 2
    if case.startswith("evict"):
        assert st["evicted_blocks"] > 0
    if case.endswith("chunked"):
        assert eng.max_step_tokens <= base["max_num_batched_tokens"]


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["float", "int8"])
def test_offset_prefill_past_row_leaves_shared_blocks_untouched(models,
                                                                kv_dtype):
    """A cache hit's whole-prompt prefill writes ``prompt_pad`` lanes from
    the cached offset: here positions 24..51 of a 32-position row. The
    lanes past the row write back into the row's first block, which is a
    shared (adopted) prefix block: its bytes and scales must come out
    bitwise unchanged, and the tokens equal the reference engine's."""
    jm, tm = models
    p = np.random.RandomState(8).randint(0, 250, (28,))
    kw = dict(max_batch=1, max_len=32, block_size=8, num_blocks=8,
              prompt_pad=28, prefix_cache=True, kv_dtype=kv_dtype)
    jeng = JEngine(jm, **kw)
    eng = ContinuousBatchingEngine(tm, **kw)
    for e in (jeng, eng):
        e.add_request("cold", p, max_new_tokens=4)
        e.run()
    shared = eng.prefix_cache.lookup(p)[1]
    assert len(shared) == 3
    snap = [[pool[:, shared].clone() for pool in entry] for entry in eng._pools]
    seen = []
    prefill = eng._prefill

    def checked_prefill(ids, tables, cache_len, last_idx):
        out = prefill(ids, tables, cache_len, last_idx)
        # write positions 24..51: lanes 32..51 run past the 4-block row
        assert int(cache_len.max()) == 24 and tables[0, 0] == shared[0]
        for entry, before in zip(eng._pools, snap):
            for pool, b in zip(entry, before):
                assert torch.equal(pool[:, shared], b)
        seen.append(True)
        return out

    eng._prefill = checked_prefill
    for e in (jeng, eng):
        e.add_request("hot", p, max_new_tokens=4)
    want, got = jeng.run(), eng.run()
    assert seen == [True]
    assert got["hot"].out == want["hot"].out == want["cold"].out
    assert eng.prefix_hit_tokens == jeng.prefix_hit_tokens == 24
