"""Port parity: the port's ``ContinuousBatchingEngine`` against the JAX
package's engine on ``LlamaConfig.tiny()`` with carried weights.

Greedy token streams must agree token for token (f32 on the CPU; the
logits agree to ~1e-6, far inside any argmax margin of these prompts).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, generate
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


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return {i: rng.randint(0, 250, (n,)) for i, n in enumerate(lengths)}


CASES = {
    # whole-prompt prefill, mixed prompt lengths, three slots
    "mixed_prompts": (_prompts(0, (5, 11, 3)), (6, 4, 8), dict(
        max_batch=3, max_len=64, block_size=8, num_blocks=24, prompt_pad=16)),
    # 4 blocks: the third request must reuse the first one's freed blocks
    "eviction_recycles_blocks": (_prompts(1, (4, 6, 7)), (3, 10, 5), dict(
        max_batch=2, max_len=32, block_size=8, num_blocks=4, prompt_pad=8)),
    # chunked prefill under a 6-token budget
    "chunked_prefill": (_prompts(7, (3, 7, 13, 5)), (6, 6, 6, 6), dict(
        max_batch=2, max_len=48, block_size=8, num_blocks=12,
        prefill_chunk=4, max_num_batched_tokens=6)),
    # 4 decode steps per dispatch
    "decode_chunk": (_prompts(6, (3, 4, 5, 6)), (9, 5, 12, 7), dict(
        max_batch=2, max_len=48, block_size=8, num_blocks=12, prompt_pad=8,
        decode_chunk=4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_tokens_match_jax_engine(models, case):
    jm, tm = models
    prompts, budgets, kw = CASES[case]
    budgets = dict(enumerate(budgets))
    _, want = _serve(JEngine, jm, prompts, budgets, **kw)
    eng, got = _serve(ContinuousBatchingEngine, tm, prompts, budgets, **kw)
    assert got == want
    assert eng.manager.free_blocks == kw["num_blocks"]  # all recycled
    assert eng.decode_tokens == sum(budgets.values()) - len(budgets)
    if "max_num_batched_tokens" in kw:
        assert eng.max_step_tokens <= kw["max_num_batched_tokens"]


def test_eos_mid_chunk_matches_jax_engine(models):
    jm, tm = models
    prompts = _prompts(2, (4, 5, 6))
    budgets = {0: 10, 1: 10, 2: 10}
    base = dict(max_batch=3, max_len=32, block_size=8, num_blocks=12,
                prompt_pad=8, decode_chunk=4)
    _, free = _serve(ContinuousBatchingEngine, tm, prompts, budgets, **base)
    eos = free[0][3]  # forces an early stop inside a decode chunk
    _, want = _serve(JEngine, jm, prompts, budgets, eos_token_id=eos, **base)
    eng, got = _serve(ContinuousBatchingEngine, tm, prompts, budgets,
                      eos_token_id=eos, **base)
    assert got == want
    assert got[0] == free[0][:4]
    assert eng.manager.free_blocks == 12


@pytest.mark.parametrize("kw", [{}, {"block_size": 4},
                                {"block_size": 4, "decode_chunk": 3}],
                         ids=["dense", "paged", "paged_chunk3"])
def test_generate_matches_engine(models, kw):
    _, tm = models
    prompts = _prompts(4, (6, 6))
    _, served = _serve(ContinuousBatchingEngine, tm, prompts, {0: 7, 1: 7},
                       max_batch=2, max_len=32, block_size=8, num_blocks=8,
                       prompt_pad=8)
    ids = torch.from_numpy(np.stack([prompts[0], prompts[1]]).astype(np.int64))
    out = generate(tm, ids, max_new_tokens=7, **kw)
    assert out[:, 6:].tolist() == [served[0], served[1]]


def test_later_slices_refuse():
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    base = dict(max_batch=1, max_len=32, block_size=8, num_blocks=4)
    for kw in ({"cache_tier": object()}, {"role": "prefill_only"},
               {"fp8": True}, {"admission": object()}):
        with pytest.raises(NotImplementedError, match="later slice"):
            ContinuousBatchingEngine(tm, **base, **kw)
    eng = ContinuousBatchingEngine(tm, **base, prompt_pad=8)
    for kw in ({"deadline": 5.0}, {"priority": "batch"}, {"retries": 1},
               {"trace": {"trace_id": "t"}}):
        with pytest.raises(NotImplementedError, match="later slice"):
            eng.add_request("x", np.arange(3), **kw)
    with pytest.raises(ValueError, match="prompt length"):
        eng.add_request("big", np.zeros(9, np.int32))
    with pytest.raises(ValueError, match="tenant_namespaces requires"):
        ContinuousBatchingEngine(tm, **base, tenant_namespaces=True)
