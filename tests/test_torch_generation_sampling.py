"""Sampling in the port's ``generate``: the reference's top-k masking rule,
reproducibility from the port's seeded generator, the draw's distribution,
and ``use_jit`` on and off.

JAX's threefry and torch's Philox streams never match, so no test compares
a sampled port stream with a JAX one: the reference is held to its masking
rule (the logits it draws from, captured at its categorical draw) and the
draw to a chi-square test against softmax of the masked logits.
"""
import jax
import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as paddle
from paddle_tpu.models import generation as JG
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, generate
from paddle_tpu_torch.models import generation as G

# the draw's p-value must exceed this: a fault that moves the distribution
# fails at any sample size worth running, a right draw fails 1 run in 1000
CHI2_P_MIN = 1e-3


@pytest.fixture(scope="module")
def model():
    pt_seed(0)
    return LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")


def _tie_logits(seed):
    """[4, 64] f32 logits on a coarse grid, so many values tie, the k-th
    largest among them."""
    r = np.random.RandomState(seed)
    return (r.randint(-6, 7, (4, 64)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("temperature,top_k", [(0.7, 5), (1.0, 1),
                                               (1.3, 17), (0.9, 0),
                                               (1.0, 64), (1.0, 100)])
def test_masking_rule_matches_reference(monkeypatch, temperature, top_k):
    seen = []

    def capture(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return jax.numpy.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    for s in range(3):
        x = _tie_logits(s)
        JG._sample(paddle.to_tensor(x), temperature, top_k)
        got = G._filter_logits(torch.from_numpy(x), temperature, top_k)
        want = seen[-1]
        np.testing.assert_array_equal(got.numpy(), want)
        if 0 < top_k < x.shape[1]:
            kth = np.sort(x / np.float32(temperature), axis=-1)[:, -top_k]
            kept = np.isfinite(want).sum(-1)
            ties = (x / np.float32(temperature) == kth[:, None]).sum(-1)
            assert (kept >= top_k).all()
            if s == 0:  # the grid ties at the k-th value in some row
                assert (kept > top_k).any() or (ties > 1).any()


def test_draws_lie_in_the_kept_set():
    x = torch.from_numpy(np.tile(_tie_logits(5)[:1], (4096, 1)))
    gen = torch.Generator().manual_seed(3)
    toks = G._sample(x, 0.8, 7, generator=gen).numpy()
    kept = np.isfinite(G._filter_logits(x[:1], 0.8, 7).numpy()[0])
    assert kept.sum() > 7  # ties with the 7th value stay in
    assert kept[toks].all()
    assert len(set(toks.tolist())) == kept.sum()  # every kept value drawn


def _ids(seed, b=2, s=6):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (b, s)).astype(np.int64))


def test_top_k_1_equals_greedy(model):
    ids = _ids(0)
    greedy = generate(model, ids, max_new_tokens=8)
    for kw in ({}, {"block_size": 4}, {"decode_chunk": 3}):
        got = generate(model, ids, max_new_tokens=8, temperature=1.0,
                       top_k=1, **kw)
        assert torch.equal(got, greedy), kw


@pytest.mark.parametrize("kw", [{}, {"block_size": 4, "decode_chunk": 3}],
                         ids=["dense", "paged_chunk3"])
def test_same_seed_reproduces_other_seeds_differ(model, kw):
    ids = _ids(1)

    def run(s):
        pt_seed(s)
        return generate(model, ids, max_new_tokens=12, temperature=0.9,
                        top_k=40, **kw)

    a, b, c = run(11), run(11), run(12)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, generate(model, ids, max_new_tokens=12))


def test_first_token_distribution(model):
    """4096 rows of one prompt: each first token is an independent draw
    from softmax of the prefill's last logits, masked and tempered."""
    temperature, top_k, n = 0.8, 20, 4096
    prompt = _ids(2, b=1)
    with torch.no_grad():
        logits = model(prompt)[:, -1]
    p = torch.softmax(G._filter_logits(logits, temperature, top_k),
                      dim=-1)[0].double().numpy()
    pt_seed(5)
    out = generate(model, prompt.repeat(n, 1), max_new_tokens=1,
                   temperature=temperature, top_k=top_k)
    toks = out[:, -1].numpy()
    support = np.flatnonzero(p > 0)
    assert np.isin(toks, support).all()
    counts = np.bincount(toks, minlength=p.size)[support]
    expected = p[support] * n
    # pool the bins expected below 5 draws, as the test requires
    small = expected < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(expected[~small], expected[small].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    res = stats.chisquare(obs, exp * obs.sum() / exp.sum())
    assert res.pvalue > CHI2_P_MIN, res


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=9),
    dict(max_new_tokens=9, block_size=4, decode_chunk=4, eos_token_id=7),
    dict(max_new_tokens=9, temperature=0.8, top_k=30, block_size=4,
         kv_dtype="int8"),
], ids=["greedy", "paged_chunk_eos", "sampled_int8"])
def test_use_jit_matches_eager(model, kw):
    ids = _ids(3)
    pt_seed(7)
    a = generate(model, ids, use_jit=True, **kw)
    pt_seed(7)
    b = generate(model, ids, use_jit=False, **kw)
    assert torch.equal(a, b)
    # the program store keeps one entry a signature, reset on each call
    pt_seed(7)
    assert torch.equal(generate(model, ids, use_jit=True, **kw), a)
