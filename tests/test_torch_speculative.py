"""Port parity: the port's draft proposers and ``generate(speculative_k=)``
against the JAX package's, on ``LlamaConfig.tiny()`` with carried weights.

The proposer is pure numpy in both packages, so its drafts and the accept
rule must agree exactly. Speculative generation must give the reference's
tokens and the port's own plain greedy tokens exactly (f32 on the CPU; the
logits agree to ~1e-6, far inside any argmax margin of these prompts).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import speculative as jspec
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models.generation import generate as jgenerate
from paddle_tpu_torch.inference import speculative as tspec
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, generate
from paddle_tpu_torch.models import generation as G
from paddle_tpu_torch.utils import load_jax_params

_RNG = np.random.RandomState(7)
_BASE = _RNG.randint(0, 50, (6,))
_REPETITIVE = np.concatenate([_BASE, _BASE, _BASE])[:16]  # n-gram signal
_RAND = _RNG.randint(0, 250, (16,))


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return jm, tm


# the cases of tests/test_spec_decode.py's proposer tests, then seeded
# random histories over a small alphabet (many n-gram repeats)
_HIST = [
    (dict(max_ngram=3), [5, 6, 7, 8, 5, 6, 7], 4),
    (dict(max_ngram=3), [1, 2, 3, 4, 0, 2, 3, 9, 1, 2, 3], 1),
    (dict(max_ngram=2), [2, 3, 4, 9, 2, 3, 5, 9, 2, 3], 1),
    (dict(), list(range(10)), 4),
    (dict(), [3], 4),
    (dict(), [3, 3, 3], 0),
] + [(dict(max_ngram=int(r.randint(1, 5)), min_ngram=1),
      list(r.randint(0, 4, (int(r.randint(1, 40)),))), int(r.randint(0, 6)))
     for r in [np.random.RandomState(s) for s in range(40)]]


def test_ngram_proposer_matches_reference():
    for kw, toks, k in _HIST:
        toks = np.asarray(toks, np.int32)
        want = jspec.NgramProposer(**kw).propose(toks, k)
        got = tspec.NgramProposer(**kw).propose(toks, k)
        assert got.dtype == want.dtype == np.int32
        assert got.tolist() == want.tolist(), (kw, toks, k)
    with pytest.raises(ValueError, match="min_ngram"):
        tspec.NgramProposer(max_ngram=2, min_ngram=3)
    with pytest.raises(NotImplementedError):
        tspec.DraftProposer().propose(np.zeros(3, np.int32), 2)


def test_accept_length_matches_reference():
    cases = [([1, 2, 3], [1, 2, 3, 9]), ([1, 2, 3], [1, 9, 3]), ([1], [2]),
             (np.zeros((0,)), np.array([5]))]
    rng = np.random.RandomState(1)
    for _ in range(200):
        n = int(rng.randint(0, 6))
        d = rng.randint(0, 3, (n,))
        cases.append((d, np.concatenate([d[:rng.randint(0, n + 1)],
                                         rng.randint(0, 3, (n + 1,))])))
    for d, t in cases:
        assert tspec.accept_length(d, t) == jspec.accept_length(d, t)


def _tokens(out):
    return np.asarray(out.numpy() if hasattr(out, "numpy") else out)


_SPEC_CASES = {
    # k = 2, 4, 8 on one repetitive row
    "k2": (_REPETITIVE[None], dict(max_new_tokens=12, speculative_k=2)),
    "k8": (_REPETITIVE[None], dict(max_new_tokens=12, speculative_k=8)),
    # two rows advance together by the batch-minimum accept
    "batch": (np.stack([_REPETITIVE, _RAND]),
              dict(max_new_tokens=9, speculative_k=3)),
    "paged": (_REPETITIVE[None], dict(max_new_tokens=10, speculative_k=4,
                                      block_size=8)),
    "paged_int8": (_REPETITIVE[None], dict(max_new_tokens=10, speculative_k=4,
                                           block_size=8, kv_dtype="int8")),
}


@pytest.mark.parametrize("case", list(_SPEC_CASES))
def test_generate_speculative_matches_reference_and_plain(models, case):
    jm, tm = models
    prompt, kw = _SPEC_CASES[case]
    want = _tokens(jgenerate(jm, paddle.to_tensor(prompt.astype(np.int64)),
                             **kw))
    ids = torch.from_numpy(prompt.astype(np.int64))
    got = _tokens(generate(tm, ids, **kw))
    plain_kw = {k: v for k, v in kw.items() if k != "speculative_k"}
    plain = _tokens(generate(tm, ids, **plain_kw))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)


def test_generate_speculative_eos_freezes_rows(models):
    jm, tm = models
    ids = torch.from_numpy(_REPETITIVE[None].astype(np.int64))
    ref = _tokens(generate(tm, ids, max_new_tokens=10, use_jit=False))[0, 16:]
    eos = int(ref[3])
    got = _tokens(generate(tm, ids, max_new_tokens=10, speculative_k=4,
                           eos_token_id=eos))[0, 16:]
    want = _tokens(jgenerate(
        jm, paddle.to_tensor(_REPETITIVE[None].astype(np.int64)),
        max_new_tokens=10, speculative_k=4, eos_token_id=eos))[0, 16:]
    assert list(got) == list(want) == list(ref[:4]) + [eos] * 6


def test_no_draft_rounds_take_the_single_step(models, monkeypatch):
    _, tm = models
    calls = {"verify": 0}
    orig = G._get_compiled

    def wrapped(*a, **kw):
        res = orig(*a, **kw)
        if len(res) == 4:
            state, prefill, decode, verify = res

            def counting_verify(ids, cur):
                calls["verify"] += 1
                return verify(ids, cur)

            return state, prefill, decode, counting_verify
        return res

    monkeypatch.setattr(G, "_get_compiled", wrapped)

    class NoDraft(tspec.DraftProposer):
        def propose(self, tokens, k):
            return np.zeros((0,), np.int32)

    ids = torch.from_numpy(_RAND[None].astype(np.int64))
    ref = _tokens(generate(tm, ids, max_new_tokens=8))
    out = _tokens(generate(tm, ids, max_new_tokens=8, speculative_k=4,
                           draft_proposer=NoDraft()))
    assert calls["verify"] == 0
    np.testing.assert_array_equal(out, ref)
    generate(tm, ids, max_new_tokens=8, speculative_k=4)
    assert calls["verify"] == 0  # the random prompt gives no n-gram either
    rep = torch.from_numpy(_REPETITIVE[None].astype(np.int64))
    generate(tm, rep, max_new_tokens=8, speculative_k=4)
    assert calls["verify"] > 0


def test_generate_speculative_validation(models):
    _, tm = models
    ids = torch.from_numpy(_REPETITIVE[None].astype(np.int64))
    with pytest.raises(ValueError, match="greedy-only"):
        generate(tm, ids, speculative_k=2, temperature=0.5)
    with pytest.raises(ValueError, match="alternative decode"):
        generate(tm, ids, speculative_k=2, decode_chunk=4)
    with pytest.raises(ValueError, match="speculative_k"):
        generate(tm, ids, speculative_k=0)
    with pytest.raises(ValueError, match="paged"):
        generate(tm, ids, kv_dtype="int8")  # dense cache
