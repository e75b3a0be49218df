"""Port parity: GPT and BERT (``paddle_tpu_torch.models.{gpt,bert}``)
against the JAX package's on the tiny configurations in f32, with the JAX
models' weights carried over by ``load_jax_params``, at ``ATOL = 1e-4``.

- GPT: logits, the cached forward (prefill, then decode steps) on a dense
  cache, and greedy ``generate`` tokens equal to the reference's over
  dense, paged and int8 paged caches; per-sequence cache lengths on the
  paged cache give each row its own positions;
- BERT: the MLM logits with and without a padding mask and with token
  types, the pooled output, the sequence-classification head;
- three ``jit.to_static`` train steps of each (AdamW lr 1e-3) against the
  reference's compiled step: each loss.

The reference's attention runs its plain path here (CPU).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import BertForMaskedLM as JBertMLM
from paddle_tpu.models import BertForSequenceClassification as JBertCls
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import generate as jgenerate
from paddle_tpu.tensor import manipulation as M
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                     BertForSequenceClassification, GPTConfig,
                                     GPTForCausalLM, generate)
from paddle_tpu_torch.utils import load_jax_params

ATOL = 1e-4
B, S = 2, 16


def _carry(jm, tm):
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _gpt():
    paddle.seed(0)
    return _carry(JGPT(JGPTConfig.tiny()),
                  GPTForCausalLM(GPTConfig.tiny(), device="cpu"))


def _ids(vocab, seed=0, shape=(B, S)):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int64)


def test_entry_points_default_to_the_card():
    """Models and layers build on the card unless the CPU is asked for:
    without CUDA they raise."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.models import UNet2DConditionModel, UNetConfig

    for build in (lambda: GPTForCausalLM(GPTConfig.tiny()),
                  lambda: BertForMaskedLM(BertConfig.tiny()),
                  lambda: UNet2DConditionModel(UNetConfig.tiny()),
                  lambda: tnn.Conv2D(2, 2, 3), lambda: tnn.LayerNorm(4),
                  lambda: tnn.GroupNorm(2, 4), lambda: tnn.BatchNorm2D(3)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_gpt_logits_match():
    jm, tm = _gpt()
    ids = _ids(512)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    got = tm(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert tm.num_params() == jm.num_params()
    assert tm.flops_per_token(S) == jm.flops_per_token(S)


def test_gpt_cached_forward_matches_on_a_dense_cache():
    jm, tm = _gpt()
    ids = _ids(512, 1, (B, 12))
    jc, tc = jm.init_cache(B, 24), tm.init_cache(B, 24)
    cl = 0
    for chunk in (ids[:, :8], ids[:, 8:9], ids[:, 9:12]):
        jl, jc = jm.forward_with_cache(paddle.to_tensor(chunk), jc,
                                       paddle.to_tensor(np.int32(cl)))
        with torch.no_grad():
            tl, tc = tm.forward_with_cache(torch.from_numpy(chunk), tc,
                                           torch.tensor(cl, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()),
                                   atol=ATOL)
        cl += chunk.shape[1]


@pytest.mark.parametrize("cache", [dict(), dict(block_size=16),
                                   dict(block_size=16, kv_dtype="int8")],
                         ids=["dense", "paged", "int8_paged"])
def test_gpt_greedy_tokens_equal_the_references(cache):
    jm, tm = _gpt()
    ids = _ids(512, 2, (B, 9))
    want = np.asarray(jgenerate(jm, paddle.to_tensor(ids), max_new_tokens=12,
                                **cache).numpy())
    got = generate(tm, torch.from_numpy(ids), max_new_tokens=12, **cache)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gpt_paged_per_sequence_lengths_give_each_row_its_positions():
    _, tm = _gpt()
    tm.eval()
    ids = torch.from_numpy(_ids(512, 3, (B, 6)))
    lengths = [2, 5]
    caches = tm.init_cache(B, 32, block_size=16)
    with torch.no_grad():
        # both rows' five tokens cached; row 0 then continues after two
        # (the decode step masks its keys past position 2)
        tm.forward_with_cache(ids[:, :5], caches,
                              torch.zeros(B, dtype=torch.int32))
        tok = ids[:, 5:6]
        cl = torch.tensor(lengths, dtype=torch.int32)
        got, _ = tm.forward_with_cache(tok, caches, cl)
        for b, n in enumerate(lengths):
            whole = torch.cat([ids[b, :n], tok[b]])[None]
            want = tm(whole)[:, -1]
            np.testing.assert_allclose(got[b, -1].numpy(), want[0].numpy(),
                                       atol=ATOL)


def _bert(cls=JBertMLM, tcls=BertForMaskedLM, **kw):
    paddle.seed(0)
    return _carry(cls(JBertConfig.tiny(), **kw),
                  tcls(BertConfig.tiny(), device="cpu", **kw))


def _mask():
    m = np.ones((B, S), np.int64)
    m[1, 11:] = 0
    return m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("types", [False, True])
def test_bert_mlm_logits_match(masked, types):
    jm, tm = _bert()
    ids = _ids(512, 4)
    kw_np = {}
    if types:
        kw_np["token_type_ids"] = _ids(2, 5)
    if masked:
        kw_np["attention_mask"] = _mask()
    want = np.asarray(jm(paddle.to_tensor(ids), **{
        k: paddle.to_tensor(v) for k, v in kw_np.items()}).numpy())
    got = tm(torch.from_numpy(ids), **{
        k: torch.from_numpy(v) for k, v in kw_np.items()}).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    jx, jp = jm.bert(paddle.to_tensor(ids))
    tx, tp = tm.bert(torch.from_numpy(ids))
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp.numpy()),
                               atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_bert_sequence_classification_matches(masked):
    jm, tm = _bert(JBertCls, BertForSequenceClassification, num_classes=3)
    ids = _ids(512, 6)
    m = _mask() if masked else None
    want = np.asarray(jm(paddle.to_tensor(ids), attention_mask=None if m is None
                         else paddle.to_tensor(m)).numpy())
    got = tm(torch.from_numpy(ids), attention_mask=None if m is None
             else torch.from_numpy(m)).detach().numpy()
    assert got.shape == (B, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _mlm_labels(ids, seed):
    rs = np.random.RandomState(seed)
    labels = np.full_like(ids, -100)
    pick = rs.rand(*ids.shape) < 0.3
    labels[pick] = ids[pick]
    return labels


def _jax_losses(jm, loss_fn, args):
    opt = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())

    def step(*a):
        loss = loss_fn(*a)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    compiled = paddle.jit.to_static(step, layers=[jm], optimizers=[opt])
    ja = [paddle.to_tensor(a) for a in args]
    return [float(compiled(*ja).numpy()) for _ in range(3)]


def _torch_losses(tm, args):
    opt = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters())

    def step(*a):
        loss = tm.loss(*a)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    compiled = tjit.to_static(step, layers=[tm], optimizers=[opt])
    ta = [torch.from_numpy(a) for a in args]
    return [compiled(*ta).item() for _ in range(3)]


def _ce(jm, ids, labels, **kw):
    logits = jm(ids, **kw)
    b, s, v = logits.shape
    return JF.cross_entropy(M.reshape(logits, [b * s, v]),
                            M.reshape(labels, [b * s]), ignore_index=-100)


@pytest.mark.parametrize("family", ["gpt", "bert", "bert_masked"])
def test_three_to_static_steps_match_the_references(family):
    if family == "gpt":
        jm, tm = _gpt()
        ids = _ids(512, 7)
        args = (ids, np.roll(ids, -1, axis=1))
        want = _jax_losses(jm, lambda i, l: _ce(jm, i, l), args)
    else:
        jm, tm = _bert()
        ids = _ids(512, 8)
        if family == "bert":
            args = (ids, _mlm_labels(ids, 9))
            want = _jax_losses(jm, lambda i, l: _ce(jm, i, l), args)
        else:
            args = (ids, _mlm_labels(ids, 9), _mask())
            want = _jax_losses(
                jm, lambda i, l, m: _ce(jm, i, l, attention_mask=m), args)
    got = _torch_losses(tm, args)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got[2] < got[0]
