"""Port parity: ``TensorParallel`` at mp=2 on GPT and BERT (their fused
qkv projection cut into whole heads of each of q, k and v, weight and bias
alike) against the JAX package's serial model on ``GPTConfig.tiny()`` and
``BertConfig.tiny()`` in f32, on the same weights (the reference's whole
arrays, sliced into each rank's shards by ``load_jax_params``).

Two gloo ranks in processes (``torch_dist_ranks.run_ranks``). Held to
``TOL = 1e-5``: the logits gathered over the vocabulary shards, the loss
through the vocab-sharded head (``ParallelCrossEntropy``; BERT's MLM
labels hold ``-100`` positions), and the gradient of every parameter,
sharded ones gathered whole. Also: every shard loads its slice of the
reference's arrays; each rank keeps half the heads of each of q, k and v;
a degree that does not divide the heads raises; the checkpoint placement
refuses the qkv shard (it is no one block of the whole).
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import BertForMaskedLM as JBertMLM
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.tensor import manipulation as M

import torch_dist_ranks as R
import torch_tp_ranks as T

TOL = 1e-5
B, S, MP = 2, 16, 2


def _reference(kind):
    """The reference's serial model: its arrays, the batch, the logits,
    the loss and every parameter's gradient."""
    paddle.seed(0)
    rng = np.random.RandomState(5)
    if kind == "gpt":
        jm = JGPT(JGPTConfig.tiny())
        ids = rng.randint(0, 512, (B, S)).astype(np.int64)
        labels = np.roll(ids, -1, axis=1)
    else:
        jm = JBertMLM(JBertConfig.tiny())
        ids = rng.randint(0, 512, (B, S)).astype(np.int64)
        labels = np.where(rng.rand(B, S) < 0.3, ids, -100).astype(np.int64)
        labels[:, 0] = ids[:, 0]  # at least one position per row
    arrays = {n: np.asarray(p._data).copy() for n, p in jm.named_parameters()}
    logits = jm(paddle.to_tensor(ids))
    v = logits.shape[-1]
    loss = JF.cross_entropy(M.reshape(logits, [B * S, v]),
                            paddle.to_tensor(labels.reshape(B * S)),
                            ignore_index=-100)
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()
             if p.grad is not None}  # BERT's pooler takes no part
    return dict(arrays=arrays, ids=ids, labels=labels,
                logits=np.asarray(logits.numpy()),
                loss=float(loss.numpy()), grads=grads)


@pytest.fixture(scope="module", params=["gpt", "bert"])
def case(request, tmp_path_factory):
    ref = _reference(request.param)
    tmp = tmp_path_factory.mktemp(f"tp_{request.param}")
    ranks = R.run_ranks(T.tp_gpt_bert_body, MP, tmp,
                        args=(request.param, ref["arrays"], ref["ids"],
                              ref["labels"]))
    return request.param, ref, ranks


def test_shards_load_the_references_arrays(case):
    _, _, ranks = case
    assert all(r["loaded_equal"] for r in ranks)


def test_logits_and_loss_match_the_serial_reference(case):
    _, ref, ranks = case
    for r in ranks:
        np.testing.assert_allclose(r["logits"], ref["logits"], atol=TOL,
                                   rtol=0)
        assert abs(r["loss"] - ref["loss"]) <= TOL


def test_gradients_match_the_serial_reference(case):
    kind, ref, ranks = case
    qkv = "qkv_proj" if kind == "gpt" else "qkv"
    for r in ranks:
        assert set(r["grads"]) == set(ref["grads"])
        # the fused qkv is sharded, weight and bias alike
        assert {f"{qkv}.weight", f"{qkv}.bias"} <= {
            ".".join(n.split(".")[-2:]) for n in r["sharded"]}
        for n, want in ref["grads"].items():
            np.testing.assert_allclose(r["grads"][n], want, atol=TOL,
                                       rtol=0, err_msg=n)


def test_each_rank_keeps_whole_heads_of_q_k_and_v(case):
    _, _, ranks = case
    h = 64  # the tiny configs' hidden width, 4 heads of 16
    assert all(r["qkv_local_cols"] == 3 * h // MP for r in ranks)


def test_checkpoint_placement_refuses_the_fused_shard(case):
    _, _, ranks = case
    assert all(r["placement_refused"] for r in ranks)


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_degree_that_does_not_divide_the_heads_raises(kind):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        check_whole_units
    from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                         GPTConfig, GPTForCausalLM)

    model = (GPTForCausalLM(GPTConfig.tiny(), device="cpu") if kind == "gpt"
             else BertForMaskedLM(BertConfig.tiny(), device="cpu"))
    check_whole_units(model, 2)
    # 4 heads a part: mp=3 divides 3 x 4 columns' heads but not one part's
    with pytest.raises(ValueError, match="in each of its 3 parts"):
        check_whole_units(model, 3)
