"""Port parity: the pipeline over point-to-point sends.

``PipelineLayer``'s segmentation against the reference's at V=1 and V=2
(prologue, body and epilogue, the stacked parameters' names and shapes, the
chunk-to-row map, and the whole layer's forward on one process). Then
``fleet.init(pp_degree=2)`` and ``fleet.distributed_model`` (a
``PipelineParallel`` on each of two gloo ranks, each holding its stage's
rows) against the reference's ``PipelineParallel`` on its CPU mesh, for the
reference tests' Block model on the reference's weights (its whole arrays,
sliced into each stage by ``load_jax_params``): each step's
``train_batch`` loss, ``eval_batch``'s loss and logits, and every
parameter after 3 SGD steps, at V=1 and V=2; dp=2 x pp=2 on four ranks
(each dp rank on its rows of every microbatch, as the reference shards
them): the same, plus the stage shards bitwise equal across dp peers and
one dp average a step. ``LlamaConfig.tiny`` at 4 layers as a pipeline at
pp=2 (V=1, V=2, and V=1 with recompute) with AdamW and
``ClipGradByGlobalNorm`` through ``distributed_optimizer``, against the
reference's serial ``LlamaForCausalLM`` on the same weights (the
reference's pipeline is microbatch-exact, so its serial run is its
answer). pp beside mp, sep or sharding raises. Tolerance 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet.meta_parallel import LayerDesc as JLayerDesc
from paddle_tpu.distributed.fleet.meta_parallel import \
    PipelineLayer as JPipelineLayer
from paddle_tpu.distributed.fleet.meta_parallel import \
    PipelineParallel as JPipelineParallel
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

import torch_dist_ranks as R
import torch_pp_ranks as P
from paddle_tpu_torch.distributed.fleet.meta_parallel import (LayerDesc,
                                                              PipelineLayer)
from paddle_tpu_torch.nn import Embedding, Linear
from paddle_tpu_torch.utils import load_jax_params

TOL = 1e-4
H, C, MB, M, STEPS, LR = 16, 4, 4, 4, 3, 0.1


class JBlock(jnn.Layer):
    def __init__(self, h):
        super().__init__()
        self.fc = jnn.Linear(h, h)

    def forward(self, x):
        return JF.relu(self.fc(x))


def _jce(logits, y):
    return JF.cross_entropy(logits, y)


def _arrays(layer):
    return {n: np.asarray(p._data).copy() for n, p in layer.named_parameters()}


# ---------------------------------------------------------------------------
# segmentation


@pytest.mark.parametrize("V", [1, 2])
def test_segmentation_matches_reference(V):
    paddle.seed(3)
    ref = JPipelineLayer(
        [jnn.Embedding(10, H)] + [JLayerDesc(JBlock, H) for _ in range(8)]
        + [jnn.Linear(H, C)], num_stages=2, num_virtual_pipeline_stages=V)
    got = PipelineLayer(
        [Embedding(10, H, device="cpu", dtype=torch.float32)]
        + [LayerDesc(P.Block, H) for _ in range(8)]
        + [Linear(H, C, device="cpu", dtype=torch.float32)],
        num_stages=2, num_virtual_pipeline_stages=V)
    assert len(got._pre) == len(ref._pre) == 1
    assert len(got._post) == len(ref._post) == 1
    assert got._num_layers_per_stage == ref._num_layers_per_stage == 4
    assert [got._stacked_index(c) for c in range(2 * V)] == \
        [ref._stacked_index(c) for c in range(2 * V)]
    want = {n: tuple(p.shape) for n, p in ref.named_parameters()}
    assert {n: tuple(p.shape) for n, p in got.named_parameters()} == want
    # the whole layer (every stage on one process) runs the chunks in order
    arrays = _arrays(ref)
    load_jax_params(got, arrays)
    ids = np.random.RandomState(0).randint(0, 10, (6,)).astype(np.int64)
    np.testing.assert_allclose(
        got(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(ref(paddle.to_tensor(ids))._data), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# PipelineParallel on the Block model


def _batches(seed, n=STEPS):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, M * MB, H).astype(np.float32)
    ys = rng.randint(0, C, (n, M * MB)).astype(np.int64)
    return xs, ys


def _reference_block(dp, V, n_layers, seed, xs, ys):
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "pp_degree": 2}
    strategy.pipeline_configs = {"accumulate_steps": M}
    hcg = jfleet.init(strategy=strategy)
    try:
        paddle.seed(seed)
        pipe = JPipelineLayer(
            [JLayerDesc(JBlock, H) for _ in range(n_layers)]
            + [jnn.Linear(H, C)], num_stages=2,
            num_virtual_pipeline_stages=V, loss_fn=_jce)
        arrays = _arrays(pipe)
        model = JPipelineParallel(pipe, hcg, strategy)
        opt = jopt.SGD(learning_rate=LR, parameters=pipe.parameters())
        losses = [float(model.train_batch(
            (paddle.to_tensor(x), paddle.to_tensor(y)), opt))
            for x, y in zip(xs, ys)]
        # the reference's eval_batch runs under to_static (eagerly its
        # shard_map refuses the mesh's other axes on this jax)
        data = (paddle.to_tensor(xs[-1]), paddle.to_tensor(ys[-1]))
        ev = float(paddle.jit.to_static(
            lambda a, b: model.eval_batch((a, b)))(*data))
        logits = np.asarray(paddle.jit.to_static(
            lambda a, b: model.eval_batch((a, b), compute_loss=False))(
                *data)._data)
        params = _arrays(pipe)
    finally:
        jdist.destroy_process_group()
        jfleet.set_hybrid_communicate_group(None)
    return arrays, losses, ev, logits, params


def _stage_slice(name, a, stage, V):
    return a[stage * V:(stage + 1) * V] if name.startswith(
        "pipeline_stacked_") else a


def _check_ranks(ranks, ref, V):
    _, losses, ev, logits, params = ref
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["eval"], ev, rtol=TOL, atol=TOL)
        assert set(r["params"]) == {n for n in params if (
            n.startswith("pipeline_stacked_") or r["stage"] == 1)}
        for n, a in r["params"].items():
            np.testing.assert_allclose(
                a, _stage_slice(n, params[n], r["stage"], V), rtol=TOL,
                atol=TOL, err_msg=n)
    return losses, logits


@pytest.fixture(scope="module")
def block_runs(tmp_path_factory):
    out = {}
    for V in (1, 2):
        xs, ys = _batches(10 + V)
        ref = _reference_block(1, V, 8, 20 + V, xs, ys)
        ranks = R.run_ranks(P.pipeline_block_body, 2,
                            tmp_path_factory.mktemp(f"pp{V}"),
                            args=(1, V, M, 8, ref[0], xs, ys, LR))
        out[V] = (ranks, ref)
    return out


@pytest.mark.parametrize("V", [1, 2])
def test_pipeline_matches_reference(block_runs, V):
    ranks, ref = block_runs[V]
    assert [r["stage"] for r in ranks] == [0, 1]
    losses, logits = _check_ranks(ranks, ref, V)
    # every rank returns the same loss and the eval logits
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for r in ranks:
        np.testing.assert_allclose(r["logits"], logits, rtol=TOL, atol=TOL)
    # a hop a microbatch a chunk boundary, each way
    boundaries = 2 * V - 1
    assert sum(r["hops"] for r in ranks) == \
        2 * boundaries * M * STEPS + boundaries * M * 2


def test_dp_pp_matches_reference(tmp_path):
    xs, ys = _batches(31)
    ref = _reference_block(2, 1, 4, 32, xs, ys)
    ranks = R.run_ranks(P.pipeline_block_body, 4, tmp_path,
                        args=(2, 1, M, 4, ref[0], xs, ys, LR))
    _check_ranks(ranks, ref, 1)
    by_stage = {}
    for r in ranks:
        by_stage.setdefault(r["stage"], []).append(r)
        assert r["n_syncs"] == STEPS  # one dp average a step
    for stage, peers in by_stage.items():
        assert sorted(p["dp_rank"] for p in peers) == [0, 1]
        for n in peers[0]["params"]:
            assert np.array_equal(peers[0]["params"][n],
                                  peers[1]["params"][n]), (stage, n)


@pytest.mark.parametrize("S", [2, 3])
def test_shared_layer_across_stages_matches_the_whole_layer(tmp_path, S):
    """A ``SharedLayerDesc`` on the first and the last stage: its gradient
    summed over the two, the clip counting it once. The oracle is the
    port's whole ``PipelineLayer`` on one process (one instance, tied
    structurally; the reference's pipeline fails with a prologue that has
    parameters, ROADMAP C3)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD

    torch.manual_seed(0)
    whole = P.shared_pipe(H, 2 * S, num_stages=S)
    arrays = {n: p.detach().numpy().copy()
              for n, p in whole.named_parameters()}
    # the instance's names on the last stage (the whole layer lists it once)
    arrays.update({n.replace("_pre.", "_post."): a for n, a in arrays.items()
                   if n.startswith("_pre.")})
    xs, ys = _batches(41)
    ys = ys % H
    clip = 0.5
    opt = SGD(learning_rate=LR, parameters=whole.parameters(),
              grad_clip=ClipGradByGlobalNorm(clip))
    losses, norms = [], []
    for x, y in zip(xs, ys):
        loss = P._ce(whole(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        norms.append(float(opt._grad_clip.global_norm(
            [(p, p.grad) for p in whole.parameters()])))
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    ranks = R.run_ranks(P.shared_body, S, tmp_path,
                        args=(M, 2 * S, arrays, xs, ys, LR, clip))
    want = {n: p.detach().numpy() for n, p in whole.named_parameters()}
    for s, r in enumerate(ranks):
        np.testing.assert_allclose(r["losses"], losses, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["norms"], norms, rtol=TOL, atol=TOL)
        for n, a in r["params"].items():
            w = want[n.replace("_post.", "_pre.")]
            np.testing.assert_allclose(a, _stage_slice(n, w, s, 1), rtol=TOL,
                                       atol=TOL, err_msg=n)
    assert np.array_equal(ranks[0]["params"]["_pre.0.weight"],
                          ranks[-1]["params"]["_post.0.weight"])


# ---------------------------------------------------------------------------
# Llama as a pipeline against the reference's serial model

LLAMA_LAYERS, LLAMA_B, LLAMA_S, LLAMA_CLIP = 4, 4, 16, 0.1
_DECODER = ("input_layernorm.weight", "self_attn.q_proj.weight",
            "self_attn.k_proj.weight", "self_attn.v_proj.weight",
            "self_attn.o_proj.weight", "post_attention_layernorm.weight",
            "mlp.gate_proj.weight", "mlp.up_proj.weight",
            "mlp.down_proj.weight")


def _pipe_arrays(serial, S, V, n_layers):
    """The serial Llama's arrays in the reference pipeline's layout: the
    embedding as the prologue, the norm and head as the epilogue, and each
    decoder parameter stacked ``[S·V, ...]`` with logical chunk ``v·S + s``
    at row ``s·V + v``."""
    per = n_layers // (S * V)
    out = {"_pre.0.weight": serial["llama.embed_tokens.weight"],
           "_post.0.weight": serial["llama.norm.weight"],
           "_post.1.weight": serial["lm_head.weight"]}
    k = 0
    for i in range(per):
        for name in _DECODER:
            rows = [None] * (S * V)
            for c in range(S * V):
                v, s = divmod(c, S)
                rows[s * V + v] = serial[f"llama.layers.{c * per + i}.{name}"]
            out[f"pipeline_stacked_{k}"] = np.stack(rows)
            k += 1
    return out


def _llama_reference(arrays, ids, labels):
    paddle.seed(0)
    jm = JLlama(JConfig.tiny(num_hidden_layers=LLAMA_LAYERS))
    for n, p in jm.named_parameters():
        p.set_value(paddle.to_tensor(arrays[n]))
    opt = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                     grad_clip=jnn.ClipGradByGlobalNorm(LLAMA_CLIP))
    losses = []
    for _ in range(STEPS):
        loss = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, _arrays(jm)


@pytest.fixture(scope="module")
def llama_case():
    paddle.seed(5)
    jm = JLlama(JConfig.tiny(num_hidden_layers=LLAMA_LAYERS))
    arrays = _arrays(jm)
    ids = np.random.RandomState(2).randint(
        0, 256, (LLAMA_B, LLAMA_S)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    return arrays, ids, labels, _llama_reference(arrays, ids, labels)


@pytest.mark.parametrize("V,recompute", [(1, 0), (2, 0), (1, 1)])
def test_llama_pipeline_matches_serial(llama_case, tmp_path, V, recompute):
    arrays, ids, labels, (losses, params) = llama_case
    ranks = R.run_ranks(
        P.pipeline_llama_body, 2, tmp_path,
        args=(V, 2, LLAMA_LAYERS, _pipe_arrays(arrays, 2, V, LLAMA_LAYERS),
              ids, labels, STEPS, LLAMA_CLIP, recompute))
    want = _pipe_arrays(params, 2, V, LLAMA_LAYERS)
    for s, r in enumerate(ranks):
        np.testing.assert_allclose(r["losses"], losses, rtol=TOL, atol=TOL)
        for n, a in r["params"].items():
            np.testing.assert_allclose(a, _stage_slice(n, want[n], s, V),
                                       rtol=TOL, atol=TOL, err_msg=n)
    # the clip saw every stage: one global norm on both ranks
    assert ranks[0]["norms"] == ranks[1]["norms"]
    assert "_pre.0.weight" in ranks[0]["params"]
    assert "_post.1.weight" in ranks[1]["params"]


def test_pipeline_beside_mp_sep_or_sharding_raises(tmp_path):
    ranks = R.run_ranks(P.routing_body, 4, tmp_path)
    for r in ranks:
        for other in ("mp", "sep", "sharding"):
            assert "ROADMAP A1" in r[other] and other in r[other], r[other]


def test_whole_pipeline_layer_runs_alone():
    """Built outside a pipeline topology, a ``PipelineLayer`` holds every
    stage and runs them in order."""
    pipe = P.block_pipe(4, 8, 3, 1)
    assert pipe._stage is None  # no topology here: every stage
    assert pipe(torch.zeros(2, 8)).shape == (2, 3)
