"""Port parity: ``fleet.init(mp_degree=2)`` (and dp=2 x mp=2),
``distributed_model`` and ``distributed_optimizer`` around the Llama step
on ``LlamaConfig.tiny()`` in f32 (gloo ranks in processes, each holding its
shards) against the JAX package's ``TensorParallel`` step on its mesh, on
the same weights (the reference's full arrays, sliced into each rank by
``load_jax_params``) and the same global batch, with ``AdamW`` and
``ClipGradByGlobalNorm`` through ``distributed_optimizer``, 2 steps.

Held: each step's loss to 1e-5 (at dp=2 the mean of the dp ranks'); every
parameter, gathered over mp, to 1e-4 after the steps, and bitwise equal
across the dp peers; the clip's global norm equal on every rank. Also: the
port's ``tp_axis`` equals the reference's, parameter by parameter; a model
built at mp=2 from a seed holds the serial model's slices (and an mp layer
the slices of the one built at mp=1); the reference's whole arrays load
into the shards; a kv-head count mp does not divide raises.
``fleet.distributed_optimizer`` at sharding=2 (it wraps
``DygraphShardingOptimizer``: each rank on its half of the batch, stage 1
over the sharding group) against the reference's sharding optimizer on its
mesh: losses to 1e-5, parameters to 1e-4, the moments cut in half; group
sharding beside mp or dp raises. A step's collectives: one all-reduce each
way per attention and per MLP on the mp group, one bucket on the dp group.
"""
import numpy as np
import pytest

import jax

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

import torch_dist_ranks as R
import torch_tp_ranks as T

STEPS, B, S = 2, 4, 16
CLIP = 0.1  # below the global norm: the clip scales every gradient
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4


def _reference(dp, mp, arrays, ids, labels):
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    hcg = jfleet.init(strategy=strategy)
    paddle.seed(0)  # a fresh RNG key, not one placed on another mesh
    try:
        jm = JLlama(JConfig.tiny())
        for n, p in jm.named_parameters():
            p.set_value(paddle.to_tensor(arrays[n]))
        tp = jfleet.distributed_model(jm)
        opt = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                         grad_clip=jnn.ClipGradByGlobalNorm(CLIP))
        opt = jfleet.distributed_optimizer(opt)

        def step(x, y):
            loss = tp.loss(x, y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        compiled = paddle.jit.to_static(step, layers=[jm], optimizers=[opt])
        with hcg.mesh:
            losses = [float(compiled(paddle.to_tensor(ids),
                                     paddle.to_tensor(labels)).numpy())
                      for _ in range(STEPS)]
        params = {n: np.asarray(jax.device_get(p._data))
                  for n, p in jm.named_parameters()}
    finally:
        jdist.destroy_process_group()
        jfleet.set_hybrid_communicate_group(None)
    return losses, params


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    arrays = {n: np.asarray(p._data).copy() for n, p in jm.named_parameters()}
    ref_axes = {n: p.tp_axis for n, p in jm.named_parameters()}
    ids = np.random.RandomState(1).randint(0, 256, (B, S)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    tmp = tmp_path_factory.mktemp("tp")
    ranks = {(1, 2): R.run_ranks(T.tp_llama_body, 2, tmp,
                                 args=(1, arrays, ids, labels, STEPS, CLIP)),
             (2, 2): R.run_ranks(T.tp_llama_body, 4, tmp,
                                 args=(2, arrays, ids, labels, STEPS, CLIP))}
    ref = {k: _reference(*k, arrays, ids, labels) for k in ranks}
    ranks["sharding"] = R.run_ranks(T.sharding_opt_body, 2, tmp,
                                    args=(arrays, ids, labels, STEPS))
    ref["sharding"] = _sharding_reference(arrays, ids, labels)
    return arrays, ref_axes, ranks, ref


def _sharding_reference(arrays, ids, labels):
    from paddle_tpu.distributed.fleet.meta_optimizers import \
        DygraphShardingOptimizer

    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"sharding_degree": 2}
    hcg = jfleet.init(strategy=strategy)
    paddle.seed(0)
    try:
        jm = JLlama(JConfig.tiny())
        for n, p in jm.named_parameters():
            p.set_value(paddle.to_tensor(arrays[n]))
        opt = DygraphShardingOptimizer(
            jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters()), hcg)

        def step(x, y):
            loss = jm.loss(x, y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        compiled = paddle.jit.to_static(step, layers=[jm], optimizers=[opt])
        with hcg.mesh:
            losses = [float(compiled(paddle.to_tensor(ids),
                                     paddle.to_tensor(labels)).numpy())
                      for _ in range(STEPS)]
        params = {n: np.asarray(jax.device_get(p._data))
                  for n, p in jm.named_parameters()}
    finally:
        jdist.destroy_process_group()
        jfleet.set_hybrid_communicate_group(None)
    return losses, params


def test_sharding_optimizer_matches_the_reference(case):
    arrays, _, ranks, ref = case
    assert [r["inner"] for r in ranks["sharding"]] == \
        ["DygraphShardingOptimizer"] * 2
    got = np.mean([r["losses"] for r in ranks["sharding"]], axis=0)
    np.testing.assert_allclose(got, ref["sharding"][0], atol=LOSS_TOL, rtol=0)
    for n, want in ref["sharding"][1].items():
        for r in ranks["sharding"]:
            np.testing.assert_allclose(r["params"][n], want, atol=PARAM_TOL,
                                       rtol=0, err_msg=n)
    shapes = ranks["sharding"][0]["moment_shapes"]
    assert sum(int(np.prod(v)) for v in shapes.values()) * 2 == \
        sum(a.size for a in arrays.values())


@pytest.mark.parametrize("dims", [(1, 2), (2, 2)], ids=["mp2", "dp2xmp2"])
def test_losses_match_the_reference(case, dims):
    _, _, ranks, ref = case
    dp = dims[0]
    got = np.mean([ranks[dims][r]["losses"] for r in range(0, 2 * dp, 2)],
                  axis=0)
    np.testing.assert_allclose(got, ref[dims][0], atol=LOSS_TOL, rtol=0)
    # the mp peers of a dp rank compute one loss
    for r in range(0, 2 * dp, 2):
        assert ranks[dims][r]["losses"] == ranks[dims][r + 1]["losses"]


@pytest.mark.parametrize("dims", [(1, 2), (2, 2)], ids=["mp2", "dp2xmp2"])
def test_parameters_match_the_reference(case, dims):
    _, _, ranks, ref = case
    for n, want in ref[dims][1].items():
        for r, res in enumerate(ranks[dims]):
            np.testing.assert_allclose(res["params"][n], want, atol=PARAM_TOL,
                                       rtol=0, err_msg=f"rank {r} {n}")
            # dp peers (and mp peers, gathered) hold the same parameters
            np.testing.assert_array_equal(res["params"][n],
                                          ranks[dims][0]["params"][n])
    norms = [res["norms"] for res in ranks[dims]]
    assert all(nm == norms[0] for nm in norms), norms
    assert min(norms[0]) > CLIP, norms[0]


def test_shards_heads_and_logits(case):
    arrays, _, ranks, _ = case
    res = ranks[(1, 2)][0]
    assert res["heads"] == (2, 1)  # tiny: 4 heads, 2 kv heads, at mp=2
    assert res["logits_shape"] == (B, S, 128)  # the vocabulary's half
    for n, (axis, dist, shape) in res["tp_axis"].items():
        full = arrays[n].shape
        if axis is None:
            assert not dist and shape == full, n
        else:
            assert dist and shape[axis] * 2 == full[axis], n
    for dims in ((1, 2), (2, 2)):
        for r in ranks[dims]:
            assert r["loaded_equal"] and r["seed_slices_equal"]
            assert r["mp_layer_seed_equal"]


def test_tp_axis_metadata_matches_the_reference(case):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    _, ref_axes, _, _ = case
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    got = {n: (p.tp_axis, p.is_distributed) for n, p in model.named_parameters()}
    assert set(got) == set(ref_axes)
    for n, axis in ref_axes.items():
        assert got[n] == (axis, False), n


def test_kv_heads_mp_does_not_divide_raise():
    from paddle_tpu_torch.distributed.fleet.meta_parallel import TensorParallel
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    class TwoWay:  # an mp degree of 2 with no group: raises before any use
        def get_model_parallel_world_size(self):
            return 2

        def get_model_parallel_group(self):
            return None

    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=1),
                             device="cpu")
    with pytest.raises(ValueError, match=r"k_proj\.weight holds 1 units"):
        TensorParallel(model, TwoWay())
    assert model.llama.layers[0].self_attn.num_kv_heads == 1  # untouched


@pytest.mark.parametrize("other", ["mp_degree", "dp_degree"])
def test_sharding_beside_mp_or_dp_raises(other):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    degrees = {"sharding_degree": 2, other: 2}

    class Hcg:  # the degrees alone: raises before any group is used
        def get_sharding_parallel_world_size(self):
            return degrees.get("sharding_degree", 1)

        def get_model_parallel_world_size(self):
            return degrees.get("mp_degree", 1)

        def get_data_parallel_world_size(self):
            return degrees.get("dp_degree", 1)

        def get_pipe_parallel_world_size(self):
            return 1

    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    fleet.set_hybrid_communicate_group(Hcg())
    try:
        with pytest.raises(NotImplementedError, match="group sharding"):
            fleet.distributed_model(model)
        with pytest.raises(NotImplementedError, match="group sharding"):
            fleet.distributed_optimizer(
                AdamW(learning_rate=1e-3, parameters=model.parameters()))
    finally:
        fleet.set_hybrid_communicate_group(None)


@pytest.mark.parametrize("dims", [(1, 2), (2, 2)], ids=["mp2", "dp2xmp2"])
def test_one_all_reduce_each_way_per_block(case, dims):
    # per decoder layer: the o and down projections' all-reduces forward,
    # one copy of the attention's and the MLP's input backward; the head's
    # input copy, ParallelCrossEntropy's three (a max, two sums), the
    # clip's one; the
    # embedding's all-gather. dp: one bucket of the tiny model's gradients
    _, _, ranks, _ = case
    layers = JConfig.tiny().num_hidden_layers
    want = {"mp": {"all_reduce[sum]": 4 * layers + 1 + 2 + 1,
                   "all_reduce[max]": 1, "all_gather_into_tensor": 1}}
    if dims[0] > 1:
        want["dp"] = {"all_reduce[sum]": 1}
    for r in ranks[dims]:
        assert r["step_collectives"] == want
