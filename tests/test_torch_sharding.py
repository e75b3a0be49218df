"""Port parity: group-sharded stages 1-3
(``paddle_tpu_torch.distributed.group_sharded_parallel``, two gloo ranks in
processes) against the JAX package's ``group_sharded_parallel`` on a
``("sharding", 2)`` mesh (``tests/test_sharding_and_io.py`` is the
reference's own test), on ``LlamaConfig.tiny()`` in f32 with the reference
model's weights in every rank and the same global batch.

Held, per level (``os``, ``os_g``, ``p_g_os``): each step's global loss
(the mean of the ranks' losses) to 1e-5 and every gathered parameter after
two steps to 1e-4 against the reference; the port's parameters bitwise
equal to its own ``DataParallel`` step's (averaging is the same sum and
division); the moments each rank keeps are its shard (and, at stage 3, the
parameters too). The port's placement rule equals the reference's
``_shard_spec`` on the flagship's (Llama-542M's) 75 shapes, on the tiny
model's, and on shapes that only a later dimension divides or none does.
"""
import os

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import sharding as jsharding
from paddle_tpu.distributed.collective import Group as JGroup
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.tensor import manipulation as M
from paddle_tpu_torch.distributed import sharding as tsharding

import torch_dist_ranks as R

WORLD, STEPS = 2, 2
B, S = 4, 16
LEVELS = ("os", "os_g", "p_g_os")
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4


def _weights():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    return {n: np.asarray(p._data).copy() for n, p in jm.named_parameters()}


def _batch():
    ids = np.random.RandomState(2).randint(0, 256, (B, S)).astype(np.int64)
    return ids, np.roll(ids, -1, axis=1)


def _reference(level, arrays, ids, labels):
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    for n, p in jm.named_parameters():
        p.set_value(paddle.to_tensor(arrays[n]))
    opt = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sharding",))
    group = JGroup(list(range(WORLD)), "sharding", mesh=mesh)
    jm, opt, _ = jsharding.group_sharded_parallel(jm, opt, level, group=group)

    def step(x, y):
        logits = jm(x)
        b, s, v = logits.shape
        loss = JF.cross_entropy(M.reshape(logits, [b * s, v]),
                                M.reshape(y, [b * s]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    compiled = paddle.jit.to_static(step, layers=[jm], optimizers=[opt])
    losses = [float(compiled(paddle.to_tensor(ids),
                             paddle.to_tensor(labels)).numpy())
              for _ in range(STEPS)]
    return losses, {n: np.asarray(p._data) for n, p in jm.named_parameters()}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    arrays = _weights()
    ids, labels = _batch()
    return arrays, R.run_ranks(R.shard_body, WORLD,
                               tmp_path_factory.mktemp("shard"),
                               args=(arrays, ids, labels, STEPS, LEVELS))


@pytest.mark.parametrize("level", LEVELS)
def test_stage_matches_the_reference(port, level):
    arrays, ranks = port
    ids, labels = _batch()
    ref_losses, ref_params = _reference(level, arrays, ids, labels)
    got = np.mean([r[level]["losses"] for r in ranks], axis=0)
    np.testing.assert_allclose(got, ref_losses, atol=LOSS_TOL, rtol=0)
    for n, want in ref_params.items():
        for r in ranks:
            np.testing.assert_allclose(r[level]["params"][n], want,
                                       atol=PARAM_TOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("level", LEVELS)
def test_stage_is_bitwise_the_data_parallel_step(port, level):
    _, ranks = port
    for r in ranks:
        assert r[level]["losses"] == r["dp"]["losses"]
        for n, want in r["dp"]["params"].items():
            np.testing.assert_array_equal(r[level]["params"][n], want,
                                          err_msg=n)


@pytest.mark.parametrize("level", LEVELS)
def test_each_rank_keeps_its_shards(port, level):
    arrays, ranks = port
    for r in ranks:
        dp, st = r["dp"], r[level]
        for key, shape in st["moment_shapes"].items():
            whole = dp["moment_shapes"][key]
            # the tiny model's every dimension 0 is even: all are cut there
            assert shape == (whole[0] // WORLD, *whole[1:]), key
        for n, shape in st["param_shapes"].items():
            whole = arrays[n].shape
            want = ((whole[0] // WORLD, *whole[1:]) if level == "p_g_os"
                    else whole)
            assert shape == tuple(want), n


def _flagship_shapes():
    import importlib.util
    import sys

    name = "_sharding_chip_smoke"
    cs = sys.modules.get(name)
    if cs is None:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(repo, "chip_smoke.py"))
        cs = importlib.util.module_from_spec(spec)
        sys.modules[name] = cs
        spec.loader.exec_module(cs)
    return cs.flagship_shapes()


def test_placement_rule_equals_the_references():
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sharding",))
    shapes = [*_flagship_shapes(), *(a.shape for a in _weights().values()),
              (3, 4), (5, 7), (1,), (), (7, 6, 4)]
    dims = set()
    for shape in shapes:
        want = tuple(jsharding._shard_spec(shape, mesh, "sharding"))
        got = tsharding._shard_spec(shape, WORLD, "sharding")
        assert got == want, shape
        if "sharding" in got:
            dims.add(got.index("sharding"))
    # the flagship shards every tensor along dimension 0
    assert all(tsharding._shard_spec(s, WORLD)[0] == "sharding"
               for s in _flagship_shapes())
    assert dims == {0, 1}


def test_offload_and_clipping_are_refused():
    import torch

    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    model = torch.nn.Linear(4, 4)
    opt = AdamW(parameters=model.parameters())
    with pytest.raises(NotImplementedError, match="offload"):
        tsharding.group_sharded_parallel(model, opt, "os", offload=True)
    with pytest.raises(ValueError, match="level"):
        tsharding.group_sharded_parallel(model, opt, "zero4")
    clipped = AdamW(parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
    with pytest.raises(NotImplementedError, match="clipping"):
        tsharding.group_sharded_parallel(model, clipped, "os")


def test_a_shard_with_its_base_draws_the_whole_tensors_rounding_bits():
    """The fused AdamW's SR writeback hashes each element's flat index; a
    dimension-0 shard updated with ``sr_base`` = its offset rounds every
    element as the whole tensor's update does (the kernel takes the same
    base per table entry; the plain version is what runs here)."""
    import torch

    from paddle_tpu_torch.ops.fused_adamw import (
        adamw_scalars_multi, fused_adamw_multi_update)

    gen = torch.Generator().manual_seed(4)
    shape = (6, 40)
    p = torch.randn(shape, generator=gen).to(torch.bfloat16)
    g = torch.randn(shape, generator=gen).to(torch.bfloat16)
    m = (torch.randn(shape, generator=gen) * 0.1).to(torch.bfloat16)
    v = (torch.rand(shape, generator=gen) * 0.1).to(torch.bfloat16)
    salts = torch.tensor([[123456789, 987654321]], dtype=torch.int64)
    one = torch.ones(1)

    def run(ps, gs, ms, vs, bases):
        t = len(ps)
        sc = adamw_scalars_multi(lr=1e-2, epsilon=1e-8, beta1_pow=one.repeat(t) * 0.9,
                                 beta2_pow=one.repeat(t) * 0.999,
                                 weight_decay=[0.01] * t)
        fused_adamw_multi_update(ps, gs, ms, vs, scalars=sc, beta1=0.9,
                                 beta2=0.999, sr_salts=salts.repeat(t, 1),
                                 sr_base=bases)

    whole = [t.clone() for t in (p, g, m, v)]
    run(*([x] for x in whole), None)
    half = shape[0] // 2 * shape[1]
    for r in (0, 1):
        part = [t.clone().chunk(2, 0)[r].contiguous() for t in (p, g, m, v)]
        run(*([x] for x in part), [r * half])
        assert torch.equal(part[0], whole[0].chunk(2, 0)[r])
        if r == 1:  # without the base the shard draws other bits
            plain = [t.clone().chunk(2, 0)[r].contiguous() for t in (p, g, m, v)]
            run(*([x] for x in plain), None)
            assert not torch.equal(plain[0], whole[0].chunk(2, 0)[r])
