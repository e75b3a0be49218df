"""Port parity: ``paddle_tpu_torch.distributed.DataParallel`` (two gloo
ranks in processes) against the JAX package's GSPMD data-parallel step
over a ``("dp", 2)`` mesh (the pattern of ``__graft_entry__.py:170-240``),
on ``LlamaConfig.tiny()`` in f32 with the reference model's weights carried
into every rank (``load_jax_params``) and the same global batch.

Each port rank trains on its half of the batch; the global loss is the
mean of the two ranks' losses. Held: each step's global loss to 1e-5 and
every parameter after two steps to 1e-4; the two ranks' parameters
bitwise equal; ``no_sync`` keeps the first micro-batch's gradients local
and the next backward averages the sums; under gloo a ``to_static``
capture of the step is a ``GraphBreakError`` (``full_graph=True``), or,
with ``full_graph=False``, an eager run that says so (the split finds no
safe cut: the loss carries its graph into the backward).
"""
import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.tensor import manipulation as M

import torch_dist_ranks as R

WORLD, STEPS = 2, 2
B, S = 4, 16  # the global batch
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    arrays = {n: np.asarray(p._data).copy() for n, p in jm.named_parameters()}
    ids = np.random.RandomState(1).randint(0, 256, (B, S)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    ranks = R.run_ranks(R.dp_body, WORLD, tmp_path_factory.mktemp("dp"),
                        args=(arrays, ids, labels, STEPS))
    # the reference: GSPMD over a ("dp", 2) mesh, the whole batch at once
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    dp = jdist.DataParallel(jm, mesh=mesh, dp_axis="dp")
    opt = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())

    def step(x, y):
        logits = dp(x)
        b, s, v = logits.shape
        loss = JF.cross_entropy(M.reshape(logits, [b * s, v]),
                                M.reshape(y, [b * s]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    compiled = paddle.jit.to_static(step, layers=[jm], optimizers=[opt])
    with mesh:
        ref_losses = [float(compiled(paddle.to_tensor(ids),
                                     paddle.to_tensor(labels)).numpy())
                      for _ in range(STEPS)]
    ref_params = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return ranks, ref_losses, ref_params


def test_losses_match_the_gspmd_step(case):
    ranks, ref_losses, _ = case
    port = np.mean([r["losses"] for r in ranks], axis=0)
    np.testing.assert_allclose(port, ref_losses, atol=LOSS_TOL, rtol=0)


def test_parameters_match_the_gspmd_step_and_each_other(case):
    ranks, _, ref_params = case
    for n, want in ref_params.items():
        np.testing.assert_array_equal(ranks[0]["params"][n],
                                      ranks[1]["params"][n], err_msg=n)
        np.testing.assert_allclose(ranks[0]["params"][n], want,
                                   atol=PARAM_TOL, rtol=0, err_msg=n)
    # small buckets: the gradients went over in more than one
    assert ranks[0]["buckets"] > 1 and ranks[0]["syncs"] == STEPS


def test_no_sync_accumulates_locally_then_averages(case):
    ranks, _, _ = case
    names = list(ranks[0]["nosync_local"])
    # inside no_sync each rank kept its own gradients
    assert any(not np.array_equal(ranks[0]["nosync_local"][n],
                                  ranks[1]["nosync_local"][n]) for n in names)
    for r in ranks:
        for n in names:
            np.testing.assert_allclose(r["nosync_synced"][n],
                                       r["nosync_expect"][n], atol=1e-6,
                                       rtol=0, err_msg=n)


def test_to_static_under_gloo_is_a_graph_break(case):
    ranks, ref_losses, _ = case
    for r in ranks:
        assert r["full_graph"].startswith("GraphBreakError"), r["full_graph"]
        assert "gloo backend is a host operation" in r["full_graph"]
        # full_graph=False: no safe split (the loss carries its graph into
        # the backward), so the step runs eagerly with a warning, never
        # silently, and trains as the eager step does
        assert any("graph break" in w and "gloo" in w
                   for w in r["piecewise_warnings"]), r["piecewise_warnings"]
    port = np.mean([r["piecewise_losses"][:STEPS] for r in ranks], axis=0)
    np.testing.assert_allclose(port, ref_losses, atol=LOSS_TOL, rtol=0)
