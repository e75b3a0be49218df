"""Port parity: Mixture-of-Experts and expert parallelism.

``TopKGate`` against the reference's on the same weights (top-1, top-2, and
an overflowing capacity): the dispatch mask exactly, the combine weights and
the load-balance loss to 1e-6. ``MoELayer`` in both dispatch modes
(``"einsum"`` and ``"sort"``), with ample capacity and with overflow,
against the reference's same mode: the output, the aux loss and the
gradients of ``sum(out * c) + 0.1 * l_aux`` for the input, the gate and both
expert weights, to 1e-4. Expert parallelism at ep=2 (two gloo ranks,
``place_experts_on_mesh`` over the world group: 4 of 8 experts a rank)
against the reference's replicated layer, both modes: the output, the
input's gradient and every gradient (experts gathered whole) to 1e-4, and
``ClipGradForMOEByGlobalNorm(moe_group=...)``'s global norm against the
norm of the replicated gradients (without the group it sees only the
rank's experts). Without a group the MoE clip is the dense clip, bitwise.
The layer's entry points raise without CUDA unless given the CPU.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.meta_parallel.moe import MoELayer as JMoE
from paddle_tpu.distributed.fleet.meta_parallel.moe import TopKGate as JGate

import torch_dist_ranks as R
import torch_pp_ranks as P
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ClipGradForMOEByGlobalNorm, MoELayer, TopKGate)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.utils import load_jax_params

TOL, GATE_TOL = 1e-4, 1e-6
D, F, E = 16, 32, 8


def _arrays(layer):
    return {n: np.asarray(p._data).copy() for n, p in layer.named_parameters()}


@pytest.mark.parametrize("top_k,cf", [(1, 4.0), (2, 4.0), (2, 0.5)])
def test_gate_matches_reference(top_k, cf):
    paddle.seed(top_k)
    ref = JGate(D, E, top_k, cf)
    got = TopKGate(D, E, top_k, cf, device="cpu")
    load_jax_params(got, _arrays(ref))
    x = np.random.RandomState(0).randn(32, D).astype(np.float32)
    rd, rc, rl = ref(paddle.to_tensor(x))
    gd, gc, gl = got(torch.from_numpy(x))
    assert np.array_equal(gd.numpy(), np.asarray(rd._data))
    np.testing.assert_allclose(gc.detach().numpy(), np.asarray(rc._data),
                               atol=GATE_TOL)
    np.testing.assert_allclose(float(gl.detach()), float(rl), atol=GATE_TOL)


def _reference_moe(mode, cf, x, c, seed=4):
    paddle.seed(seed)
    ref = JMoE(D, F, E, top_k=2, capacity_factor=cf, dispatch_mode=mode)
    arrays = _arrays(ref)
    tx = paddle.to_tensor(x)
    tx.stop_gradient = False
    out = ref(tx)
    ((out * paddle.to_tensor(c)).sum() + 0.1 * ref.l_aux).backward()
    grads = {n: np.asarray(p.grad._data) for n, p in ref.named_parameters()}
    return arrays, np.asarray(out._data), float(ref.l_aux), \
        np.asarray(tx.grad._data), grads


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 16, D).astype(np.float32),
            rng.randn(2, 16, D).astype(np.float32))


@pytest.mark.parametrize("cf", [4.0, 1.25])
@pytest.mark.parametrize("mode", ["einsum", "sort"])
def test_moe_matches_reference(mode, cf):
    x, c = _inputs()
    arrays, out, l_aux, dx, grads = _reference_moe(mode, cf, x, c)
    moe = MoELayer(D, F, E, top_k=2, capacity_factor=cf, dispatch_mode=mode,
                   device="cpu")
    load_jax_params(moe, arrays)
    tx = torch.tensor(x, requires_grad=True)
    got = moe(tx)
    ((got * torch.from_numpy(c)).sum() + 0.1 * moe.l_aux).backward()
    np.testing.assert_allclose(got.detach().numpy(), out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(moe.l_aux), l_aux, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), dx, rtol=TOL, atol=TOL)
    for n, p in moe.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[n], rtol=TOL,
                                   atol=TOL, err_msg=n)


@pytest.mark.parametrize("mode", ["einsum", "sort"])
def test_expert_parallel_matches_replicated(tmp_path, mode):
    x, c = _inputs(2)
    arrays, out, l_aux, dx, grads = _reference_moe(mode, 4.0, x, c, seed=6)
    ranks = R.run_ranks(P.moe_ep_body, 2, tmp_path,
                        args=(arrays, x, c, mode, 1.0))
    dense = float(np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                              for g in grads.values())))
    for r in ranks:
        assert r["shapes"]["experts.w1"] == (E // 2, D, F)  # 4 of 8 experts
        assert r["shapes"]["experts.w2"] == (E // 2, F, D)
        np.testing.assert_allclose(r["out"], out, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["l_aux"], l_aux, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["dx"], dx, rtol=TOL, atol=TOL)
        for n, g in r["grads"].items():
            np.testing.assert_allclose(g, grads[n], rtol=TOL, atol=TOL,
                                       err_msg=n)
        np.testing.assert_allclose(r["moe_norm"], dense, rtol=TOL)
        assert r["no_group_norm"] < r["moe_norm"]
    assert ranks[0]["moe_norm"] == ranks[1]["moe_norm"]


def test_moe_clip_without_group_is_the_dense_clip():
    torch.manual_seed(0)
    moe = MoELayer(D, F, E, device="cpu")
    x = torch.randn(2, 8, D)
    (moe(x).square().sum() + moe.l_aux).backward()
    pg = [(p, p.grad.clone()) for p in moe.parameters()]
    for clip_norm in (0.1, 1e6):
        got = ClipGradForMOEByGlobalNorm(clip_norm)(pg)
        want = ClipGradByGlobalNorm(clip_norm)(pg)
        for (_, a), (_, b) in zip(got, want):
            assert torch.equal(a, b)


def test_moe_clip_beside_mp_or_pp_raises(tmp_path):
    """The MoE clip sums its squares over ``moe_group`` only: beside mp or
    pp, where the other shards' and stages' squares are missing,
    ``distributed_optimizer`` refuses it; beside dp it stays as it is."""
    for r in R.run_ranks(P.moe_clip_routing_body, 2, tmp_path):
        for axis in ("mp", "pp"):
            assert "ClipGradForMOEByGlobalNorm" in r[axis], r[axis]
            assert "ROADMAP A1" in r[axis], r[axis]
        assert r["dp"] == "ClipGradForMOEByGlobalNorm"


def test_entry_points_need_the_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for build in (lambda: MoELayer(D, F, E), lambda: TopKGate(D, E)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
