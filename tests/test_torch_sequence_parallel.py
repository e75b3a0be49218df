"""Port parity: sequence parallelism of ``paddle_tpu_torch.distributed.
fleet.utils.sequence_parallel_utils`` (two gloo ranks in processes, each
holding its share of the sequence) against the JAX package's on its mesh
(the pattern of ``tests/test_hybrid_parallel.py:152-174``), in f32 on
``[s, b, h]`` activations.

Held, to 1e-5: the four ops (``ScatterOp``, ``GatherOp``, ``AllGatherOp``,
``ReduceScatterOp``) forward and backward: each rank's part of the
reference's result and gradient (``ReduceScatterOp`` on per-rank partial
sums, whose reduction the reference's input stands for);
``ColumnSequenceParallelLinear`` then ``RowSequenceParallelLinear`` between
``ScatterOp`` and ``GatherOp``: the output, the input's gradient and the
gathered weight gradients. The row layer's bias, applied on the sequence
shard, is marked sequence-parallel: without the hooks each rank holds its
part of its gradient (the parts sum to the reference's); with
``register_sequence_parallel_allreduce_hooks`` every rank holds the
reference's, bitwise equal across ranks.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet.utils.sequence_parallel_utils import (
    AllGatherOp, ColumnSequenceParallelLinear, GatherOp, ReduceScatterOp,
    RowSequenceParallelLinear, ScatterOp)

import torch_dist_ranks as R
import torch_tp_ranks as T

WORLD, TOL = 2, 1e-5
S, BATCH, H = 8, 2, 16


def _t(a, grad=False):
    t = paddle.to_tensor(np.asarray(a))
    t.stop_gradient = not grad
    return t


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.RandomState(2)
    case = {"x": rng.randn(S, BATCH, H).astype(np.float32),
            "c": rng.randn(S, BATCH, H).astype(np.float32)}
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": WORLD}
    jfleet.init(strategy=strategy)
    ref = {}
    try:
        for name, op in (("scatter", ScatterOp), ("gather", GatherOp),
                         ("all_gather", AllGatherOp),
                         ("reduce_scatter", ReduceScatterOp)):
            x = _t(case["x"], True)
            y = op.apply(x)
            (y * _t(case["c"])).sum().backward()
            ref[name] = (y.numpy(), x.grad.numpy())
        paddle.seed(8)
        col = ColumnSequenceParallelLinear(16, 32, has_bias=True,
                                           gather_output=False)
        row = RowSequenceParallelLinear(32, 16, input_is_parallel=True)
        case["col"] = {n: np.asarray(p._data).copy()
                       for n, p in col.named_parameters()}
        case["row"] = {n: np.asarray(p._data).copy()
                       for n, p in row.named_parameters()}
        x = _t(case["x"], True)
        y = GatherOp.apply(row(col(ScatterOp.apply(x))))
        (y * _t(case["c"])).sum().backward()
        ref["linears"] = {"y": y.numpy(), "dx": x.grad.numpy(),
                          **{f"col.{n}": p.grad.numpy()
                             for n, p in col.named_parameters()},
                          **{f"row.{n}": p.grad.numpy()
                             for n, p in row.named_parameters()}}
    finally:
        jdist.destroy_process_group()
        jfleet.set_hybrid_communicate_group(None)
    ranks = R.run_ranks(T.sp_body, WORLD, tmp_path_factory.mktemp("sp"),
                        args=(case,))
    return ranks, ref


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=what)


def test_the_four_ops_match_the_reference(case):
    ranks, ref = case
    s = S // WORLD
    for r, res in enumerate(ranks):
        mine = slice(r * s, (r + 1) * s)
        y, dx = ref["scatter"]
        _close(res["scatter"][0], y[mine], f"rank {r} scatter")
        _close(res["scatter"][1], dx, f"rank {r} scatter grad (all-gathered)")
        _close(res["scatter_fn"], y[mine], f"rank {r} scatter()")
        y, dx = ref["gather"]
        _close(res["gather"][0], y, f"rank {r} gather")
        _close(res["gather"][1], dx[mine], f"rank {r} gather grad (split)")
        # all-gather: backward reduce-scatters the ranks' equal cotangents
        y, dx = ref["all_gather"]
        _close(res["all_gather"][0], y, f"rank {r} all_gather")
        _close(res["all_gather"][1], WORLD * dx[mine],
               f"rank {r} all_gather grad (reduce-scattered)")
        # reduce-scatter of partial sums x * (rank + 1): their sum is 3 x
        y, dx = ref["reduce_scatter"]
        _close(res["reduce_scatter"][0], 3 * y[mine], f"rank {r} reduce_scatter")
        _close(res["reduce_scatter"][1], dx,
               f"rank {r} reduce_scatter grad (all-gathered)")


def test_linears_match_the_reference(case):
    ranks, ref = case
    for r, res in enumerate(ranks):
        got = res["linears_hooks1"]
        for k in ("y", "dx", "col.weight", "col.bias", "row.weight",
                  "row.bias"):
            _close(got[k], ref["linears"][k], f"rank {r} {k}")
        assert got["n_hooks"] == 1 and got["sp_marked"]


def test_hooks_make_sequence_parallel_gradients_whole(case):
    ranks, ref = case
    want = ref["linears"]["row.bias"]
    parts = [res["linears_hooks0"]["row.bias"] for res in ranks]
    # without the hooks: each rank's sequence share, summing to the whole
    assert not np.allclose(parts[0], want, atol=TOL)
    _close(parts[0] + parts[1], want, "the parts' sum")
    assert ranks[0]["linears_hooks0"]["n_hooks"] == 0
    # with them: the whole gradient, bitwise equal on both ranks
    np.testing.assert_array_equal(ranks[0]["linears_hooks1"]["row.bias"],
                                  ranks[1]["linears_hooks1"]["row.bias"])
