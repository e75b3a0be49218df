"""Port parity: the tensor-parallel layers of ``paddle_tpu_torch.distributed.
fleet`` (gloo ranks in processes, each holding its shard) against the JAX
package's on its ``mp_env`` mesh (dp=2, mp=4 over conftest's 8 CPU devices,
the pattern of ``tests/test_hybrid_parallel.py``), on the same weights: the
reference's full arrays, carried into each rank's shard by
``load_jax_params``.

Held, in f32: ``ColumnParallelLinear`` then ``RowParallelLinear`` (sharded
between them), the column layer gathering its output and the row layer
slicing its input, at mp=2 and mp=4: outputs, input gradients and the
gathered weight gradients to 1e-5. At mp=2 also ``VocabParallelEmbedding``
(output, gathered weight gradient) and ``ParallelCrossEntropy`` over
vocab-sharded logits with an ignored label (per-token loss and the
gathered logits' gradient) to 1e-5; the reference's
``test_tp_training_matches_serial`` (a TP MLP, SGD, 3 steps), losses to
2e-5; and ``split``, whose layer, rebuilt from the same seed, gives its
output.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet.meta_parallel import (
    ColumnParallelLinear as JCol,
    ParallelCrossEntropy as JPce,
    RowParallelLinear as JRow,
    VocabParallelEmbedding as JEmb,
)

import torch_dist_ranks as R
import torch_tp_ranks as T

TOL, MLP_TOL = 1e-5, 2e-5


def _arrays(layer):
    return {n: np.asarray(p._data).copy() for n, p in layer.named_parameters()}


def _grads(layer):
    return {n: np.asarray(p.grad.numpy()) for n, p in layer.named_parameters()}


def _t(a, grad=False):
    t = paddle.to_tensor(np.asarray(a))
    t.stop_gradient = not grad
    return t


@pytest.fixture(scope="module")
def ref():
    """The reference's layers on its mp_env mesh; returns the case (inputs
    and full weights) and the reference's results."""
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 4}
    jfleet.init(strategy=strategy)
    try:
        rng = np.random.RandomState(0)
        case = {"x": rng.randn(4, 16).astype(np.float32),
                "xr": rng.randn(4, 32).astype(np.float32),
                "cy": rng.randn(4, 8).astype(np.float32),
                "ch": rng.randn(4, 32).astype(np.float32),
                "ids": np.array([[1, 5, 31, 16], [0, 15, 17, 7]], np.int64),
                "cemb": rng.randn(2, 4, 16).astype(np.float32),
                "logits": rng.randn(6, 32).astype(np.float32),
                "labels": np.array([0, 3, 31, -100, 16, 9], np.int64),
                "closs": rng.randn(6).astype(np.float32)}
        out = {}
        paddle.seed(3)
        col = JCol(16, 32, has_bias=True, gather_output=False)
        row = JRow(32, 8, input_is_parallel=True)
        case["pair"] = {"col": _arrays(col), "row": _arrays(row)}
        x = _t(case["x"], True)
        y = row(col(x))
        (y * _t(case["cy"])).sum().backward()
        g = {**{f"col.{k}": v for k, v in _grads(col).items()},
             **{f"row.{k}": v for k, v in _grads(row).items()}}
        out["pair"] = {"y": y.numpy(), "dx": x.grad.numpy(), **g}
        # the serial maths of the two single layers, on the same weights
        colg = JCol(16, 32, has_bias=True, gather_output=True)
        colg.weight.set_value(col.weight)
        colg.bias.set_value(col.bias)
        x = _t(case["x"], True)
        h = colg(x)
        (h * _t(case["ch"])).sum().backward()
        out["col_gather"] = {"y": h.numpy(), "dx": x.grad.numpy()}
        rows = JRow(32, 8, input_is_parallel=False)
        rows.weight.set_value(row.weight)
        rows.bias.set_value(row.bias)
        xr = _t(case["xr"], True)
        y = rows(xr)
        (y * _t(case["cy"])).sum().backward()
        out["row_split"] = {"y": y.numpy(), "dx": xr.grad.numpy()}

        paddle.seed(4)
        emb = JEmb(32, 16)
        case["emb"] = _arrays(emb)
        e = emb(_t(case["ids"]))
        (e * _t(case["cemb"])).sum().backward()
        out["emb"] = {"y": e.numpy(), "dw": emb.weight.grad.numpy()}

        logits = _t(case["logits"], True)
        loss = JPce()(logits, _t(case["labels"]))
        (loss * _t(case["closs"])).sum().backward()
        out["pce"] = {"loss": loss.numpy(), "dlogits": logits.grad.numpy()}

        class TPNet(paddle.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = JCol(16, 32, has_bias=True, gather_output=False)
                self.fc2 = JRow(32, 4, input_is_parallel=True)

            def forward(self, x):
                return self.fc2(JF.relu(self.fc1(x)))

        paddle.seed(6)
        net = TPNet()
        case["mlp"] = _arrays(net)
        rng = np.random.RandomState(0)
        case["mlp_x"] = rng.randn(3, 8, 16).astype(np.float32)
        case["mlp_y"] = rng.randint(0, 4, (3, 8)).astype(np.int64)
        model = jfleet.distributed_model(net)
        opt = jopt.SGD(learning_rate=0.1, parameters=net.parameters())
        losses = []
        for xs, ys in zip(case["mlp_x"], case["mlp_y"]):
            loss = JF.cross_entropy(model(_t(xs)), _t(ys))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        out["mlp_losses"] = losses
        out["split_shapes"] = {
            "col": tuple(jdist.split(_t(case["x"]), (16, 32), "linear",
                                     axis=1).shape),
            "row": tuple(jdist.split(_t(case["x"]), (16, 8), "linear",
                                     axis=0).shape),
            "emb": tuple(jdist.split(_t(case["ids"]), (32, 16),
                                     "embedding").shape)}
    finally:
        jdist.destroy_process_group()
        jfleet.set_hybrid_communicate_group(None)
    return case, out


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    case, _ = ref
    tmp = tmp_path_factory.mktemp("mp")
    return {2: R.run_ranks(T.mp_linears_body, 2, tmp, args=(case, True)),
            4: R.run_ranks(T.mp_linears_body, 4, tmp, args=(case, False))}


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("part", ["pair", "col_gather", "row_split"])
def test_linears_match_the_reference(ref, ranks, mp, part):
    _, want = ref
    for r, res in enumerate(ranks[mp]):
        for k, v in want[part].items():
            _close(res[part][k], v, TOL, f"mp={mp} rank {r} {part} {k}")


def test_linear_shards_and_metadata(ranks):
    for mp, rs in ranks.items():
        for res in rs:
            assert res["pair"]["shapes"] == ((16, 32 // mp), (32 // mp, 8))
            # column weight and bias, row weight sharded; row bias replicated
            assert res["pair"]["meta"] == [(1, True), (0, True), (0, True),
                                           (None, False)]


@pytest.mark.parametrize("part", ["emb", "pce"])
def test_embedding_and_cross_entropy_match(ref, ranks, part):
    _, want = ref
    for r, res in enumerate(ranks[2]):
        for k, v in want[part].items():
            _close(res[part][k], v, TOL, f"rank {r} {part} {k}")
    if part == "pce":  # the ignored label: no loss, no gradient
        assert ranks[2][0]["pce"]["loss"][3] == 0.0
        assert not ranks[2][0]["pce"]["dlogits"][3].any()


def test_tp_mlp_training_matches_the_reference(ref, ranks):
    _, want = ref
    for res in ranks[2]:
        _close(res["mlp_losses"], want["mlp_losses"], MLP_TOL, "losses")


def test_split(ref, ranks):
    _, want = ref
    for res in ranks[2]:
        for kind, got in res["split"].items():
            assert got.shape == want["split_shapes"][kind], kind
            _close(got, res["split_want"][kind], TOL, kind)
