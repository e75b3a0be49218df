"""Port parity: ring attention and ``SegmentParallel``.

``sep_parallel_attention`` over gloo ranks (each rank with the global q/k/v,
its block of the sequence through the ring, the output gathered) against
the reference's on its CPU mesh, at ring sizes 2 and 4, causal and not: the
output and the gradients of ``sum(out * c)`` for q, k and v (every rank
holds them whole), atol 2e-5 as ``tests/test_ring_attention.py``. Then
``fleet.init(sep_degree=2)`` and ``fleet.distributed_model`` (a
``SegmentParallel``) around the reference tests' attention block (qkv,
causal attention, o, residual) twice and a head, 3 SGD steps, against the
reference's serial net on plain attention: losses and parameters to 1e-4.
The single-rank ring is plain attention.
"""
from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.ops.ring_attention import ring_attention as j_ring_attention
from paddle_tpu.ops.ring_attention import \
    sep_parallel_attention as j_sep_attention
from paddle_tpu.utils.jax_compat import shard_map
from paddle_tpu.tensor import manipulation as JM

import torch_dist_ranks as R
import torch_pp_ranks as P
from paddle_tpu_torch.ops.ring_attention import (ring_attention,
                                                 sep_parallel_attention)

ATOL, TOL = 2e-5, 1e-4


def _qkvc(B=2, S=64, H=2, D=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def _reference(q, k, v, c, ring, causal):
    """The reference's ring on its mesh, as its ``sep_parallel_attention``
    runs it (``shard_map`` of ``ring_attention`` over the sequence), with
    its vjp, compiled once."""
    mesh = Mesh(np.array(jax.devices()[:ring]), ("sep",))
    spec = PartitionSpec(None, "sep", None, None)
    ring_fn = shard_map(partial(j_ring_attention, axis_name="sep",
                                causal=causal),
                        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)

    def run(q, k, v, c):
        out, vjp = jax.vjp(ring_fn, q, k, v)
        return (out, *vjp(c))

    return [np.asarray(a) for a in jax.jit(run)(q, k, v, c)]


def test_reference_entry_point_agrees():
    """The compiled form above is the reference's ``sep_parallel_attention``
    (its eager entry point, at one size)."""
    q, k, v, c = _qkvc(S=16, seed=9)
    mesh = Mesh(np.array(jax.devices()[:2]), ("sep",))
    out = j_sep_attention(*(paddle.to_tensor(a) for a in (q, k, v)), mesh,
                          causal=True)
    np.testing.assert_allclose(np.asarray(out.numpy()),
                               _reference(q, k, v, c, 2, True)[0], atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("ring", [2, 4])
def test_ring_matches_reference(tmp_path, ring, causal):
    q, k, v, c = _qkvc(seed=ring + 2 * causal)
    want = _reference(q, k, v, c, ring, causal)
    ranks = R.run_ranks(P.ring_body, ring, tmp_path,
                        args=(q, k, v, c, causal))
    for r in ranks:
        for name, w in zip(("out", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(r[name], w, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_one_rank_ring_is_plain_attention(causal):
    q, k, v, _ = _qkvc(seed=7)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = torch.nn.functional.scaled_dot_product_attention(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
        is_causal=causal).transpose(1, 2)
    for got in (ring_attention(tq, tk, tv, None, causal),
                sep_parallel_attention(tq, tk, tv, causal=causal)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# SegmentParallel

SEP_H, SEP_HEADS, SEP_C, SEP_B, SEP_S = 16, 2, 6, 4, 8
SEP_STEPS, SEP_LR = 3, 0.05


class JSepBlock(jnn.Layer):
    def __init__(self, h, heads):
        super().__init__()
        self.h, self.heads = h, heads
        self.qkv = jnn.Linear(h, 3 * h)
        self.o = jnn.Linear(h, h)

    def forward(self, x):
        b, s, hh = x.shape
        d = hh // self.heads
        qkv = JM.reshape(self.qkv(x), [b, s, 3, self.heads, d])
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = JF.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              training=False)
        return x + self.o(JM.reshape(out, [b, s, hh]))


class JSepNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.blocks = jnn.LayerList([JSepBlock(SEP_H, SEP_HEADS)
                                     for _ in range(2)])
        self.head = jnn.Linear(SEP_H, SEP_C)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return self.head(x)


def test_segment_parallel_matches_serial(tmp_path):
    paddle.seed(61)
    net = JSepNet()
    arrays = {n: np.asarray(p._data).copy() for n, p in net.named_parameters()}
    rng = np.random.RandomState(5)
    xs = rng.randn(SEP_STEPS, SEP_B, SEP_S, SEP_H).astype(np.float32)
    ys = rng.randint(0, SEP_C, (SEP_STEPS, SEP_B, SEP_S)).astype(np.int64)
    opt = jopt.SGD(learning_rate=SEP_LR, parameters=net.parameters())
    losses = []
    for x, y in zip(xs, ys):
        logits = net(paddle.to_tensor(x))
        loss = JF.cross_entropy(JM.reshape(logits, [-1, SEP_C]),
                                JM.reshape(paddle.to_tensor(y), [-1]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    params = {n: np.asarray(p._data) for n, p in net.named_parameters()}
    ranks = R.run_ranks(P.sep_body, 2, tmp_path,
                        args=(arrays, SEP_HEADS, xs, ys, SEP_LR))
    for r in ranks:
        assert r["wrapper"] == "SegmentParallel"
        np.testing.assert_allclose(r["losses"], losses, rtol=TOL, atol=TOL)
        for n, a in r["params"].items():
            np.testing.assert_allclose(a, params[n], rtol=TOL, atol=TOL,
                                       err_msg=n)
    # the parameters stay equal across the sep ranks with no reduction
    for n in ranks[0]["params"]:
        assert np.array_equal(ranks[0]["params"][n], ranks[1]["params"][n]), n
