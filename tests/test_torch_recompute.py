"""Port parity: ``paddle_tpu_torch.distributed.fleet.utils.recompute``, the
counterparts of ``tests/test_recompute.py``, on the CPU.

Held: a recomputed net's loss and gradients equal a plain backward's
(bitwise in the port) and the reference's, on the same weights, to 1e-5;
recompute under ``jit.to_static`` (eager on the CPU) trains as the eager
step does; with dropout (the port's attention dropout, drawn from its
explicit generators) the rerun draws the first run's masks, so the
gradients equal a plain run's from the same seed, inside a tracker branch
too, and the streams end where a plain run leaves them; two recomputed
segments draw different masks; ``recompute_sequential`` in segments
equals the plain forward and trains every layer; keyword and several
arguments pass through; ``recompute_hybrid`` drops its ``ctx``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed.fleet.utils import recompute as jrecompute

from paddle_tpu_torch import jit, seed as pt_seed
from paddle_tpu_torch.base import random as R
from paddle_tpu_torch.distributed.fleet.utils import (recompute,
                                                      recompute_sequential)
from paddle_tpu_torch.distributed.fleet.utils.recompute import \
    recompute_hybrid
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils import load_jax_params

H = 32
KW = dict(device=torch.device("cpu"), dtype=torch.float32)


class Block(torch.nn.Module):
    def __init__(self, hidden=H):
        super().__init__()
        self.fc1 = Linear(hidden, hidden * 4, **KW)
        self.fc2 = Linear(hidden * 4, hidden, **KW)

    def forward(self, x):
        return self.fc2(torch.nn.functional.gelu(self.fc1(x)))


class Net(torch.nn.Module):
    def __init__(self, use_recompute):
        super().__init__()
        self.blocks = torch.nn.ModuleList([Block() for _ in range(3)])
        self.head = Linear(H, 4, **KW)
        self.use_recompute = use_recompute

    def forward(self, x):
        for b in self.blocks:
            x = recompute(b, x) if self.use_recompute else b(x)
        return self.head(x)


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.blocks = jnn.LayerList([jnn.Sequential(
            jnn.Linear(H, H * 4), jnn.GELU(), jnn.Linear(H * 4, H))
            for _ in range(3)])
        self.head = jnn.Linear(H, 4)

    def forward(self, x):
        for b in self.blocks:
            x = jrecompute(b, x)
        return self.head(x)


def _port_names(jname):
    # blocks.0.0.weight -> blocks.0.fc1.weight
    parts = jname.split(".")
    if parts[0] == "blocks":
        parts[2] = {"0": "fc1", "2": "fc2"}[parts[2]]
    return ".".join(parts)


@pytest.fixture(scope="module")
def ref():
    paddle.seed(11)
    jnet = JNet()
    arrays = {_port_names(n): np.asarray(p._data).copy()
              for n, p in jnet.named_parameters()}
    x = np.random.RandomState(0).randn(8, H).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 4, (8,)).astype(np.int64)
    loss = JF.cross_entropy(jnet(paddle.to_tensor(x)), paddle.to_tensor(y))
    loss.backward()
    grads = {_port_names(n): p.grad.numpy() for n, p in jnet.named_parameters()}
    return arrays, x, y, float(loss.numpy()), grads


def _port_run(arrays, x, y, use_recompute):
    net = Net(use_recompute)
    load_jax_params(net, arrays)
    loss = F.cross_entropy(net(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy()
                                  for n, p in net.named_parameters()}


def test_matches_plain_backward_and_the_reference(ref):
    arrays, x, y, ref_loss, ref_grads = ref
    l0, g0 = _port_run(arrays, x, y, False)
    l1, g1 = _port_run(arrays, x, y, True)
    assert l0 == l1 and g0.keys() == g1.keys() == ref_grads.keys()
    for k in g0:
        np.testing.assert_array_equal(g1[k], g0[k], err_msg=k)
        np.testing.assert_allclose(g1[k], ref_grads[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    assert abs(l1 - ref_loss) < 1e-5


def test_under_to_static_trains_as_eager(ref):
    arrays, x, y, _, _ = ref
    losses = []
    for static in (False, True):
        net = Net(True)
        load_jax_params(net, arrays)
        opt = AdamW(learning_rate=1e-2, parameters=net.parameters())

        def step(a, b):
            loss = F.cross_entropy(net(a), b)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        fn = jit.to_static(step, layers=[net], optimizers=[opt]) if static \
            else step
        losses.append([float(fn(torch.from_numpy(x), torch.from_numpy(y)))
                       for _ in range(6)])
    assert losses[1] == losses[0]
    assert losses[1][-1] < losses[1][0]


def _attn_dropout(w, x):
    """A segment that draws: attention dropout from the port's generator."""
    q = (x @ w).reshape(2, 16, 2, 8)
    out = F.scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                         training=True)
    return out.reshape(2, 16, 16)


@pytest.mark.parametrize("branch", [None, "local_seed"])
def test_rerun_draws_the_first_runs_masks(branch):
    rng = np.random.RandomState(3)
    w0 = rng.randn(16, 16).astype(np.float32)
    x = torch.from_numpy(rng.randn(2, 16, 16).astype(np.float32))
    results = []
    for use in (False, True):
        pt_seed(7)
        R.model_parallel_random_seed(7, tp_rank=1)
        w = torch.tensor(w0, requires_grad=True)

        def run():
            if use:
                return recompute(_attn_dropout, w, x)
            return _attn_dropout(w, x)

        if branch is None:
            out = run()
        else:
            with R.get_rng_state_tracker().rng_state(branch):
                out = run()
        (out * out).sum().backward()
        after = R.get_generator("cpu").get_state()
        tracker = R.get_rng_state_tracker().get_states_dict()
        results.append((out.detach(), w.grad, after, tracker))
    (o0, g0, s0, t0), (o1, g1, s1, t1) = results
    assert torch.equal(o0, o1)
    assert torch.equal(g0, g1)  # the rerun's masks are the first run's
    assert torch.equal(s0, s1)  # the streams end where a plain run leaves them
    for k in t0:
        for dev in t0[k]["devices"]:
            assert torch.equal(t0[k]["devices"][dev], t1[k]["devices"][dev])


def test_two_segments_not_correlated():
    pt_seed(5)
    x = torch.ones(2, 16, 16)
    w = torch.eye(16, requires_grad=True)
    a = recompute(_attn_dropout, w, x)
    b = recompute(_attn_dropout, w, x)
    assert not torch.equal(a, b)
    (a.sum() + b.sum()).backward()
    assert w.grad is not None


def test_recompute_sequential_and_hybrid():
    pt_seed(11)
    seq = torch.nn.Sequential(*[Block() for _ in range(4)])
    x = torch.from_numpy(np.random.RandomState(0).randn(4, H).astype(np.float32))
    plain = seq(x)
    out = recompute_sequential({"segments": 2}, seq, x)
    assert torch.equal(out, plain)
    out.sum().backward()
    assert all(p.grad is not None for p in seq.parameters())
    hybrid = recompute_hybrid({"mp_group": None, "offload": False}, seq, x)
    assert torch.equal(hybrid, plain)


def test_kwargs_and_several_arguments():
    class TwoIn(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = Linear(8, 8, **KW)

        def forward(self, a, b, scale=1.0):
            return self.fc(a) * scale + b

    pt_seed(0)
    m = TwoIn()
    rng = np.random.RandomState(0)
    a = torch.tensor(rng.randn(2, 8).astype(np.float32), requires_grad=True)
    b = torch.from_numpy(rng.randn(2, 8).astype(np.float32))
    out = recompute(m, a, b, scale=2.0)
    assert torch.equal(out, m(a, b, scale=2.0))
    out.sum().backward()
    assert a.grad is not None and m.fc.weight.grad is not None
