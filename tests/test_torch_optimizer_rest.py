"""Port parity: the rest of ``paddle_tpu_torch.optimizer`` against
``paddle_tpu.optimizer``.

- The nine optimizers the training slice left (``Adagrad``, ``Adadelta``,
  ``Adamax``, ``RMSProp``, ``Lamb``, ``NAdam``, ``RAdam``, ``Rprop``,
  ``ASGD``) with options off their defaults, and ``LBFGS`` (fixed step and
  strong-Wolfe line search) on a least-squares problem: 3 steps on the
  same f32 tensors and gradients, parameters at 1e-6 (LBFGS, whose
  iterations reduce in another order: 1e-5).
- ``L1Decay`` (optimizer-level, group-level and a parameter's own
  ``regularizer``) and a callable ``weight_decay`` in ``AdamW`` (its value
  per parameter; the reference raises a ``TypeError`` for a callable, a
  fault listed in ROADMAP C3, so the port is held against the reference
  run with the numbers the callable returns).
- ``interleave_updates``: each parameter updated during ``backward()`` as
  its gradient lands, against the serial step (bitwise, fused and
  unfused) and against the JAX package's interleaved step on a tiny Llama
  (1e-5); and the reference's refusals.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.optimizer.optimizer import L1Decay as JL1Decay
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.regularizer import L1Decay, L2Decay
from paddle_tpu_torch.utils import load_jax_params

SHAPES = [(8, 6), (6,), (5, 3)]

# the nine optimizers with options off their defaults
REST = {
    "Adagrad": dict(learning_rate=0.1, epsilon=1e-5,
                    initial_accumulator_value=0.1),
    "Adadelta": dict(learning_rate=0.5, epsilon=1e-5, rho=0.9),
    "Adamax": dict(learning_rate=0.05, beta1=0.8, beta2=0.99),
    "RMSProp": dict(learning_rate=0.01, rho=0.9, momentum=0.5, centered=True),
    "Lamb": dict(learning_rate=0.01, lamb_weight_decay=0.05,
                 exclude_from_weight_decay_fn=lambda p: p.ndim == 1),
    "NAdam": dict(learning_rate=0.01, momentum_decay=0.01),
    "RAdam": dict(learning_rate=0.01, beta2=0.9),
    "Rprop": dict(learning_rate=0.01, learning_rate_range=(1e-4, 0.02),
                  etas=(0.4, 1.3)),
    "ASGD": dict(learning_rate=0.05, batch_num=2, weight_decay=0.01),
}


def _params(seed=0):
    rng = np.random.RandomState(seed)
    vals = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    return ([jnn.Parameter(x) for x in vals],
            [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in vals])


def _steps(jo, to, jps, tps, steps=3):
    for step in range(steps):
        rng = np.random.RandomState(100 + step)
        for jp, tp, s in zip(jps, tps, SHAPES):
            g = (0.5 * rng.randn(*s)).astype(np.float32)
            jp.grad = paddle.to_tensor(g)
            tp.grad = torch.from_numpy(g)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()


def _assert_close(jps, tps, atol):
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(),
                                   np.asarray(jp._data.astype(jnp.float32)),
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("name", list(REST))
def test_optimizer_with_options_matches_reference(name):
    jps, tps = _params()
    kw = REST[name]
    if name == "Lamb":  # the exclusion function sees each side's tensor
        tkw = dict(kw, exclude_from_weight_decay_fn=lambda p: p.dim() == 1)
    else:
        tkw = kw
    jo = getattr(jopt, name)(parameters=jps, **kw)
    to = getattr(topt, name)(parameters=tps, **tkw)
    _steps(jo, to, jps, tps)
    _assert_close(jps, tps, 1e-6)
    for accum, store in jo._accumulators.items():
        for (_, ja), (_, ta) in zip(store.items(), to._accumulators[accum].items()):
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6,
                                       rtol=0, err_msg=accum)


def _lstsq(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(12, 5).astype(np.float32),
            rng.randn(12, 2).astype(np.float32))


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"],
                         ids=["fixed", "strong_wolfe"])
def test_lbfgs_matches_reference(line_search):
    a, b = _lstsq()
    jx = paddle.to_tensor(np.zeros((5, 2), np.float32), stop_gradient=False)
    tx = torch.nn.Parameter(torch.zeros(5, 2))
    kw = dict(learning_rate=0.5 if line_search is None else 1.0, max_iter=6,
              history_size=4, line_search_fn=line_search)
    jo = jopt.LBFGS(parameters=[jx], **kw)
    to = topt.LBFGS(parameters=[tx], **kw)
    ja, jb = paddle.to_tensor(a), paddle.to_tensor(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def jclosure():
        jo.clear_grad()
        r = ja @ jx - jb
        loss = (r * r).mean()
        loss.backward()
        return loss

    def tclosure():
        to.clear_grad()
        loss = ((ta @ tx - tb) ** 2).mean()
        loss.backward()
        return loss

    for _ in range(3):
        jl, tl = jo.step(jclosure), to.step(tclosure)
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.detach().numpy(), jx.numpy(), atol=1e-5, rtol=0)
    assert to._n_evals == jo._n_evals


@pytest.mark.parametrize("where", ["optimizer", "group", "param"])
def test_l1_decay_matches_reference(where):
    jps, tps = _params(1)
    if where == "optimizer":
        jo = jopt.Momentum(0.05, parameters=jps, weight_decay=JL1Decay(0.02))
        to = topt.Momentum(0.05, parameters=tps, weight_decay=L1Decay(0.02))
    elif where == "group":
        jo = jopt.SGD(0.05, parameters=[{"params": jps[:2],
                                         "weight_decay": JL1Decay(0.03)},
                                        {"params": jps[2:]}])
        to = topt.SGD(0.05, parameters=[{"params": tps[:2],
                                         "weight_decay": L1Decay(0.03)},
                                        {"params": tps[2:]}])
    else:  # a parameter's own regularizer wins over the optimizer's
        jps[0].regularizer = JL1Decay(0.04)
        tps[0].regularizer = L1Decay(0.04)
        jo = jopt.SGD(0.05, parameters=jps, weight_decay=0.01)
        to = topt.SGD(0.05, parameters=tps, weight_decay=L2Decay(0.01))
    _steps(jo, to, jps, tps)
    _assert_close(jps, tps, 1e-6)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_callable_weight_decay(fused):
    """A callable coefficient per parameter: the port against the reference
    run with the same coefficients as a float and a decay filter."""
    coeff = {2: 0.05, 1: 0.0}
    jps, tps = _params(2)
    names = (jps[0].name, jps[2].name)  # the 2-d parameters
    jo = jopt.AdamW(1e-2, parameters=jps, weight_decay=0.05,
                    apply_decay_param_fun=lambda n: n in names)
    to = topt.AdamW(1e-2, parameters=tps, fused=fused,
                    weight_decay=lambda p: coeff[p.dim()])
    with pytest.raises(TypeError):  # the reference's callable fault
        jbad = [jnn.Parameter(np.ones(3, np.float32))]
        jbad[0].grad = paddle.to_tensor(np.ones(3, np.float32))
        jopt.AdamW(1e-2, parameters=jbad, weight_decay=lambda p: 0.1).step()
    _steps(jo, to, jps, tps)
    _assert_close(jps, tps, 1e-6)


# -- interleaved updates -----------------------------------------------------
B, S = 2, 16


def _llama_pair():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tms = []
    for _ in range(2):
        tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        load_jax_params(tm, arrays)
        tms.append(tm)
    return jm, tms


def _batch(step):
    ids = np.random.RandomState(step).randint(0, 256, (B, S)).astype(np.int64)
    return ids, np.roll(ids, -1, axis=1)


def _torch_train(tm, opt, steps=3):
    losses = []
    for step in range(steps):
        ids, labels = (torch.from_numpy(x) for x in _batch(step))
        loss = tm.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_interleaved_updates_equal_the_serial_step(fused):
    _, (serial, inter) = _llama_pair()
    kw = dict(learning_rate=1e-3, weight_decay=0.1, fused=fused)
    so = topt.AdamW(parameters=serial.parameters(), **kw)
    io = topt.AdamW(parameters=inter.parameters(), interleave_updates=True, **kw)
    ids, labels = (torch.from_numpy(x) for x in _batch(0))
    loss = inter.loss(ids, labels)
    before = [p.detach().clone() for p in inter.parameters()]
    loss.backward()  # the updates land here, before step()
    assert all(p.grad is None for p in inter.parameters())
    assert not any(torch.equal(a, b) for a, b in zip(before, inter.parameters()))
    io.step()
    io.clear_grad()
    assert io._global_step == 1
    # the same three steps from the same state, serial against interleaved
    _, (s2, i2) = _llama_pair()
    so2 = topt.AdamW(parameters=s2.parameters(), **kw)
    io2 = topt.AdamW(parameters=i2.parameters(), interleave_updates=True, **kw)
    assert _torch_train(s2, so2) == _torch_train(i2, io2)
    for a, b in zip(s2.parameters(), i2.parameters()):
        assert torch.equal(a, b)
    for name, store in so2._accumulators.items():
        for k, v in store.items():
            assert torch.equal(v, io2._accumulators[name][k]), (name, k)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_interleaved_updates_match_the_jax_interleaved_step(fused):
    jm, (tm, _) = _llama_pair()
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    interleave_updates=True, fused=fused)
    to = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                    interleave_updates=True, fused=fused)
    jl = []
    for step in range(3):
        ids, labels = (paddle.to_tensor(x) for x in _batch(step))
        loss = jm.loss(ids, labels)
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss.numpy()))
    tl = _torch_train(tm, to)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    jparams = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[n], atol=1e-5,
                                   rtol=0, err_msg=n)


def test_interleave_refusals_match_the_reference():
    jps, tps = _params(3)
    for make, clip in ((jopt.AdamW, None), (topt.AdamW, tclip)):
        ps = jps if make is jopt.AdamW else tps
        with pytest.raises(ValueError, match="single param group"):
            make(parameters=[{"params": ps[:1]}, {"params": ps[1:]}],
                 interleave_updates=True)
        if clip is not None:
            with pytest.raises(ValueError, match="incompatible with grad_clip"):
                make(parameters=ps, interleave_updates=True,
                     grad_clip=clip.ClipGradByGlobalNorm(1.0))
    # a second backward before step(): gradient accumulation is refused
    _, (tm, _) = _llama_pair()
    opt = topt.AdamW(parameters=tm.parameters(), interleave_updates=True)
    ids, labels = (torch.from_numpy(x) for x in _batch(0))
    tm.loss(ids, labels).backward()
    with pytest.raises(RuntimeError, match="second backward"):
        tm.loss(ids, labels).backward()
    # a GradScaler refuses a non-fused interleaving optimizer before backward
    opt.step()
    scaler = tamp.GradScaler()
    with pytest.raises(ValueError, match="cannot drive an interleave_updates"):
        scaler.scale(tm.loss(ids, labels))
    # a new optimizer over the same parameters takes them over
    topt.AdamW(parameters=tm.parameters())
    tm.loss(ids, labels).backward()
    assert all(p.grad is not None for p in tm.parameters())
