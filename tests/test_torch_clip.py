"""Port parity: ``paddle_tpu_torch.nn.clip`` against ``paddle_tpu.nn.clip``.

- ``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm`` on
  the same (param, grad) lists, a ``need_clip = False`` parameter among
  them, with grads both above and below the clip: each clipped gradient at
  1e-6 (f32; the global norm sums per-tensor squares in the reference's
  order).
- ``clip_grad_norm_`` (2-norm and inf-norm) and ``clip_grad_value_`` in
  place on ``.grad``: the returned norm and each gradient at 1e-6. The
  port keeps the norm on the device (no host branch), so the case where
  no clipping happens must leave every gradient's bits as they were.
- ``grad_clip`` in an optimizer and in a param group, over 3 AdamW steps
  against ``paddle_tpu.optimizer.AdamW``: parameters at 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import clip as tclip

SHAPES = [(6, 5), (7,), (3, 4)]
ATOL = 1e-6


def _arrays(scale, seed=0):
    rng = np.random.RandomState(seed)
    ps = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [(scale * rng.randn(*s)).astype(np.float32) for s in SHAPES]
    return ps, gs


def _pairs(scale, seed=0):
    ps, gs = _arrays(scale, seed)
    jpg, tpg = [], []
    for i, (p, g) in enumerate(zip(ps, gs)):
        jp, tp = jnn.Parameter(p), torch.nn.Parameter(torch.from_numpy(p))
        if i == 1:  # a parameter whose gradient is never clipped
            jp.need_clip = False
            tp.need_clip = False
        jpg.append((jp, paddle.to_tensor(g)))
        tpg.append((tp, torch.from_numpy(g)))
    return jpg, tpg


CLIPS = {
    "value": (lambda: jclip.ClipGradByValue(0.3, -0.2),
              lambda: tclip.ClipGradByValue(0.3, -0.2)),
    "norm": (lambda: jclip.ClipGradByNorm(0.7), lambda: tclip.ClipGradByNorm(0.7)),
    "global_norm": (lambda: jclip.ClipGradByGlobalNorm(1.0),
                    lambda: tclip.ClipGradByGlobalNorm(1.0)),
}


@pytest.mark.parametrize("scale", [0.05, 2.0], ids=["below", "above"])
@pytest.mark.parametrize("kind", list(CLIPS))
def test_clip_classes_match_reference(kind, scale):
    make_j, make_t = CLIPS[kind]
    jpg, tpg = _pairs(scale)
    jout, tout = make_j()(jpg), make_t()(tpg)
    for (_, jg), (_, tg), (_, g0) in zip(jout, tout, tpg):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg.numpy()),
                                   atol=ATOL, rtol=0)
    # the need_clip=False gradient is passed through untouched
    assert tout[1][1] is tpg[1][1]


def test_global_norm_is_a_device_scalar():
    _, tpg = _pairs(2.0)
    norm = tclip.ClipGradByGlobalNorm(1.0).global_norm(tpg)
    assert isinstance(norm, torch.Tensor) and norm.dtype == torch.float32
    want = np.sqrt(sum((g.numpy().astype(np.float64) ** 2).sum()
                       for i, (_, g) in enumerate(tpg) if i != 1))
    np.testing.assert_allclose(float(norm), want, rtol=1e-6)


def _with_grads(scale, seed=1):
    ps, gs = _arrays(scale, seed)
    jps, tps = [], []
    for p, g in zip(ps, gs):
        jp = jnn.Parameter(p)
        jp.grad = paddle.to_tensor(g)
        tp = torch.nn.Parameter(torch.from_numpy(p))
        tp.grad = torch.from_numpy(g.copy())
        jps.append(jp)
        tps.append(tp)
    return jps, tps


@pytest.mark.parametrize("norm_type", [2.0, float("inf")], ids=["l2", "inf"])
@pytest.mark.parametrize("scale", [0.05, 2.0], ids=["below", "above"])
def test_clip_grad_norm_in_place_matches_reference(scale, norm_type):
    jps, tps = _with_grads(scale)
    before = [p.grad.clone() for p in tps]
    jt = jclip.clip_grad_norm_(jps, 1.5, norm_type=norm_type)
    tt = tclip.clip_grad_norm_(tps, 1.5, norm_type=norm_type)
    np.testing.assert_allclose(float(tt), float(jt.numpy()), rtol=1e-6)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad.numpy()),
                                   atol=ATOL, rtol=0)
    if float(tt) < 1.5:  # nothing to clip: every gradient's bits unchanged
        assert all(torch.equal(p.grad, b) for p, b in zip(tps, before))


def test_clip_grad_value_in_place_matches_reference():
    jps, tps = _with_grads(1.0)
    jclip.clip_grad_value_(jps, 0.25)
    tclip.clip_grad_value_(tps, 0.25)
    for jp, tp in zip(jps, tps):
        np.testing.assert_array_equal(tp.grad.numpy(), np.asarray(jp.grad.numpy()))


def _train(make_j, make_t, steps=3):
    ps, _ = _arrays(1.0, seed=2)
    jps = [jnn.Parameter(p) for p in ps]
    tps = [torch.nn.Parameter(torch.from_numpy(p)) for p in ps]
    jo, to = make_j(jps), make_t(tps)
    for step in range(steps):
        _, gs = _arrays(3.0, seed=10 + step)
        for jp, tp, g in zip(jps, tps, gs):
            jp.grad = paddle.to_tensor(g)
            tp.grad = torch.from_numpy(g)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(),
                                   np.asarray(jp._data.astype(jnp.float32)),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_grad_clip_in_the_optimizer_matches_reference(fused):
    _train(lambda ps: jopt.AdamW(1e-2, parameters=ps,
                                 grad_clip=jclip.ClipGradByGlobalNorm(1.0)),
           lambda ps: topt.AdamW(1e-2, parameters=ps, fused=fused,
                                 grad_clip=tclip.ClipGradByGlobalNorm(1.0)))


def test_grad_clip_in_a_param_group_matches_reference():
    def groups(ps, clip):
        return [{"params": ps[:2], "grad_clip": clip.ClipGradByNorm(0.5)},
                {"params": ps[2:]}]

    _train(lambda ps: jopt.AdamW(1e-2, parameters=groups(ps, jclip),
                                 grad_clip=jclip.ClipGradByValue(0.1)),
           lambda ps: topt.AdamW(1e-2, parameters=groups(ps, tclip),
                                 grad_clip=tclip.ClipGradByValue(0.1)))
