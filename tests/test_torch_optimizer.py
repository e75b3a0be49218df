"""Port parity: ``paddle_tpu_torch.optimizer`` and the fused AdamW plain
version against the JAX package.

- ``fused_adamw_update_plain`` against the reference's update expressions
  run eagerly in JAX (op by op, as the reference's ``AdamW._update_param``
  runs outside ``jit``), with pinned beta powers and salts: bitwise for
  every output, f32 included (neither side contracts a product and a sum
  into an FMA when ops run one by one). Never against the interpret-mode
  Pallas kernel's multi-tile output, a known fault of the reference here.
- ``AdamW``/``Adam``/``SGD``/``Momentum`` against ``paddle_tpu.optimizer``
  over 3 steps on the same f32 tensors and gradients at 1e-6 (the
  reference's AdamW decay factor is one f32 rounding of a Python double in
  both); likewise ``multi_precision`` and ``moment_dtype="bfloat16"``.
- The stochastic-rounding writeback against the reference's lowbias32 hash
  with the salts the port's generator draws.
- Every scheduler of ``lr.py`` equal over 20 steps, and a ``state_dict``
  round trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
import paddle_tpu.optimizer.lr as jlr
import paddle_tpu_torch.optimizer as topt
import paddle_tpu_torch.optimizer.lr as tlr
from paddle_tpu_torch import seed as t_seed
from paddle_tpu_torch.base.random import sr_salts
from paddle_tpu_torch.ops.fused_adamw import (
    fused_adamw_hbm_bytes,
    fused_adamw_multi_update,
    fused_adamw_update,
    fused_adamw_update_plain,
    unfused_adamw_hbm_bytes,
)

LR, B1, B2, EPS = 1e-2, 0.9, 0.999, 1e-8
J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _ref_update(p, g, m, v, *, wd, b1p, b2p, m_store):
    """The reference AdamW._update_param expressions, eagerly."""
    g32 = g.astype(jnp.float32)
    m_new = B1 * m.astype(jnp.float32) + (1 - B1) * g32
    v_new = B2 * v.astype(jnp.float32) + (1 - B2) * g32 * g32
    lr_t = LR * jnp.sqrt(1 - b2p) / (1 - b1p)
    delta = lr_t * m_new / (jnp.sqrt(v_new) + EPS * jnp.sqrt(1 - b2p))
    new = p.astype(jnp.float32) * (1.0 - LR * wd) - delta
    return new, m_new.astype(m_store), v_new.astype(m_store)


def _ref_sr(x32, salts):
    """_stochastic_round_bf16's hash with pinned salts (C-order iota)."""
    u = jax.lax.bitcast_convert_type(x32, jnp.uint32)
    i = jax.lax.iota(jnp.uint32, x32.size).reshape(x32.shape)
    b = i * jnp.uint32(0x9E3779B9) + salts[0]
    b = (b ^ (b >> 16)) * jnp.uint32(0x7FEB352D)
    b = (b ^ (b >> 15)) * jnp.uint32(0x846CA68B)
    b = (b ^ (b >> 16)) + salts[1]
    r = jax.lax.bitcast_convert_type(
        (u + (b & jnp.uint32(0xFFFF))) & jnp.uint32(0xFFFF0000), jnp.float32)
    return jnp.where(jnp.isfinite(x32), r, x32).astype(jnp.bfloat16)


def _np(t):
    """Raw bits of a torch tensor as numpy (bf16 through int16)."""
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _inputs(shape, p_dt, g_dt, m_dt, seed=0):
    rng = np.random.RandomState(seed)
    raw = [rng.randn(*shape), 0.1 * rng.randn(*shape),
           0.01 * rng.randn(*shape), 0.01 * rng.rand(*shape)]
    dts = [p_dt, g_dt, m_dt, m_dt]
    js = [jnp.asarray(x, J_DT[d]) for x, d in zip(raw, dts)]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(T_DT[d])
          for j, d in zip(js, dts)]
    return js, ts


COMBOS = [("f32", "f32", "f32"), ("f32", "f32", "bf16"),
          ("bf16", "bf16", "bf16"), ("bf16", "bf16", "f32"),
          ("bf16", "f32", "bf16"), ("f32", "bf16", "f32")]


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["wd0", "wd.01"])
@pytest.mark.parametrize("p_dt,g_dt,m_dt", COMBOS,
                         ids=["-".join(c) for c in COMBOS])
def test_plain_fused_update_bitwise_vs_reference(p_dt, g_dt, m_dt, wd):
    (jp, jg, jm, jv), (tp, tg, tm, tv) = _inputs((37, 19), p_dt, g_dt, m_dt)
    b1p, b2p = np.float32(B1 ** 3), np.float32(B2 ** 3)
    new, m_new, v_new = _ref_update(jp, jg, jm, jv, wd=wd, b1p=jnp.float32(b1p),
                                    b2p=jnp.float32(b2p), m_store=J_DT[m_dt])
    fused_adamw_update_plain(
        tp, tg, tm, tv, lr=LR, beta1=B1, beta2=B2, epsilon=EPS,
        beta1_pow=torch.tensor(b1p), beta2_pow=torch.tensor(b2p),
        weight_decay=wd)
    for got, want, name in ((tp, new.astype(J_DT[p_dt]), "p"), (tm, m_new, "m"),
                            (tv, v_new, "v")):
        np.testing.assert_array_equal(_np(got), _jbits(want),
                                      err_msg=f"{name} not bitwise-identical")


@pytest.mark.parametrize("m_dt", ["bf16", "f32"])
def test_plain_sr_writeback_bitwise_vs_reference_hash(m_dt):
    (jp, jg, jm, jv), (tp, tg, tm, tv) = _inputs((300, 130), "bf16", "bf16", m_dt)
    salts = [0xDEADBEEF, 0x12345678]
    new, _, _ = _ref_update(jp, jg, jm, jv, wd=0.01, b1p=jnp.float32(B1),
                            b2p=jnp.float32(B2), m_store=J_DT[m_dt])
    want = _ref_sr(new, jnp.asarray(salts, jnp.uint32))
    fused_adamw_update_plain(
        tp, tg, tm, tv, lr=LR, beta1=B1, beta2=B2, epsilon=EPS,
        beta1_pow=torch.tensor(B1, dtype=torch.float32),
        beta2_pow=torch.tensor(B2, dtype=torch.float32), weight_decay=0.01,
        sr_salts=torch.tensor(salts, dtype=torch.int64))
    np.testing.assert_array_equal(_np(tp), _jbits(want))


def test_sr_passes_non_finite_values_through():
    p = torch.tensor([float("inf"), float("nan"), 1.0]).to(torch.bfloat16)
    g = torch.tensor([0.0, 0.0, float("inf")])
    m, v = torch.zeros(3), torch.zeros(3)
    fused_adamw_update_plain(p, g, m, v, lr=LR, beta1=B1, beta2=B2, epsilon=EPS,
                             beta1_pow=torch.tensor(B1), beta2_pow=torch.tensor(B2),
                             sr_salts=torch.tensor([1, 2]))
    assert p[0].item() == float("inf") and p[1].isnan() and p[2].isnan()


def test_skip_veto_is_bitwise_and_cpu_wrapper_is_the_plain_version():
    _, (tp, tg, tm, tv) = _inputs((64, 33), "bf16", "bf16", "bf16", seed=3)
    ref = [t.clone() for t in (tp, tm, tv)]
    kw = dict(lr=LR, beta1=B1, beta2=B2, epsilon=EPS,
              beta1_pow=torch.tensor(B1), beta2_pow=torch.tensor(B2),
              weight_decay=0.01, sr_salts=torch.tensor([5, 6]))
    before = fused_adamw_multi_update.launches  # the kernel's one count
    fused_adamw_update(tp, tg, tm, tv, skip=torch.tensor(True), **kw)
    for a, b in zip((tp, tm, tv), ref):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    fused_adamw_update(tp, tg, tm, tv, skip=torch.tensor(False), **kw)
    fused_adamw_update_plain(*ref[:1], tg, *ref[1:], **kw)
    for a, b in zip((tp, tm, tv), ref):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert fused_adamw_multi_update.launches == before  # CPU: no launch


def test_hbm_byte_models_match_the_reference():
    from paddle_tpu.ops import fused_adamw as jf

    for pd, md in ((jnp.float32, jnp.float32), (jnp.bfloat16, jnp.bfloat16),
                   (jnp.bfloat16, jnp.float32)):
        tp, tm = (torch.float32 if pd == jnp.float32 else torch.bfloat16,
                  torch.float32 if md == jnp.float32 else torch.bfloat16)
        assert fused_adamw_hbm_bytes(1000, tp, tp, tm) == \
            jf.fused_adamw_hbm_bytes(1000, pd, pd, md)
        assert unfused_adamw_hbm_bytes(1000, tp, tp, tm) == \
            jf.unfused_adamw_hbm_bytes(1000, pd, pd, md)


# -- optimizers against paddle_tpu.optimizer ------------------------------
SHAPES = [(8, 6), (6,), (5, 3)]


def _pair_params(dtype="f32", seed=0):
    rng = np.random.RandomState(seed)
    vals = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jps = []
    for x in vals:
        p = jnn.Parameter(x)
        p._data = p._data.astype(J_DT[dtype])
        jps.append(p)
    tps = [torch.nn.Parameter(torch.from_numpy(x).to(T_DT[dtype])) for x in vals]
    return jps, tps


def _grads(step, dtype="f32"):
    rng = np.random.RandomState(100 + step)
    return [(0.5 * rng.randn(*s)).astype(np.float32) for s in SHAPES]


def _run_pair(make_j, make_t, dtype="f32", steps=3):
    jps, tps = _pair_params(dtype)
    jo, to = make_j(jps), make_t(tps)
    for step in range(steps):
        for jp, tp, g in zip(jps, tps, _grads(step)):
            jp.grad = paddle.to_tensor(g).astype(jp.dtype)
            tp.grad = torch.from_numpy(g).to(tp.dtype)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        assert all(p.grad is None for p in tps)
    return jps, tps, jo, to


def _assert_params(jps, tps, atol):
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().float().numpy(),
                                   np.asarray(jp._data.astype(jnp.float32)),
                                   atol=atol, rtol=0)


CASES = {
    "sgd": (lambda ps: jopt.SGD(0.1, parameters=ps),
            lambda ps: topt.SGD(0.1, parameters=ps)),
    "sgd_l2": (lambda ps: jopt.SGD(0.1, parameters=ps, weight_decay=0.05),
               lambda ps: topt.SGD(0.1, parameters=ps, weight_decay=0.05)),
    "momentum": (lambda ps: jopt.Momentum(0.1, 0.9, parameters=ps),
                 lambda ps: topt.Momentum(0.1, 0.9, parameters=ps)),
    "nesterov": (lambda ps: jopt.Momentum(0.1, 0.9, parameters=ps, use_nesterov=True),
                 lambda ps: topt.Momentum(0.1, 0.9, parameters=ps, use_nesterov=True)),
    "adam": (lambda ps: jopt.Adam(1e-2, parameters=ps),
             lambda ps: topt.Adam(1e-2, parameters=ps)),
    "adamw": (lambda ps: jopt.AdamW(1e-2, parameters=ps),
              lambda ps: topt.AdamW(1e-2, parameters=ps)),
    "adamw_fused": (lambda ps: jopt.AdamW(1e-2, parameters=ps),
                    lambda ps: topt.AdamW(1e-2, parameters=ps, fused=True)),
    "adamw_groups": (
        lambda ps: jopt.AdamW(1e-2, parameters=[
            {"params": ps[:1]}, {"params": ps[1:], "learning_rate": 0.5}]),
        lambda ps: topt.AdamW(1e-2, parameters=[
            {"params": ps[:1]}, {"params": ps[1:], "learning_rate": 0.5}])),
    "adamw_sched": (
        lambda ps: jopt.AdamW(jlr.StepDecay(1e-2, 1, 0.5), parameters=ps),
        lambda ps: topt.AdamW(tlr.StepDecay(1e-2, 1, 0.5), parameters=ps)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_reference_f32(case):
    make_j, make_t = CASES[case]
    jps, tps, jo, to = _run_pair(make_j, make_t)
    _assert_params(jps, tps, 1e-6)
    assert to._global_step == jo._global_step == 3


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode", ["master", "bf16_moments"])
def test_adamw_low_precision_modes_match_reference(mode, fused):
    if mode == "master":
        kw = dict(multi_precision=True)
    else:
        kw = dict(moment_dtype="bfloat16")
    jps, tps, jo, to = _run_pair(
        lambda ps: jopt.AdamW(1e-2, parameters=ps, **kw),
        lambda ps: topt.AdamW(1e-2, parameters=ps, fused=fused, **kw),
        dtype="bf16")
    _assert_params(jps, tps, 0)  # one bf16 rounding of equal f32 values
    for name, store in jo._accumulators.items():
        tstore = to._accumulators[name]
        for (jk, ja), (tk, ta) in zip(store.items(), tstore.items()):
            np.testing.assert_allclose(
                ta.float().numpy(), np.asarray(ja.astype(jnp.float32)),
                atol=1e-6, rtol=0, err_msg=f"{name} {tk}")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_adamw_sr_writeback_uses_the_drawn_salts(fused):
    """Masterless bf16 with SR: the step equals the reference expressions
    rounded by the reference hash with the salts the port's salt generator
    draws for it."""
    rng = np.random.RandomState(7)
    x = rng.randn(40, 24).astype(np.float32)
    g = (0.5 * rng.randn(40, 24)).astype(np.float32)
    t_seed(11)
    salts = sr_salts("cpu")
    t_seed(11)
    p = torch.nn.Parameter(torch.from_numpy(x).to(torch.bfloat16))
    p.grad = torch.from_numpy(g).to(torch.bfloat16)
    topt.AdamW(LR, parameters=[p], use_stochastic_rounding=True,
               moment_dtype="bfloat16", fused=fused).step()
    jp = jnp.asarray(x, jnp.bfloat16)
    jg = jnp.asarray(g, jnp.bfloat16)
    z = jnp.zeros(x.shape, jnp.bfloat16)
    new, _, _ = _ref_update(jp, jg, z, z, wd=0.01, b1p=jnp.float32(B1),
                            b2p=jnp.float32(B2), m_store=jnp.bfloat16)
    want = _ref_sr(new, jnp.asarray(salts.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(_np(p), _jbits(want))


def test_state_dict_round_trip_resumes_exactly():
    _, tps, _, to = _run_pair(lambda ps: jopt.AdamW(1e-2, parameters=ps),
                              lambda ps: topt.AdamW(1e-2, parameters=ps), steps=2)
    sd = to.state_dict()
    assert sd["global_step"] == 2 and "param_0.moment1" in sd
    twins = [torch.nn.Parameter(p.detach().clone()) for p in tps]
    to2 = topt.AdamW(1e-2, parameters=twins)
    to2.set_state_dict(sd)
    for ps, o in ((tps, to), (twins, to2)):
        for p, g in zip(ps, _grads(9)):
            p.grad = torch.from_numpy(g)
        o.step()
    for a, b in zip(tps, twins):
        assert torch.equal(a, b)
    assert to2._global_step == 3


@pytest.mark.parametrize("name", ["Adagrad", "Adadelta", "Adamax", "RMSProp",
                                  "Lamb", "NAdam", "RAdam", "Rprop", "ASGD",
                                  "LBFGS"])
def test_later_slice_features_raise(name):
    """The optimizers a later slice was to port (they raised here before
    this slice): each one, built as it was built here, now steps as the
    reference's does — 3 steps at their defaults, parameters at 1e-6
    (LBFGS: one closure-driven step on a quadratic, 1e-5). Their options,
    ``interleave_updates`` and ``grad_clip`` have their own tests
    (``test_torch_optimizer_rest.py``, ``test_torch_clip.py``)."""
    rng = np.random.RandomState(5)
    x = rng.randn(6).astype(np.float32)
    jp, tp = jnn.Parameter(x), torch.nn.Parameter(torch.from_numpy(x.copy()))
    jo = getattr(jopt, name)(learning_rate=0.1, parameters=[jp])
    to = getattr(topt, name)(learning_rate=0.1, parameters=[tp])
    if name == "LBFGS":
        c = rng.randn(6).astype(np.float32)
        jc, tc = paddle.to_tensor(c), torch.from_numpy(c)

        def jclosure():
            jo.clear_grad()
            loss = ((jp - jc) * (jp - jc)).sum()
            loss.backward()
            return loss

        def tclosure():
            to.clear_grad()
            loss = ((tp - tc) ** 2).sum()
            loss.backward()
            return loss

        np.testing.assert_allclose(to.step(tclosure), jo.step(jclosure),
                                   rtol=1e-5)
        atol = 1e-5
    else:
        for step in range(3):
            g = (0.5 * np.random.RandomState(50 + step).randn(6)).astype(
                np.float32)
            jp.grad = paddle.to_tensor(g)
            tp.grad = torch.from_numpy(g)
            jo.step()
            to.step()
            jo.clear_grad()
            to.clear_grad()
        atol = 1e-6
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                               atol=atol, rtol=0)


# -- schedulers -----------------------------------------------------------
SCHEDULERS = {
    "Noam": dict(d_model=64, warmup_steps=5),
    "PiecewiseDecay": dict(boundaries=[3, 7], values=[0.1, 0.05, 0.01]),
    "NaturalExpDecay": dict(learning_rate=0.1, gamma=0.3),
    "InverseTimeDecay": dict(learning_rate=0.1, gamma=0.3),
    "PolynomialDecay": dict(learning_rate=0.1, decay_steps=7, cycle=True),
    "LinearWarmup": dict(learning_rate=0.1, warmup_steps=4, start_lr=0.0,
                         end_lr=0.1),
    "LinearWarmupInner": dict(warmup_steps=4, start_lr=0.0, end_lr=0.1),
    "ExponentialDecay": dict(learning_rate=0.1, gamma=0.9),
    "MultiStepDecay": dict(learning_rate=0.1, milestones=[2, 5, 9]),
    "StepDecay": dict(learning_rate=0.1, step_size=3),
    "LambdaDecay": dict(learning_rate=0.1, lr_lambda=lambda e: 0.95 ** e),
    "MultiplicativeDecay": dict(learning_rate=0.1, lr_lambda=lambda e: 0.9),
    "CosineAnnealingDecay": dict(learning_rate=0.1, T_max=6),
    "CosineAnnealingWarmRestarts": dict(learning_rate=0.1, T_0=3, T_mult=2),
    "LinearLR": dict(learning_rate=0.1, total_steps=8),
    "OneCycleLR": dict(max_learning_rate=0.1, total_steps=15),
    "CyclicLR": dict(base_learning_rate=0.01, max_learning_rate=0.1,
                     step_size_up=3, mode="triangular2"),
}


def _make(mod, name):
    kw = dict(SCHEDULERS[name])
    if name == "Noam":
        return mod.NoamDecay(**kw)
    if name == "LinearWarmupInner":
        return mod.LinearWarmup(mod.StepDecay(0.1, 2), **kw)
    return getattr(mod, name)(**kw)


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_matches_reference_over_20_steps(name):
    js, ts = _make(jlr, name), _make(tlr, name)
    for _ in range(20):
        assert ts() == js()
        js.step()
        ts.step()
    sd = ts.state_dict()
    twin = _make(tlr, name)
    twin.set_state_dict(sd)
    assert twin() == ts()


def test_reduce_on_plateau_matches_reference():
    js = jlr.ReduceOnPlateau(0.1, patience=1, cooldown=1)
    ts = tlr.ReduceOnPlateau(0.1, patience=1, cooldown=1)
    for metric in [1.0, 0.9, 0.95, 0.97, 0.99, 0.5, 0.6, 0.7, 0.8, 0.9] * 2:
        js.step(metric)
        ts.step(torch.tensor(metric))
        assert ts() == js() and ts.last_epoch == js.last_epoch
