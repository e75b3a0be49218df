"""The multi-tensor fused AdamW: its batched prologue and plain version on
the CPU, and ``AdamW(fused=True)``'s one update per group against the JAX
package.

- ``adamw_scalars_multi`` bitwise the per-tensor ``adamw_scalars`` rows.
- ``fused_adamw_multi_update_plain`` (and the wrapper on CPU tensors)
  bitwise T single plain updates with the same rows and salts, SR and
  round-to-nearest, sizes 1, 7 and 2049 and an empty tensor.
- ``AdamW(fused=True)`` over parameters of mixed shapes in two groups with
  masterless bf16 and SR: bitwise the reference's update expressions
  (``_ref_update``) rounded by the reference hash with the salts the port's
  generator draws for the step, one ``[T, 2]`` draw; bitwise the unfused
  port (on the CPU the generator gives T draws of 2 and one of ``[T, 2]``
  the same numbers); and the per-parameter beta powers, advanced in one
  vector, survive a ``state_dict`` round trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import seed as t_seed
from paddle_tpu_torch.base.random import sr_salts
from paddle_tpu_torch.ops.fused_adamw import (
    adamw_scalars,
    adamw_scalars_multi,
    fused_adamw_multi_update,
    fused_adamw_multi_update_plain,
    fused_adamw_update_plain,
)
B1, B2, EPS = 0.9, 0.999, 1e-8
SIZES = [(1,), (7,), (2049,), (0,), (33, 5)]


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


def _np(t):
    return _bits(t.detach()).numpy()


def _ref_sr(x32, salts):
    """The reference's _stochastic_round_bf16 hash with given salts, as
    ``tests/test_torch_optimizer.py`` writes it."""
    u = jax.lax.bitcast_convert_type(x32, jnp.uint32)
    i = jax.lax.iota(jnp.uint32, x32.size).reshape(x32.shape)
    b = i * jnp.uint32(0x9E3779B9) + salts[0]
    b = (b ^ (b >> 16)) * jnp.uint32(0x7FEB352D)
    b = (b ^ (b >> 15)) * jnp.uint32(0x846CA68B)
    b = (b ^ (b >> 16)) + salts[1]
    r = jax.lax.bitcast_convert_type(
        (u + (b & jnp.uint32(0xFFFF))) & jnp.uint32(0xFFFF0000), jnp.float32)
    return jnp.where(jnp.isfinite(x32), r, x32).astype(jnp.bfloat16)


@pytest.mark.parametrize("skip", [None, False, True], ids=["none", "no", "yes"])
def test_batched_scalars_are_bitwise_the_per_tensor_rows(skip):
    rng = np.random.RandomState(0)
    t = 9
    b1p = torch.from_numpy((B1 ** rng.randint(1, 50, t)).astype(np.float32))
    b2p = torch.from_numpy((B2 ** rng.randint(1, 5000, t)).astype(np.float32))
    lrs = list(1e-4 * (1 + rng.rand(t)))
    wds = [0.0, 0.01, 0.1] * 3
    sk = None if skip is None else torch.tensor(skip)
    got = adamw_scalars_multi(lr=lrs, epsilon=EPS, beta1_pow=b1p,
                              beta2_pow=b2p, weight_decay=wds, skip=sk)
    assert got.shape == (t, 4) and got.dtype == torch.float32
    for i in range(t):
        want = adamw_scalars(lr=lrs[i], epsilon=EPS, beta1_pow=b1p[i],
                             beta2_pow=b2p[i], weight_decay=wds[i], skip=sk)
        assert torch.equal(got[i].view(torch.int32), want.view(torch.int32)), i
    # one lr and one decay for all
    one = adamw_scalars_multi(lr=lrs[0], epsilon=EPS, beta1_pow=b1p,
                              beta2_pow=b2p, weight_decay=0.01)
    want = adamw_scalars(lr=lrs[0], epsilon=EPS, beta1_pow=b1p[3],
                         beta2_pow=b2p[3], weight_decay=0.01)
    assert torch.equal(one[3].view(torch.int32), want.view(torch.int32))


def _tensors(dtypes, seed):
    rng = np.random.RandomState(seed)
    out = []
    for shape in SIZES:
        raw = [rng.randn(*shape), 0.1 * rng.randn(*shape),
               0.01 * rng.randn(*shape), 0.01 * rng.rand(*shape)]
        out.append([torch.from_numpy(x.astype(np.float32)).to(d)
                    for x, d in zip(raw, dtypes)])
    return out


@pytest.mark.parametrize("dtypes,sr", [(("bf16",) * 3, False),
                                       (("bf16",) * 3, True),
                                       (("f32", "f32", "bf16"), False)],
                         ids=["bf16-rne", "bf16-sr", "f32-bf16m-rne"])
def test_multi_plain_is_bitwise_t_single_plain_updates(dtypes, sr):
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    p_dt, g_dt, m_dt = (dt[x] for x in dtypes)
    ts = _tensors((p_dt, g_dt, m_dt, m_dt), seed=1)
    refs = [[x.clone() for x in row] for row in ts]
    t = len(ts)
    b1p = torch.tensor([B1 ** (i + 1) for i in range(t)], dtype=torch.float32)
    b2p = torch.tensor([B2 ** (i + 1) for i in range(t)], dtype=torch.float32)
    lrs, wds = [1e-2 * (i + 1) for i in range(t)], [0.01 * i for i in range(t)]
    salts = (torch.tensor([[0x9E3779B9 + i, 0x2545F491 * (i + 1) % 2 ** 32]
                           for i in range(t)]) if sr else None)
    scalars = adamw_scalars_multi(lr=lrs, epsilon=EPS, beta1_pow=b1p,
                                  beta2_pow=b2p, weight_decay=wds)
    before = fused_adamw_multi_update.launches
    cols = list(zip(*ts))
    fused_adamw_multi_update(*cols, scalars=scalars, beta1=B1, beta2=B2,
                             sr_salts=salts)
    assert fused_adamw_multi_update.launches == before  # CPU: no launch
    alone = [[x.clone() for x in row] for row in refs]
    fused_adamw_multi_update_plain(*zip(*alone), scalars=scalars, beta1=B1,
                                   beta2=B2, sr_salts=salts)
    for i, (p, g, m, v) in enumerate(refs):
        fused_adamw_update_plain(p, g, m, v, lr=lrs[i], beta1=B1, beta2=B2,
                                 epsilon=EPS, beta1_pow=b1p[i],
                                 beta2_pow=b2p[i], weight_decay=wds[i],
                                 sr_salts=None if salts is None else salts[i])
    for got, plain, want in zip(ts, alone, refs):
        for k in (0, 2, 3):  # p, m, v
            assert torch.equal(_bits(got[k]), _bits(want[k]))
            assert torch.equal(_bits(plain[k]), _bits(want[k]))


def test_multi_update_refuses_mismatched_tables():
    ts = _tensors((torch.float32,) * 4, seed=2)[:2]
    cols = list(zip(*ts))
    with pytest.raises(ValueError, match=r"scalars must be f32 \[2, 4\]"):
        fused_adamw_multi_update(*cols, scalars=torch.zeros(3, 4), beta1=B1,
                                 beta2=B2)
    with pytest.raises(ValueError, match="requires a bf16 param"):
        fused_adamw_multi_update(
            *cols, scalars=torch.zeros(2, 4), beta1=B1, beta2=B2,
            sr_salts=torch.zeros(2, 2, dtype=torch.int64))


SHAPES = [(40, 24), (24,), (7, 3), (2049,)]


def _params(seed=7):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    return xs, [torch.nn.Parameter(torch.from_numpy(x).to(torch.bfloat16))
                for x in xs]


def _grads(step):
    rng = np.random.RandomState(50 + step)
    return [(0.5 * rng.randn(*s)).astype(np.float32) for s in SHAPES]


def _make(ps, fused):
    # two groups (the second at half the lr), one parameter without decay
    groups = [{"params": ps[:2]}, {"params": ps[2:], "learning_rate": 0.5}]
    return topt.AdamW(1e-2, parameters=groups,
                      apply_decay_param_fun=lambda n: n != "param_1",
                      use_stochastic_rounding=True, moment_dtype="bfloat16",
                      fused=fused)


def test_fused_sr_step_matches_reference_with_one_salt_draw():
    """Two steps of masterless bf16 with SR: every parameter equals the
    reference expressions rounded with row t of the step's [T, 2] salts."""
    xs, ps = _params()
    opt = _make(ps, fused=True)
    t_seed(3)
    want_p = [jnp.asarray(x, jnp.bfloat16) for x in xs]
    want_m = [jnp.zeros(s, jnp.bfloat16) for s in SHAPES]
    want_v = [jnp.zeros(s, jnp.bfloat16) for s in SHAPES]
    for step in range(2):
        gs = _grads(step)
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g).to(torch.bfloat16)
        t_seed(3 + step)
        salts = sr_salts("cpu", len(ps)).numpy().astype(np.uint32)
        t_seed(3 + step)
        opt.step()
        opt.clear_grad()
        for i, g in enumerate(gs):
            lr = 1e-2 * (1.0 if i < 2 else 0.5)
            wd = 0.0 if i == 1 else 0.01
            # the beta powers as the reference keeps them: one f32 product
            # a step
            b1p, b2p = np.float32(1), np.float32(1)
            for _ in range(step + 1):
                b1p, b2p = b1p * np.float32(B1), b2p * np.float32(B2)
            jg = jnp.asarray(g, jnp.bfloat16).astype(jnp.float32)
            m = B1 * want_m[i].astype(jnp.float32) + (1 - B1) * jg
            v = B2 * want_v[i].astype(jnp.float32) + (1 - B2) * jg * jg
            lr_t = lr * jnp.sqrt(1 - b2p) / (1 - b1p)
            delta = lr_t * m / (jnp.sqrt(v) + EPS * jnp.sqrt(1 - b2p))
            decayed = want_p[i].astype(jnp.float32) * np.float32(1.0 - lr * wd)
            want_p[i] = _ref_sr(decayed - delta, jnp.asarray(salts[i]))
            want_m[i] = m.astype(jnp.bfloat16)
            want_v[i] = v.astype(jnp.bfloat16)
            np.testing.assert_array_equal(
                _np(ps[i]), np.asarray(want_p[i]).view(np.int16),
                err_msg=f"step {step} param {i}")
    pows = opt._accumulators["beta2_pow"]
    assert [float(pows[f"param_{i}"]) for i in range(len(ps))] == \
        [float(np.float32(np.float32(B2) * np.float32(B2)))] * len(ps)


def test_fused_step_is_bitwise_the_unfused_step_and_resumes():
    """On the CPU the fused step (one [T, 2] salt draw) and the unfused one
    (T draws of 2) see the same salts, so they agree bit for bit; a fused
    optimizer restored from a state_dict resumes exactly."""
    _, fused_ps = _params()
    _, plain_ps = _params()
    fused, plain = _make(fused_ps, True), _make(plain_ps, False)
    for step in range(3):
        for ps, o in ((fused_ps, fused), (plain_ps, plain)):
            for p, g in zip(ps, _grads(step)):
                p.grad = torch.from_numpy(g).to(torch.bfloat16)
            t_seed(20 + step)
            o.step()
            o.clear_grad()
        for a, b in zip(fused_ps, plain_ps):
            assert torch.equal(_bits(a.detach()), _bits(b.detach())), step
    sd = fused.state_dict()
    b1 = np.float32(B1)
    assert float(sd["param_3.beta1_pow"]) == float(b1 * b1 * b1)
    twins = [torch.nn.Parameter(p.detach().clone()) for p in fused_ps]
    resumed = _make(twins, True)
    resumed.set_state_dict(sd)
    for ps, o in ((fused_ps, fused), (twins, resumed)):
        for p, g in zip(ps, _grads(9)):
            p.grad = torch.from_numpy(g).to(torch.bfloat16)
        t_seed(99)
        o.step()
    for a, b in zip(fused_ps, twins):
        assert torch.equal(_bits(a.detach()), _bits(b.detach()))
    for name in ("beta1_pow", "beta2_pow"):
        for key, val in fused._accumulators[name].items():
            assert torch.equal(val, resumed._accumulators[name][key])
