"""Port parity: ``paddle_tpu_torch.amp`` against ``paddle_tpu.amp``.

- Tiny-Llama logits and loss under ``auto_cast`` at O1 and O2, float16 and
  bfloat16, untied and tied heads, weights carried from the JAX model: the
  same output dtypes, logits within 2 ulps of the low-precision type at
  the largest logit (``2 * eps * max|logits|``; the GEMMs accumulate in
  other orders), the loss within twice that (``lse - picked``).
  ``decorate(level="O2")`` casts the same parameters.
- ``GradScaler`` ``scale``/``unscale_``/``step``/``update``/``minimize``
  sequences with an injected inf, against the JAX scaler: the scale and
  the good/bad counters after every step, the parameters at 1e-6 (f32),
  ``n_skipped_steps``; and on the skipped step every parameter and
  accumulator bitwise as it was, both for ``AdamW(fused=True)`` (the
  kernel's skip veto) and for the snapshot-and-select route (unfused
  AdamW, Momentum).
- A reference ``state_dict`` loaded into the port's scaler.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.utils import load_jax_params

EPS = {"float16": 2.0 ** -10, "bfloat16": 2.0 ** -7}


def _llama_pair(tie):
    paddle.seed(0)
    jm = JLlama(JConfig.tiny(tie_word_embeddings=tie))
    tm = LlamaForCausalLM(LlamaConfig.tiny(tie_word_embeddings=tie), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    return jm, tm


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_logits_match_reference(level, dtype, tie):
    jm, tm = _llama_pair(tie)
    ids = np.random.RandomState(0).randint(0, 256, (2, 16))
    ji, ti = paddle.to_tensor(ids), torch.from_numpy(ids)
    with jamp.auto_cast(level=level, dtype=dtype):
        jl, jloss = jm(ji), jm.loss(ji, ji)
    with tamp.auto_cast(level=level, dtype=dtype):
        tl, tloss = tm(ti), tm.loss(ti, ti)
    want = np.asarray(jl.numpy()).astype(np.float32)
    assert str(tl.dtype).replace("torch.", "") == str(jl.dtype)
    assert tloss.dtype == torch.float32 and str(jloss.dtype) == "float32"
    atol = 2 * EPS[dtype] * np.abs(want).max()
    np.testing.assert_allclose(tl.detach().float().numpy(), want, rtol=0,
                               atol=atol)
    # lse - picked moves at most twice as far as the logits do
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()), rtol=0,
                               atol=2 * atol)
    # outside the block nothing is cast
    assert tm(ti).dtype == torch.float32


def test_custom_lists_and_levels():
    from paddle_tpu_torch.base.amp_state import cast_target

    with tamp.auto_cast(level="O1", dtype="float16",
                        custom_black_list=["linear"],
                        custom_white_list=["rms_norm"]):
        assert cast_target("linear") == torch.float32
        assert cast_target("rms_norm") == torch.float16
        assert cast_target("add") is None
    with tamp.auto_cast(level="O2"):
        assert cast_target("add") == torch.bfloat16
        assert cast_target("embedding") == torch.float32
    with tamp.auto_cast(level="O0"):
        assert cast_target("linear") is None
    with pytest.raises(ValueError, match="overlap"):
        with tamp.auto_cast(custom_white_list=["x"], custom_black_list=["x"]):
            pass
    for level in ("O1", "O2", "OD"):
        for dt in ("float16", "bfloat16"):
            lists = tamp.AutoCastLists(dtype=dt, level=level)
            want = jamp.AutoCastLists(dtype=dt, level=level)
            assert lists.white_list == want.white_list
            assert lists.black_list == want.black_list


def test_decorate_o2_casts_the_parameters_as_the_reference_does():
    jm, tm = _llama_pair(False)
    jo = jopt.AdamW(parameters=jm.parameters())
    to = topt.AdamW(parameters=tm.parameters())
    jamp.decorate(jm, jo, level="O2", dtype="bfloat16")
    tamp.decorate(tm, to, level="O2", dtype="bfloat16")
    jd = {n: str(p.dtype) for n, p in jm.named_parameters()}
    td = {n: str(p.dtype).replace("torch.", "") for n, p in tm.named_parameters()}
    assert jd == td and set(td.values()) == {"bfloat16"}
    assert to._multi_precision and jo._multi_precision


# -- GradScaler -----------------------------------------------------------
SHAPES = [(5, 4), (4,), (3, 3)]
STEPS = 4
INF_STEP = 1
SCALER = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)


def _coeffs(step):
    rng = np.random.RandomState(30 + step)
    cs = [(0.3 * rng.randn(*s)).astype(np.float32) for s in SHAPES]
    if step == INF_STEP:
        cs[2][1, 1] = np.inf
    return cs


OPTS = {
    "adamw_fused": (lambda ps: jopt.AdamW(1e-2, parameters=ps),
                    lambda ps: topt.AdamW(1e-2, parameters=ps, fused=True)),
    "adamw": (lambda ps: jopt.AdamW(1e-2, parameters=ps),
              lambda ps: topt.AdamW(1e-2, parameters=ps)),
    "momentum": (lambda ps: jopt.Momentum(0.05, parameters=ps),
                 lambda ps: topt.Momentum(0.05, parameters=ps)),
}


def _state(ps, opt):
    return ([p.detach().clone() for p in ps],
            {k: v.detach().clone() for k, v in opt.state_dict().items()
             if isinstance(v, torch.Tensor)})


@pytest.mark.parametrize("calls", ["step_update", "unscale_step", "minimize"])
@pytest.mark.parametrize("opt", list(OPTS))
def test_grad_scaler_sequence_matches_reference(opt, calls):
    rng = np.random.RandomState(1)
    vals = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jps = [jnn.Parameter(v) for v in vals]
    tps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in vals]
    make_j, make_t = OPTS[opt]
    jo, to = make_j(jps), make_t(tps)
    js, ts = jamp.GradScaler(**SCALER), tamp.GradScaler(**SCALER)
    skips = []
    ts.set_on_skip(skips.append)
    for step in range(STEPS):
        cs = _coeffs(step)
        jloss = sum((p * paddle.to_tensor(c)).sum() for p, c in zip(jps, cs))
        tloss = sum((p * torch.from_numpy(c)).sum() for p, c in zip(tps, cs))
        js.scale(jloss).backward()
        scaled = ts.scale(tloss)
        scaled.backward()
        before = _state(tps, to)
        if calls == "minimize":
            js.minimize(jo)
            ts.minimize(to, scaled)
        else:
            if calls == "unscale_step":
                js.unscale_(jo)
                ts.unscale_(to)
            if opt == "adamw_fused":  # every update goes through the kernel
                assert ts._kernel_veto(to, ts._params_with_grads(to))
            js.step(jo)
            ts.step(to)
            js.update()
            ts.update()
        jo.clear_grad()
        to.clear_grad()
        assert ts.get_scale_value() == js.get_scale_value(), step
        jsd, tsd = js.state_dict(), ts.state_dict()
        assert (tsd["incr_count"], tsd["decr_count"]) == (
            jsd["incr_count"], jsd["decr_count"]), step
        assert ts.n_skipped_steps == js.n_skipped_steps
        after = _state(tps, to)
        if step == INF_STEP:  # the skipped step changes no bit
            for a, b in zip(before[0], after[0]):
                assert torch.equal(a, b)
            assert before[1].keys() == after[1].keys()
            for k in before[1]:
                assert torch.equal(before[1][k], after[1][k]), k
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp._data.astype(jnp.float32)),
                                       atol=1e-6, rtol=0)
    assert ts.n_skipped_steps == 1 and skips == [INF_STEP]
    assert ts.last_skip_step == js.last_skip_step == INF_STEP


def test_skipped_first_step_leaves_fresh_state():
    """An overflow on the very first step: the accumulators the step
    created stay at their initial values (the reference's creation log),
    through the kernel's veto and through the rollback alike."""
    for fused in (True, False):
        p = torch.nn.Parameter(torch.ones(4))
        o = topt.AdamW(1e-2, parameters=[p], fused=fused)
        s = tamp.GradScaler()
        s.scale((p * torch.tensor([1.0, np.inf, 1.0, 1.0])).sum()).backward()
        s.step(o)
        s.update()
        assert torch.equal(p.detach(), torch.ones(4))
        sd = o.state_dict()
        assert float(sd["param_0.beta1_pow"]) == 1.0
        assert float(sd["param_0.beta2_pow"]) == 1.0
        assert not sd["param_0.moment1"].any() and not sd["param_0.moment2"].any()


def test_grad_scaler_state_dict_from_the_reference():
    js = jamp.GradScaler(init_loss_scaling=64.0, incr_ratio=3.0,
                         decr_ratio=0.25, incr_every_n_steps=7,
                         decr_every_n_nan_or_inf=3)
    p = jnn.Parameter(np.ones(2, np.float32))
    jo = jopt.SGD(0.1, parameters=[p])
    for bad in (True, False, False):
        c = np.array([np.inf if bad else 1.0, 1.0], np.float32)
        js.scale((p * paddle.to_tensor(c)).sum()).backward()
        js.step(jo)
        js.update()
        jo.clear_grad()
    ts = tamp.GradScaler()
    ts.load_state_dict(js.state_dict())
    tsd, jsd = ts.state_dict(), js.state_dict()
    assert float(tsd["scale"]) == float(np.asarray(jsd["scale"]))
    for k in jsd:
        if k != "scale":
            assert tsd[k] == jsd[k], k
    assert ts.get_scale_value() == js.get_scale_value() == 64.0
