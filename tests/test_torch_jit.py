"""Port parity: ``paddle_tpu_torch.jit`` against ``paddle_tpu.jit`` on the
CPU, where the port runs the step eagerly (the captured CUDA graph is held
against the eager step by the card tests in ``test_torch_kernels.py``).

- ``to_static(step, layers=, optimizers=, scalers=[GradScaler])`` and
  ``multi_step(..., steps=3, lr_schedule=...)`` on a tiny f32 Llama against
  the JAX package's compiled ``multi_step``: each loss and every final
  parameter at 1e-4, the scaler's scale and the optimizer's step count
  equal. Also with per-step (stacked) batches.
- ``multi_step`` before the warm-up call raises, as the reference's does.
- ``enable_to_static(False)`` runs the function as it is, and
  ``not_to_static`` marks a function that ``to_static`` leaves eager; both
  give the losses of the plain eager loop.
- ``to_static`` finds the layers, optimizers and scalers in the step's
  closure when none are named.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.utils import load_jax_params

ATOL = 1e-4
B, S = 2, 16
SCHEDULE = [1e-3, 5e-4, 2.5e-4]


def _pair():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    return jm, tm


def _batch(seed):
    ids = np.random.RandomState(seed).randint(0, 256, (B, S)).astype(np.int64)
    return ids, np.roll(ids, -1, axis=1)


def _scaled_step(model, opt, scaler):
    def step(ids, labels):
        loss = model.loss(ids, labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss

    return step


@pytest.mark.parametrize("stacked", [False, True], ids=["steps", "stacked"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_multi_step_with_scaler_and_schedule_matches_reference(fused, stacked):
    jm, tm = _pair()
    jo = jopt.AdamW(1e-3, parameters=jm.parameters(), weight_decay=0.1)
    to = topt.AdamW(1e-3, parameters=tm.parameters(), weight_decay=0.1,
                    fused=fused)
    js = jamp.GradScaler(init_loss_scaling=256.0, incr_every_n_steps=2)
    ts = tamp.GradScaler(init_loss_scaling=256.0, incr_every_n_steps=2)
    jc = paddle.jit.to_static(_scaled_step(jm, jo, js), layers=[jm],
                              optimizers=[jo], scalers=[js])
    tc = tjit.to_static(_scaled_step(tm, to, ts), layers=[tm],
                        optimizers=[to], scalers=[ts])
    ids, labels = _batch(0)
    warm = (float(jc(paddle.to_tensor(ids), paddle.to_tensor(labels)).numpy()),
            float(tc(torch.from_numpy(ids), torch.from_numpy(labels)).detach()))
    np.testing.assert_allclose(warm[1], warm[0], atol=ATOL, rtol=0)
    if stacked:
        batches = [_batch(1 + t) for t in range(3)]
        sids, slabels = (np.stack([b[i] for b in batches]) for i in (0, 1))
        jl = jc.multi_step(paddle.to_tensor(sids), paddle.to_tensor(slabels),
                           lr_schedule=np.asarray(SCHEDULE, np.float32))
        tl = tc.multi_step(torch.from_numpy(sids), torch.from_numpy(slabels),
                           lr_schedule=SCHEDULE)
    else:
        ji, jl_ = paddle.to_tensor(ids), paddle.to_tensor(labels)
        jl = jc.multi_step(ji, jl_, steps=3,
                           lr_schedule=np.asarray(SCHEDULE, np.float32))
        tl = tc.multi_step(torch.from_numpy(ids), torch.from_numpy(labels),
                           steps=3, lr_schedule=SCHEDULE)
    assert tuple(tl.shape) == (3,) and not tl.requires_grad
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()), atol=ATOL,
                               rtol=0)
    jparams = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[n], atol=ATOL,
                                   rtol=0, err_msg=n)
    assert ts.get_scale_value() == js.get_scale_value() == 1024.0  # 4 good
    assert to._global_step == jo._global_step == 4
    assert to._lr_override is None and to.get_lr() == 1e-3


def test_multi_step_requires_the_warm_up_call():
    jm, tm = _pair()
    ids, labels = _batch(0)
    jo = jopt.AdamW(1e-3, parameters=jm.parameters())
    to = topt.AdamW(1e-3, parameters=tm.parameters())

    def jstep(i, lab):
        loss = jm.loss(i, lab)
        loss.backward()
        jo.step()
        jo.clear_grad()
        return loss

    def tstep(i, lab):
        loss = tm.loss(i, lab)
        loss.backward()
        to.step()
        to.clear_grad()
        return loss

    jc = paddle.jit.to_static(jstep, layers=[jm], optimizers=[jo])
    tc = tjit.to_static(tstep, layers=[tm], optimizers=[to])
    with pytest.raises(RuntimeError, match="one regular call first"):
        jc.multi_step(paddle.to_tensor(ids), paddle.to_tensor(labels), steps=2)
    with pytest.raises(RuntimeError, match="one regular call first"):
        tc.multi_step(torch.from_numpy(ids), torch.from_numpy(labels), steps=2)
    assert to._global_step == 0
    tc(torch.from_numpy(ids), torch.from_numpy(labels))
    assert tc.multi_step(torch.from_numpy(ids), torch.from_numpy(labels),
                         steps=2).shape == (2,)
    with pytest.raises(ValueError, match="lr_schedule"):
        tc.multi_step(torch.from_numpy(ids), torch.from_numpy(labels),
                      steps=2, lr_schedule=[1e-3])


def _eager_losses(steps=3):
    _, tm = _pair()
    opt = topt.AdamW(1e-3, parameters=tm.parameters())
    out = []
    for t in range(steps):
        ids, labels = (torch.from_numpy(x) for x in _batch(t))
        loss = tm.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(loss.item())
    return out


@pytest.mark.parametrize("how", ["enable_to_static", "not_to_static"])
def test_eager_switches_give_the_eager_losses(how):
    _, tm = _pair()
    opt = topt.AdamW(1e-3, parameters=tm.parameters())

    def step(ids, labels):
        loss = tm.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    if how == "not_to_static":
        assert tjit.not_to_static(step) is step and step._not_to_static
    else:
        tjit.enable_to_static(False)
    try:
        compiled = tjit.to_static(step, layers=[tm], optimizers=[opt])
        assert compiled._eager()
        got = [compiled(*(torch.from_numpy(x) for x in _batch(t))).item()
               for t in range(3)]
    finally:
        tjit.enable_to_static(True)
    assert got == _eager_losses()
    assert not tjit.to_static(lambda: None)._eager()


def test_to_static_finds_the_state_in_the_closure():
    _, tm = _pair()
    opt = topt.AdamW(1e-3, parameters=tm.parameters())
    scaler = tamp.GradScaler()
    compiled = tjit.to_static(_scaled_step(tm, opt, scaler))
    compiled(*(torch.from_numpy(x) for x in _batch(0)))
    assert compiled._layers == [tm] and compiled._optimizers == [opt]
    assert compiled._scalers == [scaler]

    @tjit.to_static
    def forward(ids):
        return tm(ids)

    assert forward(torch.from_numpy(_batch(0)[0])).shape == (B, S, 256)
    assert forward._layers == [tm]
