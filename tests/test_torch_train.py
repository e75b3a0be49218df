"""Port parity: the training slice end to end on ``LlamaConfig.tiny()`` in
f32, with the JAX model's weights carried over by ``load_jax_params``.

- ``model.loss`` and every parameter's gradient against the JAX package's
  ``loss.backward()`` (1e-4: f32 through two layers of GEMMs, the sums in
  other orders).
- Three ``to_static`` steps of ``bench.py``'s step body (``model(ids)`` ->
  ``F.cross_entropy`` -> ``loss.backward()`` -> ``opt.step()`` ->
  ``opt.clear_grad()``) with ``AdamW(lr=1e-3)``, unfused and fused, against
  the JAX package's compiled step: each loss and the final parameters at
  1e-4.
- ``multi_step(steps=3)``, after the warm-up call it requires, returns the
  three losses as one ``[3]`` tensor, equal to three calls.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.tensor import manipulation as M
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.utils import load_jax_params

ATOL = 1e-4
B, S = 2, 16


def _pair():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, arrays)
    return jm, tm


def _batch(seed=0):
    ids = np.random.RandomState(seed).randint(0, 256, (B, S)).astype(np.int64)
    return ids, np.roll(ids, -1, axis=1)


def test_loss_and_every_gradient_match():
    jm, tm = _pair()
    ids, labels = _batch()
    jl = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jl.backward()
    tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), atol=ATOL, rtol=0)
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    tgrads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(jgrads) == set(tgrads)
    for n in jgrads:
        np.testing.assert_allclose(tgrads[n], jgrads[n], atol=ATOL, rtol=0,
                                   err_msg=n)
    assert tm.flops_per_token(S) == jm.flops_per_token(S)


def _jax_steps(jm, fused, ids, labels, n=3):
    opt = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(), fused=fused)

    def step(ids, labels):
        logits = jm(ids)
        b, s, v = logits.shape
        loss = JF.cross_entropy(M.reshape(logits, [b * s, v]),
                                M.reshape(labels, [b * s]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    compiled = paddle.jit.to_static(step, layers=[jm], optimizers=[opt])
    ji, jl = paddle.to_tensor(ids), paddle.to_tensor(labels)
    return [float(compiled(ji, jl).numpy()) for _ in range(n)]


def _torch_step(tm, opt):
    def step(ids, labels):
        logits = tm(ids)
        b, s, v = logits.shape
        loss = TF.cross_entropy(logits.reshape(b * s, v), labels.reshape(b * s))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return tjit.to_static(step, layers=[tm], optimizers=[opt])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_three_to_static_steps_match_the_jax_package(fused):
    jm, tm = _pair()
    ids, labels = _batch(1)
    want = _jax_steps(jm, fused, ids, labels)
    opt = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters(), fused=fused)
    compiled = _torch_step(tm, opt)
    ti, tl = torch.from_numpy(ids), torch.from_numpy(labels)
    got = [compiled(ti, tl).item() for _ in range(3)]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got[2] < got[0]
    jparams = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[n], atol=ATOL,
                                   rtol=0, err_msg=n)


def test_multi_step_returns_the_losses_of_three_calls():
    _, tm = _pair()
    _, tm2 = _pair()
    ids, labels = (torch.from_numpy(x) for x in _batch(2))
    runs = []
    for model, multi in ((tm, False), (tm2, True)):
        opt = topt.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                         fused=True)
        compiled = _torch_step(model, opt)
        compiled(ids, labels)  # the warm-up call multi_step requires
        if multi:
            losses = compiled.multi_step(ids, labels, steps=3)
        else:
            losses = torch.stack([compiled(ids, labels).detach() for _ in range(3)])
        runs.append(losses)
        assert opt._lr_override is None and opt._global_step == 4
    assert runs[1].shape == (3,) and not runs[1].requires_grad
    assert torch.equal(runs[0], runs[1])
    for a, b in zip(tm.parameters(), tm2.parameters()):
        assert torch.equal(a, b)


def test_multi_step_holds_the_lr_and_takes_stacked_batches():
    _, tm = _pair()
    sched = topt.lr.StepDecay(1e-3, step_size=1, gamma=0.5)
    opt = topt.AdamW(learning_rate=sched, parameters=tm.parameters())
    seen = []

    def step(ids, labels):
        seen.append(opt._lr())
        sched.step()  # a scheduler stepped inside cannot move the held lr
        loss = tm.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    compiled = tjit.to_static(step, layers=[tm], optimizers=[opt])
    ids, labels = (torch.from_numpy(np.stack([x, x])) for x in _batch(3))
    compiled(ids[0], labels[0])  # the warm-up call: lr 1e-3, then 5e-4
    out = compiled.multi_step(ids, labels)
    assert out.shape == (2,) and seen == [1e-3, 5e-4, 5e-4]
    assert opt._lr_override is None and opt.get_lr() == 1.25e-4
