"""Port parity: the SD-style UNet (``paddle_tpu_torch.models.unet``) against
the JAX package's on the tiny configuration in f32, with the JAX model's
weights carried over by ``load_jax_params``, at ``ATOL = 1e-4``.

- ``timestep_embedding`` (f32 whatever the timesteps' dtype, odd widths);
- the model's output over timesteps (0, mid, late) and conditioning
  (context lengths 1, 7 and the text encoder's 77; a zero context);
- a bf16 model: the sinusoid in f32, cast to the parameters' dtype;
- three ``jit.to_static`` train steps (the denoising MSE, AdamW lr 1e-3)
  against the reference's compiled step: each loss;
- which attentions the card's flash kernels take: ``chip_smoke``'s count
  of them, held against the calls the model makes (query length a multiple
  of 128 at head_dim 64, cross-attention at any key length);
- ``chip_smoke``'s check of the fused AdamW at a model's own tensor set
  (the UNet's exceeds one launch's 512): clean, it finds no bit apart;
  with a wrong moment in the second launch's tensors, it names them.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import UNet2DConditionModel as JUNet
from paddle_tpu.models import UNetConfig as JUNetConfig
from paddle_tpu.models.unet import timestep_embedding as jtimestep_embedding
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import UNet2DConditionModel, UNetConfig
from paddle_tpu_torch.models.unet import timestep_embedding
from paddle_tpu_torch.utils import load_jax_params

ATOL = 1e-4


def _pair(**kw):
    paddle.seed(0)
    jm = JUNet(dataclasses.replace(JUNetConfig.tiny(), **kw))
    tm = UNet2DConditionModel(UNetConfig.tiny(**kw), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _inputs(b=2, hw=16, ctx_len=7, seed=0, t=(3, 500)):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, 4, hw, hw).astype(np.float32)
    ctx = rs.randn(b, ctx_len, 32).astype(np.float32)
    return x, np.asarray(t[:b], np.int64), ctx


@pytest.mark.parametrize("dim", [32, 33, 320])
@pytest.mark.parametrize("dtype", [np.int64, np.float32])
def test_timestep_embedding_matches(dim, dtype):
    t = np.asarray([0, 1, 250, 999], dtype)
    want = np.asarray(jtimestep_embedding(paddle.to_tensor(t), dim).numpy())
    got = timestep_embedding(torch.from_numpy(t), dim)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("ctx_len,t,zero_ctx", [
    (7, (3, 500), False), (1, (0, 999), False), (77, (250, 250), False),
    (7, (10, 20), True)])
def test_unet_output_matches(ctx_len, t, zero_ctx):
    jm, tm = _pair()
    x, tt, ctx = _inputs(ctx_len=ctx_len, t=t)
    if zero_ctx:
        ctx = np.zeros_like(ctx)
    want = np.asarray(jm(paddle.to_tensor(x), paddle.to_tensor(tt),
                         paddle.to_tensor(ctx)).numpy())
    got = tm(torch.from_numpy(x), torch.from_numpy(tt),
             torch.from_numpy(ctx)).detach().numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_unet_names_and_sizes_match():
    jm, tm = _pair(layers_per_block=2, attn_resolutions=(0, 1))
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == \
        {n: tuple(p.shape) for n, p in jm.named_parameters()}
    assert tm.num_params() == jm.num_params()
    assert tm.down_attn[0] is not None and tm.up_attn[-1] is not None


def test_bf16_unet_runs_the_sinusoid_in_f32():
    _, tm = _pair()
    bf = UNet2DConditionModel(UNetConfig.tiny(), device="cpu",
                              dtype=torch.bfloat16)
    bf.load_state_dict(tm.state_dict())
    x, tt, ctx = _inputs()
    out = bf(torch.from_numpy(x).bfloat16(), torch.from_numpy(tt),
             torch.from_numpy(ctx).bfloat16())
    assert out.dtype == torch.bfloat16
    want = tm(torch.from_numpy(x), torch.from_numpy(tt),
              torch.from_numpy(ctx)).detach()
    rel = (out.float() - want).norm() / want.norm()
    assert rel < 0.05


def test_three_to_static_steps_match_the_reference():
    jm, tm = _pair()
    x, tt, ctx = _inputs(seed=1)
    target = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    jopt_ = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())

    def jstep(x, t, c, y):
        d = jm(x, t, c) - y
        loss = (d * d).mean()
        loss.backward()
        jopt_.step()
        jopt_.clear_grad()
        return loss

    jc = paddle.jit.to_static(jstep, layers=[jm], optimizers=[jopt_])
    ja = [paddle.to_tensor(a) for a in (x, tt, ctx, target)]
    want = [float(jc(*ja).numpy()) for _ in range(3)]
    opt = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters())

    def step(x, t, c, y):
        loss = tm.loss(x, t, c, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    tc = tjit.to_static(step, layers=[tm], optimizers=[opt])
    ta = [torch.from_numpy(a) for a in (x, tt, ctx, target)]
    got = [tc(*ta).item() for _ in range(3)]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got[2] < got[0]


@pytest.mark.parametrize("kw,plain", [
    (dict(block_out_channels=(64, 128)), False),
    (dict(block_out_channels=(64, 128, 128), attn_resolutions=(0, 1, 2)),
     True),
])
def test_chip_smokes_flash_count_is_the_models(monkeypatch, kw, plain):
    """``chip_smoke.unet_flash_calls`` predicts phase 21(d)'s B1 launches a
    forward; here every attention call is recorded with the gate the card
    would apply (the device aside)."""
    import chip_smoke
    from paddle_tpu_torch.nn.functional import attention as A

    seen = []
    real = A._use_flash

    def spy(q, mask, dropout_p):
        seen.append(q.shape[-1] in (64, 128, 256) and q.shape[1] % 128 == 0
                    and mask is None and dropout_p == 0)
        return real(q, mask, dropout_p)

    monkeypatch.setattr(A, "_use_flash", spy)
    cfg = UNetConfig.tiny(attention_head_dim=64, cross_attention_dim=32, **kw)
    m = UNet2DConditionModel(cfg, device="cpu")
    hw = 32  # levels 32x32, 16x16 (and 8x8, whose 64 tokens stay plain)
    x = torch.zeros(1, 4, hw, hw)
    with torch.no_grad():
        m(x, torch.zeros(1, dtype=torch.long), torch.zeros(1, 77, 32))
    assert sum(seen) == chip_smoke.unet_flash_calls(cfg, hw, hw) > 0
    assert (len(seen) > sum(seen)) == plain


@pytest.mark.parametrize("broken", [False, True])
def test_chip_smokes_adamw_check_covers_a_second_launch(monkeypatch, broken):
    """``chip_smoke.p21_adamw_check`` over 520 tensors (more than
    ``MAX_TENSORS_PER_LAUNCH``, some a few elements long): two steps each
    held bit for bit against the plain version on copies, the parameters
    put back after."""
    import chip_smoke
    import paddle_tpu_torch.optimizer.optimizer as O
    from paddle_tpu_torch.ops.fused_adamw import MAX_TENSORS_PER_LAUNCH

    n, wrong = 520, 515
    assert n > wrong >= MAX_TENSORS_PER_LAUNCH
    gen = torch.Generator().manual_seed(0)
    m = torch.nn.Module()
    m.ps = torch.nn.ParameterList(
        torch.nn.Parameter(torch.randn(1 + i % 7, 3 + i % 5, generator=gen))
        for i in range(n))
    grads = {name: torch.randn(p.shape, generator=gen)
             for name, p in m.named_parameters()}
    if broken:
        real = O.fused_adamw_multi_update

        def wrong_tail(ps, gs, ms, vs, **kw):
            real(ps, gs, ms, vs, **kw)
            ms[wrong].add_(1e-2)

        monkeypatch.setattr(O, "fused_adamw_multi_update", wrong_tail)
    before = [p.detach().clone() for p in m.parameters()]

    def make_opt():
        return topt.AdamW(learning_rate=1e-3, parameters=m.parameters(),
                          fused=True, use_stochastic_rounding=True)

    sizes, diffs = chip_smoke.p21_adamw_check(torch, m, make_opt, grads)
    assert sizes == [n, n]
    want = {f"{s}:{wrong}m": m.ps[wrong].numel() for s in (0, 1)}
    assert diffs == (want if broken else {})
    assert all(torch.equal(a, b) for a, b in zip(before, m.parameters()))
