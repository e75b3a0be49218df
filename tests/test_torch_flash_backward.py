"""Port parity: the flash-attention backward.

Autograd through ``paddle_tpu_torch.ops.flash_attention.flash_attention``
on the CPU (forward and backward take their plain versions there) against
``jax.grad`` of the JAX package's Pallas kernels in interpret mode, on the
same numpy inputs and cotangent. dq/dk/dv in f32 agree to 1e-4: the same
sums in other orders. The kernel wrappers' pieces are held against the
same oracle, and the plain backward with P and dS rounded to bf16 (the
chip gates' reference) against the Pallas kernels run on bf16 inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.flash_attention import flash_attention as j_flash
from paddle_tpu_torch.ops.flash_attention import (
    _bwd_plain_heads,
    _delta,
    _sum_groups,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
)

ATOL = 1e-4


def _inputs(s, h, kvh, d=64, b=2, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, kvh, d).astype(np.float32)
    v = rng.randn(b, s, kvh, d).astype(np.float32)
    w = rng.randn(b, s, h, d).astype(np.float32)
    return q, k, v, w


def _jax_grads(q, k, v, w, causal):
    def f(q, k, v):
        return jnp.sum(j_flash(q, k, v, causal, None, True) * w)

    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("s", [128, 256])
def test_autograd_matches_jax_grad(s, kvh, causal):
    q, k, v, w = _inputs(s, 4, kvh)
    want = _jax_grads(q, k, v, w, causal)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal)
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0,
                                   err_msg=f"d{name}")


def test_kernel_wrappers_on_cpu_compose_to_the_backward():
    """The dQ and dK/dV wrappers (plain on the CPU) give what
    ``flash_attention_bwd`` gives, dK/dV already summed over each GQA group
    as the kernel sums them, and the launch counts stay put."""
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(128, 4, 2, seed=1))
    out, lse = flash_attention_fwd(q, k, v, True)
    scale = 1.0 / np.sqrt(64)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    delta = _delta(out, w)
    dq = flash_attention_bwd_dq(q, k, v, w, lse, delta, True, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, w, lse, delta, True, scale)
    assert dk.shape == dv.shape == (2, 128, 2, 64)  # per kv head, summed
    want = flash_attention_bwd(q, k, v, out, lse, w, True)
    torch.testing.assert_close(dq, want[0], atol=0, rtol=0)
    torch.testing.assert_close(dk, want[1], atol=1e-6, rtol=0)
    torch.testing.assert_close(dv, want[2], atol=1e-6, rtol=0)
    # the group sum is the per-query-head gradients' sum
    _, dk_h, dv_h = _bwd_plain_heads(q, k, v, w, lse, delta, True, scale)
    torch.testing.assert_close(_sum_groups(dk_h, 2, k.dtype), dk, atol=0,
                               rtol=0)
    torch.testing.assert_close(_sum_groups(dv_h, 2, v.dtype), dv, atol=0,
                               rtol=0)
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == before


def test_fully_masked_rows_get_no_gradient():
    """Sq > Sk with causal masking leaves the first Sq - Sk rows with no
    visible key: their output is 0 and no gradient flows through them."""
    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.randn(1, 8, 2, 64).astype(np.float32)).requires_grad_()
    k = torch.from_numpy(rng.randn(1, 4, 2, 64).astype(np.float32)).requires_grad_()
    v = torch.from_numpy(rng.randn(1, 4, 2, 64).astype(np.float32)).requires_grad_()
    out = flash_attention(q, k, v, True)
    assert torch.equal(out[:, :4], torch.zeros_like(out[:, :4]))
    out.sum().backward()
    assert torch.equal(q.grad[:, :4], torch.zeros_like(q.grad[:, :4]))
    assert torch.isfinite(k.grad).all() and torch.isfinite(v.grad).all()


# per-row tolerance of the p_dtype reference against the TPU kernels: the
# JAX outputs are rounded to bf16 (half an ulp, 2^-9 = 0.00195 of each
# element) and the two sum in other orders (worst row 0.0027 at these
# inputs; the version that keeps P and dS in f32 is 0.0031-0.0044 off); a
# row's norm counts at least ROW_FLOOR of the tensor's RMS row norm, since
# under causal masking dq's first row sees one key and is rounding noise
# (dP = delta in exact arithmetic)
ROW_REL, ROW_FLOOR = 3e-3, 1e-2


def _row_rel(got, want):
    norms = want.norm(dim=-1)
    floor = ROW_FLOOR * float(norms.pow(2).mean().sqrt())
    return float(((got - want).norm(dim=-1) / norms.clamp_min(floor)).max())


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kvh", [2, 1], ids=["mha", "gqa"])
def test_plain_backward_rounds_where_the_tpu_kernels_round(kvh, causal):
    """``flash_attention_bwd_plain(..., p_dtype=bf16)`` run in f32 on
    bf16-valued inputs against the JAX package's ``_flash_bwd`` (Pallas,
    interpret mode) on the same bf16 inputs, out and lse: P rounded before
    ``P^T dO`` and dS before ``dS K`` and ``dS^T Q`` on both sides. Three
    128-row tiles per side, so the causal ``live`` predicate skips tiles."""
    from paddle_tpu.ops.flash_attention import _flash_bwd

    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_fwd_plain)

    h, s = 2, 384
    q, k, v, w = (torch.from_numpy(x).to(torch.bfloat16).float()
                  for x in _inputs(s, h, kvh, b=1, seed=3))
    out, lse = flash_attention_fwd_plain(q, k, v, causal,
                                         p_dtype=torch.bfloat16)
    out = out.to(torch.bfloat16).float()
    got = flash_attention_bwd_plain(q, k, v, out, lse, w, causal,
                                    p_dtype=torch.bfloat16)

    def bf16_bhsd(t, repeat=1):
        a = jnp.asarray(t.transpose(1, 2).numpy(), dtype=jnp.bfloat16)
        return jnp.repeat(a, repeat, axis=1) if repeat > 1 else a

    group = h // kvh
    dq, dk, dv = _flash_bwd(
        bf16_bhsd(q), bf16_bhsd(k, group), bf16_bhsd(v, group), bf16_bhsd(out),
        jnp.asarray(lse.numpy()), bf16_bhsd(w), 1.0 / np.sqrt(64), causal, True)

    def port_layout(a, sum_groups=False):
        t = torch.from_numpy(np.array(a.astype(jnp.float32))).transpose(1, 2)
        if sum_groups:  # [B, S, H, D] -> each GQA group summed in f32
            t = t.reshape(t.shape[0], t.shape[1], kvh, group, -1).sum(3)
        return t

    want = (port_layout(dq), port_layout(dk, True), port_layout(dv, True))
    unrounded = flash_attention_bwd_plain(q, k, v, out, lse, w, causal)
    for name, g, wnt, f32 in zip(("dq", "dk", "dv"), got, want, unrounded):
        assert g.dtype == torch.float32 and g.shape == wnt.shape, name
        assert _row_rel(g, wnt) <= ROW_REL, name
        # the rounding points are what bring it this close
        assert _row_rel(f32, wnt) > _row_rel(g, wnt), name
