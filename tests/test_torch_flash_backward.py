"""Port parity: the flash-attention backward.

Autograd through ``paddle_tpu_torch.ops.flash_attention.flash_attention``
on the CPU (forward and backward take their plain versions there) against
``jax.grad`` of the JAX package's Pallas kernels in interpret mode, on the
same numpy inputs and cotangent. dq/dk/dv in f32 agree to 1e-4: the same
sums in other orders. The kernel wrappers' per-head pieces and the GQA
group sum are held against the same oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.flash_attention import flash_attention as j_flash
from paddle_tpu_torch.ops.flash_attention import (
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
    """The dQ and dK/dV wrappers (plain on the CPU) with the group sum give
    what ``flash_attention_bwd`` gives, and the launch counts stay put."""
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(128, 4, 2, seed=1))
    out, lse = flash_attention_fwd(q, k, v, True)
    scale = 1.0 / np.sqrt(64)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    delta = _delta(out, w)
    dq = flash_attention_bwd_dq(q, k, v, w, lse, delta, True, scale)
    dk_h, dv_h = flash_attention_bwd_dkv(q, k, v, w, lse, delta, True, scale)
    assert dk_h.shape == (2, 128, 4, 64)  # per query head, before the sum
    want = flash_attention_bwd(q, k, v, out, lse, w, True)
    torch.testing.assert_close(dq, want[0], atol=0, rtol=0)
    torch.testing.assert_close(_sum_groups(dk_h, 2, k.dtype), want[1],
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(_sum_groups(dv_h, 2, v.dtype), want[2],
                               atol=1e-6, rtol=0)
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
