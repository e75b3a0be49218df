"""Port parity: attention functionals and the flash-attention forward.

``scaled_dot_product_attention`` on CPU tensors takes the plain path and
must match the JAX package's ``_naive_attention``; the flash kernel's plain
version must match the TPU kernel run in interpret mode (as
tests/test_flash_attention.py runs it). All f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.attention import _naive_attention as j_naive
from paddle_tpu.ops.flash_attention import _fa_fwd
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.flash_attention import (
    FWD_VARIANTS,
    _fwd_variant,
    flash_attention,
    flash_attention_fwd,
)

SDPA_ATOL = 1e-5   # f32, same op order, different reduction order
FLASH_ATOL = 2e-5  # online-softmax kernel vs one-block math (test_flash_attention's bound)


def _qkv(rng, b, s, h, hkv, d, sk=None):
    sk = s if sk is None else sk
    return (rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, sk, hkv, d).astype(np.float32),
            rng.randn(b, sk, hkv, d).astype(np.float32))


@pytest.mark.parametrize("case", ["causal", "bool_mask", "additive_mask",
                                  "gqa_causal", "cross_causal"])
def test_sdpa_matches_reference_naive(case):
    rng = np.random.RandomState(0)
    hkv = 2 if case.startswith("gqa") else 4
    sk = 12 if case == "cross_causal" else 8
    q, k, v = _qkv(rng, 2, 8, 4, hkv, 16, sk)
    mask = None
    if case == "bool_mask":
        mask = rng.rand(2, 1, 8, sk) > 0.3
        mask[..., 0] = True  # no fully masked row
    elif case == "additive_mask":
        mask = (rng.randn(2, 4, 8, sk) * 2).astype(np.float32)
    causal = case.endswith("causal")
    want = j_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   None if mask is None else jnp.asarray(mask), 0.0, causal,
                   None, None)
    got = scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SDPA_ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
def test_flash_plain_matches_tpu_kernel_interpret(causal, hkv):
    rng = np.random.RandomState(1)
    q, k, v = _qkv(rng, 2, 256, 4, hkv, 64)
    want, (_, _, _, _, want_lse) = _fa_fwd(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), causal, None, True)
    before = kernels.launch_counts()["flash_attention_fwd"]
    out, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=FLASH_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=FLASH_ATOL, rtol=1e-6)
    # CPU tensors take the plain version: no kernel launch is counted
    assert kernels.launch_counts()["flash_attention_fwd"] == before


def test_flash_fully_masked_rows_are_zero():
    """sq > sk under causal masking leaves the first rows no visible key:
    they come out as zeros with lse = -1e30, as in the TPU kernel."""
    rng = np.random.RandomState(2)
    q, k, v = _qkv(rng, 1, 8, 2, 2, 64, sk=4)
    out, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), True)
    assert torch.all(out[:, :4] == 0)
    assert torch.all(lse[:, :, :4] == -1e30)
    assert torch.isfinite(out).all()


def test_flash_autograd_matches_plain_attention_gradients():
    """The training slice carries the backward: differentiating the flash
    path no longer raises, and its gradients are those of the plain
    attention differentiated by autograd."""
    rng = np.random.RandomState(3)
    arrays = _qkv(rng, 1, 16, 2, 2, 64)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    flash_attention(q, k, v, True).sum().backward()
    q2, k2, v2 = (torch.from_numpy(a).requires_grad_() for a in arrays)
    scaled_dot_product_attention(q2, k2, v2, is_causal=True).sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=SDPA_ATOL, rtol=0)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "wgmma"),
                                           (torch.float16, "wgmma"),
                                           (torch.float32, "cuda_core")])
def test_fwd_variant_is_decided_from_dtype_and_head_dim(dtype, variant, d):
    """The card's forward kernel is chosen up front from dtype and head_dim
    alone: 2-byte types on the TMA/wgmma kernel, f32 on the CUDA cores."""
    assert _fwd_variant(dtype, d) == variant
    assert variant in FWD_VARIANTS


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 96),
                                     (torch.float32, 32),
                                     (torch.int8, 128),
                                     (torch.float64, 64)])
def test_fwd_variant_refuses_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError):
        _fwd_variant(dtype, d)


def test_cpu_forward_counts_no_variant_launch():
    """CPU tensors take the plain version: no launch of any variant."""
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(rng, 1, 16, 2, 2, 64))
    before = kernels.launch_counts()
    flash_attention_fwd(q, k, v, True)
    assert kernels.launch_counts() == before
    assert {f"flash_attention_fwd:{v}" for v in FWD_VARIANTS} <= set(before)
