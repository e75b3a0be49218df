"""Attention dropout in ``paddle_tpu_torch.nn.functional``, checked by
distribution: its keep mask comes from torch's generator, whose stream
never matches JAX's, so no test compares it with the reference's mask.

With q = k = 0 every probability of a row is 1/Sk, and with v the identity
the output row is the probability row after dropout. The checks: the kept
share is 1 - p (within 4 standard deviations over 2**17 draws), every kept
entry is exactly (1/Sk) / (1 - p), the same seed draws the same mask and
another seed another, ``training=False`` and ``dropout_p=0`` are bitwise
the no-dropout path (nothing is drawn), and the plain path with dropout
keeps its gradient.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import seed as t_seed
from paddle_tpu_torch.base.random import get_generator
from paddle_tpu_torch.nn import functional as F

B, S, H = 2, 256, 2  # B * H * S * S = 2**18 probabilities


def _inputs():
    q = torch.zeros(B, S, H, S)
    v = torch.eye(S).reshape(1, S, 1, S).expand(B, S, H, S).contiguous()
    return q, q.clone(), v


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_and_scale(p):
    t_seed(3)
    q, k, v = _inputs()
    out = F.scaled_dot_product_attention(q, k, v, dropout_p=p, training=True)
    kept = out != 0
    n = kept.numel()
    rate = kept.float().mean().item()
    assert abs(rate - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
    want = torch.tensor(1.0 / S) / (1.0 - p)
    assert torch.equal(out[kept], want.expand(int(kept.sum())))


def test_same_seed_same_mask_other_seed_other_mask():
    q, k, v = _inputs()
    masks = []
    for s in (5, 5, 6):
        t_seed(s)
        masks.append(F.scaled_dot_product_attention(q, k, v, dropout_p=0.3) != 0)
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])


def test_no_dropout_when_not_training_or_p_zero():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(B, 64, H, 32).astype(np.float32))
               for _ in range(3))
    t_seed(1)
    state = get_generator("cpu").get_state()
    plain = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    for kw in (dict(dropout_p=0.0), dict(dropout_p=0.5, training=False)):
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True, **kw)
        assert torch.equal(out, plain)
    assert torch.equal(get_generator("cpu").get_state(), state)  # no draw


def test_dropout_is_differentiable():
    t_seed(2)
    q, k, v = (torch.randn(1, 32, 2, 16, requires_grad=True) for _ in range(3))
    out = F.scaled_dot_product_attention(q, k, v, dropout_p=0.2, is_causal=True)
    out.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))
