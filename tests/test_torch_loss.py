"""Port parity: ``paddle_tpu_torch.nn.functional`` losses against the JAX
package's on the same numpy inputs, in f32, at 1e-6 (one logsumexp and a
mean; the sums run in other orders)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn.functional as TF

TOL = 1e-6
N, C = 24, 11


def _logits(seed=0, shape=(N, C)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3


def _labels(seed=1, ignore=False):
    y = np.random.RandomState(seed).randint(0, C, (N,)).astype(np.int64)
    if ignore:
        y[::5] = -100
    return y


def _j(x):
    return paddle.to_tensor(x)


def _check(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want.numpy()),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("ignore", [False, True], ids=["all", "ignore"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_hard_labels(reduction, ignore, smoothing):
    x, y = _logits(), _labels(ignore=ignore)
    want = JF.cross_entropy(_j(x), _j(y), reduction=reduction,
                            label_smoothing=smoothing)
    got = TF.cross_entropy(torch.from_numpy(x), torch.from_numpy(y),
                           reduction=reduction, label_smoothing=smoothing)
    _check(got, want)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_class_weights(reduction):
    x, y = _logits(), _labels(ignore=True)
    w = np.random.RandomState(3).rand(C).astype(np.float32) + 0.5
    want = JF.cross_entropy(_j(x), _j(y), weight=_j(w), reduction=reduction)
    got = TF.cross_entropy(torch.from_numpy(x), torch.from_numpy(y),
                           weight=torch.from_numpy(w), reduction=reduction)
    _check(got, want)


@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_soft_labels(smoothing):
    x = _logits()
    soft = np.random.RandomState(4).rand(N, C).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    want = JF.cross_entropy(_j(x), _j(soft), soft_label=True,
                            label_smoothing=smoothing)
    got = TF.cross_entropy(torch.from_numpy(x), torch.from_numpy(soft),
                           soft_label=True, label_smoothing=smoothing)
    _check(got, want)


def test_trailing_label_dim_and_no_softmax():
    x, y = _logits(), _labels(ignore=True)
    probs = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    want = JF.cross_entropy(_j(probs), _j(y[:, None]), use_softmax=False)
    got = TF.cross_entropy(torch.from_numpy(probs), torch.from_numpy(y[:, None]),
                           use_softmax=False)
    _check(got, want)


def test_softmax_with_cross_entropy_and_nll_loss():
    x, y = _logits(), _labels(ignore=True)
    want = JF.softmax_with_cross_entropy(_j(x), _j(y))
    got = TF.softmax_with_cross_entropy(torch.from_numpy(x), torch.from_numpy(y))
    assert tuple(got.shape) == (N, 1)
    _check(got, want)
    logp = np.log(np.exp(x) / np.exp(x).sum(-1, keepdims=True)).astype(np.float32)
    w = np.linspace(0.5, 1.5, C).astype(np.float32)
    for kw_j, kw_t in (({}, {}), ({"weight": _j(w)}, {"weight": torch.from_numpy(w)})):
        want = JF.nll_loss(_j(logp), _j(y), **kw_j)
        got = TF.nll_loss(torch.from_numpy(logp), torch.from_numpy(y), **kw_t)
        _check(got, want)


def test_bf16_logits_reduce_in_f32_and_backprop():
    """The logsumexp-gather path upcasts bf16 logits to f32 and its
    gradient is softmax - onehot, divided by the token count."""
    x = torch.from_numpy(_logits(5, (6, 7))).to(torch.bfloat16).requires_grad_()
    y = torch.tensor([0, 1, 2, 3, 4, 5])
    loss = TF.cross_entropy(x, y)
    assert loss.dtype == torch.float32
    loss.backward()
    want = (torch.softmax(x.detach().float(), -1)
            - torch.nn.functional.one_hot(y, 7)) / 6
    torch.testing.assert_close(x.grad.float(), want, atol=4e-3, rtol=0)
