"""Port parity: ``paddle_tpu_torch.autograd`` (``backward``, ``grad``,
``jacobian``, ``hessian``, ``PyLayer``, ``saved_tensors_hooks``) against
``paddle_tpu.autograd`` — the reference's ``tests/test_autograd.py`` cases,
each run in both packages on the same numpy inputs. Gradients agree to 1e-6
(f32).

The reference's tape is its own; the port's is torch's. ``stop_gradient`` is
``not requires_grad``, ``x.grad`` is the accumulated gradient in both, and
``clear_grad`` is ``x.grad = None``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import autograd as jag
from paddle_tpu_torch import autograd as tag

TOL = 1e-6


def _j(a, grad=True):
    t = paddle.to_tensor(np.asarray(a, np.float32))
    t.stop_gradient = not grad
    return t


def _t(a, grad=True):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.numpy())


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), rtol=TOL, atol=TOL)


def test_backward_simple():
    jx, tx = _j([1.0, 2.0, 3.0]), _t([1.0, 2.0, 3.0])
    (jx * jx).sum().backward()
    tag.backward((tx * tx).sum())
    _close(tx.grad, jx.grad)
    _close(tx.grad, torch.tensor([2.0, 4.0, 6.0]))


def test_backward_chain():
    x0 = [[1.0, 2.0], [3.0, 4.0]]
    w0 = [[0.5, -1.0], [2.0, 0.25]]
    jx, jw, tx, tw = _j(x0), _j(w0), _t(x0), _t(w0)
    paddle.tanh(paddle.matmul(jx, jw)).mean().backward()
    torch.tanh(tx @ tw).mean().backward()
    _close(tx.grad, jx.grad)
    _close(tw.grad, jw.grad)


def test_grad_accumulation():
    jx, tx = _j([2.0]), _t([2.0])
    for x in (jx, tx):
        (x * 3).sum().backward()
        (x * 5).sum().backward()
    _close(tx.grad, jx.grad)
    assert float(tx.grad[0]) == 8.0
    jx.clear_grad()
    tx.grad = None
    assert jx.grad is None and tx.grad is None


def test_stop_gradient():
    jx, jy = _j([1.0]), _j([1.0], grad=False)
    tx, ty = _t([1.0]), _t([1.0], grad=False)
    (jx * jy).sum().backward()
    tag.backward([(tx * ty).sum()])
    _close(tx.grad, jx.grad)
    assert ty.grad is None and jy.grad is None


def test_no_grad_context():
    jx, tx = _j([1.0]), _t([1.0])
    with paddle.no_grad():
        jy = jx * 2
    with tag.no_grad():
        ty = tx * 2
    assert jy.stop_gradient and not ty.requires_grad
    assert tag.is_grad_enabled() and jag.is_grad_enabled()


def test_detach():
    jx, tx = _j([1.0, 2.0]), _t([1.0, 2.0])
    jd, td = jx.detach(), tx.detach()
    assert jd.stop_gradient and not td.requires_grad
    (jd * 2).sum().backward()
    assert jx.grad is None and tx.grad is None


def test_paddle_grad():
    jx, tx = _j([3.0]), _t([3.0])
    (jg,) = jag.grad(jx * jx * jx, jx)
    (tg,) = tag.grad(tx * tx * tx, tx)
    _close(tg, jg)
    assert float(tg[0]) == 27.0
    assert tx.grad is None and jx.grad is None


def test_double_grad():
    jx, tx = _j([2.0]), _t([2.0])
    (jg1,) = jag.grad(jx * jx * jx, jx, create_graph=True)
    (jg2,) = jag.grad(jg1, jx)
    (tg1,) = tag.grad(tx * tx * tx, tx, create_graph=True)
    (tg2,) = tag.grad(tg1, tx)
    _close(tg2, jg2)
    assert float(tg2[0]) == 12.0


def test_retain_graph():
    jx, tx = _j([1.0]), _t([1.0])
    jy, ty = (jx * 2).sum(), (tx * 2).sum()
    jy.backward(retain_graph=True)
    jy.backward()
    tag.backward(ty, retain_graph=True)
    tag.backward(ty)
    _close(tx.grad, jx.grad)


def test_backward_twice_raises():
    for x in (_j([1.0]), _t([1.0])):
        y = (x * x).sum()
        y.backward()
        with pytest.raises(RuntimeError):
            y.backward()


def test_grad_hook():
    seen = {}
    for name, x in (("j", _j([1.0])), ("t", _t([1.0]))):
        seen[name] = []

        def hook(g, name=name):
            seen[name].append(_np(g).copy())
            return g * 2

        h = x.register_hook(hook)
        (x * 3).sum().backward()
        h.remove()
        seen[name + "_grad"] = _np(x.grad)
    np.testing.assert_allclose(seen["t"], seen["j"])
    np.testing.assert_allclose(seen["t_grad"], seen["j_grad"])


def test_multi_output_op():
    a = [[3.0, 1.0], [2.0, 4.0]]
    jx, tx = _j(a), _t(a)
    jv, _ = paddle.topk(jx, k=1, axis=1)
    tv, _ = torch.topk(tx, k=1, dim=1)
    jv.sum().backward()
    tag.backward(tv.sum())
    _close(tx.grad, jx.grad)


def _double(ag, save_hooked=False):
    class Double(ag.PyLayer):
        @staticmethod
        def forward(ctx, a):
            ctx.save_for_backward(a)
            return a * 2

        @staticmethod
        def backward(ctx, grad):
            (a,) = ctx.saved_tensor
            return grad * 2 + a * 0

    return Double


def test_pylayer():
    jx, tx = _j([1.5]), _t([1.5])
    _double(jag).apply(jx).sum().backward()
    _double(tag).apply(tx).sum().backward()
    _close(tx.grad, jx.grad)
    assert float(tx.grad[0]) == 2.0


def test_pylayer_grads_per_diff_input_and_none():
    """``backward`` may return one gradient per input that requires grad;
    a None is zero-filled (the reference's alignment)."""
    def make(ag):
        class Mix(ag.PyLayer):
            @staticmethod
            def forward(ctx, a, b, scale):
                ctx.save_for_backward(a, b)
                return a * b * scale

            @staticmethod
            def backward(ctx, g):
                a, b = ctx.saved_tensor
                return g * b * 3.0, None

        return Mix

    ja, jb = _j([1.0, 2.0]), _j([3.0, 4.0])
    ta, tb = _t([1.0, 2.0]), _t([3.0, 4.0])
    make(jag).apply(ja, jb, 3.0).sum().backward()
    make(tag).apply(ta, tb, 3.0).sum().backward()
    _close(ta.grad, ja.grad)
    _close(tb.grad, jb.grad)
    jc = _j([1.0, 1.0], grad=False)
    tc = _t([1.0, 1.0], grad=False)

    class One(tag.PyLayer):
        @staticmethod
        def forward(ctx, a, c):
            return a * c

        @staticmethod
        def backward(ctx, g):
            return g * 5.0  # one grad: the one input that requires grad

    class JOne(jag.PyLayer):
        forward, backward = One.forward, One.backward

    ta.grad = None
    ja.clear_grad()
    One.apply(ta, tc).sum().backward()
    JOne.apply(ja, jc).sum().backward()
    _close(ta.grad, ja.grad)


def test_saved_tensors_hooks_pack_and_unpack():
    log = {"j": [], "t": []}
    for name, ag, x in (("j", jag, _j([1.0, 2.0])), ("t", tag, _t([1.0, 2.0]))):
        def pack(t, name=name):
            log[name].append("pack")
            return t

        def unpack(t, name=name):
            log[name].append("unpack")
            return t

        with ag.saved_tensors_hooks(pack, unpack):
            y = _double(ag).apply(x)
        y.sum().backward()
        assert float(_np(x.grad)[0]) == 2.0
    assert log["t"].count("pack") >= log["j"].count("pack") == 1
    assert log["t"].count("unpack") >= log["j"].count("unpack") == 1


def test_jacobian_matches_the_reference():
    a = np.array([1.0, -2.0, 0.5], np.float32)
    jx, tx = _j(a), _t(a)
    jj = jag.jacobian(paddle.tanh(jx) * jx, jx)
    tj = tag.jacobian(torch.tanh(tx) * tx, tx)
    assert tuple(tj.shape) == (3, 3)
    _close(tj, jj)
    jw = _j(np.ones((3,), np.float32) * 2)
    tw = _t(np.ones((3,), np.float32) * 2)
    jjs = jag.jacobian([jx * jw, (jx * jw).sum()], [jx, jw])
    tjs = tag.jacobian([tx * tw, (tx * tw).sum()], [tx, tw])
    for jr, tr in zip(jjs, tjs):
        for j, t in zip(jr, tr):
            _close(t, j)


def test_hessian_matches_the_reference():
    a = np.array([1.0, 2.0], np.float32)
    jx, tx = _j(a), _t(a)
    jh = jag.hessian((jx * jx * jx).sum(), jx)
    th = tag.hessian((tx * tx * tx).sum(), tx)
    _close(th, jh)
    _close(th, torch.diag(6 * torch.tensor(a)))
    with pytest.raises(ValueError, match="scalar"):
        tag.hessian(tx * tx, tx)


def test_grad_allow_unused():
    jx, jy = _j([1.0]), _j([2.0])
    tx, ty = _t([1.0]), _t([2.0])
    jg = jag.grad((jx * 3).sum(), [jx, jy], allow_unused=True)
    tg = tag.grad((tx * 3).sum(), [tx, ty], allow_unused=True)
    assert jg[1] is None and tg[1] is None
    _close(tg[0], jg[0])
    with pytest.raises(RuntimeError, match="unused"):
        tag.grad((tx * 3).sum(), [tx, ty])
