"""Port parity: ``paddle_tpu_torch.nn.functional``'s 19 pooling functions and
``paddle_tpu_torch.nn``'s 15 pooling layers against the JAX package's, on the
same signed numpy inputs made from a seed, in f32 at ``ATOL = 1e-5``
(values and input gradients; masks and unpooled maps exactly).

- max and average pools in 1-3 d over every padding form (int, per axis,
  (low, high) pairs, pads wider than half the kernel, ``SAME``,
  ``VALID``), strides and ``ceil_mode`` (whose last window the reference
  keeps where torch's own ``ceil_mode`` would drop it), ``exclusive``
  both ways, channels-last layouts;
- ``divisor_override``, which the reference takes and ignores: held to the
  window sums the reference's ``exclusive=False`` average gives, over the
  divisor;
- ``return_mask`` with ties (the first maximum in the window wins) and the
  ``max_unpool*`` round trips;
- adaptive pools on sizes the output does not divide, ``None`` sizes;
- ``lp_pool``, fractional pools through a shared ``random_u`` (and their
  masks);
- each layer against the reference's layer, and the keywords the port's
  layers pass on against the reference's functionals.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

ATOL = 1e-5


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ties(*shape, seed=0):
    """Signed integer values in [-2, 2]: many ties in every window."""
    return np.random.RandomState(seed).randint(-2, 3, shape).astype(
        np.float32)


def _ref(fn, a, w_seed=7, **kw):
    """The reference's output(s) and the gradient of ``sum(out * w)``."""
    x = paddle.to_tensor(a, stop_gradient=False)
    res = fn(x, **kw)
    out = res[0] if isinstance(res, tuple) else res
    w = _x(*out.shape, seed=w_seed)
    (out * paddle.to_tensor(w)).sum().backward()
    outs = ([np.asarray(r.numpy()) for r in res] if isinstance(res, tuple)
            else [np.asarray(res.numpy())])
    return outs, np.asarray(x.grad.numpy()), w


def _port(fn, a, w, **kw):
    x = torch.tensor(a, requires_grad=True)
    res = fn(x, **kw)
    out = res[0] if isinstance(res, tuple) else res
    (out * torch.from_numpy(w)).sum().backward()
    outs = ([r.detach().numpy() for r in res] if isinstance(res, tuple)
            else [res.detach().numpy()])
    return outs, x.grad.numpy()


def _check(name, a, grad=True, exact=(), **kw):
    """Outputs (``exact`` indices compared exactly) and, with ``grad``,
    the input gradient, port against reference."""
    want, gwant, w = _ref(getattr(JF, name), a, **kw)
    got, ggot = _port(getattr(TF, name), a, w, **kw)
    assert len(got) == len(want)
    for i, (g, r) in enumerate(zip(got, want)):
        assert g.shape == r.shape, (i, g.shape, r.shape)
        if i in exact:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, atol=ATOL, rtol=1e-5)
    if grad:
        np.testing.assert_allclose(ggot, gwant, atol=ATOL, rtol=1e-5)
    return got


POOL_CASES = [
    dict(kernel_size=3, stride=2, padding=1),
    dict(kernel_size=2),
    dict(kernel_size=3, stride=1, padding=0),
    dict(kernel_size=3, stride=2, padding=1, ceil_mode=True),
    dict(kernel_size=2, stride=3, padding=0, ceil_mode=True),
    dict(kernel_size=3, stride=2, padding=2),            # wider than k/2
    dict(kernel_size=4, stride=3, padding=2, ceil_mode=True),
    dict(kernel_size=3, stride=2, padding="SAME"),
    dict(kernel_size=3, stride=2, padding="VALID"),
]
PAD_FORMS_2D = [
    dict(kernel_size=(3, 2), stride=(2, 1), padding=(1, 0)),
    dict(kernel_size=3, stride=2, padding=[0, 1, 2, 1]),   # (lo, hi) per axis
    dict(kernel_size=3, stride=2, padding=[[0, 0], [0, 0], [1, 2], [0, 1]]),
    dict(kernel_size=3, stride=2, padding=[(1, 2), (0, 1)], ceil_mode=True),
]
SHAPES = {1: (2, 3, 11), 2: (2, 3, 9, 8), 3: (1, 2, 7, 6, 5)}


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_max_pool_values_and_gradient(nd, case):
    _check(f"max_pool{nd}d", _x(*SHAPES[nd]), **POOL_CASES[case])


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("case", range(len(POOL_CASES) - 2))
def test_avg_pool_values_and_gradient(nd, exclusive, case):
    # string padding: the reference's average always excludes the pad
    _check(f"avg_pool{nd}d", _x(*SHAPES[nd]), exclusive=exclusive,
           **POOL_CASES[case])


@pytest.mark.parametrize("case", range(len(PAD_FORMS_2D)))
@pytest.mark.parametrize("kind", ["max", "avg_exclusive", "avg"])
def test_2d_padding_forms(case, kind):
    kw = dict(PAD_FORMS_2D[case])
    if kind != "max":
        kw["exclusive"] = kind == "avg_exclusive"
    _check("max_pool2d" if kind == "max" else "avg_pool2d",
           _x(2, 3, 10, 9), **kw)


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("nd", [2, 3])
def test_channels_last(kind, nd):
    fmt = "NHWC" if nd == 2 else "NDHWC"
    shape = (2, 9, 8, 3) if nd == 2 else (1, 7, 6, 5, 2)
    _check(f"{kind}_pool{nd}d", _x(*shape), kernel_size=3, stride=2,
           padding=1, data_format=fmt)


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("divisor", [1, 5])
def test_divisor_override_divides_the_window_sum(nd, divisor):
    a = _x(*SHAPES[nd])
    kw = dict(kernel_size=3, stride=2, padding=1)
    (mean,), _, _ = _ref(getattr(JF, f"avg_pool{nd}d"), a, exclusive=False,
                         **kw)
    got = getattr(TF, f"avg_pool{nd}d")(torch.from_numpy(a),
                                        divisor_override=divisor, **kw)
    np.testing.assert_allclose(got.numpy(), mean * 3 ** nd / divisor,
                               atol=ATOL * 3 ** nd, rtol=1e-5)
    # the explicit-pad path (ceil_mode) holds the same divisor
    got = getattr(TF, f"avg_pool{nd}d")(torch.from_numpy(a), ceil_mode=True,
                                        divisor_override=divisor, **kw)
    (mean,), _, _ = _ref(getattr(JF, f"avg_pool{nd}d"), a, exclusive=False,
                         ceil_mode=True, **kw)
    np.testing.assert_allclose(got.numpy(), mean * 3 ** nd / divisor,
                               atol=ATOL * 3 ** nd, rtol=1e-5)


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("case", [0, 3, 5, 6])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_max_pool_mask_and_unpool_round_trip(nd, case, data):
    a = (_x if data == "random" else _ties)(*SHAPES[nd], seed=nd)
    kw = dict(POOL_CASES[case])
    # the reference's mask is its argmax; gradients split ties differently
    got = _check(f"max_pool{nd}d", a, grad=data == "random", exact=(1,),
                 return_mask=True, **kw)
    out, mask = got
    assert mask.dtype == np.int32
    ukw = dict(kernel_size=kw["kernel_size"], stride=kw.get("stride"),
               output_size=list(a.shape[2:]))
    want = getattr(JF, f"max_unpool{nd}d")(
        paddle.to_tensor(out), paddle.to_tensor(mask), **ukw)
    back = getattr(TF, f"max_unpool{nd}d")(
        torch.from_numpy(out), torch.from_numpy(mask), **ukw)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want.numpy()))
    # every value of a window that holds input sits where it came from (a
    # window wholly in the padding is -inf, its index out of range)
    flat = a.reshape(a.shape[0], a.shape[1], -1)
    idx = mask.reshape(*mask.shape[:2], -1)
    inside = np.isfinite(out.reshape(idx.shape))
    taken = np.take_along_axis(flat, np.where(inside, idx, 0), 2)
    np.testing.assert_array_equal(taken[inside], out.reshape(idx.shape)[inside])


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_unpool_default_output_size(nd):
    a = _x(*SHAPES[nd], seed=3)
    out, mask = getattr(TF, f"max_pool{nd}d")(
        torch.from_numpy(a), 2, 2, return_mask=True)
    want = getattr(JF, f"max_unpool{nd}d")(
        paddle.to_tensor(out.numpy()), paddle.to_tensor(mask.numpy()), 2, 2)
    got = getattr(TF, f"max_unpool{nd}d")(out, mask, 2, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


ADAPTIVE = {1: [5, 3, 4, 1], 2: [(3, 5), (4, 4), 1, (None, 3)],
            3: [(2, 3, 4), 1, (3, None, 2)]}
ADAPTIVE_SHAPES = {1: (2, 3, 11), 2: (2, 3, 10, 7), 3: (1, 2, 7, 5, 6)}


@pytest.mark.parametrize("nd,size", [(nd, s) for nd in ADAPTIVE
                                     for s in ADAPTIVE[nd]])
@pytest.mark.parametrize("kind", ["avg", "max"])
def test_adaptive_pools_on_bins_the_size_does_not_divide(nd, size, kind):
    _check(f"adaptive_{kind}_pool{nd}d", _x(*ADAPTIVE_SHAPES[nd]),
           output_size=size)


@pytest.mark.parametrize("nd", [2, 3])
def test_adaptive_avg_channels_last(nd):
    fmt = "NHWC" if nd == 2 else "NDHWC"
    shape = (2, 10, 7, 3) if nd == 2 else (1, 7, 5, 6, 2)
    _check(f"adaptive_avg_pool{nd}d", _x(*shape), output_size=3,
           data_format=fmt)


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_adaptive_max_mask_is_the_argmax(nd):
    """The reference ignores ``return_mask`` here; the port's mask picks
    each bin's maximum out of the flat input."""
    a = _x(*ADAPTIVE_SHAPES[nd], seed=4)
    out, mask = getattr(TF, f"adaptive_max_pool{nd}d")(
        torch.from_numpy(a), 3, return_mask=True)
    want = getattr(JF, f"adaptive_max_pool{nd}d")(paddle.to_tensor(a), 3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want.numpy()))
    flat = a.reshape(a.shape[0], a.shape[1], -1)
    taken = np.take_along_axis(flat, mask.numpy().reshape(
        *mask.shape[:2], -1), 2)
    np.testing.assert_array_equal(taken, out.numpy().reshape(taken.shape))


@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("p", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("ceil_mode", [False, True])
def test_lp_pool(nd, p, ceil_mode):
    a = _x(*SHAPES[nd]) + 0.1  # off zero: |x|^p's gradient is defined
    _check(f"lp_pool{nd}d", a, norm_type=p, kernel_size=3, stride=2,
           ceil_mode=ceil_mode)


@pytest.mark.parametrize("u", [0.0, 0.3, 0.77])
@pytest.mark.parametrize("nd,size", [(2, 4), (2, (5, 3)), (3, 3),
                                     (3, (2, 4, 3))])
def test_fractional_max_pool_and_mask(nd, size, u):
    a = _x(*((2, 3, 11, 9) if nd == 2 else (1, 2, 7, 9, 6)), seed=5)
    _check(f"fractional_max_pool{nd}d", a, output_size=size, random_u=u,
           return_mask=True, exact=(1,))
    _check(f"fractional_max_pool{nd}d", a, output_size=size, random_u=u)


# -- the layers ---------------------------------------------------------------

LAYERS = [
    ("MaxPool1D", (3, 2, 1, True), (2, 3, 11)),
    ("MaxPool2D", (3, 2, 1), (2, 3, 9, 8)),
    ("MaxPool3D", (2, 2, 0, True), (1, 2, 7, 6, 5)),
    ("AvgPool1D", (3, 2, 1), (2, 3, 11)),
    ("AvgPool2D", (3, 2, 1, True), (2, 3, 9, 8)),
    ("AvgPool3D", (3, 2, 1), (1, 2, 7, 6, 5)),
    ("AdaptiveAvgPool1D", (4,), (2, 3, 11)),
    ("AdaptiveAvgPool2D", ((3, 5),), (2, 3, 10, 7)),
    ("AdaptiveAvgPool3D", (2,), (1, 2, 7, 5, 6)),
    ("AdaptiveMaxPool1D", (4,), (2, 3, 11)),
    ("AdaptiveMaxPool2D", ((3, 5),), (2, 3, 10, 7)),
    ("AdaptiveMaxPool3D", (2,), (1, 2, 7, 5, 6)),
    ("LPPool1D", (2.0, 3, 2), (2, 3, 11)),
    ("LPPool2D", (3.0, 2, 2, 0, True), (2, 3, 9, 8)),
]


@pytest.mark.parametrize("name,args,shape", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_matches_the_reference_layer(name, args, shape):
    a = _x(*shape, seed=6) + 0.05
    want = getattr(jnn, name)(*args)(paddle.to_tensor(a))
    got = getattr(tnn, name)(*args)(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=ATOL, rtol=1e-5)
    assert not list(getattr(tnn, name)(*args).parameters())


def test_max_unpool_layer_matches_the_reference_layer():
    a = _x(2, 3, 9, 8, seed=8)
    out, mask = JF.max_pool2d(paddle.to_tensor(a), 3, 2, 1, return_mask=True)
    want = jnn.MaxUnPool2D(3, 2, 1, output_size=[9, 8])(out, mask)
    got = tnn.MaxUnPool2D(3, 2, 1, output_size=[9, 8])(
        torch.tensor(np.asarray(out.numpy())),
        torch.tensor(np.asarray(mask.numpy())))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


@pytest.mark.parametrize("name,kw,fn", [
    ("MaxPool2D", dict(return_mask=True), "max_pool2d"),
    ("AvgPool2D", dict(exclusive=False), "avg_pool2d"),
    ("MaxPool2D", dict(data_format="NHWC"), "max_pool2d"),
    ("AvgPool1D", dict(exclusive=False), "avg_pool1d"),
])
def test_layer_keywords_reach_the_functional(name, kw, fn):
    """The reference's layers drop these keywords; the port's pass them
    on: held to the reference's functional called with them."""
    a = _x(2, 3, 9, 8, seed=9) if "1" not in name else _x(2, 3, 11, seed=9)
    want = getattr(JF, fn)(paddle.to_tensor(a), 3, 2, 1, **kw)
    got = getattr(tnn, name)(3, 2, 1, **kw)(torch.from_numpy(a))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   atol=ATOL, rtol=1e-5)


def test_every_reference_pooling_name_has_a_port_counterpart():
    import paddle_tpu.nn.functional.pooling as jpool
    import paddle_tpu.nn.layer.pooling as jlayers

    assert len(jpool.__all__) == 19 and len(jlayers.__all__) == 15
    assert all(callable(getattr(TF, n)) for n in jpool.__all__)
    assert all(isinstance(getattr(tnn, n), type) for n in jlayers.__all__)
