"""Port parity: ``paddle_tpu_torch.nn.functional``'s activations, norms,
convolutions and common functionals against the JAX package's, on the same
numpy inputs made from a seed, in f32 at ``ATOL = 1e-4``.

- every activation (with its keyword arguments) and the in-place forms;
- ``layer_norm``, ``group_norm``, ``batch_norm`` (training moves the
  running statistics), ``instance_norm``, ``local_response_norm``, in both
  channel layouts;
- ``conv1d/2d/3d`` and their transposes over strides, every padding form
  (int, per axis, (low, high) pairs, ``SAME``, ``VALID``), dilation,
  groups, output padding and channels-last;
- ``interpolate`` in every mode at up- and down-scales and non-integer
  factors, which hold the reference's ``jax.image.resize`` semantics
  (half-pixel nearest, antialiased downsampling, Keys cubic), and the
  corner-aligned bilinear gather;
- ``linear``, ``pad`` in its four modes, ``embedding``, ``one_hot``,
  ``normalize``, ``cosine_similarity``, ``pairwise_distance``;
- the dropouts, whose draws cannot match across packages: the keep rate
  and the scaling of the kept values, and the identity at ``p = 0`` and in
  eval mode;
- the f32 convolution's precision policy: TF32 off inside the call,
  whatever the global flag.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.nn.functional import conv as tconv

ATOL = 1e-4


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _both(name, *arrays, **kw):
    """(JAX result, port result) of functional ``name`` on ``arrays``."""
    def conv(to):
        return [to(a) if isinstance(a, np.ndarray) else a for a in arrays]

    j = getattr(JF, name)(*conv(paddle.to_tensor), **kw)
    t = getattr(TF, name)(*conv(torch.from_numpy), **kw)
    return np.asarray(j.numpy()), t.detach().numpy()


def _check(name, *arrays, atol=ATOL, **kw):
    want, got = _both(name, *arrays, **kw)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5)


ACTIVATIONS = [
    ("relu", {}), ("relu6", {}), ("sigmoid", {}), ("silu", {}), ("swish", {}),
    ("tanh", {}), ("softsign", {}), ("log_sigmoid", {}), ("mish", {}),
    ("tanhshrink", {}), ("elu", {"alpha": 0.7}), ("celu", {"alpha": 1.3}),
    ("selu", {}), ("gelu", {}), ("gelu", {"approximate": True}),
    ("leaky_relu", {"negative_slope": 0.2}), ("hardshrink", {"threshold": 0.4}),
    ("softshrink", {"threshold": 0.3}), ("hardtanh", {"min": -0.5, "max": 2.0}),
    ("hardsigmoid", {}), ("hardswish", {}),
    ("softplus", {"beta": 2.0, "threshold": 3.0}),
    ("thresholded_relu", {"threshold": 0.5, "value": -1.0}),
    ("softmax", {"axis": 1}), ("log_softmax", {"axis": -1}),
    ("glu", {"axis": -1}), ("maxout", {"groups": 2, "axis": 1}),
    ("rrelu", {"training": False}),
]


@pytest.mark.parametrize("name,kw", ACTIVATIONS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(ACTIVATIONS)])
def test_activation_matches(name, kw):
    _check(name, _x(3, 4, 6, scale=3.0), **kw)


@pytest.mark.parametrize("shape,fmt", [((3,), "NCHW"), ((4,), "NCHW"),
                                       ((4,), "NHWC")])
def test_prelu_matches(shape, fmt):
    x = _x(2, 4, 3, 4, scale=2.0)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = np.abs(_x(*shape, seed=1)) if shape != (3,) else np.float32([0.25])
    _check("prelu", x, w, data_format=fmt)


@pytest.mark.parametrize("name,kw", [("relu_", {}), ("tanh_", {}),
                                     ("elu_", {"alpha": 0.5}),
                                     ("hardtanh_", {}), ("leaky_relu_", {}),
                                     ("thresholded_relu_", {}),
                                     ("softmax_", {"axis": 0})])
def test_inplace_activation_writes_its_input(name, kw):
    x = _x(5, 7, scale=2.0)
    t = torch.from_numpy(x.copy())
    out = getattr(TF, name)(t, **kw)
    assert out is t
    want = getattr(TF, name[:-1])(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(t.numpy(), want.numpy())


def test_random_activations_draw_from_the_given_generator():
    x = torch.from_numpy(_x(64, 64, scale=2.0))
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = TF.rrelu(x, training=True, generator=g())
    assert torch.equal(a, TF.rrelu(x, training=True, generator=g()))
    neg = x < 0
    slope = a[neg] / x[neg]
    assert slope.min() >= 1 / 8 - 1e-6 and slope.max() <= 1 / 3 + 1e-6
    assert torch.equal(a[~neg], x[~neg])
    y = TF.gumbel_softmax(x, hard=True, generator=g())
    assert torch.equal(y.sum(-1), torch.ones(64))
    assert set(y.unique().tolist()) == {0.0, 1.0}


# -- norms ---------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_group_norm_matches(fmt):
    x = _x(2, 8, 5, 3, scale=2.0) + 1.0
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w, b = _x(8, seed=1), _x(8, seed=2)
    j = JF.group_norm(paddle.to_tensor(x), 4, 1e-5, paddle.to_tensor(w),
                      paddle.to_tensor(b), data_format=fmt)
    t = TF.group_norm(torch.from_numpy(x), 4, 1e-5, torch.from_numpy(w),
                      torch.from_numpy(b), data_format=fmt)
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), atol=ATOL)


@pytest.mark.parametrize("shape,affine", [((2, 5, 16), True),
                                          ((3, 4, 6), False)])
def test_layer_norm_matches(shape, affine):
    x = _x(*shape, scale=3.0)
    n = shape[-1:] if affine else shape[-2:]
    wb = [_x(*n, seed=1), _x(*n, seed=2)] if affine else [None, None]
    j = JF.layer_norm(paddle.to_tensor(x), list(n),
                      *[None if a is None else paddle.to_tensor(a) for a in wb],
                      epsilon=1e-5)
    t = TF.layer_norm(torch.from_numpy(x), list(n),
                      *[None if a is None else torch.from_numpy(a) for a in wb],
                      epsilon=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), atol=ATOL)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("shape,fmt", [((4, 3, 5, 5), "NCHW"),
                                       ((4, 5, 5, 3), "NHWC"),
                                       ((6, 3), "NC"), ((4, 3, 7), "NCL")])
def test_batch_norm_matches_and_moves_running_stats(shape, fmt, training):
    x = _x(*shape, scale=2.0) + 0.5
    c = shape[-1] if fmt in ("NHWC", "NC") else shape[1]
    rm, rv = _x(c, seed=1), np.abs(_x(c, seed=2)) + 0.5
    w, b = _x(c, seed=3), _x(c, seed=4)
    jm, jv = paddle.to_tensor(rm.copy()), paddle.to_tensor(rv.copy())
    tm, tv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    j = JF.batch_norm(paddle.to_tensor(x), jm, jv, paddle.to_tensor(w),
                      paddle.to_tensor(b), training=training, momentum=0.8,
                      data_format=fmt)
    t = TF.batch_norm(torch.from_numpy(x), tm, tv, torch.from_numpy(w),
                      torch.from_numpy(b), training=training, momentum=0.8,
                      data_format=fmt)
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), atol=ATOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm.numpy()), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv.numpy()), atol=ATOL)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_instance_and_local_response_norms_match(fmt):
    x = _x(2, 6, 5, 4, scale=2.0)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w, b = _x(6, seed=1), _x(6, seed=2)
    j = JF.instance_norm(paddle.to_tensor(x), weight=paddle.to_tensor(w),
                         bias=paddle.to_tensor(b), data_format=fmt)
    t = TF.instance_norm(torch.from_numpy(x), weight=torch.from_numpy(w),
                         bias=torch.from_numpy(b), data_format=fmt)
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), atol=ATOL)
    _check("local_response_norm", x, 3, alpha=0.1, beta=0.75, k=2.0,
           data_format=fmt)


# -- convolutions ------------------------------------------------------------------

CONVS = [
    # (n, x shape, weight shape, kwargs)
    (1, (2, 4, 17), (6, 4, 3), dict(stride=2, padding=1)),
    (1, (2, 4, 17), (6, 2, 5), dict(padding="SAME", dilation=2, groups=2)),
    (2, (2, 4, 11, 9), (6, 4, 3, 3), dict(stride=2, padding=[1, 2])),
    (2, (2, 4, 11, 9), (6, 4, 3, 2), dict(padding=[1, 0, 2, 1])),
    (2, (2, 4, 11, 9), (6, 4, 3, 3), dict(padding=[[0, 0], [0, 0], [2, 0],
                                                   [1, 1]], stride=(1, 2))),
    (2, (2, 4, 11, 9), (8, 1, 3, 3), dict(padding="SAME", stride=2, groups=4)),
    (2, (2, 4, 11, 9), (6, 4, 3, 3), dict(padding="VALID", dilation=(2, 1))),
    (2, (2, 11, 9, 4), (6, 4, 3, 3), dict(padding=1, data_format="NHWC")),
    (3, (1, 2, 6, 7, 5), (4, 2, 3, 3, 2), dict(stride=(1, 2, 1), padding=1)),
]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n,xs,ws,kw", CONVS, ids=[str(i) for i in range(len(CONVS))])
def test_conv_matches(n, xs, ws, kw, bias):
    args = [_x(*xs), _x(*ws, seed=1)] + ([_x(ws[0], seed=2)] if bias else [])
    _check(f"conv{n}d", *args, **kw)


CONV_TS = [
    (1, (2, 4, 9), (4, 3, 3), dict(stride=2, padding=1, output_padding=1)),
    (1, (2, 4, 9), (4, 2, 4), dict(stride=3, groups=2, dilation=2)),
    (2, (2, 4, 7, 6), (4, 5, 3, 3), dict(stride=2, padding=1,
                                         output_padding=1)),
    (2, (2, 4, 7, 6), (4, 3, 4, 4), dict(stride=2, padding=[1, 2, 0, 1])),
    (2, (2, 4, 7, 6), (4, 2, 3, 3), dict(stride=(2, 1), groups=2,
                                         padding=[1, 0, 2, 2])),
    (2, (2, 7, 6, 4), (4, 3, 3, 3), dict(stride=2, padding=1,
                                         data_format="NHWC")),
    (3, (1, 2, 4, 5, 3), (2, 3, 3, 3, 3), dict(stride=2, padding=1)),
]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n,xs,ws,kw", CONV_TS, ids=[str(i) for i in range(len(CONV_TS))])
def test_conv_transpose_matches(n, xs, ws, kw, bias):
    groups = kw.get("groups", 1)
    args = [_x(*xs), _x(*ws, seed=1)]
    if bias:
        args.append(_x(ws[1] * groups, seed=2))
    _check(f"conv{n}d_transpose", *args, **kw)


@pytest.mark.parametrize("pad,kw,explicit", [
    ("SAME", dict(stride=(2, 1), groups=2), [1, 1, 1, 1]),
    ("VALID", dict(stride=2, dilation=2), [4, 4, 2, 2]),
])
def test_string_padded_conv_transpose_matches_its_explicit_padding(
        pad, kw, explicit):
    """The reference's transposed convolution refuses a string padding
    (``lax`` has none for lhs dilation), so the port's ``"SAME"`` (total
    pad ``d (k - 1)``, the smaller half first, as XLA pads a stride-1
    convolution) and ``"VALID"`` are held against the reference at the
    explicit paddle padding they stand for."""
    x = _x(2, 4, 7, 6)
    w = _x(4, 2 if kw.get("groups") else 3, 3, 3 if pad == "SAME" else 2,
           seed=1)
    j = JF.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                            padding=explicit, **kw)
    t = TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                            padding=pad, **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), atol=ATOL)


def test_f32_conv_runs_without_tf32_whatever_the_global_flag(monkeypatch):
    """The policy in the library: inside an f32 convolution on the card
    cuDNN may not take TF32, and the global flag is as it was after."""
    seen = []

    def fake_conv(a, w, *rest):
        seen.append(torch.backends.cudnn.allow_tf32)
        return torch.nn.functional.conv2d(a, w, *rest)

    monkeypatch.setitem(tconv._CONV, 2, fake_conv)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cuda_like = types.SimpleNamespace(dtype=torch.float32,
                                      device=torch.device("cuda"))
    with tconv._precision(cuda_like):
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is True
    x = torch.from_numpy(_x(1, 2, 5, 5))
    TF.conv2d(x, torch.from_numpy(_x(3, 2, 3, 3)))
    assert seen == [True]  # a CPU tensor: the flag is not cuDNN's concern


# -- interpolate ---------------------------------------------------------------

INTERP = [
    # (x shape, kwargs)
    ((2, 3, 6, 5), dict(scale_factor=2, mode="nearest")),
    ((2, 3, 6, 5), dict(size=[9, 7], mode="nearest")),
    ((2, 3, 8, 9), dict(size=[5, 4], mode="nearest")),
    ((2, 3, 6, 5), dict(scale_factor=1.5, mode="nearest")),
    ((2, 3, 6, 5), dict(scale_factor=2, mode="bilinear")),
    ((2, 3, 9, 8), dict(size=[4, 3], mode="bilinear")),
    ((2, 3, 6, 5), dict(scale_factor=[1.7, 0.6], mode="bilinear")),
    ((2, 3, 6, 5), dict(size=[11, 9], mode="bilinear", align_corners=True)),
    ((2, 3, 9, 8), dict(size=[4, 5], mode="bilinear", align_corners=True)),
    ((2, 3, 6, 5), dict(scale_factor=2, mode="bicubic")),
    ((2, 3, 9, 8), dict(size=[5, 3], mode="bicubic")),
    ((2, 3, 8, 8), dict(size=[3, 5], mode="area")),
    ((2, 3, 10), dict(scale_factor=2.5, mode="linear", data_format="NCW")),
    ((2, 3, 10), dict(size=[4], mode="linear", data_format="NCW")),
    ((1, 2, 4, 5, 3), dict(scale_factor=2, mode="trilinear",
                           data_format="NCDHW")),
    ((1, 2, 6, 5, 4), dict(size=[3, 7, 2], mode="nearest",
                           data_format="NCDHW")),
    ((2, 6, 5, 3), dict(scale_factor=2, mode="bilinear", data_format="NHWC")),
    ((2, 6, 5, 3), dict(size=[4, 8], mode="nearest", data_format="NHWC")),
]


@pytest.mark.parametrize("xs,kw", INTERP, ids=[str(i) for i in range(len(INTERP))])
def test_interpolate_matches_the_references_resize(xs, kw):
    _check("interpolate", _x(*xs, scale=2.0), **kw)
    _check("upsample", _x(*xs, scale=2.0), **kw)


def test_nearest_is_half_pixel_not_torchs_nearest():
    """5 -> 7 (and 8 -> 5) pick ``floor((i + 0.5) * in / out)``, which
    torch's ``"nearest"`` (``floor(i * in / out)``) does not."""
    x = torch.arange(5.0).reshape(1, 1, 1, 5)
    got = TF.interpolate(x, size=[1, 7], mode="nearest").flatten().tolist()
    assert got == [0.0, 1.0, 1.0, 2.0, 3.0, 3.0, 4.0]
    torchs = torch.nn.functional.interpolate(x, size=(1, 7), mode="nearest")
    assert torchs.flatten().tolist() != got
    y = torch.arange(8.0).reshape(1, 1, 1, 8)
    got = TF.interpolate(y, size=[1, 5], mode="nearest").flatten().tolist()
    assert got == [0.0, 2.0, 4.0, 5.0, 7.0]


# -- common --------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches(bias):
    args = [_x(3, 4, 5), _x(5, 6, seed=1)] + ([_x(6, seed=2)] if bias else [])
    _check("linear", *args)


PADS = [
    ((2, 3, 5, 4), dict(pad=[1, 2, 0, 3], mode="constant", value=1.5)),
    ((2, 3, 5, 4), dict(pad=[2, 1, 3, 1], mode="reflect")),
    ((2, 3, 5, 4), dict(pad=[4, 5, 1, 2], mode="replicate")),
    ((2, 3, 5, 4), dict(pad=[3, 2, 6, 1], mode="circular")),
    ((2, 3, 5, 4), dict(pad=[1, 1, 2, 0], mode="reflect",
                        data_format="NHWC")),
    ((2, 3, 7), dict(pad=[2, 3], mode="replicate", data_format="NCL")),
    ((2, 3, 4), dict(pad=[0, 1, 1, 0, 2, 2], mode="constant")),
    ((2, 3, 4), dict(pad=[0, 1, 1, 0, 2, 2], mode="constant",
                     pad_from_left_axis=False)),
    ((1, 2, 3, 4, 5), dict(pad=[1, 0, 0, 2, 2, 1], mode="reflect",
                           data_format="NCDHW")),
]


@pytest.mark.parametrize("xs,kw", PADS, ids=[str(i) for i in range(len(PADS))])
def test_pad_matches(xs, kw):
    _check("pad", _x(*xs), **kw)


def test_zeropad_embedding_one_hot_and_distances_match():
    x = _x(2, 3, 4, 5)
    _check("zeropad2d", x, [1, 2, 0, 1])
    ids = np.random.RandomState(0).randint(0, 10, (3, 4))
    w = _x(10, 6)
    for pidx in (None, 2, -1):
        j = JF.embedding(paddle.to_tensor(ids), paddle.to_tensor(w),
                         padding_idx=pidx)
        t = TF.embedding(torch.from_numpy(ids), torch.from_numpy(w),
                         padding_idx=pidx)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
    j = JF.one_hot(paddle.to_tensor(ids), 12)
    t = TF.one_hot(torch.from_numpy(ids), 12)
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
    a, b = _x(4, 7), _x(4, 7, seed=1)
    _check("normalize", a, p=2, axis=1)
    _check("normalize", a, p=3, axis=0)
    _check("cosine_similarity", a, b, axis=1)
    _check("pairwise_distance", a, b)
    _check("pairwise_distance", a, b, p=1.0, keepdim=True)


# -- dropout ---------------------------------------------------------------------------

def _gen():
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.8])
def test_dropout_keep_rate_and_scaling(p):
    x = torch.full((256, 256), 2.0)
    y = TF.dropout(x, p, generator=_gen())
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0 / (1 - p)))
    y = TF.dropout(x, p, mode="downscale_in_infer", generator=_gen())
    assert set(y.unique().tolist()) <= {0.0, 2.0}
    torch.testing.assert_close(TF.dropout(x, p, training=False,
                                          mode="downscale_in_infer"),
                               x * (1 - p))
    y = TF.dropout(x, p, axis=1, generator=_gen())
    assert bool((y == y[:1]).all())  # one draw a column


def test_dropout_identity_cases():
    x = torch.from_numpy(_x(2, 3, 4, 4))
    for fn in (TF.dropout, TF.dropout2d, TF.alpha_dropout):
        assert torch.equal(fn(x, 0.0), x)
        assert torch.equal(fn(x, 0.5, training=False), x)
    assert torch.equal(TF.dropout3d(x[None], 0.5, training=False), x[None])
    assert torch.equal(TF.dropout(x, 1.0), torch.zeros_like(x))
    j = JF.dropout(paddle.to_tensor(x.numpy()), 0.0)
    np.testing.assert_array_equal(np.asarray(j.numpy()), x.numpy())


def test_dropout2d_drops_whole_channels_and_alpha_dropout_keeps_moments():
    x = torch.ones(64, 32, 4, 4)
    y = TF.dropout2d(x, 0.5, generator=_gen())
    per_channel = y.reshape(64, 32, -1)
    assert bool((per_channel == per_channel[..., :1]).all())
    assert abs((per_channel[..., 0] != 0).float().mean().item() - 0.5) < 0.03
    z = torch.randn(512, 512, generator=_gen())
    a = TF.alpha_dropout(z, 0.3, generator=torch.Generator().manual_seed(1))
    assert abs(a.mean().item()) < 0.02 and abs(a.std().item() - 1.0) < 0.02
