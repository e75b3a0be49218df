"""Port parity: ``paddle_tpu_torch.nn``'s initializers, containers and
layers against the JAX package's, in f32 at ``ATOL = 1e-4``.

- initializers: fans and gains exactly (``_compute_fans``,
  ``calculate_gain``, each bound and standard deviation), and the moments
  and bounds of each draw, which cannot match the reference's stream;
  ``Assign``, ``Dirac``, ``Bilinear`` and ``Orthogonal`` exactly or by
  their defining property; ``set_global_initializer`` reaching the layers'
  defaults;
- containers: ``Sequential``, ``LayerList``, ``ParameterList`` and
  ``LayerDict`` with the reference's names and methods;
- every activation, norm, convolution and common layer against the
  reference's layer with the same weights (``load_jax_params``) and
  buffers (``load_jax_buffers``), in training and eval mode where they
  differ.
"""
import collections
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.initializer as JI
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.initializer as TI
from paddle_tpu_torch.utils import load_jax_buffers, load_jax_params

ATOL = 1e-4
CPU = dict(device="cpu")


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# -- initializers -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(), (7,), (5, 9), (8, 3, 3, 3),
                                   (4, 6, 2, 3, 5)])
def test_fans_equal_the_references(shape):
    from paddle_tpu.nn.initializer import _compute_fans as jfans
    from paddle_tpu_torch.nn.initializer import _compute_fans as tfans

    assert tfans(shape) == jfans(shape)


@pytest.mark.parametrize("name,param", [
    ("sigmoid", None), ("linear", None), ("conv2d", None),
    ("conv3d_transpose", None), ("tanh", None), ("relu", None),
    ("leaky_relu", None), ("leaky_relu", 0.2), ("selu", None)])
def test_gains_equal_the_references(name, param):
    assert TI.calculate_gain(name, param) == JI.calculate_gain(name, param)


def test_unknown_gain_raises():
    with pytest.raises(ValueError):
        TI.calculate_gain("swish")


def _moments(t):
    t = t.double()
    return t.mean().item(), t.std().item(), t.min().item(), t.max().item()


DRAWS = [
    # (initializer, shape, mean, std, low, high)
    (TI.Normal(0.5, 2.0), (256, 256), 0.5, 2.0, None, None),
    (TI.Uniform(-0.3, 0.7), (256, 256), 0.2, 1.0 / math.sqrt(12), -0.3, 0.7),
    (TI.XavierNormal(), (300, 500), 0.0, math.sqrt(2.0 / 800), None, None),
    (TI.XavierUniform(gain=2.0), (300, 500), 0.0,
     2.0 * math.sqrt(6.0 / 800) / math.sqrt(3), -2.0 * math.sqrt(6.0 / 800),
     2.0 * math.sqrt(6.0 / 800)),
    (TI.XavierUniform(fan_in=10, fan_out=30), (64, 64), 0.0,
     math.sqrt(6.0 / 40) / math.sqrt(3), -math.sqrt(6.0 / 40),
     math.sqrt(6.0 / 40)),
    (TI.KaimingNormal(), (64, 32, 3, 3), 0.0, math.sqrt(2.0) / math.sqrt(288),
     None, None),
    (TI.KaimingUniform(negative_slope=0.1, nonlinearity="leaky_relu"),
     (128, 64, 3, 3), 0.0,
     math.sqrt(2.0 / 1.01) * math.sqrt(3.0 / 576) / math.sqrt(3),
     -math.sqrt(2.0 / 1.01) * math.sqrt(3.0 / 576),
     math.sqrt(2.0 / 1.01) * math.sqrt(3.0 / 576)),
    (TI.TruncatedNormal(1.0, 0.5, -1.0, 1.5), (256, 256), None, None, 0.5,
     1.75),
]


@pytest.mark.parametrize("init,shape,mean,std,low,high", DRAWS,
                         ids=[type(d[0]).__name__ + str(i)
                              for i, d in enumerate(DRAWS)])
def test_draws_have_the_references_moments_and_bounds(init, shape, mean, std,
                                                      low, high):
    t = init(shape, "float32", device="cpu", generator=_gen())
    assert tuple(t.shape) == shape and t.dtype == torch.float32
    m, s, lo, hi = _moments(t)
    n = t.numel()
    if mean is not None:
        assert abs(m - mean) < 6 * std / math.sqrt(n) + 1e-12
        assert abs(s - std) < 0.02 * std
    if low is not None:
        assert lo >= low - 1e-6 and hi <= high + 1e-6
    # the reference draws the same distribution
    j = np.asarray(_jax_twin(init)(list(shape)))
    jm, js = float(j.mean()), float(j.std())
    assert abs(jm - m) < 8 * (js + 1e-12) / math.sqrt(n)
    assert abs(js - s) < 0.03 * js
    # one generator, one draw
    assert torch.equal(t, init(shape, "float32", device="cpu",
                               generator=_gen()))


def _jax_twin(init):
    """The reference initializer with ``init``'s arguments."""
    d = {k: v for k, v in vars(init).items()}
    return getattr(JI, type(init).__name__)(**d)


def test_truncated_normal_tail_cut():
    t = TI.TruncatedNormal(0.0, 1.0, -2.0, 2.0)((1 << 16,), device="cpu",
                                              generator=_gen())
    assert t.abs().max() <= 2.0 and abs(t.std().item() - 0.8796) < 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_constant_assign_and_dtypes(dtype):
    c = TI.Constant(3.0)([2, 3], dtype, device="cpu")
    assert c.dtype == getattr(torch, dtype) and bool((c == 3).all())
    v = np.arange(6, dtype=np.float32).reshape(2, 3)
    a = TI.Assign(v)([3, 2], dtype, device="cpu")
    j = np.asarray(JI.Assign(v)([3, 2], dtype).astype(np.float32))
    np.testing.assert_array_equal(a.float().numpy(), j)


@pytest.mark.parametrize("shape,groups", [((6, 6, 3, 3), 1),
                                          ((8, 2, 5), 2), ((4, 4, 3, 1, 3), 1)])
def test_dirac_equals_the_references(shape, groups):
    t = TI.Dirac(groups)(shape, device="cpu")
    np.testing.assert_array_equal(t.numpy(),
                                  np.asarray(JI.Dirac(groups)(shape)))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_bilinear_equals_the_references(k):
    shape = (3, 2, k, k)
    np.testing.assert_allclose(TI.Bilinear()(shape, device="cpu").numpy(),
                               np.asarray(JI.Bilinear()(shape)), atol=1e-7)


@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (4, 3, 2, 2)])
def test_orthogonal_rows_or_columns_are_orthonormal(shape):
    w = TI.Orthogonal(gain=1.5)(shape, device="cpu", generator=_gen())
    m = w.reshape(shape[0], -1).double() / 1.5
    small = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
    torch.testing.assert_close(small, torch.eye(small.shape[0],
                                                dtype=torch.float64),
                               atol=1e-5, rtol=0)


def test_global_initializer_reaches_layer_defaults():
    try:
        TI.set_global_initializer(TI.Constant(0.25), TI.Constant(-1.0))
        lin = tnn.Linear(3, 4, device="cpu", dtype=torch.float32)
        conv_t = tnn.Conv2DTranspose(2, 3, 3, **CPU)
        gn = tnn.GroupNorm(2, 4, **CPU)
        assert bool((lin.weight == 0.25).all() and (lin.bias == -1).all())
        assert bool((conv_t.weight == 0.25).all())
        # a convolution's default weight init is its own, not the global
        assert not bool((tnn.Conv2D(2, 3, 3, **CPU).weight == 0.25).all())
        assert bool((gn.weight == 1).all() and (gn.bias == -1).all())
    finally:
        TI.set_global_initializer(None, None)
    lin = tnn.Linear(300, 500, device="cpu", dtype=torch.float32,
                     generator=_gen())
    limit = math.sqrt(6.0 / 800)
    assert lin.weight.abs().max() <= limit and bool((lin.bias == 0).all())


def test_linear_draws_as_before_the_initializers():
    """``Linear``'s weights through ``XavierUniform`` are the draw it made
    with ``uniform_`` itself, so seeded models keep their weights."""
    lin = tnn.Linear(64, 96, device="cpu", dtype=torch.bfloat16,
                     generator=_gen(5))
    w = torch.empty(64, 96, dtype=torch.bfloat16)
    limit = math.sqrt(6.0 / 160)
    w.uniform_(-limit, limit, generator=_gen(5))
    assert torch.equal(lin.weight.detach(), w)


def test_conv_default_init_is_kaiming_like():
    conv = tnn.Conv2D(64, 32, 3, generator=_gen(), **CPU)
    std = math.sqrt(2.0 / (9 * 64))
    assert abs(conv.weight.std().item() - std) < 0.03 * std
    assert bool((conv.bias == 0).all())
    assert conv.weight.is_distributed is False


# -- containers --------------------------------------------------------------------

def _lin(i, o):
    return tnn.Linear(i, o, device="cpu", dtype=torch.float32)


def test_sequential_names_and_forms():
    s = tnn.Sequential(_lin(2, 3), tnn.ReLU(), _lin(3, 1))
    j = jnn.Sequential(jnn.Linear(2, 3), jnn.ReLU(), jnn.Linear(3, 1))
    assert [n for n, _ in s.named_parameters()] == \
        [n for n, _ in j.named_parameters()]
    load_jax_params(s, {n: np.asarray(p._data)
                        for n, p in j.named_parameters()})
    x = _x(4, 2)
    np.testing.assert_allclose(s(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(j(paddle.to_tensor(x)).numpy()),
                               atol=ATOL)
    assert len(s) == 3 and isinstance(s[1], tnn.ReLU)
    assert isinstance(s[1:], tnn.Sequential) and len(s[1:]) == 2
    named = tnn.Sequential(("a", _lin(2, 2)), ("b", tnn.Tanh()))
    assert list(dict(named.named_children())) == ["a", "b"]
    od = tnn.Sequential(collections.OrderedDict([("x", tnn.Identity())]))
    assert list(dict(od.named_children())) == ["x"]


def test_layer_list_parameter_list_and_layer_dict():
    ll = tnn.LayerList([_lin(2, 2), _lin(2, 3)])
    assert ll.append(_lin(3, 4)) is ll and len(ll) == 3
    ll.insert(1, tnn.Identity())
    assert isinstance(ll[1], tnn.Identity) and ll[-1].out_features == 4
    assert ll.extend([tnn.Tanh()]) is ll and len(ll) == 5
    assert [n for n, _ in ll.named_parameters()][:2] == ["0.weight", "0.bias"]
    with_none = tnn.LayerList([_lin(2, 2), None, _lin(2, 2)])
    assert [n for n, _ in with_none.named_parameters()] == \
        ["0.weight", "0.bias", "2.weight", "2.bias"] and with_none[1] is None
    pl = tnn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    pl.append(torch.nn.Parameter(torch.zeros(3)))
    assert len(pl) == 2 and [n for n, _ in pl.named_parameters()] == ["0", "1"]
    ld = tnn.LayerDict({"a": _lin(2, 2)})
    ld["b"] = tnn.ReLU()
    assert "b" in ld and list(ld.keys()) == ["a", "b"] and len(ld) == 2
    assert isinstance(ld.pop("b"), tnn.ReLU) and len(ld) == 1
    ld.update({"c": tnn.Tanh()})
    assert list(ld) == ["a", "c"]
    ld.clear()
    assert len(ld) == 0


# -- layers against the reference's --------------------------------------------------

def _carry(j, t):
    load_jax_params(t, {n: np.asarray(p._data) for n, p in j.named_parameters()})
    bufs = {n: np.asarray(b._data) for n, b in j.named_buffers()}
    if bufs:
        load_jax_buffers(t, bufs)


def _run_pair(j, t, *arrays):
    jo = j(*[paddle.to_tensor(a) for a in arrays])
    to = t(*[torch.from_numpy(a) for a in arrays])
    return np.asarray(jo.numpy()), to.detach().numpy()


ACT_LAYERS = [("ReLU", ()), ("ReLU6", ()), ("Sigmoid", ()), ("Silu", ()),
              ("Swish", ()), ("Tanh", ()), ("Softsign", ()),
              ("LogSigmoid", ()), ("Mish", ()), ("Tanhshrink", ()),
              ("Hardswish", ()), ("Hardsigmoid", ()), ("GELU", (True,)),
              ("ELU", (0.5,)), ("CELU", (1.5,)), ("SELU", ()),
              ("LeakyReLU", (0.3,)), ("Hardshrink", (0.2,)),
              ("Softshrink", (0.4,)), ("Hardtanh", (-2.0, 0.5)),
              ("Softplus", (1.5, 4.0)), ("ThresholdedReLU", (0.3,)),
              ("Softmax", (1,)), ("LogSoftmax", (0,)), ("GLU", (1,)),
              ("Maxout", (2, 1)), ("RReLU", ())]


@pytest.mark.parametrize("name,args", ACT_LAYERS,
                         ids=[a[0] for a in ACT_LAYERS])
def test_activation_layer_matches(name, args):
    j, t = getattr(jnn, name)(*args), getattr(tnn, name)(*args)
    j.eval()
    t.eval()
    want, got = _run_pair(j, t, _x(3, 4, 6, scale=3.0))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_prelu_layer_matches():
    j = jnn.PReLU(4, init=0.1)
    t = tnn.PReLU(4, init=0.1, **CPU)
    assert t.weight.shape == (4,) and bool((t.weight == 0.1).all())
    _carry(j, t)
    want, got = _run_pair(j, t, _x(2, 4, 3, 3, scale=2.0))
    np.testing.assert_allclose(got, want, atol=ATOL)


NORM_LAYERS = [
    ("LayerNorm", ([6],), dict(epsilon=1e-6), (2, 3, 6)),
    ("LayerNorm", ([3, 6],), dict(weight_attr=False, bias_attr=False),
     (2, 3, 6)),
    ("GroupNorm", (2, 6), {}, (2, 6, 4, 3)),
    ("GroupNorm", (3, 6), dict(data_format="NHWC"), (2, 4, 3, 6)),
    ("BatchNorm", (6,), dict(momentum=0.5), (4, 6, 3, 3)),
    ("BatchNorm1D", (6,), {}, (4, 6, 5)),
    ("BatchNorm2D", (6,), dict(data_format="NHWC"), (4, 3, 3, 6)),
    ("BatchNorm3D", (6,), {}, (2, 6, 2, 3, 2)),
    ("InstanceNorm1D", (6,), {}, (2, 6, 5)),
    ("InstanceNorm2D", (6,), dict(weight_attr=False), (2, 6, 4, 4)),
    ("InstanceNorm3D", (6,), {}, (2, 6, 2, 3, 3)),
    ("LocalResponseNorm", (5,), dict(alpha=0.2, k=1.5), (2, 6, 3, 3)),
]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name,args,kw,xs", NORM_LAYERS,
                         ids=[f"{n[0]}{i}" for i, n in enumerate(NORM_LAYERS)])
def test_norm_layer_matches(name, args, kw, xs, train):
    j = getattr(jnn, name)(*args, **kw)
    extra = CPU if name != "LocalResponseNorm" else {}
    t = getattr(tnn, name)(*args, **kw, **extra)
    for m in (j, t):
        m.train() if train else m.eval()
    # non-trivial weights and running statistics
    for i, (n, p) in enumerate(j.named_parameters()):
        p.set_value(paddle.to_tensor(_x(*p.shape, seed=i + 1)))
    if name.startswith("BatchNorm"):
        j._mean.set_value(paddle.to_tensor(_x(6, seed=7)))
        j._variance.set_value(paddle.to_tensor(np.abs(_x(6, seed=8)) + 0.5))
    _carry(j, t)
    want, got = _run_pair(j, t, _x(*xs, scale=2.0) + 0.3)
    np.testing.assert_allclose(got, want, atol=ATOL)
    for (n, jb), (m, tb) in zip(j.named_buffers(), t.named_buffers()):
        assert n == m
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb._data),
                                   atol=ATOL)


CONV_LAYERS = [
    ("Conv1D", (4, 6, 3), dict(stride=2, padding=1), (2, 4, 11)),
    ("Conv2D", (4, 6, 3), dict(padding="SAME", dilation=2, groups=2),
     (2, 4, 9, 8)),
    ("Conv2D", (4, 6, (3, 1)), dict(padding=[1, 0], data_format="NHWC",
                                    bias_attr=False), (2, 9, 8, 4)),
    ("Conv3D", (2, 4, 3), dict(padding=1, stride=(1, 2, 2)),
     (1, 2, 5, 6, 6)),
    ("Conv1DTranspose", (4, 6, 3), dict(stride=2, padding=1,
                                        output_padding=1), (2, 4, 7)),
    ("Conv2DTranspose", (4, 6, 4), dict(stride=2, padding=1, groups=2),
     (2, 4, 5, 6)),
    ("Conv3DTranspose", (2, 3, 3), dict(stride=2), (1, 2, 3, 4, 3)),
]


@pytest.mark.parametrize("name,args,kw,xs", CONV_LAYERS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CONV_LAYERS)])
def test_conv_layer_matches(name, args, kw, xs):
    j = getattr(jnn, name)(*args, **kw)
    t = getattr(tnn, name)(*args, **kw, **CPU)
    assert {n: tuple(p.shape) for n, p in t.named_parameters()} == \
        {n: tuple(p.shape) for n, p in j.named_parameters()}
    _carry(j, t)
    want, got = _run_pair(j, t, _x(*xs))
    np.testing.assert_allclose(got, want, atol=ATOL)


COMMON_LAYERS = [
    ("Identity", (), (3, 4)),
    ("Flatten", (), (2, 3, 4, 5)),
    ("Flatten", (2, 3), (2, 3, 4, 5)),
    ("Pad1D", ([1, 2], "reflect"), (2, 3, 6)),
    ("Pad2D", (1, "replicate"), (2, 3, 4, 5)),
    ("Pad3D", ([1, 0, 0, 1, 2, 1], "constant", 0.5), (1, 2, 3, 4, 3)),
    ("ZeroPad2D", ([0, 1, 2, 0],), (2, 3, 4, 5)),
    ("Upsample", (None, 2, "bilinear"), (2, 3, 4, 5)),
    ("Upsample", ([3, 7], None, "nearest"), (2, 3, 4, 5)),
    ("UpsamplingNearest2D", (None, 2), (2, 3, 4, 5)),
    ("UpsamplingBilinear2D", ([7, 9],), (2, 3, 4, 5)),
    ("Dropout", (0.5,), (4, 5)),
    ("Dropout2D", (0.5,), (2, 3, 4, 4)),
    ("Dropout3D", (0.5,), (2, 3, 2, 4, 4)),
    ("AlphaDropout", (0.5,), (4, 5)),
]


@pytest.mark.parametrize("name,args,xs", COMMON_LAYERS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(COMMON_LAYERS)])
def test_common_layer_matches_in_eval_mode(name, args, xs):
    j, t = getattr(jnn, name)(*args), getattr(tnn, name)(*args)
    j.eval()
    t.eval()
    want, got = _run_pair(j, t, _x(*xs))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_distance_layers_match():
    a, b = _x(5, 8), _x(5, 8, seed=1)
    for name, args in (("CosineSimilarity", (1, 1e-8)),
                       ("PairwiseDistance", (3.0, 1e-6, True))):
        want, got = _run_pair(getattr(jnn, name)(*args),
                              getattr(tnn, name)(*args), a, b)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_dropout_layer_trains_and_evaluates():
    d = tnn.Dropout(0.25)
    x = torch.ones(200, 200)
    y = d(x)
    assert abs((y == 0).float().mean().item() - 0.25) < 0.01
    d.eval()
    assert torch.equal(d(x), x)
