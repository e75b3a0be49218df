"""Port parity: ``paddle_tpu_torch.nn.quant`` and ``paddle_tpu_torch.quantization``
against ``paddle_tpu.nn.quant`` and ``paddle_tpu.quantization`` (the cases of
``tests/test_quant_exec.py`` but ``TestFP8Gemm``, and the quantization cases
of ``tests/test_quant_geo_audio.py``, on both packages).

- ``weight_quantize``: int8 values and scales, packed int4 bytes and their
  scales (per channel and group-wise) bitwise; the unpack and dequant too.
- ``int8_dynamic_matmul``: the int32 accumulation bitwise (integer sums are
  exact), the rescaled output bitwise without outliers and within 1e-6 of
  the norm with the llm.int8 split (its small float matmul sums in another
  order). ``jax.lax.top_k`` and ``torch.topk`` may break ties differently,
  so the split is held on inputs whose column maxima have no ties.
- ``llm_int8_linear`` and ``weight_only_linear`` against the reference to
  1e-6, the straight-through gradient too.
- QAT/PTQ: fake-quant values bitwise, the quanter's state bitwise, a QAT
  training run's losses and folded weights within 1e-5, PTQ's folded
  weights and int8 conversions bitwise.
- ``generate`` greedy tokens of converted tiny models (int8 execution,
  int8 and int4 weight-only) equal to the reference's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import quantization as jquant
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models.generation import generate as jgenerate
from paddle_tpu.nn import quant as jq
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import quantization as tquant
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, generate
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.quantization import observers as tobs
from paddle_tpu_torch.utils import load_jax_buffers, load_jax_params

# float results against the reference where an f32 matmul sums in another
# order
REL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np(t):
    return (np.array(t._data) if hasattr(t, "_data")
            else t.detach().numpy())


ALGOS = {"int8": ("weight_only_int8", -1), "llm.int8": ("llm.int8", -1),
         "int4": ("weight_only_int4", -1), "int4_g64": ("weight_only_int4", 64),
         "int4_g128": ("weight_only_int4", 128)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", list(ALGOS))
def test_weight_quantize_bitwise(algo, dtype):
    name, gs = ALGOS[algo]
    rng = np.random.RandomState(0)
    w = rng.randn(256, 24).astype(np.float32)
    w[3] *= 40  # an outlier row
    jw = paddle.to_tensor(w).astype(dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jqw, js = jq.weight_quantize(jw, algo=name, group_size=gs)
    tqw, ts = tq.weight_quantize(tw, algo=name, group_size=gs)
    assert tqw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqw.numpy(), _np(jqw))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    wd = "int4" if "int4" in name else "int8"
    if wd == "int4":
        np.testing.assert_array_equal(tq._unpack_int4(tqw).numpy(),
                                      np.asarray(jq._unpack_int4(jqw._data)))
    np.testing.assert_array_equal(
        tq._dequant_weight(tqw, ts, wd, gs, torch.float32).numpy(),
        np.asarray(jq._dequant_weight(jqw._data, js._data, wd, gs,
                                      jnp.float32)))
    if gs == -1:
        np.testing.assert_array_equal(
            tq.weight_dequantize(tqw, ts, algo=name,
                                 out_dtype="float32").numpy(),
            _np(jq.weight_dequantize(jqw, js, algo=name,
                                     out_dtype="float32")))


def test_weight_quantize_rejects_as_the_reference():
    z = torch.zeros(7, 4)
    with pytest.raises(ValueError, match="even"):
        tq.weight_quantize(z, algo="weight_only_int4")
    with pytest.raises(ValueError, match="unsupported algo"):
        tq.weight_quantize(z, algo="int2")
    with pytest.raises(ValueError, match="group_size supports"):
        tq.weight_quantize(torch.zeros(8, 4), algo="weight_only_int4",
                           group_size=32)
    with pytest.raises(ValueError, match="must divide"):
        tq.weight_quantize(torch.zeros(96, 4), algo="weight_only_int4",
                           group_size=64)


def _tie_free(rng, m, k):
    """Activations whose column abs-maxima are distinct (top_k tie-free),
    one strong outlier column and a few above a 6.0 threshold."""
    a = rng.randn(m, k).astype(np.float32)
    a[0] = np.linspace(0.5, 3.0, k) * rng.choice([-1, 1], k)
    a[:, 7] = 80.0
    a[1, 11] = -9.5
    a[2, 20] = 7.25
    return a


@pytest.mark.parametrize("threshold", [None, 6.0], ids=["plain", "split"])
@pytest.mark.parametrize("shape", [(4, 32, 16), (3, 30, 40), (2, 3, 64, 24)],
                         ids=["decode", "odd", "3d"])
def test_int8_dynamic_matmul_matches(shape, threshold):
    *lead, k, n = shape
    rng = np.random.RandomState(1)
    w = (rng.randn(k, n) * 0.1).astype(np.float32)
    a = _tie_free(rng, int(np.prod(lead)), k).reshape(*lead, k)
    jqw, js = jq.weight_quantize(paddle.to_tensor(w))
    tqw, ts = tq.weight_quantize(torch.from_numpy(w))
    # the int32 accumulation, bitwise
    qa_t, sc_t = tq._quantize_rows(torch.from_numpy(a).reshape(-1, k))
    acc_t = tq._int8_mm(qa_t, tqw)
    acc_j = jax.lax.dot_general(
        jnp.asarray(qa_t.numpy()), jqw._data, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    want = np.asarray(jq.int8_dynamic_matmul(
        jnp.asarray(a), jqw._data, js._data, outlier_threshold=threshold))
    got = tq.int8_dynamic_matmul(torch.from_numpy(a), tqw, ts,
                                 outlier_threshold=threshold).numpy()
    assert got.shape == want.shape
    if threshold is None:
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) < REL


def test_int8_padding_equals_unpadded():
    """Zero rows, depth and width padded around an int8 product leave its
    values bitwise as they are."""
    rng = np.random.RandomState(2)
    qa = torch.from_numpy(rng.randint(-127, 128, (3, 30)).astype(np.int8))
    qw = torch.from_numpy(rng.randint(-127, 128, (30, 36)).astype(np.int8))
    want = qa.int() @ qw.int()
    got = tq._int8_mm(qa, qw)
    assert tuple(got.shape) == (3, 36)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    big = tq._int8_mm(tq._pad_to(qa, 24, 40), tq._pad_to(qw, 40, 48))
    np.testing.assert_array_equal(big[:3, :36].numpy(), want.numpy())
    assert not big[3:].any() and not big[:, 36:].any()


def _llm_pair(k, n, seed, bias=False):
    rng = np.random.RandomState(seed)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    b = rng.randn(n).astype(np.float32) if bias else None
    jqw, js = jq.weight_quantize(paddle.to_tensor(w))
    tqw, ts = tq.weight_quantize(torch.from_numpy(w))
    return rng, w, b, (jqw, js), (tqw, ts)


@pytest.mark.parametrize("threshold", [None, 6.0, 1e9],
                         ids=["none", "split", "nosplit"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_llm_int8_linear_matches(bias, threshold):
    rng, w, b, (jqw, js), (tqw, ts) = _llm_pair(64, 32, 1, bias)
    x = _tie_free(rng, 8, 64)
    jb = paddle.to_tensor(b) if bias else None
    tb = torch.from_numpy(b) if bias else None
    want = _np(jq.llm_int8_linear(paddle.to_tensor(x), jqw, bias=jb,
                                  weight_scale=js, threshold=threshold))
    got = tq.llm_int8_linear(torch.from_numpy(x), tqw, bias=tb,
                             weight_scale=ts, threshold=threshold).numpy()
    assert _rel(got, want) < REL
    # the reference's gates: close to the float product; the split recovers
    # the outlier column plain int8 loses
    ref = x @ w + (b if bias else 0)
    if threshold == 6.0:
        plain = tq.llm_int8_linear(torch.from_numpy(x), tqw, bias=tb,
                                   weight_scale=ts, threshold=1e9).numpy()
        assert np.abs(got - ref).mean() < np.abs(plain - ref).mean() / 2


def test_llm_int8_accuracy_vs_float():
    rng, w, _, _, (tqw, ts) = _llm_pair(64, 32, 1)
    x = rng.randn(8, 64).astype(np.float32)
    got = tq.llm_int8_linear(torch.from_numpy(x), tqw, weight_scale=ts)
    want = x @ w
    assert np.abs(got.numpy() - want).mean() / np.abs(want).mean() < 0.02


def test_llm_int8_ste_gradient_matches():
    rng, w, _, (jqw, js), (tqw, ts) = _llm_pair(32, 16, 6)
    x = rng.randn(4, 32).astype(np.float32)
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jout = jq.llm_int8_linear(jx, jqw, weight_scale=js)
    jout.sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    tout = tq.llm_int8_linear(tx, tqw, weight_scale=ts)
    tout.sum().backward()
    assert _rel(_np(tout), _np(jout)) < REL
    assert _rel(_np(tx.grad), _np(jx.grad)) < REL
    # straight-through: the float matmul's gradient
    w_deq = tqw.numpy().astype(np.float32) * ts.numpy()
    np.testing.assert_allclose(tx.grad.numpy(), np.broadcast_to(
        w_deq.sum(axis=1), x.shape), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("wd,gs", [("int4", -1), ("int4", 64),
                                   ("int4", 128), ("int8", -1)])
def test_weight_only_linear_matches(wd, gs):
    rng = np.random.RandomState(1)
    w = rng.randn(128, 12).astype(np.float32)
    x = rng.randn(5, 128).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    algo = f"weight_only_{wd}"
    jqw, js = jq.weight_quantize(paddle.to_tensor(w), algo=algo,
                                 group_size=gs)
    tqw, ts = tq.weight_quantize(torch.from_numpy(w), algo=algo,
                                 group_size=gs)
    want = _np(jq.weight_only_linear(paddle.to_tensor(x), jqw,
                                     bias=paddle.to_tensor(b),
                                     weight_scale=js, weight_dtype=wd,
                                     group_size=gs))
    got = tq.weight_only_linear(torch.from_numpy(x), tqw,
                                bias=torch.from_numpy(b), weight_scale=ts,
                                weight_dtype=wd, group_size=gs).numpy()
    assert _rel(got, want) < REL


def test_groupwise_beats_per_channel_on_outliers():
    rng = np.random.RandomState(2)
    w = rng.randn(128, 8).astype(np.float32)
    w[0, :] *= 50
    errs = {}
    for gs in (-1, 64):
        q, s = tq.weight_quantize(torch.from_numpy(w),
                                  algo="weight_only_int4", group_size=gs)
        wd = tq._dequant_weight(q, s, "int4", gs, torch.float32).numpy()
        errs[gs] = np.abs(wd[64:] - w[64:]).mean()
    assert errs[64] < 0.2 * errs[-1], errs


def _seq_pair(sizes, act, seed=0):
    paddle.seed(seed)
    jl = []
    tl = []
    for i, (k, n) in enumerate(sizes):
        if i:
            jl.append(getattr(jnn, act)())
            tl.append(getattr(torch.nn, act)())
        jl.append(jnn.Linear(k, n))
        tl.append(Linear(k, n, device="cpu", dtype=torch.float32))
    jm, tm = jnn.Sequential(*jl), torch.nn.Sequential(*tl)
    load_jax_params(tm, {n: _np(p) for n, p in jm.named_parameters()})
    return jm, tm


@pytest.mark.parametrize("wd", ["int4", "int8"])
def test_convert_to_weight_only_matches(wd):
    jm, tm = _seq_pair(((64, 32), (32, 8)), "GELU")
    x = np.random.RandomState(3).randn(4, 64).astype(np.float32)
    nj = jq.convert_to_weight_only(jm, weight_dtype=wd)
    nt = tq.convert_to_weight_only(tm, weight_dtype=wd)
    assert nt == nj == 2 and isinstance(tm[0], tq.WeightOnlyLinear)
    for (n1, b1), (n2, b2) in zip(sorted(jm.named_buffers()),
                                  sorted(tm.named_buffers())):
        assert n1 == n2
        np.testing.assert_array_equal(_np(b2), _np(b1))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert _rel(got, _np(jm(paddle.to_tensor(x)))) < 1e-5
    # odd in-dims cannot pack: skipped by both
    jo, to = _seq_pair(((7, 4),), "ReLU")
    assert tq.convert_to_weight_only(to, "int4") == \
        jq.convert_to_weight_only(jo, "int4") == 0


def test_stub_is_identity_until_configured():
    x = torch.arange(4.0)
    assert tq.Stub()(x) is x
    assert torch.equal(tq.Stub(lambda t: t * 2)(x), x * 2)


# -- quantization/ ---------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_values_and_ste_bitwise(bits):
    x = np.concatenate([np.linspace(-1, 1, 9),
                        np.random.RandomState(0).randn(40) * 3]).astype(
        np.float32)
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jy = jquant.fake_quantize_dequantize_abs_max(jx, bit_length=bits)
    jy.sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    ty = tquant.fake_quantize_dequantize_abs_max(tx, bit_length=bits)
    ty.sum().backward()
    np.testing.assert_array_equal(_np(ty), _np(jy))
    np.testing.assert_array_equal(tx.grad.numpy(), np.ones_like(x))  # STE
    # a given scale
    s = np.float32(1.7)
    np.testing.assert_array_equal(
        _np(tquant.fake_quantize_dequantize_abs_max(
            torch.from_numpy(x), bits, scale=torch.tensor(s))),
        _np(jquant.fake_quantize_dequantize_abs_max(
            paddle.to_tensor(x), bits, scale=paddle.to_tensor(s))))


def test_quanter_state_bitwise_and_first_scale_is_absmax():
    jqt = jquant.FakeQuanterWithAbsMaxObserver(moving_rate=0.9)
    tqt = tquant.FakeQuanterWithAbsMaxObserver(moving_rate=0.9)
    jqt.train()
    tqt.train()
    rng = np.random.RandomState(4)
    for i in range(4):
        x = (rng.randn(16) * (i + 1)).astype(np.float32)
        if i == 0:
            x[:3] = [0.5, -2.0, 1.0]
            x[3:] = np.clip(x[3:], -1.9, 1.9)
        np.testing.assert_array_equal(
            _np(tqt(torch.from_numpy(x))), _np(jqt(paddle.to_tensor(x))))
        if i == 0:
            assert float(tqt.scale) == 2.0
        for n in ("scale", "accum", "state"):
            np.testing.assert_array_equal(_np(getattr(tqt, n)),
                                          _np(getattr(jqt, n)))
    # load_jax_buffers carries quanter state by name
    fresh = tquant.FakeQuanterWithAbsMaxObserver()
    load_jax_buffers(fresh, {n: _np(b) for n, b in jqt.named_buffers()})
    for n in ("scale", "accum", "state"):
        assert torch.equal(getattr(fresh, n), getattr(tqt, n))


def test_qat_quantize_train_convert_matches():
    jm, tm = _seq_pair(((8, 16), (16, 2)), "ReLU")
    jcfg = jquant.QuantConfig(activation=jquant.quanter(moving_rate=0.9),
                              weight=jquant.quanter(moving_rate=0.9))
    tcfg = tquant.QuantConfig(activation=tquant.quanter(moving_rate=0.9),
                              weight=tquant.quanter(moving_rate=0.9))
    jqat, tqat = jquant.QAT(jcfg), tquant.QAT(tcfg)
    jm, tm = jqat.quantize(jm), tqat.quantize(tm)
    assert isinstance(tm[0], tquant.QuantedLinear)
    assert isinstance(tm[2], tquant.QuantedLinear)
    assert sorted(n for n, _ in tm.named_parameters()) == \
        sorted(n for n, _ in jm.named_parameters())
    jopt_ = jopt.SGD(learning_rate=0.05, parameters=jm.parameters())
    topt_ = topt.SGD(learning_rate=0.05, parameters=tm.parameters())
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randint(0, 2, (16,))
    jl, tl = [], []
    for _ in range(8):
        loss = jnn.functional.cross_entropy(jm(paddle.to_tensor(x)),
                                            paddle.to_tensor(y))
        loss.backward()
        jopt_.step()
        jopt_.clear_grad()
        jl.append(float(_np(loss)))
        loss = TF.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        topt_.step()
        topt_.clear_grad()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    assert tl[-1] < tl[0]
    # the last forward observes once more in both packages
    jq_out = _np(jm(paddle.to_tensor(x)))
    with torch.no_grad():
        tq_out = tm(torch.from_numpy(x)).numpy()
    assert _rel(tq_out, jq_out) < 1e-5
    jm, tm = jqat.convert(jm), tqat.convert(tm)
    assert isinstance(tm[0], Linear) and isinstance(tm[2], Linear)
    for (n1, p1), (n2, p2) in zip(sorted(jm.named_parameters()),
                                  sorted(tm.named_parameters())):
        assert n1 == n2
        np.testing.assert_allclose(_np(p2), _np(p1), rtol=0, atol=1e-5)
    with torch.no_grad():
        conv = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(conv, tq_out, atol=0.1)


def test_qat_convert_int8_matches():
    jm, tm = _seq_pair(((16, 32), (32, 4)), "ReLU")
    x = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    with torch.no_grad():
        float_out = tm(torch.from_numpy(x)).numpy()
    out = {}
    for name, pkg, m, X in (("j", jquant, jm, paddle.to_tensor(x)),
                            ("t", tquant, tm, torch.from_numpy(x))):
        qat = pkg.QAT(pkg.QuantConfig(activation=pkg.quanter(moving_rate=0.9),
                                      weight=pkg.quanter(moving_rate=0.9)))
        m = qat.quantize(m)
        m(X)  # observe
        m = qat.convert(m, execute_dtype="int8")
        assert isinstance(m[0], pkg.Int8InferenceLinear)
        out[name] = (m, _np(m(X)))
    (jm, jo), (tm, to) = out["j"], out["t"]
    assert tm[0].qweight.dtype == torch.int8
    # column-major: the int8 GEMM's second-operand layout
    assert tm[0].qweight.t().is_contiguous()
    for n in ("qweight", "scale"):
        np.testing.assert_array_equal(_np(getattr(tm[0], n)),
                                      _np(getattr(jm[0], n)))
    assert _rel(to, jo) < REL
    rel = np.abs(to - float_out).mean() / (np.abs(float_out).mean() + 1e-9)
    assert rel < 0.05, rel
    with pytest.raises(ValueError, match="8-bit weight config"):
        tquant.Int8InferenceLinear(
            Linear(4, 4, device="cpu", dtype=torch.float32),
            tquant.FakeQuanterWithAbsMaxObserver(bit_length=4))


def test_ptq_observe_and_convert_matches():
    jm, tm = _seq_pair(((8, 8),), "ReLU", seed=1)
    x = np.random.RandomState(1).randn(2, 8).astype(np.float32)
    res = {}
    for name, pkg, m, X in (("j", jquant, jm, paddle.to_tensor(x)),
                            ("t", tquant, tm, torch.from_numpy(x))):
        ptq = pkg.PTQ(pkg.QuantConfig(activation=None,
                                      weight=pkg.quanter(moving_rate=0.9)))
        m = ptq.quantize(m)
        assert not m.training
        m(X)
        m = ptq.convert(m)
        res[name] = _np(m[0].weight)
    np.testing.assert_array_equal(res["t"], res["j"])
    # the host abs-max observer
    jo, to = jquant.AbsmaxObserver(), tquant.AbsmaxObserver()
    for v in (x, x * 3, x / 2):
        jo(paddle.to_tensor(v))
        to(torch.from_numpy(v))
    assert to.scale() == jo.scale()


def test_groupwise_observer_matches():
    from paddle_tpu.quantization import observers as jobs

    w = np.random.RandomState(5).randn(256, 12).astype(np.float32)
    for gs in (64, 128):
        jo = jobs.GroupWiseWeightObserver(quant_bits=4, group_size=gs)
        to = tobs.GroupWiseWeightObserver(quant_bits=4, group_size=gs)
        jo(paddle.to_tensor(w))
        to(torch.from_numpy(w))
        np.testing.assert_array_equal(to.scales().numpy(), _np(jo.scales()))
        assert to.quant_axis() == -1 and to.bit_length() == 4
    with pytest.raises(ValueError, match="64 or 128"):
        tobs.GroupWiseWeightObserver(group_size=32)


# -- generate over converted models ---------------------------------------


def _llama_pair():
    paddle.seed(3)
    cfg = dict(num_hidden_layers=2)
    jm = JLlama(JConfig.tiny(**cfg))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_jax_params(tm, {n: _np(p) for n, p in jm.named_parameters()})
    jm.eval()
    tm.eval()
    return jm, tm


def _convert(kind, pkg_q, pkg_quant, m):
    if kind == "int8_exec":
        qat = pkg_quant.QAT(pkg_quant.QuantConfig(activation=None,
                                                  weight=None))
        return qat.convert(qat.quantize(m), execute_dtype="int8")
    pkg_q.convert_to_weight_only(m, weight_dtype=kind)
    return m


@pytest.mark.parametrize("gen_kw", [{}, dict(decode_chunk=4),
                                    dict(block_size=8)],
                         ids=["dense", "chunk4", "paged"])
@pytest.mark.parametrize("kind", ["int8_exec", "int8", "int4"])
def test_generate_converted_tokens_match(kind, gen_kw):
    jm, tm = _llama_pair()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (4, 12))
    jm = _convert(kind, jq, jquant, jm)
    tm = _convert(kind, tq, tquant, tm)
    with torch.no_grad():
        tl = tm(torch.from_numpy(ids))[:, -1].numpy()
    jl = _np(jm(paddle.to_tensor(ids)))[:, -1]
    assert _rel(tl, jl) < 1e-5
    want = np.asarray(_np(jgenerate(jm, paddle.to_tensor(ids),
                                    max_new_tokens=6, temperature=0.0,
                                    **gen_kw)))
    with torch.no_grad():
        got = generate(tm, torch.from_numpy(ids), max_new_tokens=6,
                       **gen_kw).numpy()
    np.testing.assert_array_equal(got, want)
    # one token decodes (B=1) too
    want1 = np.asarray(_np(jgenerate(jm, paddle.to_tensor(ids[:1]),
                                     max_new_tokens=3, **gen_kw)))
    with torch.no_grad():
        got1 = generate(tm, torch.from_numpy(ids[:1]), max_new_tokens=3,
                        **gen_kw).numpy()
    np.testing.assert_array_equal(got1, want1)
