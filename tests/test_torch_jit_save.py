"""Port parity: ``jit.save`` / ``jit.load`` / ``TranslatedLayer`` and the
inference ``Predictor`` against the JAX package's, on the CPU.

- A save and load round trip of a small MLP and of ``LlamaConfig.tiny()`` in
  f32: the ``TranslatedLayer`` equals the live forward to 1e-6, and the
  reference's own round trip of the same weights to 1e-5 (XLA against
  PyTorch).
- The exported program holds no weights (``.pdmodel`` far smaller than
  ``.pdiparams``) and, where attention takes the flash path, one
  ``paddle_tpu_torch::flash_fwd`` node per layer (read from the graph).
- Without ``input_spec`` ``load`` gives the state dict.
- ``.pdiparams`` files cross-read in both directions (f32 as is, bf16
  through the raw ``uint16`` form).
- A reference ``.pdmodel`` with a StableHLO program raises the clear error
  and still hands over its weights.
- The ``Predictor`` API (names, handles, ``PredictorPool``) against the
  reference's on the same weights, to 1e-4.
- ``Config()`` defaults to the card: creating a predictor raises where CUDA
  is absent.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.inference as jinf
import paddle_tpu.jit as pjit
import paddle_tpu.nn as jnn
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.utils import load_jax_params

EXACT = 1e-6
CROSS = 1e-5
PREDICT = 1e-4


def _mlps():
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tm = torch.nn.Sequential(tnn.Linear(8, 16, device="cpu", dtype=torch.float32),
                             torch.nn.ReLU(),
                             tnn.Linear(16, 4, device="cpu", dtype=torch.float32))
    load_jax_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    return jm, tm


def _llamas(**kw):
    paddle.seed(0)
    jm = JLlama(JConfig.tiny(**kw))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    return jm, tm


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.numpy())


@pytest.mark.parametrize("kind", ["mlp", "llama_tiny"])
def test_round_trip_equals_live_forward(tmp_path, kind):
    if kind == "mlp":
        jm, tm = _mlps()
        spec, x = [([4, 8], "float32")], np.random.RandomState(0).randn(4, 8).astype(np.float32)
    else:
        jm, tm = _llamas()
        spec, x = [([2, 16], "int64")], np.random.RandomState(0).randint(0, 256, (2, 16))
    tpath, jpath = str(tmp_path / "t" / "m"), str(tmp_path / "j" / "m")
    tjit.save(tm, tpath, input_spec=spec)
    pjit.save(jm, jpath, input_spec=spec)
    tl, jl = tjit.load(tpath, device="cpu"), pjit.load(jpath)
    assert isinstance(tl, tjit.TranslatedLayer) and tl.num_inputs == jl.num_inputs == 1
    got = _np(tl(torch.from_numpy(x)))
    np.testing.assert_allclose(got, _np(tm(torch.from_numpy(x))), rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(got, _np(jl(paddle.to_tensor(x))), rtol=CROSS, atol=CROSS)
    # the program holds no weights: they live once, in .pdiparams
    assert not tl.program.state_dict and not tl.program.constants
    if kind == "llama_tiny":
        assert os.path.getsize(tpath + ".pdmodel") < os.path.getsize(tpath + ".pdiparams")
    with open(tpath + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    assert meta["format"] == tjit.FORMAT
    assert meta["param_names"] == [n for n, _ in tm.named_parameters()]
    assert meta["class"] == type(tm).__name__
    assert tl.eval() is tl
    with pytest.raises(RuntimeError, match="inference-only"):
        tl.train()


def test_input_spec_objects_with_shape_and_dtype(tmp_path):
    from paddle_tpu.static import InputSpec

    _, tm = _mlps()
    path = str(tmp_path / "m")
    tjit.save(tm, path, input_spec=[InputSpec([3, 8], "float32")])
    x = torch.randn(3, 8)
    np.testing.assert_allclose(_np(tjit.load(path, device="cpu")(x)), _np(tm(x)),
                               rtol=EXACT, atol=EXACT)
    with pytest.raises(ValueError, match="dynamic"):
        tjit.save(tm, path, input_spec=[([None, 8], "float32")])


def test_exported_program_holds_the_flash_operator(tmp_path, monkeypatch):
    """Where attention can take the flash path, the program holds the
    registered ``paddle_tpu_torch::flash_fwd`` once per layer and no plain
    attention (no softmax), whatever device it was saved on: here the CPU,
    where the operator's implementation is the plain version. The loaded
    program equals the live forward taking the same path (forced for the
    live model only: on CPU tensors eager attention is the plain softmax)."""
    _, tm = _llamas(hidden_size=128, num_attention_heads=2, num_key_value_heads=1)
    path = str(tmp_path / "m")
    tjit.save(tm, path, input_spec=[([2, 128], "int64")])
    tl = tjit.load(path, device="cpu")
    targets = [str(n.target) for n in tl.program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("paddle_tpu_torch.flash_fwd.default") == 2
    assert not any("softmax" in t for t in targets)
    ids = torch.randint(0, 256, (2, 128))
    got = _np(tl(ids))
    monkeypatch.setattr(tattn, "_use_flash",
                        lambda q, mask, p: mask is None and p == 0)
    np.testing.assert_allclose(got, _np(tm(ids)), rtol=EXACT, atol=EXACT)


def test_program_saved_on_the_cpu_keeps_the_flash_operator_when_moved(tmp_path):
    """What ``load`` runs on another device than the one saved on: the
    program moved there (``_program_on``; the meta device stands in for the
    card, which this machine lacks) still holds one ``flash_fwd`` per layer
    and no softmax, and every device argument names the new device."""
    _, tm = _llamas(hidden_size=128, num_attention_heads=2, num_key_value_heads=1)
    path = str(tmp_path / "m")
    tjit.save(tm, path, input_spec=[([2, 128], "int64")])
    with open(path + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    assert meta["device"] == "cpu"
    program = tjit._program_on(meta, torch.device("meta"))
    calls = [n for n in program.graph.nodes if n.op == "call_function"]
    targets = [str(n.target) for n in calls]
    assert targets.count("paddle_tpu_torch.flash_fwd.default") == 2
    assert not any("softmax" in t for t in targets)
    devices = {str(n.kwargs["device"]) for n in calls if "device" in n.kwargs}
    assert devices == {"meta"}


def test_without_input_spec_load_gives_the_state_dict(tmp_path):
    jm, tm = _mlps()
    path = str(tmp_path / "m")
    tjit.save(tm, path)
    got = tjit.load(path)
    assert isinstance(got, dict) and set(got) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert torch.equal(got[k], v)
    pjit.save(jm, str(tmp_path / "j"))
    want = pjit.load(str(tmp_path / "j"))
    assert set(want) == set(got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pdiparams_cross_read_both_ways(tmp_path, dtype):
    import ml_dtypes

    paddle.seed(1)
    jm = JLlama(JConfig.tiny())
    if dtype == "bfloat16":
        jm.bfloat16()
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", dtype=dtype)
    load_jax_params(tm, {n: np.asarray(p._data).astype(np.float32)
                         for n, p in jm.named_parameters()})
    # port -> reference: f32 as is, bf16 as its raw uint16 bits
    tjit.save(tm, str(tmp_path / "t"))
    ref_reads = pjit.load(str(tmp_path / "t"))
    for k, v in tm.state_dict().items():
        a = ref_reads[k]
        if dtype == "bfloat16":
            assert a.dtype == np.uint16
            a = a.view(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(np.asarray(a, np.float32), v.float().numpy())
    # reference -> port: its ml_dtypes bf16 arrays read through their bits
    pjit.save(jm, str(tmp_path / "j"))
    port_reads = tjit.load(str(tmp_path / "j"))
    for n, p in jm.named_parameters():
        assert port_reads[n].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(port_reads[n].float().numpy(),
                                      np.asarray(p._data).astype(np.float32))


def test_reference_stablehlo_program_gives_a_clear_error(tmp_path):
    jm, tm = _mlps()
    path = str(tmp_path / "j")
    pjit.save(jm, path, input_spec=[([4, 8], "float32")])
    with pytest.raises(tjit.ForeignProgramError, match="StableHLO") as e:
        tjit.load(path, device="cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(e.value.state[k], v)


def _predict(inf, path, x, cpu):
    cfg = inf.Config(path)
    if cpu:
        cfg.disable_gpu()
    pred = inf.create_predictor(cfg)
    names = pred.get_input_names()
    h = pred.get_input_handle(names[0])
    h.copy_from_cpu(x)
    assert h.shape() == list(x.shape) and h.name() == names[0]
    assert pred.run()
    out_names = pred.get_output_names()
    return names, out_names, pred.get_output_handle(out_names[0]).copy_to_cpu()


@pytest.mark.parametrize("kind", ["mlp", "llama_tiny"])
def test_predictor_matches_the_reference(tmp_path, kind):
    if kind == "mlp":
        jm, tm = _mlps()
        spec, x = [([4, 8], "float32")], np.random.RandomState(2).randn(4, 8).astype(np.float32)
    else:
        jm, tm = _llamas()
        spec, x = [([2, 16], "int64")], np.random.RandomState(2).randint(0, 256, (2, 16))
    tjit.save(tm, str(tmp_path / "t"), input_spec=spec)
    pjit.save(jm, str(tmp_path / "j"), input_spec=spec)
    tn, to, tout = _predict(tinf, str(tmp_path / "t"), x, cpu=True)
    jn, jo, jout = _predict(jinf, str(tmp_path / "j"), x, cpu=True)
    assert (tn, to) == (jn, jo) == (["x0"], ["out0"])
    np.testing.assert_allclose(tout, jout, rtol=PREDICT, atol=PREDICT)
    np.testing.assert_allclose(tout, _np(tm(torch.from_numpy(x))), rtol=EXACT, atol=EXACT)
    cfg = tinf.Config(str(tmp_path / "t"))
    cfg.disable_gpu()
    pool = tinf.PredictorPool(cfg, size=2)
    p1 = pool.retrieve(1)
    p1.get_input_handle("x0").copy_from_cpu(x)
    p1.run()
    np.testing.assert_array_equal(p1.get_output_handle("out0").copy_to_cpu(), tout)


def test_predictor_api_surface_matches_the_reference():
    for name in jinf.__all__:
        assert hasattr(tinf, name), name
    for enum_name in ("DataType", "PlaceType", "PrecisionType"):
        je, te = getattr(jinf, enum_name), getattr(tinf, enum_name)
        assert [(m.name, m.value) for m in je] == [(m.name, m.value) for m in te]
    for dt in tinf.DataType:
        assert tinf.get_num_bytes_of_data_type(dt) == \
            jinf.get_num_bytes_of_data_type(getattr(jinf.DataType, dt.name))
    assert tinf.get_trt_compile_version() == jinf.get_trt_compile_version()
    assert tinf._get_phi_kernel_name("matmul") == "matmul"
    assert tinf.get_version() == jinf.get_version()
    with pytest.raises(NotImplementedError):
        tinf.convert_to_mixed_precision("a", "b", "c", "d")
    cfg = tinf.Config("p")
    cfg.enable_tensorrt_engine()
    cfg.switch_ir_optim(False)
    assert cfg.prog_file() == "p" and cfg.summary()["device"] == "gpu"
    assert tinf.XpuConfig(a=1).a == 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a CUDA-less machine")
def test_config_defaults_to_the_card_and_raises_without_cuda(tmp_path):
    _, tm = _mlps()
    path = str(tmp_path / "m")
    tjit.save(tm, path, input_spec=[([4, 8], "float32")])
    cfg = tinf.Config(path)
    assert cfg.use_gpu()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinf.create_predictor(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tjit.load(path)
    cfg.disable_gpu()
    assert not cfg.use_gpu() and tinf.create_predictor(cfg) is not None
