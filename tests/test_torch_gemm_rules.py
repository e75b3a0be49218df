"""The port's low-precision GEMMs held to the card's rules on the CPU.

The CPU builds of ``torch._scaled_mm`` and ``torch._int_mm`` accept calls
that the CUDA build refuses. On the H100 (torch 2.11.0+cu128, sm_90) the
card's own error messages give these rules:

- ``_scaled_mm``: "Only multiplication of row-major and column-major
  matrices is supported by cuBLASLt"; "Expected trailing dimension of mat1
  to be divisible by 16"; "mat2 shape (KxN) must be divisible by 16";
  "Multiplication of two Float8_e5m2 matrices is not supported"; scales on
  the operands' device.
- ``_int_mm``: "self.size(0) needs to be greater than 16"; "self.size(1)
  needs to be greater than 0 and a multiple of 8"; "mat2.size(1) needs to
  be greater than 0 and a multiple of 8"; a row-major x row-major or
  column-major x column-major call fails in cuBLASLt
  (CUBLAS_STATUS_NOT_SUPPORTED).

The port's own contract adds: f32 one-element scales, f32 output and no
fast accumulation (the reference's ``preferred_element_type=f32``).

A fixture wraps both ops with a checker of these rules and records every
call; each fp8 and int8 path of the port runs through it: the fp8 forward
and backward, a captured fp8 train step (eager on the CPU), the fp8 engine
in its modes, and ``generate`` over int8-executing and weight-only models,
at shapes that include the reference tests' ``Linear(32, 4)`` and a B=1
decode. Separately, the padded calls equal the unpadded ones on the CPU.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import quantization as tquant
from paddle_tpu_torch.amp import fp8 as tfp8
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, generate
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import quant as tq

E4, E5 = torch.float8_e4m3fn, torch.float8_e5m2


class CardRuleError(AssertionError):
    pass


def _col_major(t):
    return t.stride(0) == 1 and t.stride(1) >= max(1, t.shape[0])


def _row_major(t):
    # torch's cuBLAS argument check tries column-major first
    return (not _col_major(t) and t.stride(1) == 1
            and t.stride(0) >= max(1, t.shape[1]))


def _check(ok, msg):
    if not ok:
        raise CardRuleError(msg)


def scaled_mm_rules(a, b, scale_a, scale_b, bias=None, scale_result=None,
                    out_dtype=None, use_fast_accum=False):
    _check(a.dim() == 2 and b.dim() == 2, "operands must be matrices")
    _check(a.dtype in (E4, E5) and b.dtype in (E4, E5), "fp8 operands")
    _check(not (a.dtype == E5 and b.dtype == E5), "e5m2 x e5m2")
    _check(_row_major(a) and _col_major(b),
           f"layouts: a strides {a.stride()} b strides {b.stride()}")
    _check(a.shape[1] % 16 == 0, f"depth {a.shape[1]} % 16")
    _check(b.shape[0] % 16 == 0 and b.shape[1] % 16 == 0,
           f"mat2 {tuple(b.shape)} % 16")
    for s in (scale_a, scale_b):
        _check(s.dtype == torch.float32 and s.numel() == 1
               and s.device == a.device, "f32 one-element scales")
    _check(out_dtype == torch.float32, "f32 output")
    _check(not use_fast_accum, "no fast accumulation")
    _check(bias is None and scale_result is None, "no bias, no result scale")


def int_mm_rules(a, b):
    _check(a.dtype == torch.int8 and b.dtype == torch.int8, "int8 operands")
    _check(a.shape[0] > 16, f"{a.shape[0]} rows")
    _check(a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0,
           f"depth {a.shape[1]}, width {b.shape[1]} % 8")
    _check(_row_major(a) and _col_major(b),
           f"layouts: a strides {a.stride()} b strides {b.stride()}")


@pytest.fixture
def card_rules(monkeypatch):
    """Wrap both ops with the card's rules; yields the recorded calls."""
    calls = {"scaled_mm": [], "int_mm": []}
    scaled_mm, int_mm = torch._scaled_mm, torch._int_mm

    def checked_scaled_mm(a, b, *args, **kw):
        scaled_mm_rules(a, b, *args, **kw)
        calls["scaled_mm"].append((tuple(a.shape), tuple(b.shape),
                                   a.dtype, b.dtype))
        return scaled_mm(a, b, *args, **kw)

    def checked_int_mm(a, b):
        int_mm_rules(a, b)
        calls["int_mm"].append((tuple(a.shape), tuple(b.shape)))
        return int_mm(a, b)

    monkeypatch.setattr(torch, "_scaled_mm", checked_scaled_mm)
    monkeypatch.setattr(torch, "_int_mm", checked_int_mm)
    yield calls


def _rng_t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


# -- the checker refuses what the card refuses ------------------------------


def _fp8(rng, m, n, dt=E4):
    return _rng_t(rng, m, n, scale=4).to(dt)


REFUSED_SCALED = {
    "row_x_row": lambda r: (_fp8(r, 16, 32), _fp8(r, 32, 48)),
    "col_x_col": lambda r: (_fp8(r, 32, 16).t(), _fp8(r, 48, 32).t()),
    "depth_30": lambda r: (_fp8(r, 16, 30), _fp8(r, 48, 30).t()),
    "width_40": lambda r: (_fp8(r, 16, 32), _fp8(r, 40, 32).t()),
    "e5m2_x_e5m2": lambda r: (_fp8(r, 16, 32, E5), _fp8(r, 48, 32, E5).t()),
}


@pytest.mark.parametrize("case", list(REFUSED_SCALED))
def test_checker_refuses_what_the_card_refuses_scaled_mm(card_rules, case):
    a, b = REFUSED_SCALED[case](np.random.RandomState(0))
    one = torch.ones(())
    with pytest.raises(CardRuleError):
        torch._scaled_mm(a, b, scale_a=one, scale_b=one,
                         out_dtype=torch.float32)
    # the accepted form of the same call
    a = _fp8(np.random.RandomState(1), 5, 32)
    b = _fp8(np.random.RandomState(2), 48, 32).t()
    torch._scaled_mm(a, b, scale_a=one, scale_b=one, out_dtype=torch.float32)
    with pytest.raises(CardRuleError, match="fast accumulation"):
        torch._scaled_mm(a, b, scale_a=one, scale_b=one,
                         out_dtype=torch.float32, use_fast_accum=True)


def _i8(rng, m, n):
    return torch.from_numpy(rng.randint(-127, 128, (m, n)).astype(np.int8))


REFUSED_INT = {
    "16_rows": lambda r: (_i8(r, 16, 32), _i8(r, 40, 32).t()),
    "depth_30": lambda r: (_i8(r, 17, 30), _i8(r, 40, 30).t()),
    "width_36": lambda r: (_i8(r, 17, 32), _i8(r, 36, 32).t()),
    "row_x_row": lambda r: (_i8(r, 17, 32), _i8(r, 32, 40)),
}


@pytest.mark.parametrize("case", list(REFUSED_INT))
def test_checker_refuses_what_the_card_refuses_int_mm(card_rules, case):
    a, b = REFUSED_INT[case](np.random.RandomState(0))
    with pytest.raises(CardRuleError):
        torch._int_mm(a, b)
    rng = np.random.RandomState(1)
    torch._int_mm(_i8(rng, 17, 32), _i8(rng, 40, 32).t())


# -- the port's paths keep the rules ----------------------------------------

FP8_SHAPES = [((8, 32), 4), ((4, 16), 8), ((1, 64), 24), ((5, 30), 40),
              ((2, 3, 48), 80)]


@pytest.mark.parametrize("xshape,n", FP8_SHAPES,
                         ids=["lin32x4", "lin16x8", "b1", "odd", "3d"])
def test_fp8_forward_and_backward_keep_the_rules(card_rules, xshape, n):
    rng = np.random.RandomState(0)
    x = _rng_t(rng, *xshape).requires_grad_()
    w = _rng_t(rng, xshape[-1], n, scale=0.1).requires_grad_()
    b = _rng_t(rng, n).requires_grad_()
    y = tfp8.fp8_linear(x, w, b)
    (y * _rng_t(rng, *y.shape)).sum().backward()
    assert x.grad is not None and w.grad is not None
    kinds = [(c[2], c[3]) for c in card_rules["scaled_mm"]]
    # forward e4m3 x e4m3, dgrad e5m2 x e4m3, wgrad e4m3 x e5m2: every
    # product through _scaled_mm, none through a float matmul
    assert kinds == [(E4, E4), (E5, E4), (E4, E5)]


def test_fp8_captured_train_step_keeps_the_rules(card_rules):
    torch.manual_seed(0)
    model = torch.nn.Sequential(
        Linear(16, 32, device="cpu", dtype=torch.float32), torch.nn.ReLU(),
        Linear(32, 4, device="cpu", dtype=torch.float32))
    assert tfp8.convert_to_fp8(model) == 2
    opt = topt.AdamW(learning_rate=1e-2, parameters=model.parameters())
    rng = np.random.RandomState(0)
    x = _rng_t(rng, 3, 16)
    y = torch.from_numpy(rng.randint(0, 4, (3,)))

    def body(xb, yb):
        loss = TF.cross_entropy(model(xb), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    step = tjit.to_static(body, layers=[model], optimizers=[opt])
    for _ in range(3):
        step(x, y)
    # a step: 2 forwards, 2 wgrads, 1 dgrad (the input takes no gradient)
    assert len(card_rules["scaled_mm"]) == 3 * 5


FP8_ENGINES = {
    "whole_prompt": dict(prompt_pad=16),
    "chunked": dict(prefill_chunk=8, max_num_batched_tokens=10),
    "spec_k2_int8": dict(prompt_pad=16, spec_decode_k=2, kv_dtype="int8"),
    "overlap_prefix": dict(prompt_pad=16, overlap=True, decode_chunk=2,
                           prefix_cache=True),
}


@pytest.mark.parametrize("case", list(FP8_ENGINES))
def test_fp8_engine_keeps_the_rules(card_rules, case):
    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    eng = ContinuousBatchingEngine(model, max_batch=2, max_len=64,
                                   block_size=8, num_blocks=24, fp8=True,
                                   **FP8_ENGINES[case])
    rng = np.random.RandomState(0)
    for i, n in enumerate((5, 9, 1)):
        eng.add_request(i, rng.randint(0, 250, (n,)), max_new_tokens=5)
    done = eng.run()
    assert all(len(r.out) == 5 for r in done.values())
    assert len(card_rules["scaled_mm"]) > 0
    assert all(c[2] == c[3] == E4 for c in card_rules["scaled_mm"])


def _tiny_llama():
    torch.manual_seed(0)
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    m.eval()
    return m


@pytest.mark.parametrize("batch", [1, 4], ids=["b1", "b4"])
@pytest.mark.parametrize("kind", ["fp8", "int8_exec", "int8", "int4"])
def test_generate_keeps_the_rules(card_rules, kind, batch):
    m = _tiny_llama()
    if kind == "fp8":
        tfp8.convert_to_fp8(m, exclude=lambda n: "lm_head" in n)
    elif kind == "int8_exec":
        qat = tquant.QAT(tquant.QuantConfig(activation=None, weight=None))
        m = qat.convert(qat.quantize(m), execute_dtype="int8")
    else:
        assert tq.convert_to_weight_only(m, weight_dtype=kind) == 15
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (batch, 7)))
    with torch.no_grad():
        for kw in ({}, dict(block_size=8, decode_chunk=2)):
            out = generate(m, ids, max_new_tokens=4, **kw)
            assert tuple(out.shape) == (batch, 11)
    used = {k: len(v) for k, v in card_rules.items()}
    want = {"fp8": ("scaled_mm", "int_mm"), "int8_exec": ("int_mm",
                                                           "scaled_mm")}
    if kind in want:
        on, off = want[kind]
        assert used[on] > 0 and used[off] == 0
    else:  # weight-only: dequantize, then a float matmul
        assert used == {"scaled_mm": 0, "int_mm": 0}


# -- padding leaves the products as they are ----------------------------------


def test_padded_calls_equal_unpadded_on_the_cpu():
    rng = np.random.RandomState(3)
    one = torch.ones(())
    for (m, k, n) in ((5, 30, 40), (1, 64, 4), (16, 16, 8)):
        for da, db in ((E4, E4), (E5, E4), (E4, E5)):
            a, b = _fp8(rng, m, k, da), _fp8(rng, k, n, db)
            raw = torch._scaled_mm(a, b, scale_a=one, scale_b=one,
                                   out_dtype=torch.float32)
            np.testing.assert_array_equal(tfp8._mm(a, b).numpy(),
                                          raw.numpy())
    for (m, k, n) in ((3, 30, 36), (1, 64, 4), (16, 16, 8)):
        a, b = _i8(rng, m, k), _i8(rng, k, n)
        np.testing.assert_array_equal(tq._int8_mm(a, b).numpy(),
                                      torch._int_mm(a, b).numpy())
