"""Weight-only and int8 quantized linears (counterpart of
``paddle_tpu/nn/quant/__init__.py``): ``Stub``, ``weight_quantize``,
``weight_dequantize``, ``weight_only_linear``, ``int8_dynamic_matmul``,
``llm_int8_linear``, ``WeightOnlyLinear`` and ``convert_to_weight_only``.

int8/int4 weight-only quantization stores int weights (int4 packed two to a
byte along the input dim) with per-channel or group-wise f32 scales; the
linear dequantizes and multiplies in the activation's dtype, as the
reference does. ``int8_dynamic_matmul`` quantizes activations per row and
runs the int8 x int8 -> int32 product through ``torch._int_mm`` (the
reference's ``dot_general(..., preferred_element_type=int32)``, an XLA op,
not a Pallas kernel). ``torch._int_mm`` on the card takes more than 16 rows
and a depth and output width that are multiples of 8: :func:`_int8_mm`
pads rows, depth and width with zeros (exact: integer sums of zero
products) and lays the first operand out row-major, the second
column-major.
"""
from __future__ import annotations

import torch
from torch import nn

from ...base.amp_state import amp_cast
from .._util import _pad_to, _round_up, _swap

__all__ = ["Stub", "weight_only_linear", "llm_int8_linear",
           "WeightOnlyLinear", "convert_to_weight_only",
           "weight_quantize", "weight_dequantize", "int8_dynamic_matmul"]

# torch._int_mm on the card: more than 16 rows, depth and output width
# multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_DIM_MULTIPLE = 8


class Stub(nn.Module):
    """A placeholder the quantizer swaps for an observer/quanter; identity
    until configured."""

    def __init__(self, observer=None):
        super().__init__()
        self._observer = observer

    def forward(self, x):
        return self._observer(x) if self._observer is not None else x


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """Quantize a ``[in, out]`` weight; returns ``(q, scale)``.

    - int8 (and "llm.int8"): per-out-channel absmax scales, unpacked int8.
    - int4: values in [-8, 7] packed two to a byte along the in axis
      (``[in/2, out]`` int8), with per-out-channel scales
      (``group_size=-1``) or group-wise scales ``[in/group, out]``.
    """
    if algo not in ("weight_only_int8", "weight_only_int4", "llm.int8"):
        raise ValueError(f"unsupported algo {algo!r}")
    w = x.detach()
    if algo != "weight_only_int4":
        scale = w.abs().amax(0) / 127.0
        q = torch.round(w / torch.clamp_min(scale, 1e-9)).clamp_(-128, 127)
        return q.to(torch.int8), scale.to(torch.float32)

    cin = int(w.shape[0])
    if group_size not in (-1, 64, 128):
        raise ValueError("group_size supports -1, 64 or 128")
    if cin % 2:
        raise ValueError("int4 packing needs an even input dim")
    if group_size > 0 and cin % group_size:
        raise ValueError(f"group_size {group_size} must divide in={cin}")
    if group_size > 0:
        g = w.reshape(cin // group_size, group_size, -1)
        scale = g.abs().amax(1) / 7.0  # [in/gs, out]
        sc = torch.repeat_interleave(torch.clamp_min(scale, 1e-9),
                                     group_size, dim=0)
    else:
        scale = w.abs().amax(0) / 7.0  # [out]
        sc = torch.clamp_min(scale, 1e-9)
    q = torch.round(w / sc).clamp_(-8, 7).to(torch.int32)
    # pack: byte = (q[2i] & 0xF) | (q[2i+1] << 4)
    packed = (q[0::2] & 0xF) | ((q[1::2] & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8), scale.to(torch.float32)


def _unpack_int4(packed):
    """``[in/2, out]`` packed int8 -> ``[in, out]`` int8 values in [-8, 7]."""
    u = packed.view(torch.uint8).to(torch.int32)
    lo = u & 0xF
    hi = (u >> 4) & 0xF
    # sign-extend 4-bit two's complement
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    n2, out = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * n2, out).to(torch.int8)


def _dequant_weight(q, s, weight_dtype, group_size, dtype):
    if weight_dtype == "int4":
        q = _unpack_int4(q)
    if s.dim() == 2:  # group-wise [in/gs, out]
        s = torch.repeat_interleave(s, q.shape[0] // s.shape[0], dim=0)
    return q.to(dtype) * s.to(dtype)


def weight_dequantize(x, scale, algo="weight_only_int8", out_dtype="float16"):
    """The float weight ``q * scale`` in ``out_dtype``."""
    from ...base.dtype import to_torch_dtype

    wd = "int4" if algo == "weight_only_int4" else "int8"
    return _dequant_weight(x, scale, wd, -1,
                           torch.float32).to(to_torch_dtype(out_dtype))


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """``y = x @ dequant(weight) + bias``. int4 weights arrive packed
    (``[in/2, out]``, see :func:`weight_quantize`) with per-channel or
    group-wise scales; the product runs in x's dtype."""
    x, weight_scale, bias = amp_cast("weight_only_linear", x, weight_scale,
                                     bias)
    w = _dequant_weight(weight, weight_scale, weight_dtype, group_size,
                        x.dtype)
    out = torch.matmul(x, w)
    return out if bias is None else out + bias


def _int8_mm(qa: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int32 ``qa @ q`` of int8 ``[M, K]`` and ``[K, N]`` (any strides)
    through ``torch._int_mm``: ``qa`` row-major with at least 17 rows,
    ``q`` column-major, K and N multiples of 8, all padding zeros."""
    m, k = qa.shape
    n = q.shape[1]
    mp = max(m, _INT_MM_MIN_ROWS)
    kp = _round_up(k, _INT_MM_DIM_MULTIPLE)
    np_ = _round_up(n, _INT_MM_DIM_MULTIPLE)
    a = _pad_to(qa, mp, kp).contiguous()
    bt = _pad_to(q.t(), np_, kp).contiguous()  # q column-major, padded
    out = torch._int_mm(a, bt.t())
    return out if (mp, np_) == (m, n) else out[:m, :n]


def _quantize_rows(a):
    """Per-row dynamic int8 quantization: ``(q, act_scale)``."""
    act_scale = torch.clamp_min(a.abs().amax(-1, keepdim=True) / 127.0, 1e-9)
    qa = torch.round(a / act_scale).clamp_(-127, 127).to(torch.int8)
    return qa, act_scale


def int8_dynamic_matmul(a, q, s, outlier_threshold=None, max_outliers=16):
    """Quantize activations per row, run the int8 x int8 -> int32 product,
    rescale by ``act_scale * weight_scale``. With ``outlier_threshold``,
    the llm.int8 decomposition (arXiv:2208.07339): the top-``max_outliers``
    activation feature columns whose magnitude exceeds the threshold are
    carried in a small f32 matmul instead (a static K, as the
    reference)."""
    in_f = a.shape[-1]
    extra = None
    if outlier_threshold is not None:
        k = min(max_outliers, in_f)
        col_max = a.reshape(-1, in_f).abs().amax(0)
        top_vals, idx = torch.topk(col_max, k)
        sel = top_vals > outlier_threshold  # [k]
        outlier_mask = torch.zeros(in_f, dtype=torch.bool,
                                   device=a.device).index_put((idx,), sel)
        a_main = torch.where(outlier_mask, 0.0, a)
        a_out = a.index_select(-1, idx) * sel.to(a.dtype)  # [.., k]
        w_out = q[idx].to(torch.float32) * s.to(torch.float32)  # [k, out]
        extra = torch.matmul(a_out.to(torch.float32), w_out)
    else:
        a_main = a
    qa, act_scale = _quantize_rows(a_main)
    acc = _int8_mm(qa.reshape(-1, in_f), q).reshape(*qa.shape[:-1],
                                                     q.shape[1])
    out = (acc.to(torch.float32) * act_scale.to(torch.float32)
           * s.to(torch.float32))
    if extra is not None:
        out = out + extra
    return out.to(a.dtype)


def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0):
    """llm.int8 linear with int8 arithmetic: activations quantized per row,
    the main product an int8 x int8 -> int32 GEMM; activation feature
    columns above ``threshold`` take the float path (``threshold=None``
    disables the split).

    Gradients: the int8 round/clip has zero derivative, so when an input
    requires grad the op runs a straight-through estimator — the value of
    the int8 product, the gradient of the dequantized f32 matmul."""
    x, weight_scale, bias = amp_cast("llm_int8_linear", x, weight_scale,
                                     bias)
    needs_grad = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in (x, weight, weight_scale, bias))
    out = int8_dynamic_matmul(x.detach() if needs_grad else x, weight,
                              weight_scale, outlier_threshold=threshold)
    if needs_grad:
        w = weight.to(torch.float32) * weight_scale.to(torch.float32)
        out_f = torch.matmul(x.to(torch.float32), w).to(x.dtype)
        # value == the int8 result exactly; gradient == the float matmul's
        out = out_f + (out - out_f).detach()
    return out if bias is None else out + bias


class WeightOnlyLinear(nn.Module):
    """Inference Linear over frozen weight-only-quantized weights:
    ``weight_dtype="int8"`` (per-out-channel scales, unpacked) or
    ``"int4"`` (packed two to a byte, per-channel or group-wise scales).
    The quantized weight and its scales are buffers."""

    def __init__(self, linear, weight_dtype: str = "int4",
                 group_size: int = -1):
        super().__init__()
        algo = ("weight_only_int4" if weight_dtype == "int4"
                else "weight_only_int8")
        with torch.no_grad():
            q, s = weight_quantize(linear.weight, algo=algo,
                                   group_size=group_size)
        self.register_buffer("weight", q)  # packed for int4
        self.register_buffer("weight_scale", s)
        self.bias = linear.bias
        self.weight_dtype = weight_dtype
        self.group_size = group_size
        self._in_features = int(linear.weight.shape[0])
        self._out_features = int(linear.weight.shape[1])

    def forward(self, x):
        return weight_only_linear(
            x, self.weight, bias=self.bias, weight_scale=self.weight_scale,
            weight_dtype=self.weight_dtype, group_size=self.group_size)

    def extra_repr(self):
        return (f"in={self._in_features}, out={self._out_features}, "
                f"weight_dtype={self.weight_dtype}, gs={self.group_size}")


def convert_to_weight_only(model, weight_dtype: str = "int4",
                           group_size: int = -1, exclude=lambda name: False):
    """Swap every ``Linear`` in ``model`` for a :class:`WeightOnlyLinear`
    holding quantized frozen weights. Returns the number converted."""
    from ..layer.common import Linear

    n = 0
    for name, sub in list(model.named_modules()):
        if not name or not isinstance(sub, Linear) or exclude(name):
            continue
        if weight_dtype == "int4" and int(sub.weight.shape[0]) % 2:
            continue  # odd in-dim cannot pack
        _swap(model, name, WeightOnlyLinear(sub, weight_dtype, group_size))
        n += 1
    return n
