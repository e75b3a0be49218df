"""fp8 delayed-scaling GEMMs (counterpart of ``paddle_tpu/amp/fp8.py``).

``fp8_linear`` runs the matmul on fp8 operands, following the delayed-
scaling recipe of Micikevicius et al., *FP8 Formats for Deep Learning*
(2022), with the reference's arithmetic op for op:

- forward: x and w cast to **e4m3** (``clamp(t.float() * scale, -448,
  448)``) with per-tensor f32 scales, the product accumulated in f32 by
  ``torch._scaled_mm`` (unit scales, ``out_dtype=float32``, no fast
  accumulation: the reference's ``dot_general(...,
  preferred_element_type=f32)``), then divided by ``x_scale * w_scale``
  in f32 and cast to x's dtype;
- backward: dy cast to **e5m2** with a just-in-time scale; ``dx = qdy @
  qwᵀ`` (e5m2 x e4m3) and ``dw = qxᵀ @ qdy`` (e4m3 x e5m2, every leading
  dim contracted), each an f32 ``_scaled_mm`` divided by its two scales.
  The scales get zero gradients.

The GEMM is a library call (the reference's is an XLA op, not a Pallas
kernel); the casts and amax reductions are plain torch ops, all on the
device with no host read, so a step that uses them can be captured.
``torch._scaled_mm`` on the card takes the first operand row-major and the
second column-major, a depth and a second operand whose sizes are
multiples of 16, and at least one e4m3 operand: :func:`_mm` lays every
operand out so and pads depth and output width with zeros (exact: a zero
product adds nothing, and the padded columns are dropped).

``Fp8Linear`` wraps a ``Linear`` and shares its weight and bias; its amax
histories are two f32 buffers rolled in place, so captured graphs keep
their addresses. ``convert_to_fp8`` swaps every Linear of a model.
"""
from __future__ import annotations

import torch
from torch import nn

from ..base.amp_state import amp_cast
from ..nn._util import _pad_to, _round_up, _swap

__all__ = ["Fp8Linear", "convert_to_fp8", "fp8_linear",
           "E4M3_MAX", "E5M2_MAX"]

E4M3_MAX = 448.0    # torch.finfo(torch.float8_e4m3fn).max
E5M2_MAX = 57344.0  # torch.finfo(torch.float8_e5m2).max
E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2

# torch._scaled_mm on the card wants the depth and both sizes of the second
# operand to be multiples of this
_DIM_MULTIPLE = 16

# unit dequant scales, one per device: _scaled_mm takes its scales as f32
# tensors on the operands' device, and these never move
_ONES = {}


def _one(device) -> torch.Tensor:
    t = _ONES.get(device)
    if t is None:
        t = torch.ones((), dtype=torch.float32, device=device)
        if not (t.is_cuda and torch.cuda.is_current_stream_capturing()):
            # a tensor made inside a capture is filled only by replays
            _ONES[device] = t
    return t


def _cast_fp8(t, scale, dtype, fmax):
    """``clamp(t.float() * scale, -fmax, fmax)`` cast to ``dtype``."""
    f = t.to(torch.float32, copy=True)
    return f.mul_(scale).clamp_(-fmax, fmax).to(dtype)


def _amax(t) -> torch.Tensor:
    """``max(|t|)`` in f32: one reduction pass, no ``|t|`` written out."""
    return torch.linalg.vector_norm(t, float("inf")).float()


def _over(fmax: float, amax: torch.Tensor) -> torch.Tensor:
    """``fmax / amax`` as one f32 division (torch computes a Python number
    over a tensor as a reciprocal and a product, rounded twice)."""
    return torch.full_like(amax, fmax) / amax


def _jit_scale(t, fmax):
    """Just-in-time per-tensor scale: fmax / amax (1.0 for an all-zero
    tensor)."""
    amax = _amax(t)
    return torch.where(amax > 0, _over(fmax, amax), torch.ones_like(amax))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``a @ b`` of two fp8 images (``[M, K]`` and ``[K, N]``, any
    strides) through ``torch._scaled_mm`` with unit scales: ``a`` row-major,
    ``b`` column-major, K and N padded with zeros to multiples of 16."""
    m, k = a.shape
    n = b.shape[1]
    kp, np_ = _round_up(k, _DIM_MULTIPLE), _round_up(n, _DIM_MULTIPLE)
    a = _pad_to(a, m, kp).contiguous()
    bt = _pad_to(b.t(), np_, kp).contiguous()  # b column-major, padded
    one = _one(a.device)
    out = torch._scaled_mm(a, bt.t(), scale_a=one, scale_b=one,
                           out_dtype=torch.float32, use_fast_accum=False)
    return out if np_ == n else out[:, :n]


def _mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`_mm`: the same fp8 images up-cast and
    multiplied in f32. No main path uses it; the tests and the chip smoke
    hold ``_scaled_mm`` against it."""
    return torch.matmul(a.float(), b.float())


class _Fp8Dot(torch.autograd.Function):
    """``x @ w`` on fp8 operands (the reference's custom-VJP ``_fp8_dot``).
    The residuals are the fp8 images, not the operands."""

    @staticmethod
    def forward(ctx, x, w, x_scale, w_scale):
        lead, k = x.shape[:-1], x.shape[-1]
        qx = _cast_fp8(x.reshape(-1, k), x_scale, E4M3, E4M3_MAX)
        qw = _cast_fp8(w, w_scale, E4M3, E4M3_MAX)
        acc = _mm(qx, qw)
        y = (acc / (x_scale * w_scale)).to(x.dtype)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(qx, qw, x_scale, w_scale)
            ctx.dtypes = (x.dtype, w.dtype)
        return y.reshape(*lead, w.shape[1])

    @staticmethod
    def backward(ctx, dy):
        qx, qw, x_scale, w_scale = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        lead, n = dy.shape[:-1], dy.shape[-1]
        dy2 = dy.reshape(-1, n)
        dy_scale = _jit_scale(dy2, E5M2_MAX)
        qdy = _cast_fp8(dy2, dy_scale, E5M2, E5M2_MAX)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx = dy @ wᵀ
            dx = (_mm(qdy, qw.t()) / (dy_scale * w_scale)).to(x_dtype)
            dx = dx.reshape(*lead, qw.shape[0])
        if ctx.needs_input_grad[1]:
            # dw = xᵀ @ dy: every leading dim contracted
            dw = (_mm(qx.t(), qdy) / (x_scale * dy_scale)).to(w_dtype)
        # scales are amax-derived controls, not trainable signal
        return (dx, dw, torch.zeros_like(x_scale),
                torch.zeros_like(w_scale))


def fp8_linear(x, weight, bias=None, x_scale=None, w_scale=None):
    """``y = fp8_dot(x, w) + bias``. ``x_scale``/``w_scale`` are per-tensor
    f32 cast scales (0-dim tensors, from an :class:`Fp8Linear`'s delayed-
    scaling histories); omitted, each is computed just in time from the
    tensor's current amax."""
    x, weight, x_scale, w_scale, bias = amp_cast(
        "fp8_linear", x, weight, x_scale, w_scale, bias)
    with torch.no_grad():
        if x_scale is None:
            x_scale = _jit_scale(x, E4M3_MAX)
        if w_scale is None:
            w_scale = _jit_scale(weight, E4M3_MAX)
    out = _Fp8Dot.apply(x, weight, x_scale, w_scale)
    return out if bias is None else out + bias


class Fp8Linear(nn.Module):
    """Drop-in fp8 Linear: wraps an existing ``Linear`` and keeps its
    weight and bias parameters (optimizer state survives the conversion;
    only the GEMM runs on fp8 operands). The amax histories are buffers
    rolled in place, so a captured train step records into them."""

    def __init__(self, linear, history_len: int = 16):
        super().__init__()
        self.weight = linear.weight
        self.bias = linear.bias
        self.in_features = self.weight.shape[0]
        self.out_features = self.weight.shape[1]
        self.history_len = int(history_len)
        dev = self.weight.device
        # two distinct zero buffers
        self.register_buffer("amax_history_x", torch.zeros(
            self.history_len, dtype=torch.float32, device=dev))
        self.register_buffer("amax_history_w", torch.zeros(
            self.history_len, dtype=torch.float32, device=dev))

    @staticmethod
    def _scale_from(hist, cur):
        hist, cur = amp_cast("fp8_scale", hist, cur)
        hmax = hist.amax()
        amax = torch.where(hmax > 0, hmax, cur)
        return torch.where(amax > 0, _over(E4M3_MAX, amax),
                           torch.ones_like(amax)).float()

    @staticmethod
    def _roll(hist, cur) -> None:
        """Drop the oldest entry and record ``cur``, in place."""
        h, c = amp_cast("fp8_amax_roll", hist, cur)
        hist.copy_(torch.cat([h[1:], c.reshape(1)]))

    def forward(self, x):
        with torch.no_grad():
            cur_x = _amax(amp_cast("fp8_amax", x))
            cur_w = _amax(amp_cast("fp8_amax", self.weight))
            # delayed scaling: cast with the scale the history implies,
            # then record this call's amax for later calls
            xs = self._scale_from(self.amax_history_x, cur_x)
            ws = self._scale_from(self.amax_history_w, cur_w)
            if self.training:
                self._roll(self.amax_history_x, cur_x)
                self._roll(self.amax_history_w, cur_w)
        return fp8_linear(x, self.weight, self.bias, x_scale=xs, w_scale=ws)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, fp8=e4m3/e5m2, "
                f"history_len={self.history_len}")


def convert_to_fp8(model, exclude=lambda name: False,
                   history_len: int = 16) -> int:
    """Swap every ``Linear`` in ``model`` for an :class:`Fp8Linear`
    sharing the same parameters. Returns the number of layers converted.
    Typical exclusion: the lm_head (its logits feed the loss or sampling,
    where fp8 costs measurable quality for one GEMM of savings)."""
    from ..nn.layer.common import Linear

    n = 0
    for name, sub in list(model.named_modules()):
        if not name or not isinstance(sub, Linear) or exclude(name):
            continue
        _swap(model, name, Fp8Linear(sub, history_len=history_len))
        n += 1
    return n
