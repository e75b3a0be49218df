"""Quantization-aware training and post-training quantization (counterpart
of ``paddle_tpu/quantization/__init__.py``): fake quant with a
straight-through estimator, the abs-max observer and quanter,
``QuantConfig``, ``QAT``/``PTQ`` layer swaps over the port's modules, and
``Int8InferenceLinear``, which executes an int8 x int8 -> int32 GEMM
(``nn.quant.llm_int8_linear``).

Fake quant is ``x + (q - x).detach()``: the value of the quant-dequant
image, the gradient of the identity. ``QAT.convert`` folds the weight
quanters into the weights (float execution) or, with
``execute_dtype="int8"``, builds :class:`Int8InferenceLinear` layers.
"""
from __future__ import annotations

import inspect
from typing import Dict, Type

import torch
from torch import nn

from ..base.amp_state import amp_cast
from ..nn._util import _swap

__all__ = [
    "fake_quantize_dequantize_abs_max",
    "FakeQuanterWithAbsMaxObserver",
    "AbsmaxObserver",
    "QuantConfig",
    "QAT",
    "QuantedLinear",
    "BaseQuanter", "BaseObserver", "PTQ", "Int8InferenceLinear", "quanter"]


def fake_quantize_dequantize_abs_max(x, bit_length: int = 8, scale=None):
    """Round-through fake quant with straight-through gradients; ``scale``
    defaults to ``max(|x|)``."""
    qmax = float(2 ** (bit_length - 1) - 1)
    s = x.detach().abs().amax() if scale is None else scale
    s = torch.clamp_min(s, 1e-9)
    q = torch.clamp(torch.round(x.detach() / s * qmax), -qmax, qmax) \
        * s / qmax
    # straight-through estimator: identity gradient
    return x + (q - x.detach()).detach()


class AbsmaxObserver(nn.Module):
    """PTQ observer tracking the running abs-max on the host."""

    def __init__(self, quant_bits: int = 8):
        super().__init__()
        self.quant_bits = quant_bits
        self._scale = None

    def forward(self, x):
        cur = float(x.detach().abs().max())
        self._scale = cur if self._scale is None else max(self._scale, cur)
        return x

    def scale(self) -> float:
        return self._scale or 1e-9


class FakeQuanterWithAbsMaxObserver(nn.Module):
    """QAT quanter: EMA abs-max scale + fake quant round-through. ``accum``
    and ``state`` start at zero, so the first observation sets the scale to
    the absmax exactly. The buffers are written in place."""

    def __init__(self, moving_rate: float = 0.9, bit_length: int = 8,
                 dtype="float32", name=None):
        super().__init__()
        self.moving_rate = moving_rate
        self.bit_length = bit_length
        self.register_buffer("scale", torch.ones(()))
        self.register_buffer("accum", torch.zeros(()))
        self.register_buffer("state", torch.zeros(()))

    def forward(self, x):
        if self.training:
            r = self.moving_rate
            with torch.no_grad():
                cur = x.detach().abs().amax()
                state = r * self.state + 1.0
                accum = r * self.accum + cur
                self.scale.copy_(accum / state)
                self.state.copy_(state)
                self.accum.copy_(accum)
        return fake_quantize_dequantize_abs_max(x, self.bit_length,
                                                scale=self.scale)


class QuantedLinear(nn.Module):
    """Linear with fake-quanted activations and weights."""

    def __init__(self, linear, q_config):
        super().__init__()
        self.linear = linear
        dev = linear.weight.device
        self.activation_quanter = (
            q_config.activation._instance(dev) if q_config.activation
            else None)
        self.weight_quanter = (
            q_config.weight._instance(dev) if q_config.weight else None)

    def forward(self, x):
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        w = self.linear.weight
        wq = self.weight_quanter(w) if self.weight_quanter is not None else w
        x, wq, b = amp_cast("linear", x, wq, self.linear.bias)
        y = torch.matmul(x, wq)
        return y if b is None else y + b


class _QuanterFactory:
    def __init__(self, cls, **kwargs):
        self.cls = cls
        self.kwargs = kwargs

    def _instance(self, device=None):
        q = self.cls(**self.kwargs)
        return q if device is None else q.to(device)


def _factory_from_instance(inst) -> _QuanterFactory:
    """Rebuild a factory from a configured quanter instance, carrying over
    every ``__init__`` parameter stored as a same-named attribute."""
    sig = inspect.signature(type(inst).__init__)
    kwargs = {
        p: getattr(inst, p)
        for p in list(sig.parameters)[1:]
        if p not in ("args", "kwargs") and hasattr(inst, p)
    }
    return _QuanterFactory(type(inst), **kwargs)


class QuantConfig:
    """Which quanter handles activations and weights, globally or per layer
    type."""

    def __init__(self, activation=None, weight=None):
        self.activation = (
            activation if isinstance(activation, (_QuanterFactory, type(None)))
            else _factory_from_instance(activation))
        self.weight = (
            weight if isinstance(weight, (_QuanterFactory, type(None)))
            else _factory_from_instance(weight))
        self._layer_configs: Dict[Type, "QuantConfig"] = {}

    def add_type_config(self, layer_type, activation=None, weight=None):
        self._layer_configs[layer_type] = QuantConfig(activation, weight)

    def config_for(self, layer) -> "QuantConfig":
        return self._layer_configs.get(type(layer), self)


def quanter(cls=None, **kwargs):
    """Factory helper mirroring the reference's quanter registration."""
    return _QuanterFactory(cls or FakeQuanterWithAbsMaxObserver, **kwargs)


class QAT:
    """Quantization-aware training: the layer swap and the conversion."""

    def __init__(self, q_config: QuantConfig):
        self.q_config = q_config

    def quantize(self, model: nn.Module, inplace: bool = False) -> nn.Module:
        """Swap ``Linear`` submodules for :class:`QuantedLinear` (the model
        is changed in place)."""
        from ..nn import Linear

        for name, sub in list(model.named_modules()):
            if name and isinstance(sub, Linear):
                _swap(model, name,
                      QuantedLinear(sub, self.q_config.config_for(sub)))
        return model

    def convert(self, model: nn.Module, inplace: bool = False,
                execute_dtype: str | None = None) -> nn.Module:
        """Finalize for inference: fold the weight quanters into the
        weights (the quant-dequant image, float execution) and strip the
        wrappers; ``execute_dtype="int8"`` builds
        :class:`Int8InferenceLinear` layers instead."""
        for name, sub in list(model.named_modules()):
            if not isinstance(sub, QuantedLinear):
                continue
            if execute_dtype == "int8":
                new = Int8InferenceLinear(sub.linear, sub.weight_quanter)
            else:
                new = sub.linear
                if sub.weight_quanter is not None:
                    sub.weight_quanter.eval()
                    with torch.no_grad():
                        new.weight.copy_(sub.weight_quanter(new.weight))
            _swap(model, name, new)
        return model


class Int8InferenceLinear(nn.Module):
    """Inference linear executing with int8 arithmetic: per-out-channel
    int8 weights and f32 scales as buffers (``qweight`` is laid out
    column-major, the GEMM's second-operand layout); forward quantizes
    activations per row and runs the int8 GEMM
    (``nn.quant.int8_dynamic_matmul``).

    Built from a QAT layer, the weight is first projected onto the grid the
    weight quanter trained against (its fake-quant image), then
    int8-encoded."""

    def __init__(self, linear, weight_quanter=None):
        super().__init__()
        from ..nn.quant import weight_quantize

        if weight_quanter is not None:
            bits = getattr(weight_quanter, "bit_length", 8)
            if bits != 8:
                raise ValueError(
                    f"execute_dtype='int8' needs an 8-bit weight config; "
                    f"the QAT weight quanter used bit_length={bits}")
        with torch.no_grad():
            w = linear.weight
            if weight_quanter is not None:
                weight_quanter.eval()
                w = weight_quanter(w)
            qw, scale = weight_quantize(w, algo="weight_only_int8")
        self.register_buffer("qweight", qw.t().contiguous().t())
        self.register_buffer("scale", scale)
        self.bias = linear.bias

    def forward(self, x):
        from ..nn.quant import llm_int8_linear

        return llm_int8_linear(x, self.qweight, bias=self.bias,
                               weight_scale=self.scale, threshold=None)


class BaseQuanter(nn.Module):
    """An abstract quant transform; subclasses implement forward plus the
    bit/axis queries."""

    def forward(self, x):
        raise NotImplementedError

    def scales(self):
        raise NotImplementedError

    def zero_points(self):
        raise NotImplementedError

    def quant_axis(self):
        return None

    def bit_length(self):
        return 8


class BaseObserver(BaseQuanter):
    """A quanter that only collects statistics (a PTQ calibration pass)."""

    def forward(self, x):
        return x


class PTQ:
    """Post-training quantization: ``quantize()`` inserts observers,
    the user runs calibration batches, ``convert()`` folds the observed
    scales into quant-dequant weights."""

    def __init__(self, q_config: QuantConfig):
        self.q_config = q_config
        self._qat = QAT(q_config)

    def quantize(self, model: nn.Module, inplace: bool = False) -> nn.Module:
        m = self._qat.quantize(model, inplace)
        # observers run in eval mode during calibration
        m.eval()
        return m

    def convert(self, model: nn.Module, inplace: bool = False,
                execute_dtype: str | None = None) -> nn.Module:
        return self._qat.convert(model, inplace, execute_dtype=execute_dtype)


# submodule namespaces (the reference's quantization/{observers,quanters})
from . import observers  # noqa: E402,F401
from . import quanters  # noqa: E402,F401
