"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``):
``Linear``, ``Embedding``, ``Identity``, the dropouts, ``Flatten``, the
pads, the upsamplers and the distances.

``Linear`` keeps paddle's ``[in_features, out_features]`` weight layout
(``y = x @ W``), so weights carried over from the JAX package need no
transpose. Init mirrors the reference's defaults: the global initializers
(``initializer.set_global_initializer``; Xavier-uniform weights and zero
biases unless set), N(0, 1) embeddings — drawn from an explicit
``torch.Generator``. Every parameter carries the reference ``Parameter``'s
tensor-parallel metadata (``paddle_tpu/nn/layer/layers.py:49-50``):
``is_distributed`` (False: the whole tensor) and ``tp_axis`` (None: no
sharding hint), which ``distributed.fleet``'s tensor parallelism reads.

A layer's ``weight_attr`` / ``bias_attr`` is ``None`` (the default
initializer), an initializer, or ``False`` (no such parameter).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...base.amp_state import amp_cast
from ...base.device import get_device
from ...base.dtype import to_torch_dtype
from .. import functional as F

__all__ = [
    "Linear", "Embedding", "Identity", "Dropout",
    "Dropout2D", "Dropout3D", "AlphaDropout", "Flatten", "Pad1D", "Pad2D",
    "Pad3D", "ZeroPad2D", "Upsample", "UpsamplingNearest2D",
    "UpsamplingBilinear2D", "CosineSimilarity", "PairwiseDistance",
]


def tp_meta(p: nn.Parameter, tp_axis: Optional[int] = None) -> nn.Parameter:
    """Set the reference ``Parameter``'s TP metadata on ``p``: the whole
    tensor (``is_distributed = False``) with the sharding hint
    ``tp_axis``."""
    p.is_distributed = False
    p.tp_axis = tp_axis
    return p


def param(shape, attr, default, device, dtype,
          generator: Optional[torch.Generator]) -> Optional[nn.Parameter]:
    """A parameter of ``shape`` drawn by ``attr`` (an initializer) or, for
    ``None``, by ``default`` (an initializer); ``None`` for ``attr=False``.
    ``device`` ``None`` is the card."""
    if attr is False:
        return None
    init = attr if attr is not None else default
    data = init(shape, to_torch_dtype(dtype), device=get_device(device),
                generator=generator)
    return tp_meta(nn.Parameter(data))


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, device: torch.device, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from .. import initializer as I

        self.in_features = in_features
        self.out_features = out_features
        self.weight = param([in_features, out_features], None,
                            I._default_weight_init(), device, dtype,
                            generator)
        self.bias = (param([out_features], None, I._default_bias_init(),
                           device, dtype, generator) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = amp_cast("linear", x, self.weight, self.bias)
        y = torch.matmul(x, w)
        return y if b is None else y + b

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 device: torch.device, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = torch.empty(num_embeddings, embedding_dim, device=device,
                        dtype=dtype)
        w.normal_(0.0, 1.0, generator=generator)
        self.weight = tp_meta(nn.Parameter(w))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return amp_cast("embedding", self.weight)[ids.long()]

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Dropout(nn.Module):
    """``F.dropout`` in training, the identity (or, for
    ``downscale_in_infer``, the ``1 - p`` scaling) in eval mode."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}, mode={self.mode}"


class Dropout2D(nn.Module):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(nn.Module):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(nn.Module):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class _PadNd(nn.Module):
    ndim_spatial = 2

    def __init__(self, padding, mode="constant", value=0.0, data_format=None,
                 name=None):
        super().__init__()
        if isinstance(padding, int):
            padding = [padding] * (2 * self.ndim_spatial)
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format or ("NCL", "NCHW",
                                           "NCDHW")[self.ndim_spatial - 1]

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_PadNd):
    ndim_spatial = 1


class Pad2D(_PadNd):
    ndim_spatial = 2


class Pad3D(_PadNd):
    ndim_spatial = 3


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format, name)


class Upsample(nn.Module):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format, name)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format, name)


class CosineSimilarity(nn.Module):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(nn.Module):
    """The reference layer's formula, ``(sum(|x - y| ** p) + epsilon) **
    (1 / p)`` (its functional adds ``epsilon`` inside instead)."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        x, y = amp_cast("pairwise_distance", x, y)
        s = ((x - y).abs() ** self.p).sum(dim=-1, keepdim=self.keepdim)
        return (s + self.epsilon) ** (1.0 / self.p)
