"""Carry the JAX package's parameters into the port, name for name.

The caller builds ``arrays`` from a ``paddle_tpu`` layer's
``named_parameters()`` (or ``named_buffers()``) with ``np.asarray``, so this
package never imports ``paddle_tpu``. The port's modules carry the
reference's names (Llama, GPT, BERT and the SD UNet alike: containers
index their sub-layers ``"0"``, ``"1"``, ... as the reference's do, and a
``LayerList`` slot holding ``None`` owns no parameter in either). Paddle's
``Linear`` weight layout ``[in, out]`` is kept by the port, and a
convolution's weight is ``[out, in / groups, *kernel]`` (transposed: ``[in,
out / groups, *kernel]``) in both packages, so no array is transposed. A
tensor-parallel shard (``is_distributed``, with its ``tp_axis``) takes
its rank's slice of the whole array (of each part of a fused qkv, which
``fleet`` cuts part by part), so the reference's full arrays load
into every rank of a tensor-parallel model. The same holds for a pipeline
stage's stacked parameters (``_pp_rows = (stage, S)``: the stage's V rows
of the reference's ``[S·V, ...]`` array, which are contiguous) and for an
expert-parallel rank's experts (``_ep_shard = (rank, ep)``: its E/ep rows
along ``ep_axis``); the names a pipeline stage leaves to the other stages
(a ``PipelineLayer``'s ``_pp_elsewhere``) are skipped.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_jax_params", "load_jax_buffers"]


def _cut(a: np.ndarray, t: torch.Tensor, shard, axis,
         groups: int = 1) -> np.ndarray:
    """Part ``rank`` of ``n`` of ``a`` along ``axis`` (``shard = (rank,
    n)``), where ``a`` is ``t``'s whole; ``a`` itself otherwise (the
    caller's shape check names a mismatch). With ``groups`` > 1 the axis
    is that many equal parts (a fused qkv's q, k and v), each cut alone
    and the rank's cuts laid side by side, as ``fleet`` cuts the shard."""
    if shard is None or tuple(a.shape) == tuple(t.shape):
        return a
    rank, n = shard
    if a.ndim != t.dim() or a.shape[axis] != n * t.shape[axis]:
        return a
    parts = np.split(a, groups, axis=axis)
    return np.concatenate([np.split(g, n, axis=axis)[rank] for g in parts],
                          axis=axis)


def _tp_slice(t: torch.Tensor, a: np.ndarray) -> np.ndarray:
    """A sharded tensor's slice of the whole array ``a``: a
    tensor-parallel shard's part along its ``tp_axis`` (``_tp_shard =
    (rank, degree)``), a pipeline stage's stacked rows (``_pp_rows``), an
    expert-parallel rank's experts (``_ep_shard``); ``a`` itself
    otherwise, or where it has the tensor's shape already."""
    shard = getattr(t, "_tp_shard", None)
    if shard is not None and getattr(t, "is_distributed", False):
        a = _cut(a, t, shard, t.tp_axis, getattr(t, "tp_groups", 1))
    a = _cut(a, t, getattr(t, "_pp_rows", None), 0)
    return _cut(a, t, getattr(t, "_ep_shard", None),
                getattr(t, "ep_axis", None) or 0)


def _elsewhere(module: torch.nn.Module) -> set:
    """The parameter names a pipeline stage in ``module`` leaves to the
    other stages (prefixed with the stage's own name)."""
    out = set()
    for prefix, m in module.named_modules():
        for n in getattr(m, "_pp_elsewhere", ()):
            out.add(f"{prefix}.{n}" if prefix else n)
    return out


def _load_named(kind: str, named: Mapping[str, torch.Tensor],
                arrays: Mapping[str, np.ndarray], elsewhere=()) -> None:
    missing = sorted(set(named) - set(arrays))
    extra = sorted(set(arrays) - set(named) - set(elsewhere))
    if missing or extra:
        raise KeyError(f"{kind} names differ: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, t in named.items():
            # a writable copy numpy can hand torch: f32 for floats (numpy
            # has no bfloat16 torch can read), int64 for integers
            a = np.asarray(arrays[name])
            full = tuple(a.shape)
            a = _tp_slice(t, a)
            a = np.array(a, dtype=(np.float32 if t.is_floating_point()
                                   else np.int64))
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {full} matches neither "
                                 f"{tuple(t.shape)} nor its sharded whole")
            # in place: the destination keeps its strides and address
            t.copy_(torch.from_numpy(a).to(device=t.device, dtype=t.dtype))


def load_jax_params(module: torch.nn.Module,
                    arrays: Mapping[str, np.ndarray]) -> None:
    """Copy ``arrays[name]`` into every parameter of ``module`` (cast to the
    parameter's dtype, on its device); a tensor-parallel shard takes its
    rank's slice of the whole array, a pipeline stage its rows, an
    expert-parallel rank its experts; a pipeline stage skips the names
    other stages hold. Raises ``KeyError`` when a name is missing or left
    over, ``ValueError`` on a shape that matches neither the parameter nor
    its whole."""
    _load_named("parameter", dict(module.named_parameters()), arrays,
                _elsewhere(module))


def load_jax_buffers(module: torch.nn.Module,
                     arrays: Mapping[str, np.ndarray]) -> None:
    """``load_jax_params`` for ``module.named_buffers()``: the fp8 amax
    histories, int8 ``qweight``/``scale``, quanter state. The caller builds
    ``arrays`` from the ``paddle_tpu`` layer's ``named_buffers()``."""
    _load_named("buffer", dict(module.named_buffers()), arrays)
