"""In-memory cross-topology reshard of sharded training state
(counterpart of ``paddle_tpu/distributed/checkpoint/reshard.py``).

The file checkpoint (``distributed/checkpoint``) reshards across
topologies: save writes per-rank shard files keyed by global offset, load
assembles by offset and fills the CURRENT tensors. The peer-RAM recovery
tier (``training/peer_snapshot.py``) needs the same property without
touching disk: each rank serializes only the shards it holds, a (possibly
different) future incarnation gathers every rank's payload and assembles
the full host tree, then places it on whatever layout it runs.

Where a shard lies. The reference reads each shard's offset from its
``jax.Array``'s sharding. A port tensor is a plain local tensor; the
wrapper that cut it knows its place, and this module asks it, never the
shapes: :func:`layer_placements` / :func:`optimizer_placements` read group
sharding's ``_Shard`` (``distributed/sharding``: the dimension, the whole
shape, the rank's offset) and a tensor-parallel weight's ``tp_axis`` with
its ``_tp_shard = (rank, degree)`` (a fused qkv's shard, cut in each of
its ``tp_groups`` parts, is no one block: it raises). :func:`place`
wraps the local tensors of a state tree as :class:`Placed` leaves (the
tensor, its global shape, its global offset); :func:`dumps_sharded` writes each as a ``_SHARD_TAG``
dict {global_shape, dtype, shards by offset}; every other leaf takes
``framework.io``'s host form. bf16 travels as raw ``uint16`` with the dtype
name ``bfloat16`` (the card's machine has no ``ml_dtypes``); the values
are the reference's bit for bit, and the reference's own payloads (bf16 as
``ml_dtypes`` arrays) assemble here through their bits.

Assembly (:func:`loads_combined`) is coverage-checked: a hole in the
offset map — a rank's payload missing from the gather — raises, it never
yields silently-zeroed state. Layout validation is the explicit error path
the elastic resume relies on: restoring onto a layout whose sharding
degree divides no dimension of a saved-sharded tensor raises
:class:`ReshardLayoutError` (a ``ValueError``) naming BOTH layouts —
permanent, not a tier to fall back from. The assembled tree is
layout-free: full host tensors.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["ReshardLayoutError", "dumps_sharded", "loads_combined",
           "sharded_leaf_count", "Placed", "place", "layer_placements",
           "optimizer_placements"]

_SHARD_TAG = "__paddle_tpu_shard__"
_PROTOCOL = 4


class ReshardLayoutError(ValueError):
    """Restoring sharded state onto an incompatible topology: some
    saved-sharded tensor has no dimension divisible by the target
    layout's sharding degree. Permanent — retrying or falling back to an
    older snapshot of the SAME layout cannot fix a layout mismatch."""


class Placed:
    """A rank's local shard of a tensor and its place in the whole:
    ``global_shape`` and ``offset`` (the shard's first index along each
    dimension)."""

    __slots__ = ("tensor", "global_shape", "offset")

    def __init__(self, tensor: torch.Tensor, global_shape, offset):
        self.tensor = tensor
        self.global_shape = tuple(int(d) for d in global_shape)
        self.offset = tuple(int(o) for o in offset)
        if len(self.offset) != len(self.global_shape) or any(
                o + s > g for o, s, g in zip(self.offset, tensor.shape,
                                              self.global_shape)):
            raise ValueError(
                f"shard of shape {tuple(tensor.shape)} at offset "
                f"{self.offset} does not lie in {self.global_shape}")

    def __repr__(self):
        return (f"Placed({tuple(self.tensor.shape)} at {self.offset} of "
                f"{self.global_shape})")


# -- where each local tensor lies ---------------------------------------------
def _place_of(p: torch.Tensor, local_shape, group_sharded=None
              ) -> Optional[Tuple[tuple, tuple]]:
    """(global shape, offset) of a tensor of ``local_shape`` that belongs
    to parameter ``p`` (the parameter's data or one of its optimizer
    accumulators), or None where it is whole."""
    local_shape = tuple(int(d) for d in local_shape)
    s = group_sharded.shards.get(p) if group_sharded is not None else None
    if s is not None and s.dim is not None and local_shape != s.shape:
        off = [0] * len(s.shape)
        off[s.dim] = s.rank * (s.shape[s.dim] // s.degree)
        return tuple(s.shape), tuple(off)
    tp = getattr(p, "_tp_shard", None)
    if tp is not None and getattr(p, "is_distributed", False) \
            and len(local_shape) == p.dim():
        if getattr(p, "tp_groups", 1) > 1:
            raise ReshardLayoutError(
                f"a tensor-parallel shard of shape {local_shape} cut in "
                f"each of {p.tp_groups} parts along axis {p.tp_axis} (a "
                "fused qkv's q, k and v) is not one block of the whole; "
                "gather it whole before placing it")
        rank, degree = tp
        axis = p.tp_axis
        whole = list(local_shape)
        whole[axis] *= degree
        off = [0] * len(whole)
        off[axis] = rank * local_shape[axis]
        return tuple(whole), tuple(off)
    return None


def layer_placements(layer) -> Dict[str, Tuple[tuple, tuple]]:
    """``state_dict`` key -> (global shape, offset) for every parameter of
    ``layer`` this rank holds a shard of (group sharding's stage 3, a
    tensor-parallel weight)."""
    gs = getattr(layer, "_group_sharded", None)
    out = {}
    for name, p in layer.named_parameters():
        pl = _place_of(p, p.shape, gs)
        if pl is not None:
            out[name] = pl
    return out


def optimizer_placements(opt, layers: Sequence = ()
                         ) -> Dict[str, Tuple[tuple, tuple]]:
    """The same for an optimizer's ``state_dict`` keys
    (``<param name>.<accumulator>``): an accumulator of the shard's shape
    lies where its parameter's shard lies; scalars are whole."""
    sharders = [getattr(m, "_group_sharded", None) for m in layers]
    sharders = [g for g in sharders if g is not None]
    by_name = {opt._name(p): p for p in opt._parameter_list}
    out = {}
    for accum, store in opt._accumulators.items():
        for pname, t in store.items():
            p = by_name.get(pname)
            if p is None or t.dim() == 0:
                continue
            gs = next((g for g in sharders if p in g.shards), None)
            pl = _place_of(p, t.shape, gs)
            if pl is not None:
                out[f"{pname}.{accum}"] = pl
    return out


def place(state: dict, placements: Dict[str, Tuple[tuple, tuple]]) -> dict:
    """``state`` (a flat ``state_dict``) with each placed key's tensor
    wrapped as a :class:`Placed` leaf."""
    return {k: (Placed(v, *placements[k]) if k in placements
                and isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}


# -- numpy forms of a shard (bf16 as its bits) ---------------------------------
def _host_array(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    from ...framework import io as fio

    arr = fio.to_numpy(t)
    return arr, ("bfloat16" if t.dtype == torch.bfloat16 else str(arr.dtype))


def _fill(path: str, shape, dtype: str, pieces) -> np.ndarray:
    """The whole array of ``shape`` from ``pieces`` ((offset, array) pairs;
    bf16 as ``uint16`` bits, or the reference's ``ml_dtypes`` arrays read
    through their bits), coverage-checked: a hole raises."""
    shape = tuple(shape)
    full = np.zeros(shape, np.uint16 if dtype == "bfloat16" else dtype)
    covered = np.zeros(shape, np.bool_)
    for offset, data in pieces:
        data = np.asarray(data)
        if dtype == "bfloat16":
            data = data.view(np.uint16)
        slices = tuple(slice(o, o + s) for o, s in zip(offset, data.shape))
        full[slices] = data
        covered[slices] = True
    if not covered.all():
        raise ValueError(
            f"incomplete shard coverage for {path!r}: "
            f"{int((~covered).sum())}/{covered.size} elements missing — "
            "a rank's payload is absent from the gather")
    return full


def _shard_leaf(pl: Placed, *, tensor: bool) -> dict:
    arr, dtype = _host_array(pl.tensor)
    return {
        _SHARD_TAG: 1,
        "global_shape": pl.global_shape,
        "dtype": dtype,
        "tensor": bool(tensor),
        "stop_gradient": not pl.tensor.requires_grad,
        "name": None,  # torch tensors carry no name
        "shards": {pl.offset: arr},
    }


def _strip_sharded(obj):
    """Replace :class:`Placed` leaves with ``_SHARD_TAG`` dicts so the rest
    of the tree can go through ``framework.io``'s host serialization."""
    if isinstance(obj, Placed):
        return _shard_leaf(obj, tensor=True)
    if isinstance(obj, dict):
        return {k: _strip_sharded(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_strip_sharded(v) for v in obj)
    return obj


def dumps_sharded(state, layout: Optional[dict] = None) -> bytes:
    """Serialize this rank's view of ``state``: :class:`Placed` leaves
    carry only this rank's shard, everything else the usual
    ``framework.io`` host form. ``layout`` (e.g. ``{"world": 2, "mesh":
    {"sharding": 2}}``) rides along so the restoring side can name the
    saved topology in errors and count reshard-on-resume events."""
    from ...framework import io as fio

    tree = fio._to_serializable(_strip_sharded(state))
    return pickle.dumps({"layout": layout, "state": tree},
                        protocol=_PROTOCOL)


def _validate_leaf(path: str, global_shape: Tuple[int, ...],
                   saved_layout, target_layout) -> None:
    mesh = (target_layout or {}).get("mesh", {})
    for axis, degree in mesh.items():
        degree = int(degree)
        if degree <= 1:
            continue
        if not any(d % degree == 0 and d >= degree for d in global_shape):
            raise ReshardLayoutError(
                f"cannot reshard {path!r} of global shape "
                f"{tuple(global_shape)}: saved on layout {saved_layout!r} "
                f"but the target layout {target_layout!r} shards axis "
                f"{axis!r} {degree}-way and no dimension is divisible "
                f"by {degree}")


def _assemble(path: str, leaves: List[dict], saved_layout,
              target_layout) -> Any:
    """Merge one sharded leaf's shard maps from every payload into the
    full host array; coverage-checked against the global shape. A tensor
    leaf comes back in ``framework.io``'s tagged form (the caller's
    ``_from_serializable`` makes the tensor)."""
    from ...framework import io as fio

    head = leaves[0]
    shape = tuple(head["global_shape"])
    dtype = str(head["dtype"])
    _validate_leaf(path, shape, saved_layout, target_layout)
    full = _fill(path, shape, dtype, [
        item for leaf in leaves for item in leaf["shards"].items()])
    if head["tensor"]:
        out = {fio._TENSOR_TAG: 1, "array": full,
               "stop_gradient": head["stop_gradient"], "name": None}
        if dtype == "bfloat16":
            out["dtype"] = "bfloat16"
        return out
    return full


def _combine(path: str, nodes: List[Any], saved_layout,
             target_layout) -> Any:
    head = nodes[0]
    if isinstance(head, dict) and head.get(_SHARD_TAG) == 1:
        return _assemble(path, nodes, saved_layout, target_layout)
    if isinstance(head, dict):
        return {k: _combine(f"{path}.{k}" if path else str(k),
                            [n[k] for n in nodes], saved_layout,
                            target_layout)
                for k in head}
    if isinstance(head, (list, tuple)) and not hasattr(head, "_fields"):
        return type(head)(
            _combine(f"{path}[{i}]", [n[i] for n in nodes],
                     saved_layout, target_layout)
            for i in range(len(head)))
    return head  # host leaf / scalar: identical on every rank, take 0's


def loads_combined(payloads: Sequence[bytes], *,
                   target_layout: Optional[dict] = None):
    """Assemble every rank's :func:`dumps_sharded` payload into one
    full-host state tree. Returns ``(state, saved_layout)``.

    ``target_layout`` (same shape as the saved one) turns on the explicit
    compatibility check: any saved-sharded leaf with no dimension
    divisible by a target mesh axis degree raises
    :class:`ReshardLayoutError` naming both layouts. Assembly itself is
    layout-free — the full host tree restores onto ANY compatible layout.
    """
    from ...framework import io as fio

    if not payloads:
        raise ValueError("no shard payloads to combine")
    trees, layouts = [], []
    for p in payloads:
        blob = pickle.loads(p)
        trees.append(blob["state"])
        layouts.append(blob["layout"])
    saved_layout = layouts[0]
    state = _combine("", trees, saved_layout, target_layout)
    return fio._from_serializable(state, False), saved_layout


def sharded_leaf_count(payload: bytes) -> int:
    """How many sharded leaves one payload carries (diagnostics: 0 means
    the state was effectively replicated and a single payload restores
    alone)."""
    blob = pickle.loads(payload)

    def walk(obj) -> int:
        if isinstance(obj, dict):
            if obj.get(_SHARD_TAG) == 1:
                return 1
            return sum(walk(v) for v in obj.values())
        if isinstance(obj, (list, tuple)):
            return sum(walk(v) for v in obj)
        return 0

    return walk(blob["state"])
