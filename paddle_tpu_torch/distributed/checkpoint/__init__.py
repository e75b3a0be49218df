"""Distributed checkpoint (counterpart of
``paddle_tpu/distributed/checkpoint/__init__.py``; ref:
python/paddle/distributed/checkpoint/save_state_dict.py:104,
load_state_dict.py, metadata.py).

Per-rank shard files plus a global metadata plan, as in the reference:

- save: each rank writes ``{rank}_0.distcp``, its shards keyed
  ``<key>@<offset>`` by global offset; the coordinator writes
  ``0.metadata``, mapping each tensor to its global shape, dtype and
  [(offset, shape, file)] over every rank (the ranks' plans are gathered
  with one ``all_gather_object``). A sharded leaf is a
  :class:`reshard.Placed` (its place comes from the wrapper that cut it:
  ``reshard.place(sd, reshard.layer_placements(layer))``); a plain tensor
  is whole and written once, by the coordinator.
- load: shards are read, assembled by offset, coverage-checked, and
  copied INTO the current tensors in place, whatever their layout now: a
  :class:`Placed` target takes its own slice of the whole, a plain one
  the whole. Save on two ranks, load on one (or the other way) reshards.

bf16 is written as raw ``uint16`` with the dtype name ``bfloat16`` in the
plan (the card's machine has no ``ml_dtypes``); the values are the
reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import reshard  # noqa: F401 — in-RAM cross-topology reshard
from .reshard import Placed

__all__ = ["save_state_dict", "load_state_dict", "reshard"]

_META_FILE = "0.metadata"


@dataclasses.dataclass
class _ShardInfo:
    """One saved shard of one tensor (ref: metadata.py LocalTensorMetadata)."""

    global_offset: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    file_name: str


def _flatten(state_dict, prefix=""):
    flat = {}
    for k, v in state_dict.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _flatten_with_parents(state_dict, prefix=""):
    """Like _flatten but yields (key, value, parent_dict, parent_key) so
    loads can rebind scalar leaves in place."""
    out = {}
    for k, v in state_dict.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten_with_parents(v, key))
        else:
            out[key] = (v, state_dict, k)
    return out


def _rank_world(process_group) -> Tuple[int, int]:
    from .. import parallel

    return (parallel.get_rank(process_group),
            parallel.get_world_size(process_group))


def _shard_key(key: str, offset) -> str:
    return f"{key}@{'_'.join(map(str, offset))}"


def save_state_dict(state_dict: Dict, path: str,
                    process_group=None, coordinator_rank: int = 0,
                    unique_id: Optional[int] = None,
                    async_save: bool = False):
    """Write a (possibly sharded) state_dict to the ``path`` directory.
    Every rank of ``process_group`` (default: the world) calls it."""
    from ...framework import io as fio

    os.makedirs(path, exist_ok=True)
    rank, world = _rank_world(process_group)
    flat = _flatten(state_dict)
    file_name = f"{rank}_0.distcp"
    plan: Dict[str, dict] = {"tensors": {}, "scalars": {}}
    payload: Dict[str, np.ndarray] = {}
    for key, val in flat.items():
        if isinstance(val, Placed):
            t, shape, offset = val.tensor, val.global_shape, val.offset
            owner = file_name
        elif isinstance(val, torch.Tensor):
            t, shape, offset = val, tuple(val.shape), (0,) * val.dim()
            owner = f"{coordinator_rank}_0.distcp"
        else:
            plan["scalars"][key] = val
            continue
        if owner == file_name:
            payload[_shard_key(key, offset)] = fio.to_numpy(t)
        plan["tensors"][key] = {
            "global_shape": tuple(int(s) for s in shape),
            "dtype": ("bfloat16" if t.dtype == torch.bfloat16
                      else str(fio.to_numpy(t.reshape(-1)[:0]).dtype)),
            "shards": [dataclasses.asdict(_ShardInfo(
                tuple(offset), tuple(int(s) for s in t.shape), owner))],
        }
    plans = [plan]
    if world > 1:
        from ..communication import all_gather_object

        plans = []
        all_gather_object(plans, plan, group=process_group)
    with open(os.path.join(path, file_name), "wb") as f:
        pickle.dump(payload, f, protocol=4)
    if rank == coordinator_rank:
        metadata: Dict[str, dict] = {"tensors": {}, "scalars": {}}
        for p in plans:
            metadata["scalars"].update(p["scalars"])
            for key, info in p["tensors"].items():
                have = metadata["tensors"].setdefault(
                    key, {**info, "shards": []})
                seen = {tuple(s["global_offset"]) for s in have["shards"]}
                have["shards"] += [s for s in info["shards"]
                                   if tuple(s["global_offset"]) not in seen]
        with open(os.path.join(path, _META_FILE), "wb") as f:
            pickle.dump(metadata, f, protocol=4)
    if world > 1:
        from ..communication import barrier

        barrier(group=process_group)  # the plan is on disk for every rank


def _whole(key: str, info: dict, payloads: Dict[str, np.ndarray]
           ) -> torch.Tensor:
    """One tensor assembled from its shards, coverage-checked."""
    from ...framework import io as fio

    dtype = str(info["dtype"])
    full = reshard._fill(key, info["global_shape"], dtype, [
        (sh["global_offset"], payloads[_shard_key(key, sh["global_offset"])])
        for sh in info["shards"]])
    return fio.from_numpy(full, dtype == "bfloat16")


def load_state_dict(state_dict: Dict, path: str,
                    process_group=None, coordinator_rank: int = 0,
                    unique_id: Optional[int] = None,
                    offload: bool = False):
    """Fill ``state_dict``'s tensors in place from ``path``: a
    :class:`reshard.Placed` target takes its slice of the saved whole, a
    plain tensor the whole (cross-topology reshard on load)."""
    meta_path = os.path.join(path, _META_FILE)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no checkpoint metadata at {meta_path}")
    with open(meta_path, "rb") as f:
        metadata = pickle.load(f)
    payloads: Dict[str, np.ndarray] = {}
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".distcp"):
            with open(os.path.join(path, fn), "rb") as f:
                payloads.update(pickle.load(f))
    flat = _flatten_with_parents(state_dict)
    missing: List[str] = []
    for key, (target, parent, pkey) in flat.items():
        if not isinstance(target, (Placed, torch.Tensor)):
            if key in metadata["scalars"]:
                parent[pkey] = metadata["scalars"][key]
            else:
                missing.append(key)
            continue
        info = metadata["tensors"].get(key)
        if info is None:
            missing.append(key)
            continue
        full = _whole(key, info, payloads)
        if isinstance(target, Placed):
            if tuple(full.shape) != target.global_shape:
                raise ValueError(
                    f"shape mismatch for {key}: saved {tuple(full.shape)} "
                    f"vs current whole {target.global_shape}")
            dst = target.tensor
            src = full[tuple(slice(o, o + s) for o, s in
                             zip(target.offset, dst.shape))]
        else:
            dst, src = target, full
            if tuple(full.shape) != tuple(dst.shape):
                raise ValueError(
                    f"shape mismatch for {key}: saved {tuple(full.shape)} "
                    f"vs current {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src.to(dst.dtype))
    if missing:
        raise KeyError(f"keys missing from checkpoint: {missing}")
