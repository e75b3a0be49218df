"""``save`` / ``load`` — object serialization (counterpart of
``paddle_tpu/framework/io.py``).

Tensors serialize as numpy arrays in the reference's plain-dict tag
(``{"__paddle_tpu_tensor__": 1, "array", "stop_gradient", "name"}``), so a
file holds only builtins and numpy and either package reads the other's
files. bf16 has no numpy dtype without ``ml_dtypes`` (which the card's
machine lacks): the port writes a bf16 tensor's raw ``uint16`` bits and
adds ``"dtype": "bfloat16"`` to its tag (the reference reads the ``uint16``
array; a reader views it as bfloat16), and reads the reference's
``ml_dtypes`` bfloat16 arrays through their bits. ``stop_gradient`` is
``not requires_grad``; a tensor's name is not kept (torch tensors have
none). Loaded tensors lie on the host; the caller moves
them (``set_state_dict`` / ``load_state_dict`` copy onto the module's
device).
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load", "dumps", "loads"]

_PROTOCOL = 4

# the reference's tag: a plain dict, not a framework class, so saved files
# contain only builtins + numpy and load without either package
_TENSOR_TAG = "__paddle_tpu_tensor__"


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 as its raw ``uint16``
    bits (numpy has no bfloat16, and the card's machine no ``ml_dtypes``)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().copy()
    return t.numpy().copy()


def from_numpy(a, bfloat16: bool = False) -> torch.Tensor:
    """Inverse of :func:`to_numpy` (``bfloat16``: ``a`` holds bf16 bits).
    An ``ml_dtypes`` bfloat16 array (the reference's files) is read
    through its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a, bfloat16 = a.view(np.uint16), True
    # np.array keeps a 0-d array 0-d (np.ascontiguousarray makes it 1-d)
    t = torch.from_numpy(np.array(a, order="C", copy=True))
    return t.view(torch.bfloat16) if bfloat16 else t


def _tensor_payload(t: torch.Tensor) -> dict:
    out = {
        _TENSOR_TAG: 1,
        "array": to_numpy(t),
        "stop_gradient": not t.requires_grad,
        "name": None,  # torch tensors carry no name
    }
    if t.dtype == torch.bfloat16:
        out["dtype"] = "bfloat16"
    return out


def _to_serializable(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return _tensor_payload(obj)
    if isinstance(obj, dict):
        if _TENSOR_TAG in obj:
            raise ValueError(
                f"cannot save a dict containing the reserved key {_TENSOR_TAG!r}"
            )
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_to_serializable(v) for v in obj)
    # anything else (scalars, strings, numpy arrays, ...) pickles directly
    return obj


def _from_serializable(obj: Any, return_numpy: bool) -> Any:
    if isinstance(obj, dict) and obj.get(_TENSOR_TAG) == 1:
        t = from_numpy(obj["array"], obj.get("dtype") == "bfloat16")
        if return_numpy:
            return to_numpy(t)
        if not obj.get("stop_gradient", True) and t.is_floating_point():
            t.requires_grad_(True)
        return t
    if isinstance(obj, dict):
        return {k: _from_serializable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_from_serializable(v, return_numpy) for v in obj)
    return obj


def save(obj: Any, path: str, pickle_protocol: int = _PROTOCOL, **configs):
    """Save a tensor / state dict / nested container to ``path``. Parent
    directories are created; a directory as ``path`` raises."""
    if os.path.isdir(path):
        raise ValueError(f"path must be a file name, got directory: {path}")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = _to_serializable(obj)
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle_protocol)


def dumps(obj: Any, pickle_protocol: int = _PROTOCOL) -> bytes:
    """:func:`save` to bytes instead of a file."""
    return pickle.dumps(_to_serializable(obj), protocol=pickle_protocol)


def loads(data: bytes, return_numpy: bool = False) -> Any:
    """Inverse of :func:`dumps`."""
    return _from_serializable(pickle.loads(data), return_numpy)


def load(path: str, return_numpy: bool = False, **configs) -> Any:
    """Load an object saved by :func:`save` (either package's).
    ``return_numpy=True`` gives numpy arrays (bf16 as raw ``uint16``)
    instead of tensors."""
    if not os.path.exists(path):
        raise ValueError(f"path not found: {path}")
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return _from_serializable(payload, return_numpy)
