"""Framework-level utilities (counterpart of ``paddle_tpu/framework``):
``save``/``load`` of tensors, state dicts and nested containers
(``io.py``), exported at the top level as ``paddle_tpu_torch.save`` and
``paddle_tpu_torch.load``."""
from __future__ import annotations

from . import io  # noqa: F401
from .io import dumps, load, loads, save  # noqa: F401

__all__ = ["io", "save", "load", "dumps", "loads"]
