"""Seeded ``torch.Generator``s (counterpart of ``paddle_tpu/base/random.py``):
one per device for parameter init, and one per device for the optimizer's
stochastic-rounding salts, so drawing salts never shifts the init stream.

JAX's threefry and torch's Philox streams never agree, so no parity test
goes through these generators: the tests carry the JAX package's weights
into the port instead (``utils/convert.py``) and pin the salts.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

__all__ = ["seed", "get_generator", "sr_generator", "sr_salts"]

_seed = 0
_generators: Dict[str, torch.Generator] = {}
_sr_generators: Dict[str, torch.Generator] = {}
# the salt stream's seed differs from the init stream's by this constant
_SR_STREAM = 0x5A17


def seed(value: int) -> int:
    """Set the process seed; every per-device generator restarts from it.
    Existing generators are re-seeded in place, so a CUDA graph that
    registered one (``jit.to_static``) draws the new stream on its next
    replay."""
    global _seed
    _seed = int(value)
    for gen in _generators.values():
        gen.manual_seed(_seed)
    for gen in _sr_generators.values():
        gen.manual_seed(_seed + _SR_STREAM)
    return _seed


def _key(dev: torch.device) -> str:
    """One key per device: ``cuda`` and ``cuda:<current>`` are one card."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def get_generator(device: Optional[Union[str, torch.device]] = None
                  ) -> torch.Generator:
    """The generator for ``device``, seeded from the last :func:`seed`
    (created on first use; ``None`` means the CUDA card)."""
    from .device import get_device

    dev = get_device(device)
    key = _key(dev)
    gen = _generators.get(key)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(_seed)
        _generators[key] = gen
    return gen


def sr_generator(device: Union[str, torch.device]) -> torch.Generator:
    """The salt generator of ``device``, seeded from the last :func:`seed`
    (created on first use)."""
    dev = torch.device(device)
    key = _key(dev)
    gen = _sr_generators.get(key)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(_seed + _SR_STREAM)
        _sr_generators[key] = gen
    return gen


def sr_salts(device: Union[str, torch.device], n: Optional[int] = None
             ) -> torch.Tensor:
    """Two uint32 salts for one stochastic-rounding writeback, as an int64
    ``[2]`` tensor (``[n, 2]`` for n writebacks, in one draw) drawn on
    ``device`` from its salt generator; no value comes back to the host."""
    dev = torch.device(device)
    return torch.randint(0, 2 ** 32, (2,) if n is None else (n, 2),
                         dtype=torch.int64, device=dev,
                         generator=sr_generator(dev))
