"""What the vision models share: the device, dtype and generator their
layers are built with (``device=None`` is the card, ``device="cpu"`` the
CPU; weights are drawn from ``generator``, by default the seeded generator
of the device, ``base/random.py``)."""
from __future__ import annotations

from ...base.device import get_device
from ...base.dtype import to_torch_dtype
from ...base.random import get_generator


def layer_kw(device, dtype, generator) -> dict:
    """The keywords a ``Conv2D`` or ``Linear`` of the port is built with."""
    dev = get_device(device)
    return dict(device=dev, dtype=to_torch_dtype(dtype),
                generator=generator if generator is not None
                else get_generator(dev))


def norm_kw(kw: dict) -> dict:
    """Those of a norm layer (ones and zeros: it draws nothing)."""
    return dict(device=kw["device"], dtype=kw["dtype"])
