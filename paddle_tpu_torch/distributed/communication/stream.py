"""Stream-variant collectives (counterpart of
``paddle_tpu/distributed/communication/stream.py``; ref:
python/paddle/distributed/communication/stream/__init__.py, 11 names).

The reference's stream API chooses which CUDA stream a NCCL collective
runs on (``use_calc_stream=True`` skips the comm-stream hop). The port's
collectives run where ``torch.distributed`` puts them (NCCL orders its own
stream after the caller's), so every stream variant is the plain
collective: ``use_calc_stream`` is accepted and ignored, and each call
returns what the plain call returns."""
from __future__ import annotations

import functools

from . import (
    all_gather as _all_gather,
    all_reduce as _all_reduce,
    alltoall as _alltoall,
    alltoall_single as _alltoall_single,
    broadcast as _broadcast,
    gather as _gather,
    recv as _recv,
    reduce as _reduce,
    reduce_scatter as _reduce_scatter,
    scatter as _scatter,
    send as _send,
)

__all__ = [
    "all_gather", "all_reduce", "alltoall", "alltoall_single", "broadcast",
    "reduce", "reduce_scatter", "recv", "scatter", "send", "gather",
]


def _stream_variant(fn):
    @functools.wraps(fn)
    def wrapped(*args, use_calc_stream: bool = False, **kwargs):
        return fn(*args, **kwargs)

    wrapped.__doc__ = (
        f"stream.{fn.__name__} (ref: communication/stream/"
        f"{fn.__name__}.py) — see the module's docstring; delegates to "
        f"distributed.{fn.__name__}."
    )
    return wrapped


all_gather = _stream_variant(_all_gather)
all_reduce = _stream_variant(_all_reduce)
alltoall = _stream_variant(_alltoall)
alltoall_single = _stream_variant(_alltoall_single)
broadcast = _stream_variant(_broadcast)
reduce = _stream_variant(_reduce)
reduce_scatter = _stream_variant(_reduce_scatter)
recv = _stream_variant(_recv)
scatter = _stream_variant(_scatter)
send = _stream_variant(_send)
gather = _stream_variant(_gather)
