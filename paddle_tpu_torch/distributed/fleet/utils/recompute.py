"""Activation recomputation (counterpart of
``paddle_tpu/distributed/fleet/utils/recompute.py``; ref:
python/paddle/distributed/fleet/recompute/recompute.py:93-147
RecomputeFunction, recompute_sequential; recompute_hybrid.py:171-183).

:func:`recompute` keeps only a segment's inputs in the forward and reruns
the segment under grad in the backward, through
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: gradients reach
the parameters the segment uses whatever its inputs need, so no parameter
is discovered or passed. A tensor-parallel segment reruns its forward
collectives in the backward; every rank reruns the same segments in the
same order.

RNG. The port draws from explicit generators (``base/random.py``), which
``torch.utils.checkpoint``'s ``preserve_rng_state`` does not restore (it
restores torch's default CPU and CUDA generators, which it still does). So
before the first run the segment's streams are captured
(``random.capture_rng``: the current default generator and the tracker's
branches), and the rerun draws from them again (``random.replay_rng``),
leaving every stream where the backward found it. The reference's two
rules follow: the rerun draws the first run's dropout masks, and two
sequential segments never reuse a stream (the second draws after the
first).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint as _ckpt

from ....base import random as _random

__all__ = ["recompute", "recompute_sequential", "recompute_hybrid"]


def recompute(function, *args, use_reentrant: bool = True,
              preserve_rng_state: bool = True, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward instead of stored. ``function`` is any callable (a module, a
    bound method, a closure). ``use_reentrant`` is accepted for parity:
    both values run the non-reentrant mechanism. With
    ``preserve_rng_state`` the rerun draws what the first run drew."""
    captured = _random.capture_rng() if preserve_rng_state else None
    runs = [0]

    def run(*a):
        runs[0] += 1
        if runs[0] == 1 or captured is None:
            return function(*a, **kwargs)
        with _random.replay_rng(captured):
            return function(*a, **kwargs)

    return _ckpt.checkpoint(run, *args, use_reentrant=False,
                            preserve_rng_state=preserve_rng_state)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """A ``torch.nn.Sequential`` (or a list of modules) run in
    ``ctx["segments"]`` recomputed segments of consecutive modules (ref:
    recompute_sequential); each segment's output is the next one's
    input."""
    segments = (int(ctx.get("segments", 1)) if isinstance(ctx, dict)
                else int(ctx or 1))
    modules = list(functions)
    if segments <= 1:
        chunks = [modules]
    else:
        size = (len(modules) + segments - 1) // segments
        chunks = [modules[i:i + size] for i in range(0, len(modules), size)]
    out = args
    for chunk in chunks:
        res = recompute(torch.nn.Sequential(*chunk), *out, **kwargs)
        out = res if isinstance(res, tuple) else (res,)
    return out[0] if len(out) == 1 else out


def recompute_hybrid(ctx, function, *args, **kwargs):
    """Recompute inside hybrid parallelism (ref: recompute_hybrid.py:171-183):
    ``ctx`` (``{"mp_group": ..., "offload": bool}``) is dropped, as the
    reference drops it; the tracker's branches are replayed as in
    :func:`recompute`."""
    del ctx
    return recompute(function, *args, **kwargs)
