"""``to_static`` and ``StaticFunction`` (counterpart of ``paddle_tpu/jit``).

In this slice the step runs eagerly: ``to_static(fn, layers=...,
optimizers=...)`` returns a :class:`StaticFunction` whose ``__call__`` runs
``fn`` and whose ``multi_step`` runs K steps with the learning rate held
constant and returns the K outputs as one device tensor, with no host read
between steps. Capturing the step (CUDA graphs) is later work; there is no
dy2static or piecewise machinery.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["to_static", "StaticFunction"]


class StaticFunction:
    """A train or eval step with its layers and optimizers named up front
    (the reference threads their state through its compiled program; here
    the optimizers are read for the learning rate only, and ``layers`` is
    accepted for the reference's signature)."""

    def __init__(self, fn, layers: Sequence[torch.nn.Module] = (),
                 optimizers: Sequence = ()):
        self._fn = fn
        self._optimizers = list(optimizers)

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)

    def multi_step(self, *stacked_args, steps: Optional[int] = None
                   ) -> torch.Tensor:
        """Run K steps; returns the K outputs stacked, ``[K, ...]``.

        With ``steps=K`` the same arguments feed every step; without it,
        each argument carries a leading axis of length K (per-step data).
        Each optimizer's learning rate is held at its current value across
        the K steps, as in the reference (a scheduler cannot step inside
        them)."""
        if steps is not None:
            per_step = [stacked_args] * int(steps)
        elif stacked_args:
            per_step = [tuple(a[i] for a in stacked_args)
                        for i in range(len(stacked_args[0]))]
        else:
            raise ValueError("multi_step needs steps= or stacked arguments")
        outs = []
        for o in self._optimizers:
            o._lr_override = o.get_lr()
        try:
            for args in per_step:
                outs.append(self._fn(*args).detach())
        finally:
            for o in self._optimizers:
                o._lr_override = None
        return torch.stack(outs)


def to_static(function, layers: Sequence[torch.nn.Module] = (),
              optimizers: Sequence = ()) -> StaticFunction:
    """``to_static(fn, layers=[...], optimizers=[...])`` -> a
    :class:`StaticFunction` over ``fn`` (it runs eagerly in this slice)."""
    return StaticFunction(function, layers=layers, optimizers=optimizers)
