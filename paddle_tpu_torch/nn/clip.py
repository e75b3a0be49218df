"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

Each ``ClipGrad*`` is a callable the optimizer applies to its
``(param, grad)`` list before the update (``Optimizer(grad_clip=...)`` or a
param group's ``grad_clip``); a parameter with ``need_clip = False`` keeps
its gradient. Every norm is an f32 device tensor and the scale is applied
by multiplication, so nothing reads a value back to the host and no branch
depends on one: a step that clips is capturable as a CUDA graph. The
reference leaves these ops to XLA; here they are plain torch ops in the
reference's order (the global norm sums the per-tensor squares one by
one, in list order).
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]


def _sq_sum(g: torch.Tensor) -> torch.Tensor:
    return g.float().square().sum()


def _clippable(p, g) -> bool:
    return g is not None and getattr(p, "need_clip", True)


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)

    def _clip(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clippable(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an f32 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clippable(p, g):
                norm = torch.sqrt(_sq_sum(g))
                scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                    max=1.0)
                g = _scaled(g, scale)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All clippable gradients scaled by ``min(clip_norm / ||g||, 1)``, the
    norm taken in f32 over all of them together."""

    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _total_sq(self, clippable):
        total = _sq_sum(clippable[0][1])
        for _, g in clippable[1:]:
            total = total + _sq_sum(g)
        return total

    def global_norm(self, params_grads) -> torch.Tensor:
        """The f32 global norm of the clippable gradients (a device
        scalar)."""
        return torch.sqrt(self._total_sq(
            [(p, g) for p, g in params_grads if _clippable(p, g)]))

    def _clip(self, params_grads):
        if not any(_clippable(p, g) for p, g in params_grads):
            return params_grads
        norm = self.global_norm(params_grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return [(p, _scaled(g, scale) if _clippable(p, g) else g)
                for p, g in params_grads]


def _as_list(parameters):
    if isinstance(parameters, torch.Tensor):
        return [parameters]
    return list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients in place so their total ``norm_type`` norm is
    at most about ``max_norm`` (scale ``max_norm / (total + 1e-6)`` where
    that is below 1); returns the total norm as an f32 device scalar. The
    reference's host branch on ``scale < 1`` is a multiplication by
    ``min(scale, 1)`` here: a factor of exactly 1 leaves every gradient's
    bits as they were."""
    params = _as_list(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return None
    norm_type = float(norm_type)
    if norm_type == float("inf"):
        total = grads[0].abs().max().float()
        for g in grads[1:]:
            total = torch.maximum(total, g.abs().max().float())
    else:
        acc = grads[0].float().abs().pow(norm_type).sum()
        for g in grads[1:]:
            acc = acc + g.float().abs().pow(norm_type).sum()
        total = acc.pow(1.0 / norm_type)
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.copy_(_scaled(g, scale))
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every gradient to ``[-clip_value, clip_value]`` in place."""
    for p in _as_list(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
