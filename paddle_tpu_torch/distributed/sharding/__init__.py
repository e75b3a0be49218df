"""Group-sharded data parallelism, ZeRO stages 1-3 (counterpart of
``paddle_tpu/distributed/sharding/__init__.py``; ref:
python/paddle/distributed/sharding/group_sharded.py:41).

The reference makes each stage a placement policy over a mesh axis and
lets GSPMD derive the communication. The port runs one process per rank,
so each stage is eager sharding with its communication written out, over
the placement rule of the reference (:func:`_shard_spec`: a tensor is cut
along the first dimension the degree divides; one that has none is
replicated, with a warning when it is large):

- stage 1 (``os``): after the backward the gradients are averaged over the
  group (all-reduce); each rank then updates only its shard of each
  parameter, with the moments of that shard alone, and the updated shards
  are all-gathered back into the parameter after ``optimizer.step()``;
- stage 2 (``os_g``): as stage 1, but the gradients are reduce-scattered,
  so each rank keeps only its shard of each gradient;
- stage 3 (``p_g_os``): as stage 2, and between steps each rank keeps only
  its shard of each parameter: a forward pre-hook all-gathers every
  parameter before the forward, and the full parameters are freed after
  the backward's reduce-scatter (the reference's stage-3 hooks gather per
  layer; the port gathers the whole model at once).

During ``optimizer.step()`` a sharded parameter holds its shard (a
contiguous buffer, whatever its dimension), so the update, fused AdamW
kernel included, runs on shards; the optimizer's placement hooks (the
reference's ``_accum_placement_fn`` and ``_grad_placement_fn``) cut a
gradient or an accumulator of the whole shape to the rank's shard, and
each shard carries the flat index of its first element
(``_sr_index_base``), so a shard along dimension 0 draws the stochastic
rounding bits its elements draw under ``DataParallel``. Averaging is the
sum divided by the group size, as ``DataParallel``'s, so with stochastic
rounding off every stage's parameters are bitwise those of the
data-parallel step.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

import torch

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]

_LEVELS = ("os", "os_g", "p_g_os")


def _shard_spec(shape, degree: int, axis: str = "sharding") -> tuple:
    """The reference's rule (``_shard_spec``, :64-92) as a tuple of the
    ``PartitionSpec``'s entries: ``axis`` at the first dimension the degree
    divides, None elsewhere; all None (replicated) where none does, with a
    warning for a tensor of 2**16 elements or more."""
    spec = [None] * len(shape)
    for i, d in enumerate(shape):
        if d % degree == 0 and d >= degree:
            spec[i] = axis
            break
    else:
        numel = 1
        for d in shape:
            numel *= d
        if numel >= 1 << 16:
            warnings.warn(
                f"group sharding: tensor of shape {tuple(shape)} has no "
                f"axis divisible by the sharding degree {degree}; it will "
                "be REPLICATED on every shard (no memory saving). Pad "
                "the dimension (e.g. vocab) to a multiple of the degree "
                "to shard it.", stacklevel=3)
    return tuple(spec)


class _Shard:
    """One parameter's sharding: the dimension (None: replicated), its
    whole shape, and this rank's place in it."""

    def __init__(self, p: torch.Tensor, degree: int, rank: int):
        spec = _shard_spec(tuple(p.shape), degree)
        self.dim = next((i for i, a in enumerate(spec) if a), None)
        self.shape = tuple(p.shape)
        self.degree, self.rank = degree, rank
        self.full: Optional[torch.Tensor] = None  # the whole data, stages 1-2
        self.shard: Optional[torch.Tensor] = None  # stage 3's own shard
        if self.dim is None:
            self.offset = 0
        else:
            inner = 1
            for d in self.shape[self.dim + 1:]:
                inner *= d
            self.offset = rank * (self.shape[self.dim] // degree) * inner

    def local(self, t: torch.Tensor, copy: bool = True) -> torch.Tensor:
        """This rank's shard of a tensor of the whole shape: a contiguous
        copy, or (``copy=False``) a view where the shard is contiguous
        (along dimension 0 of a contiguous tensor), so that writing it
        writes the whole tensor."""
        c = t.chunk(self.degree, self.dim)[self.rank]
        return c.clone(memory_format=torch.contiguous_format) if copy or \
            not c.is_contiguous() else c


class _GroupSharded:
    """The stage's state and hooks, kept on the model as
    ``model._group_sharded``."""

    def __init__(self, model, optimizer, level: str, group):
        from ..parallel import init_parallel_env

        self.model, self.optimizer, self.level = model, optimizer, level
        params = [p for p in model.parameters() if p.requires_grad]
        if group is None:
            group = init_parallel_env(params[0].device if params else None)
        self.group = group
        self.shards: Dict[torch.Tensor, _Shard] = {
            p: _Shard(p, group.nranks, group.rank) for p in params}
        self._queued = False
        self._sync_params()
        optimizer._accum_placement_fn = self._place_accum
        optimizer._grad_placement_fn = self._place_grad
        # state made before the wrap is placed as new state would be
        by_name = {optimizer._name(p): p for p in params
                   if id(p) in optimizer._names}
        for name, store in optimizer._accumulators.items():
            for key in store:
                if key in by_name:
                    store[key] = self._place_accum(store[key], by_name[key],
                                                   name)
        self._hooks = [p.register_post_accumulate_grad_hook(self._on_grad)
                       for p in params]
        step = optimizer.step

        def sharded_step(*args, **kwargs):
            out = step(*args, **kwargs)
            self._after_step()
            return out

        optimizer.step = sharded_step
        if level == "p_g_os":
            with torch.no_grad():
                for p, s in self.shards.items():
                    if s.dim is not None:
                        s.shard = s.local(p.data)
                        p.data = s.shard
            self._pre = model.register_forward_pre_hook(self._gather_params)

    @torch.no_grad()
    def _sync_params(self):
        """Broadcast the parameters and buffers from the group's first rank,
        as ``DataParallel`` does at wrap."""
        from ..communication import broadcast

        src = self.group.ranks[0]
        for t in [*self.model.parameters(), *self.model.buffers()]:
            broadcast(t.data, src=src, group=self.group)

    # -- the optimizer's placement hooks ------------------------------------
    def _place_accum(self, t: torch.Tensor, param, name) -> torch.Tensor:
        """An accumulator of the parameter's whole shape becomes the rank's
        shard; a scalar or one made on the shard stays as it is."""
        s = self.shards.get(param)
        if s is None or s.dim is None or tuple(t.shape) != s.shape:
            return t
        return s.local(t)

    def _place_grad(self, g: torch.Tensor, param=None) -> torch.Tensor:
        """Stage 1's gradients arrive whole (all-reduced): each becomes the
        rank's shard. Stages 2-3 hand in shards already."""
        s = self.shards.get(param)
        if s is not None and s.dim is not None and tuple(g.shape) == s.shape:
            return s.local(g, copy=False)
        return g.contiguous()

    # -- after the backward ---------------------------------------------------
    def _on_grad(self, p):
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._after_backward)

    @torch.no_grad()
    def _after_backward(self):
        """Average the gradients over the group (stage 1: all-reduce;
        stages 2-3: reduce-scatter) and leave each sharded parameter
        holding its shard for the optimizer's step."""
        from ..communication import all_reduce, reduce_scatter

        self._queued = False
        n = self.group.nranks
        for p, s in self.shards.items():
            g = p.grad
            if g is None:
                continue
            if s.dim is None or self.level == "os":
                all_reduce(g, group=self.group)
                g.div_(n)
            else:
                parts = [c.contiguous() for c in g.chunk(n, s.dim)]
                g = torch.empty_like(parts[0])
                reduce_scatter(g, parts, group=self.group)
                g.div_(n)
            if s.dim is None:
                continue
            # stages 1-2 update the shard in place in the whole parameter
            # where it is contiguous there (dimension 0), else a copy
            if self.level == "os":
                # the whole averaged gradient stays; the optimizer's grad
                # placement hook cuts the rank's shard from it
                s.full = p.data
                p.data = s.local(s.full, copy=False)
            else:
                p.grad = None
                if self.level == "p_g_os":
                    p.data = s.shard
                else:
                    s.full = p.data
                    p.data = s.local(s.full, copy=False)
                p.grad = g
            p._sr_index_base = s.offset

    # -- after the optimizer's step ---------------------------------------------
    @torch.no_grad()
    def _after_step(self):
        """Stages 1-2: all-gather the updated shards back into the whole
        parameters. Stage 3 keeps the shards until the next forward."""
        from ..communication import all_gather_into_tensor

        if self.level == "p_g_os":
            return
        for p, s in self.shards.items():
            if s.full is None:
                continue
            all_gather_into_tensor(s.full, p.data, group=self.group,
                                   axis=s.dim)
            p.data = s.full
            s.full = None
            p.__dict__.pop("_sr_index_base", None)

    @torch.no_grad()
    def _gather_params(self, module, inputs):
        """Stage 3's forward pre-hook: every parameter whole again."""
        from ..communication import all_gather_into_tensor

        for p, s in self.shards.items():
            if s.dim is None or tuple(p.shape) == s.shape:
                continue
            whole = torch.empty(s.shape, dtype=p.dtype, device=p.device)
            all_gather_into_tensor(whole, s.shard, group=self.group,
                                   axis=s.dim)
            p.data = whole
            p.__dict__.pop("_sr_index_base", None)

    def full_state(self) -> Dict[str, torch.Tensor]:
        """The model's state with every sharded parameter whole (a
        collective: every rank calls it)."""
        from ..communication import all_gather_into_tensor

        by_name = {n: self.shards.get(p)
                   for n, p in self.model.named_parameters()}
        out = {}
        for name, t in self.model.state_dict().items():
            s = by_name.get(name)
            if s is not None and s.dim is not None and tuple(t.shape) != s.shape:
                whole = torch.empty(s.shape, dtype=t.dtype, device=t.device)
                all_gather_into_tensor(whole, t.contiguous(), group=self.group,
                                       axis=s.dim)
                t = whole
            out[name] = t
        return out


def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size: int = 2 ** 23,
                           segment_size: int = 2 ** 20, sync_comm: bool = False,
                           dp_group=None, exclude_layer=None):
    """Wrap model and optimizer for group-sharded training (ref:
    group_sharded.py:41); returns ``(model, optimizer, scaler)``. The
    buffer and segment knobs are accepted for parity and unused: each
    parameter is communicated on its own. Gradient clipping needs every
    rank's shards and is refused."""
    if level not in _LEVELS:
        raise ValueError(f"level must be one of {_LEVELS}, got {level!r}")
    if offload:
        raise NotImplementedError(
            "offload=True is not supported: optimizer state is sharded over "
            "the group instead")
    if optimizer._grad_clip is not None or any(
            g.get("grad_clip") is not None for g in optimizer._param_groups):
        raise NotImplementedError(
            "group sharding with gradient clipping: the global norm needs "
            "every rank's shards; clip before sharding or use DataParallel")
    model._group_sharded = _GroupSharded(model, optimizer, level, group)
    model._group_sharded_level = level
    return model, optimizer, scaler


def save_group_sharded_model(model, output: str, optimizer=None):
    """Gather the sharded state and save it (ref: group_sharded.py:168):
    ``output/model.pdmodel`` and ``output/model.pdopt``, written by the
    group's first rank; every rank calls it."""
    from ...framework import io as _io

    gs = model._group_sharded
    state = {k: v.detach().cpu() for k, v in gs.full_state().items()}
    if gs.group.rank == 0:
        os.makedirs(output, exist_ok=True)
        _io.save(state, os.path.join(output, "model.pdmodel"))
        if optimizer is not None:
            _io.save(optimizer.state_dict(),
                     os.path.join(output, "model.pdopt"))
