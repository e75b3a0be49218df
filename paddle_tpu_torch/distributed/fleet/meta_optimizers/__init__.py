"""Dygraph meta-optimizers for hybrid parallelism (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/__init__.py``; ref:
fleet/meta_optimizers/dygraph_optimizer/hybrid_parallel_optimizer.py:255,
dygraph_sharding_optimizer.py:44).

Under GSPMD the reference's clip sees global arrays (``:49-63``). The port's
ranks hold shards, so :class:`HybridParallelOptimizer` replaces a
``ClipGradByGlobalNorm`` by :class:`HybridParallelClipGrad`: the squared
norms of the distributed parameters' gradients are summed over the mp group
and the replicated ones are counted once, and with pp > 1 each stage's sum
is summed over the pp group (a layer shared by two stages counted once),
so the clip factor is the whole model's and equal on every rank. The dp
average is ``DataParallel``'s, in the backward (``fleet.distributed_model``
wraps the model in it, beside tensor and pipeline parallelism too). With
sharding > 1 the optimizer is wrapped in :class:`DygraphShardingOptimizer`
over the sharding group, as Paddle's ``HybridParallelOptimizer`` wraps it.
"""
from __future__ import annotations

import torch

from ....nn.clip import ClipGradByGlobalNorm, _clippable, _scaled, _sq_sum

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad",
           "DygraphShardingOptimizer"]


class _OptimizerWrapper:
    """Attribute-transparent optimizer wrapper base.

    Contract: a subclass ``__init__`` assigns its OWN attributes FIRST and
    ``self._inner_opt`` LAST. Until ``_inner_opt`` exists, every write stays
    on the wrapper; afterwards, writes to names the wrapper does not already
    own go to the inner optimizer (``jit.to_static`` assigns optimizer
    state such as ``_global_step`` and ``_lr_override``).
    """

    def __setattr__(self, name, value):
        if "_inner_opt" not in self.__dict__ or name in self.__dict__:
            object.__setattr__(self, name, value)
        else:
            setattr(self.__dict__["_inner_opt"], name, value)

    def __getattr__(self, name):
        # before __init__ assigns _inner_opt (pickle/copy/hasattr probes),
        # delegation fails as a normal missing attribute, not KeyError
        if "_inner_opt" not in self.__dict__:
            raise AttributeError(name)
        return getattr(self.__dict__["_inner_opt"], name)

    def step(self):
        self._inner_opt.step()

    def clear_grad(self, set_to_zero: bool = False):
        self._inner_opt.clear_grad(set_to_zero)

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)


class HybridParallelClipGrad:
    """A global-norm clip over tensor-parallel shards and pipeline stages:
    the squares of the distributed (``is_distributed``) parameters'
    gradients all-reduced over the mp group, the replicated ones' added
    once; with pp > 1 that sum all-reduced over the pp group, where each
    stage holds its own parameters (the second copy of a layer shared by
    the first and the last stage, ``_pp_dup``, is left out).
    ``last_global_norm`` and ``last_scale`` keep the last step's f32
    device scalars."""

    def __init__(self, clip: ClipGradByGlobalNorm, hcg):
        self._clip = clip
        self.clip_norm = clip.clip_norm
        self._group = hcg.get_model_parallel_group()
        self._pp_group = hcg.get_pipe_parallel_group()
        self.last_global_norm = None
        self.last_scale = None

    def __call__(self, params_grads):
        from ...communication import all_reduce

        clippable = [(p, g) for p, g in params_grads if _clippable(p, g)]
        if not clippable:
            return params_grads
        dev = clippable[0][1].device
        dist_sq = torch.zeros((), dtype=torch.float32, device=dev)
        repl_sq = torch.zeros((), dtype=torch.float32, device=dev)
        for p, g in clippable:
            if getattr(p, "_pp_dup", False):
                continue
            if getattr(p, "is_distributed", False):
                dist_sq = dist_sq + _sq_sum(g)
            else:
                repl_sq = repl_sq + _sq_sum(g)
        if self._group is not None and self._group.nranks > 1:
            all_reduce(dist_sq, group=self._group)
        total = dist_sq + repl_sq
        if self._pp_group is not None and self._pp_group.nranks > 1:
            all_reduce(total, group=self._pp_group)
        norm = torch.sqrt(total)
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        self.last_global_norm, self.last_scale = norm, scale
        return [(p, _scaled(g, scale) if _clippable(p, g) else g)
                for p, g in params_grads]


class HybridParallelOptimizer(_OptimizerWrapper):
    """Wraps the user optimizer for hybrid-parallel training: with sharding
    > 1 in :class:`DygraphShardingOptimizer` (which refuses a clip), else
    its ``ClipGradByGlobalNorm`` sees the whole model
    (:class:`HybridParallelClipGrad`); a subclass of it (the MoE clip)
    beside mp or pp raises. The gradients arrive averaged over the dp
    group (``DataParallel``'s backward)."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        # wrapper-local attrs BEFORE _inner_opt (see _OptimizerWrapper)
        self._hcg = hcg
        self._strategy = strategy
        if hcg is not None:
            clip = optimizer._grad_clip
            if hcg.get_sharding_parallel_world_size() > 1:
                optimizer = DygraphShardingOptimizer(optimizer, hcg)
            elif type(clip) is ClipGradByGlobalNorm:
                optimizer._grad_clip = HybridParallelClipGrad(clip, hcg)
            elif isinstance(clip, ClipGradByGlobalNorm) and (
                    hcg.get_model_parallel_world_size() > 1
                    or hcg.get_pipe_parallel_world_size() > 1):
                # its own sum (the MoE clip's over moe_group) would miss
                # the other shards' and stages' squares
                raise NotImplementedError(
                    f"{type(clip).__name__} beside mp or pp is not ported "
                    "yet: only the plain ClipGradByGlobalNorm sums its "
                    "squares over the mp and pp groups (ROADMAP A1)")
        self._inner_opt = optimizer

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()

    def set_lr(self, lr):
        self._inner_opt.set_lr(lr)

    def get_lr(self):
        return self._inner_opt.get_lr()


class DygraphShardingOptimizer(_OptimizerWrapper):
    """Stage-1 sharding over the topology's sharding group (ref:
    dygraph_sharding_optimizer.py:44), through ``distributed.sharding``'s
    placement hooks: the gradients are averaged over the group after the
    backward, each rank updates its shard of every parameter with that
    shard's moments, and the updated shards are all-gathered. Gradient
    clipping is refused, as ``group_sharded_parallel`` refuses it."""

    def __init__(self, optimizer, hcg=None):
        from ...sharding import _GroupSharded

        if optimizer._grad_clip is not None:
            raise NotImplementedError(
                "sharding with gradient clipping: the global norm needs every "
                "rank's shards; clip before sharding or use DataParallel")
        # wrapper-local attrs BEFORE _inner_opt (see _OptimizerWrapper)
        self._hcg = hcg
        group = hcg.get_sharding_parallel_group() if hcg is not None else None
        holder = torch.nn.ParameterList(optimizer._parameter_list)
        self._sharded = _GroupSharded(holder, optimizer, "os", group)
        self._inner_opt = optimizer
