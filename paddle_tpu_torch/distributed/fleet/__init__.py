"""Fleet: the hybrid-parallel front (counterpart of
``paddle_tpu/distributed/fleet/__init__.py``; ref:
python/paddle/distributed/fleet/fleet.py:99,166,598).

``init`` initialises the default group (``init_parallel_env``) and builds
the hybrid topology's groups from ``strategy.hybrid_configs``;
``distributed_model`` wraps the model by parallel mode (precedence pp > mp
> sep > sharding > dp, ``:58-82``): the pipeline
(``meta_parallel.PipelineParallel`` over a ``PipelineLayer``, with
``DataParallel`` over the dp group when dp > 1), tensor parallelism
(``meta_parallel.TensorParallel``, likewise), segment parallelism
(``meta_parallel.SegmentParallel``, likewise), or ``DataParallel`` over the
dp group; ``distributed_optimizer`` wraps the optimizer
(``meta_optimizers.HybridParallelOptimizer``, which shards it over the
sharding group when sharding > 1). The pipeline beside mp, sep or
sharding, group sharding beside tensor or data parallelism, and
``elastic`` are later slices (ROADMAP A1): asking for them raises.
"""
from __future__ import annotations

from typing import Optional

from .base.distributed_strategy import DistributedStrategy  # noqa: F401
from .base.role_maker import (  # noqa: F401
    Fleet,
    MultiSlotDataGenerator,
    MultiSlotStringDataGenerator,
    PaddleCloudRoleMaker,
    Role,
    UserDefinedRoleMaker,
    UtilBase,
)
from .base.topology import (  # noqa: F401
    CommunicateTopology,
    HybridCommunicateGroup,
    get_hybrid_communicate_group,
    set_hybrid_communicate_group,
)
from . import elastic  # noqa: F401

__all__ = ["init", "get_strategy", "distributed_model",
           "distributed_optimizer", "get_rank", "worker_num", "worker_index",
           "DistributedStrategy", "CommunicateTopology",
           "HybridCommunicateGroup", "get_hybrid_communicate_group",
           "set_hybrid_communicate_group", "Fleet", "Role",
           "UserDefinedRoleMaker", "PaddleCloudRoleMaker", "UtilBase",
           "MultiSlotDataGenerator", "MultiSlotStringDataGenerator"]

_strategy: Optional[DistributedStrategy] = None


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, device=None):
    """fleet.init (fleet.py:166): the default group on ``device`` (default:
    the rank's card; ``"cpu"`` on request), then the topology of
    ``strategy.hybrid_configs`` (degrees in its ``order``) and every group
    of it, on every rank. Returns the ``HybridCommunicateGroup``."""
    global _strategy
    from ..parallel import init_parallel_env

    _strategy = strategy if strategy is not None else DistributedStrategy()
    hc = _strategy.hybrid_configs
    order = hc.get("order", ["dp", "pp", "sharding", "sep", "mp"])
    dims = [hc.get(f"{name}_degree", 1) for name in order]
    init_parallel_env(device)
    hcg = HybridCommunicateGroup(CommunicateTopology(order, dims))
    set_hybrid_communicate_group(hcg)
    return hcg


def get_strategy() -> Optional[DistributedStrategy]:
    return _strategy


def _check_sharding(hcg):
    """Group sharding runs alone: beside mp or dp it raises."""
    if hcg.get_sharding_parallel_world_size() > 1 and (
            hcg.get_model_parallel_world_size() > 1
            or hcg.get_data_parallel_world_size() > 1):
        raise NotImplementedError(
            "group sharding beside tensor or data parallelism "
            "(sharding_degree > 1 with mp_degree or dp_degree > 1) is not "
            "ported yet: the "
            "sharded optimizer averages over the sharding group only "
            "(ROADMAP A1)")


def distributed_model(model):
    """Wrap by parallel mode (ref: fleet/model.py:32), pp > mp > sep >
    sharding > dp."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("call fleet.init() first")
    _check_sharding(hcg)
    if hcg.get_pipe_parallel_world_size() > 1:
        from .meta_parallel import PipelineParallel

        return PipelineParallel(model, hcg, _strategy)
    if hcg.get_model_parallel_world_size() > 1:
        from .meta_parallel import TensorParallel

        return TensorParallel(model, hcg, _strategy)
    if hcg.get_sep_parallel_world_size() > 1:
        from .meta_parallel import SegmentParallel

        return SegmentParallel(model, hcg, _strategy)
    if hcg.get_sharding_parallel_world_size() > 1:
        return model  # distributed_optimizer shards the optimizer
    if hcg.get_data_parallel_world_size() > 1:
        from ..parallel import DataParallel

        return DataParallel(model, group=hcg.get_data_parallel_group())
    return model


def distributed_optimizer(optimizer, strategy: Optional[DistributedStrategy] = None):
    """Wrap the optimizer (ref: fleet.py distributed_optimizer ->
    HybridParallelOptimizer, hybrid_parallel_optimizer.py:255)."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return optimizer
    _check_sharding(hcg)
    from .meta_optimizers import HybridParallelOptimizer

    return HybridParallelOptimizer(optimizer, hcg, strategy or _strategy)


def get_rank() -> int:
    from ..parallel import get_rank as _gr

    return _gr()


def worker_num() -> int:
    from ..parallel import get_world_size as _ws

    return _ws()


worker_index = get_rank
