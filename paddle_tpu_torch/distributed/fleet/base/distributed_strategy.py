"""DistributedStrategy: the hybrid-parallel configuration (counterpart of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``): an attribute
bag whose ``hybrid_configs`` assignment merges into the defaults, as the
reference's does (``:40-46``)."""
from __future__ import annotations

from typing import Any, Dict

__all__ = ["DistributedStrategy"]

_DEFAULT_HYBRID = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "order": ["dp", "pp", "sharding", "sep", "mp"],
}


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs: Dict[str, Any] = dict(_DEFAULT_HYBRID)
        self.amp = False
        self.amp_configs: Dict[str, Any] = {}
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = {}
        self.sharding = False
        self.sharding_configs: Dict[str, Any] = {}
        self.pipeline = False
        self.pipeline_configs: Dict[str, Any] = {"accumulate_steps": 1,
                                                 "micro_batch_size": 1}
        self.gradient_merge = False
        self.gradient_merge_configs: Dict[str, Any] = {}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.without_graph_optimization = False

    def __setattr__(self, key, value):
        if key == "hybrid_configs" and hasattr(self, "hybrid_configs"):
            merged = dict(self.__dict__["hybrid_configs"])
            merged.update(value)
            self.__dict__[key] = merged
        else:
            self.__dict__[key] = value

    def __repr__(self):
        return f"DistributedStrategy({self.hybrid_configs})"
