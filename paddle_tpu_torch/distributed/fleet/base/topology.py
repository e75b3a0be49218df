"""Hybrid-parallel topology: the N-D rank grid and its communication groups
(counterpart of ``paddle_tpu/distributed/fleet/base/topology.py``).

:class:`CommunicateTopology` is the reference's, pure Python: every method
answers as the reference's does. :class:`HybridCommunicateGroup` differs in
how it holds the groups. The reference's is one controller over a JAX mesh:
it binds each axis to its first group (``get_comm_list(axis)[0]``) and
answers rank 0's coordinates, since the controller traces every rank at
once. The port runs one process per rank, so every rank builds every group
of every axis, in one fixed order (``torch.distributed.new_group`` must be
called by all ranks for every group, members or not), keeps the group of
each axis it is in, and its rank getters give this process's own
coordinates. There is no mesh (ROADMAP C2).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from ...collective import Group, new_group

__all__ = ["CommunicateTopology", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group"]

_HYBRID_AXES = ["dp", "pp", "sharding", "sep", "mp"]


class CommunicateTopology:
    """Cartesian rank topology (ref: topology.py:65); rank = row-major index
    of the coordinate over ``dims``."""

    def __init__(self, hybrid_group_names: Sequence[str] = _HYBRID_AXES,
                 dims: Sequence[int] = (1, 1, 1, 1, 1)):
        assert len(hybrid_group_names) == len(dims)
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = list(itertools.product(*[range(d) for d in dims]))
        self._coord2rank = {c: i for i, c in enumerate(self.coordinate)}
        self._rank2coord = {i: c for i, c in enumerate(self.coordinate)}

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        n = 1
        for d in self._dims:
            n *= d
        return n

    def get_rank(self, **kwargs) -> int:
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return self._coord2rank[coord]

    def get_coord(self, rank: int) -> Tuple[int, ...]:
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """All ranks whose coordinate on ``axis_name`` equals ``index``."""
        ax = self._parallel_names.index(axis_name)
        return sorted(self._coord2rank[c] for c in self.coordinate
                      if c[ax] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """Rank groups that vary only along ``axis_name``: one group per
        combination of the other axes."""
        ax = self._parallel_names.index(axis_name)
        others = [range(d) for i, d in enumerate(self._dims) if i != ax]
        groups = []
        for combo in itertools.product(*others):
            ranks = []
            for k in range(self._dims[ax]):
                coord = list(combo)
                coord.insert(ax, k)
                ranks.append(self._coord2rank[tuple(coord)])
            groups.append(ranks)
        return groups

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        coord = list(self.get_coord(global_rank))
        for name, v in kwargs.items():
            coord[self._parallel_names.index(name)] = v
        return self._coord2rank[tuple(coord)]

    def get_fused_comm_list(self, axes: Sequence[str]) -> List[List[int]]:
        """Rank groups that vary only along the axes ``axes`` together: one
        per combination of the other axes (the check and ``dp_sep``
        groups)."""
        idx = [self._parallel_names.index(a) for a in axes
               if a in self._parallel_names]
        groups: Dict[tuple, List[int]] = {}
        for rank, c in enumerate(self.coordinate):
            key = tuple(v for i, v in enumerate(c) if i not in idx)
            groups.setdefault(key, []).append(rank)
        return [groups[k] for k in sorted(groups)]


# the fused groups besides the five axes', in the order they are built
_FUSED = (("check", ("pp", "mp")), ("check_sharding", ("pp", "sharding", "mp")),
          ("dp_sep", ("dp", "sep")))


class HybridCommunicateGroup:
    """The hybrid topology's groups on this rank (ref: topology.py:178).

    Needs the default group (``init_parallel_env``) with as many ranks as
    the topology has. Every rank builds, in the same order, the groups of
    each axis of ``topology.get_hybrid_group_names()`` (its
    ``get_comm_list``), then the check, sharding-check and ``dp_sep``
    groups, and keeps those it is a member of."""

    def __init__(self, topology: CommunicateTopology):
        from ...collective import _get_global_group

        self._topo = topology
        world = _get_global_group()
        n = topology.world_size()
        if world.nranks != n:
            raise ValueError(
                f"the topology {dict(zip(topology.get_hybrid_group_names(), topology._dims))} "
                f"has {n} ranks, the default group {world.nranks}: start "
                f"{n} processes (distributed.launch --nproc {n})")
        self.global_rank = world.rank
        self._coord = topology.get_coord(self.global_rank)

        def _dim(name):
            return (topology.get_dim(name)
                    if name in topology.get_hybrid_group_names() else 1)

        self._dp_degree = _dim("dp")
        self._pp_degree = _dim("pp")
        self._sharding_degree = _dim("sharding")
        self._sep_degree = _dim("sep")
        self._mp_degree = _dim("mp")

        self._groups: Dict[str, Group] = {}
        order = [(a, topology.get_comm_list(a))
                 for a in topology.get_hybrid_group_names()]
        order += [(name, topology.get_fused_comm_list(axes))
                  for name, axes in _FUSED]
        for name, lists in order:
            for ranks in lists:
                g = new_group(ranks)
                if self.global_rank in ranks:
                    g.name = name
                    self._groups[name] = g

    def _axis_rank(self, name: str) -> int:
        names = self._topo.get_hybrid_group_names()
        return self._coord[names.index(name)] if name in names else 0

    # -- degrees -------------------------------------------------------
    def get_data_parallel_world_size(self) -> int:
        return self._dp_degree

    def get_model_parallel_world_size(self) -> int:
        return self._mp_degree

    def get_pipe_parallel_world_size(self) -> int:
        return self._pp_degree

    def get_sharding_parallel_world_size(self) -> int:
        return self._sharding_degree

    def get_sep_parallel_world_size(self) -> int:
        return self._sep_degree

    # -- groups --------------------------------------------------------
    def _group(self, name: str) -> Optional[Group]:
        return self._groups.get(name)

    def get_data_parallel_group(self) -> Group:
        return self._group("dp")

    def get_model_parallel_group(self) -> Group:
        return self._group("mp")

    def get_pipe_parallel_group(self) -> Group:
        return self._group("pp")

    def get_sharding_parallel_group(self) -> Group:
        return self._group("sharding")

    def get_sep_parallel_group(self) -> Group:
        return self._group("sep")

    def get_check_parallel_group(self, sharding=False) -> Group:
        """The ranks that share this rank's dp (and, unless ``sharding``,
        sharding and sep) coordinates: pp x mp (x sharding)."""
        return self._group("check_sharding" if sharding else "check")

    def get_dp_sep_parallel_group(self) -> Group:
        return self._group("dp_sep")

    # -- this process's coordinates ----------------------------------
    def get_global_rank(self) -> int:
        return self.global_rank

    def get_data_parallel_rank(self) -> int:
        return self._axis_rank("dp")

    def get_model_parallel_rank(self) -> int:
        return self._axis_rank("mp")

    def get_stage_id(self) -> int:
        return self._axis_rank("pp")

    def get_sharding_parallel_rank(self) -> int:
        return self._axis_rank("sharding")

    def get_sep_parallel_rank(self) -> int:
        return self._axis_rank("sep")

    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_p2p_groups(self):
        return None  # the pipeline's point-to-point waits for its slice

    def __repr__(self):
        dims = {a: self._topo.get_dim(a)
                for a in self._topo.get_hybrid_group_names()}
        return f"HybridCommunicateGroup({dims}, rank={self.global_rank})"


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
