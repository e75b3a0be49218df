"""Process groups over ``torch.distributed`` (counterpart of
``paddle_tpu/distributed/collective.py``).

The reference's ``Group`` is a named mesh axis: its collectives are XLA ops
traced over that axis by one controller. The port runs one process per
rank, so a ``Group`` carries the global ranks and the
``torch.distributed`` process group it wraps (``pg``), and the device its
collectives run on (``device``: the card under NCCL, the CPU or the card
under gloo). Group 0 is the default (world) group that
``parallel.init_parallel_env`` creates; :func:`new_group` makes a subgroup,
which every rank must create, as ``torch.distributed.new_group`` requires.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "is_initialized",
           "destroy_process_group"]

# id 0 is reserved for the default world group (init_default_group)
_group_counter = itertools.count(1)


class ReduceOp:
    """Reduction type for collective ops (ref: process_group.h ReduceOp)."""

    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


class Group:
    """A communication group: global ranks, its ``torch.distributed``
    process group and the backend's device."""

    def __init__(self, ranks: Sequence[int], pg=None,
                 pg_id: Optional[int] = None, name: str = "",
                 device: Optional[torch.device] = None):
        self.ranks = list(ranks)
        self.pg = pg
        self.id = next(_group_counter) if pg_id is None else pg_id
        self.name = name or f"pg_{self.id}"
        self.device = torch.device("cpu") if device is None else device

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    @property
    def world_size(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        """This process's rank within the group, -1 if not a member."""
        return self.get_group_rank(_global_rank())

    @property
    def backend(self) -> str:
        """``"nccl"`` or ``"gloo"``."""
        return dist.get_backend(self.pg).lower()

    def is_member(self) -> bool:
        return _global_rank() in self.ranks

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(id={self.id}, backend={self.backend if self.pg is not None else None}, "
                f"nranks={self.nranks}, ranks={self.ranks})")


_default_group: Optional[Group] = None
_groups: dict = {}


def _global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def init_default_group(device: torch.device) -> Group:
    """The world group over ``torch.distributed``'s default process group;
    ``parallel.init_parallel_env`` calls it once the process group is up."""
    global _default_group
    _default_group = Group(list(range(dist.get_world_size())),
                           pg=dist.group.WORLD, pg_id=0, name="default",
                           device=device)
    _groups[0] = _default_group
    return _default_group


def is_initialized() -> bool:
    return _default_group is not None


def destroy_process_group(group: Optional[Group] = None):
    """Drop ``group`` (default: every group and ``torch.distributed``'s
    process group)."""
    global _default_group
    if group is None or group is _default_group:
        _default_group = None
        _groups.clear()
        if dist.is_initialized():
            dist.destroy_process_group()
    else:
        _groups.pop(group.id, None)
        if group.pg is not None and dist.is_initialized():
            dist.destroy_process_group(group.pg)


def _get_global_group() -> Group:
    if _default_group is None:
        raise RuntimeError(
            "no process group: call paddle_tpu_torch.distributed."
            "init_parallel_env() first (one process per rank, started by "
            "distributed.launch or distributed.spawn)")
    return _default_group


def get_group(gid: int = 0) -> Optional[Group]:
    return _groups.get(gid)


def new_group(ranks: Optional[Sequence[int]] = None,
              backend: Optional[str] = None, timeout=None) -> Group:
    """paddle.distributed.new_group parity (collective.py:186): every rank
    calls it with the same ranks; a rank outside ``ranks`` gets a group it
    is not a member of. ``backend`` defaults to the world group's."""
    world = _get_global_group()
    ranks = sorted(world.ranks if ranks is None else ranks)
    bad = [r for r in ranks if r not in world.ranks]
    if bad:
        raise ValueError(f"new_group: ranks {bad} are not in the world "
                         f"group {world.ranks}")
    kw = {} if timeout is None else {"timeout": timeout}
    pg = dist.new_group(ranks, backend=backend or world.backend, **kw)
    g = Group(ranks, pg=pg, device=world.device)
    _groups[g.id] = g
    return g
