"""Parallel environment and ``DataParallel`` (counterpart of
``paddle_tpu/distributed/parallel.py``), over ``torch.distributed``.

The reference runs data parallelism as GSPMD over a batch-sharded input:
one controller, replicated parameters, and the compiler's all-reduce of the
gradients. The port runs one process per rank, as the reference's own
reference (Paddle's dygraph ``DataParallel``) does: parameters and buffers
are broadcast from the group's first rank at wrap, each rank runs its own
part of the global batch, and after the backward the gradients are
averaged over the group in flat buckets of ``comm_buffer_size`` MB, so
every rank steps with the global-batch mean gradient (the reference's
``scale_loss`` is the identity, and so is the port's).

Backends: :func:`init_parallel_env` picks NCCL when the rank's device is
CUDA and gloo on the CPU; ``PADDLE_DISTRI_BACKEND=gloo`` forces gloo (how
two ranks share one card, since NCCL will not put two ranks on one
device). Under NCCL a ``jit.to_static`` capture of a data-parallel step
holds the gradient all-reduces; under gloo they are host operations and a
graph break (``communication``'s docstring).

``shard_map`` has no counterpart: the port has no mesh to map a function
over, and its ranks are processes (ROADMAP C2).
"""
from __future__ import annotations

import contextlib
import os
from typing import List, Optional, Union

import torch
import torch.distributed as dist

from . import collective as _collective
from .collective import Group, init_default_group, is_initialized

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "shard_map", "DataParallel"]


class ParallelEnv:
    """Env-derived parallel info (ref: parallel.py ParallelEnv)."""

    def __init__(self):
        from .multi_controller import env_world

        world, rank, _ = env_world()
        if dist.is_initialized():
            world, rank = dist.get_world_size(), dist.get_rank()
        self.rank = rank
        self.world_size = world
        self.nranks = world
        self.local_rank = int(os.environ.get("LOCAL_RANK")
                              or os.environ.get("PADDLE_LOCAL_RANK") or rank)
        n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
        self.device_id = self.local_rank % n_dev if n_dev else 0
        self.trainer_endpoints = os.environ.get(
            "PADDLE_TRAINER_ENDPOINTS", "").split(",")
        self.current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def dev_id(self):
        return self.device_id


def _backend(dev: torch.device) -> str:
    forced = os.environ.get("PADDLE_DISTRI_BACKEND", "").strip().lower()
    if forced:
        if forced not in ("gloo", "nccl"):
            raise ValueError(f"PADDLE_DISTRI_BACKEND={forced!r}: expected "
                             "'gloo' or 'nccl'")
        if forced == "nccl" and dev.type != "cuda":
            raise ValueError("PADDLE_DISTRI_BACKEND=nccl needs a CUDA device")
        return forced
    return "nccl" if dev.type == "cuda" else "gloo"


def init_parallel_env(device: Optional[Union[str, torch.device]] = None,
                      init_method: Optional[str] = None) -> Group:
    """Initialize the default (world) group and return it.

    ``device``: the rank's device (default the card, ``cuda:<local rank
    mod card count>``; ``"cpu"`` on request). A worker started by
    ``distributed.launch`` or ``spawn`` joins the launcher's rendezvous
    (``multi_controller.initialize_from_env``); ``init_method`` (for
    example ``file://<path>``) overrides it; a single process without
    either gets a world of one (ref: parallel.py:957)."""
    from ..base.device import get_device
    from . import multi_controller as _mc

    if is_initialized():
        return _collective._get_global_group()
    dev = get_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", ParallelEnv().device_id)
        torch.cuda.set_device(dev)
    backend = _backend(dev)
    if not dist.is_initialized():
        if not _mc.initialize_from_env(backend, init_method=init_method):
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    return init_default_group(dev)


def get_world_size(group: Optional[Group] = None) -> int:
    """The number of ranks of ``group`` (default: the world)."""
    if group is not None:
        return group.nranks
    if dist.is_initialized():
        return dist.get_world_size()
    return ParallelEnv().world_size


def get_rank(group: Optional[Group] = None) -> int:
    """This process's rank (in ``group`` when given)."""
    if group is not None:
        return group.rank
    if dist.is_initialized():
        return dist.get_rank()
    return ParallelEnv().rank


def shard_map(fn, mesh=None, in_specs=None, out_specs=None, check_vma=False):
    """The reference maps ``fn`` over a device mesh in one process. The port
    has no mesh: its ranks are processes, each running ``fn`` on its own
    data and calling the collectives directly."""
    raise NotImplementedError(
        "shard_map has no counterpart in paddle_tpu_torch: there is no mesh "
        "to map over. Start one process per rank (distributed.launch or "
        "distributed.spawn), call init_parallel_env(), and run fn on each "
        "rank's own data with the collectives of distributed.communication")


class DataParallel:
    """paddle.DataParallel (ref: parallel.py:144-251), one process per rank.

    At wrap the layer's parameters and buffers are broadcast from the
    group's first rank. Each parameter's post-accumulate-grad hook queues
    one pass at the end of the backward that averages every gradient over
    the group (sum, then / nranks) in flat buckets of at most
    ``comm_buffer_size`` MB (the bucket of the first parameters, whose
    gradients come last, at most ``last_comm_buffer_size`` MB), in the
    reverse order of the parameters. Inside :meth:`no_sync` gradients
    accumulate locally; the next backward outside it averages the sums.
    A parameter that got no gradient raises at that pass, unless
    ``find_unused_parameters`` is set: then it takes part with zeros."""

    def __init__(self, layers, strategy=None, comm_buffer_size: int = 25,
                 last_comm_buffer_size: int = 1,
                 find_unused_parameters: bool = False,
                 group: Optional[Group] = None):
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        params = [p for p in layers.parameters() if p.requires_grad]
        if group is None:
            dev = params[0].device if params else None
            group = init_parallel_env(dev)
        self.group = group
        self.comm_buffer_size = comm_buffer_size
        self.last_comm_buffer_size = last_comm_buffer_size
        self._grad_sync_enabled = True
        self._queued = False
        self._buckets = self._make_buckets(params)
        self.n_syncs = 0  # averaging passes run (host count)
        self._sync_params_buffers()
        self._hooks = [p.register_post_accumulate_grad_hook(self._on_grad)
                       for p in params]

    def _make_buckets(self, params) -> List[List[torch.Tensor]]:
        """Filled from the first parameter on (that bucket, reduced last,
        holds at most ``last_comm_buffer_size`` MB), one dtype and device
        per bucket; returned in reduction order, last parameters first."""
        buckets, cur, size = [], [], 0
        cap = int(self.last_comm_buffer_size * 2 ** 20)
        for p in params:
            nbytes = p.numel() * p.element_size()
            if cur and (size + nbytes > cap or p.dtype != cur[0].dtype
                        or p.device != cur[0].device):
                buckets.append(cur)
                cur, size = [], 0
                cap = int(self.comm_buffer_size * 2 ** 20)
            cur.append(p)
            size += nbytes
        if cur:
            buckets.append(cur)
        return [b[::-1] for b in reversed(buckets)]

    @torch.no_grad()
    def _sync_params_buffers(self):
        """Broadcast parameters and buffers from the group's first rank (ref:
        parallel.py sync_params_buffers)."""
        from .communication import broadcast

        src = self.group.ranks[0]
        for t in [*self._layers.parameters(), *self._layers.buffers()]:
            broadcast(t.data, src=src, group=self.group)

    def _on_grad(self, p):
        if not self._grad_sync_enabled or self._queued:
            return
        self._queued = True
        torch.autograd.Variable._execution_engine.queue_callback(
            self._sync_grads)

    @torch.no_grad()
    def _sync_grads(self):
        """Average every gradient over the group, bucket by bucket."""
        from .communication import all_reduce

        self._queued = False
        n = self.group.nranks
        for bucket in self._buckets:
            grads = []
            for p in bucket:
                if p.grad is None:
                    if not self.find_unused_parameters:
                        raise RuntimeError(
                            "DataParallel: a parameter of shape "
                            f"{tuple(p.shape)} got no gradient in this "
                            "backward; pass find_unused_parameters=True")
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            flat = torch.cat([g.reshape(-1) for g in grads])
            all_reduce(flat, group=self.group)
            flat.div_(n)
            off = 0
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
        self.n_syncs += 1

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    __call__ = forward

    def scale_loss(self, loss):
        """Identity: the averaged gradients are the global-batch mean's."""
        return loss

    def apply_collective_grads(self):
        """Kept for the reference's API: the gradients were averaged when
        the backward finished."""

    @contextlib.contextmanager
    def no_sync(self):
        """Within this context gradients accumulate locally."""
        self._grad_sync_enabled = False
        try:
            yield
        finally:
            self._grad_sync_enabled = True

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    load_dict = set_state_dict

    def train(self):
        self._layers.train()
        return self

    def eval(self):
        self._layers.eval()
        return self

    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)
