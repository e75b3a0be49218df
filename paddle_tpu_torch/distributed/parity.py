"""The distributed namespace's small collectives and aliases (counterpart of
the communication half of ``paddle_tpu/distributed/parity.py``).

Ported here: ``gather``, ``scatter_object_list``, ``broadcast_object_list``,
``wait``, ``isend``/``irecv`` with their ``_Work``, ``is_available``,
``get_backend``, ``ParallelMode``, ``ReduceType``, the ``gloo_*``
functions and the tensor-parallel ``split`` (over ``fleet``'s mp layers).
The rest of the reference's module (the PS entry policies, the fleet datasets, ``DistAttr``, ``Strategy``,
``DistModel``, ``to_static``, ``shard_dataloader``, ``shard_scaler``, the
sharding-stage tags, ``unshard_dtensor``) waits for ``fleet`` and
``auto_parallel`` (ROADMAP A1).
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from .collective import _get_global_group

__all__ = ["gather", "scatter_object_list", "broadcast_object_list", "wait",
           "isend", "irecv", "is_available", "get_backend", "ParallelMode",
           "ReduceType", "split", "gloo_init_parallel_env", "gloo_barrier",
           "gloo_release"]


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """ref: communication/gather.py — every rank's tensor, in rank order. As
    the reference's, every rank's list is filled (``dst``'s view)."""
    from .communication import all_gather

    out: List = gather_list if gather_list is not None else []
    out.clear()
    all_gather(out, tensor, group=group)
    return out


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """ref: communication/scatter.py scatter_object_list — rank r receives
    ``in_object_list[r]`` of rank ``src`` (only ``src`` needs the list)."""
    from .communication import _resolve, flight_recorder

    g = _resolve(group)
    flight_recorder.record("scatter_object_list", group=str(g.id),
                           detail=f"src={src}")
    mine = g.rank == g.get_group_rank(src)
    if mine and (in_object_list is None or len(in_object_list) != g.nranks):
        raise ValueError(f"scatter_object_list: the source rank needs "
                         f"{g.nranks} objects (one per rank)")
    got = [None]
    from .communication.watchdog import watch

    with watch(f"scatter_object_list(group={g.id})"):
        dist.scatter_object_list(got, list(in_object_list) if mine else None,
                                 src=src, group=g.pg)
    out_object_list.clear()
    out_object_list.append(got[0])


def broadcast_object_list(object_list, src=0, group=None):
    """ref: communication/broadcast.py broadcast_object_list — every rank's
    ``object_list`` becomes ``src``'s, in place; returns it."""
    from .communication import _resolve, flight_recorder
    from .communication.watchdog import watch

    g = _resolve(group)
    flight_recorder.record("broadcast_object_list", group=str(g.id),
                           detail=f"src={src} n={len(object_list)}")
    with watch(f"broadcast_object_list(group={g.id})"):
        dist.broadcast_object_list(object_list, src=src, group=g.pg)
    return object_list


def wait(tensor, group=None, use_calc_stream=True):
    """ref: communication/wait.py — block until the tensor's pending work
    is done: the card's stream is synchronized."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


class _Work:
    """What :func:`isend`/:func:`irecv` return: ``wait()`` blocks until
    the transfer has landed."""

    def __init__(self, task=None):
        self._task = task

    def wait(self):
        if self._task is not None:
            self._task.wait()
        return True

    def is_completed(self):
        return self._task is None or self._task.is_completed()


def isend(tensor, dst=0, group=None):
    """ref: communication/send.py isend — async send returning a Work."""
    from .communication import send

    return _Work(send(tensor, dst=dst, group=group, sync_op=False))


def irecv(tensor, src=0, group=None):
    from .communication import recv

    return _Work(recv(tensor, src=src, group=group, sync_op=False))


def is_available() -> bool:
    """ref: parallel.py is_available — ``torch.distributed`` is built in."""
    return dist.is_available()


def get_backend(group=None) -> str:
    """ref: communication/group.py get_backend: ``"NCCL"`` or ``"GLOO"``
    (the reference says ``"XCCL"``, its XLA collectives)."""
    g = group or _get_global_group()
    return g.backend.upper()


class ParallelMode:
    """ref: parallel.py ParallelMode constants."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class ReduceType:
    """ref: auto_parallel ReduceType (Partial reduce kinds)."""

    kRedSum = 0
    kRedMax = 1
    kRedMin = 2
    kRedProd = 3
    kRedAvg = 4
    kRedAny = 5
    kRedAll = 6


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """ref: parity.py:171-195 (fleet/layers/mpu/mp_ops.py split): build a
    row-parallel (``axis=0``) or column-parallel (``axis=1``) linear of
    ``size = (in, out)``, or a vocab-parallel embedding, over the mp group,
    on ``x``'s device, and return its output on ``x`` (the reference's
    functional form; the layer is built from the RNG tracker's global
    branch, so every rank builds its slice of one weight)."""
    from .fleet.layers.mpu.mp_layers import (ColumnParallelLinear,
                                             RowParallelLinear,
                                             VocabParallelEmbedding)

    kw = dict(device=x.device)
    if operation == "linear":
        if axis == 0:
            layer = RowParallelLinear(size[0], size[1],
                                      weight_attr=weight_attr,
                                      has_bias=bias_attr is not False,
                                      input_is_parallel=False, **kw)
        else:
            layer = ColumnParallelLinear(size[0], size[1],
                                         weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out, **kw)
        return layer(x)
    if operation == "embedding":
        return VocabParallelEmbedding(size[0], size[1],
                                      weight_attr=weight_attr, **kw)(x)
    raise ValueError(f"split: unknown operation {operation!r}")


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """ref: parallel.py gloo_init_parallel_env: a gloo world of ``rank_num``
    processes meeting at ``server_endpoint`` (``host:port``), on the
    CPU."""
    from .parallel import init_parallel_env

    if dist.is_initialized():
        return _get_global_group()
    dist.init_process_group("gloo", init_method=f"tcp://{server_endpoint}",
                            rank=int(rank_id), world_size=int(rank_num))
    return init_parallel_env("cpu")


def gloo_barrier():
    from .communication import barrier

    barrier()


def gloo_release():
    """Tear the gloo world down."""
    from .collective import destroy_process_group

    destroy_process_group()
