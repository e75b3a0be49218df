"""Multi-process bring-up and trainer-level eager collectives (counterpart
of ``paddle_tpu/distributed/multi_controller.py``).

The reference brings up JAX's coordination service from the launcher's
environment and runs each eager collective as a small compiled program over
a one-device-per-process mesh, returning host numpy. The port's processes
are ``torch.distributed`` ranks:

- :func:`initialize_from_env` calls ``torch.distributed.init_process_group``
  from the environment ``distributed.launch`` (or ``torchrun``) sets: the
  port's own rendezvous (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``), with the reference's ``PADDLE_MASTER``/``PADDLE_TRAINERS_NUM``/
  ``PADDLE_GLOBAL_RANK`` accepted in their place. ``parallel.
  init_parallel_env`` calls it first.
- the ``eager_*`` functions take and return host numpy arrays, as the
  reference's do, over the port's collectives on the world group's device;
  each collective records its signature in the flight recorder before it
  runs (``communication._record``, where the reference's ``_record`` is).

Contract (as in every multi-process framework): all processes reach the
same collective calls in the same order, with matching shapes and dtypes.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize_from_env", "active", "env_world", "eager_all_reduce",
           "eager_all_gather", "eager_broadcast", "eager_p2p",
           "eager_ppermute", "eager_send", "eager_recv",
           "eager_all_gather_object"]


def env_world():
    """``(world_size, rank, master)`` from the launcher's environment: the
    port's names first, the reference's as fallbacks; ``master`` is
    ``host:port`` or None."""
    world = int(os.environ.get("WORLD_SIZE")
                or os.environ.get("PADDLE_TRAINERS_NUM") or "1")
    rank = int(os.environ.get("RANK") or os.environ.get("PADDLE_GLOBAL_RANK")
               or os.environ.get("PADDLE_TRAINER_ID") or "0")
    master = None
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        master = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    master = master or os.environ.get("PADDLE_MASTER") or None
    return world, rank, master


def initialize_from_env(backend: str = "gloo", init_method: Optional[str] = None,
                        force: bool = False) -> bool:
    """Bring up ``torch.distributed``'s process group from the launcher's
    environment (``init_method``, e.g. ``file://...``, overrides the
    master address). Returns True when a multi-process group is (now) up;
    False for a single-process run without ``init_method``."""
    if dist.is_initialized() and not force:
        return True
    world, rank, master = env_world()
    if init_method is None:
        if world <= 1:
            return False
        if not master:
            raise RuntimeError(
                f"multi-process run (world size {world}) without MASTER_ADDR/"
                "MASTER_PORT or PADDLE_MASTER; start the workers with "
                "paddle_tpu_torch.distributed.launch")
        init_method = f"tcp://{master}"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return True


def active() -> bool:
    """True when more than one process takes part."""
    return dist.is_initialized() and dist.get_world_size() > 1


def _on_device(x) -> torch.Tensor:
    """A copy of ``x`` on the world group's device (the in-place
    collectives must not write the caller's array)."""
    from .collective import _get_global_group

    return torch.from_numpy(np.array(x)).to(_get_global_group().device)


def eager_all_reduce(x, op_kind: str) -> np.ndarray:
    """``op_kind`` in {sum, max, min, prod, avg}; the reduced value."""
    from . import communication as C
    from .collective import ReduceOp

    ops = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX, "min": ReduceOp.MIN,
           "prod": ReduceOp.PROD, "avg": ReduceOp.AVG}
    t = _on_device(x)
    C.all_reduce(t, ops[op_kind])
    return t.cpu().numpy()


def eager_all_gather(x) -> np.ndarray:
    """``[nproc, *x.shape]`` in rank order."""
    from . import communication as C

    rows = []
    C.all_gather(rows, _on_device(x))
    return torch.stack(rows).cpu().numpy()


def eager_broadcast(x, src: int) -> np.ndarray:
    from . import communication as C

    t = _on_device(x)
    C.broadcast(t, int(src))
    return t.cpu().numpy()


def eager_ppermute(x, perm) -> np.ndarray:
    """``[nproc, ...]``: the post-permute value of every process (each
    process contributes its own slot; callers index theirs)."""
    from . import communication as C

    moved = C.ppermute(_on_device(x), perm)
    return eager_all_gather(moved.cpu().numpy())


def eager_p2p(x, src: int, dst: int) -> np.ndarray:
    """The value process ``src`` holds lands at ``dst``; the post-transfer
    ``[nproc, ...]`` view."""
    return eager_ppermute(x, [(int(src), int(dst))])


def eager_send(x, dst: int) -> None:
    from . import communication as C

    C.send(_on_device(x), int(dst))


def eager_recv(src: int, like, deadline=None) -> np.ndarray:
    """Receive from ``src`` an array shaped and typed like ``like`` (the
    port's point-to-point needs the buffer; the reference's KV store
    pickles the array). ``deadline`` bounds the wait."""
    from . import communication as C

    t = _on_device(np.zeros_like(np.asarray(like)))
    C.recv(t, int(src), deadline=deadline)
    return t.cpu().numpy()


def eager_all_gather_object(obj) -> list:
    from . import communication as C

    out: list = []
    C.all_gather_object(out, obj)
    return out
