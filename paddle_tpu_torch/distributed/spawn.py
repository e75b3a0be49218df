"""paddle.distributed.spawn (counterpart of ``paddle_tpu/distributed/
spawn.py``; ref: python/paddle/distributed/spawn.py).

Single-node multi-process start: ``nprocs`` processes from the ``spawn``
context, each running ``func(*args)`` with the rank environment set (the
reference's ``PADDLE_*`` names and the port's ``RANK``/``WORLD_SIZE``/
``LOCAL_RANK``), so ``init_parallel_env`` in the child finds its rank. The
rendezvous is the caller's: a ``master`` (``host:port``) sets
``MASTER_ADDR``/``MASTER_PORT``, or the children pass ``init_method`` to
``init_parallel_env`` themselves.
"""
from __future__ import annotations

import multiprocessing as mp
import os
from typing import Optional

__all__ = ["spawn"]


def _worker(func, args, rank: int, nprocs: int, env: dict):
    os.environ.update(env)
    for name in ("PADDLE_TRAINER_ID", "PADDLE_GLOBAL_RANK", "RANK"):
        os.environ[name] = str(rank)
    for name in ("PADDLE_LOCAL_RANK", "LOCAL_RANK"):
        os.environ[name] = str(rank)
    for name in ("PADDLE_TRAINERS_NUM", "WORLD_SIZE"):
        os.environ[name] = str(nprocs)
    func(*args)


def spawn(func, args=(), nprocs: int = 1, join: bool = True,
          daemon: bool = False, master: Optional[str] = None, **options):
    """ref: spawn.py spawn — returns the processes when ``join=False``, else
    joins them and raises on a child's failure."""
    env = {}
    if master:
        host, port = master.rsplit(":", 1)
        env.update(MASTER_ADDR=host, MASTER_PORT=port, PADDLE_MASTER=master)
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(func, tuple(args), rank, nprocs, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if not join:
        return procs
    for p in procs:
        p.join()
    failed = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"spawned processes failed (rank, exitcode): {failed}")
    return procs
