"""paddle_tpu_torch.distributed.launch — the multi-process launcher
(counterpart of ``paddle_tpu/distributed/launch``; ref:
python/paddle/distributed/launch/ — main.py:21 (CLI),
controllers/collective.py (process management, env injection, log
capture, restart)).

Run: ``python -m paddle_tpu_torch.distributed.launch [--nnodes N]
[--master host:port] [--rank R] [--nproc P] train.py args...``. It starts
``--nproc`` rank processes on this host with the rendezvous environment
``init_parallel_env`` reads (the port's ``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE``/``RANK``/``LOCAL_RANK`` and the reference's ``PADDLE_*``
names), writes each rank's output to ``<log_dir>/<job_id>.rank<r>.log``,
restarts a failed rank up to ``--max_restart`` times, and tears the others
down when one fails for good.
"""
from .main import launch, main  # noqa: F401

__all__ = ["launch", "main"]
