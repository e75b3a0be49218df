"""Elastic kill-and-relaunch worker: two trainer processes (counterpart of
the reference's ``tests/_elastic_worker.py``, with the same environment
plus the device).

Run under ``python -m paddle_tpu_torch.distributed.launch --nproc 2``
with this module's file as the script. Trains a data-parallel model
(``DataParallel`` over gloo, each rank half of every batch) with periodic
rank-0 checkpoints. On the FIRST incarnation rank 1 dies mid-training (a
simulated hardware failure); the launcher then stops rank 0 — the elastic
contract: the agent relaunches the whole job and training resumes from the
last checkpoint (ref: python/paddle/distributed/fleet/elastic/manager.py).

env:
  ELASTIC_DEVICE     — "cuda" (default) or "cpu"
  ELASTIC_DIR        — scratch dir (checkpoints + incarnation marker)
  ELASTIC_KILL_STEP  — step at which rank 1 dies in incarnation 1
  ELASTIC_TOTAL      — total steps to train

Its imports are absolute: the launcher runs this file as a script.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["main"]


def main() -> None:
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.base.device import get_device
    from paddle_tpu_torch.framework import io as fio
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    device = get_device(os.environ.get("ELASTIC_DEVICE", "cuda"))
    scratch = os.environ["ELASTIC_DIR"]
    kill_step = int(os.environ.get("ELASTIC_KILL_STEP", "-1"))
    total = int(os.environ["ELASTIC_TOTAL"])
    ckpt = os.path.join(scratch, "ckpt.pdparams")
    opt_ckpt = os.path.join(scratch, "ckpt.pdopt")
    meta = os.path.join(scratch, "ckpt.step")

    dist.init_parallel_env(device)
    rank = dist.get_rank()
    pt_seed(0)
    gen = torch.Generator().manual_seed(0)
    kw = dict(device=device, dtype=torch.float32, generator=gen)
    model = torch.nn.Sequential(Linear(8, 16, **kw), torch.nn.ReLU(),
                                Linear(16, 4, **kw))
    opt = AdamW(learning_rate=1e-2, parameters=model.parameters())
    start = 0
    if os.path.exists(meta):  # resume from the last checkpoint
        start = int(open(meta).read())
        model.load_state_dict(fio.load(ckpt))
        opt.set_state_dict(fio.load(opt_ckpt))
        print(f"rank {rank}: resumed at step {start}", flush=True)
    dp = dist.DataParallel(model)

    rng = np.random.RandomState(7)
    loss = None
    for i in range(total):
        x_np = rng.randn(8, 8).astype(np.float32)
        y_np = rng.randint(0, 4, (8,)).astype(np.int64)
        if i < start:
            continue  # deterministic data schedule: replay the stream
        x = torch.as_tensor(x_np[rank * 4:(rank + 1) * 4], device=device)
        y = torch.as_tensor(y_np[rank * 4:(rank + 1) * 4], device=device)
        out = F.cross_entropy(dp(x), y)
        out.backward()
        opt.step()
        opt.clear_grad()
        # the global batch's loss: the mean of the ranks' halves
        g = out.detach().reshape(1).clone()
        dist.all_reduce(g)
        loss = float(g[0]) / dist.get_world_size()

        done = i + 1
        if rank == 0 and done % 4 == 0:
            fio.save(model.state_dict(), ckpt)
            fio.save(opt.state_dict(), opt_ckpt)
            with open(meta + ".tmp", "w") as f:
                f.write(str(done))
            os.replace(meta + ".tmp", meta)
        dist.barrier()
        if (rank == 1 and done == kill_step
                and not os.path.exists(os.path.join(scratch, "died"))):
            open(os.path.join(scratch, "died"), "w").write("1")
            print(f"rank 1: simulated failure at step {done}", flush=True)
            os._exit(17)

    print(f"rank {rank}: DONE final_loss={loss:.8f}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
