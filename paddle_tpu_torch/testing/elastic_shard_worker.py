"""Elastic sharded-pretrain worker (counterpart of the reference's
``tests/_elastic_shard_worker.py``, with the same environment plus the
device).

Run this file as a script (under the launcher in ``dist`` mode). Two
modes, selected by ``ELASTIC_SHARD_MODE``:

- ``dist``: one of two ranks under ``paddle_tpu_torch.distributed.launch``
  (gloo). Each rank trains group-sharded stage 3 (``p_g_os``, each rank
  holding half of every parameter and its moments) under a
  TrainingSupervisor whose peer tier publishes SHARDED payloads (each rank
  ships only its own shards) to the shared FileKVStore, with ElasticManager
  membership and per-step telemetry. A ``train.kill_rank.<r>@N=kill`` chaos
  spec SIGKILLs the named rank mid-pretrain; the launcher then stops the
  other.
- ``solo``: one process, world 1 (the whole model on one device). Used for
  the uninjected reference run and for the post-kill relaunch:
  ElasticManager re-registers (the dead ranks have aged out: the world
  shrinks 2 -> 1, a re-mesh), resume() gathers BOTH saved ranks' shard
  payloads from the store and restores through the cross-topology reshard,
  then training continues to the same final loss.

The reference's solo mode keeps a two-device mesh in one process; here a
rank is a process, so the relaunch runs unsharded at world 1.

env: ``ELASTIC_DEVICE`` ("cuda" by default, or "cpu"), ``ELASTIC_DIR``
(shared scratch: KV store + elastic membership), ``TOTAL_STEPS``,
``ELASTIC_SETTLE_S`` (sleep before register so a killed wave's heartbeats
age out), ``PADDLE_CHAOS``.

Its imports are absolute: the launcher runs this file as a script.
"""
from __future__ import annotations

import os
import time

import numpy as np

__all__ = ["main", "batch_fn", "build_model"]

SHARD_DEGREE = 2


def batch_fn(index):
    rng = np.random.RandomState(1000 + int(index))
    x = rng.randn(8, 16).astype(np.float32)
    y = rng.randint(0, 8, (8,)).astype(np.int64)
    return x, y


def build_model(device):
    import torch

    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import AdamW

    pt_seed(31)
    gen = torch.Generator().manual_seed(31)
    kw = dict(device=device, dtype=torch.float32, generator=gen)
    model = torch.nn.Sequential(Linear(16, 32, **kw), torch.nn.GELU(),
                                Linear(32, 8, **kw))
    opt = AdamW(learning_rate=1e-2, parameters=model.parameters())
    return model, opt


def main() -> None:
    import torch

    from paddle_tpu_torch.base.device import get_device
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.distributed.store import FileKVStore
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.training import (PeerReplicator,
                                           TrainingSupervisor,
                                           TrainTelemetry)
    from paddle_tpu_torch.utils.retries import Deadline

    device = get_device(os.environ.get("ELASTIC_DEVICE", "cuda"))
    mode = os.environ.get("ELASTIC_SHARD_MODE", "solo")
    scratch = os.environ["ELASTIC_DIR"]
    total = int(os.environ.get("TOTAL_STEPS", "8"))
    settle = float(os.environ.get("ELASTIC_SETTLE_S", "0"))

    if mode == "dist":
        import paddle_tpu_torch.distributed as dist

        dist.init_parallel_env(device)
        rank = dist.get_rank()
    else:
        rank = 0

    # membership: a relaunch waits out the dead wave's heartbeats, so
    # register() sees only the CURRENT incarnation — the world-size
    # decision (2 in the pod wave, 1 after the kill) IS the re-mesh
    if settle > 0:
        time.sleep(settle)
    mgr = ElasticManager(
        os.path.join(scratch, "elastic"), node_id=f"n{rank}",
        np=("2" if mode == "dist" else "1:2"),
        heartbeat_interval=0.2, elastic_timeout=1.2)
    world_nodes = mgr.register(deadline=Deadline(60.0))
    W = len(world_nodes)
    print(f"rank {rank}: ELASTIC world={W} nodes={world_nodes}", flush=True)

    store = FileKVStore(os.path.join(scratch, "store"))
    peer = PeerReplicator(store, rank=rank, world_size=W, tag="esnap")
    telemetry = TrainTelemetry(store, rank, W)
    model, opt = build_model(device)

    def step_fn(batch):
        x = torch.as_tensor(batch[0], device=device)
        y = torch.as_tensor(batch[1], device=device)
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss)

    sup = TrainingSupervisor(
        step_fn, batch_fn, layers=[model], optimizers=[opt],
        snapshot_interval=2, peer=peer, telemetry=telemetry,
        elastic=mgr, rank=rank, sharded_state=True,
        state_layout={"world": W, "mesh": {"sharding": W}})

    # resume BEFORE placement: the restore writes whole tensors;
    # group_sharded_parallel then places parameters and restored moments
    # on THIS incarnation's world (reshard-on-resume, in RAM)
    nxt = sup.resume()
    print(f"rank {rank}: RESUME next_step={nxt} "
          f"gather_ranks={peer.ranks()}", flush=True)
    if W > 1:
        group_sharded_parallel(model, opt, "p_g_os")

    report = sup.run(total)
    loss = report["final_loss"]
    h = sup.health()
    wall = h["wall_seconds"]
    print(f"rank {rank}: final_step={report['final_step']}", flush=True)
    print(f"rank {rank}: final_loss={loss!r}", flush=True)
    print(f"rank {rank}: final_loss_hex="
          f"{np.float32(loss).tobytes().hex()}", flush=True)
    print(f"rank {rank}: reshard_resumes={h['reshard_resumes']}",
          flush=True)
    print(f"rank {rank}: elastic_world={h['elastic']['world_size']} "
          f"remesh_events={h['elastic']['remesh_events']}", flush=True)
    print(f"rank {rank}: LEDGER productive={wall['productive']:.4f} "
          f"rollback={wall['rollback']:.4f} "
          f"checkpoint={wall['checkpoint']:.4f} "
          f"stall={wall['stall']:.4f}", flush=True)
    mgr.exit()
    print(f"ESHARD_OK rank {rank}", flush=True)
    if mode == "dist":
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
