"""Fault-tolerant-training worker: one dp replica rank (counterpart of the
reference's ``tests/_trainfault_worker.py``, with the same environment plus
the device).

Run with ``python -m paddle_tpu_torch.testing.trainfault_worker``. Each rank
trains an IDENTICAL tiny model on an identical data stream (bit-exact dp
replicas without a process group), under a TrainingSupervisor wired to the
shared TCP store: peer-replicated in-memory snapshots (PeerReplicator) and
cross-rank telemetry (TrainTelemetry). ``chaos.inject("train.step")`` at the
top of every step is the kill site; ``train.nan``/``train.spike``/
``train.sdc`` fire inside the supervisor itself.

On start the worker calls ``resume()``: a relaunched rank restores from the
freshest verified tier (peer RAM preferred; disk only when TF_DIR is set)
and reports which one it used, then prints ``DONE rank=... final_loss=...``.

env:
  TF_DEVICE  — "cuda" (default) or "cpu"; "cuda" without a card raises
  TF_STORE   — host:port of the parent's TCPStoreServer
  TF_RANK    — this rank (0-based)
  TF_WORLD   — world size
  TF_TOTAL   — total steps to train
  TF_TAG     — key namespace (one per wave)
  TF_DIR     — optional scratch dir: enables the disk AutoCheckpoint tier
  TF_SNAP    — snapshot/peer interval (default 5)
  PADDLE_CHAOS — optional fault schedule
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["main", "build_rig"]


def build_rig(device):
    """The reference worker's model (Linear 8->16, ReLU, Linear 16->4, from
    a seeded generator), AdamW(lr 1e-2), its 64 batches, and the step."""
    import torch

    from .. import seed as pt_seed
    from ..nn import Linear
    from ..nn import functional as F
    from ..optimizer import AdamW
    from . import chaos

    pt_seed(0)
    gen = torch.Generator().manual_seed(0)
    kw = dict(device=device, dtype=torch.float32)
    model = torch.nn.Sequential(Linear(8, 16, generator=gen, **kw),
                                torch.nn.ReLU(),
                                Linear(16, 4, generator=gen, **kw))
    opt = AdamW(learning_rate=1e-2, parameters=model.parameters())
    rng = np.random.RandomState(7)
    data = [(rng.randn(8, 8).astype(np.float32),
             rng.randint(0, 4, (8,)).astype(np.int64)) for _ in range(64)]

    def batch_fn(i):
        return data[(i - 1) % len(data)]

    def step_fn(batch):
        # the kill site: a scheduled 'kill' dies mid-step, like a real
        # worker death (state for this step never completes)
        chaos.inject("train.step")
        x = torch.as_tensor(batch[0], device=device)
        y = torch.as_tensor(batch[1], device=device)
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, opt, batch_fn, step_fn


def main() -> None:
    from ..base.device import get_device
    from ..distributed.store import TCPKVStore
    from ..incubate.checkpoint.auto_checkpoint import AutoCheckpoint
    from ..training import PeerReplicator, TrainingSupervisor, TrainTelemetry
    from ..utils.retries import Deadline

    device = get_device(os.environ.get("TF_DEVICE", "cuda"))
    host, port = os.environ["TF_STORE"].rsplit(":", 1)
    rank = int(os.environ["TF_RANK"])
    world = int(os.environ["TF_WORLD"])
    total = int(os.environ["TF_TOTAL"])
    tag = os.environ.get("TF_TAG", "tfw")
    snap = int(os.environ.get("TF_SNAP", "5"))

    store = TCPKVStore(host, int(port), timeout=10.0)
    store.wait_alive(deadline=Deadline(30.0))
    model, opt, batch_fn, step_fn = build_rig(device)
    ac = None
    if os.environ.get("TF_DIR"):
        ac = AutoCheckpoint(
            os.path.join(os.environ["TF_DIR"], f"rank-{rank}"),
            layers=[model], optimizers=[opt],
            save_interval_steps=snap, async_save=False)
    sup = TrainingSupervisor(
        step_fn, batch_fn, layers=[model], optimizers=[opt],
        snapshot_interval=snap,
        peer=PeerReplicator(store, rank, world, tag=tag),
        auto_checkpoint=ac,
        telemetry=TrainTelemetry(store, rank, world, tag=tag,
                                 straggler_patience=10_000),
        telemetry_interval=2,
    )
    start = sup.resume()
    tier = "fresh"
    for kind, detail in sup.events:
        if kind == "resume":
            tier = ("peer" if "peer RAM" in detail
                    else "disk" if "disk" in detail else "fresh")
    print(f"resumed step={start} tier={tier}", flush=True)

    rep = sup.run(total)
    sup.peer.wait()
    print(f"DONE rank={rank} final_loss={rep['final_loss']:.8f} "
          f"final_hex={np.float32(rep['final_loss']).tobytes().hex()} "
          f"rollbacks={rep['rollbacks']} "
          f"quarantined={rep['quarantined']}", flush=True)


if __name__ == "__main__":
    main()
