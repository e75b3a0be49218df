"""Rank bodies of the checkpoint and elasticity parity tests
(``tests/test_torch_checkpoint.py``, ``tests/test_torch_elastic.py``), run
by ``torch_dist_ranks.run_ranks`` in gloo processes. Torch and the port
only: the children import this module fresh."""
from __future__ import annotations

import os

import torch


def sharded_rig(rank: int, world: int, steps: int, store_dir: str,
                save_dir: str):
    """Group-sharded stage 3 over the world on the elastic shard worker's
    model and data: a supervisor with sharded peer payloads runs ``steps``
    steps; then the live shards go to ``save_state_dict`` under
    ``save_dir``. Returns this rank's losses, its local shards (with the
    dimension each was cut along) and the whole state gathered over the
    group."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.checkpoint import reshard
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.distributed.store import FileKVStore
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.testing.elastic_shard_worker import (batch_fn,
                                                               build_model)
    from paddle_tpu_torch.training import PeerReplicator, TrainingSupervisor

    model, opt = build_model("cpu")
    group_sharded_parallel(model, opt, "p_g_os")
    losses = []

    def step_fn(batch):
        loss = F.cross_entropy(model(torch.as_tensor(batch[0])),
                               torch.as_tensor(batch[1]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        return losses[-1]

    store = FileKVStore(store_dir)
    sup = TrainingSupervisor(
        step_fn, batch_fn, layers=[model], optimizers=[opt],
        snapshot_interval=2, peer=PeerReplicator(store, rank, world,
                                                 tag="ck"),
        rank=rank, sharded_state=True,
        state_layout={"world": world, "mesh": {"sharding": world}})
    sup.run(steps)
    sup.peer.wait()
    gs = model._group_sharded
    named = dict(model.named_parameters())
    by_name = {opt._name(p): p for p in opt._parameter_list}
    local = {}
    for k, t in model.state_dict().items():
        s = gs.shards.get(named.get(k))
        local[f"model.{k}"] = (t.clone(), None if s is None else s.dim)
    for k, t in opt.state_dict().items():
        if torch.is_tensor(t):
            s = gs.shards.get(by_name.get(k.rpartition(".")[0]))
            dim = None if s is None or t.dim() == 0 else s.dim
            local[f"opt.{k}"] = (t.clone(), dim)
    sd = {"model": reshard.place(model.state_dict(),
                                 reshard.layer_placements(model)),
          "opt": reshard.place(opt.state_dict(),
                               reshard.optimizer_placements(opt, [model]))}
    dist.save_state_dict(sd, save_dir)
    whole = {f"model.{k}": v.clone() for k, v in gs.full_state().items()}
    return {"losses": losses, "local": local, "whole": whole,
            "global_step": opt._global_step}


def elastic_register(rank: int, world: int, node: str, root: str):
    """Each rank registers one elastic node under ``root``; returns the
    registered world and the dense rank mapping."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    from paddle_tpu_torch.utils.retries import Deadline

    mgr = ElasticManager(os.path.join(root, "el"), node_id=f"{node}{rank}",
                         np=world, heartbeat_interval=0.05,
                         elastic_timeout=5.0)
    world = mgr.register(deadline=Deadline(30.0))
    out = {"world": world, "mapping": mgr.rank_mapping(), "rank": mgr.rank()}
    dist.barrier()
    mgr.exit()
    return out
