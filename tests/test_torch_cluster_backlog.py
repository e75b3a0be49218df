"""``chip_smoke.py`` phase 15(b)'s backlog placement on the CPU: each
session lands on its own live replica whatever the replicas' loads do
while the backlog goes in (``chip_smoke.submit_backlog``).

The router places a request by the loads it reads at submit time. Its
``est_queue_delay_s`` term grows with a replica's measured step time
(``ewma_step_s``), so on a loaded machine a session's later requests, and
with them the session, moved to an idle replica. Here the load moves
between submits on purpose: the replica that just took a request is
stepped (its queue is admitted, its KV occupancy rises) and reads as slow
(a 10 s step). Without the pin the second session's requests follow the
load, not the session.
"""
import importlib.util
import os
import sys

import numpy as np

from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.inference.cluster import ClusterRouter, InProcessReplica
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128)
ENGINE = dict(max_batch=4, max_len=64, block_size=8, prefill_chunk=16,
              num_blocks=40, prefix_cache=True)


def _chip_smoke():
    name = "_backlog_chip_smoke"
    cs = sys.modules.get(name)
    if cs is None:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(repo, "chip_smoke.py"))
        cs = importlib.util.module_from_spec(spec)
        sys.modules[name] = cs
        spec.loader.exec_module(cs)
    return cs


def test_backlog_sessions_stay_on_their_replicas_while_the_load_moves(
        monkeypatch):
    import torch

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "AUTOSCALE_BACKLOG_NEW", 4)
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    model.eval()
    reps = [InProcessReplica(f"r{i}", lambda: ContinuousBatchingEngine(
        model, **ENGINE)) for i in range(3)]
    router = ClusterRouter(reps, block_size=ENGINE["block_size"])
    live = [0, 1, 2]
    rng = np.random.RandomState(15)
    prompts = {f"drain-{n}-{j}": rng.randint(0, 256, (12,)).astype(np.int32)
               for n in range(3) for j in range(cs.AUTOSCALE_BACKLOG)}

    def load_moves(idx):
        reps[idx].pump()
        reps[idx].supervisor.engine.ewma_step_s = 10.0

    try:
        ids = cs.submit_backlog(router, live, prompts, between=load_moves)
        placed = [router._sessions[f"drain-s{n}"] for n in range(3)]
        assert placed == live
        assert ids == list(prompts)
        on = {rid: idx for rid, (rec, idx) in router.inflight.items()}
        for n in range(3):
            assert {on[f"drain-{n}-{j}"] for j in range(
                cs.AUTOSCALE_BACKLOG)} == {n}
        # the pin lasts only while the backlog goes in
        assert router.session_weight == 1.0
    finally:
        for r in reps:
            r.stop()
