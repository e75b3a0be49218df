"""Cluster replica worker process (counterpart of the reference's
``tests/_router_worker.py``, with the same environment plus the device).

Run with ``python -m paddle_tpu_torch.testing.router_worker``. One replica:
connects to the driver's ``TCPKVStore``, builds a tiny model from seed 0
(the same weights in every process, so greedy outputs are token-exact
across the fleet), and runs a :class:`~..inference.cluster.ReplicaServer`
over a journaled supervisor with the prefix cache on.

env:
  ROUTER_DEVICE       — "cuda" (default) or "cpu"; "cuda" without a card
                        raises
  ROUTER_STORE_PORT   — the driver's TCPStoreServer port
  ROUTER_REPLICA_ID   — this replica's id (store namespace)
  ROUTER_JOURNAL_DIR  — journal directory (read by the router on death)
  ROUTER_BUDGET       — serve-loop wall budget in seconds (default 120)
  PADDLE_CHAOS        — optional fault schedule
  PADDLE_LOCK_SANITIZER — non-empty: run under the lock-order sanitizer
                        (``utils.locks``); a recorded inversion fails the
                        exit
  PADDLE_LEAK_SANITIZER — non-empty: run under the resource ledger; on a
                        clean exit nothing may be outstanding
"""
from __future__ import annotations

import os

__all__ = ["main"]


def main() -> None:
    from .. import obs
    from .. import seed as pt_seed
    from ..base.device import get_device
    from ..distributed.store import TCPKVStore
    from ..inference.cluster import ReplicaServer
    from ..inference.serving import ContinuousBatchingEngine
    from ..models import LlamaConfig, LlamaForCausalLM
    from .disagg_worker import _lock_sanitizer_on, _lock_sanitizer_verdict

    device = get_device(os.environ.get("ROUTER_DEVICE", "cuda"))
    sanitize = _lock_sanitizer_on()
    leak_sanitize = bool(os.environ.get("PADDLE_LEAK_SANITIZER"))
    if leak_sanitize:
        # before the factory, so the engine's manager is built wrapped
        from ..utils import resources as _res
        _res.instrument_resources()
    pt_seed(0)
    obs.set_process_label(f"router-{os.environ['ROUTER_REPLICA_ID']}")
    model = LlamaForCausalLM(LlamaConfig.tiny(), device=device)

    def factory():
        return ContinuousBatchingEngine(
            model, max_batch=2, max_len=32, block_size=8, num_blocks=14,
            prompt_pad=24, prefix_cache=True)

    store = TCPKVStore("127.0.0.1", int(os.environ["ROUTER_STORE_PORT"]))
    server = ReplicaServer(
        store, os.environ["ROUTER_REPLICA_ID"], factory,
        journal_dir=os.environ["ROUTER_JOURNAL_DIR"])
    server.serve(deadline=float(os.environ.get("ROUTER_BUDGET", "120")))
    if sanitize:
        _lock_sanitizer_verdict()
    if leak_sanitize:
        # prefix-cache pins last the process's life: drop them, so a clean
        # exit means nothing at all is outstanding
        eng = server.supervisor.engine
        if eng.prefix_cache is not None:
            eng.prefix_cache.clear()
        led = _res.current()
        led.verify(eng.manager)  # free + referenced == pool total
        led.leak_check()  # raises naming acquisition sites
        print("leak-sanitizer: clean", flush=True)


if __name__ == "__main__":
    main()
