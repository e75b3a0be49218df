"""One disaggregated-serving worker process: a prefill OR a decode worker
behind a :class:`~..inference.disagg.DisaggServer`, over the driver's
``TCPKVStore`` (counterpart of the reference's ``tests/_disagg_worker.py``,
with the same environment, plus the device and the model's seed and
dtype).

Run with ``python -m paddle_tpu_torch.testing.disagg_worker``. The model is
built from ``DISAGG_MODEL_JSON`` (``LlamaConfig`` keywords; default
``LlamaConfig.tiny()``) with ``seed(DISAGG_SEED)``, so every process that
builds it from the same JSON and seed on the same kind of device holds the
same weights, and greedy outputs are token-exact across the pools. Besides
its results, the server publishes ``cluster/<id>/launches`` into the store
with every heartbeat: the kernels' launch counts of this process and the
decode steps of every engine it built, so the driver can gate them, even
for a worker that dies to a scheduled ``kill``.

env:
  DISAGG_DEVICE       — "cuda" (default) or "cpu"; "cuda" without a card
                        raises, it never carries on on the CPU
  DISAGG_ROLE         — "prefill" | "decode"
  DISAGG_STORE_PORT   — the driver's TCPStoreServer port
  DISAGG_MODEL_JSON   — LlamaConfig keywords as JSON (default: tiny)
  DISAGG_SEED         — the weights' seed (default 0)
  DISAGG_BF16         — non-empty: the model in bfloat16
  DISAGG_CONTRACT_RANK/_WORLD — flight-recorder contract topology
                        (default: role rank in a 1+1 pair)
  DISAGG_WORKER_ID    — this worker's id (store namespace)
  DISAGG_JOURNAL_DIR  — journal directory (read by the router on death)
  DISAGG_DECODE_IDS   — comma-separated decode channels (prefill role)
  DISAGG_BUDGET       — serve-loop wall budget in seconds (default 120)
  DISAGG_N_PARTS      — fixed part count per transfer (default: 1 MiB parts)
  DISAGG_HANDOFF_BUDGET — seconds a handoff may take, export to ack
                        (prefill role; default 30, the reference's)
  DISAGG_CHUNK        — prefill_chunk for both roles (default: whole-prompt
                        prefill with DISAGG_PAD)
  DISAGG_PAD          — prompt_pad (default 24)
  DISAGG_MAX_LEN      — engine max_len (default 32)
  DISAGG_BLOCKS       — engine num_blocks (default 16)
  DISAGG_BATCH        — engine max_batch (default 2)
  DISAGG_OVERLAP      — non-empty: the engines run overlap mode
  DISAGG_STEPS_PER_PUMP — decode steps between store polls (default 1)
  DISAGG_TRACE_DUMP   — a path: the trace ring is dumped there at exit
  PADDLE_CHAOS        — optional fault schedule
  PADDLE_LOCK_SANITIZER — non-empty: run under the lock-order sanitizer
                        (``utils.locks``); a recorded inversion fails the
                        exit
  PADDLE_LEAK_SANITIZER — non-empty: run under the resource ledger; a
                        clean exit must leave nothing outstanding
"""
from __future__ import annotations

import json
import os

__all__ = ["main", "build_model", "launch_record"]


def _lock_sanitizer_on() -> bool:
    """``PADDLE_LOCK_SANITIZER``: trace every lock made from here on (a
    lock-order inversion anywhere in the worker raises
    ``LockOrderViolation`` in process)."""
    if not os.environ.get("PADDLE_LOCK_SANITIZER"):
        return False
    from ..utils.locks import instrument_locks

    instrument_locks()
    return True


def _lock_sanitizer_verdict() -> None:
    """At a clean exit: a recorded violation fails the worker."""
    from ..utils.locks import violation_count

    n = violation_count()
    assert n == 0, f"lock sanitizer recorded {n} violation(s)"
    print("lock-sanitizer: clean", flush=True)


def build_model(device: str, model_json=None, seed: int = 0,
                bf16: bool = False, max_len: int = 32):
    """The worker's model: ``LlamaConfig(**model_json)`` (or the tiny
    config, its positions raised to ``max_len``) drawn from ``seed`` on
    ``device``, in bfloat16 when asked. Eval mode."""
    import torch

    from .. import seed as pt_seed
    from ..models import LlamaConfig, LlamaForCausalLM

    if model_json:
        cfg = LlamaConfig(**json.loads(model_json))
    else:
        cfg = LlamaConfig.tiny()
        if max_len > cfg.max_position_embeddings:
            cfg = LlamaConfig.tiny(max_position_embeddings=max_len)
    pt_seed(seed)
    model = LlamaForCausalLM(cfg, device=device,
                             dtype=torch.bfloat16 if bf16 else torch.float32)
    model.eval()
    return model


def launch_record(engines) -> dict:
    """This process's kernel launch counts and the decode steps and
    dispatches of every engine it built."""
    from ..ops import kernels

    return {"counts": kernels.launch_counts(),
            "decode_steps": sum(e.decode_steps for e in engines),
            "dispatches": sum(e.n_dispatches for e in engines),
            "engines": len(engines), "pid": os.getpid()}


def main() -> None:
    from .. import obs
    from ..base.device import get_device
    from ..distributed.store import TCPKVStore
    from ..inference.disagg import DecodeWorker, DisaggServer, PrefillWorker
    from ..inference.serving import ContinuousBatchingEngine

    device = get_device(os.environ.get("DISAGG_DEVICE", "cuda"))
    sanitize = _lock_sanitizer_on()
    leak_sanitize = bool(os.environ.get("PADDLE_LEAK_SANITIZER"))
    if leak_sanitize:
        # before the factory, so the engine's manager is built wrapped
        from ..utils import resources as _res
        _res.instrument_resources()
    role = os.environ["DISAGG_ROLE"]
    max_len = int(os.environ.get("DISAGG_MAX_LEN", "32"))
    model = build_model(device, os.environ.get("DISAGG_MODEL_JSON"),
                        int(os.environ.get("DISAGG_SEED", "0")),
                        bool(os.environ.get("DISAGG_BF16")), max_len)
    blocks = int(os.environ.get("DISAGG_BLOCKS", "16"))
    chunk = os.environ.get("DISAGG_CHUNK")
    max_batch = int(os.environ.get("DISAGG_BATCH", "2"))
    engines = []

    def factory():
        kw = dict(max_batch=max_batch, max_len=max_len,
                  block_size=8, num_blocks=blocks,
                  role="prefill_only" if role == "prefill"
                  else "decode_only",
                  overlap=bool(os.environ.get("DISAGG_OVERLAP")))
        if chunk:
            kw["prefill_chunk"] = int(chunk)
        else:
            kw["prompt_pad"] = int(os.environ.get("DISAGG_PAD", "24"))
        eng = ContinuousBatchingEngine(model, **kw)
        engines.append(eng)
        return eng

    store = TCPKVStore("127.0.0.1", int(os.environ["DISAGG_STORE_PORT"]))
    wid = os.environ["DISAGG_WORKER_ID"]
    journal_dir = os.environ["DISAGG_JOURNAL_DIR"]
    if role == "prefill":
        sender_kwargs = {}
        n_parts = os.environ.get("DISAGG_N_PARTS")
        if n_parts:
            sender_kwargs["n_parts"] = int(n_parts)
        worker = PrefillWorker(
            wid, factory, store, os.environ["DISAGG_DECODE_IDS"].split(","),
            journal_dir=journal_dir, sender_kwargs=sender_kwargs,
            handoff_budget=float(os.environ.get("DISAGG_HANDOFF_BUDGET",
                                                "30")))
    else:
        worker = DecodeWorker(
            wid, factory, store, journal_dir=journal_dir,
            steps_per_pump=int(os.environ.get("DISAGG_STEPS_PER_PUMP", "1")))
    obs.set_process_label(f"{role}:{wid}")
    crank = os.environ.get("DISAGG_CONTRACT_RANK")
    server = DisaggServer(
        store, worker, contract_rank=None if crank is None else int(crank),
        contract_world=int(os.environ.get("DISAGG_CONTRACT_WORLD", "2")))
    publish = server._publish

    def publish_with_launches():
        # the counts go first: a scheduled kill can end the process
        # between two publications, and the driver reads the last one
        store.set(f"cluster/{wid}/launches",
                  json.dumps(launch_record(engines)))
        publish()

    server._publish = publish_with_launches
    try:
        server.serve(deadline=float(os.environ.get("DISAGG_BUDGET", "120")))
    finally:
        dump_path = os.environ.get("DISAGG_TRACE_DUMP")
        if dump_path:
            with open(dump_path, "w", encoding="utf-8") as fh:
                json.dump(obs.ring().dump(), fh)
    store.set(f"cluster/{wid}/launches", json.dumps(launch_record(engines)))
    if sanitize:
        _lock_sanitizer_verdict()
    if leak_sanitize:
        eng = worker.supervisor.engine
        if eng.prefix_cache is not None:
            eng.prefix_cache.clear()
        led = _res.current()
        led.verify(eng.manager)  # free + referenced == pool total
        led.leak_check()  # raises naming acquisition sites
        print("leak-sanitizer: clean", flush=True)


if __name__ == "__main__":
    main()
