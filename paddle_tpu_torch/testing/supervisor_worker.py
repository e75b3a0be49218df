"""Serving-supervisor kill-and-relaunch worker (counterpart of the
reference's ``tests/_supervisor_worker.py``, with the same environment
plus the device).

Run with ``python -m paddle_tpu_torch.testing.supervisor_worker``. Builds a
tiny model from seed 0 and a :class:`~..inference.supervisor.ServingSupervisor`
with a journal, submits a fixed request set (skipping ids a previous life
journaled), drives the loop, and prints the harvested results as one JSON
line. A first wave dies at a scheduled ``kill`` at ``serving.step``
(``PADDLE_CHAOS``); the relaunch, run without it, replays the journal:
accepted unfinished requests are requeued and finished ones restored, so
every request ends token-identical to an isolated ``generate()`` run.

env:
  SUP_DEVICE   — "cuda" (default) or "cpu"; "cuda" without a card raises
  SUP_DIR      — journal directory (shared across waves)
  SUP_NREQ     — number of requests to submit (default 4)
  SUP_OVERLAP  — non-empty: engines run overlap mode (a kill then lands
                 with the copy ring mid-flight)
  PADDLE_CHAOS — optional fault schedule (the first wave only)
  PADDLE_LOCK_SANITIZER — non-empty: run under the lock-order sanitizer
                        (``utils.locks``); a recorded inversion fails the
                        exit
"""
from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["main", "requests"]


def requests(n_req: int, vocab: int = 256):
    """The fixed request set: ``[(req_id, prompt, max_new_tokens)]``, the
    reference worker's prompts and budgets."""
    rng = np.random.RandomState(5)
    out = []
    for i in range(n_req):
        prompt = rng.randint(0, 250, (3 + i % 4,))
        out.append((f"r{i}", prompt, 3 + i % 3))
    return out


def main() -> None:
    from .. import seed as pt_seed
    from ..base.device import get_device
    from ..inference.serving import ContinuousBatchingEngine
    from ..inference.supervisor import ServingSupervisor
    from ..models import LlamaConfig, LlamaForCausalLM
    from .disagg_worker import _lock_sanitizer_on, _lock_sanitizer_verdict

    device = get_device(os.environ.get("SUP_DEVICE", "cuda"))
    sanitize = _lock_sanitizer_on()
    pt_seed(0)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device=device)

    def factory():
        return ContinuousBatchingEngine(
            model, max_batch=2, max_len=32, block_size=8, num_blocks=8,
            prompt_pad=8, overlap=bool(os.environ.get("SUP_OVERLAP")))

    sup = ServingSupervisor(factory, journal_dir=os.environ["SUP_DIR"])
    for rid, prompt, new in requests(int(os.environ.get("SUP_NREQ", "4"))):
        if rid not in sup.journaled_ids:
            sup.submit(rid, prompt, max_new_tokens=new)
    res = sup.run()
    print(json.dumps({
        "results": {str(rid): {"status": r.status,
                               "out": [int(t) for t in r.out]}
                    for rid, r in res.items()},
        "restarts": sup.restarts,
    }), flush=True)
    if sanitize:
        _lock_sanitizer_verdict()


if __name__ == "__main__":
    main()
