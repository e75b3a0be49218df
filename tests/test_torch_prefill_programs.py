"""Port parity: the engine's prefill programs — whole-prompt (``[B,
prompt_pad]``) and chunked (``[B, prefill_chunk]``) prefill as
``jit.to_static`` functions over persistent inputs, the counterpart of the
reference's ``_prefill_jit`` — against the JAX engine.

On the CPU the programs run eagerly through ``to_static`` (on the card they
are captured as CUDA graphs; ``tests/test_torch_kernels.py`` holds that).
Tokens, upload bytes and ``warmed_up`` move as the reference's do.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu_torch import jit
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.utils import load_jax_params


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return jm, tm


CASES = {
    "whole": dict(max_batch=3, max_len=64, block_size=8, num_blocks=24,
                  prompt_pad=16),
    "whole_chunk4": dict(max_batch=3, max_len=64, block_size=8, num_blocks=24,
                         prompt_pad=16, decode_chunk=4),
    "chunked": dict(max_batch=2, max_len=48, block_size=8, num_blocks=12,
                    prefill_chunk=4, max_num_batched_tokens=6),
    "chunked_overlap": dict(max_batch=2, max_len=48, block_size=8,
                            num_blocks=12, prefill_chunk=4,
                            max_num_batched_tokens=6, overlap=True),
    "whole_overlap_prefix": dict(max_batch=2, max_len=64, block_size=8,
                                 num_blocks=16, prompt_pad=24, overlap=True,
                                 prefix_cache=True, decode_chunk=2),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("static", [True, False], ids=["to_static", "eager"])
def test_prefill_programs_match_reference(models, name, static):
    """The same prompts through both engines in lockstep: after every step
    the streams so far, the prefill token count, the upload bytes of the
    prefill path and ``warmed_up`` agree; the prefill program's inputs
    keep their addresses."""
    jm, tm = models
    kw = CASES[name]
    rng = np.random.RandomState(3)
    shared = rng.randint(0, 250, (16,))
    prompts = [np.concatenate([shared, rng.randint(0, 250, (n,))])
               if name.endswith("prefix") else rng.randint(0, 250, (n + 3,))
               for n in (2, 8, 5, 1, 7)]
    j = JEngine(jm, **kw)
    jit.enable_to_static(static)
    try:
        t = ContinuousBatchingEngine(tm, **kw)
        ptrs = [x.data_ptr() for x in (t._pids, t._ptab, t._pcl, t._plast)]
        width = kw.get("prefill_chunk") or kw["prompt_pad"]
        assert tuple(t._pids.shape) == (kw["max_batch"], width)
        for e in (j, t):
            for i, p in enumerate(prompts):
                e.add_request(i, p, 6)
        assert t.warmed_up == j.warmed_up is False
        moved = []
        for _ in range(200):
            if not (j._queue or j.num_active or t._queue or t.num_active):
                break
            j.step()
            t.step()
            assert t.warmed_up == j.warmed_up
            moved.append(t.warmed_up)
            assert {r: q.out for r, q in t._completed.items()} == {
                r: [int(x) for x in q.out] for r, q in j._completed.items()}
            assert t.prefill_tokens == j.prefill_tokens
            assert t.h2d_bytes - t.h2d_decode_bytes == \
                j.h2d_bytes - j.h2d_decode_bytes
        dt, dj = t.run(), j.run()
    finally:
        jit.enable_to_static(True)
    assert {r: q.out for r, q in dt.items()} == {
        r: [int(x) for x in q.out] for r, q in dj.items()}
    assert moved[-1] and t.warmed_up == j.warmed_up
    assert [x.data_ptr() for x in (t._pids, t._ptab, t._pcl,
                                   t._plast)] == ptrs
    assert "prefill" in t._phases_run and not t._prefill_fn._graphs


def test_prefill_program_returns_only_the_last_positions_tokens(models):
    """One dispatch of the whole-prompt program: ``[B]`` int32 tokens, the
    greedy argmax at each row's last real position — the reference's
    ``prefill`` output — and rows pointed at the trash block write only
    there."""
    jm, tm = models
    eng = ContinuousBatchingEngine(tm, max_batch=2, max_len=32, block_size=8,
                                   num_blocks=8, prompt_pad=8)
    p = np.random.RandomState(4).randint(0, 250, (5,))
    eng.manager.allocate("r", 8)
    row = eng.manager.table_row("r", eng.max_blocks_per_seq, fill=eng._trash)
    iso = np.full_like(eng._tables, eng._trash)
    iso[1] = row
    ids = np.zeros((2, 8), np.int32)
    ids[1, :5] = p
    before = [[x[:, :eng._trash].clone() for x in e] for e in eng._pools]
    out = eng._prefill(ids, iso, np.zeros(2, np.int32),
                       np.array([0, 4], np.int32))
    assert out.dtype == torch.int32 and tuple(out.shape) == (2,)
    logits, _ = tm.forward_with_cache(
        torch.from_numpy(p[None].astype(np.int64)),
        tm.init_cache(1, 8), 0)
    assert int(out[1]) == int(torch.argmax(logits[0, -1]))
    blocks = eng.manager.owned_blocks("r")
    for e, b in zip(eng._pools, before):
        for x, x0 in zip(e, b):
            untouched = [i for i in range(eng._trash) if i not in blocks]
            assert torch.equal(x[:, untouched], x0[:, untouched])
