"""Port parity: the port's ``ContinuousBatchingEngine(overlap=True)``
against its own ``overlap=False`` and against the JAX package's
``overlap=True``, on ``LlamaConfig.tiny()`` with carried weights (the cases
of ``tests/test_serving_overlap.py``).

Overlap mode changes when the host sees each token, never which: every
stream must equal the sync engine's and the reference's exactly. On the CPU
the ring's copies complete at once, but its ordering logic runs whole. The
transfer ledgers are held to the reference's: the same dispatches and
device->host bytes, the same host->device bytes in sync mode, and in
overlap mode one byte less a dirty-row upload (the port uploads a row as
int32 ``(table row, cache_len, tok, finished)`` where the reference sends
the row index, the row and three scalars, ``finished`` as one byte).
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
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


def _serve(engine_cls, model, workload, **kw):
    eng = engine_cls(model, **kw)
    for rid, prompt, max_new in workload:
        eng.add_request(rid, prompt, max_new_tokens=max_new)
    done = eng.run()
    return {rid: list(map(int, done[rid].out)) for rid, _, _ in workload}, eng


def _abc(models, workload, **kw):
    """Port sync, port overlap and reference overlap over one workload:
    the streams must be equal, and the overlap ledgers the reference's.
    Returns (tokens, port sync engine, port overlap engine)."""
    jm, tm = models
    sync, seng = _serve(ContinuousBatchingEngine, tm, workload,
                        overlap=False, **kw)
    ovl, oeng = _serve(ContinuousBatchingEngine, tm, workload, overlap=True,
                       **kw)
    ref, jeng = _serve(JEngine, jm, workload, overlap=True, **kw)
    assert sync == ovl == ref, (kw, sync, ovl, ref)
    got, want = oeng.overlap_stats(), jeng.overlap_stats()
    for key in ("enabled", "pipeline_depth", "in_flight", "dispatches",
                "d2h_bytes", "tokens_per_dispatch"):
        assert got[key] == want[key], key
    assert got["h2d_decode_bytes"] == (want["h2d_decode_bytes"]
                                       - oeng._rows_flushed)
    assert got["h2d_bytes"] == want["h2d_bytes"] - oeng._rows_flushed
    assert oeng.spec_stats() == jeng.spec_stats()
    assert oeng.prefix_stats() == jeng.prefix_stats()
    return sync, seng, oeng


def _workload(rng, n=4, lens=(5, 11, 3, 8), gens=(6, 4, 8, 5)):
    return [(f"r{i}", rng.randint(0, 250, (lens[i % len(lens)],)),
             gens[i % len(gens)]) for i in range(n)]


_MODES = {
    "whole_prompt": dict(max_batch=3, max_len=64, block_size=8,
                         num_blocks=24, prompt_pad=16),
    "chunked": dict(max_batch=3, max_len=64, block_size=8, num_blocks=24,
                    prefill_chunk=4, max_num_batched_tokens=8),
    "chunk_scan": dict(max_batch=3, max_len=64, block_size=8, num_blocks=24,
                       prompt_pad=16, decode_chunk=4),
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_overlap_matches_sync_and_reference(models, mode):
    _, seng, oeng = _abc(models, _workload(np.random.RandomState(0)),
                         **_MODES[mode])
    st = oeng.overlap_stats()
    assert st["enabled"] and st["pipeline_depth"] == 1
    assert st["in_flight"] == 0  # run() drained the ring
    assert st["dispatches"] >= seng.overlap_stats()["dispatches"]
    assert oeng.manager.free_blocks == seng.manager.free_blocks == 24


def test_eos_and_one_token_budget_edges(models):
    """A slot that finishes on its first decode is still in flight when
    the host learns it: the over-issued token is discarded."""
    _, tm = models
    p = np.random.RandomState(2).randint(0, 250, (4,))
    ref = _serve(ContinuousBatchingEngine, tm, [("x", p, 8)], max_batch=1,
                 max_len=32, block_size=8, num_blocks=4, prompt_pad=8)[0]["x"]
    eos = ref[2]
    for kw, n, want in ((dict(eos_token_id=eos), 8, ref[:3]),
                        (dict(), 1, ref[:1])):
        out, seng, oeng = _abc(models, [("x", p, n)], max_batch=1,
                               max_len=32, block_size=8, num_blocks=4,
                               prompt_pad=8, **kw)
        assert out["x"] == want, kw
        assert oeng.manager.free_blocks == 4


def test_h2d_decode_bytes_per_token_drop(models):
    rng = np.random.RandomState(3)
    wl = [(f"r{i}", rng.randint(0, 250, (4,)), 12) for i in range(2)]
    jm, _ = models
    kw = dict(max_batch=2, max_len=64, block_size=8, num_blocks=16,
              prompt_pad=8)
    _, seng, oeng = _abc(models, wl, **kw)
    _, jsync = _serve(JEngine, jm, wl, **kw)
    s, o, js = seng.overlap_stats(), oeng.overlap_stats(), jsync.overlap_stats()
    for key in ("dispatches", "h2d_bytes", "h2d_decode_bytes", "d2h_bytes",
                "h2d_decode_bytes_per_token", "tokens_per_dispatch"):
        assert s[key] == js[key], key  # sync mode: the reference's ledgers
    assert (o["h2d_decode_bytes_per_token"]
            < s["h2d_decode_bytes_per_token"]), (s, o)
    assert s["host_blocked_s"] > 0 and o["host_blocked_s"] >= 0
    assert 0.0 <= o["host_blocked_frac"] <= 1.0 and o["busy_s"] > 0
    assert set(o) == {"enabled", "pipeline_depth", "in_flight", "dispatches",
                      "host_blocked_s", "busy_s", "host_blocked_frac",
                      "overlap_frac", "tokens_per_dispatch", "h2d_bytes",
                      "h2d_decode_bytes", "h2d_decode_bytes_per_token",
                      "d2h_bytes"}


def test_device_state_matches_host_mirror(models):
    """With the ring drained, every decode-ready slot's device (tok,
    tables, cache_len, finished) row equals the host's, after each step."""
    _, tm = models
    rng = np.random.RandomState(4)
    wl = [(i, rng.randint(0, 250, (5,)), 8) for i in range(3)]
    eng = ContinuousBatchingEngine(tm, max_batch=2, max_len=64, block_size=8,
                                   num_blocks=16, prompt_pad=8, overlap=True)
    for rid, p, n in wl:  # 3 requests over 2 slots: one waits
        eng.add_request(rid, p, max_new_tokens=n)
    checked = 0
    while eng._queue or eng.num_active:
        eng.step()
        eng._harvest(drain=True)
        tok, tables, cl, fin = (t.numpy() for t in eng._dstate)
        for i, slot in enumerate(eng._slots):
            if not slot.decode_ready or i in eng._dirty:
                continue
            assert cl[i] == slot.cache_len
            assert tok[i] == slot.req.out[-1]
            assert not fin[i]
            np.testing.assert_array_equal(tables[i], eng._tables[i])
            checked += 1
    assert checked > 0
    done = eng.run()
    ref = _serve(ContinuousBatchingEngine, tm, wl, max_batch=2, max_len=64,
                 block_size=8, num_blocks=16, prompt_pad=8)[0]
    assert {r: list(map(int, done[r].out)) for r in done} == ref


def test_spec_decode_with_overlap(models):
    base = np.asarray([7, 9, 11, 7, 9, 11, 7, 9], np.int32)
    wl = [("a", base, 10), ("b", np.asarray(base[::-1]), 8)]
    _, seng, oeng = _abc(models, wl, max_batch=2, max_len=64, block_size=8,
                         num_blocks=16, prefill_chunk=8,
                         max_num_batched_tokens=32, spec_decode_k=2)
    for eng in (seng, oeng):
        assert eng.spec_stats()["dispatches"] > 0
        assert eng.spec_stats()["acceptance_rate"] > 0


def test_prefix_cache_with_overlap(models):
    rng = np.random.RandomState(6)
    fam = rng.randint(0, 250, (16,))
    wl = [(f"r{i}", np.concatenate([fam, rng.randint(0, 250, (4 + i,))]), 5)
          for i in range(3)]
    _, _, oeng = _abc(models, wl, max_batch=2, max_len=64, block_size=8,
                      num_blocks=24, prefill_chunk=8,
                      max_num_batched_tokens=12, prefix_cache=True)
    assert oeng.prefix_stats()["hit_tokens"] > 0


def test_int8_kv_with_overlap(models):
    _abc(models, _workload(np.random.RandomState(7), n=3), max_batch=2,
         max_len=64, block_size=8, num_blocks=16, prompt_pad=16,
         kv_dtype="int8", decode_chunk=2)
