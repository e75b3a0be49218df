"""Port parity: the host-RAM prefix tier — ``BlockManager.export_blocks`` /
``import_blocks`` and ``HostTier`` frames — against the JAX package's.

Frames are byte-identical between the packages for the same pages (bf16,
carried by the port as raw 16-bit patterns, and int8 with its scales), and
each package decodes the other's. Imports write into the existing pool
tensors in place (the engine's captured graphs hold their addresses). The
engine's write-through spill and read-through restore give the reference
engine's restores, hit tokens and streams.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import cache_tier as jtier
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.ops.paged_attention import BlockManager as JManager
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch.inference import ContinuousBatchingEngine, HostTier
from paddle_tpu_torch.inference import cache_tier as ttier
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.paged_attention import BlockImportError, BlockManager
from paddle_tpu_torch.testing import chaos as tchaos
from paddle_tpu_torch.utils import load_jax_params


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    tchaos.uninstall()
    jchaos.uninstall()


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _arrays(kind, layers=2, kvh=2, blocks=8, bs=4, d=8, seed=0):
    """Per-layer numpy pool tuples: bf16 pools as raw 16-bit patterns
    (finite values), int8 pools with f32 per-token scales."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(layers):
        if kind == "int8":
            out.append((rng.randint(-127, 128, (kvh, blocks, bs, d)).astype(np.int8),
                        rng.randint(-127, 128, (kvh, blocks, bs, d)).astype(np.int8),
                        rng.rand(kvh, blocks, bs).astype(np.float32),
                        rng.rand(kvh, blocks, bs).astype(np.float32)))
        else:
            f = rng.randn(2, kvh, blocks, bs, d).astype(np.float32)
            bits = torch.from_numpy(f).to(torch.bfloat16).view(torch.int16)
            raw = bits.numpy().view(np.uint16)
            out.append((raw[0], raw[1]))
    return out


def _torch_pools(arrs):
    def one(a):
        if a.dtype == np.uint16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return [tuple(one(a) for a in e) for e in arrs]


def _jax_pools(arrs):
    def one(a):
        if a.dtype == np.uint16:
            return jnp.asarray(a.view(jnp.bfloat16))
        return jnp.asarray(a)
    return [tuple(one(a) for a in e) for e in arrs]


def _ref_pages(a):
    """Pages as the reference carries them: bf16 as ``ml_dtypes`` arrays."""
    return a.view(jnp.bfloat16) if a.dtype == np.uint16 else a


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _pool_bits(t):
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_export_and_frames_are_byte_identical(kind):
    arrs = _arrays(kind)
    tp, jp = _torch_pools(arrs), _jax_pools(arrs)
    tm, jm = BlockManager(8, 4), JManager(8, 4)
    for m in (tm, jm):
        m.allocate("occupant", 6)
        m.allocate("x", 10)  # 3 blocks, the last partial
    tpages, tscales, tmeta = tm.export_blocks("x", tp, num_tokens=8)
    jpages, jscales, jmeta = jm.export_blocks("x", jp, num_tokens=8)
    assert tmeta == jmeta and tmeta["num_blocks"] == 2
    np.testing.assert_array_equal(_bits(tpages), _bits(jpages))
    assert (tscales is None) == (jscales is None) == (kind != "int8")
    if tscales is not None:
        np.testing.assert_array_equal(tscales, np.asarray(jscales))
    toks = np.arange(100, 108, dtype=np.int32)
    tframe = ttier._encode(toks, tpages, tscales, tmeta)
    jframe = jtier._encode(toks, jpages, jscales, jmeta)
    assert tframe == jframe
    # each package decodes the other's frame
    for dec, frame in ((ttier._decode, jframe), (jtier._decode, tframe)):
        rtoks, rpages, rscales, rmeta = dec(frame)
        assert rmeta == tmeta and list(rtoks) == list(toks)
        np.testing.assert_array_equal(_bits(rpages), _bits(tpages))
        if tscales is not None:
            np.testing.assert_array_equal(rscales, tscales)
    # the stores agree too: the same key, the same bytes
    ts, js = {}, {}
    HostTier(backend=ts).put("t0", toks, tpages, tscales, tmeta)
    jtier.HostTier(backend=js).put("t0", toks, jpages, jscales, jmeta)
    assert ts == js


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_import_writes_the_pools_in_place_bitwise(kind):
    arrs = _arrays(kind)
    src, sp = BlockManager(8, 4), _torch_pools(arrs)
    src.allocate("x", 8)
    pages, scales, meta = src.export_blocks("x", sp)
    dst, dp = BlockManager(16, 4), _torch_pools(_arrays(kind, blocks=16,
                                                        seed=9))
    dst.allocate("occupant", 12)  # another free-list shape
    ptrs = [[t.data_ptr() for t in e] for e in dp]
    before = [[t.clone() for t in e] for e in dp]
    same, blocks = dst.import_blocks("x", pages, scales, meta, dp)
    assert same is dp
    assert [[t.data_ptr() for t in e] for e in dp] == ptrs
    srow = src.owned_blocks("x")
    others = [b for b in range(16) if b not in blocks]
    for es, ed, eb in zip(sp, dp, before):
        for ts, td, tb in zip(es, ed, eb):
            np.testing.assert_array_equal(_pool_bits(ts[:, srow]),
                                          _pool_bits(td[:, blocks]))
            assert torch.equal(td[:, others], tb[:, others])
    # the reference's import of the same export lands the same bytes
    jm = JManager(16, 4)
    jm.allocate("occupant", 12)
    jp, jblocks = jm.import_blocks("x", _ref_pages(pages), scales, meta,
                                   _jax_pools(_arrays(kind, blocks=16,
                                                      seed=9)))
    assert jblocks == blocks
    for ej, ed in zip(jp, dp):
        for tj, td in zip(ej, ed):
            np.testing.assert_array_equal(_bits(np.asarray(tj)),
                                          _pool_bits(td))


def test_import_refusals_leave_nothing_allocated():
    arrs = _arrays("bf16")
    src = BlockManager(8, 4)
    src.allocate("x", 12)
    pages, scales, meta = src.export_blocks("x", _torch_pools(arrs))
    dst = BlockManager(8, 4)
    dst.allocate("big", 24)  # 6 of 8 blocks taken
    pools = _torch_pools(arrs)
    with pytest.raises(BlockImportError, match="too full"):
        dst.import_blocks("y", pages, scales, meta, pools)
    for bad, msg in ((dict(meta, block_size=8), "block_size"),
                     (dict(meta, layers=3), "layers"),
                     (dict(meta, quantized=True), "quantized")):
        with pytest.raises(ValueError, match=msg):
            dst.import_blocks("y", pages, scales, bad, pools)
    assert "y" not in dst.accounting()["owned"] and dst.free_blocks == 2
    with pytest.raises(KeyError):
        src.export_blocks("nobody", pools)


def test_frames_decode_without_ml_dtypes(monkeypatch):
    """The port reads and writes bf16 frames with no ``ml_dtypes``: hidden
    from ``sys.modules``, a reference frame still decodes, and the pages
    round-trip through a tier and an import bitwise."""
    arrs = _arrays("bf16")
    jm = JManager(8, 4)
    jm.allocate("x", 8)
    jpages, _, jmeta = jm.export_blocks("x", _jax_pools(arrs))
    toks = np.arange(8, dtype=np.int32)
    jframe = jtier._encode(toks, jpages, None, jmeta)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # import now fails
    with pytest.raises(ImportError):
        import ml_dtypes  # noqa: F401
    _, pages, _, meta = ttier._decode(jframe)
    assert pages.dtype == np.uint16 and meta["dtype"] == "bfloat16"
    tier = HostTier()
    assert tier.put(None, toks, pages, None, meta)
    n, rpages, _, rmeta = tier.lookup(None, toks, block_size=4)
    assert n == 8 and ttier._encode(toks, rpages, None, rmeta) == jframe
    dst = BlockManager(8, 4)
    pools = _torch_pools(_arrays("bf16", seed=3))
    _, blocks = dst.import_blocks("x", rpages, None, rmeta, pools)
    np.testing.assert_array_equal(_pool_bits(pools[0][0][:, blocks]),
                                  _bits(jpages[0, 0]))


def _tier_pair():
    return HostTier(), jtier.HostTier()


def _put(tier, ns, lo, n=4):
    toks = np.arange(lo, lo + n, dtype=np.int32)
    pages = np.full((1, 1, 4, 2), float(lo), np.float32)
    assert tier.put(ns, toks, pages, None, {"num_blocks": 1})
    return toks


def test_lru_namespaces_and_prefix_selection_match_reference():
    t, j = _tier_pair()
    for tier in (t, j):
        t1 = _put(tier, None, 100)
        t2 = _put(tier, None, 200)
        tier.capacity_bytes = tier.stats()["bytes"]  # exactly two fit
        assert tier.lookup(None, t1, block_size=4) is not None
        t3 = _put(tier, None, 300)  # evicts t2, the least recent
        assert tier.lookup(None, t2, block_size=4) is None
        assert tier.lookup(None, t3, block_size=4) is not None
        _put(tier, None, 300)  # idempotent: refreshes only
        toks = _put(tier, "tenantA", 7)
        assert tier.lookup("tenantB", toks, block_size=4) is None
        assert tier.lookup("tenantA", toks, block_size=4) is not None
        assert not tier.put(None, np.arange(4), np.zeros((64, 64), np.float32),
                            None, {"num_blocks": 1})  # oversize
    assert t.stats() == j.stats()
    assert list(t._index) == list(j._index)
    t, j = _tier_pair()
    for tier in (t, j):
        toks = np.arange(16)
        pages = np.zeros((1, 2, 4, 2), np.float32)
        tier.put(None, toks[:4], pages, None, {"num_blocks": 1})
        tier.put(None, toks[:12], pages, None, {"num_blocks": 3})
        assert tier.lookup(None, toks, block_size=4)[0] == 12
        assert tier.lookup(None, toks, block_size=4, min_tokens=12) is None
        assert tier.lookup(None, toks[:14], block_size=4)[0] == 12
    assert t.stats() == j.stats()


@pytest.mark.parametrize("fault", ["corrupt", "drop"])
def test_chaos_spill_matches_reference(fault):
    """``cache.spill`` chaos: a corrupt frame is stored, rejected by its
    CRC at lookup (a miss, purged) and healed by a clean re-put; a dropped
    spill is never stored. Both tiers count the same."""
    arrs = _arrays("bf16")
    m = BlockManager(8, 4)
    m.allocate("x", 8)
    pages, scales, meta = m.export_blocks("x", _torch_pools(arrs))
    toks = np.arange(8, dtype=np.int32)
    results = []
    for tier, ch, pg in ((HostTier(), tchaos, pages),
                         (jtier.HostTier(), jchaos, _ref_pages(pages))):
        ch.install(ch.ChaosSchedule(seed=1).at("cache.spill", 1, fault))
        stored = tier.put("t", toks, pg, scales, meta)
        miss = tier.lookup("t", toks, block_size=4) is None
        ch.uninstall()
        healed = tier.put("t", toks, pg, scales, meta)
        hit = tier.lookup("t", toks, block_size=4)
        np.testing.assert_array_equal(_bits(hit[1]), _bits(pages))
        results.append((stored, miss, healed, tier.stats()))
    assert results[0] == results[1]
    stored, miss, _, st = results[0]
    assert miss and st["corrupt_rejected"] == (fault == "corrupt")
    assert st["put_drops"] == (fault == "drop") and stored == (fault != "drop")


@pytest.mark.parametrize("kw", [
    dict(max_batch=1, prompt_pad=24),
    dict(max_batch=1, prefill_chunk=8, kv_dtype="int8"),
    dict(max_batch=2, prompt_pad=24, overlap=True),
], ids=["whole", "chunked_int8", "overlap"])
def test_engine_restores_match_reference(models, kw):
    """The reference's scenario: four 17-token prompts (2 full blocks each)
    overflow an 8-block pool, so the replay pass can hit only through tier
    restores. Streams, restores, restored and hit tokens, the tier's
    counters and the block accounting equal the reference engine's; every
    restore writes into the same pool tensors."""
    jm, tm = models
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 250, (17,)).astype(np.int32) for _ in range(4)]
    base = dict(max_len=32, block_size=8, num_blocks=8, prefix_cache=True)
    j = JEngine(jm, cache_tier=jtier.HostTier(), **base, **kw)
    t = ContinuousBatchingEngine(tm, cache_tier=HostTier(), **base, **kw)
    ptrs = [[x.data_ptr() for x in e] for e in t._pools]

    def run(eng, tag):
        outs = []
        for i, p in enumerate(prompts):
            rid = f"{tag}-{i}"
            eng.add_request(rid, p, 4)
            for _ in range(512):
                if rid in eng._completed:
                    break
                eng.step()
            assert eng._completed[rid].status == "ok"
            outs.append([int(x) for x in eng._completed[rid].out])
        return outs

    for tag in ("warm", "replay"):
        assert run(t, tag) == run(j, tag)
    tst, jst = t.prefix_stats(), j.prefix_stats()
    assert tst["tier"]["restores"] >= 1
    assert tst["tier"]["restore_tokens"] >= 16
    for k in ("hit_tokens", "prefill_tokens", "forks", "nodes",
              "evicted_blocks"):
        assert tst[k] == jst[k], k
    for k, v in jst["tier"].items():
        assert tst["tier"][k] == v, k
    assert tst["tier"]["spill_bytes"] > 0
    assert [[x.data_ptr() for x in e] for e in t._pools] == ptrs
    assert t.manager.accounting() == j.manager.accounting()


def test_restored_prefix_reexports_its_spilled_pages(models):
    """A restored prefix, exported again from the pools, is bitwise the
    frame it was restored from."""
    _, tm = models
    tier = HostTier()
    eng = ContinuousBatchingEngine(tm, max_batch=1, max_len=32, block_size=8,
                                   num_blocks=4, prompt_pad=24,
                                   prefix_cache=True, cache_tier=tier)
    rng = np.random.RandomState(12)
    a, b = (rng.randint(0, 250, (17,)) for _ in range(2))
    for rid, p in (("a", a), ("b", b), ("a2", a)):
        eng.add_request(rid, p, 4)
        eng.run()
    assert eng.tier_restores == 1
    _, pages, _, meta = tier.lookup(None, a, block_size=8)
    n, blocks = eng.prefix_cache.lookup(a)
    assert n == 16
    eng.manager.adopt("probe", blocks)
    again, _, meta2 = eng.manager.export_blocks("probe", eng._pools)
    eng.manager.free_sequence("probe")
    assert meta2 == meta
    np.testing.assert_array_equal(_bits(again), _bits(pages))
