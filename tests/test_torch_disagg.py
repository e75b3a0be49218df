"""Port parity: disaggregated prefill/decode serving (``inference/disagg.py``
and the engine's ``role=``) against the JAX package's.

The scenarios of the reference's ``tests/test_disagg.py`` run in both
packages on ``LlamaConfig.tiny()`` in f32 with the reference's weights
carried into the port, each package with its own stores, chaos monkey
and flight recorder. Held exactly:

- the blob frames and the chaos byte site;
- ``BlockManager.export_blocks``/``import_blocks`` on f32, bf16 and int8
  pools (pages and scale rows), and ``HandoffPayload.pack()`` bytes for
  the same blocks, with the payload's clock field pinned; payloads cross
  packages both ways;
- the engine roles: a ``prefill_only`` engine never decodes and reserves
  the prompt alone, its export equals the unified engine's blocks byte for
  byte, export/import resumes token-exact (sync and overlap), a payload
  the reference's ``prefill_only`` engine exported and the port's
  ``decode_only`` engine imported yields the reference's unified stream,
  and lapsed handoffs are swept;
- the routers: token streams and counters of ``DisaggRouter`` runs,
  including the corrupt-transfer nack and resend, the dropped import, the
  partial-transfer discard, stale acks, record GC, config skew, the
  kill-one-prefill-worker requeue and the colocated fallback.

The process-level kill (two port workers over a ``TCPKVStore``, run with
``python -m paddle_tpu_torch.testing.disagg_worker`` on the CPU) keeps the
reference's ``slow`` marker.
"""
import base64
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import store as jstore
from paddle_tpu.inference import disagg as jdg
from paddle_tpu.inference import serving as jserving
from paddle_tpu.inference import supervisor as jsup
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu.utils import retries as jretries
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch.distributed import store as tstore
from paddle_tpu_torch.inference import disagg as tdg
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference import supervisor as tsup
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, generate
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.testing import chaos as tchaos
from paddle_tpu_torch.utils import load_jax_params
from paddle_tpu_torch.utils import retries as tretries

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    tchaos.uninstall()
    jchaos.uninstall()


def _pkg(port, model=None):
    return SimpleNamespace(
        port=port, dg=tdg if port else jdg, st=tstore if port else jstore,
        sv=tserving if port else jserving, pa=tpa if port else jpa,
        chaos=tchaos if port else jchaos, sup=tsup if port else jsup,
        Deadline=(tretries if port else jretries).Deadline, model=model)


PKGS = {"port": _pkg(True), "reference": _pkg(False)}


@pytest.fixture(scope="module")
def pk():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return {"port": _pkg(True, tm), "reference": _pkg(False, jm)}


def _both(scenario, pkgs=PKGS):
    got = {name: scenario(P) for name, P in pkgs.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def _generate(model, prompt, n):
    ids = torch.from_numpy(np.asarray(prompt, np.int64)[None])
    return generate(model, ids, max_new_tokens=n)[0, len(prompt):].tolist()


def _eng(P, **kw):
    return P.sv.ContinuousBatchingEngine(P.model, **kw)


# -- frames and the chaos byte site ------------------------------------------


def test_blob_frames_and_transient_taxonomy(tmp_path):
    def scen(P):
        data = bytes(range(256)) * 41
        out = []
        for store in (P.st.MemKVStore(),
                      P.st.FileKVStore(str(tmp_path / str(P.port)))):
            store.put_bytes("b", data)
            out += [store.get_bytes("b") == data, store.get_bytes("absent"),
                    store.get("b")]
        store = P.st.MemKVStore()
        store.put_bytes("b", b"payload bytes" * 50)
        frame = bytearray(base64.b64decode(store.get("b")))
        frame[100] ^= 0x10
        store.set("b", base64.b64encode(bytes(frame)).decode())
        with pytest.raises(P.st.CorruptBlobError, match="CRC32 mismatch"):
            store.get_bytes("b")
        t = P.dg._handoff_transient
        out += [t(P.st.CorruptBlobError("x")),
                t(P.pa.BlockImportError("full")), t(KeyError("fatal")),
                P.st.TCPKVStore._is_transient(P.st.CorruptBlobError("x"))]
        return out

    assert _both(scen)[-4:] == [True, True, False, True]


def test_chaos_byte_site_matches():
    def scen(P):
        data = bytes(64)
        with P.chaos.active(P.chaos.ChaosSchedule().at(
                "site.bytes", 2, "corrupt", 19)):
            first = P.chaos.inject_bytes("site.bytes", data)
            second = P.chaos.inject_bytes("site.bytes", data)
        with P.chaos.active(P.chaos.ChaosSchedule()
                            .at("site.bytes", 1, "drop")
                            .at("site.plain", 1, "corrupt")):
            dropped = P.chaos.inject_bytes("site.bytes", b"x")
            plain = P.chaos.inject("site.plain")
        with P.chaos.active(P.chaos.ChaosSchedule().at(
                "site.bytes", 1, "error")):
            with pytest.raises(RuntimeError, match="injected error"):
                P.chaos.inject_bytes("site.bytes", b"x")
        return first == data, second, dropped, plain

    same, second, dropped, plain = _both(scen)
    assert same and dropped is None and plain is True
    assert [(i, b) for i, b in enumerate(second) if b] == \
        [(19 // 8, 1 << (19 % 8))]


# -- block export/import and the payload's wire format ------------------------


def _arrays(layers=2, kvh=2, blocks=8, bs=4, d=8, quant=False, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(layers):
        if quant:
            out.append((rng.randint(-127, 128, (kvh, blocks, bs, d)),
                        rng.randint(-127, 128, (kvh, blocks, bs, d)),
                        rng.rand(kvh, blocks, bs).astype(np.float32),
                        rng.rand(kvh, blocks, bs).astype(np.float32)))
        else:
            out.append((rng.randn(kvh, blocks, bs, d).astype(np.float32),
                        rng.randn(kvh, blocks, bs, d).astype(np.float32)))
    return out


def _pools(P, arrays, dtype="float32"):
    """The same numbers as one package's pools (bf16 rounds to nearest
    even in both)."""
    def one(a, j):
        if a.dtype.kind == "i":
            return (torch.from_numpy(a.astype(np.int8)) if P.port
                    else jnp.asarray(a, jnp.int8))
        if j >= 2:  # scale rows stay f32
            return torch.from_numpy(a.copy()) if P.port else jnp.asarray(a)
        if P.port:
            return torch.from_numpy(a.copy()).to(getattr(torch, dtype))
        return jnp.asarray(a).astype(getattr(jnp, dtype))
    return [tuple(one(a, j) for j, a in enumerate(e)) for e in arrays]


def _host(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _rows(pools, row):
    return [[_host(p)[:, row].tobytes() for p in e] for e in pools]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_export_import_round_trip_matches(dtype):
    """Ragged tables on the exporter, another free-list shape on the
    importer: the rows round-trip byte-exact, and both packages export and
    import the same bytes (scale rows carried on int8 pools)."""
    quant = dtype == "int8"

    def scen(P):
        src = P.pa.BlockManager(8, 4)
        src.allocate("a", 8)
        src.allocate("x", 10)
        src.free_sequence("a")
        src.allocate("b", 4)
        pools = _pools(P, _arrays(quant=quant), dtype)
        pages, scales, meta = src.export_blocks("x", pools, num_tokens=10)
        dst = P.pa.BlockManager(16, 4)
        dst.allocate("occupant", 20)
        dpools = _pools(P, _arrays(quant=quant, seed=9), dtype)
        dpools, blocks = dst.import_blocks("x", pages, scales, meta, dpools)
        return (_host(pages).tobytes(),
                None if scales is None else _host(scales).tobytes(), meta,
                blocks, _rows(pools, src.owned_blocks("x")) ==
                _rows(dpools, blocks), dst.owned_blocks("x"))

    pages, scales, meta, blocks, same, owned = _both(scen)
    assert same and meta["num_blocks"] == 3 and owned == blocks
    assert (scales is not None) == quant and meta["quantized"] == quant
    assert meta["dtype"] == dtype


def test_export_refs_fuller_pools_mismatches_and_limits():
    def scen(P):
        out = []
        mgr = P.pa.BlockManager(8, 4)
        shared = mgr.allocate("donor", 8)
        for b in shared:
            mgr.ref(b)
        mgr.free_sequence("donor")
        mgr.adopt("reader", shared)
        before = {b: mgr.refcount(b) for b in shared}
        _, _, meta = mgr.export_blocks("reader", _pools(P, _arrays()))
        out += [before == {b: mgr.refcount(b) for b in shared},
                meta["num_blocks"]]
        src = P.pa.BlockManager(8, 4)
        src.allocate("big", 20)
        pages, _, meta = src.export_blocks("big", _pools(P, _arrays()))
        dst = P.pa.BlockManager(8, 4)
        dst.allocate("hog", 26)
        with pytest.raises(P.pa.BlockImportError, match="too full"):
            dst.import_blocks("big", pages, None, meta,
                              _pools(P, _arrays(seed=3)))
        out += [dst.free_blocks, dst.owned_blocks("big")]
        for bad_mgr, bad_meta, match in (
                (P.pa.BlockManager(4, 4), meta, "total"),
                (P.pa.BlockManager(8, 8), meta, "block_size"),
                (P.pa.BlockManager(8, 4), dict(meta, layers=5), "layers")):
            with pytest.raises(ValueError, match=match):
                bad_mgr.import_blocks("big", pages, None, bad_meta,
                                      _pools(P, _arrays()))
        mgr = P.pa.BlockManager(8, 4)
        mgr.allocate("q", 16)
        out.append(mgr.export_blocks("q", _pools(P, _arrays()),
                                     num_tokens=5)[2]["num_blocks"])
        return out

    assert _both(scen) == [True, 2, 1, [], 2]


def _payload(P, pages, scales, meta, req_id="r"):
    return P.dg.HandoffPayload(
        req_id=req_id, prompt=np.arange(7, dtype=np.int32), first_token=5,
        max_new_tokens=4, priority="batch", deadline_unix=1234567890.5,
        retries=1, pages=pages, scales=scales, meta=dict(meta),
        trace={"trace_id": "t1", "span_id": "s1"}, tenant="acme")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_payload_pack_bytes_match_and_cross_packages(dtype):
    """``pack()`` of the same blocks is the reference's bytes exactly (the
    deadline field pinned), and each package unpacks the other's payload
    to the same header and the same page and scale bytes."""
    quant = dtype == "int8"
    packed = {}
    for name, P in PKGS.items():
        mgr = P.pa.BlockManager(8, 4)
        mgr.allocate("x", 10)
        pages, scales, meta = mgr.export_blocks(
            "x", _pools(P, _arrays(quant=quant), dtype), num_tokens=10)
        meta["kv_len"] = 10
        packed[name] = _payload(P, pages, scales, meta).pack()
    assert packed["port"] == packed["reference"]
    for reader in PKGS.values():
        for data in packed.values():
            p = reader.dg.HandoffPayload.unpack(data)
            assert (p.req_id, p.first_token, p.tenant, p.retries,
                    p.deadline_unix, p.trace, p.meta["dtype"]) == \
                ("r", 5, "acme", 1, 1234567890.5,
                 {"trace_id": "t1", "span_id": "s1"}, dtype)
            assert p.pack() == data
    with pytest.raises(ValueError, match="truncated"):
        tdg.HandoffPayload.unpack(packed["port"][:3])
    with pytest.raises(ValueError, match="header promises"):
        tdg.HandoffPayload.unpack(packed["port"][:-1])


# -- the engine's roles ---------------------------------------------------------


def test_role_validation_and_fp8_still_refuses(pk):
    tm = pk["port"].model
    with pytest.raises(ValueError, match="role must be"):
        tserving.ContinuousBatchingEngine(
            tm, max_batch=1, max_len=16, block_size=8, num_blocks=4,
            role="both")
    # fp8 arrived and composes with every role (a fresh model each: the
    # engine converts its model's Linears in place)
    for role in ("prefill_only", "decode_only"):
        fm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        assert tserving.ContinuousBatchingEngine(
            fm, max_batch=1, max_len=16, block_size=8, num_blocks=4,
            fp8=True, role=role).fp8_layers == 14
    for role in ("prefill_only", "decode_only", "unified"):
        assert tserving.ContinuousBatchingEngine(
            tm, max_batch=1, max_len=16, block_size=8, num_blocks=4,
            role=role).role == role


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_prefill_only_parks_handoff_ready_never_decodes(pk, overlap):
    prompt = np.arange(5) + 7

    def scen(P):
        eng = _eng(P, max_batch=2, max_len=32, block_size=8, num_blocks=4,
                   prompt_pad=8, role="prefill_only",
                   **({"overlap": True} if overlap else {}))
        eng.add_request("r", prompt, max_new_tokens=4)
        eng.run()
        ready = eng.drain_prefilled()
        out = ([r.req_id for r in ready], [int(t) for t in ready[0].out],
               "decode" in eng._phases_run, eng.num_active,
               len(eng.manager.owned_blocks("r")), eng.warmed_up)
        eng.release_handoff("r")
        return out + (eng.manager.owned_blocks("r"), eng.n_handed_off,
                      eng.decode_steps if P.port else 0)

    ids, first, decoded, active, owned, warm, after, n, steps = _both(
        scen, pk)
    assert ids == ["r"] and first == _generate(pk["port"].model, prompt, 1)
    assert not decoded and active == 0 and owned == 1 and warm
    assert after == [] and n == 1 and steps == 0


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_engine_export_import_resumes_token_exact(pk, overlap):
    prompt = np.arange(6) + 3

    def scen(P):
        pf = _eng(P, max_batch=1, max_len=32, block_size=8, num_blocks=4,
                  prompt_pad=8, role="prefill_only")
        dx = _eng(P, max_batch=2, max_len=32, block_size=8, num_blocks=8,
                  prompt_pad=8, role="decode_only",
                  **({"overlap": True} if overlap else {}))
        # a colocated request already decoding beside the import
        dx.add_request("c", prompt[::-1].copy(), max_new_tokens=6)
        dx.step()
        pf.add_request("r", prompt, max_new_tokens=5)
        pf.run()
        (req,) = pf.drain_prefilled()
        pages, scales, meta = pf.export_kv("r", kv_len=prompt.size)
        pf.release_handoff("r")
        req2 = P.sv.GenRequest("r", prompt, 5)
        dx.import_kv(req2, req.out[0], pages, scales, meta)
        done = dx.run()
        return (meta["kv_len"], req2.status, [int(t) for t in req2.out],
                [int(t) for t in done["c"].out], dx.n_imported)

    kv_len, status, out, other, n = _both(scen, pk)
    tm = pk["port"].model
    assert kv_len == 6 and status == "ok" and n == 1
    assert out == _generate(tm, prompt, 5)
    assert other == _generate(tm, prompt[::-1].copy(), 6)


def test_prefill_only_export_equals_the_unified_engines_blocks(pk):
    """Chunked prefill pads its last chunk; a prefill-only engine reserves
    the prompt's blocks alone, so padded lanes past them go to the trash
    row (or rewrite the row's first cell as it was). The exported pages
    equal the unified engine's blocks for the same prompt, bytes and all,
    including the positions past the prompt inside its last block."""
    tm = pk["port"].model
    prompt = np.random.RandomState(3).randint(0, 250, (13,))
    kw = dict(max_batch=2, max_len=32, block_size=8, num_blocks=8,
              prefill_chunk=8)
    pf = tserving.ContinuousBatchingEngine(tm, role="prefill_only", **kw)
    pf.add_request("r", prompt, max_new_tokens=6)
    pf.run()
    pf.drain_prefilled()
    assert len(pf.manager.owned_blocks("r")) == 2  # 13 tokens, no growth
    pages, _, meta = pf.export_kv("r")
    uni = tserving.ContinuousBatchingEngine(tm, **kw)
    uni.add_request("r", prompt, max_new_tokens=6)
    uni._admit()
    while uni._slots[0].prefilling:
        uni._prefill_step(uni.max_num_batched_tokens)
    upages, _, _ = uni.manager.export_blocks("r", uni._pools, num_tokens=13)
    assert meta["num_blocks"] == 2
    np.testing.assert_array_equal(pages, upages)


def test_reference_export_imports_into_the_port(pk):
    """A payload the reference's prefill-only engine exported (through the
    wire format) resumes in the port's decode-only engine as the
    reference's unified stream."""
    jm, tm = pk["reference"].model, pk["port"].model
    rng = np.random.RandomState(21)
    prompts = {f"x{i}": rng.randint(0, 250, (9 + 4 * i,)) for i in range(3)}
    kw = dict(max_batch=2, max_len=48, block_size=8, num_blocks=16,
              prefill_chunk=8)
    uni = jserving.ContinuousBatchingEngine(jm, **kw)
    for rid, p in prompts.items():
        uni.add_request(rid, p, max_new_tokens=6)
    want = {rid: [int(t) for t in r.out] for rid, r in uni.run().items()}
    pf = jserving.ContinuousBatchingEngine(jm, role="prefill_only", **kw)
    for rid, p in prompts.items():
        pf.add_request(rid, p, max_new_tokens=6)
    pf.run()
    wire = []
    for req in pf.drain_prefilled():
        pages, scales, meta = pf.export_kv(req.req_id, kv_len=req.prompt.size)
        pf.release_handoff(req.req_id)
        wire.append(jdg.HandoffPayload.from_request(
            req, pages, scales, meta).pack())
    dx = tserving.ContinuousBatchingEngine(tm, role="decode_only",
                                           **dict(kw, max_batch=3))
    got = {}
    for data in wire:
        p = tdg.HandoffPayload.unpack(data)
        req = p.to_request()
        dx.import_kv(req, p.first_token, p.pages, p.scales, p.meta)
        got[req.req_id] = req
    dx.run()
    assert {rid: [int(t) for t in r.out] for rid, r in got.items()} == want


def test_import_without_slot_or_blocks_is_retryable(pk):
    prompt = np.arange(6)

    def scen(P):
        pf = _eng(P, max_batch=1, max_len=32, block_size=8, num_blocks=4,
                  prompt_pad=8, role="prefill_only")
        pf.add_request("r", prompt, max_new_tokens=4)
        pf.run()
        (req,) = pf.drain_prefilled()
        pages, scales, meta = pf.export_kv("r", kv_len=prompt.size)
        dx = _eng(P, max_batch=1, max_len=32, block_size=8, num_blocks=4,
                  prompt_pad=8)
        dx.manager.allocate("hog", 3 * 8)
        with pytest.raises(P.pa.BlockImportError):
            dx.import_kv(P.sv.GenRequest("r", prompt, 20), req.out[0],
                         pages, scales, meta)
        out = [dx.manager.owned_blocks("r")]
        dx2 = _eng(P, max_batch=1, max_len=32, block_size=8, num_blocks=1,
                   prompt_pad=8)
        with pytest.raises(ValueError):
            dx2.import_kv(P.sv.GenRequest("r", prompt, 20), req.out[0],
                          pages, scales, meta)
        dx3 = _eng(P, max_batch=1, max_len=32, block_size=8, num_blocks=8,
                   prompt_pad=8)
        dx3.add_request("busy", prompt, max_new_tokens=8)
        dx3.step()
        with pytest.raises(P.pa.BlockImportError, match="slot"):
            dx3.import_kv(P.sv.GenRequest("r", prompt, 4), req.out[0],
                          pages, scales, meta)
        with pytest.raises(ValueError, match="kv_len"):
            dx2.import_kv(P.sv.GenRequest("r", prompt[:3], 4), req.out[0],
                          pages, scales, meta)
        return out + [dx2.manager.owned_blocks("r"),
                      dx3.manager.owned_blocks("r")]

    assert _both(scen, pk) == [[], [], []]


def test_expired_handoff_ready_is_swept(pk):
    def scen(P):
        eng = _eng(P, max_batch=1, max_len=32, block_size=8, num_blocks=4,
                   prompt_pad=8, role="prefill_only")
        eng.add_request("r", np.arange(5), max_new_tokens=4,
                        deadline=P.Deadline(0.05))
        eng.step()
        parked = "r" in eng._handoff_ready
        time.sleep(0.06)
        eng.step()
        return (parked, "r" in eng._handoff_ready,
                eng._completed["r"].status, eng.manager.owned_blocks("r"),
                eng.manager.free_blocks, eng.n_expired)

    assert _both(scen, pk) == (True, False, "expired", [], 4, 1)


def test_handoff_ledger_accounts_holds(pk):
    """With the resource ledger on, a handoff hold is outstanding from the
    prefill's end to its release, and nothing is left after."""
    from paddle_tpu_torch.utils import resources

    led = resources.instrument_resources()
    try:
        eng = tserving.ContinuousBatchingEngine(
            pk["port"].model, max_batch=1, max_len=32, block_size=8,
            num_blocks=4, prompt_pad=8, role="prefill_only")
        eng.add_request("r", np.arange(5), max_new_tokens=4)
        eng.run()
        assert [e[:3] for e in led.outstanding("handoff.hold")] == \
            [("handoff.hold", "r", 1)]
        (req,) = eng.drain_prefilled()
        eng.export_kv("r")
        eng.release_handoff("r")
        led.verify(eng.manager)
        assert led.leak_check() == 0
    finally:
        resources.uninstrument_resources()


# -- the routers -----------------------------------------------------------------


def _factories(P, *, chunk=None, kv_dtype=None, spec_k=None, pf_blocks=8,
               dx_blocks=16, max_len=32, max_batch=2, overlap=False):
    def make(role, blocks, **extra):
        kw = dict(max_batch=max_batch, max_len=max_len, block_size=8,
                  num_blocks=blocks, kv_dtype=kv_dtype, role=role, **extra)
        if overlap:
            kw["overlap"] = True
        if chunk:
            kw["prefill_chunk"] = chunk
        else:
            kw["prompt_pad"] = 16
        return lambda: _eng(P, **kw)

    return (make("prefill_only", pf_blocks),
            make("decode_only", dx_blocks, spec_decode_k=spec_k))


def _router(P, n_pf=1, journal=None, **kw):
    pf_f, dx_f = _factories(P, **kw)
    store = P.st.MemKVStore()
    pfs = [P.dg.PrefillWorker(
        f"pf{i}", pf_f, store, ["dx0"],
        journal_dir=None if journal is None else f"{journal}/pf{i}")
        for i in range(n_pf)]
    dx = P.dg.DecodeWorker("dx0", dx_f, store)
    return P.dg.DisaggRouter(pfs, [dx]), pfs, dx, store


def _streams(res):
    return {k: (v["status"], v.get("out", [])) for k, v in res.items()}


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_handoff_round_trip_token_exact(pk, overlap):
    rng = np.random.RandomState(0)
    prompts = {f"q{i}": rng.randint(0, 250, (5 + i,)) for i in range(4)}

    def scen(P):
        router, (pf,), dx, _ = _router(P, overlap=overlap)
        pools = [router.submit(rid, p, max_new_tokens=4)[0]
                 for rid, p in prompts.items()]
        res = router.run(deadline=240)
        return (pools, _streams(res), router.n_fallback,
                router.n_handoff_failed, dx.supervisor.engine.n_imported,
                pf.supervisor.engine.n_handed_off,
                pf.senders[0].n_sent, dx.receiver.n_received)

    pools, res, *counts = _both(scen, pk)
    assert pools == ["prefill"] * 4 and counts == [0, 0, 4, 4, 4, 4]
    for rid, p in prompts.items():
        assert res[rid] == ("ok", _generate(pk["port"].model, p, 4))


def test_chunked_int8_spec_compose_across_handoff(pk):
    rng = np.random.RandomState(3)
    prompts = {f"c{i}": rng.randint(0, 250, (11 + 7 * i,)) for i in range(3)}

    def scen(P):
        router, _, dx, _ = _router(P, chunk=8, kv_dtype="int8", spec_k=2,
                                   max_len=64, dx_blocks=32, pf_blocks=16)
        for rid, p in prompts.items():
            router.submit(rid, p, max_new_tokens=5)
        res = router.run(deadline=240)
        ref = _eng(P, max_batch=2, max_len=64, block_size=8, num_blocks=32,
                   prefill_chunk=8, kv_dtype="int8")
        for rid, p in prompts.items():
            ref.add_request(rid, p, max_new_tokens=5)
        want = {rid: ("ok", [int(t) for t in r.out])
                for rid, r in ref.run().items()}
        return _streams(res), want, dx.supervisor.engine.n_imported

    res, want, n = _both(scen, pk)
    assert res == want and n == 3


@pytest.mark.parametrize("fault", ["corrupt", "drop_import"])
def test_transfer_faults_recover_token_exact(pk, fault):
    p = np.arange(5) + 3

    def scen(P):
        router, (pf,), dx, _ = _router(P, max_batch=1, pf_blocks=4,
                                       dx_blocks=8)
        sched = (P.chaos.ChaosSchedule().at("handoff.transfer", 1,
                                            "corrupt", 77)
                 if fault == "corrupt" else
                 P.chaos.ChaosSchedule().at("handoff.import", 1, "drop"))
        with P.chaos.active(sched) as mk:
            router.submit("x", p, max_new_tokens=4)
            res = router.run(deadline=240)
            events = list(mk.events)
        return (_streams(res), pf.senders[0].n_nacked, dx.receiver.n_nacked,
                router.n_handoff_failed, events)

    res, s_nacked, r_nacked, failed, events = _both(scen, pk)
    assert res["x"] == ("ok", _generate(pk["port"].model, p, 4))
    assert failed == 0 and len(events) == 1
    assert (s_nacked >= 1 and r_nacked >= 1) == (fault == "corrupt")


def _tiny(P, req_id):
    return P.dg.HandoffPayload(
        req_id=req_id, prompt=np.arange(4, dtype=np.int32), first_token=1,
        max_new_tokens=4, priority="interactive", deadline_unix=None,
        retries=0, pages=np.zeros((1, 2, 1, 1, 4, 2), np.float32),
        scales=None, meta={"num_blocks": 1, "block_size": 4, "layers": 1,
                           "dtype": "float32", "quantized": False,
                           "kv_len": 4})


def test_partial_and_orphaned_transfers_are_discarded():
    def scen(P):
        store = P.st.MemKVStore()
        sender = P.dg.KVHandoffSender(store, "dx0", n_parts=3)
        parts = sender._split(_tiny(P, "half").pack())
        store.put_bytes("disagg/dx0/xfer/pf-00000001/part/0000", parts[0])
        store.put_bytes("disagg/dx0/xfer/pf-00000001/part/0001", parts[1])
        receiver = P.dg.KVHandoffReceiver(store, "dx0", orphan_grace=0.05)
        out = [receiver.recv_handoff(), receiver.n_received,
               store.get("disagg/dx0/ack/pf-00000001"),
               len(store.keys("disagg/dx0/xfer/"))]
        time.sleep(0.06)
        out += [receiver.recv_handoff(), store.keys("disagg/dx0/xfer/"),
                receiver.n_orphans_gcd,
                store.get("disagg/dx0/ack/pf-00000001")]
        return out

    assert _both(scen) == [[], 0, None, 2, [], [], 1, None]


def test_relaunched_sender_does_not_read_stale_acks_and_records_are_gcd():
    def scen(P):
        store = P.st.MemKVStore()
        receiver = P.dg.KVHandoffReceiver(store, "dx0")
        s1 = P.dg.KVHandoffSender(store, "dx0", sender_id="pf0", n_parts=2)
        seq1 = s1.send_handoff(_tiny(P, "r1"))
        out = [[p.req_id for p in receiver.recv_handoff()], s1.poll_ack(seq1),
               store.keys("disagg/dx0/xfer/")]
        s2 = P.dg.KVHandoffSender(store, "dx0", sender_id="pf0")
        seq2 = s2.send_handoff(_tiny(P, "r2"))
        out += [seq2 != seq1, s2.poll_ack(seq2),
                [p.req_id for p in receiver.recv_handoff()],
                s2.poll_ack(seq2)]
        data = _tiny(P, "g2").pack()
        store.put_bytes("disagg/dx0/xfer/bad-0001/part/0000", data)
        store.set("disagg/dx0/xfer/bad-0001/commit", json.dumps(
            {"req_id": "g2", "parts": 1, "bytes": len(data), "crc": 12345}))
        out += [receiver.recv_handoff(), receiver.n_nacked,
                store.keys("disagg/dx0/xfer/"),
                str(store.get("disagg/dx0/ack/bad-0001")).split(":")[0]]
        # a resend of an imported request is acked and dropped
        s1.send_handoff(_tiny(P, "r1"))
        out += [receiver.recv_handoff(), receiver.n_duplicates]
        return out

    out = _both(scen)
    assert out[:2] == [["r1"], "ok"] and out[2] == []
    assert out[3:7] == [True, None, ["r2"], "ok"]
    assert out[7:] == [[], 1, [], "corrupt", [], 1]


def test_config_skew_import_falls_back_colocated(pk):
    p = np.arange(6) + 2

    def scen(P):
        pf_f, _ = _factories(P, pf_blocks=4)

        def dx_factory():
            return _eng(P, max_batch=2, max_len=32, block_size=4,
                        num_blocks=16, prompt_pad=16, role="decode_only")

        store = P.st.MemKVStore()
        pf = P.dg.PrefillWorker("pf0", pf_f, store, ["dx0"])
        dx = P.dg.DecodeWorker("dx0", dx_factory, store)
        router = P.dg.DisaggRouter([pf], [dx])
        router.submit("skew", p, max_new_tokens=4)
        res = router.run(deadline=240)
        return _streams(res), dx.supervisor.engine.n_imported, dx.alive()

    res, n, alive = _both(scen, pk)
    assert res["skew"] == ("ok", _generate(pk["port"].model, p, 4))
    assert n == 0 and alive


def test_kill_prefill_worker_requeues_onto_survivor(pk, tmp_path):
    rng = np.random.RandomState(5)
    prompts = {f"k{i}": rng.randint(0, 250, (5 + i,)) for i in range(4)}

    def scen(P):
        router, pfs, _, _ = _router(P, n_pf=2, max_batch=1, pf_blocks=4,
                                    dx_blocks=16,
                                    journal=str(tmp_path / str(P.port)))
        where = {rid: router.submit(rid, p, max_new_tokens=4)
                 for rid, p in prompts.items()}
        pfs[0].kill()
        res = router.run(deadline=240)
        return (where, sorted(router.dead_prefill), _streams(res),
                router.n_fallback, dict(router.retries),
                [e[:2] for e in router.events])

    where, dead, res, fallback, retries, events = _both(scen, pk)
    victims = [r for r, w in where.items() if w == ("prefill", 0)]
    assert victims and dead == [0] and fallback == 0
    assert all(retries[v] == 1 for v in victims)
    assert events == [("prefill-dead", "pf0")]
    for rid, p in prompts.items():
        assert res[rid] == ("ok", _generate(pk["port"].model, p, 4))


def test_prefill_pool_down_colocated_fallback_no_shed(pk):
    rng = np.random.RandomState(6)
    prompts = {f"f{i}": rng.randint(0, 250, (4 + i,)) for i in range(3)}

    def scen(P):
        router, (pf,), dx, _ = _router(P, max_batch=1, pf_blocks=4,
                                       dx_blocks=16)
        pf.kill()
        router.check_workers()
        pools = [router.submit(rid, p, max_new_tokens=4)[0]
                 for rid, p in prompts.items()]
        res = router.run(deadline=240)
        load = dx.load()
        return (pools, _streams(res), router.n_fallback,
                load["n_shed_interactive"] + load["n_shed_batch"])

    pools, res, fallback, shed = _both(scen, pk)
    assert pools == ["decode"] * 3 and fallback == 3 and shed == 0
    for rid, p in prompts.items():
        assert res[rid] == ("ok", _generate(pk["port"].model, p, 4))


class _FakeWorker:
    """A DisaggServer-shaped worker for the serve plumbing."""

    replica_id = "dx9"

    def __init__(self, completed=()):
        self.got = []
        self._completed = list(completed)
        sup = type("S", (), {})()
        sup.journaled_ids = {"r"}
        sup.journaled_retries = {"r": 0}
        self.supervisor = sup

    def submit(self, rec):
        self.got.append(rec)

    def poll_completed(self):
        return [self._completed.pop(0)] if self._completed else []

    def load(self):
        return None

    def pending(self):
        return False

    def active(self):
        return False

    def pump(self, deadline=None):
        pass


def test_server_pull_and_publish_match():
    """A requeue with bumped retries is accepted while a stale re-read is
    dropped; a marker and a later result are both delivered once."""
    def scen(P):
        from importlib import import_module
        cl = import_module(P.dg.__name__.replace("disagg", "cluster"))
        store = P.st.MemKVStore()
        w = _FakeWorker()
        srv = P.dg.DisaggServer(store, w, contract_rank=1)
        store.set("cluster/dx9/req/00000000",
                  json.dumps({"req_id": "r", "retries": 0}))
        store.set("cluster/dx9/req/00000001",
                  json.dumps({"req_id": "r", "retries": 1}))
        pulled = srv._pull(), [rec["retries"] for rec in w.got]
        store = P.st.MemKVStore()
        w = _FakeWorker(completed=[
            {"req_id": "r", "status": "transferred", "target": "dx0"},
            {"req_id": "r", "status": "ok", "out": [1, 2]}])
        srv = P.dg.DisaggServer(store, w, contract_rank=1)
        srv._publish()
        srv._publish()
        rep = cl.ProcessReplica(store, "dx9")
        got = sorted(r["status"] for r in rep.poll_completed())
        return pulled, got, rep.poll_completed()

    assert _both(scen) == ((1, [1]), ["ok", "transferred"], [])


def test_sender_cooldown_and_warmup_grace(pk):
    def scen(P):
        pf_f, _ = _factories(P)
        pf = P.dg.PrefillWorker("pf0", pf_f, P.st.MemKVStore(),
                                ["dx0", "dx1"])
        pf._down_until["dx1"] = time.monotonic() + 60
        picks = {pf._pick_sender().channel for _ in range(4)}
        pf._down_until["dx0"] = time.monotonic() + 60
        fallback_pick = pf._pick_sender().channel in ("dx0", "dx1")

        def factory():
            return _eng(P, max_batch=1, max_len=32, block_size=8,
                        num_blocks=8, prompt_pad=16, role="decode_only")

        sup = P.sup.ServingSupervisor(factory, step_budget=5.0,
                                      warmup_budget=120.0,
                                      warmup_max_steps=4)
        sup.engine.steps = 1000
        grace = sup.engine.warmed_up, sup._step_budget()
        sup._warmup_grants = sup.warmup_max_steps
        return picks, fallback_pick, grace, sup._step_budget()

    assert _both(scen, pk) == ({"dx0"}, True, (False, 120.0), 5.0)


def test_prefill_worker_needs_a_prefill_only_engine(pk):
    P = pk["port"]
    _, dx_f = _factories(P)
    with pytest.raises(ValueError, match="prefill_only"):
        tdg.PrefillWorker("pf0", dx_f, tstore.MemKVStore(), ["dx0"])


def test_handoff_legs_land_in_the_flight_recorder(pk):
    """Each handoff records ``handoff_send`` on the prefill side and
    ``handoff_recv`` on the decode side, as in the reference."""
    from paddle_tpu.distributed.communication import flight_recorder as jfr
    from paddle_tpu_torch.distributed.communication import \
        flight_recorder as tfr

    def scen(P):
        fr = tfr if P.port else jfr
        fr.reset()
        router, *_ = _router(P)
        router.submit("q", np.arange(5) + 1, max_new_tokens=3)
        router.run(deadline=240)
        ops = [(s.op, s.shape, s.dtype, s.group, s.detail)
               for s in fr.recorder().snapshot()]
        fr.reset()
        return ops

    ops = _both(scen, pk)
    assert [o[0] for o in ops] == ["handoff_send", "handoff_recv"]


@pytest.mark.slow
def test_kill_prefill_mid_handoff_zero_lost(tmp_path):
    """Two port worker processes over a TCPKVStore; a scheduled ``kill``
    ends the prefill worker partway through the parts of its second
    transfer. The decode side never imports the partial transfer, the
    router's recovery serves every request through the colocated fallback,
    token-exact, and the decode worker exits with nothing outstanding."""
    from paddle_tpu_torch.inference.cluster import ProcessReplica
    from paddle_tpu_torch.utils.retries import Deadline

    server = tstore.TCPStoreServer("127.0.0.1", 0)
    procs, logs = [], []
    try:
        reps = []
        for rid, role, spec in (("pf0", "prefill", "handoff.transfer@7=kill"),
                                ("dx0", "decode", None)):
            env = dict(os.environ)
            env.pop("PADDLE_CHAOS", None)
            env.update({
                "DISAGG_DEVICE": "cpu",
                "DISAGG_ROLE": role,
                "DISAGG_STORE_PORT": str(server.port),
                "DISAGG_WORKER_ID": rid,
                "DISAGG_JOURNAL_DIR": str(tmp_path / rid),
                "DISAGG_DECODE_IDS": "dx0",
                "DISAGG_BUDGET": "240",
                "DISAGG_N_PARTS": "4",
                "PADDLE_LEAK_SANITIZER": "1",
                "PYTHONPATH": REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""),
            })
            if spec:
                env["PADDLE_CHAOS"] = spec
            log = open(tmp_path / f"{rid}.log", "w")
            logs.append(log)
            p = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.testing.disagg_worker"],
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
            procs.append(p)
            reps.append(ProcessReplica(
                tstore.TCPKVStore("127.0.0.1", server.port), rid,
                journal_dir=str(tmp_path / rid), proc=p))
        router = tdg.DisaggRouter([reps[0]], [reps[1]])
        store = tstore.TCPKVStore("127.0.0.1", server.port)
        dl = Deadline(180)
        while not dl.expired() and not all(
                store.get(f"cluster/{r}/hb") for r in ("pf0", "dx0")):
            time.sleep(0.25)
        rng = np.random.RandomState(9)
        prompts = {f"q{i}": rng.randint(0, 250, (16,)) for i in range(5)}
        for rid, p in prompts.items():
            router.submit(rid, p, max_new_tokens=4)
        res = router.run(deadline=240)
        assert router.dead_prefill == {0}, "the kill never fired"
        pt_seed(0)
        model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        for rid, p in prompts.items():
            assert rid in res, f"request {rid} was lost"
            assert (res[rid]["status"], res[rid]["out"]) == \
                ("ok", _generate(model, p, 4)), rid
        xfer = store.keys("disagg/dx0/xfer/")
        parts = {k.split("/xfer/")[1].split("/part/")[0]
                 for k in xfer if "/part/" in k}
        commits = {k.split("/xfer/")[1].rsplit("/", 1)[0]
                   for k in xfer if k.endswith("/commit")}
        partial = parts - commits
        assert partial, xfer
        assert all(store.get(f"disagg/dx0/ack/{s}") is None for s in partial)
        assert router.n_fallback > 0
        assert [e[:2] for e in router.events] == [("prefill-dead", "pf0")]
        pf_counts = json.loads(store.get("cluster/pf0/launches"))
        assert pf_counts["decode_steps"] == 0
        router.stop(deadline=20.0)
        procs[1].wait(timeout=60)
        text = (tmp_path / "dx0.log").read_text()
        assert procs[1].returncode == 0, text[-2000:]
        assert "leak-sanitizer: clean" in text
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
        for log in logs:
            log.close()
        server.stop()
