"""Port parity: ``paddle_tpu_torch.amp.fp8`` and the engine's ``fp8=`` against
``paddle_tpu.amp.fp8`` and the JAX engine (every case of
``tests/test_fp8.py``, on both packages).

- The e4m3 and e5m2 images (``clamp(t.float() * scale, -max, max)`` cast
  to fp8) and the just-in-time scales are bitwise the reference's.
- ``fp8_linear`` in f32: the forward and both gradients within 1e-6 of the
  norm. Products of fp8 images are exact in f32; only the order of the f32
  sums differs. The upstream gradient is a fixed tensor, so both packages
  cast the same dy to e5m2.
- ``Fp8Linear``: the amax histories roll bitwise as the reference's, the
  scale comes from the history before recording, eval never rolls.
- ``convert_to_fp8``: the same count and names, the lm_head excluded.
- The 25-step convergence run: the fp8 losses within 1e-4 of the
  reference's fp8 run, and the reference's own gates; a ``to_static`` step
  threading the amax state (eager on the CPU).
- ``ContinuousBatchingEngine(fp8=True)`` on ``LlamaConfig.tiny()`` in f32:
  greedy streams equal to the reference engine's token for token, in every
  mode the engine has.
- ``load_jax_buffers`` carries the histories by name.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.amp import fp8 as jfp8
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp import fp8 as tfp8
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.utils import load_jax_buffers, load_jax_params

FMT = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn, tfp8.E4M3_MAX),
       "e5m2": (jnp.float8_e5m2, torch.float8_e5m2, tfp8.E5M2_MAX)}

# fp8_linear against the reference, f32: the same exact products summed in
# another order
FP8_REL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np(t):
    return (np.array(t._data) if hasattr(t, "_data")
            else t.detach().numpy())


@pytest.mark.parametrize("fmt", list(FMT))
def test_fp8_images_bitwise(fmt):
    jdt, tdt, fmax = FMT[fmt]
    rng = np.random.RandomState(0)
    # every magnitude the format holds, its clamp and its subnormals
    x = (rng.randn(65536) * np.exp2(rng.randint(-24, 20, 65536))).astype(
        np.float32)
    x[:4] = [0.0, -0.0, 1e30, -1e30]
    for s in (1.0, 0.37, 1234.5):
        want = np.asarray(jfp8._cast_fp8(jnp.asarray(x), jnp.float32(s), jdt,
                                         fmax)).view(np.uint8)
        got = tfp8._cast_fp8(torch.from_numpy(x), torch.tensor(s), tdt,
                             fmax).view(torch.uint8).numpy()
        np.testing.assert_array_equal(got, want)
    for t in (x, np.zeros(8, np.float32), x[4:100] * 1e-3):
        want = np.asarray(jfp8._jit_scale(jnp.asarray(t), fmax))
        got = tfp8._jit_scale(torch.from_numpy(t), fmax).numpy()
        np.testing.assert_array_equal(got, want)


# (input shape, out features): 3-d and 2-d inputs, the reference tests'
# Linear(32, 4) and Linear(16, 8), an odd depth and width, one token
SHAPES = {"3d": ((4, 6, 32), 80), "2d": ((13, 48), 80),
          "lin32x4": ((8, 32), 4), "lin16x8": ((4, 16), 8),
          "odd": ((5, 30), 40), "one_token": ((1, 64), 24)}


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fp8_linear_forward_and_grads_match(shape, bias):
    xshape, n = SHAPES[shape]
    rng = np.random.RandomState(1)
    k = xshape[-1]
    x = rng.randn(*xshape).astype(np.float32)
    w = (rng.randn(k, n) * 0.1).astype(np.float32)
    b = rng.randn(n).astype(np.float32) if bias else None
    c = rng.randn(*xshape[:-1], n).astype(np.float32)  # the upstream grad

    jx, jw = paddle.to_tensor(x), paddle.to_tensor(w)
    jx.stop_gradient = jw.stop_gradient = False
    jb = None
    if bias:
        jb = paddle.to_tensor(b)
        jb.stop_gradient = False
    jy = jfp8.fp8_linear(jx, jw, jb)
    (jy * paddle.to_tensor(c)).sum().backward()

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_() if bias else None
    ty = tfp8.fp8_linear(tx, tw, tb)
    (ty * torch.from_numpy(c)).sum().backward()

    assert ty.shape == tuple(jy.shape) and ty.dtype == torch.float32
    assert _rel(_np(ty), _np(jy)) < FP8_REL
    assert _rel(_np(tx.grad), _np(jx.grad)) < FP8_REL
    assert _rel(_np(tw.grad), _np(jw.grad)) < FP8_REL
    if bias:
        assert _rel(_np(tb.grad), _np(jb.grad)) < FP8_REL


def test_forward_quality_and_gradient_tracking_gates():
    """The reference's quality gates (``tests/test_fp8.py``) on the port:
    rel err < 0.06 against the float linear, gradients within 0.12."""
    rng = np.random.RandomState(1)
    lin = Linear(256, 256, device="cpu", dtype=torch.float32,
                 generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.randn(64, 256).astype(np.float32))
    with torch.no_grad():
        assert _rel(_np(tfp8.fp8_linear(x, lin.weight, lin.bias)),
                    _np(lin(x))) < 0.06
    lin = Linear(64, 32, device="cpu", dtype=torch.float32,
                 generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.randn(16, 64).astype(np.float32))

    def grads(fp8):
        lin.zero_grad()
        y = tfp8.fp8_linear(x, lin.weight, lin.bias) if fp8 else lin(x)
        (y ** 2).mean().backward()
        return [p.grad.clone().numpy() for p in lin.parameters()]

    for a, b in zip(grads(True), grads(False)):
        assert np.isfinite(a).all() and _rel(a, b) < 0.12


def test_scaled_mm_against_plain_product_and_padding():
    rng = np.random.RandomState(2)
    for (m, k, n) in ((13, 32, 48), (5, 30, 40), (16, 64, 4)):
        qa = torch.from_numpy(rng.randn(m, k).astype(np.float32) * 8).to(
            torch.float8_e5m2)
        qb = torch.from_numpy(rng.randn(k, n).astype(np.float32) * 8).to(
            torch.float8_e4m3fn)
        got = tfp8._mm(qa, qb)
        assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
        assert _rel(got.numpy(), tfp8._mm_plain(qa, qb).numpy()) < 1e-6
        # zero padding of depth and width changes nothing, bitwise
        pa = tfp8._pad_to(qa, m, 64)
        pb = tfp8._pad_to(qb, 64, 48)
        assert not pa[:, k:].float().any() and not pb[k:].float().any()
        np.testing.assert_array_equal(tfp8._mm(pa, pb)[:, :n].numpy(),
                                      got.numpy())
    assert tfp8._pad_to(pa, *pa.shape) is pa


def _linear_pair(k, n, seed=0):
    paddle.seed(seed)
    jl = jnn.Linear(k, n)
    tl = Linear(k, n, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(_np(jl.weight)))
        tl.bias.copy_(torch.from_numpy(_np(jl.bias)))
    return jl, tl


def test_history_roll_and_scale_bitwise():
    jl, tl = _linear_pair(16, 8)
    jf, tf = jfp8.Fp8Linear(jl, history_len=4), tfp8.Fp8Linear(tl, 4)
    assert tf.weight is tl.weight and tf.bias is tl.bias
    addr = tf.amax_history_x.data_ptr(), tf.amax_history_w.data_ptr()
    rng = np.random.RandomState(3)
    xs = [rng.randn(4, 16).astype(np.float32) * s for s in (1, 3, 0.5)]
    jf.train()
    tf.train()
    for i, x in enumerate(xs):
        jy, ty = jf(paddle.to_tensor(x)), tf(torch.from_numpy(x))
        assert _rel(_np(ty), _np(jy)) < FP8_REL
        for name in ("amax_history_x", "amax_history_w"):
            np.testing.assert_array_equal(_np(getattr(tf, name)),
                                          _np(getattr(jf, name)))
        hx = _np(tf.amax_history_x)
        assert hx[-1] > 0 and (hx[:-1 - i] == 0).all()
    # rolled in place: the buffers kept their storage
    assert (tf.amax_history_x.data_ptr(),
            tf.amax_history_w.data_ptr()) == addr
    hx = _np(tf.amax_history_x).copy()
    jf.eval()
    tf.eval()
    jy, ty = jf(paddle.to_tensor(xs[0])), tf(torch.from_numpy(xs[0]))
    assert _rel(_np(ty), _np(jy)) < FP8_REL
    np.testing.assert_array_equal(_np(tf.amax_history_x), hx)
    # the scale from a history, and from an empty one (the current amax)
    for h in (np.zeros(4, np.float32), np.array([0, 2.5, 0.7, 0], np.float32)):
        for cur in (0.0, 3.0):
            want = _np(jf._scale_from(paddle.to_tensor(h),
                                      paddle.to_tensor(np.float32(cur))))
            got = tfp8.Fp8Linear._scale_from(torch.from_numpy(h),
                                             torch.tensor(cur))
            np.testing.assert_array_equal(got.numpy(), want)


def test_convert_counts_and_exclusions():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    excl = lambda name: "lm_head" in name  # noqa: E731
    nj = jfp8.convert_to_fp8(jm, exclude=excl)
    nt = tfp8.convert_to_fp8(tm, exclude=excl)
    assert nt == nj == 2 * 7
    names_j = sorted(n for n, m in jm.named_sublayers()
                     if isinstance(m, jfp8.Fp8Linear))
    names_t = sorted(n for n, m in tm.named_modules()
                     if isinstance(m, tfp8.Fp8Linear))
    assert names_t == names_j
    assert isinstance(tm.lm_head, Linear)
    # a second conversion finds nothing left to convert
    assert tfp8.convert_to_fp8(tm, exclude=excl) == 0
    assert tfp8.convert_to_fp8(tm) == 1  # the lm_head, now unexcluded


def test_load_jax_buffers_carries_histories_by_name():
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 4))
    tm = torch.nn.Sequential(
        Linear(16, 32, device="cpu", dtype=torch.float32), torch.nn.ReLU(),
        Linear(32, 4, device="cpu", dtype=torch.float32))
    jfp8.convert_to_fp8(jm)
    tfp8.convert_to_fp8(tm)
    jm.train()
    jm(paddle.to_tensor(np.random.RandomState(0).randn(3, 16)
                        .astype(np.float32)))
    bufs = {n: _np(b) for n, b in jm.named_buffers()}
    assert sorted(bufs) == sorted(n for n, _ in tm.named_buffers())
    ptrs = [b.data_ptr() for _, b in tm.named_buffers()]
    load_jax_buffers(tm, bufs)
    for n, b in tm.named_buffers():
        np.testing.assert_array_equal(b.numpy(), bufs[n])
    assert [b.data_ptr() for _, b in tm.named_buffers()] == ptrs
    with pytest.raises(KeyError, match="buffer names differ"):
        load_jax_buffers(tm, {k: v for k, v in bufs.items()
                              if "0." not in k})
    with pytest.raises(ValueError, match="shape"):
        load_jax_buffers(tm, {k: v[:2] for k, v in bufs.items()})


def _sequential_pair(seed=7):
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 4))
    tm = torch.nn.Sequential(
        Linear(16, 32, device="cpu", dtype=torch.float32), torch.nn.ReLU(),
        Linear(32, 4, device="cpu", dtype=torch.float32))
    load_jax_params(tm, {n: _np(p) for n, p in jm.named_parameters()})
    return jm, tm


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(32, 16).astype(np.float32),
            rng.randint(0, 4, (32,)).astype(np.int64))


def _run_jax(fp8, steps=25):
    jm, _ = _sequential_pair()
    if fp8:
        assert jfp8.convert_to_fp8(jm) == 2
    opt = jopt.AdamW(learning_rate=1e-2, parameters=jm.parameters())
    x, y = (paddle.to_tensor(a) for a in _data())
    losses = []
    for _ in range(steps):
        loss = JF.cross_entropy(jm(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(_np(loss)))
    return losses


def _run_port(fp8, steps=25, static=False):
    _, tm = _sequential_pair()
    if fp8:
        assert tfp8.convert_to_fp8(tm) == 2
    opt = topt.AdamW(learning_rate=1e-2, parameters=tm.parameters())
    x, y = (torch.from_numpy(a) for a in _data())

    def body(xb, yb):
        loss = TF.cross_entropy(tm(xb), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    step = (tjit.to_static(body, layers=[tm], optimizers=[opt]) if static
            else body)
    return [float(step(x, y).detach()) for _ in range(steps)], tm


def test_convergence_run_matches_reference_fp8_run():
    ref, fp8 = _run_jax(False), _run_jax(True)
    got, _ = _run_port(True)
    # the reference's convergence gates, on both packages
    for run in (fp8, got):
        assert run[-1] < ref[0] * 0.5          # it actually learns
        assert run[-1] < ref[-1] + 0.25        # and lands near the ref
    # the port's fp8 run is the reference's fp8 run
    np.testing.assert_allclose(got, fp8, rtol=0, atol=1e-4)


def test_to_static_step_threads_amax_state():
    steps = 8
    losses, tm = _run_port(True, steps=steps, static=True)
    assert losses[-1] < losses[0]
    n = 0
    for name, buf in tm.named_buffers():
        if "amax_history" in name:
            h = buf.numpy()
            assert h[-1] > 0, f"{name} never recorded an amax"
            # one entry a step, rolled in place
            assert int((h > 0).sum()) == min(steps, len(h)), name
            n += 1
    assert n == 4
    # the captured-step losses are the eager step's
    np.testing.assert_allclose(losses, _run_port(True, steps=steps)[0],
                               rtol=0, atol=1e-6)


# -- the engine's fp8= --------------------------------------------------------


def _fresh_pair():
    """A fresh tiny model pair with carried weights: the engine converts
    its model's Linears in place."""
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: _np(p) for n, p in jm.named_parameters()})
    return jm, tm


def _prompts(seed, lengths, prefix=0):
    rng = np.random.RandomState(seed)
    pre = rng.randint(0, 250, (prefix,))
    return {i: np.concatenate([pre, rng.randint(0, 250, (n,))])
            for i, n in enumerate(lengths)}


WHOLE = dict(max_batch=2, max_len=64, block_size=8, num_blocks=24,
             prompt_pad=32)
CHUNKED = dict(max_batch=2, max_len=64, block_size=8, num_blocks=24,
               prefill_chunk=8, max_num_batched_tokens=10)
ENGINE_CASES = {
    "whole_prompt": (_prompts(0, (5, 9, 3)), WHOLE),
    "chunked": (_prompts(1, (3, 13, 7, 5)), CHUNKED),
    "decode_chunk": (_prompts(2, (3, 4, 5)), dict(WHOLE, decode_chunk=4)),
    "int8_kv": (_prompts(3, (6, 11, 4)), dict(WHOLE, kv_dtype="int8")),
    "prefix_cache": (_prompts(4, (5, 3, 0, 7), prefix=16),
                     dict(WHOLE, prefix_cache=True)),
    "prefix_int8_chunked": (_prompts(5, (5, 3, 0, 7), prefix=16),
                            dict(CHUNKED, prefix_cache=True,
                                 kv_dtype="int8")),
    "spec_k2": (_prompts(6, (6, 8, 5)), dict(WHOLE, spec_decode_k=2)),
    "overlap": (_prompts(7, (5, 9, 3)), dict(WHOLE, overlap=True)),
    "overlap_chunked": (_prompts(8, (3, 13, 7)),
                        dict(CHUNKED, overlap=True, decode_chunk=2)),
}

# both packages cast the same f32 activations to the same e4m3 images and
# sum exact products in f32, so the logits agree to ~1e-6; a stream could
# depart only where the reference's top-2 logit gap is below this bound
FP8_GAP_BOUND = 1e-3


def _first_departure_gap(jm, prompt, got, want):
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    ids = np.concatenate([prompt, want[:i]])[None]
    logits = np.sort(_np(jm(paddle.to_tensor(ids)))[0, -1])
    return logits[-1] - logits[-2]


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_fp8_streams_match_reference(case):
    prompts, kw = ENGINE_CASES[case]
    jm, tm = _fresh_pair()
    je = jserving.ContinuousBatchingEngine(jm, fp8=True, **kw)
    te = tserving.ContinuousBatchingEngine(tm, fp8=True, **kw)
    assert te.fp8_layers == je.fp8_layers == 14
    assert isinstance(tm.lm_head, Linear)
    assert all(not m.training for m in tm.modules())
    for eng in (je, te):
        for rid, p in prompts.items():
            eng.add_request(rid, p, max_new_tokens=7)
    want = {r: list(map(int, q.out)) for r, q in je.run().items()}
    got = {r: list(map(int, q.out)) for r, q in te.run().items()}
    for rid, p in prompts.items():
        if got[rid] != want[rid]:
            gap = _first_departure_gap(jm, p, got[rid], want[rid])
            assert gap < FP8_GAP_BOUND, (rid, gap)
    assert got == want
    if kw.get("prefix_cache"):
        assert te.prefix_stats() == je.prefix_stats()
    else:
        assert te.manager.free_blocks == kw["num_blocks"]
    # eval mode: the histories never recorded
    assert all(not b.any() for n, b in tm.named_buffers() if "amax" in n)


def test_engine_fp8_rows_depend_on_their_batch_like_reference():
    """In eval mode an fp8 linear scales just in time from the amax of the
    whole batch, so one row's output moves with its neighbours, in both
    packages alike. On these prompts that makes the reference's chunked
    fp8 engine give other streams with ``overlap=True`` than without (its
    batches differ), while the same engines without fp8 agree; the port
    equals the reference in each mode."""
    rng = np.random.RandomState(11)
    x = rng.randn(4, 32).astype(np.float32)
    w = (rng.randn(32, 16) * 0.1).astype(np.float32)
    wide = x.copy()
    wide[1:] *= 8.0  # row 0 unchanged, the batch's amax 8x larger
    rows = []
    for a in (x, wide):
        jy = _np(jfp8.fp8_linear(paddle.to_tensor(a), paddle.to_tensor(w)))
        ty = tfp8.fp8_linear(torch.from_numpy(a), torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(ty, jy, rtol=FP8_REL, atol=1e-7)
        rows.append(ty[0])
    assert not np.array_equal(rows[0], rows[1])

    prompts = _prompts(100, (3, 13, 7, 5))
    streams = {}
    for fp8 in (True, False):
        for overlap in (False, True):
            kw = dict(CHUNKED, overlap=overlap, fp8=fp8)
            for name, sv in (("ref", jserving), ("port", tserving)):
                jm, tm = _fresh_pair()
                eng = sv.ContinuousBatchingEngine(
                    jm if name == "ref" else tm, **kw)
                for rid, p in prompts.items():
                    eng.add_request(rid, p, max_new_tokens=7)
                streams[name, fp8, overlap] = {
                    r: list(map(int, q.out)) for r, q in eng.run().items()}
    for key in [k for k in streams if k[0] == "ref"]:
        assert streams[("port",) + key[1:]] == streams[key], key
    assert streams["ref", True, False] != streams["ref", True, True]
    assert streams["ref", False, False] == streams["ref", False, True]


def test_engine_fp8_prefill_only_to_decode_only_handoff():
    prompt = np.arange(6) + 3

    def scen(sv, model):
        pf = sv.ContinuousBatchingEngine(
            model, max_batch=1, max_len=32, block_size=8, num_blocks=4,
            prompt_pad=8, role="prefill_only", fp8=True)
        dx = sv.ContinuousBatchingEngine(
            model, max_batch=2, max_len=32, block_size=8, num_blocks=8,
            prompt_pad=8, role="decode_only", fp8=True)
        dx.add_request("c", prompt[::-1].copy(), max_new_tokens=6)
        dx.step()
        pf.add_request("r", prompt, max_new_tokens=5)
        pf.run()
        (req,) = pf.drain_prefilled()
        pages, scales, meta = pf.export_kv("r", kv_len=prompt.size)
        pf.release_handoff("r")
        req2 = sv.GenRequest("r", prompt, 5)
        dx.import_kv(req2, req.out[0], pages, scales, meta)
        done = dx.run()
        # the first engine converted the shared model, the second found
        # nothing left to convert
        return (pf.fp8_layers, dx.fp8_layers, req2.status,
                [int(t) for t in req2.out], [int(t) for t in done["c"].out])

    jm, tm = _fresh_pair()
    want = scen(jserving, jm)
    got = scen(tserving, tm)
    assert got == want
    assert got[:3] == (14, 0, "ok") and len(got[3]) == 5
