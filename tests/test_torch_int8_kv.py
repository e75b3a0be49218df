"""Port parity: int8 KV storage of ``paddle_tpu_torch.ops.paged_attention``
against the JAX package on the CPU.

The quantizer, the stored pools and the dequantized views must agree
bitwise (the same f32 operations in the same order); decode attention
over int8 pools is float math in two frameworks, held at 1e-5 in f32;
greedy tokens through int8 caches agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import generate as jgenerate
from paddle_tpu.ops import paged_attention as JPA
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, generate
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops import paged_attention as TPA
from paddle_tpu_torch.utils import load_jax_params

ATOL = 1e-5  # f32 attention, reductions in different orders


def _quant_inputs():
    """[B, s, kvh, D] rows covering the quantizer's edges: a zero row (the
    1e-8 amax floor), rows holding +-amax (the +-127 clip), rows whose
    scaled values fall on exact .5 ties (half-to-even rounding), and
    random rows of mixed scale."""
    rng = np.random.RandomState(0)
    d = 16
    rows = [np.zeros(d), np.full(d, -3.0), np.linspace(-2.0, 2.0, d)]
    # amax 127.5 makes x * (127.5 / amax) == x: ties at k + 0.5
    rows.append(np.r_[127.5, np.arange(d - 1) - 7.5])
    rows.append(np.r_[-127.5, np.arange(d - 1) * 2.5 - 0.5])
    rows += list(rng.randn(27, d) * rng.choice([1e-6, 1e-2, 1.0, 300.0],
                                               (27, 1)))
    return np.asarray(rows, np.float32).reshape(2, 4, 4, d)


def test_quantize_and_dequantize_bitwise():
    x = _quant_inputs()
    jq, jh = JPA._kv_quantize(jnp.asarray(x))
    tq, th = TPA._kv_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and th.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    # the edges were reached: the floor, the clip and half-to-even ties
    rows_q, rows_h = tq.numpy().reshape(-1, 16), th.numpy().reshape(-1)
    assert rows_h[0] == np.float32(1e-8) and not rows_q[0].any()
    assert (rows_q[1] == -127).all()  # -127.5 rounds to -128, clipped
    assert rows_q[3].tolist() == [127, -8, -6, -6, -4, -4, -2, -2, 0, 0, 2,
                                  2, 4, 4, 6, 6]
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = JPA._kv_dequantize(jq, jh, jdt).astype(jnp.float32)
        got = TPA._kv_dequantize(tq, th, dt).float()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_alloc_int8_pools_and_validation():
    caches = TPA.alloc_paged_kv_caches(2, 2, 16, 2, 8, "float32",
                                       block_size=4, kv_dtype="int8",
                                       device="cpu")
    c = caches[0]
    assert c.quantized and c.k_pool.dtype == torch.int8
    assert tuple(c.k_scale.shape) == (2, 8, 4) and c.v_scale.dtype == torch.float32
    assert not TPA.alloc_paged_kv_caches(1, 1, 8, 1, 8, "float32", block_size=4,
                                         device="cpu")[0].quantized
    with pytest.raises(ValueError, match="kv_dtype"):
        TPA.alloc_paged_kv_caches(1, 1, 16, 2, 4, "float32", block_size=8,
                                  kv_dtype="fp8", device="cpu")


@pytest.mark.parametrize("contiguous", [False, True])
def test_prefill_update_dequantized_views_match_reference(contiguous):
    rng = np.random.RandomState(2)
    b, kvh, bs, d, per_seq, s = 2, 2, 4, 8, 4, 6
    nb = b * per_seq
    tables = (JPA.contiguous_tables(b, per_seq * bs, bs) if contiguous
              else rng.permutation(nb).reshape(b, per_seq).astype(np.int32))
    kk = rng.randn(b, s, kvh, d).astype(np.float32)
    vv = rng.randn(b, s, kvh, d).astype(np.float32)
    cl = np.array([0, 3], np.int32)
    zeros = [np.zeros((kvh, nb, bs, d), np.int8) for _ in range(2)]
    zeros += [np.zeros((kvh, nb, bs), np.float32) for _ in range(2)]
    jout = JPA.paged_update_kv_cache(
        jnp.asarray(kk), jnp.asarray(vv), *map(jnp.asarray, zeros[:2]),
        jnp.asarray(tables), jnp.asarray(cl), s, contiguous=contiguous,
        k_scale=jnp.asarray(zeros[2]), v_scale=jnp.asarray(zeros[3]))
    tp = [torch.from_numpy(z) for z in zeros]
    tout = TPA.paged_update_kv_cache(
        torch.from_numpy(kk), torch.from_numpy(vv), tp[0], tp[1],
        torch.from_numpy(tables), torch.from_numpy(cl), s,
        contiguous=contiguous, k_scale=tp[2], v_scale=tp[3])
    assert len(tout) == len(jout) == 7
    for got, want in zip(tout, jout):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("contiguous", [False, True])
@pytest.mark.parametrize("heads", [(4, 2), (8, 2), (4, 4)],
                         ids=["gqa2", "gqa4", "mha"])
def test_int8_decode_plain_matches_reference(contiguous, heads):
    rng = np.random.RandomState(1)
    h, kvh = heads
    b, bs, d, per_seq = 3, 4, 16, 5
    nb = b * per_seq if contiguous else b * per_seq + 2
    tables = (JPA.contiguous_tables(b, per_seq * bs, bs) if contiguous
              else rng.permutation(nb)[: b * per_seq].reshape(b, per_seq)
              .astype(np.int32))
    kp, vp = (rng.randint(-127, 128, (kvh, nb, bs, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.1, 3, (kvh, nb, bs)).astype(np.float32)
              for _ in range(2))
    q = rng.randn(b, 1, h, d).astype(np.float32)
    cl = np.array([0, 9, per_seq * bs - 1], np.int32)
    want = JPA.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, tables, cl)), contiguous=contiguous,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    before = kernels.launch_counts()
    got = TPA.paged_decode_attention(
        *map(torch.from_numpy, (q, kp, vp, tables, cl)),
        contiguous=contiguous, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    plain = TPA.paged_decode_int8_plain(
        *map(torch.from_numpy, (q, kp, vp, ks, vs, tables, cl)))
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # CPU tensors take the plain version: no kernel launch is counted
    assert kernels.launch_counts() == before


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return jm, tm


@pytest.mark.parametrize("block_size", [8, 4])
def test_generate_int8_matches_reference(models, block_size):
    jm, tm = models
    ids = np.random.RandomState(5).randint(0, 250, (2, 9))
    want = jgenerate(jm, paddle.to_tensor(ids.astype(np.int64)),
                     max_new_tokens=7, block_size=block_size, kv_dtype="int8")
    got = generate(tm, torch.from_numpy(ids.astype(np.int64)),
                   max_new_tokens=7, block_size=block_size, kv_dtype="int8")
    assert got.tolist() == np.asarray(want.numpy()).tolist()
    with pytest.raises(ValueError, match="block_size"):
        generate(tm, torch.from_numpy(ids.astype(np.int64)),
                 max_new_tokens=2, kv_dtype="int8")


def test_prefill_logits_match_reference_and_stay_near_float(models):
    """Prefill through int8 pools: logits equal the reference's to f32
    rounding, and their relative error against float pools stays under
    the reference's own quality gate (0.05, tests/test_spec_decode.py)."""
    from paddle_tpu import to_tensor
    from paddle_tpu.base.tape import no_grad

    jm, tm = models
    ids = np.random.RandomState(6).randint(0, 250, (2, 12))
    with no_grad():
        jl, _ = jm.forward_with_cache(
            paddle.to_tensor(ids.astype(np.int64)),
            jm.init_cache(2, 24, block_size=8, kv_dtype="int8"),
            to_tensor(np.asarray(0, np.int32)))
    with torch.no_grad():
        t_ids = torch.from_numpy(ids)
        tl, _ = tm.forward_with_cache(
            t_ids, tm.init_cache(2, 24, block_size=8, kv_dtype="int8"), 0)
        tf, _ = tm.forward_with_cache(t_ids, tm.init_cache(2, 24, block_size=8), 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._data), atol=1e-5,
                               rtol=0)
    a, b = tf[:, -1].numpy(), tl[:, -1].numpy()
    assert float(np.abs(a - b).mean() / np.abs(a).mean()) < 0.05


def test_copy_block_moves_scale_rows(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, max_batch=1, max_len=32, block_size=8,
                                   num_blocks=4, kv_dtype="int8",
                                   prefix_cache=True)
    k, v, ks, vs = eng._pools[0]
    k[:, 1], v[:, 1], ks[:, 1], vs[:, 1] = 7, 9, 0.5, 0.25
    before = [p.clone() for p in eng._pools[1]]
    eng._copy_block(1, 2)
    k2, v2, ks2, vs2 = eng._pools[0]
    assert (k2[:, 2] == 7).all() and (v2[:, 2] == 9).all()
    assert (ks2[:, 2] == 0.5).all() and (vs2[:, 2] == 0.25).all()
    assert (k2[:, 1] == 7).all()  # the source block is untouched
    for p, b in zip(eng._pools[1], before):  # and so are the other blocks
        assert torch.equal(p[:, :2], b[:, :2]) and torch.equal(p[:, 3:], b[:, 3:])
