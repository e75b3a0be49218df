"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA card (``nvcc`` builds the kernels at first use) and
skip without one; run them there with ``python -m pytest --noconftest
-p no:cacheprovider tests/test_torch_kernels.py`` (``tests/conftest.py``
imports JAX, which the card's machine need not have). Whether a card is present is decided inside
the fixture, never at import.

Tolerances: f32 inputs agree to reduction order (1e-4); bf16 paged decode
differs from its plain version by the plain path's bf16 logits (the kernel
pre-scales q in bf16 and keeps scores in f32), 3e-2 absolute on outputs of
unit scale, and over int8 pools also by the plain path's dequantized K/V
rounded to q's dtype (2e-2 relative for outputs beyond unit scale; against
the plain version run in f32 on the kernel's pre-scaled q, 5e-3
norm-relative for each (sequence, head) row); 2-byte
flash rounds P to the input dtype before ``P @ V`` (as the TPU kernel
does) where the plain version keeps f32: about two ulps of the output,
2e-2 absolute plus 2e-2 relative; against the plain version run in f32
with P rounded likewise, each (b, s, h) row within 1e-2 of its norm and
every element within 2e-3 plus 1e-2 relative (``chip_smoke.py``'s
FLASH_* gate). The flash backward kernels
round P and dS to the input dtype before their products (as the TPU
kernels do) where the plain version keeps f32: for 2-byte inputs dq/dk/dv
agree within 3e-2 absolute plus 3e-2 relative and 1e-2 in norm-relative
error; against the plain version run in f32 with P and dS rounded likewise,
each row of D values (dq: (b, s, h); dk, dv: (b, s_k, h_kv)) within 1.4e-2
of its norm (a norm counting at least 1e-2 of the tensor's RMS row norm)
and every element within 1e-2 plus 1e-2 relative (``chip_smoke.py``'s
BWD_* gate, with the elementwise bound the kernels that sum GQA groups in
f32 hold); f32 to 1e-4. The fused AdamW kernel is bitwise equal to its
plain version.
"""
import pytest
import torch

from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from paddle_tpu_torch.ops.fused_adamw import (
    adamw_scalars_multi,
    fused_adamw_multi_update,
    fused_adamw_multi_update_plain,
    fused_adamw_update,
    fused_adamw_update_plain,
)
from paddle_tpu_torch.ops.paged_attention import (
    paged_decode,
    paged_decode_int8,
    paged_decode_int8_plain,
    paged_decode_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2, torch.float16: 3e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_paged_decode_kernel_matches_plain(dev, dtype, d):
    g = torch.Generator(device="cpu").manual_seed(0)
    b, h, kvh, bs, per = 5, 8, 2, 16, 9
    nb = b * per + 3
    tables = torch.randperm(nb, generator=g)[: b * per].reshape(b, per)
    tables = tables.to(torch.int32).to(dev)
    kp = torch.randn(kvh, nb, bs, d, generator=g).to(dev, dtype)
    vp = torch.randn(kvh, nb, bs, d, generator=g).to(dev, dtype)
    q = torch.randn(b, 1, h, d, generator=g).to(dev, dtype)
    cl = torch.tensor([0, 15, 16, 77, per * bs - 1], dtype=torch.int32,
                      device=dev)
    before = paged_decode.launches
    got = paged_decode(q, kp, vp, tables, cl)
    torch.cuda.synchronize()
    assert paged_decode.launches == before + 1
    want = paged_decode_plain(q, kp, vp, tables, cl)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("heads", [(8, 2), (4, 4)], ids=["gqa", "mha"])
def test_paged_decode_int8_kernel_matches_plain(dev, dtype, d, heads):
    """Int8 pools with f32 scales: the kernel dequantizes in f32 as
    ``(x * s) / 127.5`` where the plain version rounds ``x * (s / 127.5)``
    to q's dtype, so f32 agrees to reduction order and 2-byte types to the
    plain path's rounding (the float kernel's tolerances)."""
    g = torch.Generator(device="cpu").manual_seed(7)
    h, kvh = heads
    b, bs, per = 5, 16, 9
    nb = b * per + 3
    tables = torch.randperm(nb, generator=g)[: b * per].reshape(b, per)
    tables = tables.to(torch.int32).to(dev)
    kp, vp = (torch.randint(-127, 128, (kvh, nb, bs, d), generator=g)
              .to(torch.int8).to(dev) for _ in range(2))
    ks, vs = ((0.1 + 3 * torch.rand(kvh, nb, bs, generator=g)).to(dev)
              for _ in range(2))
    q = torch.randn(b, 1, h, d, generator=g).to(dev, dtype)
    # lengths 1, a page edge, one past it, mid-table and the full table
    cl = torch.tensor([0, 15, 16, 77, per * bs - 1], dtype=torch.int32,
                      device=dev)
    before = (paged_decode_int8.launches, paged_decode.launches)
    got = paged_decode_int8(q, kp, vp, ks, vs, tables, cl)
    torch.cuda.synchronize()
    assert (paged_decode_int8.launches, paged_decode.launches) == (
        before[0] + 1, before[1])
    want = paged_decode_int8_plain(q, kp, vp, ks, vs, tables, cl)
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0 if dtype == torch.float32 else 2e-2)
    # against the plain version run in f32 on the kernel's pre-scaled q,
    # only the kernel's final rounding to q's dtype is left: each
    # (sequence, head) row within 5e-3 of its norm
    scale = torch.tensor(d ** -0.5, dtype=torch.float32).to(dtype)
    want32 = paged_decode_int8_plain((q * scale).float() * d ** 0.5, kp, vp,
                                     ks, vs, tables, cl)
    row_rel = ((got.float() - want32).norm(dim=-1)
               / want32.norm(dim=-1).clamp_min(1e-30))
    assert float(row_rel.max()) <= 5e-3


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_paged_decode_attention_takes_kernel_on_contiguous_tables(dev, int8):
    """On the card, contiguous tables (``generate``'s layout) at a GQA
    ratio below 4 launch the kernel too; the CPU takes the reshape view."""
    from paddle_tpu_torch.ops.paged_attention import (
        _kv_quantize, contiguous_tables, paged_decode_attention)

    g = torch.Generator(device="cpu").manual_seed(8)
    b, h, kvh, d, bs, max_len = 3, 4, 2, 64, 16, 64
    tables = torch.from_numpy(contiguous_tables(b, max_len, bs)).to(dev)
    nb = tables.numel()
    kp, vp = (torch.randn(kvh, nb, bs, d, generator=g).to(dev)
              for _ in range(2))
    q = torch.randn(b, 1, h, d, generator=g).to(dev)
    cl = torch.tensor([0, 20, max_len - 1], dtype=torch.int32, device=dev)
    if int8:
        (kp, ks), (vp, vs) = _kv_quantize(kp), _kv_quantize(vp)
        wrapper, scales = paged_decode_int8, dict(k_scale=ks, v_scale=vs)
        want = paged_decode_int8_plain(q, kp, vp, ks, vs, tables, cl)
    else:
        wrapper, scales = paged_decode, {}
        want = paged_decode_plain(q, kp, vp, tables, cl)
    before = wrapper.launches
    got = paged_decode_attention(q, kp, vp, tables, cl, contiguous=True,
                                 **scales)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


# (B, H, KVH, lengths): at bs=64 and a 32-page table, B=5 and H=16 take
# 16 splits of 2 pages (128 tokens): one token, exactly one split, one past
# it, a ragged middle and the full table (the splits past a short row hold
# no live page); B=1 takes 32 splits of one page
SPLIT_EDGES = {
    "mha": (5, 16, 16, [1, 128, 129, 700, 2048]),
    "gqa4": (5, 16, 4, [1, 128, 129, 700, 2048]),
    "b1_full": (1, 16, 16, [2048]),
    "b1_one_page_past": (1, 8, 2, [65]),
}


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", list(SPLIT_EDGES))
def test_paged_decode_kernels_split_edges(dev, int8, case):
    """Both decode kernels at lengths on the split edges, bf16 q: against
    the plain version (the float kernel's and the int8 kernel's tolerances
    above) and, per (sequence, head) row, within 5e-3 of the plain version
    run in f32 on the kernel's pre-scaled q; a second call gives the same
    bits (each call returns its tickets to zero)."""
    from paddle_tpu_torch.ops.paged_attention import (_kv_quantize,
                                                      decode_splits)

    b, h, kvh, lens = SPLIT_EDGES[case]
    d, bs, per = 128, 64, 32
    g = torch.Generator(device="cpu").manual_seed(11)
    nb = b * per + 1
    tables = torch.randperm(b * per, generator=g).reshape(b, per)
    tables = tables.to(torch.int32).to(dev)
    kp, vp = (torch.randn(kvh, nb, bs, d, generator=g).to(dev, torch.bfloat16)
              for _ in range(2))
    q = torch.randn(b, 1, h, d, generator=g).to(dev, torch.bfloat16)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev) - 1
    splits, pps = decode_splits(per, b, h, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    assert splits > 1
    if int8:
        (kp, ks), (vp, vs) = _kv_quantize(kp), _kv_quantize(vp)
        wrapper, args = paged_decode_int8, (q, kp, vp, ks, vs, tables, cl)
        plain = paged_decode_int8_plain
        want32 = plain(_prescaled_q32(q), *args[1:])
    else:
        wrapper, args = paged_decode, (q, kp, vp, tables, cl)
        plain = paged_decode_plain
        want32 = plain(_prescaled_q32(q), kp.float(), vp.float(), tables, cl)
    before = wrapper.launches
    got = wrapper(*args)
    again = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert torch.equal(got, again)
    want = plain(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                               rtol=2e-2 if int8 else 0)
    assert _row_rel(got, want32) <= 5e-3


def _prescaled_q32(q):
    """q as the decode kernels round it (``q * (1/sqrt(D))`` in q's dtype),
    back at unit scale in f32 for the plain versions' own scaling."""
    d = q.shape[-1]
    scale = torch.tensor(d ** -0.5, dtype=torch.float32).to(q.dtype)
    return (q * scale).float() * d ** 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 256, 4, 4, 256), (1, 100, 4, 2, 300)],
                         ids=["mha", "gqa_ragged_cross"])
def test_flash_kernel_matches_plain(dev, dtype, d, causal, shape):
    b, sq, h, hkv, sk = shape
    g = torch.Generator(device="cpu").manual_seed(1)
    q = torch.randn(b, sq, h, d, generator=g).to(dev, dtype)
    k = torch.randn(b, sk, hkv, d, generator=g).to(dev, dtype)
    v = torch.randn(b, sk, hkv, d, generator=g).to(dev, dtype)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    want, want_lse = flash_attention_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(out.float(), want.float(),
                               atol=1e-4 if dtype == torch.float32 else 2e-2,
                               rtol=0 if dtype == torch.float32 else 2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-5)
    if dtype != torch.float32:
        _check_flash_rows(out, q, k, v, causal)


def _row_rel(a, want):
    """The worst norm-relative error over the rows of the last axis."""
    a, want = a.float(), want.float()
    return float(((a - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(1e-30)).max())


def _check_flash_rows(out, q, k, v, causal):
    """The 2-byte flash kernels' per-row gate: against the plain version
    run in f32 with P rounded to q's dtype before ``P @ V`` (the kernels'
    rounding points), each (b, s, h) row within 1e-2 of its norm and every
    element within 2e-3 + 1e-2 relative (chip_smoke's FLASH_* gate)."""
    want32, _ = flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                          causal, p_dtype=q.dtype)
    assert torch.isfinite(out).all()
    assert _row_rel(out, want32) <= 1e-2
    torch.testing.assert_close(out.float(), want32, atol=2e-3, rtol=1e-2)


# (B, Sq, H, Hkv, Sk, causal): ragged ends that TMA zero-fills and the
# epilogue clips, the causal chunk offset (Sq < Sk), fully masked rows
# (Sq > Sk), and GQA groups of 2, 4 and 8
WGMMA_EDGES = {
    "ragged": (2, 200, 4, 4, 333, False),
    "causal_chunk_offset": (1, 130, 8, 2, 390, True),
    "masked_rows": (1, 300, 4, 1, 100, True),
    "gqa2": (1, 256, 8, 4, 256, True),
    "gqa4": (2, 384, 8, 2, 384, False),
    "gqa8": (1, 256, 8, 1, 256, True),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", list(WGMMA_EDGES))
def test_flash_wgmma_kernel_edges(dev, dtype, d, case):
    b, sq, h, hkv, sk, causal = WGMMA_EDGES[case]
    g = torch.Generator(device="cpu").manual_seed(9)
    q = torch.randn(b, sq, h, d, generator=g).to(dev, dtype)
    k = torch.randn(b, sk, hkv, d, generator=g).to(dev, dtype)
    v = torch.randn(b, sk, hkv, d, generator=g).to(dev, dtype)
    before = dict(flash_attention_fwd.variant_launches)
    out, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.variant_launches == dict(
        before, wgmma=before["wgmma"] + 1)
    want, want_lse = flash_attention_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-5)
    _check_flash_rows(out, q, k, v, causal)
    if case == "masked_rows":  # rows i + (Sk - Sq) < 0 see no key
        assert torch.all(out[:, : sq - sk] == 0)
        assert torch.all(lse[:, :, : sq - sk] == -1e30)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_wgmma_kernel_reads_fused_qkv_slices(dev, dtype, d, causal):
    """q/k/v as strided slices of one fused [B, S, 3, H, D] buffer, read
    through the tensor maps' strides without a copy."""
    g = torch.Generator(device="cpu").manual_seed(10)
    qkv = torch.randn(2, 192, 3, 4, d, generator=g).to(dev, dtype)
    q, k, v = qkv.unbind(2)
    before = flash_attention_fwd.variant_launches["wgmma"]
    out, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.variant_launches["wgmma"] == before + 1
    want, want_lse = flash_attention_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-5)
    _check_flash_rows(out, q, k, v, causal)


def test_kernels_build_from_sources(dev):
    times = kernels.build()
    assert set(times) == set(kernels.SOURCES)
    for name in kernels.SOURCES:
        assert kernels.load(name) is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_strided_and_misaligned_views(dev, dtype):
    """[B, H, S, D] storage seen as [B, S, H, D], and a view starting one
    element into its storage (not 16-byte aligned)."""
    g = torch.Generator(device="cpu").manual_seed(2)
    q = torch.randn(2, 4, 128, 64, generator=g).to(dev, dtype).transpose(1, 2)
    buf = torch.randn(2, 128, 4, 65, generator=g).to(dev, dtype)
    k = buf[..., 1:]
    v = buf[..., :64]
    out, lse = flash_attention_fwd(q, k, v, True)
    want, want_lse = flash_attention_fwd_plain(q, k, v, True)
    torch.testing.assert_close(out.float(), want.float(),
                               atol=1e-4 if dtype == torch.float32 else 2e-2,
                               rtol=0 if dtype == torch.float32 else 2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-5)
    if dtype != torch.float32:
        _check_flash_rows(out, q, k, v, True)


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 256, 4, 4, 256), (1, 100, 4, 2, 300),
                                   (1, 200, 4, 1, 72)],
                         ids=["mha", "gqa_ragged_cross", "mqa_masked_rows"])
def test_flash_backward_kernels_match_plain(dev, dtype, d, causal, shape):
    b, sq, h, hkv, sk = shape
    g = torch.Generator(device="cpu").manual_seed(3)
    q, do = (torch.randn(b, sq, h, d, generator=g).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, hkv, d, generator=g).to(dev, dtype)
            for _ in range(2))
    out, lse = flash_attention_fwd_plain(q, k, v, causal)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    for a, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.isfinite(a).all(), name
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, atol=1e-4, rtol=0, msg=name)
        else:
            torch.testing.assert_close(a.float(), w.float(), atol=3e-2,
                                       rtol=3e-2, msg=name)
            assert _rel(a, w) <= 1e-2, name
    if dtype != torch.float32:
        _check_bwd_rows(got, q, k, v, out, lse, do, causal)


def _check_bwd_rows(got, q, k, v, out, lse, do, causal):
    """The 2-byte flash backward's per-row gate: against the plain version
    run in f32 with P and dS rounded to q's dtype where the kernels round
    them, each row of D values within 1.4e-2 of its norm (counted as at
    least 1e-2 of the tensor's RMS row norm: dq's first causal row is
    rounding noise) and every element within 1e-2 + 1e-2 relative
    (chip_smoke's BWD_* gate)."""
    want32 = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                       out.float(), lse, do.float(), causal,
                                       p_dtype=q.dtype)
    for a, w, name in zip(got, want32, ("dq", "dk", "dv")):
        a = a.float()
        norms = w.norm(dim=-1)
        floor = 1e-2 * float(norms.pow(2).mean().sqrt())
        row_rel = ((a - w).norm(dim=-1) / norms.clamp_min(max(floor, 1e-30)))
        assert float(row_rel.max()) <= 1.4e-2, name
        torch.testing.assert_close(a, w, atol=1e-2, rtol=1e-2, msg=name)


# (B, Sq, H, Hkv, Sk, causal): ragged ends that TMA zero-fills and the
# epilogues clip, the causal chunk offset (Sq < Sk), fully masked rows
# (Sq > Sk), and GQA groups of 1, 2 and 4
WGMMA_BWD_EDGES = {
    "ragged": (2, 200, 4, 4, 333, False),
    "ragged_causal": (2, 333, 4, 4, 333, True),
    "causal_chunk_offset": (1, 130, 8, 2, 390, True),
    "masked_rows": (1, 300, 4, 1, 100, True),
    "gqa2": (1, 256, 8, 4, 256, True),
    "gqa4": (2, 384, 8, 2, 384, False),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", list(WGMMA_BWD_EDGES))
def test_flash_backward_wgmma_kernels_edges(dev, dtype, d, case):
    b, sq, h, hkv, sk, causal = WGMMA_BWD_EDGES[case]
    g = torch.Generator(device="cpu").manual_seed(11)
    q, do = (torch.randn(b, sq, h, d, generator=g).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, hkv, d, generator=g).to(dev, dtype)
            for _ in range(2))
    out, lse = flash_attention_fwd(q, k, v, causal)
    before = [dict(w.variant_launches)
              for w in (flash_attention_bwd_dq, flash_attention_bwd_dkv)]
    got = flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    for w, counts in zip((flash_attention_bwd_dq, flash_attention_bwd_dkv),
                         before):
        assert w.variant_launches == dict(counts, wgmma=counts["wgmma"] + 1)
    assert got[1].shape == got[2].shape == k.shape  # summed per kv head
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    for a, w, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(a.float(), w.float(), atol=3e-2, rtol=3e-2,
                                   msg=name)
    _check_bwd_rows(got, q, k, v, out, lse, do, causal)
    if case == "masked_rows":  # rows i + (Sk - Sq) < 0 see no key
        assert torch.all(got[0][:, : sq - sk] == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_wgmma_kernels_read_strided_views(dev, dtype, d):
    """q and dO as [B, H, S, D] buffers seen as [B, S, H, D], k and v as
    strided slices of one fused [B, S, 2, Hkv, D] buffer, read through the
    tensor maps' strides without a copy."""
    g = torch.Generator(device="cpu").manual_seed(12)
    q, do = (torch.randn(2, 8, 192, d, generator=g).to(dev, dtype)
             .transpose(1, 2) for _ in range(2))
    k, v = torch.randn(2, 192, 2, 4, d, generator=g).to(dev, dtype).unbind(2)
    out, lse = flash_attention_fwd(q, k, v, True)
    got = flash_attention_bwd(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    _check_bwd_rows(got, q, k, v, out, lse, do, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_on_card_matches_plain_backward(dev, dtype):
    """``flash_attention`` differentiated on the card: strided q (a
    transposed [B, H, S, D] buffer) and a GQA ratio of 2."""
    g = torch.Generator(device="cpu").manual_seed(4)
    q = torch.randn(2, 4, 128, 64, generator=g).to(dev, dtype).transpose(1, 2)
    k = torch.randn(2, 128, 2, 64, generator=g).to(dev, dtype)
    v = torch.randn(2, 128, 2, 64, generator=g).to(dev, dtype)
    do = torch.randn(2, 128, 4, 64, generator=g).to(dev, dtype)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, True).backward(do)
    out, lse = flash_attention_fwd_plain(q, k, v, True)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    for t, w in zip(leaves, want):
        if dtype == torch.float32:
            torch.testing.assert_close(t.grad, w, atol=1e-4, rtol=0)
        else:
            assert _rel(t.grad, w) <= 1e-2


ADAMW_COMBOS = [(torch.float32, torch.float32, torch.float32),
                (torch.float32, torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.bfloat16, torch.float32),
                (torch.bfloat16, torch.float32, torch.bfloat16),
                (torch.float32, torch.bfloat16, torch.float32)]


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


@pytest.mark.parametrize("combo", ADAMW_COMBOS,
                         ids=lambda c: "-".join(str(x)[6:] for x in c))
@pytest.mark.parametrize("sr", [False, True], ids=["rne", "sr"])
@pytest.mark.parametrize("shape", [(37, 19), (1000, 1301)])
def test_fused_adamw_kernel_bitwise_vs_plain(dev, combo, sr, shape):
    p_dt, g_dt, m_dt = combo
    if sr and p_dt != torch.bfloat16:
        pytest.skip("the SR writeback takes bf16 params only")
    g = torch.Generator(device="cpu").manual_seed(5)
    p = torch.randn(*shape, generator=g).to(dev, p_dt)
    gr = (0.1 * torch.randn(*shape, generator=g)).to(dev, g_dt)
    m = (0.01 * torch.randn(*shape, generator=g)).to(dev, m_dt)
    v = (0.01 * torch.rand(*shape, generator=g)).to(dev, m_dt)
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, epsilon=1e-8,
              beta1_pow=torch.tensor(0.9 ** 3, device=dev),
              beta2_pow=torch.tensor(0.999 ** 3, device=dev), weight_decay=0.01,
              sr_salts=(torch.tensor([0xDEADBEEF, 0x12345678], device=dev)
                        if sr else None))
    ref = [t.clone() for t in (p, m, v)]
    before = fused_adamw_multi_update.launches  # the kernel's one count
    fused_adamw_update(p, gr, m, v, **kw)
    torch.cuda.synchronize()
    assert fused_adamw_multi_update.launches == before + 1
    fused_adamw_update_plain(ref[0], gr, ref[1], ref[2], **kw)
    for a, b, name in zip((p, m, v), ref, "pmv"):
        assert torch.equal(_bits(a), _bits(b)), name


def test_fused_adamw_kernel_skip_writes_nothing(dev):
    g = torch.Generator(device="cpu").manual_seed(6)
    p = torch.randn(513, 7, generator=g).to(dev, torch.bfloat16)
    gr = torch.full_like(p, float("inf"))
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    ref = [t.clone() for t in (p, m, v)]
    fused_adamw_update(p, gr, m, v, lr=1e-2, beta1=0.9, beta2=0.999,
                       epsilon=1e-8, beta1_pow=torch.tensor(0.9, device=dev),
                       beta2_pow=torch.tensor(0.999, device=dev),
                       sr_salts=torch.tensor([1, 2], device=dev),
                       skip=torch.tensor(True, device=dev))
    torch.cuda.synchronize()
    for a, b in zip((p, m, v), ref):
        assert torch.equal(_bits(a), _bits(b))


def _adamw_set(dev, sizes, dtypes, seed, offsets=None):
    """One (p, g, m, v) per size; with ``offsets``, each tensor a view that
    starts that many elements into a larger buffer (p, g, m, v offsets)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = []
    for i, n in enumerate(sizes):
        off = offsets[i] if offsets else (0, 0, 0, 0)
        scales = (1.0, 0.1, 0.01, 0.01)
        row = []
        for k, (dt, o, sc) in enumerate(zip(dtypes, off, scales)):
            buf = (torch.rand if k == 3 else torch.randn)(n + o, generator=g)
            row.append((sc * buf).to(dev, dt)[o:])
        rows.append(row)
    return rows


def _adamw_rows(dev, t, sr, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    scalars = adamw_scalars_multi(
        lr=[1e-2 * (1 + i % 3) for i in range(t)], epsilon=1e-8,
        beta1_pow=torch.full((t,), 0.9 ** 3, device=dev),
        beta2_pow=torch.full((t,), 0.999 ** 3, device=dev),
        weight_decay=[0.01 * (i % 2) for i in range(t)])
    salts = (torch.randint(0, 2 ** 32, (t, 2), generator=g).to(dev)
             if sr else None)
    return scalars, salts


def _check_multi(rows, scalars, salts, launches):
    ref = [[x.clone() for x in row] for row in rows]
    before = fused_adamw_multi_update.launches
    fused_adamw_multi_update(*zip(*rows), scalars=scalars, beta1=0.9,
                             beta2=0.999, sr_salts=salts)
    torch.cuda.synchronize()
    assert fused_adamw_multi_update.launches == before + launches
    fused_adamw_multi_update_plain(*zip(*ref), scalars=scalars, beta1=0.9,
                                   beta2=0.999, sr_salts=salts)
    for i, (got, want) in enumerate(zip(rows, ref)):
        for k in (0, 2, 3):
            assert torch.equal(_bits(got[k]), _bits(want[k])), (i, "pgmv"[k])


@pytest.mark.parametrize("combo", ADAMW_COMBOS,
                         ids=lambda c: "-".join(str(x)[6:] for x in c))
@pytest.mark.parametrize("sr", [False, True], ids=["rne", "sr"])
def test_fused_adamw_multi_kernel_bitwise_vs_plain(dev, combo, sr):
    """One launch over tensors of 1, 7, 2049, 8192 * 3 + 5 and 2048 x 33
    elements: bitwise the T per-tensor plain updates."""
    p_dt, g_dt, m_dt = combo
    if sr and p_dt != torch.bfloat16:
        pytest.skip("the SR writeback takes bf16 params only")
    rows = _adamw_set(dev, [1, 7, 2049, 8192 * 3 + 5, 2048 * 33],
                      (p_dt, g_dt, m_dt, m_dt), seed=12)
    _check_multi(rows, *_adamw_rows(dev, len(rows), sr), launches=1)


@pytest.mark.parametrize("sr", [False, True], ids=["rne", "sr"])
def test_fused_adamw_multi_kernel_misaligned_views(dev, sr):
    """Views that start off a 16-byte boundary: all four at one phase (an
    element-wise head, then 16-byte accesses), at different phases (the
    whole tensor element-wise), and at the same phase in bf16 and f32."""
    bf, f32 = torch.bfloat16, torch.float32
    rows = _adamw_set(dev, [2049, 10000, 5000, 3], (bf, bf, bf, bf), seed=13,
                      offsets=[(3, 3, 3, 3), (1, 2, 3, 4), (7, 7, 7, 7),
                               (5, 0, 1, 2)])
    _check_multi(rows, *_adamw_rows(dev, len(rows), sr), launches=1)
    rows = _adamw_set(dev, [9001, 17], (bf, f32, bf, bf), seed=14,
                      offsets=[(4, 4, 4, 4), (1, 1, 1, 1)])
    _check_multi(rows, *_adamw_rows(dev, len(rows), sr), launches=1)


def test_fused_adamw_multi_kernel_splits_long_tables_and_skips_empty(dev):
    """600 tensors take two launches (512 a launch); empty tensors are left
    out of the table."""
    bf = torch.bfloat16
    sizes = [0 if i % 97 == 5 else 1 + (i * 37) % 3000 for i in range(600)]
    rows = _adamw_set(dev, sizes, (bf, bf, bf, bf), seed=15)
    _check_multi(rows, *_adamw_rows(dev, len(rows), True), launches=2)


def test_fused_adamw_multi_kernel_skip_writes_nothing(dev):
    """The found-inf veto, one flag for the whole launch."""
    bf = torch.bfloat16
    rows = _adamw_set(dev, [513 * 7, 1, 70000], (bf, bf, bf, bf), seed=16)
    for row in rows:
        row[1].fill_(float("inf"))
    ref = [[x.clone() for x in row] for row in rows]
    scalars = adamw_scalars_multi(
        lr=1e-2, epsilon=1e-8, beta1_pow=torch.full((3,), 0.9, device=dev),
        beta2_pow=torch.full((3,), 0.999, device=dev),
        skip=torch.tensor(True, device=dev))
    fused_adamw_multi_update(*zip(*rows), scalars=scalars, beta1=0.9,
                             beta2=0.999,
                             sr_salts=torch.ones(3, 2, dtype=torch.int64,
                                                 device=dev))
    torch.cuda.synchronize()
    for got, want in zip(rows, ref):
        for k in (0, 2, 3):
            assert torch.equal(_bits(got[k]), _bits(want[k]))


def test_fused_adamw_multi_kernel_f32_group_skip_writes_nothing(dev):
    """The fp16 recipe's group (f32 p, g, m, v, no SR) under the veto
    GradScaler feeds it: nothing is written; without it, bitwise the plain
    version."""
    f32 = torch.float32
    rows = _adamw_set(dev, [513 * 7, 1, 70000], (f32, f32, f32, f32), seed=17)
    for row in rows[:1]:
        row[1][0] = float("inf")
    ref = [[x.clone() for x in row] for row in rows]
    scalars = adamw_scalars_multi(
        lr=1e-2, epsilon=1e-8, beta1_pow=torch.full((3,), 0.9, device=dev),
        beta2_pow=torch.full((3,), 0.999, device=dev),
        skip=torch.tensor(True, device=dev))
    fused_adamw_multi_update(*zip(*rows), scalars=scalars, beta1=0.9,
                             beta2=0.999)
    torch.cuda.synchronize()
    for got, want in zip(rows, ref):
        for k in (0, 2, 3):
            assert torch.equal(_bits(got[k]), _bits(want[k]))
    rows[0][1].zero_()
    _check_multi(rows, *_adamw_rows(dev, len(rows), False), launches=1)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_f16_at_the_training_shape(dev, causal):
    """The f16 forward and backward at the flagship's head shape (S=2048,
    D=128; fewer heads) under the FLASH_* and BWD_* per-row gates: the
    instantiations ``auto_cast(dtype="float16")`` puts on the main path."""
    g = torch.Generator(device="cpu").manual_seed(21)
    q, k, v, do = (torch.randn(1, 2048, 4, 128, generator=g).to(dev, torch.float16)
                   for _ in range(4))
    before = dict(flash_attention_fwd.variant_launches)
    out, lse = flash_attention_fwd(q, k, v, causal)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.variant_launches["wgmma"] == before["wgmma"] + 1
    _check_flash_rows(out, q, k, v, causal)
    _check_bwd_rows(got, q, k, v, out, lse, do, causal)


# -- the captured step (jit.to_static on the card) ---------------------------
def _train_setup(dev, sr=False, seed=0, **opt_kw):
    """A 2-layer bf16 Llama whose attention takes the flash kernels (head_dim
    128, S=128), fused AdamW (weight decay 0, so the captured step's device
    decay factor is exactly the eager one), and its bench step."""
    from paddle_tpu_torch import jit, seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    pt_seed(seed)
    cfg = LlamaConfig.tiny(vocab_size=512, hidden_size=256,
                           intermediate_size=512, num_attention_heads=2,
                           num_key_value_heads=2, max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    kw = dict(learning_rate=1e-3, weight_decay=0.0, moment_dtype="bfloat16",
              use_stochastic_rounding=sr, fused=True)
    kw.update(opt_kw)
    opt = AdamW(parameters=model.parameters(), **kw)

    def step(ids, labels):
        loss = model.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    ids = torch.randint(0, 512, (2, 128),
                        generator=torch.Generator().manual_seed(5)).to(dev)
    return model, opt, jit.to_static(step, layers=[model], optimizers=[opt]), ids


def _run(compiled, ids, n):
    return torch.stack([compiled(ids, ids).detach() for _ in range(n)])


@pytest.mark.parametrize("sr", [False, True], ids=["sr_off", "sr_on"])
def test_captured_step_equals_the_eager_step(dev, sr):
    """Four calls: the warm-up runs eagerly, the second captures the step
    and replays it, the last two replay. From the same seed and state the
    eager run (``enable_to_static(False)``) gives the same losses and
    parameters bitwise: with SR on as well, since the salt generator is
    registered with the graph and a replay draws what an eager step from
    the same generator state would."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.ops.fused_adamw import fused_adamw_multi_update

    runs = []
    for captured in (True, False):
        model, opt, compiled, ids = _train_setup(dev, sr=sr)
        jit.enable_to_static(captured)
        try:
            kernels.reset_launch_counts()
            losses = _run(compiled, ids, 4)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        finally:
            jit.enable_to_static(True)
        runs.append((losses, [p.detach().clone() for p in model.parameters()],
                     counts, opt._global_step, len(compiled._graphs)))
    (lc, pc, cc, sc, gc), (le, pe, ce, se, ge) = runs
    assert gc == 1 and ge == 0 and sc == se == 4
    assert cc == ce and cc["fused_adamw"] == 4
    assert cc["flash_attention_fwd:wgmma"] == cc["flash_attention_bwd_dq:wgmma"] == 8
    assert torch.equal(lc, le), (lc, le)
    for a, b in zip(pc, pe):
        assert torch.equal(a, b)
    assert lc[-1] < lc[0]
    assert fused_adamw_multi_update.launches == 4


def test_two_replays_draw_different_salts(dev):
    from paddle_tpu_torch import jit, seed as pt_seed
    from paddle_tpu_torch.base import random as R

    pt_seed(7)
    x = torch.zeros(4, device=dev)
    compiled = jit.to_static(lambda t: t + R.sr_salts(dev, 3).float().sum())
    compiled(x)  # warm-up, eager
    state = R.sr_generator(dev).get_state()
    a, b = compiled(x), compiled(x)  # capture + replay, replay
    assert len(compiled._graphs) == 1 and not torch.equal(a, b)
    R.sr_generator(dev).set_state(state)
    ea = x + R.sr_salts(dev, 3).float().sum()
    eb = x + R.sr_salts(dev, 3).float().sum()
    assert torch.equal(a, ea) and torch.equal(b, eb)


def test_replays_keep_parameter_grad_and_state_addresses(dev):
    """With ``clear_grad(set_to_zero=True)`` the gradients outlive the step:
    the capture accumulates into the buffers the warm-up made, and the
    parameters, gradients and moments keep their addresses over replays."""
    model, opt, _, ids = _train_setup(dev)
    from paddle_tpu_torch import jit

    def step(ids, labels):
        loss = model.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad(set_to_zero=True)
        return loss

    compiled = jit.to_static(step, layers=[model], optimizers=[opt])
    compiled(ids, ids)
    params = list(model.parameters())
    ptrs = ([p.data_ptr() for p in params], [p.grad.data_ptr() for p in params],
            [t.data_ptr() for t in opt._accumulators["moment1"].values()])
    losses = _run(compiled, ids, 3)
    torch.cuda.synchronize()
    assert len(compiled._graphs) == 1 and bool(torch.isfinite(losses).all())
    assert ptrs == ([p.data_ptr() for p in params],
                    [p.grad.data_ptr() for p in params],
                    [t.data_ptr() for t in opt._accumulators["moment1"].values()])
    assert all(not p.grad.any() for p in params)
    assert losses[-1] < losses[0]


def test_a_step_that_reads_the_host_is_refused_or_runs_eagerly(dev):
    from paddle_tpu_torch import jit

    model, opt, _, ids = _train_setup(dev)

    def step(ids, labels):
        loss = model.loss(ids, labels)
        if loss.item() > 1e9:  # a host branch on a device value
            return loss
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    strict = jit.to_static(step, layers=[model], optimizers=[opt])
    strict(ids, ids)
    with pytest.raises(RuntimeError, match="could not capture the step"):
        strict(ids, ids)
    assert all(p.grad is None for p in model.parameters())
    loose = jit.to_static(step, layers=[model], optimizers=[opt],
                          full_graph=False)
    loose(ids, ids)
    with pytest.warns(UserWarning, match="cannot be captured"):
        loose(ids, ids)
    assert loose._fallback_eager and not loose._graphs
    assert torch.isfinite(loose(ids, ids))


def test_captured_fp16_step_with_a_forced_overflow(dev):
    """``auto_cast(float16)`` over f32 parameters, ``GradScaler`` and fused
    AdamW, captured with ``scalers=``: a scale of 2**40 overflows the next
    replay, which leaves parameters, moments and beta powers bitwise as
    they were and counts one bad step; with the scale set back, the replay
    after it applies."""
    from paddle_tpu_torch import amp, jit, seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    pt_seed(3)
    cfg = LlamaConfig.tiny(vocab_size=512, hidden_size=256,
                           intermediate_size=512, num_attention_heads=2,
                           num_key_value_heads=2, max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device=dev)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(), fused=True)
    scaler = amp.GradScaler()

    def step(ids, labels):
        with amp.auto_cast(level="O1", dtype="float16"):
            loss = model.loss(ids, labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss

    compiled = jit.to_static(step, layers=[model], optimizers=[opt],
                             scalers=[scaler])
    ids = torch.randint(0, 512, (2, 128),
                        generator=torch.Generator().manual_seed(6)).to(dev)
    kernels.reset_launch_counts()
    _run(compiled, ids, 3)
    counts = kernels.launch_counts()
    assert counts["flash_attention_fwd:wgmma"] == 6 and counts["fused_adamw"] == 3

    def state():
        return ([p.detach().clone() for p in model.parameters()],
                {k: v.clone() for k, v in opt.state_dict().items()
                 if isinstance(v, torch.Tensor)})

    before = state()
    scaler.set_scale_value(2.0 ** 40)
    compiled(ids, ids)
    after = state()
    for a, b in zip(before[0], after[0]):
        assert torch.equal(a, b)
    for k in before[1]:
        assert torch.equal(before[1][k], after[1][k]), k
    # the reference's rule at its defaults: one bad step of the two that
    # halve the scale
    assert scaler.get_scale_value() == 2.0 ** 40
    assert int(scaler._bad_steps) == 1 and int(scaler._good_steps) == 0
    scaler.set_scale_value(2.0 ** 15)
    compiled(ids, ids)
    assert not torch.equal(after[0][0], next(model.parameters()))
    assert int(scaler._good_steps) == 1 and int(scaler._bad_steps) == 0
    assert len(compiled._graphs) == 1 and scaler.n_skipped_steps == 0


def test_a_state_load_between_calls_is_captured_afresh(dev):
    """``set_state_dict`` after the warm-up call binds new accumulators: the
    capture that meets them puts the state back, runs that call eagerly
    and captures the next; the run equals the eager one bitwise (a graph
    that kept the old beta powers would not)."""
    from paddle_tpu_torch import jit

    runs = []
    for captured in (True, False):
        model, opt, compiled, ids = _train_setup(dev)
        jit.enable_to_static(captured)
        try:
            losses = [compiled(ids, ids).detach()]
            opt.set_state_dict(opt.state_dict())
            losses += [compiled(ids, ids).detach() for _ in range(4)]
            torch.cuda.synchronize()
        finally:
            jit.enable_to_static(True)
        runs.append((torch.stack(losses),
                     [p.detach().clone() for p in model.parameters()],
                     len(compiled._graphs), opt._global_step))
    (lc, pc, gc, sc), (le, pe, ge, se) = runs
    assert gc == 1 and ge == 0 and sc == se == 5
    assert torch.equal(lc, le)
    for a, b in zip(pc, pe):
        assert torch.equal(a, b)


def _serve_small(dev, captured, **kw):
    """A small bf16 model's engine over six prompts (three of a repeated
    segment); returns the streams, the engine and the launch counts."""
    import numpy as np

    from paddle_tpu_torch import jit
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    pt_seed(3)
    cfg = LlamaConfig.tiny(vocab_size=512, hidden_size=256,
                           intermediate_size=512, num_attention_heads=2,
                           num_key_value_heads=2, max_position_embeddings=512)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    rng = np.random.RandomState(4)
    prompts = [np.tile(rng.randint(0, 512, (8,)), 4) if i % 2 else
               rng.randint(0, 512, (int(rng.randint(5, 40)),))
               for i in range(6)]
    eng = ContinuousBatchingEngine(model, max_batch=3, max_len=128,
                                   block_size=16, num_blocks=40,
                                   prompt_pad=48, **kw)
    for i, p in enumerate(prompts):
        eng.add_request(i, p, max_new_tokens=24)
    jit.enable_to_static(captured)
    try:
        kernels.reset_launch_counts()
        done = eng.run()
        torch.cuda.synchronize()
    finally:
        jit.enable_to_static(True)
    return ({r: q.out for r, q in done.items()}, eng,
            kernels.launch_counts())


@pytest.mark.parametrize("kw", [
    dict(decode_chunk=4), dict(decode_chunk=4, overlap=True),
    dict(spec_decode_k=3), dict(spec_decode_k=3, overlap=True,
                                kv_dtype="int8"),
], ids=["chunk", "chunk_overlap", "spec", "spec_overlap_int8"])
def test_captured_engine_equals_the_eager_engine(dev, kw):
    """The engine's decode programs replay as CUDA graphs (one a kind after
    its eager first call) and give the eager engine's streams bitwise; a
    replay's paged-decode launches are counted per dispatch."""
    want, eager, _ = _serve_small(dev, False, **kw)
    got, eng, counts = _serve_small(dev, True, **kw)
    assert got == want
    graphs = {n: len(getattr(eng, f"_{n}_fn")._graphs)
              for n in ("decode", "chunk", "verify")}
    assert all(n <= 1 for n in graphs.values()) and sum(graphs.values()) >= 1
    assert not any(len(getattr(eager, f"_{n}_fn")._graphs)
                   for n in ("decode", "chunk", "verify"))
    name = ("paged_decode_attention_int8" if kw.get("kv_dtype")
            else "paged_decode_attention")
    assert counts[name] == 2 * eng.decode_steps > 0
    if "spec_decode_k" in kw:
        assert eng.spec_stats()["dispatches"] > 0


def test_generate_use_jit_replays_and_equals_eager(dev):
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, generate

    pt_seed(5)
    cfg = LlamaConfig.tiny(vocab_size=512, hidden_size=256,
                           intermediate_size=512, num_attention_heads=2,
                           num_key_value_heads=2, max_position_embeddings=512)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    ids = torch.randint(0, 512, (4, 16),
                        generator=torch.Generator().manual_seed(6)).to(dev)
    for kw in (dict(block_size=16), dict(block_size=16, decode_chunk=4),
               dict(), dict(speculative_k=3)):
        want = generate(model, ids, max_new_tokens=20, use_jit=False, **kw)
        for _ in range(3):  # decode captured in the first, prefill in the second
            assert torch.equal(generate(model, ids, max_new_tokens=20, **kw),
                               want), kw
    pt_seed(7)
    a = generate(model, ids, max_new_tokens=20, temperature=0.9, top_k=40,
                 block_size=16)
    pt_seed(7)
    b = generate(model, ids, max_new_tokens=20, temperature=0.9, top_k=40,
                 block_size=16)
    assert torch.equal(a, b)
