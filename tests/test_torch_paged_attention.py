"""Port parity: ``paddle_tpu_torch.ops.paged_attention`` against the JAX
package's ``paddle_tpu.ops.paged_attention`` on the CPU.

Host logic (the block allocator) must agree exactly; scatter/gather moves
f32 values without arithmetic, so it must agree exactly too; decode
attention is float math in two frameworks, held at 1e-5 in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as JPA
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops import paged_attention as TPA

ATOL = 1e-5  # f32 attention, reductions in different orders


def _ragged_tables(rng, b, per_seq, num_blocks):
    return rng.permutation(num_blocks)[: b * per_seq].reshape(
        b, per_seq).astype(np.int32)


def test_block_manager_matches_reference_exactly():
    ops = [("alloc", "a", 5), ("alloc", "b", 9), ("alloc", "a", 12),
           ("free", "a"), ("alloc", "c", 3), ("alloc", "b", 16),
           ("free", "b"), ("alloc", "d", 20), ("free", "c")]
    jm, tm = JPA.BlockManager(10, 4), TPA.BlockManager(10, 4)
    for op in ops:
        for m in (jm, tm):
            if op[0] == "alloc":
                got = m.allocate(op[1], op[2])
            else:
                m.free_sequence(op[1])
        if op[0] == "alloc":
            assert tm.owned_blocks(op[1]) == jm.owned_blocks(op[1]) == got
        assert tm.free_blocks == jm.free_blocks
        assert tm.accounting() == jm.accounting()
        assert ([tm.refcount(b) for b in range(10)]
                == [jm.refcount(b) for b in range(10)])
        for seq in "abcd":
            np.testing.assert_array_equal(tm.table_row(seq, 6, fill=99),
                                          jm.table_row(seq, 6, fill=99))
            assert tm.can_allocate(seq, 17) == jm.can_allocate(seq, 17)
    with pytest.raises(RuntimeError, match="exhausted"):
        tm.allocate("e", 400)
    with pytest.raises(RuntimeError, match="dead block"):
        tm.release(9999)


def test_contiguous_tables_match():
    np.testing.assert_array_equal(TPA.contiguous_tables(3, 10, 4),
                                  JPA.contiguous_tables(3, 10, 4))


@pytest.mark.parametrize("cl,int8", [
    (np.int32(5), False), (np.array([0, 7, 9], np.int32), False),
    (np.int32(5), True), (np.array([0, 7, 9], np.int32), True)],
    ids=["scalar", "per_seq", "scalar-int8", "per_seq-int8"])
def test_write_with_oob_lanes_and_ragged_gather_exact(cl, int8):
    """Int8 pools: the value and scale pools bitwise equal to the
    reference's after the write (out-of-bounds lanes leave the row's first
    cell's stored bytes and scale as they were), and the gathered views
    dequantized identically."""
    rng = np.random.RandomState(0)
    b, kvh, nb, bs, d, per_seq, s = 3, 2, 12, 4, 8, 3, 5
    tables = _ragged_tables(rng, b, per_seq, nb)
    kp = rng.randn(kvh, nb, bs, d).astype(np.float32)
    vp = rng.randn(kvh, nb, bs, d).astype(np.float32)
    kk = rng.randn(b, s, kvh, d).astype(np.float32)
    vv = rng.randn(b, s, kvh, d).astype(np.float32)
    pools = [kp, vp]
    if int8:  # pools already holding quantized tokens, scales included
        pools = [rng.randint(-127, 128, (kvh, nb, bs, d)).astype(np.int8)
                 for _ in range(2)]
        pools += [rng.uniform(0.1, 3, (kvh, nb, bs)).astype(np.float32)
                  for _ in range(2)]
    scales = lambda ps: dict(zip(("k_scale", "v_scale"), ps[2:]))  # noqa: E731
    # positions run to cl + 4 = 13 >= per_seq * bs = 12: lanes past the row
    jp = [jnp.asarray(p) for p in pools]
    jout = JPA.paged_write_kv(jnp.asarray(kk), jnp.asarray(vv), jp[0], jp[1],
                              jnp.asarray(tables), jnp.asarray(cl), s,
                              **scales(jp))
    tp = [torch.from_numpy(p.copy()) for p in pools]
    TPA.paged_write_kv(torch.from_numpy(kk), torch.from_numpy(vv), tp[0],
                       tp[1], torch.from_numpy(tables),
                       torch.from_numpy(np.asarray(cl)), s, **scales(tp))
    for got, want in zip(tp, jout):
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jkc, jvc = JPA.paged_gather_kv(jout[0], jout[1], jnp.asarray(tables),
                                   **scales(jout))
    tkc, tvc = TPA.paged_gather_kv(tp[0], tp[1], torch.from_numpy(tables),
                                   **scales(tp))
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(jkc))
    np.testing.assert_array_equal(tvc.numpy(), np.asarray(jvc))


def test_write_wider_than_table_is_refused():
    t = torch.zeros(1, 2, dtype=torch.int32)
    pool = torch.zeros(1, 2, 4, 8)
    kv = torch.zeros(1, 9, 1, 8)
    with pytest.raises(ValueError, match="wider than the block table"):
        TPA.paged_write_kv(kv, kv, pool, pool.clone(), t, 0, 9)


@pytest.mark.parametrize("contiguous", [False, True])
@pytest.mark.parametrize("per_seq_len", [False, True])
@pytest.mark.parametrize("heads", [(4, 2), (8, 2)], ids=["gqa2", "gqa4"])
def test_decode_attention_plain_matches_reference(contiguous, per_seq_len,
                                                  heads):
    rng = np.random.RandomState(1)
    h, kvh = heads
    b, bs, d, per_seq = 3, 4, 16, 5
    nb = b * per_seq + 2
    tables = (JPA.contiguous_tables(b, per_seq * bs, bs) if contiguous
              else _ragged_tables(rng, b, per_seq, nb))
    if contiguous:
        nb = b * per_seq  # the reshape view needs the exact pool size
    kp = rng.randn(kvh, nb, bs, d).astype(np.float32)
    vp = rng.randn(kvh, nb, bs, d).astype(np.float32)
    q = rng.randn(b, 1, h, d).astype(np.float32)
    cl = (np.array([0, 9, 19], np.int32) if per_seq_len else np.int32(13))
    want = JPA.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(cl), contiguous=contiguous)
    before = kernels.launch_counts()["paged_decode_attention"]
    got = TPA.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(np.asarray(cl)),
        contiguous=contiguous)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # CPU tensors take the plain version: no kernel launch is counted
    assert kernels.launch_counts()["paged_decode_attention"] == before


def test_prefill_update_mask_matches_reference():
    rng = np.random.RandomState(2)
    b, kvh, bs, d, per_seq, s = 2, 2, 4, 8, 4, 6
    nb = b * per_seq
    tables = _ragged_tables(rng, b, per_seq, nb)
    kp = np.zeros((kvh, nb, bs, d), np.float32)
    kk = rng.randn(b, s, kvh, d).astype(np.float32)
    cl = np.array([0, 3], np.int32)
    *_, jkc, _, jmask = JPA.paged_update_kv_cache(
        jnp.asarray(kk), jnp.asarray(kk), jnp.asarray(kp), jnp.asarray(kp),
        jnp.asarray(tables), jnp.asarray(cl), s)
    *_, tkc, _, tmask = TPA.paged_update_kv_cache(
        torch.from_numpy(kk), torch.from_numpy(kk), torch.from_numpy(kp),
        torch.from_numpy(kp.copy()), torch.from_numpy(tables),
        torch.from_numpy(cl), s)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(jkc))


@pytest.mark.parametrize("pages,batch,heads", [
    (32, 16, 16), (16, 8, 16), (32, 64, 16), (32, 1, 16), (1, 5, 8),
    (9, 5, 8), (200, 1, 1), (128, 16, 16), (4096, 1, 1)])
def test_decode_splits_cover_the_row_and_fill_the_card(pages, batch, heads):
    """The decode kernels' split of a table row, from host shapes alone:
    page-aligned splits that cover the row, none empty of pages, within the
    kernel's limits, at most one per page, and about enough to give each of
    the card's 132 SMs 16 blocks where the row has the pages for it."""
    from paddle_tpu_torch.ops.paged_attention import decode_splits

    splits, pps = decode_splits(pages, batch, heads, 132)
    assert splits * pps >= pages and (splits - 1) * pps < pages
    assert 1 <= splits <= 64 and 1 <= pps <= 64 and splits <= pages
    # rounding the pages per split up loses at most half the splits asked
    assert 2 * splits >= min(pages, -(-132 * 16 // (batch * heads)), 64)
    # phase 2's B=16 case: 8 splits of 4 pages; the engine's B=8 at
    # max_len 1024: one page each
    assert decode_splits(32, 16, 16, 132) == (8, 4)
    assert decode_splits(16, 8, 16, 132) == (16, 1)
    with pytest.raises(ValueError, match="at most 4096 pages"):
        decode_splits(4097, 1, 1, 132)
