"""Port parity: block sharing (``BlockManager.adopt/fork/ref``) and the
radix ``PrefixCache`` of ``paddle_tpu_torch.ops.paged_attention`` against
the JAX package's. Host logic, so every return value, every raised error,
``stats()`` and ``accounting()`` must agree exactly at every step.
"""
import numpy as np
import pytest

from paddle_tpu.ops import paged_attention as JPA
from paddle_tpu_torch.ops import paged_attention as TPA


def _run_script(make, script):
    """Apply ``script`` (op name, args) to the object ``make()`` returns;
    returns per-step (result or error text, snapshot)."""
    obj = make()
    trace = []
    for op, *args in script:
        try:
            res = getattr(obj, op)(*args)
        except (RuntimeError, ValueError, KeyError) as e:
            res = f"{type(e).__name__}: {e}"
        trace.append((op, res, _snapshot(obj)))
    return trace


def _snapshot(obj):
    if isinstance(obj, (JPA.BlockManager, TPA.BlockManager)):
        return obj.accounting(), [obj.refcount(b) for b in range(obj.num_blocks)]
    snap = [obj.stats(), obj.nodes]
    if obj.manager is not None:
        snap.append(obj.manager.accounting())
    return snap


BLOCK_SCRIPT = [
    ("allocate", "a", 8), ("adopt", "b", [0, 1]), ("can_allocate", "b", 12),
    ("allocate", "b", 12), ("fork", "b", 0), ("fork", "a", 0),
    ("ref", 2), ("release", 2), ("fork", "b", 1), ("free_sequence", "a"),
    ("owned_blocks", "b"), ("adopt", "c", [5]), ("adopt", "c", [2]),
    ("allocate", "d", 16), ("fork", "c", 0), ("ref", 7), ("release", 7),
    ("free_sequence", "b"), ("free_sequence", "c"), ("release", 1),
    ("table_row", "d", 6, 9), ("free_sequence", "d"),
]


def test_block_sharing_script_matches_reference():
    want = _run_script(lambda: JPA.BlockManager(6, 4), BLOCK_SCRIPT)
    got = _run_script(lambda: TPA.BlockManager(6, 4), BLOCK_SCRIPT)
    for w, g in zip(want, got):
        if isinstance(w[1], np.ndarray):
            assert np.array_equal(w[1], g[1]), w[0]
            w, g = (w[0], None, w[2]), (g[0], None, g[2])
        assert g == w
    # the script reached the error paths and a real copy-on-write fork
    results = [r for _, r, _ in got]
    for text in ("dead block", "exhausted: need"):
        assert any(isinstance(r, str) and text in r for r in results), text
    assert any(isinstance(r, tuple) and r[0] != r[1] for r in results)


def _chunks(*ks):
    return np.concatenate([np.full(4, k) for k in ks])


PREFIX_SCRIPT = [
    ("insert", _chunks(1, 2, 3), [0, 1, 2]), ("lookup", _chunks(1, 2, 9)),
    ("insert", _chunks(1, 2, 3), [3, 4, 5]),  # idempotent: old pins kept
    ("insert", _chunks(1, 5), [0, 6]), ("lookup", np.arange(3)),
    ("insert", _chunks(7), [7], "tenant"), ("lookup", _chunks(7), "tenant"),
    ("lookup", _chunks(7)), ("insert", _chunks(8), None),  # missing blocks
    ("evict", 2), ("lookup", _chunks(1, 2, 3)), ("evict", 10),
    ("insert", _chunks(1, 2), [1, 2]), ("stats",), ("clear",),
    ("lookup", _chunks(1)),
]


def _pool_with_blocks(mod):
    """A manager whose sequence "s" owns blocks 0..7 (each ref 1), so the
    cache's pins are second references until "s" is freed."""
    bm = mod.BlockManager(10, 4)
    bm.allocate("s", 32)
    return bm


@pytest.mark.parametrize("free_owner", [False, True],
                         ids=["shared_leaves", "sole_leaves"])
def test_prefix_cache_script_matches_reference(free_owner):
    def make(mod):
        def build():
            bm = _pool_with_blocks(mod)
            pc = mod.PrefixCache(4, manager=bm)
            if free_owner:  # evict may only drop leaves it holds alone
                pc.free_owner = lambda: bm.free_sequence("s")
            return pc
        return build

    script = PREFIX_SCRIPT[:9] + ([("free_owner",)] if free_owner else []) \
        + PREFIX_SCRIPT[9:]
    want = _run_script(make(JPA), script)
    got = _run_script(make(TPA), script)
    assert got == want
    evicted = want[-1][2][0]["evicted_blocks"]
    assert evicted > 0 if free_owner else evicted == 0


def test_matcher_mode_bounds_nodes_like_reference():
    script = [("insert", _chunks(i, i + 1)) for i in range(6)]
    script += [("lookup", _chunks(5, 6)), ("lookup", _chunks(0, 1)),
               ("insert", _chunks(0, 1, 2)), ("stats",)]
    want = _run_script(lambda: JPA.PrefixCache(4, max_nodes=5), script)
    got = _run_script(lambda: TPA.PrefixCache(4, max_nodes=5), script)
    assert got == want
    assert got[-1][2][1] == 5
