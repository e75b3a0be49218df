"""Paged (block) KV cache for serving-grade decode (counterpart of
``paddle_tpu/ops/paged_attention.py``).

- ``k_pool``/``v_pool`` are ``[kv_heads, num_blocks, block_size, head_dim]``
  pools per layer; ``block_tables`` is a ``[batch, max_blocks_per_seq]``
  int32 map from a sequence's logical block to a physical pool row, shared
  by all layers.
- Writes scatter the new tokens to ``(table[pos // bs], pos % bs)``. JAX
  returns new pools; here the pools are updated IN PLACE (the JAX engine
  donates them to the same effect), and the functions return the same
  tensors so call sites keep the reference's shape.
- Prefill reads gather the table back into a ``[batch, max_len]`` view and
  run the same masked attention as the dense path. Single-token DECODE on
  the card runs the hand-written paged-decode kernels
  (``ops/kernels/paged_decode_attention.cu``, float and int8 pools) over
  ragged and contiguous tables alike; their wrappers use the gather path
  only for tensors on the CPU.
- ``BlockManager`` is the host-side allocator, reference-counted so that
  the :class:`PrefixCache` and sequences can share blocks (adopt, fork);
  ``contiguous_tables`` is the layout ``generate`` uses.

Int8 KV (``kv_dtype="int8"``): int8 value pools plus f32 scale pools
``[kv_heads, num_blocks, block_size]``, one absmax per cached token per
head, row-indexed by the same physical block ids as the values, so a
block's scales travel with its bytes through adopt, fork and copy. Writes
quantize in the same scatter (``_kv_quantize``); reads dequantize, in the
gather for prefill; the int8 decode kernel folds each row's scale into
its score and its probability.

Block tables and ``cache_len`` stay int32 like the reference (the kernels
read them as int32); they are widened to int64 wherever torch indexes
with them.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..base.device import get_device
from ..base.dtype import to_torch_dtype
from . import kernels

__all__ = [
    "PagedLayerCache", "BlockManager", "PrefixCache", "contiguous_tables",
    "alloc_paged_kv_caches", "paged_update_kv_cache", "paged_gather_kv",
    "paged_write_kv", "paged_attention_step", "paged_decode_attention",
    "paged_decode", "paged_decode_plain", "paged_decode_int8",
    "paged_decode_int8_plain", "decode_splits",
]


class PagedLayerCache(NamedTuple):
    """One layer's paged cache: pools + the (shared) block table.

    ``contiguous`` (a Python bool) records that the table is the identity
    layout (sequence b owns blocks ``[b*n, (b+1)*n)``) — ``generate``'s
    case — which unlocks the reshape-view attention path. ``k_scale`` /
    ``v_scale`` are the int8 pools' scale pools ``[kv_heads, num_blocks,
    block_size]`` (None for float pools)."""

    k_pool: torch.Tensor  # [kv_heads, num_blocks, block_size, head_dim]
    v_pool: torch.Tensor
    block_tables: torch.Tensor  # [batch, max_blocks_per_seq] int32
    contiguous: bool = False
    k_scale: Optional[torch.Tensor] = None  # [kv_heads, num_blocks, block_size]
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def contiguous_tables(batch: int, max_len: int, block_size: int) -> np.ndarray:
    """Dense layout: sequence b owns blocks [b*n, (b+1)*n)."""
    per_seq = -(-max_len // block_size)
    return np.arange(batch * per_seq, dtype=np.int32).reshape(batch, per_seq)


class BlockManager:
    """Host-side free-list allocator for serving. Blocks are
    reference-counted: a sequence that ``adopt``\\s a cached prefix block
    and the :class:`PrefixCache` that pinned it each hold one reference,
    and a block returns to the free list only when its last reference
    drops. A shared block is read-only; an owner that must write into one
    calls :meth:`fork` first (copy-on-write). ``free_blocks`` counts
    physical blocks, so a shared block counts once."""

    def __init__(self, num_blocks: int, block_size: int):
        self.block_size = block_size
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))
        self._owned: Dict[object, List[int]] = {}
        self._refs: Dict[int, int] = {}  # physical block -> live refs

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        """Live references on a physical block (0 = on the free list)."""
        return self._refs.get(int(block), 0)

    def blocks_for(self, num_tokens: int) -> int:
        """Blocks needed to hold ``num_tokens`` positions (ceil)."""
        return -(-int(num_tokens) // self.block_size)

    def can_allocate(self, seq_id, num_tokens: int) -> bool:
        """Would ``allocate(seq_id, num_tokens)`` succeed right now?
        Blocks the sequence already owns (adopted ones included) count."""
        owned = len(self._owned.get(seq_id, []))
        return self.blocks_for(num_tokens) - owned <= len(self._free)

    def allocate(self, seq_id, num_tokens: int) -> List[int]:
        """Ensure seq_id owns enough blocks for num_tokens; returns the
        full block list in logical order (adopted blocks first)."""
        owned = self._owned.setdefault(seq_id, [])
        need = -(-num_tokens // self.block_size) - len(owned)
        if need > len(self._free):
            raise RuntimeError(
                f"paged KV cache exhausted: need {need} blocks, "
                f"{len(self._free)} free (of {self.num_blocks})")
        for _ in range(max(need, 0)):
            b = self._free.pop()
            self._refs[b] = 1
            owned.append(b)
        return list(owned)

    def adopt(self, seq_id, blocks: List[int]) -> None:
        """Append SHARED blocks to ``seq_id``'s logical block list (the
        prefix-cache hit path): each gains one reference. Runs before
        :meth:`allocate` so the adopted prefix keeps logical positions
        ``0..len(blocks)-1``."""
        owned = self._owned.setdefault(seq_id, [])
        for b in blocks:
            b = int(b)
            if self._refs.get(b, 0) <= 0:
                raise RuntimeError(
                    f"adopt of dead block {b}: it has no live reference "
                    "(was it evicted between lookup and adopt?)")
            self._refs[b] += 1
            owned.append(b)

    def fork(self, seq_id, logical_index: int) -> Tuple[int, int]:
        """Copy-on-write: make ``seq_id``'s ``logical_index``-th block
        private before a write. Returns ``(old, new)`` physical ids, equal
        when the block was already private; otherwise the caller copies
        the pool contents ``old -> new`` before writing."""
        owned = self._owned[seq_id]
        old = owned[logical_index]
        if self._refs.get(old, 0) <= 1:
            return old, old
        if not self._free:
            raise RuntimeError(
                "paged KV cache exhausted: no free block for a "
                "copy-on-write fork")
        new = self._free.pop()
        self._refs[new] = 1
        self._refs[old] -= 1
        owned[logical_index] = new
        return old, new

    def ref(self, block: int) -> None:
        """Take an extra reference on a live block (the PrefixCache's
        pin). Never resurrects a freed block."""
        b = int(block)
        if self._refs.get(b, 0) <= 0:
            raise RuntimeError(f"ref of dead block {b}")
        self._refs[b] += 1

    def release(self, block: int) -> bool:
        """Drop one reference; True when the block hit the free list."""
        b = int(block)
        refs = self._refs.get(b, 0)
        if refs <= 0:
            raise RuntimeError(f"release of dead block {b}")
        if refs == 1:
            del self._refs[b]
            self._free.append(b)
            return True
        self._refs[b] = refs - 1
        return False

    def free_sequence(self, seq_id) -> None:
        for b in self._owned.pop(seq_id, []):
            self.release(b)

    def owned_blocks(self, seq_id) -> List[int]:
        """The sequence's current logical block list (post-fork ids)."""
        return list(self._owned.get(seq_id, []))

    def accounting(self) -> dict:
        """Conservation snapshot: ``free + len(refs) == total``."""
        return {
            "total": int(self.num_blocks),
            "free": len(self._free),
            "refs": {int(b): int(c) for b, c in self._refs.items()},
            "owned": {k: [int(b) for b in v] for k, v in self._owned.items()},
        }

    def table_row(self, seq_id, max_blocks_per_seq: int,
                  fill: int = 0) -> np.ndarray:
        """The sequence's block-table row, padded with ``fill`` (the
        serving engine passes its trash block id)."""
        row = np.full((max_blocks_per_seq,), fill, np.int32)
        owned = self._owned.get(seq_id, [])
        row[: len(owned)] = owned
        return row


class _PrefixNode:
    __slots__ = ("children", "block", "stamp", "parent", "key")

    def __init__(self, parent=None, key=None, block: Optional[int] = None):
        self.children: Dict[tuple, "_PrefixNode"] = {}
        self.block = block  # physical block id (None in matcher mode)
        self.stamp = 0  # LRU clock value of the last touch
        self.parent = parent
        self.key = key


class PrefixCache:
    """Radix-style prefix index over prompt tokens at block granularity:
    an edge label is one block's worth of token ids, and only FULL blocks
    enter the tree (a partial tail block keeps receiving decode writes).

    - manager mode (``manager=`` a :class:`BlockManager`): each node pins
      one physical block through ``manager.ref``, so a finished prompt's
      blocks survive ``free_sequence`` and later identical prefixes adopt
      them; ``evict`` releases LRU leaves whose pin is the last reference.
    - matcher mode (``manager=None``): the trie alone, bounded by
      ``max_nodes``.

    ``lookup``/``insert`` take an optional namespace ``ns`` selecting an
    independent root (None = the default root); the LRU clock, the leaf
    registry and eviction are global across namespaces."""

    def __init__(self, block_size: int, manager: Optional[BlockManager] = None,
                 max_nodes: Optional[int] = None):
        self.block_size = int(block_size)
        self.manager = manager
        self.max_nodes = max_nodes
        self.root = _PrefixNode()
        self._ns_roots: Dict[str, _PrefixNode] = {}
        self._clock = 0
        self._nodes = 0
        # incremental leaf registry (id(node) -> node), so eviction never
        # walks the whole tree
        self._leaf_reg: Dict[int, _PrefixNode] = {}
        self.hits = 0
        self.lookups = 0
        self.hit_tokens = 0
        self.evicted_blocks = 0

    def _chunks(self, tokens) -> List[tuple]:
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        bs = self.block_size
        return [tuple(toks[i * bs:(i + 1) * bs]) for i in range(len(toks) // bs)]

    def _touch(self, node: _PrefixNode) -> None:
        self._clock += 1
        node.stamp = self._clock

    def _root_for(self, ns) -> _PrefixNode:
        if ns is None:
            return self.root
        root = self._ns_roots.get(ns)
        if root is None:
            root = self._ns_roots[ns] = _PrefixNode()
        return root

    def lookup(self, tokens, ns=None) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens``: ``(n_tokens, blocks)``,
        ``n_tokens`` a multiple of ``block_size`` and ``blocks`` the
        pinned physical blocks in logical order (empty in matcher mode).
        Touches the matched path for LRU."""
        self.lookups += 1
        node, blocks, n = self._root_for(ns), [], 0
        for key in self._chunks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            self._touch(child)
            if child.block is not None:
                blocks.append(child.block)
            n += self.block_size
            node = child
        if n:
            self.hits += 1
            self.hit_tokens += n
        return n, blocks

    def insert(self, tokens, blocks: Optional[List[int]] = None,
               ns=None) -> int:
        """Register ``tokens``' full blocks; returns the number of new
        nodes. Idempotent: existing nodes keep their pinned block. Each
        new node pins its block (manager mode), so ``blocks`` must cover
        every full chunk there."""
        chunks = self._chunks(tokens)
        if self.manager is not None and (blocks is None
                                         or len(blocks) < len(chunks)):
            raise ValueError(
                f"insert needs one block per full chunk: {len(chunks)} "
                f"chunks, {0 if blocks is None else len(blocks)} blocks")
        node, created = self._root_for(ns), 0
        for i, key in enumerate(chunks):
            child = node.children.get(key)
            if child is None:
                block = None
                if self.manager is not None:
                    block = int(blocks[i])
                    self.manager.ref(block)
                child = _PrefixNode(parent=node, key=key, block=block)
                node.children[key] = child
                self._nodes += 1
                created += 1
                self._leaf_reg.pop(id(node), None)  # node grew a child
                self._leaf_reg[id(child)] = child
            self._touch(child)
            node = child
        if self.max_nodes is not None:
            self._evict_nodes(self._nodes - self.max_nodes)
        return created

    # -- eviction --------------------------------------------------------
    def _leaves(self) -> List[_PrefixNode]:
        return list(self._leaf_reg.values())

    def _drop_leaf(self, leaf: _PrefixNode) -> bool:
        """Remove one leaf; True when its block became free."""
        freed = False
        if leaf.block is not None and self.manager is not None:
            freed = self.manager.release(leaf.block)
            if freed:
                self.evicted_blocks += 1
        del leaf.parent.children[leaf.key]
        self._nodes -= 1
        self._leaf_reg.pop(id(leaf), None)
        parent = leaf.parent
        # namespace roots (key is None) never enter the leaf registry
        if parent.key is not None and not parent.children:
            self._leaf_reg[id(parent)] = parent
        return freed

    def _evict_nodes(self, n: int) -> None:
        while n > 0 and self._nodes > 0:
            self._drop_leaf(min(self._leaves(), key=lambda x: x.stamp))
            n -= 1

    def evict(self, need_blocks: int) -> int:
        """Release LRU leaves until ``need_blocks`` blocks hit the free
        list, dropping only leaves whose pin is the last reference (a
        leaf shared with a live sequence frees nothing now). Returns the
        blocks freed, which may fall short of ``need_blocks``."""
        freed = 0
        while freed < need_blocks and self._nodes > 0:
            sole = [lf for lf in self._leaves()
                    if lf.block is not None
                    and self.manager.refcount(lf.block) == 1]
            if not sole:
                break
            if self._drop_leaf(min(sole, key=lambda x: x.stamp)):
                freed += 1
        return freed

    def clear(self) -> None:
        while self._nodes > 0:
            self._drop_leaf(min(self._leaves(), key=lambda x: x.stamp))

    @property
    def nodes(self) -> int:
        return self._nodes

    def stats(self) -> dict:
        return {
            "nodes": self._nodes,
            "namespaces": 1 + len(self._ns_roots),
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "evicted_blocks": self.evicted_blocks,
        }


def alloc_paged_kv_caches(num_layers: int, batch: int, max_len: int,
                          num_kv_heads: int, head_dim: int, dtype,
                          block_size: int = 64,
                          num_blocks: Optional[int] = None,
                          tables: Optional[np.ndarray] = None,
                          kv_dtype: Optional[str] = None,
                          device=None) -> List[PagedLayerCache]:
    """Per-layer paged caches with a shared block table (zeroed pools).
    ``kv_dtype="int8"`` allocates int8 value pools plus f32 scale pools;
    ``dtype`` then only sets the dtype reads dequantize into."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
    dev = get_device(device)
    dtype = to_torch_dtype(dtype)
    per_seq = -(-max_len // block_size)
    if tables is None:
        tables = contiguous_tables(batch, max_len, block_size)
    tables = np.asarray(tables, np.int32)
    is_contig = bool(
        tables.shape == (batch, per_seq)
        and np.array_equal(tables, contiguous_tables(batch, max_len, block_size)))
    if num_blocks is None:
        num_blocks = int(tables.max()) + 1
    tables_t = torch.from_numpy(tables).to(dev)
    shape = (num_kv_heads, num_blocks, block_size, head_dim)
    pool_dt = torch.int8 if kv_dtype == "int8" else dtype
    caches = []
    for _ in range(num_layers):
        pools = [torch.zeros(shape, dtype=pool_dt, device=dev) for _ in range(2)]
        if kv_dtype == "int8":
            pools += [torch.zeros(shape[:3], dtype=torch.float32, device=dev)
                      for _ in range(2)]
        caches.append(PagedLayerCache(pools[0], pools[1], tables_t, is_contig,
                                      *pools[2:]))
    return caches


# int8 KV convention of the TPU paged-attention kernel's quantization
# utilities (MAX_INT8 = 127.5, dequant = q * amax / 127.5). The clip keeps
# the amax element itself from rounding to +128 and wrapping in int8.
_KV_QMAX = 127.5


def _kv_quantize(x: torch.Tensor):
    """``[..., D]`` float -> (int8 values, per-row amax ``[...]`` f32):
    amax over head_dim in f32 floored at 1e-8, ``x * (127.5 / h)``,
    round half to even, clip to +-127."""
    xf = x.float()
    h = xf.abs().amax(dim=-1).clamp_min(1e-8)
    q = torch.round(xf * (_KV_QMAX / h[..., None])).clamp(-127, 127)
    return q.to(torch.int8), h


def _kv_dequantize(q: torch.Tensor, h: torch.Tensor, dtype) -> torch.Tensor:
    """Invert :func:`_kv_quantize`: ``q * (h / 127.5)`` in f32, cast to
    ``dtype``; ``h`` broadcasts over head_dim."""
    return (q.float() * (h[..., None] / _KV_QMAX)).to(dtype)


def _validate_cache_len(cl, b: int, device) -> torch.Tensor:
    """Single source of truth for the scalar-or-[B] cache_len contract."""
    cl = torch.as_tensor(cl, device=device)
    if cl.dim() not in (0, 1) or (cl.dim() == 1 and tuple(cl.shape) != (b,)):
        raise ValueError(
            f"cache_len must be a scalar or [batch]={b} array, got "
            f"shape {tuple(cl.shape)}")
    return cl


def _per_seq_positions(cl, b: int, s: int, device) -> torch.Tensor:
    """[B, s] int64 write positions from a scalar or per-sequence [B] start."""
    cl = _validate_cache_len(cl, b, device).long()
    ar = torch.arange(s, device=device)
    if cl.dim() == 0:
        return (cl + ar).expand(b, s)
    return cl[:, None] + ar[None, :]


def _write_positions(tables, cl, b: int, s: int, bs: int):
    """(phys, off, valid) [B, s] scatter targets. Padded lanes can run past
    the table row (a chunk tail near max_len, or a whole-prompt prefill
    starting at a prefix-cache hit's offset); the gather index is clamped
    explicitly (torch's gather does not clamp) and ``valid`` marks the
    lanes inside the row — the reference routes the others past the pool
    so its scatter drops them."""
    positions = _per_seq_positions(cl, b, s, tables.device)
    logical = positions // bs
    off = positions % bs
    nbt = tables.shape[1]
    phys = torch.gather(tables.long(), 1, logical.clamp(max=nbt - 1))
    return phys, off, logical < nbt


def paged_write_kv(kk, vv, k_pool, v_pool, tables, cl, s: int,
                   k_scale=None, v_scale=None):
    """Scatter s new tokens (starting at position ``cl``, scalar or [B])
    into the pools, in place; returns the (same) pools. With int8 pools
    pass the scale pools: the new tokens quantize in the same scatter and
    ``(k_pool, v_pool, k_scale, v_scale)`` comes back.

    ``index_put_`` has no out-of-bounds drop, so lanes past the table row
    are pointed at their row's first cell (block ``table[b, 0]``, offset 0)
    and write back what is already stored there — for int8 pools the
    stored bytes and scale themselves, never a requantized value. That
    cell may be a shared prefix block; its contents stay bitwise the same.
    No in-bounds lane of the same call writes that cell unless the write
    is wider than the whole table, which is refused. This keeps the write
    free of a host sync."""
    b = kk.shape[0]
    bs = k_pool.shape[2]
    if s > tables.shape[1] * bs:
        raise ValueError(
            f"write of {s} tokens is wider than the block table "
            f"({tables.shape[1]} blocks of {bs})")
    phys, off, valid = _write_positions(tables, cl, b, s, bs)
    first = tables[:, :1].long().expand(b, s)
    phys = torch.where(valid, phys, first)
    off = torch.where(valid, off, torch.zeros_like(off))
    keep = valid[None]  # [1, B, s]

    def put(pool, vals):  # vals [B, s, kvh, ...] in the pool's dtype
        vals = vals.movedim(2, 0)  # [kvh, B, s, ...]
        k = keep.reshape(keep.shape + (1,) * (vals.dim() - 3))
        pool[:, phys, off] = torch.where(k, vals, pool[:, phys, off])

    if k_scale is not None:
        (qk, hk), (qv, hv) = _kv_quantize(kk), _kv_quantize(vv)
        for pool, vals in ((k_pool, qk), (v_pool, qv), (k_scale, hk),
                           (v_scale, hv)):
            put(pool, vals.to(pool.dtype))
        return k_pool, v_pool, k_scale, v_scale
    put(k_pool, kk.to(k_pool.dtype))
    put(v_pool, vv.to(v_pool.dtype))
    return k_pool, v_pool


def paged_gather_kv(k_pool, v_pool, tables, contiguous: bool = False,
                    k_scale=None, v_scale=None, out_dtype=None):
    """[B, max_blocks] tables -> padded [B, max_blocks*bs, kvh, D] views.
    ``contiguous=True`` replaces the gather with a reshape of the pools.
    With int8 pools (scales passed) the views come back dequantized to
    ``out_dtype`` (default f32); the scales gather through the same
    table."""
    b, nb = tables.shape
    kvh, _, bs, d = k_pool.shape
    pools = [k_pool, v_pool] + ([k_scale, v_scale] if k_scale is not None else [])
    if contiguous and k_pool.shape[1] == b * nb:
        views = [p.reshape(kvh, b, nb * bs, *p.shape[3:]).movedim(0, 2)
                 for p in pools]
    else:
        idx = tables.long()
        views = [p[:, idx].movedim(0, 3).reshape(b, nb * bs, kvh, *p.shape[3:])
                 for p in pools]
    if k_scale is None:
        return views[0], views[1]
    dt = out_dtype or torch.float32
    return (_kv_dequantize(views[0], views[2], dt),
            _kv_dequantize(views[1], views[3], dt))


def paged_update_kv_cache(kk, vv, k_pool, v_pool, tables, cl, s: int,
                          contiguous: bool = False, k_scale=None,
                          v_scale=None):
    """Scatter + gather protocol for PREFILL: returns
    ``(k_pool, v_pool, kc_view, vc_view, mask)`` with the ``[B, 1, s,
    max_len]`` causal mask of the dense ``update_kv_cache``. With int8
    pools (scales passed) the views come back dequantized to ``kk``'s
    dtype and the return grows to ``(k_pool, v_pool, k_scale, v_scale,
    kc, vc, mask)``."""
    pools = paged_write_kv(kk, vv, k_pool, v_pool, tables, cl, s,
                           k_scale=k_scale, v_scale=v_scale)
    kc, vc = paged_gather_kv(k_pool, v_pool, tables, contiguous=contiguous,
                             k_scale=k_scale, v_scale=v_scale,
                             out_dtype=kk.dtype)
    max_len = kc.shape[1]
    q_pos = _per_seq_positions(cl, kk.shape[0], s, kk.device)
    mask = (torch.arange(max_len, device=kk.device)[None, None, None, :]
            <= q_pos[:, None, :, None])
    return (*pools, kc, vc, mask)


def paged_attention_step(q, k, v, cache: PagedLayerCache, cur_len, s: int,
                         rope_fn=None):
    """Shared model-side paged-cache step. q/k/v ``[B, s, H|kvh, D]``;
    ``rope_fn(qq, kk, cl) -> (qq, kk)`` applies positional rotation.

    - decode (s == 1): returns ``(out [B, 1, H, D], cache)``;
    - prefill (s > 1): returns ``(q, kc, vc, mask, cache)`` and the caller
      runs its own attention over the gathered (dequantized) view.
    The pools in ``cache`` (and its scale pools) are updated in place."""
    cl = _validate_cache_len(cur_len, q.shape[0], q.device)
    if rope_fn is not None:
        q, k = rope_fn(q, k, cl)
    scales = dict(k_scale=cache.k_scale, v_scale=cache.v_scale)
    if s == 1:
        paged_write_kv(k, v, cache.k_pool, cache.v_pool, cache.block_tables,
                       cl, 1, **scales)
        out = paged_decode_attention(q, cache.k_pool, cache.v_pool,
                                     cache.block_tables, cl,
                                     contiguous=cache.contiguous, **scales)
        return out, cache
    *_, kc, vc, mask = paged_update_kv_cache(
        k, v, cache.k_pool, cache.v_pool, cache.block_tables, cl, s,
        contiguous=cache.contiguous, **scales)
    return q, kc, vc, mask, cache


def _decode_mask(cl, max_len: int, device):
    return (torch.arange(max_len, device=device)[None, :]
            <= cl.reshape(-1, 1))[:, None, None, :]


def paged_decode_plain(q, k_pool, v_pool, tables, cache_len,
                       contiguous: bool = False) -> torch.Tensor:
    """Plain version of the paged-decode kernel: the reference's gather +
    ``_naive_attention`` path (logits scaled by 1/sqrt(D) in f32 after a
    product in q's dtype)."""
    from ..nn.functional.attention import _naive_attention

    cl = _validate_cache_len(cache_len, q.shape[0], q.device)
    kc, vc = paged_gather_kv(k_pool, v_pool, tables, contiguous=contiguous)
    return _naive_attention(q, kc, vc, _decode_mask(cl, kc.shape[1], q.device),
                            False)


def paged_decode_int8_plain(q, k_pool, v_pool, k_scale, v_scale, tables,
                            cache_len, contiguous: bool = False) -> torch.Tensor:
    """Plain version of the int8 paged-decode kernel: the reference's
    off-TPU path — gather, dequantize ``q * (h / 127.5)`` to q's dtype,
    ``_naive_attention``."""
    from ..nn.functional.attention import _naive_attention

    cl = _validate_cache_len(cache_len, q.shape[0], q.device)
    kc, vc = paged_gather_kv(k_pool, v_pool, tables, contiguous=contiguous,
                             k_scale=k_scale, v_scale=v_scale,
                             out_dtype=q.dtype)
    return _naive_attention(q, kc, vc, _decode_mask(cl, kc.shape[1], q.device),
                            False)


def _check_decode_args(name: str, q, k_pool, v_pool, tables):
    b, s, h, d = q.shape
    kvh, _, _, dk = k_pool.shape
    if s != 1 or dk != d or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if d not in kernels.HEAD_DIMS or h % kvh != 0:
        raise ValueError(f"{name} kernel takes head_dim in {kernels.HEAD_DIMS} "
                         f"and kv heads dividing q heads; got D={d}, H={h}, "
                         f"KVH={kvh}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError(f"{name}: pools must be contiguous")
    if tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"{name}: tables {tuple(tables.shape)} for B={b}")


# the decode kernels' grid: enough blocks to fill every SM this many times
# over, whatever the lengths; and the kernel's limits on a split
_DECODE_BLOCKS_PER_SM = 16
_MAX_SPLITS = 64
_MAX_SPLIT_PAGES = 64
# per device: the kernels' uint32 tickets, one per (sequence, head), zero
# between calls (each call returns the ones it takes to zero). A captured
# CUDA graph holds the address it was captured with, so a buffer that is
# outgrown is kept alive in _retired_tickets, never freed
_tickets: Dict[torch.device, torch.Tensor] = {}
_retired_tickets: List[torch.Tensor] = []


def decode_splits(pages: int, batch: int, heads: int, sms: int
                  ) -> Tuple[int, int]:
    """``(splits, pages_per_split)`` of the decode kernels' grid (splits,
    heads, batch), from host-known shapes alone: enough page-aligned
    splits of the ``pages``-wide table row that the grid holds
    ``_DECODE_BLOCKS_PER_SM`` blocks per SM, at most one split per page;
    the splits cover the row and none is empty of pages."""
    if pages > _MAX_SPLITS * _MAX_SPLIT_PAGES:
        raise ValueError(f"paged decode kernels take at most "
                         f"{_MAX_SPLITS * _MAX_SPLIT_PAGES} pages a row; got "
                         f"{pages}")
    want = -(-sms * _DECODE_BLOCKS_PER_SM // (batch * heads))
    splits = max(min(pages, want, _MAX_SPLITS), -(-pages // _MAX_SPLIT_PAGES))
    pps = -(-pages // splits)
    return -(-pages // pps), pps


def _decode_tickets(device: torch.device, n: int) -> torch.Tensor:
    t = _tickets.get(device)
    if t is None or t.numel() < n:
        if t is not None:
            _retired_tickets.append(t)
        t = _tickets[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return t


def _launch_decode(name: str, symbol: str, q, pools, tables, cache_len):
    """Shared launch of the two paged-decode kernels: ``pools`` is
    ``(k, v)`` or ``(k, v, k_scale, v_scale)``; returns ``[B, 1, H, D]``.
    Allocates the kernel's f32 workspace ``[B, H, splits, D + 2]`` when the
    row takes more than one split."""
    b, _, h, d = q.shape
    kvh, nb, bs, _ = pools[0].shape
    code = kernels.dtype_code(name, q.dtype)
    qc = q.reshape(b, h, d).contiguous()
    if qc.data_ptr() % 16:  # the kernels load q in 16-byte pieces
        qc = qc.clone()
    tbl = tables.to(torch.int32).contiguous()
    cl = _validate_cache_len(cache_len, b, q.device)
    cl = cl.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    pages = tbl.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits, pps = decode_splits(pages, b, h, sms)
    partials = tickets = None
    if splits > 1:
        partials = torch.empty((b, h, splits, d + 2), dtype=torch.float32,
                               device=q.device)
        tickets = _decode_tickets(q.device, b * h)
    lib = kernels.load("paged_decode_attention")
    err = getattr(lib, symbol)(
        code, qc.data_ptr(), *(p.data_ptr() for p in pools), tbl.data_ptr(),
        cl.data_ptr(), cl.dim(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(), b, h, kvh, nb, bs,
        pages, d, splits, pps, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(name, err)
    return out.reshape(b, 1, h, d)


@kernels.kernel_wrapper("paged_decode_attention")
def paged_decode(q, k_pool, v_pool, tables, cache_len) -> torch.Tensor:
    """Kernel wrapper: single-token decode over ragged block tables.
    q ``[B, 1, H, D]`` (unscaled; the kernel pre-scales it by 1/sqrt(D) in
    q's dtype like the TPU kernel path), pools ``[kvh, blocks, bs, D]``,
    tables ``[B, pages]``, cache_len scalar or ``[B]`` (each row attends
    over ``cache_len + 1`` tokens) -> ``[B, 1, H, D]``. One launch per
    call: the kernel splits each row into page-aligned pieces
    (:func:`decode_splits`) and merges them itself. CPU tensors take
    :func:`paged_decode_plain`; CUDA tensors launch the kernel or raise.
    Launches on one stream at a time per device (they share the kernel's
    tickets)."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, tables, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    _check_decode_args("paged_decode", q, k_pool, v_pool, tables)
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise ValueError("paged_decode: q and pools must share one dtype")
    out = _launch_decode("paged_decode_attention",
                         "paged_decode_attention_launch", q,
                         (k_pool, v_pool), tables, cache_len)
    paged_decode.launches += 1
    return out


@kernels.kernel_wrapper("paged_decode_attention_int8")
def paged_decode_int8(q, k_pool, v_pool, k_scale, v_scale, tables,
                      cache_len) -> torch.Tensor:
    """Kernel wrapper: single-token decode over int8 pools ``[kvh, blocks,
    bs, D]`` with f32 scale pools ``[kvh, blocks, bs]``, split and merged
    like :func:`paged_decode`. The kernel folds each row's scale into its
    score and its probability, ``s_k * (q . x_k) / 127.5`` and ``(p * s_v
    / 127.5) * x_v``, where the TPU kernel dequantizes each element as
    ``(x * s) / 127.5`` before the products: the same function in f32,
    rounded at other points (an ulp of each term; the INT8_* gates hold
    it). Scores, softmax and ``P @ V`` stay in f32; q is pre-scaled by
    1/sqrt(D) in its own dtype. CPU tensors take
    :func:`paged_decode_int8_plain`; CUDA tensors launch the kernel or
    raise."""
    if q.device.type == "cpu":
        return paged_decode_int8_plain(q, k_pool, v_pool, k_scale, v_scale,
                                       tables, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_int8: unsupported device {q.device}")
    _check_decode_args("paged_decode_int8", q, k_pool, v_pool, tables)
    if not (k_pool.dtype == v_pool.dtype == torch.int8):
        raise ValueError("paged_decode_int8: pools must be int8")
    scale_shape = tuple(k_pool.shape[:3])
    for sc in (k_scale, v_scale):
        if (sc.dtype != torch.float32 or tuple(sc.shape) != scale_shape
                or not sc.is_contiguous()):
            raise ValueError(f"paged_decode_int8: scale pools must be "
                             f"contiguous f32 {scale_shape}")
    out = _launch_decode("paged_decode_attention_int8",
                         "paged_decode_attention_int8_launch", q,
                         (k_pool, v_pool, k_scale, v_scale), tables, cache_len)
    paged_decode_int8.launches += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, tables, cache_len,
                           contiguous: bool = False, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """Single-token decode attention over the paged cache. q ``[B, 1, H,
    D]``; cache_len is the position of the token being written (scalar or
    per-sequence ``[B]``); int8 pools pass their scale pools.

    Path policy: card tensors always take the kernel (:func:`paged_decode`
    or :func:`paged_decode_int8`, which read only live pages). CPU tensors
    keep the reference's off-TPU policy: ragged tables go through the
    wrapper's plain version, contiguous tables take the reshape view unless
    the GQA ratio is >= 4."""
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError("paged_decode_attention is the s == 1 decode path")
    ratio = h // max(k_pool.shape[0], 1)
    kernel = q.device.type != "cpu" or not contiguous or ratio >= 4
    if k_scale is not None:
        if kernel:
            return paged_decode_int8(q, k_pool, v_pool, k_scale, v_scale,
                                     tables, cache_len)
        return paged_decode_int8_plain(q, k_pool, v_pool, k_scale, v_scale,
                                       tables, cache_len, contiguous=True)
    if kernel:
        return paged_decode(q, k_pool, v_pool, tables, cache_len)
    return paged_decode_plain(q, k_pool, v_pool, tables, cache_len,
                              contiguous=True)
