"""Host-RAM prefix-cache tier: spill cold radix-tree blocks off HBM.

The paged KV pool (HBM) is the only home a cached prefix has today, so
prefix-cache capacity IS the HBM budget: once ``BlockManager`` runs dry
the LRU evictor throws KV away and the next identical prompt re-pays
its whole prefill. This module adds a second, much larger tier — plain
host memory (or any ``MutableMapping[str, bytes]``, e.g. a peer
``KVStore`` wrapper) — underneath the radix tree:

- **spill (write-through)**: whenever the engine registers a prompt's
  full blocks in the :class:`~paddle_tpu.ops.paged_attention.PrefixCache`
  it also exports them (``BlockManager.export_blocks`` — byte-exact for
  bf16 and int8+scales pools) and stores one self-describing frame per
  block-aligned prefix here. HBM eviction then loses nothing: the host
  copy already exists, so the evictor can stay greedy.
- **restore (read-through)**: on a prompt whose HBM radix hit is shorter
  than a spilled prefix, the engine imports the frame back into fresh
  blocks (``import_blocks``) and re-pins it in the tree — the request
  adopts it like any ordinary prefix hit.

Frames carry a CRC32 over header+payload. A corrupt frame (bit-rot,
chaos ``cache.spill``) is rejected at ``lookup`` time and treated as a
cache miss — never served as wrong tokens. The chaos site wraps the
frame bytes at ``put`` so ``corrupt``/``drop`` faults exercise exactly
the failure matrix in README §"Closed-loop fleet control".

Counterpart of ``paddle_tpu/inference/cache_tier.py``. Frames are
byte-identical to the reference's, so a frame written by either package
decodes in the other. One difference: the reference frames bfloat16
pages through ``ml_dtypes`` numpy arrays, which the port does not use.
The port carries bfloat16 pages as their raw 16-bit patterns (``uint16``
numpy arrays) and names them ``"bfloat16"`` in the frame header and in
``meta["dtype"]``; ``BlockManager.import_blocks`` reinterprets the bits.
"""
from __future__ import annotations

import json
import struct
import zlib
from collections import OrderedDict
from typing import Dict, List, MutableMapping, Optional, Tuple

import numpy as np

from ..testing import chaos as _chaos
from ..utils import resources as _res

__all__ = ["HostTier"]

_MAGIC = b"PTC1"
_SHARED_NS = "*"  # namespace for COW-shared system prompts


def _np_dtype(name: str):
    """Resolve a frame's dtype name; bfloat16 payloads decode to their raw
    16-bit patterns (``uint16``)."""
    if name == "bfloat16":
        return np.dtype(np.uint16)
    return np.dtype(name)


def _dtype_name(arr: np.ndarray, meta: dict) -> str:
    """The frame's dtype name of ``arr``: ``"bfloat16"`` for raw 16-bit
    patterns of bfloat16 pages (``meta["dtype"]`` says so), or for an
    ``ml_dtypes`` bfloat16 array; else numpy's name."""
    if arr.dtype.name == "bfloat16" or (
            arr.dtype == np.uint16 and meta.get("dtype") == "bfloat16"):
        return "bfloat16"
    return arr.dtype.name


def _raw(arr: np.ndarray) -> np.ndarray:
    """``arr`` as plain numpy: an ``ml_dtypes`` bfloat16 array becomes its
    raw ``uint16`` patterns (the same bytes)."""
    arr = np.ascontiguousarray(arr)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _key(ns: Optional[str], tokens) -> str:
    toks = np.asarray(tokens).reshape(-1).astype(np.int64)
    digest = zlib.crc32(toks.tobytes()) & 0xFFFFFFFF
    return f"kvtier/{ns or ''}/{toks.size}/{digest:08x}"


def _encode(tokens, pages: np.ndarray, scales: Optional[np.ndarray],
            meta: dict) -> bytes:
    toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
    pages_dtype = _dtype_name(pages, meta)
    pages = _raw(pages)
    header = {
        "meta": dict(meta),
        "tokens": toks,
        "pages_shape": list(pages.shape),
        "pages_dtype": pages_dtype,
    }
    payload = pages.tobytes()
    if scales is not None:
        scales_dtype = _dtype_name(scales, {})
        scales = _raw(scales)
        header["scales_shape"] = list(scales.shape)
        header["scales_dtype"] = scales_dtype
        payload += scales.tobytes()
    hjson = json.dumps(header, sort_keys=True).encode()
    body = _MAGIC + struct.pack(">I", len(hjson)) + hjson + payload
    return body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def _decode(frame: bytes):
    """-> (tokens, pages, scales, meta) or None when the frame fails
    validation (truncated, bad magic, CRC mismatch)."""
    if len(frame) < 12 or frame[:4] != _MAGIC:
        return None
    (crc,) = struct.unpack(">I", frame[-4:])
    if zlib.crc32(frame[:-4]) & 0xFFFFFFFF != crc:
        return None
    (hlen,) = struct.unpack(">I", frame[4:8])
    if len(frame) < 8 + hlen + 4:
        return None
    try:
        header = json.loads(frame[8:8 + hlen].decode())
    except ValueError:
        return None
    payload = frame[8 + hlen:-4]
    pdt = _np_dtype(header["pages_dtype"])
    pshape = tuple(header["pages_shape"])
    nbytes = int(np.prod(pshape)) * pdt.itemsize
    pages = np.frombuffer(payload[:nbytes], dtype=pdt).reshape(pshape)
    scales = None
    if "scales_shape" in header:
        sdt = _np_dtype(header["scales_dtype"])
        sshape = tuple(header["scales_shape"])
        scales = np.frombuffer(
            payload[nbytes:nbytes + int(np.prod(sshape)) * sdt.itemsize],
            dtype=sdt).reshape(sshape)
    tokens = np.asarray(header["tokens"], dtype=np.int64)
    return tokens, pages, scales, header["meta"]


class HostTier:
    """LRU byte-budgeted store of exported prefix-KV frames.

    ``backend`` is any ``MutableMapping[str, bytes]`` (default: a plain
    dict, i.e. host RAM; a peer ``KVStore`` adapter turns this into a
    remote tier with zero code change here). The index — which keys
    exist, their sizes, LRU order — is always kept locally so lookups
    probe the backend only on an index hit.
    """

    def __init__(self, capacity_bytes: Optional[int] = None,
                 backend: Optional[MutableMapping] = None):
        if capacity_bytes is not None and capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be positive or None")
        self.capacity_bytes = capacity_bytes
        self._data: MutableMapping = backend if backend is not None else {}
        self._index: "OrderedDict[str, int]" = OrderedDict()  # key -> size
        self._bytes = 0
        self.puts = 0
        self.put_drops = 0
        self.lookups = 0
        self.hits = 0
        self.corrupt_rejected = 0
        self.evictions = 0
        self._graft_ledger = _res.current()

    # -- write path ------------------------------------------------------
    def put(self, ns: Optional[str], tokens, pages, scales, meta) -> bool:
        """Store one frame for the FULL-block prefix ``tokens``.

        Idempotent per (ns, tokens). Passes the encoded frame through
        the ``cache.spill`` chaos site: ``drop`` -> not stored,
        ``corrupt`` -> stored corrupted (rejected later by CRC, i.e. a
        miss). Returns True when the frame landed in the backend.
        """
        self.puts += 1
        key = _key(ns, tokens)
        if key in self._index:  # refresh LRU only; frames are immutable
            self._index.move_to_end(key)
            return True
        frame = _encode(tokens, np.asarray(pages),
                        None if scales is None else np.asarray(scales),
                        meta)
        frame = _chaos.inject_bytes("cache.spill", frame)
        if frame is None:  # chaos drop: spill silently lost (= miss later)
            self.put_drops += 1
            return False
        if self.capacity_bytes is not None and len(frame) > self.capacity_bytes:
            self.put_drops += 1
            return False
        self._data[key] = bytes(frame)
        self._index[key] = len(frame)
        self._bytes += len(frame)
        if self._graft_ledger is not None:
            self._graft_ledger.acquire("host.frame", key)
        self._evict_to_capacity()
        return True

    def _evict_to_capacity(self) -> None:
        if self.capacity_bytes is None:
            return
        while self._bytes > self.capacity_bytes and self._index:
            key, size = self._index.popitem(last=False)  # LRU first
            self._bytes -= size
            self.evictions += 1
            if self._graft_ledger is not None:
                self._graft_ledger.release("host.frame", key)
            try:
                del self._data[key]
            except KeyError:
                pass

    def _drop(self, key: str) -> None:
        size = self._index.pop(key, None)
        if size is not None:
            self._bytes -= size
            if self._graft_ledger is not None:
                self._graft_ledger.release("host.frame", key)
        try:
            del self._data[key]
        except KeyError:
            pass

    # -- read path -------------------------------------------------------
    def lookup(self, ns: Optional[str], tokens, *, block_size: int,
               min_tokens: int = 0):
        """Longest stored block-aligned prefix of ``tokens`` strictly
        longer than ``min_tokens``. Returns ``(n_tokens, pages, scales,
        meta)`` or None. Corrupt frames are dropped from the index and
        counted in ``corrupt_rejected`` — a miss, never bad KV."""
        self.lookups += 1
        toks = np.asarray(tokens).reshape(-1)
        n_full = (int(toks.size) // int(block_size)) * int(block_size)
        for n in range(n_full, max(int(min_tokens), 0), -int(block_size)):
            key = _key(ns, toks[:n])
            if key not in self._index:
                continue
            frame = self._data.get(key)
            decoded = None if frame is None else _decode(frame)
            if decoded is None:
                self.corrupt_rejected += 1
                self._drop(key)
                continue
            f_toks, pages, scales, meta = decoded
            if f_toks.size != n or not np.array_equal(
                    f_toks, toks[:n].astype(np.int64)):
                self.corrupt_rejected += 1  # key collision/garbage: miss
                self._drop(key)
                continue
            self._index.move_to_end(key)
            self.hits += 1
            return n, pages, scales, meta
        return None

    def __len__(self) -> int:
        return len(self._index)

    def stats(self) -> dict:
        return {
            "entries": len(self._index),
            "bytes": self._bytes,
            "capacity_bytes": self.capacity_bytes,
            "puts": self.puts,
            "put_drops": self.put_drops,
            "lookups": self.lookups,
            "hits": self.hits,
            "corrupt_rejected": self.corrupt_rejected,
            "evictions": self.evictions,
        }
