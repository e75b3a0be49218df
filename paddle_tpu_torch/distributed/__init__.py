"""Distributed runtime (counterpart of ``paddle_tpu/distributed``). Ported
so far: the KV stores (:mod:`.store`) and the collective flight recorder
(:mod:`.communication.flight_recorder`), which the disaggregated serving
slice needs. Collectives, process groups and the parallel layers are
later slices."""
from .store import (
    CorruptBlobError,
    FileKVStore,
    KVStore,
    MemKVStore,
    TCPKVStore,
    TCPStoreServer,
    make_store,
)

__all__ = ["KVStore", "MemKVStore", "FileKVStore", "TCPStoreServer",
           "TCPKVStore", "CorruptBlobError", "make_store"]
