"""Distributed runtime (counterpart of ``paddle_tpu/distributed``), over
``torch.distributed``: one process per rank, NCCL on the card and gloo on
the CPU (or on the card when forced, for two ranks on one card).

Ported: the process groups (:mod:`.collective`), the collectives and their
stream variants, the watchdog and the flight recorder
(:mod:`.communication`), the launcher's bring-up (:mod:`.multi_controller`,
:mod:`.launch`, :mod:`.spawn`), ``init_parallel_env`` and ``DataParallel``
(:mod:`.parallel`), group-sharded stages 1-3 (:mod:`.sharding`), the
namespace's small collectives and the tensor-parallel ``split``
(:mod:`.parity`), the KV stores (:mod:`.store`), :mod:`.fleet` (the
hybrid topology, tensor and sequence parallelism, recompute, the pipeline,
MoE, segment parallelism, elasticity), the distributed checkpoint
(:mod:`.checkpoint`: ``save_state_dict``/``load_state_dict`` and the
in-RAM reshard) and :mod:`.io`. ``auto_parallel`` is a later slice.
"""
from .collective import (  # noqa: F401
    Group,
    ReduceOp,
    destroy_process_group,
    get_group,
    is_initialized,
    new_group,
)
from .communication import (  # noqa: F401
    all_gather,
    all_gather_into_tensor,
    all_gather_object,
    all_reduce,
    alltoall,
    alltoall_single,
    barrier,
    broadcast,
    get_rank_in_trace,
    p2p_sendrecv,
    ppermute,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
)
from .parallel import (  # noqa: F401
    DataParallel,
    ParallelEnv,
    get_rank,
    get_world_size,
    init_parallel_env,
    shard_map,
)
from . import fleet  # noqa: F401
from . import sharding  # noqa: F401
from .sharding import group_sharded_parallel, save_group_sharded_model  # noqa: F401
from . import store  # noqa: F401
from .store import (  # noqa: F401
    CorruptBlobError,
    FileKVStore,
    KVStore,
    MemKVStore,
    TCPKVStore,
    TCPStoreServer,
    make_store,
)
from .parity import *  # noqa: F401,F403
from .parity import __all__ as _parity_all
from . import launch  # noqa: F401
from .spawn import spawn  # noqa: F401
from . import checkpoint  # noqa: F401
from . import io  # noqa: F401
from .checkpoint import load_state_dict, save_state_dict  # noqa: F401

__all__ = [
    "Group", "ReduceOp", "destroy_process_group", "get_group",
    "is_initialized", "new_group", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_reduce", "alltoall", "alltoall_single",
    "barrier", "broadcast", "get_rank_in_trace", "p2p_sendrecv", "ppermute",
    "recv", "reduce", "reduce_scatter", "scatter", "send", "DataParallel",
    "ParallelEnv", "get_rank", "get_world_size", "init_parallel_env",
    "shard_map", "fleet", "sharding", "group_sharded_parallel",
    "save_group_sharded_model", "store", "KVStore", "MemKVStore",
    "FileKVStore", "TCPStoreServer", "TCPKVStore", "CorruptBlobError",
    "make_store", "launch", "spawn", "checkpoint", "io", "save_state_dict",
    "load_state_dict", *_parity_all]
