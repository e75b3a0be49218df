"""Role makers, the ``Fleet`` front object, ``UtilBase`` and the data
generators (counterpart of ``paddle_tpu/distributed/fleet/base/
role_maker.py``; ref: python/paddle/distributed/fleet/base/role_maker.py,
fleet.py Fleet, util_factory.py UtilBase, data_generator.py).

Roles collapse to WORKER under the collective runtime (SERVER exists only
for the PS mode, a later slice). Rank and size come from
``torch.distributed`` once it is up, else from the launcher's environment
(``multi_controller.env_world``), where the reference asks its runtime for
the process index. The data generators' wire format is the reference's,
byte for byte.
"""
from __future__ import annotations

import os
from typing import List

__all__ = [
    "Role", "UserDefinedRoleMaker", "PaddleCloudRoleMaker", "UtilBase",
    "MultiSlotDataGenerator", "MultiSlotStringDataGenerator", "Fleet",
]


def _process_rank() -> int:
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank()
    from ...multi_controller import env_world

    return env_world()[1]


def _process_count() -> int:
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    from ...multi_controller import env_world

    return env_world()[0]


class Role:
    """ref: role_maker.py Role constants."""

    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class _RoleMakerBase:
    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective

    def _worker_index(self) -> int:
        return _process_rank()

    def _worker_num(self) -> int:
        return _process_count()

    def _role(self):
        return Role.WORKER

    def _is_worker(self) -> bool:
        return True

    def _is_server(self) -> bool:
        return False

    worker_index = _worker_index
    worker_num = _worker_num
    is_worker = _is_worker
    is_server = _is_server


class UserDefinedRoleMaker(_RoleMakerBase):
    """ref: role_maker.py UserDefinedRoleMaker — explicit rank/size."""

    def __init__(self, is_collective=True, init_gloo=False, current_id=0,
                 role=Role.WORKER, worker_num=1, worker_endpoints=None,
                 server_endpoints=None, **kwargs):
        super().__init__(is_collective)
        self._current_id = current_id
        self._user_role = role
        self._num = worker_num
        self._worker_endpoints = worker_endpoints or []
        self._server_endpoints = server_endpoints or []

    def _worker_index(self):
        return self._current_id

    def _worker_num(self):
        return self._num

    def _role(self):
        return self._user_role

    worker_index = _worker_index
    worker_num = _worker_num


class PaddleCloudRoleMaker(_RoleMakerBase):
    """ref: role_maker.py PaddleCloudRoleMaker — rank/size from the
    launcher environment (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM, which
    paddle_tpu_torch.distributed.launch exports beside RANK and
    WORLD_SIZE)."""

    def __init__(self, is_collective=True, **kwargs):
        super().__init__(is_collective)

    def _worker_index(self):
        if "PADDLE_TRAINER_ID" in os.environ:
            return int(os.environ["PADDLE_TRAINER_ID"])
        return super()._worker_index()

    def _worker_num(self):
        if "PADDLE_TRAINERS_NUM" in os.environ:
            return int(os.environ["PADDLE_TRAINERS_NUM"])
        return super()._worker_num()

    worker_index = _worker_index
    worker_num = _worker_num


class UtilBase:
    """ref: util_factory.py UtilBase — cross-rank host utilities."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):  # noqa: A002
        """A numpy array (or number) reduced over every worker; numpy out."""
        import numpy as np
        import torch

        from ...collective import ReduceOp
        from ...communication import _resolve, all_reduce

        op = {"sum": ReduceOp.SUM, "min": ReduceOp.MIN,
              "max": ReduceOp.MAX}[mode.lower()]
        g = _resolve(None)
        t = torch.as_tensor(np.array(input), device=g.device)
        all_reduce(t, op=op, group=g)
        return t.cpu().numpy()

    def barrier(self, comm_world="worker"):
        from ...communication import barrier

        barrier()

    def all_gather(self, input, comm_world="worker"):  # noqa: A002
        from ...communication import all_gather_object

        out: List = []
        all_gather_object(out, input)
        return out

    def get_file_shard(self, files):
        """Split a file list contiguously across workers (ref:
        util_factory.py get_file_shard)."""
        n, i = _process_count(), _process_rank()
        base, rem = divmod(len(files), n)
        begin = i * base + min(i, rem)
        return files[begin:begin + base + (1 if i < rem else 0)]

    def print_on_rank(self, message, rank_id=0):
        if _process_rank() == rank_id:
            print(message)


class MultiSlotDataGenerator:
    """PS-mode data generator (ref: data_generator.py): subclasses
    implement generate_sample(line) yielding (slot_name, [ids...])
    pairs; run_from_stdin/run_from_files emit the reference's
    slot-count-value wire format."""

    def __init__(self):
        self._proto_info = None

    def generate_sample(self, line):
        raise NotImplementedError(
            "implement generate_sample(line) -> iterator of "
            "[(slot_name, [values])] lists"
        )

    def _format(self, record) -> str:
        # wire format: "<count> <v1> ... <vk>" per slot, space-joined
        parts = []
        for _name, values in record:
            parts.append(str(len(values)))
            parts.extend(self._to_str(v) for v in values)
        return " ".join(parts)

    def _to_str(self, v):
        return str(int(v))

    def run_from_files(self, paths):
        for path in paths:
            with open(path) as f:
                for line in f:
                    gen = self.generate_sample(line.rstrip("\n"))
                    for record in gen() if callable(gen) else gen:
                        yield self._format(record)

    def run_from_stdin(self):
        import sys

        for line in sys.stdin:
            gen = self.generate_sample(line.rstrip("\n"))
            for record in gen() if callable(gen) else gen:
                sys.stdout.write(self._format(record) + "\n")


class MultiSlotStringDataGenerator(MultiSlotDataGenerator):
    """ref: data_generator.py MultiSlotStringDataGenerator — values stay
    strings on the wire."""

    def _to_str(self, v):
        return str(v)


class Fleet:
    """ref: fleet.py Fleet — the stateful front object. The module-level
    paddle_tpu_torch.distributed.fleet functions are the canonical API; this
    class wraps them so code written against `fleet.Fleet()` works."""

    def __init__(self):
        self._role_maker = None
        self.strategy = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             device=None):
        from .. import init as _init

        self._role_maker = role_maker or PaddleCloudRoleMaker(is_collective)
        self.strategy = strategy
        return _init(role_maker=role_maker, is_collective=is_collective,
                     strategy=strategy, device=device)

    def is_first_worker(self) -> bool:
        return self.worker_index() == 0

    def worker_index(self) -> int:
        return (self._role_maker or PaddleCloudRoleMaker()).worker_index()

    def worker_num(self) -> int:
        return (self._role_maker or PaddleCloudRoleMaker()).worker_num()

    def is_worker(self) -> bool:
        return True

    def is_server(self) -> bool:
        return False

    def barrier_worker(self):
        UtilBase().barrier()

    @property
    def util(self) -> UtilBase:
        return UtilBase()

    def distributed_optimizer(self, optimizer, strategy=None):
        from .. import distributed_optimizer as _do

        return _do(optimizer, strategy=strategy or self.strategy)

    def distributed_model(self, model):
        from .. import distributed_model as _dm

        return _dm(model)
