"""paddle.distributed.io (counterpart of ``paddle_tpu/distributed/io.py``;
ref: python/paddle/distributed/io.py): persistables save/load for a
distributed program. There is no ProgramDesc: ``main_program`` is a Layer,
and its ``state_dict`` goes through ``framework.io`` (bf16 as raw
``uint16``, files either package reads). A sharded layer saves what this
rank holds; ``distributed.checkpoint.save_state_dict`` keeps the shards'
places."""
from __future__ import annotations

import os

__all__ = ["save_persistables", "load_persistables", "is_persistable"]


def is_persistable(var) -> bool:
    return bool(getattr(var, "persistable", True))


def save_persistables(executor=None, dirname="", main_program=None,
                      filename=None):
    """ref: io.py save_persistables: ``main_program`` is a Layer; saves its
    state_dict to ``dirname/filename`` (default ``persistables.pdparams``)."""
    from ..framework.io import save

    if main_program is None or not hasattr(main_program, "state_dict"):
        raise ValueError("save_persistables expects a Layer as main_program")
    os.makedirs(dirname, exist_ok=True)
    save(main_program.state_dict(),
         os.path.join(dirname, filename or "persistables.pdparams"))


def load_persistables(executor=None, dirname="", main_program=None,
                      filename=None):
    from ..framework.io import load

    if main_program is None or not hasattr(main_program, "load_state_dict"):
        raise ValueError("load_persistables expects a Layer as main_program")
    sd = load(os.path.join(dirname, filename or "persistables.pdparams"))
    # torch's load_state_dict copies into the live parameters in place
    main_program.load_state_dict(sd)
