"""fleet.utils (counterpart of ``paddle_tpu/distributed/fleet/utils/
__init__.py``): recompute. ``LocalFS`` and ``HDFSClient`` (``fs.py``) wait
for the checkpoint slice, ``DistributedInfer`` (which needs ``ps``) for the
parameter-server slice (ROADMAP A1)."""
from .recompute import recompute, recompute_sequential  # noqa: F401

__all__ = ["recompute", "recompute_sequential"]
