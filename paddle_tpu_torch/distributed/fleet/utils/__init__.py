"""fleet.utils (counterpart of ``paddle_tpu/distributed/fleet/utils/
__init__.py``): recompute and the file systems (``LocalFS``,
``HDFSClient``). ``DistributedInfer`` (which needs ``ps``) waits for the
parameter-server slice (ROADMAP A1)."""
from .fs import HDFSClient, LocalFS  # noqa: F401
from .recompute import recompute, recompute_sequential  # noqa: F401

__all__ = ["LocalFS", "HDFSClient", "recompute", "recompute_sequential"]
