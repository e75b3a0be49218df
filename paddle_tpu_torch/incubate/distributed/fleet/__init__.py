"""paddle.incubate.distributed.fleet (ref: python/paddle/incubate/
distributed/fleet/__init__.py): the recompute_sequential / recompute_hybrid
re-exports over fleet's recompute."""
from ....distributed.fleet.utils.recompute import (  # noqa: F401
    recompute_hybrid,
    recompute_sequential,
)

__all__ = ["recompute_sequential", "recompute_hybrid"]
