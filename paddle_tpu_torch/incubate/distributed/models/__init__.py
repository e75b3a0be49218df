"""incubate.distributed.models (ref: python/paddle/incubate/distributed/models)."""
from . import moe  # noqa: F401
