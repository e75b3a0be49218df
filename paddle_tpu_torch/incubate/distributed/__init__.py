"""incubate.distributed (ref: python/paddle/incubate/distributed)."""
from . import models  # noqa: F401
