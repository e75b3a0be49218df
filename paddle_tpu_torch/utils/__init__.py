from . import locks  # noqa: F401
from . import log  # noqa: F401
from .convert import load_jax_buffers, load_jax_params
from .log import get_logger

__all__ = ["load_jax_params", "load_jax_buffers", "get_logger", "locks",
           "log"]
