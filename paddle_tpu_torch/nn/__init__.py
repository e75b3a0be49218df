from . import functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers

__all__ = (["functional", "initializer", "ClipGradByGlobalNorm",
            "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
            "clip_grad_value_"] + _layers)
