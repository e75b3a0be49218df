"""Optimizers and learning-rate schedulers (counterpart of
``paddle_tpu/optimizer``): every optimizer of the reference, ``LBFGS``
included, and every scheduler of ``lr.py``."""
from . import lr
from .lbfgs import LBFGS
from .optimizer import (
    ASGD,
    SGD,
    Adadelta,
    Adagrad,
    Adam,
    Adamax,
    AdamW,
    L1Decay,
    L2Decay,
    Lamb,
    Momentum,
    NAdam,
    Optimizer,
    RAdam,
    RMSProp,
    Rprop,
)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "L1Decay",
           "L2Decay", "Adagrad", "Adadelta", "Adamax", "RMSProp", "Lamb",
           "NAdam", "RAdam", "Rprop", "ASGD", "LBFGS"]
