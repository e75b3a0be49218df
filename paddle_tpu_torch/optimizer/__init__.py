"""Optimizers and learning-rate schedulers (counterpart of
``paddle_tpu/optimizer``). The training slice carries ``SGD``, ``Momentum``,
``Adam`` and ``AdamW``; the reference's other optimizers exist by name and
raise ``NotImplementedError`` until a later slice ports them."""
from . import lr
from .optimizer import (
    ASGD,
    SGD,
    Adadelta,
    Adagrad,
    Adam,
    Adamax,
    AdamW,
    L2Decay,
    LBFGS,
    Lamb,
    Momentum,
    NAdam,
    Optimizer,
    RAdam,
    RMSProp,
    Rprop,
)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "L2Decay",
           "Adagrad", "Adadelta", "Adamax", "RMSProp", "Lamb", "NAdam",
           "RAdam", "Rprop", "ASGD", "LBFGS"]
