"""Containers (counterpart of ``paddle_tpu/nn/layer/container.py``):
paddle's names over torch's containers. ``Sequential`` is
``nn.Sequential`` (also built from ``(name, layer)`` pairs or an
``OrderedDict``), ``LayerList`` is ``nn.ModuleList``, ``ParameterList`` is
``nn.ParameterList`` and ``LayerDict`` is ``nn.ModuleDict``, each with the
reference's methods; sub-layers are named ``"0"``, ``"1"``, ... as in the
reference, so parameter names match across packages."""
from __future__ import annotations

import collections

from torch import nn

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(nn.Sequential):
    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            super().__init__(layers[0])
            return
        if layers and all(isinstance(x, (list, tuple)) and len(x) == 2
                          and isinstance(x[0], str) for x in layers):
            super().__init__(collections.OrderedDict(layers))
            return
        super().__init__(*layers)


class LayerList(nn.ModuleList):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)

    def extend(self, layers):
        super().extend(layers)
        return self


class ParameterList(nn.ParameterList):
    def __init__(self, parameters=None):
        super().__init__(parameters)


class LayerDict(nn.ModuleDict):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)
