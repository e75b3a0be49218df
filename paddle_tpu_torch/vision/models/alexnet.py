"""AlexNet (counterpart of ``paddle_tpu/vision/models/alexnet.py``; ref:
python/paddle/vision/models/alexnet.py — the conv/pool stack and a
4096-4096 head)."""
from __future__ import annotations

import torch

from ... import nn
from ._layers import layer_kw

__all__ = ["AlexNet", "alexnet"]


class AlexNet(torch.nn.Module):
    def __init__(self, num_classes: int = 1000, dropout: float = 0.5, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = layer_kw(device, dtype, generator)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2, **kw),
            nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(64, 192, 5, padding=2, **kw),
            nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(192, 384, 3, padding=1, **kw),
            nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1, **kw),
            nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1, **kw),
            nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
        )
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Flatten(),
                nn.Dropout(dropout),
                nn.Linear(256 * 6 * 6, 4096, **kw),
                nn.ReLU(),
                nn.Dropout(dropout),
                nn.Linear(4096, 4096, **kw),
                nn.ReLU(),
                nn.Linear(4096, num_classes, **kw),
            )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(x)
        return x


def alexnet(pretrained=False, **kwargs):
    from . import _no_pretrained

    _no_pretrained("alexnet", pretrained)
    return AlexNet(**kwargs)
