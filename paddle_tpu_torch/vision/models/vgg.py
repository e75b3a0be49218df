"""VGG family (counterpart of ``paddle_tpu/vision/models/vgg.py``; ref:
python/paddle/vision/models/vgg.py — the cfgs table, ``make_layers`` with
optional BatchNorm, a 4096-4096 head)."""
from __future__ import annotations

from typing import List, Union

import torch

from ... import nn
from ._layers import layer_kw, norm_kw

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg: List[Union[int, str]], batch_norm: bool = False, *,
                device=None, dtype=torch.float32, generator=None):
    kw = layer_kw(device, dtype, generator)
    layers: list = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(kernel_size=2, stride=2))
        else:
            layers.append(nn.Conv2D(in_channels, v, 3, padding=1, **kw))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, **norm_kw(kw)))
            layers.append(nn.ReLU())
            in_channels = v
    return nn.Sequential(*layers)


class VGG(torch.nn.Module):
    def __init__(self, features, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = layer_kw(device, dtype, generator)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Flatten(),
                nn.Linear(512 * 7 * 7, 4096, **kw),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, 4096, **kw),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, num_classes, **kw),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        return x


def _vgg(arch, cfg, batch_norm, pretrained, device=None, dtype=torch.float32,
         generator=None, **kwargs):
    from . import _no_pretrained

    _no_pretrained(arch, pretrained)
    kw = dict(device=device, dtype=dtype, generator=generator)
    return VGG(make_layers(cfgs[cfg], batch_norm=batch_norm, **kw), **kw,
               **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg11", "A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg13", "B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg16", "D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg19", "E", batch_norm, pretrained, **kwargs)
