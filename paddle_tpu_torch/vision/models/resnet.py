"""ResNet family (counterpart of ``paddle_tpu/vision/models/resnet.py``;
ref: python/paddle/vision/models/resnet.py — BasicBlock :35,
BottleneckBlock :94, ResNet :160 and the factory functions). The same stage
layout, downsample rules and parameter names (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer1.0.downsample.0``, ``fc``, ...), NCHW, so
``utils.load_jax_params`` and ``load_jax_buffers`` carry the reference's
weights and BatchNorm statistics over name for name.

Every model and block takes ``device=`` (default the card; ``"cpu"`` for
the CPU), ``dtype=`` and ``generator=``, and builds its layers there.
"""
from __future__ import annotations

import torch

from ... import nn
from ._layers import layer_kw, norm_kw

__all__ = [
    "ResNet", "BasicBlock", "BottleneckBlock", "resnet18", "resnet34",
    "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
    "wide_resnet101_2", "resnext50_32x4d", "resnext50_64x4d",
    "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
    "resnext152_64x4d",
]


class BasicBlock(torch.nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = layer_kw(device, dtype, generator)
        if norm_layer is None:
            norm_layer = nn.BatchNorm2D
        if groups != 1 or base_width != 64:
            raise ValueError(
                "BasicBlock only supports groups=1 and base_width=64")
        self.conv1 = nn.Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                               bias_attr=False, **kw)
        self.bn1 = norm_layer(planes, **norm_kw(kw))
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               **kw)
        self.bn2 = norm_layer(planes, **norm_kw(kw))
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(torch.nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = layer_kw(device, dtype, generator)
        if norm_layer is None:
            norm_layer = nn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width, **norm_kw(kw))
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation,
                               stride=stride, groups=groups,
                               dilation=dilation, bias_attr=False, **kw)
        self.bn2 = norm_layer(width, **norm_kw(kw))
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion, **norm_kw(kw))
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(torch.nn.Module):
    """ref: resnet.py ResNet — depth -> layout table, width multiplier and
    groups (ResNeXt)."""

    _layout = {
        18: (BasicBlock, [2, 2, 2, 2]),
        34: (BasicBlock, [3, 4, 6, 3]),
        50: (BottleneckBlock, [3, 4, 6, 3]),
        101: (BottleneckBlock, [3, 4, 23, 3]),
        152: (BottleneckBlock, [3, 8, 36, 3]),
    }

    def __init__(self, block=None, depth: int = 50, width: int = 64,
                 num_classes: int = 1000, with_pool: bool = True,
                 groups: int = 1, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = self._kw = layer_kw(device, dtype, generator)
        if block is None:
            block, layers = self._layout[depth]
        else:
            layers = self._layout[depth][1]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.groups = groups
        self.base_width = width
        self.inplanes = 64
        self.dilation = 1
        self._norm_layer = nn.BatchNorm2D

        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, **kw)
        self.bn1 = self._norm_layer(self.inplanes, **norm_kw(kw))
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes, **kw)
        del self._kw

    def _make_layer(self, block, planes, blocks, stride=1):
        kw, norm_layer = self._kw, self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, **kw),
                norm_layer(planes * block.expansion, **norm_kw(kw)),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        norm_layer, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, **kw))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(depth, pretrained, **kwargs):
    from . import _no_pretrained

    _no_pretrained(f"resnet{depth}", pretrained)
    return ResNet(depth=depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(101, pretrained, width=128, **kwargs)


# -- ResNeXt (ref: python/paddle/vision/models/resnext.py — through ResNet's
# grouped BottleneckBlock, the reference's own layout) ------------------------

def _resnext(depth, groups, width, pretrained, **kwargs):
    from . import _no_pretrained

    _no_pretrained(f"resnext{depth}_{groups}x{width}d", pretrained)
    return ResNet(block=BottleneckBlock, depth=depth, groups=groups,
                  width=width, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnext(50, 32, 4, pretrained, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnext(50, 64, 4, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnext(101, 32, 4, pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnext(101, 64, 4, pretrained, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnext(152, 32, 4, pretrained, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnext(152, 64, 4, pretrained, **kwargs)
