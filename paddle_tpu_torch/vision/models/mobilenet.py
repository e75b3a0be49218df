"""MobileNet V1/V2 (counterpart of ``paddle_tpu/vision/models/mobilenet.py``;
ref: python/paddle/vision/models/mobilenetv1.py, mobilenetv2.py —
depthwise-separable stacks and inverted residuals)."""
from __future__ import annotations

import torch

from ... import nn
from ._layers import layer_kw, norm_kw

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _ConvBNReLU(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1,
                 relu6=False, *, kw):
        padding = (kernel - 1) // 2
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride=stride, padding=padding,
                      groups=groups, bias_attr=False, **kw),
            nn.BatchNorm2D(out_c, **norm_kw(kw)),
            nn.ReLU6() if relu6 else nn.ReLU(),
        )


class _DepthwiseSeparable(torch.nn.Module):
    def __init__(self, in_c, out_c, stride, *, kw):
        super().__init__()
        self.depthwise = _ConvBNReLU(in_c, in_c, 3, stride=stride,
                                     groups=in_c, kw=kw)
        self.pointwise = _ConvBNReLU(in_c, out_c, 1, kw=kw)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class MobileNetV1(torch.nn.Module):
    """ref: mobilenetv1.py MobileNetV1 — 13 depthwise-separable stages."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = layer_kw(device, dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)

        cfg = [  # (in, out, stride)
            (s(32), s(64), 1), (s(64), s(128), 2), (s(128), s(128), 1),
            (s(128), s(256), 2), (s(256), s(256), 1), (s(256), s(512), 2),
            *[(s(512), s(512), 1)] * 5,
            (s(512), s(1024), 2), (s(1024), s(1024), 1),
        ]
        layers = [_ConvBNReLU(3, s(32), 3, stride=2, kw=kw)]
        layers += [_DepthwiseSeparable(i, o, st, kw=kw) for i, o, st in cfg]
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes, **kw)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


class InvertedResidual(torch.nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = layer_kw(device, dtype, generator)
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNReLU(inp, hidden, 1, relu6=True, kw=kw))
        layers += [
            _ConvBNReLU(hidden, hidden, 3, stride=stride, groups=hidden,
                        relu6=True, kw=kw),
            nn.Conv2D(hidden, oup, 1, bias_attr=False, **kw),
            nn.BatchNorm2D(oup, **norm_kw(kw)),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(torch.nn.Module):
    """ref: mobilenetv2.py MobileNetV2 — the standard t/c/n/s table."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = layer_kw(device, dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = _make_divisible(32 * scale)
        last_channel = _make_divisible(1280 * max(1.0, scale))
        inverted = [
            # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        features = [_ConvBNReLU(3, input_channel, 3, stride=2, relu6=True,
                                kw=kw)]
        for t, c, n, s in inverted:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t, **kw))
                input_channel = out_c
        features.append(_ConvBNReLU(input_channel, last_channel, 1,
                                    relu6=True, kw=kw))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last_channel, num_classes, **kw))
        self.last_channel = last_channel

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    from . import _no_pretrained

    _no_pretrained("mobilenet_v1", pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    from . import _no_pretrained

    _no_pretrained("mobilenet_v2", pretrained)
    return MobileNetV2(scale=scale, **kwargs)
