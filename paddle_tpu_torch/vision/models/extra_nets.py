"""MobileNetV3, DenseNet, InceptionV3, SqueezeNet, GoogLeNet,
ShuffleNetV2 (counterpart of ``paddle_tpu/vision/models/extra_nets.py``;
ref: python/paddle/vision/models/{mobilenetv3,densenet,inceptionv3,
squeezenet,googlenet,shufflenetv2}.py — same stage layouts, channel
schedules, heads and parameter names; NCHW).

Every model takes ``device=`` (default the card; ``"cpu"`` for the CPU),
``dtype=`` and ``generator=``; its blocks build their layers with them
(``_building``). The reference's ``tensor.manipulation`` calls are torch
ops here.
"""
from __future__ import annotations

import contextlib

import torch

from ... import nn
from ._layers import layer_kw, norm_kw

__all__ = [
    "MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
    "mobilenet_v3_large", "DenseNet", "densenet121", "densenet161",
    "densenet169", "densenet201", "densenet264", "InceptionV3",
    "inception_v3", "SqueezeNet", "squeezenet1_0", "squeezenet1_1",
    "GoogLeNet", "googlenet", "ShuffleNetV2", "shufflenet_v2_x0_25",
    "shufflenet_v2_x0_33", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
    "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "shufflenet_v2_swish",
]



# -- the layers a model builds, on its device, dtype and generator -----------
_ACTIVE = []


@contextlib.contextmanager
def _building(device, dtype, generator):
    _ACTIVE.append(layer_kw(device, dtype, generator))
    try:
        yield
    finally:
        _ACTIVE.pop()


def _kw():
    return _ACTIVE[-1] if _ACTIVE else layer_kw(None, torch.float32, None)


def _Conv2D(*args, **kwargs):
    return nn.Conv2D(*args, **kwargs, **_kw())


def _BatchNorm2D(num_features):
    return nn.BatchNorm2D(num_features, **norm_kw(_kw()))


def _Linear(in_features, out_features):
    return nn.Linear(in_features, out_features, **_kw())


def concat(xs, axis):
    return torch.cat(xs, dim=axis)


def flatten(x, start_axis):
    return torch.flatten(x, start_axis)


def split(x, num, axis):
    return torch.chunk(x, num, dim=axis)


def reshape(x, shape):
    return x.reshape(shape)


def transpose(x, perm):
    return x.permute(perm)


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# ---------------------------------------------------------------------------
# MobileNetV3 (ref: mobilenetv3.py)
# ---------------------------------------------------------------------------


class _SqueezeExcite(torch.nn.Module):
    def __init__(self, ch, squeeze_factor=4):
        super().__init__()
        sq = _make_divisible(ch // squeeze_factor)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = _Conv2D(ch, sq, 1)
        self.fc2 = _Conv2D(sq, ch, 1)

    def forward(self, x):
        s = self.pool(x)
        s = nn.functional.relu(self.fc1(s))
        s = nn.functional.hardsigmoid(self.fc2(s))
        return x * s


class _InvertedResidual(torch.nn.Module):
    def __init__(self, in_ch, exp_ch, out_ch, kernel, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        act_layer = nn.Hardswish if act == "hardswish" else nn.ReLU
        if exp_ch != in_ch:
            layers += [_Conv2D(in_ch, exp_ch, 1, bias_attr=False),
                       _BatchNorm2D(exp_ch), act_layer()]
        layers += [
            _Conv2D(exp_ch, exp_ch, kernel, stride=stride,
                      padding=kernel // 2, groups=exp_ch, bias_attr=False),
            _BatchNorm2D(exp_ch), act_layer(),
        ]
        if use_se:
            layers.append(_SqueezeExcite(exp_ch))
        layers += [_Conv2D(exp_ch, out_ch, 1, bias_attr=False),
                   _BatchNorm2D(out_ch)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_V3_LARGE = [
    # k, exp, out, se, act, stride
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]

_V3_SMALL = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class _MobileNetV3(torch.nn.Module):
    def __init__(self, cfg, last_ch, scale=1.0, num_classes=1000,
                 with_pool=True, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        with _building(device, dtype, generator):
            self._build(cfg, last_ch, scale, num_classes, with_pool)

    def _build(self, cfg, last_ch, scale, num_classes, with_pool):
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_ch = _make_divisible(16 * scale)
        stem = [_Conv2D(3, in_ch, 3, stride=2, padding=1, bias_attr=False),
                _BatchNorm2D(in_ch), nn.Hardswish()]
        blocks = []
        for k, exp, out, se, act, s in cfg:
            exp_c = _make_divisible(exp * scale)
            out_c = _make_divisible(out * scale)
            blocks.append(
                _InvertedResidual(in_ch, exp_c, out_c, k, s, se, act))
            in_ch = out_c
        last_conv = _make_divisible(cfg[-1][1] * scale)
        head = [_Conv2D(in_ch, last_conv, 1, bias_attr=False),
                _BatchNorm2D(last_conv), nn.Hardswish()]
        self.features = nn.Sequential(*stem, *blocks, *head)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                _Linear(last_conv, last_ch), nn.Hardswish(),
                nn.Dropout(0.2), _Linear(last_ch, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.classifier(x)
        return x


class MobileNetV3Large(_MobileNetV3):
    """ref: mobilenetv3.py MobileNetV3Large."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_V3_LARGE, 1280, scale, num_classes, with_pool, **kw)


class MobileNetV3Small(_MobileNetV3):
    """ref: mobilenetv3.py MobileNetV3Small."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_V3_SMALL, 1024, scale, num_classes, with_pool, **kw)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    from . import _no_pretrained

    _no_pretrained("mobilenet_v3_small", pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    from . import _no_pretrained

    _no_pretrained("mobilenet_v3_large", pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)


# ---------------------------------------------------------------------------
# DenseNet (ref: densenet.py)
# ---------------------------------------------------------------------------


class _DenseLayer(torch.nn.Module):
    def __init__(self, in_ch, growth_rate, bn_size, dropout):
        super().__init__()
        self.bn1 = _BatchNorm2D(in_ch)
        self.conv1 = _Conv2D(in_ch, bn_size * growth_rate, 1, bias_attr=False)
        self.bn2 = _BatchNorm2D(bn_size * growth_rate)
        self.conv2 = _Conv2D(bn_size * growth_rate, growth_rate, 3,
                             padding=1, bias_attr=False)
        self.dropout = dropout

    def forward(self, x):
        out = self.conv1(nn.functional.relu(self.bn1(x)))
        out = self.conv2(nn.functional.relu(self.bn2(out)))
        if self.dropout:
            out = nn.functional.dropout(out, self.dropout,
                                        training=self.training)
        return concat([x, out], axis=1)


class _Transition(torch.nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.bn = _BatchNorm2D(in_ch)
        self.conv = _Conv2D(in_ch, out_ch, 1, bias_attr=False)
        self.pool = nn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(nn.functional.relu(self.bn(x))))


_DENSE_CFG = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class DenseNet(torch.nn.Module):
    """ref: densenet.py DenseNet."""

    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        with _building(device, dtype, generator):
            self._build(layers, bn_size, dropout, num_classes, with_pool)

    def _build(self, layers, bn_size, dropout, num_classes, with_pool):
        init_ch, growth, block_cfg = _DENSE_CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        feats = [_Conv2D(3, init_ch, 7, stride=2, padding=3, bias_attr=False),
                 _BatchNorm2D(init_ch), nn.ReLU(),
                 nn.MaxPool2D(3, stride=2, padding=1)]
        ch = init_ch
        for i, n in enumerate(block_cfg):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth, bn_size, dropout))
                ch += growth
            if i != len(block_cfg) - 1:
                feats.append(_Transition(ch, ch // 2))
                ch //= 2
        feats += [_BatchNorm2D(ch), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = _Linear(ch, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _densenet(layers, pretrained, **kwargs):
    from . import _no_pretrained

    _no_pretrained(f"densenet{layers}", pretrained)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)


# ---------------------------------------------------------------------------
# SqueezeNet (ref: squeezenet.py)
# ---------------------------------------------------------------------------


class _Fire(torch.nn.Module):
    def __init__(self, in_ch, squeeze, e1, e3):
        super().__init__()
        self.squeeze = _Conv2D(in_ch, squeeze, 1)
        self.e1 = _Conv2D(squeeze, e1, 1)
        self.e3 = _Conv2D(squeeze, e3, 3, padding=1)

    def forward(self, x):
        x = nn.functional.relu(self.squeeze(x))
        return concat([nn.functional.relu(self.e1(x)),
                       nn.functional.relu(self.e3(x))], axis=1)


class SqueezeNet(torch.nn.Module):
    """ref: squeezenet.py SqueezeNet (version '1.0'/'1.1')."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        with _building(device, dtype, generator):
            self._build(version, num_classes, with_pool)

    def _build(self, version, num_classes, with_pool):
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                _Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(512, 64, 256, 256),
            )
        else:
            self.features = nn.Sequential(
                _Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256),
            )
        if num_classes > 0:
            self.classifier_conv = _Conv2D(512, num_classes, 1)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = nn.functional.relu(self.classifier_conv(
                nn.functional.dropout(x, 0.5, training=self.training)))
        if self.with_pool:
            x = self.pool(x)
        return flatten(x, 1)


def squeezenet1_0(pretrained=False, **kwargs):
    from . import _no_pretrained

    _no_pretrained("squeezenet1_0", pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    from . import _no_pretrained

    _no_pretrained("squeezenet1_1", pretrained)
    return SqueezeNet("1.1", **kwargs)


# ---------------------------------------------------------------------------
# GoogLeNet (ref: googlenet.py)
# ---------------------------------------------------------------------------


class _Inception(torch.nn.Module):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = nn.Sequential(_Conv2D(in_ch, c1, 1), nn.ReLU())
        self.b2 = nn.Sequential(_Conv2D(in_ch, c3r, 1), nn.ReLU(),
                                _Conv2D(c3r, c3, 3, padding=1), nn.ReLU())
        self.b3 = nn.Sequential(_Conv2D(in_ch, c5r, 1), nn.ReLU(),
                                _Conv2D(c5r, c5, 5, padding=2), nn.ReLU())
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                _Conv2D(in_ch, proj, 1), nn.ReLU())

    def forward(self, x):
        return concat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)], axis=1)


class GoogLeNet(torch.nn.Module):
    """ref: googlenet.py GoogLeNet — returns (main, aux1, aux2) like the
    reference."""

    def __init__(self, num_classes=1000, with_pool=True, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        with _building(device, dtype, generator):
            self._build(num_classes, with_pool)

    def _build(self, num_classes, with_pool):
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _Conv2D(3, 64, 7, stride=2, padding=3), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, ceil_mode=True),
            _Conv2D(64, 64, 1), nn.ReLU(),
            _Conv2D(64, 192, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, ceil_mode=True),
        )
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.pool5 = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = _Linear(1024, num_classes)
            self.aux1_conv = _Conv2D(512, 128, 1)
            self.aux1_fc1 = _Linear(128 * 16, 1024)
            self.aux1_fc2 = _Linear(1024, num_classes)
            self.aux2_conv = _Conv2D(528, 128, 1)
            self.aux2_fc1 = _Linear(128 * 16, 1024)
            self.aux2_fc2 = _Linear(1024, num_classes)
            self.aux_pool = nn.AdaptiveAvgPool2D(4)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        aux1 = None
        aux2 = None
        if self.num_classes > 0:
            a = nn.functional.relu(self.aux1_conv(self.aux_pool(x)))
            a = nn.functional.relu(self.aux1_fc1(flatten(a, 1)))
            aux1 = self.aux1_fc2(nn.functional.dropout(
                a, 0.7, training=self.training))
        x = self.i4d(self.i4c(self.i4b(x)))
        if self.num_classes > 0:
            a = nn.functional.relu(self.aux2_conv(self.aux_pool(x)))
            a = nn.functional.relu(self.aux2_fc1(flatten(a, 1)))
            aux2 = self.aux2_fc2(nn.functional.dropout(
                a, 0.7, training=self.training))
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(nn.functional.dropout(flatten(x, 1), 0.4,
                                              training=self.training))
            return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    from . import _no_pretrained

    _no_pretrained("googlenet", pretrained)
    return GoogLeNet(**kwargs)


# ---------------------------------------------------------------------------
# InceptionV3 (ref: inceptionv3.py — stage layout per the paper/ref impl)
# ---------------------------------------------------------------------------


class _ConvBN(torch.nn.Module):
    def __init__(self, in_ch, out_ch, k, **kw):
        super().__init__()
        self.conv = _Conv2D(in_ch, out_ch, k, bias_attr=False, **kw)
        self.bn = _BatchNorm2D(out_ch)

    def forward(self, x):
        return nn.functional.relu(self.bn(self.conv(x)))


class _IncA(torch.nn.Module):
    def __init__(self, in_ch, pool_feat):
        super().__init__()
        self.b1 = _ConvBN(in_ch, 64, 1)
        self.b5 = nn.Sequential(_ConvBN(in_ch, 48, 1),
                                _ConvBN(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_ConvBN(in_ch, 64, 1),
                                _ConvBN(64, 96, 3, padding=1),
                                _ConvBN(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _ConvBN(in_ch, pool_feat, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)], axis=1)


class _IncB(torch.nn.Module):  # reduction
    def __init__(self, in_ch):
        super().__init__()
        self.b3 = _ConvBN(in_ch, 384, 3, stride=2)
        self.b3d = nn.Sequential(_ConvBN(in_ch, 64, 1),
                                 _ConvBN(64, 96, 3, padding=1),
                                 _ConvBN(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b3d(x), self.pool(x)], axis=1)


class _IncC(torch.nn.Module):
    def __init__(self, in_ch, c7):
        super().__init__()
        self.b1 = _ConvBN(in_ch, 192, 1)
        self.b7 = nn.Sequential(_ConvBN(in_ch, c7, 1),
                                _ConvBN(c7, c7, (1, 7), padding=(0, 3)),
                                _ConvBN(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(_ConvBN(in_ch, c7, 1),
                                 _ConvBN(c7, c7, (7, 1), padding=(3, 0)),
                                 _ConvBN(c7, c7, (1, 7), padding=(0, 3)),
                                 _ConvBN(c7, c7, (7, 1), padding=(3, 0)),
                                 _ConvBN(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _ConvBN(in_ch, 192, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
                      axis=1)


class _IncD(torch.nn.Module):  # reduction
    def __init__(self, in_ch):
        super().__init__()
        self.b3 = nn.Sequential(_ConvBN(in_ch, 192, 1),
                                _ConvBN(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(_ConvBN(in_ch, 192, 1),
                                _ConvBN(192, 192, (1, 7), padding=(0, 3)),
                                _ConvBN(192, 192, (7, 1), padding=(3, 0)),
                                _ConvBN(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b7(x), self.pool(x)], axis=1)


class _IncE(torch.nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.b1 = _ConvBN(in_ch, 320, 1)
        self.b3_stem = _ConvBN(in_ch, 384, 1)
        self.b3_a = _ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.b3d_stem = nn.Sequential(_ConvBN(in_ch, 448, 1),
                                      _ConvBN(448, 384, 3, padding=1))
        self.b3d_a = _ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = _ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _ConvBN(in_ch, 192, 1))

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.b3d_stem(x)
        return concat([
            self.b1(x), self.b3_a(s), self.b3_b(s),
            self.b3d_a(d), self.b3d_b(d), self.bp(x),
        ], axis=1)


class InceptionV3(torch.nn.Module):
    """ref: inceptionv3.py InceptionV3 (299x299 input)."""

    def __init__(self, num_classes=1000, with_pool=True, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        with _building(device, dtype, generator):
            self._build(num_classes, with_pool)

    def _build(self, num_classes, with_pool):
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _ConvBN(3, 32, 3, stride=2), _ConvBN(32, 32, 3),
            _ConvBN(32, 64, 3, padding=1),
            nn.MaxPool2D(3, stride=2),
            _ConvBN(64, 80, 1), _ConvBN(80, 192, 3), nn.MaxPool2D(3, stride=2),
        )
        self.blocks = nn.Sequential(
            _IncA(192, 32), _IncA(256, 64), _IncA(288, 64),
            _IncB(288),
            _IncC(768, 128), _IncC(768, 160), _IncC(768, 160), _IncC(768, 192),
            _IncD(768),
            _IncE(1280), _IncE(2048),
        )
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = _Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    from . import _no_pretrained

    _no_pretrained("inception_v3", pretrained)
    return InceptionV3(**kwargs)


# ---------------------------------------------------------------------------
# ShuffleNetV2 (ref: shufflenetv2.py)
# ---------------------------------------------------------------------------


def _channel_shuffle(x, groups):
    n, c, h, w = x.shape
    x = reshape(x, [n, groups, c // groups, h, w])
    x = transpose(x, [0, 2, 1, 3, 4])
    return reshape(x, [n, c, h, w])


class _ShuffleUnit(torch.nn.Module):
    def __init__(self, in_ch, out_ch, stride, act):
        super().__init__()
        self.stride = stride
        branch = out_ch // 2
        act_layer = nn.Swish if act == "swish" else nn.ReLU
        if stride > 1:
            self.branch1 = nn.Sequential(
                _Conv2D(in_ch, in_ch, 3, stride=stride, padding=1,
                        groups=in_ch, bias_attr=False),
                _BatchNorm2D(in_ch),
                _Conv2D(in_ch, branch, 1, bias_attr=False),
                _BatchNorm2D(branch), act_layer(),
            )
            b2_in = in_ch
        else:
            self.branch1 = None
            b2_in = in_ch // 2
        self.branch2 = nn.Sequential(
            _Conv2D(b2_in, branch, 1, bias_attr=False), _BatchNorm2D(branch),
            act_layer(),
            _Conv2D(branch, branch, 3, stride=stride, padding=1,
                    groups=branch, bias_attr=False),
            _BatchNorm2D(branch),
            _Conv2D(branch, branch, 1, bias_attr=False), _BatchNorm2D(branch),
            act_layer(),
        )

    def forward(self, x):
        if self.stride > 1:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        else:
            x1, x2 = split(x, 2, axis=1)
            out = concat([x1, self.branch2(x2)], axis=1)
        return _channel_shuffle(out, 2)


_SHUFFLE_CH = {
    0.25: (24, 24, 48, 96, 512),
    0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}


class ShuffleNetV2(torch.nn.Module):
    """ref: shufflenetv2.py ShuffleNetV2."""

    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        with _building(device, dtype, generator):
            self._build(scale, act, num_classes, with_pool)

    def _build(self, scale, act, num_classes, with_pool):
        self.num_classes = num_classes
        self.with_pool = with_pool
        chs = _SHUFFLE_CH[scale]
        act_layer = nn.Swish if act == "swish" else nn.ReLU
        self.stem = nn.Sequential(
            _Conv2D(3, chs[0], 3, stride=2, padding=1, bias_attr=False),
            _BatchNorm2D(chs[0]), act_layer(),
            nn.MaxPool2D(3, stride=2, padding=1),
        )
        stages = []
        in_ch = chs[0]
        for stage_i, repeat in enumerate((4, 8, 4)):
            out_ch = chs[stage_i + 1]
            stages.append(_ShuffleUnit(in_ch, out_ch, 2, act))
            for _ in range(repeat - 1):
                stages.append(_ShuffleUnit(out_ch, out_ch, 1, act))
            in_ch = out_ch
        self.stages = nn.Sequential(*stages)
        self.tail = nn.Sequential(
            _Conv2D(in_ch, chs[4], 1, bias_attr=False),
            _BatchNorm2D(chs[4]), act_layer(),
        )
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = _Linear(chs[4], num_classes)

    def forward(self, x):
        x = self.tail(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def _shufflenet(scale, act, name, pretrained, **kwargs):
    from . import _no_pretrained

    _no_pretrained(name, pretrained)
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet(0.25, "relu", "shufflenet_v2_x0_25", pretrained,
                       **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet(0.33, "relu", "shufflenet_v2_x0_33", pretrained,
                       **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet(0.5, "relu", "shufflenet_v2_x0_5", pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet(1.0, "relu", "shufflenet_v2_x1_0", pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet(1.5, "relu", "shufflenet_v2_x1_5", pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet(2.0, "relu", "shufflenet_v2_x2_0", pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shufflenet(1.0, "swish", "shufflenet_v2_swish", pretrained,
                       **kwargs)
