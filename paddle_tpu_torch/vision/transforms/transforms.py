"""Class transforms (counterpart of
``paddle_tpu/vision/transforms/transforms.py``; ref:
python/paddle/vision/transforms/transforms.py).

Random parameters draw from a host numpy RNG seeded off the port's default
generator (reproducible through ``paddle_tpu_torch.seed``; the draws are
not the reference's, whose stream is JAX's).
"""
from __future__ import annotations

import numbers
import random as _pyrandom
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from . import functional as F

__all__ = [
    "BaseTransform", "Compose", "ToTensor", "Resize", "RandomResizedCrop",
    "CenterCrop", "RandomHorizontalFlip", "RandomVerticalFlip", "Normalize",
    "Transpose", "RandomCrop", "Pad", "RandomRotation", "ColorJitter",
    "Grayscale", "BrightnessTransform", "ContrastTransform",
    "SaturationTransform", "HueTransform", "RandomErasing",
]


def _rng() -> np.random.Generator:
    from ...base import random as _random

    return np.random.default_rng(_random.next_key())


class BaseTransform:
    """ref: transforms.py BaseTransform — keys-based multi-field
    dispatch collapsed to: apply to image (or each image in a tuple)."""

    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        if isinstance(inputs, tuple):
            return tuple(self._apply_image(x) for x in inputs)
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor(BaseTransform):
    """``F.to_tensor`` onto ``device`` (default the card)."""

    def __init__(self, data_format="CHW", keys=None, device=None):
        super().__init__(keys)
        self.data_format = data_format
        self.device = device

    def _apply_image(self, img):
        return F.to_tensor(img, self.data_format, self.device)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return F.resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return F.center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        if self.padding is not None:
            img = F.pad(img, self.padding, self.fill, self.padding_mode)
        h, w = F._size_hw(img)
        th, tw = self.size
        if self.pad_if_needed and w < tw:
            img = F.pad(img, (tw - w, 0), self.fill, self.padding_mode)
        if self.pad_if_needed and h < th:
            img = F.pad(img, (0, th - h), self.fill, self.padding_mode)
        h, w = F._size_hw(img)
        rng = _rng()
        top = int(rng.integers(0, h - th + 1))
        left = int(rng.integers(0, w - tw + 1))
        return F.crop(img, top, left, th, tw)


class RandomResizedCrop(BaseTransform):
    """ref: transforms.py RandomResizedCrop — scale/ratio sampling with
    10 tries then center fallback."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        h, w = F._size_hw(img)
        area = h * w
        rng = _rng()
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
            aspect = np.exp(rng.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = int(rng.integers(0, h - ch + 1))
                left = int(rng.integers(0, w - cw + 1))
                img = F.crop(img, top, left, ch, cw)
                return F.resize(img, self.size, self.interpolation)
        return F.resize(F.center_crop(img, min(h, w)), self.size, self.interpolation)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if _rng().uniform() < self.prob:
            return F.hflip(img)
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if _rng().uniform() < self.prob:
            return F.vflip(img)
        return img


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def _apply_image(self, img):
        return F.normalize(img, self.mean, self.std, self.data_format)


class Transpose(BaseTransform):
    """HWC → CHW by default (ref: transforms.py Transpose)."""

    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        arr = F._to_np(img)
        return np.transpose(arr, self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return F.pad(img, self.padding, self.fill, self.padding_mode)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = float(_rng().uniform(*self.degrees))
        return F.rotate(img, angle, self.interpolation, self.expand, self.center, self.fill)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _factor(self):
        lo, hi = max(0, 1 - self.value), 1 + self.value
        return float(_rng().uniform(lo, hi))

    def _apply_image(self, img):
        return F.adjust_brightness(img, self._factor())


class ContrastTransform(BrightnessTransform):
    def _apply_image(self, img):
        return F.adjust_contrast(img, self._factor())


class SaturationTransform(BrightnessTransform):
    def _apply_image(self, img):
        return F.adjust_saturation(img, self._factor())


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        return F.adjust_hue(img, float(_rng().uniform(-self.value, self.value)))


class ColorJitter(BaseTransform):
    """ref: transforms.py ColorJitter — random order of the four."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, keys=None):
        super().__init__(keys)
        self.transforms = []
        if brightness:
            self.transforms.append(BrightnessTransform(brightness))
        if contrast:
            self.transforms.append(ContrastTransform(contrast))
        if saturation:
            self.transforms.append(SaturationTransform(saturation))
        if hue:
            self.transforms.append(HueTransform(hue))

    def _apply_image(self, img):
        order = _rng().permutation(len(self.transforms))
        for i in order:
            img = self.transforms[int(i)]._apply_image(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return F.to_grayscale(img, self.num_output_channels)


class RandomErasing(BaseTransform):
    """ref: transforms.py RandomErasing — on CHW Tensor/ndarray."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace

    def _apply_image(self, img):
        rng = _rng()
        if rng.uniform() >= self.prob:
            return img
        import torch

        if isinstance(img, torch.Tensor):  # CHW
            h, w = img.shape[-2], img.shape[-1]
        else:  # ndarray/PIL: HWC
            h, w = F._size_hw(img)
        area = h * w
        for _ in range(10):
            target = area * rng.uniform(*self.scale)
            aspect = np.exp(rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target / aspect)))
            ew = int(round(np.sqrt(target * aspect)))
            if eh < h and ew < w:
                top = int(rng.integers(0, h - eh + 1))
                left = int(rng.integers(0, w - ew + 1))
                return F.erase(img, top, left, eh, ew, self.value, self.inplace)
        return img


class RandomAffine(BaseTransform):
    """ref: transforms.py RandomAffine — random rotation/translate/
    scale/shear."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        self.degrees = (-degrees, degrees) if isinstance(degrees, (int, float)) else tuple(degrees)
        self.translate, self.scale_rng, self.shear = translate, scale, shear
        self.interpolation, self.fill, self.center = interpolation, fill, center

    def _apply_image(self, img):
        from . import functional as F

        r = _rng()  # framework-seeded: paddle.seed reproduces pipelines
        angle = r.uniform(*self.degrees)
        h, w = F._size_hw(img)  # a numpy array's .size is its count
        if self.translate is not None:
            tx = r.uniform(-self.translate[0], self.translate[0]) * w
            ty = r.uniform(-self.translate[1], self.translate[1]) * h
        else:
            tx = ty = 0.0
        scale = r.uniform(*self.scale_rng) if self.scale_rng else 1.0
        if self.shear is not None:
            sh = self.shear if isinstance(self.shear, (list, tuple)) else (-self.shear, self.shear)
            shear = r.uniform(sh[0], sh[1])
        else:
            shear = 0.0
        return F.affine(img, angle, (tx, ty), scale, shear,
                        self.interpolation, self.fill, self.center)


class RandomPerspective(BaseTransform):
    """ref: transforms.py RandomPerspective."""

    def __init__(self, prob=0.5, distortion_scale=0.5, interpolation="nearest",
                 fill=0, keys=None):
        super().__init__(keys)
        self.prob, self.distortion_scale = prob, distortion_scale
        self.interpolation, self.fill = interpolation, fill

    def _apply_image(self, img):
        from . import functional as F

        r = _rng()
        if r.random() >= self.prob:
            return img
        h, w = F._size_hw(img)  # a numpy array's .size is its count
        d = self.distortion_scale
        half_w, half_h = w // 2, h // 2
        ri = lambda hi: int(r.integers(0, hi + 1))  # inclusive, like randint
        tl = (ri(int(d * half_w)), ri(int(d * half_h)))
        tr = (w - 1 - ri(int(d * half_w)), ri(int(d * half_h)))
        br = (w - 1 - ri(int(d * half_w)), h - 1 - ri(int(d * half_h)))
        bl = (ri(int(d * half_w)), h - 1 - ri(int(d * half_h)))
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [tl, tr, br, bl]
        return F.perspective(img, start, end, self.interpolation, self.fill)
