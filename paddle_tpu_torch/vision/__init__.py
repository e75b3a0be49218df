"""paddle_tpu_torch.vision — transforms, datasets, the model zoo and the
detection ops (counterpart of ``paddle_tpu/vision/``; ref:
python/paddle/vision/).

Host-side image code is numpy (PIL where present, imported lazily: the
package imports without it); the models are the port's ``nn`` layers,
built on the card unless the caller passes ``device="cpu"``.
"""
from . import transforms  # noqa: F401
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from .models import (  # noqa: F401
    LeNet,
    AlexNet,
    VGG,
    ResNet,
    MobileNetV1,
    MobileNetV2,
    alexnet,
    mobilenet_v1,
    mobilenet_v2,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    vgg11,
    vgg13,
    vgg16,
    vgg19,
)

__all__ = ["transforms", "datasets", "models", "ops"]


def set_image_backend(backend: str):
    """ref: vision/image.py set_image_backend — 'pil' | 'cv2' | 'tensor',
    recorded for :func:`get_image_backend`."""
    global _image_backend
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(f"unknown image backend {backend!r}")
    _image_backend = backend


_image_backend = "pil"


def get_image_backend() -> str:
    return _image_backend


def image_load(path, backend=None, device=None):
    """ref: vision/image.py image_load. backend 'pil' -> PIL Image;
    'cv2' -> BGR ndarray (decoded through PIL); 'tensor' -> a CHW uint8
    tensor on ``device`` (default the card)."""
    import numpy as _np
    from PIL import Image

    b = backend or get_image_backend()
    img = Image.open(path)
    if b == "pil":
        return img
    arr = _np.asarray(img.convert("RGB"))
    if b == "cv2":
        return arr[..., ::-1].copy()  # BGR, matching the cv2 backend
    import torch

    from ..base.device import get_device

    return torch.from_numpy(arr.transpose(2, 0, 1).copy()).to(
        get_device(device))
