"""Functional image transforms (counterpart of
``paddle_tpu/vision/transforms/functional.py``; ref:
python/paddle/vision/transforms/functional.py, functional_pil.py,
functional_cv2.py).

The port's own copy of the reference's host-side numpy/PIL code: inputs may
be PIL Images or numpy HWC arrays; outputs keep the input kind except
``to_tensor``, which gives a torch tensor on the device the caller names
(default the card). PIL is imported if present, as in the reference; only
the functions that need it (``rotate``, ``affine``, ``perspective``,
``adjust_hue``, a PIL input) raise without it. A numpy ``resize`` is the
reference's ``jax.image.resize`` (half-pixel, antialiased when shrinking,
Keys cubic) through the port's ``interpolate`` weights, on the CPU.
"""
from __future__ import annotations

import numbers
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

try:  # PIL is optional: numpy-only without it
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    Image = None
    _HAS_PIL = False

__all__ = [
    "to_tensor", "normalize", "resize", "pad", "crop", "center_crop",
    "hflip", "vflip", "rotate", "to_grayscale", "adjust_brightness",
    "adjust_contrast", "adjust_saturation", "adjust_hue", "erase",
]


def _is_pil(img) -> bool:
    return _HAS_PIL and isinstance(img, Image.Image)


def _to_np(img) -> np.ndarray:
    """HWC uint8/float numpy view of the image."""
    if _is_pil(img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _like(img, arr: np.ndarray):
    """Rebuild the same kind as ``img`` from an HWC array."""
    if _is_pil(img):
        if arr.shape[2] == 1:
            return Image.fromarray(arr[:, :, 0].astype(np.uint8))
        return Image.fromarray(arr.astype(np.uint8))
    return arr


def _size_hw(img) -> Tuple[int, int]:
    if _is_pil(img):
        w, h = img.size
        return h, w
    a = np.asarray(img)
    return a.shape[0], a.shape[1]


def to_tensor(pic, data_format: str = "CHW", device=None):
    """PIL/ndarray (HWC, uint8 0..255 or float) → float32 tensor scaled
    to [0,1] (ref: functional.py to_tensor), on ``device`` (default the
    card; ``"cpu"`` for the CPU)."""
    import torch

    from ...base.device import get_device

    arr = _to_np(pic)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
    if data_format.upper() == "CHW":
        arr = np.transpose(arr, (2, 0, 1))
    return torch.from_numpy(np.ascontiguousarray(arr)).to(get_device(device))


def normalize(img, mean, std, data_format: str = "CHW", to_rgb: bool = False):
    """(x - mean) / std per channel (ref: functional.py normalize).
    Accepts Tensor/ndarray; PIL is converted to float HWC first."""
    import torch

    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if isinstance(img, torch.Tensor):
        shape = (-1, 1, 1) if data_format.upper() == "CHW" else (1, 1, -1)
        m, s = (torch.from_numpy(a.reshape(shape)).to(img.device)
                for a in (mean, std))
        return (img - m) / s
    arr = _to_np(img).astype(np.float32)
    if data_format.upper() == "CHW" and arr.shape[0] in (1, 3) and arr.ndim == 3 and arr.shape[2] not in (1, 3):
        shape = (-1, 1, 1)
    elif data_format.upper() == "CHW" and not _is_pil(img) and arr.ndim == 3 and arr.shape[0] in (1, 3):
        shape = (-1, 1, 1)
    else:
        shape = (1, 1, -1)
    return (arr - mean.reshape(shape)) / std.reshape(shape)


def _resolve_size(size, h, w):
    if isinstance(size, int):
        if h <= w:
            return size, int(size * w / h)
        return int(size * h / w), size
    return int(size[0]), int(size[1])


def resize(img, size, interpolation: str = "bilinear"):
    """Resize to ``size`` (int → short edge, (h, w) → exact) (ref:
    functional.py resize)."""
    h, w = _size_hw(img)
    oh, ow = _resolve_size(size, h, w)
    if _is_pil(img):
        modes = {
            "nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
            "bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS,
            "box": Image.BOX, "hamming": Image.HAMMING,
        }
        return img.resize((ow, oh), modes.get(interpolation, Image.BILINEAR))
    import torch

    from ...nn.functional import common as C

    arr = _to_np(img)
    t = torch.from_numpy(arr.astype(np.float32))
    for axis, n_out in ((0, oh), (1, ow)):
        if interpolation == "nearest":
            t = C._nearest_axis(t, axis, n_out)
        else:
            kernel = C._keys_cubic if interpolation == "bicubic" else \
                C._triangle
            t = C._resize_axis(t, axis, n_out, kernel)
    out = t.numpy()
    if arr.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def pad(img, padding, fill=0, padding_mode: str = "constant"):
    """Pad HWC image (ref: functional.py pad). padding: int, (pl, pt),
    or (pl, pt, pr, pb)."""
    if isinstance(padding, numbers.Number):
        pl = pt = pr = pb = int(padding)
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding
    arr = _to_np(img)
    modes = {
        "constant": "constant", "edge": "edge",
        "reflect": "reflect", "symmetric": "symmetric",
    }
    kwargs = {"constant_values": fill} if padding_mode == "constant" else {}
    out = np.pad(
        arr, ((pt, pb), (pl, pr), (0, 0)), mode=modes[padding_mode], **kwargs
    )
    return _like(img, out)


def crop(img, top: int, left: int, height: int, width: int):
    arr = _to_np(img)
    return _like(img, arr[top : top + height, left : left + width])


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    h, w = _size_hw(img)
    th, tw = output_size
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return crop(img, top, left, th, tw)


def hflip(img):
    return _like(img, _to_np(img)[:, ::-1])


def vflip(img):
    return _like(img, _to_np(img)[::-1])


def rotate(img, angle, interpolation="nearest", expand=False, center=None, fill=0):
    """Rotate counter-clockwise by ``angle`` degrees (ref: functional.py
    rotate). Uses PIL when available; numpy inputs round-trip through
    PIL per-channel."""
    if not _HAS_PIL:
        raise RuntimeError("rotate requires PIL")
    modes = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}
    res = modes.get(interpolation, Image.NEAREST)
    if _is_pil(img):
        return img.rotate(angle, resample=res, expand=expand, center=center, fillcolor=fill)
    arr = _to_np(img)
    chans = [
        np.asarray(
            Image.fromarray(arr[:, :, c]).rotate(
                angle, resample=res, expand=expand, center=center, fillcolor=fill
            )
        )
        for c in range(arr.shape[2])
    ]
    return np.stack(chans, axis=2)


def to_grayscale(img, num_output_channels: int = 1):
    """ITU-R 601-2 luma (ref: functional.py to_grayscale)."""
    arr = _to_np(img).astype(np.float32)
    if arr.shape[2] == 1:
        gray = arr[:, :, 0]
    else:
        gray = arr[:, :, 0] * 0.299 + arr[:, :, 1] * 0.587 + arr[:, :, 2] * 0.114
    gray = np.clip(np.rint(gray), 0, 255).astype(np.uint8)
    out = np.repeat(gray[:, :, None], num_output_channels, axis=2)
    return _like(img, out)


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    out = a.astype(np.float32) * factor + b.astype(np.float32) * (1 - factor)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def adjust_brightness(img, brightness_factor: float):
    arr = _to_np(img)
    return _like(img, _blend(arr, np.zeros_like(arr), brightness_factor))


def adjust_contrast(img, contrast_factor: float):
    arr = _to_np(img)
    mean = np.full_like(arr, np.mean(to_grayscale(arr)[..., 0]))
    return _like(img, _blend(arr, mean, contrast_factor))


def adjust_saturation(img, saturation_factor: float):
    arr = _to_np(img)
    gray = np.asarray(to_grayscale(arr))
    gray = np.repeat(gray[..., :1], arr.shape[2], axis=2)
    return _like(img, _blend(arr, gray, saturation_factor))


def adjust_hue(img, hue_factor: float):
    """Shift hue by hue_factor in [-0.5, 0.5] turns (ref:
    functional_pil.py adjust_hue — same HSV roll)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    arr = _to_np(img)
    if arr.shape[2] == 1:
        return _like(img, arr)
    if not _HAS_PIL:
        raise RuntimeError("adjust_hue requires PIL")
    pil = Image.fromarray(arr.astype(np.uint8)).convert("HSV")
    h, s, v = pil.split()
    h_np = np.asarray(h, np.uint8).astype(np.int16)
    h_np = ((h_np + int(hue_factor * 255)) % 256).astype(np.uint8)
    out = Image.merge("HSV", (Image.fromarray(h_np), s, v)).convert("RGB")
    return _like(img, np.asarray(out))


def erase(img, i: int, j: int, h: int, w: int, v, inplace: bool = False):
    """Erase region with value(s) v (ref: functional.py erase)."""
    import torch

    if isinstance(img, torch.Tensor):
        out = img if inplace else img.clone()
        out[:, i : i + h, j : j + w] = torch.as_tensor(v, dtype=img.dtype,
                                                       device=img.device)
        return out
    arr = _to_np(img)
    out = arr if inplace else arr.copy()
    out[i : i + h, j : j + w] = v
    return _like(img, out)


def _affine_matrix(angle, translate, scale, shear, center):
    """Inverse affine matrix coefficients for PIL (output->input map),
    matching torchvision/paddle's parameterization."""
    import math

    rot = math.radians(angle)
    sx, sy = [math.radians(s) for s in (shear if isinstance(shear, (list, tuple)) else (shear, 0.0))]
    cx, cy = center
    tx, ty = translate
    # RSS = rotation * shear * scale; inverse mapping per torchvision
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    M = [d / scale, -b / scale, 0.0, -c / scale, a / scale, 0.0]
    M[2] = cx - (M[0] * (cx + tx) + M[1] * (cy + ty))
    M[5] = cy - (M[3] * (cx + tx) + M[4] * (cy + ty))
    return M


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    """Affine transform (ref: functional.py affine)."""
    if not _HAS_PIL:
        raise RuntimeError("affine requires PIL")
    modes = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}
    res = modes.get(interpolation, Image.NEAREST)

    def one(im):
        w, h = im.size
        c = center if center is not None else (w * 0.5, h * 0.5)
        M = _affine_matrix(angle, translate, scale, shear, c)
        return im.transform((w, h), Image.AFFINE, M, resample=res, fillcolor=fill)

    if _is_pil(img):
        return one(img)
    arr = _to_np(img)
    chans = [np.asarray(one(Image.fromarray(arr[:, :, ch]))) for ch in range(arr.shape[2])]
    return np.stack(chans, axis=2)


def _perspective_coeffs(startpoints, endpoints):
    """Solve the 8-dof homography endpoints -> startpoints (PIL expects
    the inverse map), ref torchvision _get_perspective_coeffs."""
    a = np.zeros((8, 8), np.float64)
    b = np.zeros(8, np.float64)
    for i, (sp, ep) in enumerate(zip(startpoints, endpoints)):
        a[2 * i] = [ep[0], ep[1], 1, 0, 0, 0, -sp[0] * ep[0], -sp[0] * ep[1]]
        a[2 * i + 1] = [0, 0, 0, ep[0], ep[1], 1, -sp[1] * ep[0], -sp[1] * ep[1]]
        b[2 * i] = sp[0]
        b[2 * i + 1] = sp[1]
    return np.linalg.solve(a, b).tolist()


def perspective(img, startpoints, endpoints, interpolation="nearest", fill=0):
    """Perspective transform (ref: functional.py perspective)."""
    if not _HAS_PIL:
        raise RuntimeError("perspective requires PIL")
    modes = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}
    res = modes.get(interpolation, Image.NEAREST)
    coeffs = _perspective_coeffs(startpoints, endpoints)

    def one(im):
        return im.transform(im.size, Image.PERSPECTIVE, coeffs, resample=res, fillcolor=fill)

    if _is_pil(img):
        return one(img)
    arr = _to_np(img)
    chans = [np.asarray(one(Image.fromarray(arr[:, :, ch]))) for ch in range(arr.shape[2])]
    return np.stack(chans, axis=2)
