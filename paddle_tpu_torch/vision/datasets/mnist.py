"""MNIST / FashionMNIST (counterpart of
``paddle_tpu/vision/datasets/mnist.py``; ref:
python/paddle/vision/datasets/mnist.py — same idx3-ubyte/idx1-ubyte
parsing, gzip-compressed files)."""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from torch.utils.data import Dataset

__all__ = ["MNIST", "FashionMNIST"]


class MNIST(Dataset):
    """mode: 'train' | 'test'. image_path/label_path override the
    default ``{root}/{name}-images-idx3-ubyte.gz`` layout."""

    NAME = "mnist"

    def __init__(self, image_path: Optional[str] = None,
                 label_path: Optional[str] = None, mode: str = "train",
                 transform=None, download: bool = True,
                 backend: Optional[str] = None):
        if mode not in ("train", "test"):
            raise ValueError("mode must be 'train' or 'test'")
        self.mode = mode
        self.transform = transform
        self.backend = backend or "numpy"
        prefix = "train" if mode == "train" else "t10k"
        if image_path is None or label_path is None:
            root = os.path.expanduser(f"~/.cache/paddle_tpu/{self.NAME}")
            image_path = image_path or os.path.join(root, f"{prefix}-images-idx3-ubyte.gz")
            label_path = label_path or os.path.join(root, f"{prefix}-labels-idx1-ubyte.gz")
        if not (os.path.exists(image_path) and os.path.exists(label_path)):
            raise RuntimeError(
                f"{type(self).__name__} files not found at {image_path} / "
                f"{label_path}; automatic download is unavailable (no "
                "network egress) — place the idx-ubyte(.gz) files there "
                "or pass image_path/label_path"
            )
        self.images, self.labels = self._load(image_path, label_path)

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")

    def _load(self, image_path, label_path):
        with self._open(image_path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(f"bad idx3 magic {magic} in {image_path}")
            images = np.frombuffer(f.read(n * rows * cols), np.uint8)
            images = images.reshape(n, rows, cols)
        with self._open(label_path) as f:
            magic, n2 = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise ValueError(f"bad idx1 magic {magic} in {label_path}")
            labels = np.frombuffer(f.read(n2), np.uint8).astype(np.int64)
        if n != n2:
            raise ValueError("image/label count mismatch")
        return images, labels

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"
