"""Cifar10 / Cifar100 (counterpart of
``paddle_tpu/vision/datasets/cifar.py``; ref:
python/paddle/vision/datasets/cifar.py — same tar.gz of pickled batches
with b'data' + b'labels'/b'fine_labels')."""
from __future__ import annotations

import os
import pickle
import tarfile
from typing import Optional

import numpy as np

from torch.utils.data import Dataset

__all__ = ["Cifar10", "Cifar100"]


class Cifar10(Dataset):
    _archive = "cifar-10-python.tar.gz"
    _train_members = [f"data_batch_{i}" for i in range(1, 6)]
    _test_members = ["test_batch"]
    _label_key = b"labels"

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform=None, download: bool = True,
                 backend: Optional[str] = None):
        if mode not in ("train", "test"):
            raise ValueError("mode must be 'train' or 'test'")
        self.mode = mode
        self.transform = transform
        if data_file is None:
            data_file = os.path.expanduser(
                f"~/.cache/paddle_tpu/{self._archive}"
            )
        if not os.path.exists(data_file):
            raise RuntimeError(
                f"{type(self).__name__} archive not found at {data_file}; "
                "automatic download is unavailable (no network egress) — "
                "place the tar.gz there or pass data_file"
            )
        self.data, self.labels = self._load(data_file)

    def _load(self, data_file):
        members = self._train_members if self.mode == "train" else self._test_members
        images, labels = [], []
        with tarfile.open(data_file, "r:*") as tf:
            names = {os.path.basename(n): n for n in tf.getnames()}
            for m in members:
                if m not in names:
                    raise ValueError(f"member {m} missing from {data_file}")
                with tf.extractfile(names[m]) as f:
                    batch = pickle.load(f, encoding="bytes")
                images.append(batch[b"data"])
                labels.extend(batch[self._label_key])
        data = np.concatenate(images).reshape(-1, 3, 32, 32)
        data = np.transpose(data, (0, 2, 3, 1))  # HWC like the reference
        return data, np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        img = self.data[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    _archive = "cifar-100-python.tar.gz"
    _train_members = ["train"]
    _test_members = ["test"]
    _label_key = b"fine_labels"
