"""vision.datasets (counterpart of ``paddle_tpu/vision/datasets/``; ref:
python/paddle/vision/datasets/ — mnist.py, cifar.py). File-format parsers
are faithful (MNIST idx-ubyte, CIFAR pickle batches) and read local files
only: ``download=True`` raises with the expected file layout instead. The
datasets are ``torch.utils.data.Dataset`` s yielding numpy images.
"""
from torch.utils.data import Dataset
from .mnist import MNIST, FashionMNIST  # noqa: F401
from .cifar import Cifar10, Cifar100  # noqa: F401

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100",
           "DatasetFolder", "ImageFolder", "Flowers", "VOC2012"]


class DatasetFolder(Dataset):
    """Generic folder-of-class-subfolders dataset (ref:
    vision/datasets/folder.py DatasetFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        import os

        self.root = root
        self.transform = transform
        self.loader = loader or self._pil_loader
        exts = tuple(e.lower() for e in (extensions or (
            ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp"
        )))
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        if not classes:
            raise RuntimeError(f"no class folders under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for f in sorted(files):
                    path = os.path.join(dirpath, f)
                    ok = (is_valid_file(path) if is_valid_file
                          else f.lower().endswith(exts))
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(f"no valid files under {root}")

    @staticmethod
    def _pil_loader(path):
        from PIL import Image

        with open(path, "rb") as f:
            return Image.open(f).convert("RGB")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat folder of images, no labels (ref: folder.py ImageFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        import os

        self.root = root
        self.transform = transform
        self.loader = loader or DatasetFolder._pil_loader
        exts = tuple(e.lower() for e in (extensions or (
            ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp"
        )))
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for f in sorted(files):
                path = os.path.join(dirpath, f)
                ok = (is_valid_file(path) if is_valid_file
                      else f.lower().endswith(exts))
                if ok:
                    self.samples.append(path)

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


class Flowers(Dataset):
    """Oxford-102 Flowers (ref: vision/datasets/flowers.py). No network
    egress in this environment: pass data_file/label_file/setid_file
    paths to pre-downloaded archives."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        if data_file is None or label_file is None or setid_file is None:
            raise RuntimeError(
                "Flowers: automatic download is unavailable (no network "
                "egress); pass data_file=, label_file= and setid_file= "
                "pointing at the Oxford-102 archives."
            )
        import scipy.io as sio

        self.transform = transform
        self.mode = mode
        labels = sio.loadmat(label_file)["labels"][0]
        setid = sio.loadmat(setid_file)
        key = {"train": "trnid", "valid": "valid", "test": "tstid"}[mode]
        self.indexes = setid[key][0]
        self.data_file = data_file
        self.labels = labels

    def _tar(self):
        # one handle per process (lazy: survives DataLoader worker
        # pickling, avoids re-scanning the archive per sample)
        import tarfile

        tf = getattr(self, "_tf", None)
        if tf is None:
            tf = tarfile.open(self.data_file)
            self._tf = tf
        return tf

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_tf", None)
        return d

    def __getitem__(self, idx):
        from PIL import Image

        flower_id = int(self.indexes[idx])
        name = f"jpg/image_{flower_id:05d}.jpg"
        img = Image.open(self._tar().extractfile(name)).convert("RGB")
        label = int(self.labels[flower_id - 1]) - 1
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.indexes)


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation (ref: vision/datasets/voc2012.py).
    Pass data_file= pointing at the pre-downloaded VOCtrainval tar."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        if data_file is None:
            raise RuntimeError(
                "VOC2012: automatic download is unavailable (no network "
                "egress); pass data_file= pointing at VOCtrainval_11-May-2012.tar."
            )
        import tarfile

        self.transform = transform
        self.data_file = data_file
        seg_list = {
            "train": "VOCdevkit/VOC2012/ImageSets/Segmentation/train.txt",
            "valid": "VOCdevkit/VOC2012/ImageSets/Segmentation/val.txt",
            "test": "VOCdevkit/VOC2012/ImageSets/Segmentation/trainval.txt",
        }[mode]
        with tarfile.open(data_file) as tf:
            names = tf.extractfile(seg_list).read().decode().split()
        self.names = names

    _tar = Flowers._tar
    __getstate__ = Flowers.__getstate__

    def __getitem__(self, idx):
        import numpy as np
        from PIL import Image

        name = self.names[idx]
        tf = self._tar()
        img = Image.open(tf.extractfile(
            f"VOCdevkit/VOC2012/JPEGImages/{name}.jpg")).convert("RGB")
        lab = Image.open(tf.extractfile(
            f"VOCdevkit/VOC2012/SegmentationClass/{name}.png"))
        img = np.asarray(img)
        lab = np.asarray(lab)
        if self.transform is not None:
            img = self.transform(img)
        return img, lab

    def __len__(self):
        return len(self.names)
