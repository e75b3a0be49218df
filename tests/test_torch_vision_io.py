"""Port parity: ``paddle_tpu_torch.vision``'s host-side pieces against the
JAX package's: the transforms on numpy (and PIL) inputs, the datasets
through synthetic MNIST / CIFAR files in ``tmp_path`` (built as
``tests/test_vision.py:138-185`` builds them), and the package's image
backend helpers.

- every deterministic functional transform equal to the reference's
  (``resize`` to ``ATOL`` in f32 before rounding, the rest exactly), and
  ``to_tensor`` / ``normalize`` / ``erase`` on tensors on the device asked;
- the class transforms: deterministic ones equal, random ones (whose
  draws come from each package's own generator) reproducible under
  ``paddle_tpu_torch.seed`` with the reference's shapes and ranges;
- MNIST, FashionMNIST, Cifar10 and Cifar100 items equal the reference's;
  a missing file raises the reference's message, ``download=True`` too;
- ``image_load`` in its three backends.
"""
import gzip
import io
import pickle
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as JT
import paddle_tpu_torch
from paddle_tpu_torch import vision as tvision
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as TT


def _img(h=32, w=24, c=3, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c), np.uint8)


def _np(x):
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return np.asarray(x)


@pytest.mark.parametrize("size", [16, (10, 30), 40])
@pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
def test_resize_numpy_matches(size, interp):
    img = _img()
    np.testing.assert_allclose(
        TT.resize(img, size, interp).astype(np.int16),
        np.asarray(JT.resize(img, size, interp)).astype(np.int16), atol=1)
    f = img.astype(np.float32) / 255.0
    np.testing.assert_allclose(TT.resize(f, size, interp),
                               np.asarray(JT.resize(f, size, interp)),
                               atol=1e-5)


FUNCTIONAL = [
    ("pad", (3,), {}), ("pad", ((1, 2),), dict(fill=7)),
    ("pad", ((1, 2, 3, 4),), dict(padding_mode="reflect")),
    ("pad", (2,), dict(padding_mode="edge")),
    ("pad", (2,), dict(padding_mode="symmetric")),
    ("crop", (1, 2, 5, 6), {}), ("center_crop", ((8, 10),), {}),
    ("center_crop", (9,), {}), ("hflip", (), {}), ("vflip", (), {}),
    ("to_grayscale", (), {}), ("to_grayscale", (3,), {}),
    ("adjust_brightness", (1.3,), {}), ("adjust_contrast", (0.6,), {}),
    ("adjust_saturation", (1.7,), {}), ("adjust_hue", (0.2,), {}),
    ("rotate", (30,), {}), ("rotate", (45,), dict(expand=True)),
    ("erase", (2, 3, 4, 5, 9), {}),
    ("affine", (15, (2, 3), 1.1, (5, 0)), {}),
    ("perspective", ([[0, 0], [23, 0], [23, 31], [0, 31]],
                     [[2, 1], [21, 3], [22, 30], [1, 28]]), {}),
]


@pytest.mark.parametrize("name,args,kw", FUNCTIONAL,
                         ids=[f"{f[0]}{i}" for i, f in enumerate(FUNCTIONAL)])
@pytest.mark.parametrize("kind", ["numpy", "pil"])
def test_functional_transforms_equal_the_references(name, args, kw, kind):
    from PIL import Image

    img = _img(seed=1)
    if kind == "pil":
        img = Image.fromarray(img)
    got = getattr(TT, name)(img, *args, **kw)
    want = getattr(JT, name)(img, *args, **kw)
    assert type(got) is type(want)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_to_tensor_normalize_and_erase_on_tensors():
    img = _img(seed=2)
    t = TT.to_tensor(img, device="cpu")
    j = JT.to_tensor(img)
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), _np(j))
    np.testing.assert_array_equal(TT.to_tensor(img, "HWC", "cpu").numpy(),
                                  _np(JT.to_tensor(img, "HWC")))
    mean, std = [0.5, 0.4, 0.3], [0.2, 0.3, 0.4]
    np.testing.assert_allclose(TT.normalize(t, mean, std).numpy(),
                               _np(JT.normalize(j, mean, std)), atol=1e-6)
    np.testing.assert_allclose(TT.normalize(img, mean, std, "HWC"),
                               np.asarray(JT.normalize(img, mean, std, "HWC")),
                               atol=1e-5)
    np.testing.assert_array_equal(TT.erase(t, 1, 2, 3, 4, 0.5).numpy(),
                                  _np(JT.erase(j, 1, 2, 3, 4, 0.5)))
    assert not torch.equal(TT.erase(t, 1, 2, 3, 4, 0.5), t)  # a copy


def test_to_tensor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.to_tensor(_img())


DETERMINISTIC = [
    ("Resize", (16,)), ("CenterCrop", (12,)), ("Pad", (2,)),
    ("Grayscale", (3,)), ("Transpose", ()), ("Normalize", ([0.5] * 3,
                                                          [0.25] * 3)),
]


@pytest.mark.parametrize("name,args", DETERMINISTIC,
                         ids=[d[0] for d in DETERMINISTIC])
def test_deterministic_class_transforms(name, args):
    img = _img(seed=3)
    np.testing.assert_allclose(np.asarray(getattr(TT, name)(*args)(img)),
                               np.asarray(getattr(JT, name)(*args)(img)),
                               atol=1e-5)


RANDOM = [
    ("RandomResizedCrop", (16,)), ("RandomCrop", (20,)),
    ("RandomHorizontalFlip", (0.5,)), ("RandomVerticalFlip", (0.5,)),
    ("RandomRotation", (30,)), ("BrightnessTransform", (0.4,)),
    ("ContrastTransform", (0.4,)), ("SaturationTransform", (0.4,)),
    ("HueTransform", (0.2,)), ("ColorJitter", (0.2, 0.2, 0.2, 0.1)),
    ("RandomAffine", (20, (0.1, 0.1), (0.9, 1.1), 5)),
    ("RandomPerspective", (1.0, 0.3)),
]


@pytest.mark.parametrize("name,args", RANDOM, ids=[r[0] for r in RANDOM])
def test_random_class_transforms_reproduce_under_the_seed(name, args):
    img = _img(40, 36, seed=4)
    t = getattr(TT, name)(*args)
    paddle_tpu_torch.seed(7)
    a = [np.asarray(t(img)) for _ in range(3)]
    paddle_tpu_torch.seed(7)
    b = [np.asarray(t(img)) for _ in range(3)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    if name in ("RandomAffine", "RandomPerspective"):
        # the reference reads a numpy array's .size as (w, h) and fails:
        # its shapes are held on a PIL image
        from PIL import Image

        pil = Image.fromarray(img)
        paddle_tpu_torch.seed(7)
        assert np.asarray(t(pil)).shape == np.asarray(
            getattr(JT, name)(*args)(pil)).shape == a[0].shape
        return
    want = np.asarray(getattr(JT, name)(*args)(img))
    assert a[0].shape == want.shape and a[0].dtype == want.dtype


def test_compose_pipeline_and_random_erasing():
    pipe = TT.Compose([TT.RandomResizedCrop(16), TT.RandomHorizontalFlip(),
                       TT.ColorJitter(brightness=0.2, contrast=0.2),
                       TT.ToTensor(device="cpu"),
                       TT.Normalize([0.5] * 3, [0.5] * 3)])
    img = _img(40, 40, seed=5)
    paddle_tpu_torch.seed(7)
    a = pipe(img)
    paddle_tpu_torch.seed(7)
    b = pipe(img)
    assert isinstance(a, torch.Tensor) and tuple(a.shape) == (3, 16, 16)
    assert torch.equal(a, b)
    out = TT.RandomErasing(prob=1.0, value=0)(torch.ones(3, 16, 16))
    assert float(out.min()) == 0.0 and float(out.max()) == 1.0
    arr = TT.RandomErasing(prob=1.0, value=0)(np.ones((16, 16, 3), np.uint8))
    assert arr.min() == 0 and arr.max() == 1


def test_every_reference_transform_has_a_counterpart():
    names = [n for n in dir(JT) if not n.startswith("_") and n != "functional"
             and callable(getattr(JT, n))]
    assert len(names) > 30
    assert [n for n in names if not hasattr(TT, n)] == []


# -- datasets -----------------------------------------------------------------

def _mnist_files(tmp_path, n=5, prefix="train"):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (n, 28, 28), np.uint8)
    labels = rng.randint(0, 10, (n,), np.uint8)
    ip = str(tmp_path / f"{prefix}-images-idx3-ubyte.gz")
    lp = str(tmp_path / f"{prefix}-labels-idx1-ubyte.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return ip, lp


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_mnist_items_equal_the_references(tmp_path, cls, mode):
    ip, lp = _mnist_files(tmp_path)
    kw = dict(image_path=ip, label_path=lp, mode=mode)
    got, want = getattr(tds, cls)(**kw), getattr(jds, cls)(**kw)
    assert len(got) == len(want) == 5
    for i in range(5):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert isinstance(got, torch.utils.data.Dataset)
    tr = getattr(tds, cls)(transform=TT.Normalize([127.5], [127.5]), **kw)
    np.testing.assert_allclose(
        np.asarray(tr[2][0]),
        np.asarray(getattr(jds, cls)(
            transform=JT.Normalize([127.5], [127.5]), **kw)[2][0]))


def _cifar_archive(tmp_path, hundred=False):
    rng = np.random.RandomState(0)
    name = "cifar-100-python" if hundred else "cifar-10-batches-py"
    files = (["train", "test"] if hundred else
             [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"])
    archive = str(tmp_path / f"{name}.tar.gz")
    key = b"fine_labels" if hundred else b"labels"
    with tarfile.open(archive, "w:gz") as tf:
        for f in files:
            batch = {b"data": rng.randint(0, 256, (4, 3072), np.uint8),
                     key: rng.randint(0, 100 if hundred else 10,
                                      (4,)).tolist()}
            payload = pickle.dumps(batch)
            info = tarfile.TarInfo(f"{name}/{f}")
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))
    return archive


@pytest.mark.parametrize("cls", ["Cifar10", "Cifar100"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_cifar_items_equal_the_references(tmp_path, cls, mode):
    archive = _cifar_archive(tmp_path, hundred=cls == "Cifar100")
    got = getattr(tds, cls)(data_file=archive, mode=mode)
    want = getattr(jds, cls)(data_file=archive, mode=mode)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("build", [
    lambda m, d: m.MNIST(image_path=str(d / "x.gz"),
                         label_path=str(d / "y.gz")),
    lambda m, d: m.MNIST(download=True),
    lambda m, d: m.Cifar10(data_file=str(d / "none.tar.gz")),
    lambda m, d: m.Cifar10(download=True)])
def test_missing_files_and_download_raise_the_references_error(tmp_path,
                                                               build):
    with pytest.raises(Exception) as want:
        build(jds, tmp_path)
    with pytest.raises(type(want.value)) as got:
        build(tds, tmp_path)
    assert str(got.value) == str(want.value)


def test_image_backends(tmp_path):
    from PIL import Image

    path = tmp_path / "x.png"
    Image.fromarray(_img(seed=6)).save(path)
    assert tvision.get_image_backend() == "pil"
    with pytest.raises(ValueError):
        tvision.set_image_backend("nope")
    np.testing.assert_array_equal(
        np.asarray(tvision.image_load(path)),
        np.asarray(paddle.vision.image_load(path)))
    np.testing.assert_array_equal(
        tvision.image_load(path, "cv2"),
        paddle.vision.image_load(path, "cv2"))
    t = tvision.image_load(path, "tensor", device="cpu")
    np.testing.assert_array_equal(t.numpy(), _np(paddle.vision.image_load(
        path, "tensor")))
    tvision.set_image_backend("cv2")
    try:
        assert tvision.get_image_backend() == "cv2"
    finally:
        tvision.set_image_backend("pil")
