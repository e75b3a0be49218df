"""Port parity: ``paddle_tpu_torch.vision.models`` against the JAX package's
``vision.models`` on the CPU in f32.

- every factory and class builds with the reference's parameter and
  buffer names and shapes, and so its parameter count (ResNet-50:
  25,557,032);
- forward logits at 28-64 px, with the reference's weights and BatchNorm
  statistics carried across by ``load_jax_params`` / ``load_jax_buffers``
  (nothing transposed), in eval mode and, for the models without
  dropout, in train mode, where the BatchNorm running statistics must
  move as the reference's do (Paddle's momentum: 0.9 keeps 0.9 of the old
  statistic); held to ``ATOL``;
- ``resnet18`` trained three SGD steps as ``tests/test_vision.py``'s
  recipe does: each loss, then every parameter and buffer, to ``1e-4``;
- ``pretrained=True`` raises the reference's message.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.utils import load_jax_buffers, load_jax_params
from paddle_tpu_torch.vision import models as tmodels

ATOL = 1e-4
TRAIN_BATCH = 16

FACTORIES = [
    ("resnet18", {}), ("resnet34", {}), ("resnet50", {}), ("resnet101", {}),
    ("resnet152", {}), ("wide_resnet50_2", {}), ("wide_resnet101_2", {}),
    ("resnext50_32x4d", {}), ("resnext50_64x4d", {}),
    ("resnext101_32x4d", {}), ("resnext101_64x4d", {}),
    ("resnext152_32x4d", {}), ("resnext152_64x4d", {}),
    ("alexnet", {}), ("vgg11", {}), ("vgg13", {"batch_norm": True}),
    ("vgg16", {}), ("vgg19", {"batch_norm": True}),
    ("mobilenet_v1", {}), ("mobilenet_v2", {"scale": 0.75}),
    ("LeNet", {}),
    # extra_nets.py
    ("mobilenet_v3_small", {}), ("mobilenet_v3_large", {"scale": 0.5}),
    ("densenet121", {}), ("densenet161", {}), ("densenet169", {}),
    ("densenet201", {}), ("densenet264", {}), ("inception_v3", {}),
    ("squeezenet1_0", {}), ("squeezenet1_1", {}), ("googlenet", {}),
    ("shufflenet_v2_x0_25", {}), ("shufflenet_v2_x0_33", {}),
    ("shufflenet_v2_x0_5", {}), ("shufflenet_v2_x1_0", {}),
    ("shufflenet_v2_x1_5", {}), ("shufflenet_v2_x2_0", {}),
    ("shufflenet_v2_swish", {}),
]


def _shapes(named):
    return {n: tuple(t.shape) for n, t in named}


@pytest.mark.parametrize("name,kw", FACTORIES, ids=[f[0] for f in FACTORIES])
def test_names_shapes_and_parameter_count_equal_the_references(name, kw):
    def build():  # traced for shapes only: nothing is drawn
        jm = getattr(jmodels, name)(**kw)
        return ({n: p._data for n, p in jm.named_parameters()},
                {n: b._data for n, b in jm.named_buffers()})

    params, bufs = jax.eval_shape(build)
    want = _shapes(params.items())
    want_buf = _shapes(bufs.items())
    tm = getattr(tmodels, name)(device="cpu", **kw)
    assert _shapes(tm.named_parameters()) == want
    assert _shapes(tm.named_buffers()) == want_buf
    count = sum(p.numel() for p in tm.parameters())
    assert count == sum(int(np.prod(s)) for s in want.values())
    if name == "resnet50":
        assert count == 25_557_032  # tests/test_vision.py:90


def _carry(jm, tm):
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    load_jax_buffers(tm, {n: np.asarray(b._data)
                          for n, b in jm.named_buffers()})


def _pair(name, **kw):
    paddle.seed(0)
    jm = getattr(jmodels, name)(**kw)
    tm = getattr(tmodels, name)(device="cpu", **kw)
    _carry(jm, tm)
    return jm, tm


def _stir_stats(jm, tm, seed=3):
    """Non-trivial running statistics, the same in both models (a fresh
    BatchNorm's are 0 and 1, which would hide a swapped pair)."""
    rng = np.random.RandomState(seed)
    bufs = {n: (rng.randn(*b.shape) * 0.1 if n.endswith("_mean")
                else rng.rand(*b.shape) + 0.5).astype(np.float32)
            for n, b in jm.named_buffers()}
    for n, b in jm.named_buffers():
        b.set_value(paddle.to_tensor(bufs[n]))
    load_jax_buffers(tm, bufs)


FORWARD = [("LeNet", {}, 28, 1), ("alexnet", {"num_classes": 7}, 64, 3),
           ("vgg11", {"batch_norm": True, "num_classes": 5}, 32, 3),
           ("resnet18", {"num_classes": 10}, 32, 3),
           ("resnet50", {"num_classes": 10}, 32, 3),
           ("resnext50_32x4d", {"num_classes": 10}, 32, 3),
           ("mobilenet_v1", {"num_classes": 10, "scale": 0.5}, 32, 3),
           ("mobilenet_v2", {"num_classes": 10}, 32, 3)]
DROPOUT = {"alexnet", "vgg11", "mobilenet_v2"}
TRAIN = {"LeNet", "resnet18", "resnet50", "mobilenet_v1"}


@pytest.mark.parametrize("name,kw,px,ch,mode",
                         [f + ("eval",) for f in FORWARD]
                         + [f + ("train",) for f in FORWARD if f[0] in TRAIN],
                         ids=[f"{f[0]}-eval" for f in FORWARD]
                         + [f"{f[0]}-train" for f in FORWARD if f[0] in TRAIN])
def test_forward_matches_with_weights_and_statistics_carried(name, kw, px,
                                                             ch, mode):
    jm, tm = _pair(name, **kw)
    _stir_stats(jm, tm)
    getattr(jm, mode)()
    getattr(tm, mode)()
    # train mode normalizes over the batch: 16 images of 32 px leave
    # ResNet's last stage 16 values a channel (2 would leave it 2, and the
    # normalization then amplifies f32 rounding past any shared bound)
    b = TRAIN_BATCH if mode == "train" else 2
    x = np.random.RandomState(1).randn(b, ch, px, px).astype(np.float32)
    if mode == "train":  # a float64 twin on the same weights and statistics
        twin = getattr(tmodels, name)(device="cpu", dtype=torch.float64,
                                      **kw)
        _carry(jm, twin)
        twin.train()
    want = np.asarray(jm(paddle.to_tensor(x)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    if mode == "eval":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)
    else:
        # batch statistics amplify f32 rounding through a deep net (both
        # packages stray ~6e-4 from float64 on ResNet-50's logits): the
        # port must be as close to a float64 twin as the reference is
        with torch.no_grad():
            exact = twin(torch.from_numpy(x).double()).numpy()
        ref_err = np.abs(want - exact).max()
        assert np.abs(got - exact).max() <= max(2 * ref_err, ATOL), ref_err
        np.testing.assert_allclose(got, want, atol=max(4 * ref_err, ATOL),
                                   rtol=1e-4)
    # the running statistics moved (train) or stayed (eval) alike
    jb = dict(jm.named_buffers())
    for n, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), np.asarray(jb[n].numpy()),
                                   atol=1e-5, rtol=1e-4, err_msg=n)


def test_resnet18_sgd_steps_match_the_references():
    """tests/test_vision.py:114-130's recipe: SGD at lr 0.01 over one
    batch, three steps; at 16 images, not 4: in train mode 4 images of 32
    px leave the last stage's BatchNorm 4 values a channel, and both
    packages' f32 gradients then stray ~4e-4 from float64's."""
    jm, tm = _pair("ResNet", depth=18, num_classes=4)
    x = np.random.RandomState(0).randn(TRAIN_BATCH, 3, 32, 32).astype(
        np.float32)
    y = np.random.RandomState(1).randint(0, 4, (TRAIN_BATCH,)).astype(
        np.int64)
    jo = jopt.SGD(learning_rate=0.01, parameters=jm.parameters())
    to = topt.SGD(learning_rate=0.01, parameters=tm.parameters())
    jl, tl = [], []
    for _ in range(3):
        loss = JF.cross_entropy(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss.numpy()))
        loss = TF.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        to.step()
        to.clear_grad()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    assert tl[-1] < tl[0]
    jp = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jp[n].numpy()), atol=1e-4,
                                   rtol=0, err_msg=n)
    jb = dict(jm.named_buffers())
    for n, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), np.asarray(jb[n].numpy()),
                                   atol=1e-4, rtol=0, err_msg=n)


@pytest.mark.parametrize("name", ["resnet18", "resnext50_32x4d", "alexnet",
                                  "vgg16", "mobilenet_v1", "mobilenet_v2"])
def test_pretrained_raises_the_references_message(name):
    with pytest.raises(ValueError, match="egress") as got:
        getattr(tmodels, name)(pretrained=True, device="cpu")
    with pytest.raises(ValueError) as want:
        getattr(jmodels, name)(pretrained=True)
    assert str(got.value) == str(want.value)


def test_every_reference_model_name_has_a_counterpart():
    missing = [n for n in jmodels.__all__ if not hasattr(tmodels, n)]
    assert missing == []


def test_models_build_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmodels.resnet18()
