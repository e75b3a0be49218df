"""Port parity: ``paddle_tpu_torch.vision.models.extra_nets`` (MobileNetV3,
DenseNet, SqueezeNet, GoogLeNet, InceptionV3, ShuffleNetV2) against the
JAX package's on the CPU in f32, with the reference's weights and
BatchNorm statistics carried across by ``load_jax_params`` /
``load_jax_buffers``, at ``ATOL``:

- every building block of the six families, eval and train mode (its
  output and its BatchNorm statistics after the step), at small inputs:
  the reference runs eagerly, one compile per op and shape, so whole deep
  models (DenseNet-121, InceptionV3, GoogLeNet) would take minutes here;
- whole models where that is cheap: SqueezeNet 1.1 and ShuffleNetV2
  x0.25, in eval mode;
- names, shapes and parameter counts of every factory are held in
  ``test_torch_vision_models.py``; ``pretrained=True`` raises here.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision.models.extra_nets as JE
from paddle_tpu.vision import models as jmodels
import paddle_tpu_torch.vision.models.extra_nets as TE
from paddle_tpu_torch.utils import load_jax_buffers, load_jax_params
from paddle_tpu_torch.vision import models as tmodels

ATOL = 1e-4


def _carry(jm, tm, seed=3):
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    rng = np.random.RandomState(seed)
    bufs = {n: (rng.randn(*b.shape) * 0.1 if n.endswith("_mean")
                else rng.rand(*b.shape) + 0.5).astype(np.float32)
            for n, b in jm.named_buffers()}
    for n, b in jm.named_buffers():
        b.set_value(paddle.to_tensor(bufs[n]))
    load_jax_buffers(tm, bufs)


def _check(jm, tm, x, mode):
    _carry(jm, tm)
    getattr(jm, mode)()
    getattr(tm, mode)()
    want = jm(paddle.to_tensor(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   atol=ATOL, rtol=1e-4)
    jb = dict(jm.named_buffers())
    for n, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), np.asarray(jb[n].numpy()),
                                   atol=1e-5, rtol=1e-4, err_msg=n)


BLOCKS = [
    ("_SqueezeExcite", (16,), (2, 16, 5, 5)),
    ("_InvertedResidual", (16, 48, 16, 3, 1, True, "hardswish"),
     (2, 16, 8, 8)),
    ("_InvertedResidual", (16, 48, 24, 5, 2, False, "relu"), (2, 16, 8, 8)),
    ("_DenseLayer", (16, 8, 4, 0.0), (2, 16, 6, 6)),
    ("_Transition", (16, 8), (2, 16, 6, 6)),
    ("_Fire", (16, 4, 8, 8), (2, 16, 6, 6)),
    ("_Inception", (16, 8, 4, 8, 4, 8, 8), (2, 16, 6, 6)),
    ("_IncA", (24, 8), (2, 24, 7, 7)),
    ("_IncB", (24,), (2, 24, 9, 9)),
    ("_IncC", (24, 8), (2, 24, 7, 7)),
    ("_IncD", (24,), (2, 24, 9, 9)),
    ("_IncE", (24,), (2, 24, 5, 5)),
    ("_ShuffleUnit", (16, 32, 2, "relu"), (2, 16, 8, 8)),
    ("_ShuffleUnit", (32, 32, 1, "swish"), (2, 32, 8, 8)),
]


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name,args,shape", BLOCKS,
                         ids=[f"{b[0]}{i}" for i, b in enumerate(BLOCKS)])
def test_blocks_match(name, args, shape, mode):
    paddle.seed(0)
    jm = getattr(JE, name)(*args)
    with TE._building("cpu", torch.float32, None):
        tm = getattr(TE, name)(*args)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    _check(jm, tm, x, mode)


def test_channel_shuffle():
    x = np.random.RandomState(2).randn(2, 12, 3, 4).astype(np.float32)
    np.testing.assert_array_equal(
        TE._channel_shuffle(torch.from_numpy(x), 3).numpy(),
        np.asarray(JE._channel_shuffle(paddle.to_tensor(x), 3).numpy()))


MODELS = [("squeezenet1_1", {"num_classes": 10}, 48),
          ("shufflenet_v2_x0_25", {"num_classes": 10}, 32)]


@pytest.mark.parametrize("name,kw,px", MODELS, ids=[m[0] for m in MODELS])
def test_whole_models_match_in_eval(name, kw, px):
    paddle.seed(0)
    jm = getattr(jmodels, name)(**kw)
    tm = getattr(tmodels, name)(device="cpu", **kw)
    x = np.random.RandomState(1).randn(2, 3, px, px).astype(np.float32)
    _check(jm, tm, x, "eval")


@pytest.mark.parametrize("name", ["mobilenet_v3_small", "densenet121",
                                  "squeezenet1_1", "googlenet",
                                  "inception_v3", "shufflenet_v2_x1_0"])
def test_pretrained_raises_the_references_message(name):
    with pytest.raises(ValueError) as got:
        getattr(tmodels, name)(pretrained=True, device="cpu")
    with pytest.raises(ValueError) as want:
        getattr(jmodels, name)(pretrained=True)
    assert str(got.value) == str(want.value)
