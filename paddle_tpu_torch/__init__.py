"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
layout module for module (``paddle_tpu/X/y.py`` -> ``paddle_tpu_torch/X/y.py``)
and imports ``torch`` only, never ``jax`` and nothing of ``paddle_tpu``.

Slices ported so far: serving (``inference``, ``models``, with the engine's
front door: admission, the host-RAM prefix tier, ``obs``, ``testing.chaos``
and ``utils.resources``), training (``optimizer``, ``amp`` with
``amp.debugging``, ``autograd``, ``jit.to_static`` with its control-flow
conversion and piecewise split, ``nn.functional.cross_entropy``) and
deployment (``jit.save``/``jit.load``, ``inference.Predictor``, ``save``/
``load``).

Entry points (model construction, cache allocation) run on the CUDA card by
default and raise when CUDA is absent; they run on the CPU only when the
caller passes ``device="cpu"``. Every TPU kernel on the ported path is a
hand-written CUDA kernel under ``ops/kernels/``; its wrapper uses the plain
PyTorch version only for tensors that lie on the CPU.
"""
from .base.device import get_device
from .base.dtype import to_torch_dtype
from .base.random import get_generator, seed
from .framework.io import load, save

__all__ = ["get_device", "to_torch_dtype", "get_generator", "seed", "save",
           "load"]
