"""Serving and deployment (counterpart of ``paddle_tpu/inference``).

The serving engine (``serving.py``: ``ContinuousBatchingEngine`` with
admission control and the host-RAM tier), and the reference's deployment
API: a model saved with ``jit.save`` is a ``torch.export`` program plus its
weights; :class:`Predictor` loads it (``jit.load`` -> ``TranslatedLayer``)
and runs it with named feed and fetch handles. :class:`Config` selects the
device: the CUDA card by default (``enable_use_gpu``; creating a predictor
raises where CUDA is absent), the CPU with ``disable_gpu()``. The
TensorRT and IR-pass knobs are recorded and do nothing: the program runs
as exported, the flash forward as its registered kernel.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional

import numpy as np

from .admission import (AdmissionConfig, AdmissionController, EngineLoad,
                        TenantPolicy, priority_rank)
from .cache_tier import HostTier
from .serving import ContinuousBatchingEngine, EngineFenced, GenRequest

__all__ = ["ContinuousBatchingEngine", "GenRequest", "EngineFenced",
           "AdmissionConfig", "AdmissionController", "EngineLoad",
           "TenantPolicy", "priority_rank", "HostTier",
           "Config", "DataType", "PlaceType", "PrecisionType", "Tensor",
           "Predictor", "create_predictor", "get_version",
           "_get_phi_kernel_name", "get_trt_compile_version",
           "get_trt_runtime_version", "convert_to_mixed_precision",
           "get_num_bytes_of_data_type", "PredictorPool", "XpuConfig"]

__version__ = "0.1.0"


class DataType(enum.Enum):
    FLOAT32 = 0
    FLOAT16 = 1
    BFLOAT16 = 2
    INT8 = 3
    INT32 = 4
    INT64 = 5
    UINT8 = 6
    BOOL = 7


_DT_BYTES = {
    DataType.FLOAT32: 4, DataType.FLOAT16: 2, DataType.BFLOAT16: 2,
    DataType.INT8: 1, DataType.INT32: 4, DataType.INT64: 8,
    DataType.UINT8: 1, DataType.BOOL: 1,
}


class PlaceType(enum.Enum):
    CPU = 0
    GPU = 1  # the CUDA card
    XPU = 2
    CUSTOM = 3


class PrecisionType(enum.Enum):
    Float32 = 0
    Half = 1
    Int8 = 2
    Bfloat16 = 3


class Config:
    """Model path and device knobs. The CUDA card is the default device."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        # jit.save writes a single prefix; either spelling names it
        self._path = prog_file
        self._use_accel = True
        self._device_id = 0
        self._precision = PrecisionType.Float32
        self._cpu_threads = 1
        self._enable_memory_optim = True

    def set_prog_file(self, path):
        self._path = path

    def prog_file(self):
        return self._path

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision=PrecisionType.Float32):
        """Run on CUDA card ``device_id`` (the default); the memory pool is
        PyTorch's caching allocator."""
        self._use_accel = True
        self._device_id = device_id
        self._precision = precision

    def disable_gpu(self):
        """Run on the CPU."""
        self._use_accel = False

    def use_gpu(self):
        return self._use_accel

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_threads = n

    def enable_memory_optim(self):
        self._enable_memory_optim = True

    def enable_tensorrt_engine(self, *a, **k):
        """TensorRT is not used: the exported program runs as it is (a
        recorded no-op for ported deployment scripts)."""

    def switch_ir_optim(self, flag=True):
        """IR passes are not run on the exported program; recorded no-op."""

    def _device(self) -> str:
        return f"cuda:{self._device_id}" if self._use_accel else "cpu"

    def summary(self):
        return {
            "model": self._path,
            "device": "gpu" if self._use_accel else "cpu",
            "precision": self._precision.name,
        }


def _host(t) -> np.ndarray:
    """A fetched output as numpy: bf16 widens to f32 (exact; numpy has no
    bfloat16)."""
    import torch

    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


class Tensor:
    """Named feed/fetch handle. Feeds are held as host arrays until
    ``run``; fetches stay on the device until ``copy_to_cpu``."""

    def __init__(self, name: str, store: Dict[str, object]):
        self._name = name
        self._store = store

    def name(self):
        return self._name

    def copy_from_cpu(self, arr: np.ndarray):
        self._store[self._name] = np.ascontiguousarray(arr)

    def copy_to_cpu(self) -> np.ndarray:
        return _host(self._store[self._name])

    def reshape(self, shape):
        if self._name in self._store:
            self._store[self._name] = self._store[self._name].reshape(shape)

    def shape(self):
        return list(self._store[self._name].shape)


class Predictor:
    """Runs a saved model: ``jit.load`` on the config's device, with named
    feed and fetch slots (``x0``.., ``out0``..)."""

    def __init__(self, config: Config):
        from .. import jit

        if config._path is None:
            raise ValueError("Config has no model path (set_prog_file)")
        self._device = config._device()
        self._layer = jit.load(config._path, device=self._device)
        self._inputs: Dict[str, object] = {}
        self._outputs: Dict[str, object] = {}
        n_in = getattr(self._layer, "num_inputs", None)
        self._input_names = [f"x{i}" for i in range(n_in)] if n_in else ["x0"]
        self._output_names = ["out0"]

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_output_names(self) -> List[str]:
        return list(self._output_names)

    def get_input_handle(self, name) -> Tensor:
        return Tensor(name, self._inputs)

    def get_output_handle(self, name) -> Tensor:
        return Tensor(name, self._outputs)

    def run(self):
        import torch

        args = [torch.from_numpy(np.asarray(self._inputs[n])).to(self._device)
                for n in self._input_names if n in self._inputs]
        out = self._layer(*args)
        outs = out if isinstance(out, (list, tuple)) else [out]
        self._output_names = [f"out{i}" for i in range(len(outs))]
        self._outputs.clear()
        for n, o in zip(self._output_names, outs):
            self._outputs[n] = o
        return True


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


class PredictorPool:
    """N predictors over one model."""

    def __init__(self, config: Config, size: int = 1):
        self._preds = [Predictor(config) for _ in range(size)]

    def retrieve(self, idx: int) -> Predictor:
        return self._preds[idx]


class XpuConfig:
    """XPU deployment config: no counterpart on the card; a bag of knobs."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def get_version() -> str:
    return __version__


def _get_phi_kernel_name(op_name: str) -> str:
    """The op name is its own kernel name here."""
    return op_name


def get_trt_compile_version():
    return (0, 0, 0)  # no TensorRT


def get_trt_runtime_version():
    return (0, 0, 0)


def get_num_bytes_of_data_type(dtype: DataType) -> int:
    return _DT_BYTES[dtype]


def convert_to_mixed_precision(model_file, params_file, mixed_model_file,
                               mixed_params_file,
                               mixed_precision=PrecisionType.Half,
                               backend=PlaceType.GPU, keep_io_types=True,
                               black_list=None, **kw):
    """Exported programs fix their dtypes when traced: build the model in
    the precision wanted (or under ``amp.auto_cast``) and ``jit.save`` it
    instead."""
    raise NotImplementedError(
        "convert_to_mixed_precision operates on ProgramDesc files; with "
        "torch.export programs, build the model in bfloat16 (or trace it "
        "under paddle_tpu_torch.amp.auto_cast) and jit.save it instead."
    )
