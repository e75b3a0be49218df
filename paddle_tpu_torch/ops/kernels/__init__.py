"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their build.

Each ``*.cu`` source here exports plain-C launch functions; it is
compiled by ``nvcc`` into its own shared library under
``<checkout>/build/torch_kernels/`` at first use and bound with ``ctypes``
(pointers from ``Tensor.data_ptr()``, the stream from
``torch.cuda.current_stream().cuda_stream``). A plain C interface keeps
PyTorch's headers out of the build, which is what keeps it at seconds
rather than minutes. Nothing here runs at import: the CPU tests import
every module of the package on machines with no card and no ``nvcc``.

Every kernel wrapper registers itself with :func:`kernel_wrapper` and
carries a plain-int ``launches`` count that it bumps where it launches its
kernel and nowhere else, so a run can show the main path went through it.
A wrapper that picks one of several kernels up front also counts each
launch under its variant (``launch_counts()`` key ``"<name>:<variant>"``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

__all__ = [
    "KERNELS", "kernel_wrapper", "launch_counts", "reset_launch_counts",
    "build", "load", "build_dir", "SOURCES", "HEAD_DIMS", "dtype_code",
    "OBSERVERS", "report",
]

# observers of the kernels' outputs (``amp.debugging``): a ctypes launch is
# invisible to the dispatcher, so each wrapper hands what it wrote to these,
# ``fn(kernel_name, outputs)``, when any is installed
OBSERVERS: list = []


def report(name: str, *outs) -> None:
    """Hand a launch's outputs to every observer (called by the wrappers
    only when ``OBSERVERS`` is not empty)."""
    for obs in list(OBSERVERS):
        obs(name, outs)

_HERE = Path(__file__).resolve().parent

# library name -> (source file, {C launch symbol: ctypes argtypes})
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# flash backward: dtype, q, k, v, do, lse, delta, out1, out2, B, H, HKV, Sq,
# Sk, D, host array of 18 strides (batch, seq, head of q, k, v, do, out1,
# out2), scale, causal, stream
_FLASH_BWD_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _P, _F, _I, _P]
# flash forward: dtype, q, k, v, out, lse, B, H, HKV, Sq, Sk, D,
# q/k/v/out strides (batch, seq, head), scale, causal, stream
_FLASH_FWD_ARGS = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _P]
SOURCES = {
    "paged_decode_attention": (
        "paged_decode_attention.cu", {
            "paged_decode_attention_launch":
            # dtype, q, k_pool, v_pool, tables, cache_len, its stride, out,
            # partials, tickets, B, H, KVH, NB, BS, P, D, splits, pages per
            # split, scale, stream
            [_I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _I, _I, _I, _F, _P],
            "paged_decode_attention_int8_launch":
            # dtype, q, k_pool, v_pool, k_scale, v_scale, tables,
            # cache_len, its stride, out, partials, tickets, B, H, KVH, NB,
            # BS, P, D, splits, pages per split, scale, stream
            [_I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I,
             _I, _I, _I, _I, _I, _F, _P]}),
    "flash_attention_fwd": (
        "flash_attention_fwd.cu", {
            "flash_attention_fwd_launch": _FLASH_FWD_ARGS,  # f32
            "flash_attention_fwd_wgmma_launch": _FLASH_FWD_ARGS}),  # bf16/f16
    "flash_attention_bwd": (
        "flash_attention_bwd.cu", {
            "flash_attention_bwd_dq_launch": _FLASH_BWD_ARGS,  # CUDA cores
            "flash_attention_bwd_dkv_launch": _FLASH_BWD_ARGS,
            "flash_attention_bwd_dq_wgmma_launch": _FLASH_BWD_ARGS,  # wgmma
            "flash_attention_bwd_dkv_wgmma_launch": _FLASH_BWD_ARGS}),
    "fused_adamw": (
        "fused_adamw.cu", {"fused_adamw_multi_launch":
        # p/g/m dtype codes, sr, host table (T rows of p, g, m, v pointers,
        # numel and SR index base, int64), T, scalars (f32 [T, 4]), salts
        # (int64 [T, 2]),
        # beta1, 1 - beta1, beta2, 1 - beta2, stream
        [_I, _I, _I, _I, _P, _I, _P, _P, _F, _F, _F, _F, _P]}),
}

NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes shared by every launch function (common.cuh)
_DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}
# head dims every kernel is instantiated for
HEAD_DIMS = (64, 128, 256)

KERNELS: Dict[str, Callable] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def kernel_wrapper(name: str, variants: Iterable[str] = ()):
    """Register a kernel wrapper under ``name`` and give it ``launches = 0``
    and, per variant, ``variant_launches[variant] = 0``."""
    def deco(fn):
        fn.launches = 0
        fn.variant_launches = dict.fromkeys(variants, 0)
        KERNELS[name] = fn
        return fn
    return deco


def launch_counts() -> Dict[str, int]:
    counts = {}
    for name, fn in KERNELS.items():
        counts[name] = fn.launches
        for variant, n in fn.variant_launches.items():
            counts[f"{name}:{variant}"] = n
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        fn.variant_launches = dict.fromkeys(fn.variant_launches, 0)


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Set every count to its value in ``counts`` (``launch_counts()``'s
    form)."""
    for name, fn in KERNELS.items():
        fn.launches = counts.get(name, 0)
        for variant in fn.variant_launches:
            fn.variant_launches[variant] = counts.get(f"{name}:{variant}", 0)


def count_delta(before: Dict[str, int], after: Dict[str, int]
                ) -> Dict[str, int]:
    """``after - before`` per count (``launch_counts()``'s form)."""
    return {k: v - before.get(k, 0) for k, v in after.items()}


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` to the counts: a CUDA-graph replay launches the
    kernels its capture counted, without running their wrappers."""
    set_launch_counts({k: v + delta.get(k, 0)
                       for k, v in launch_counts().items()})


def build_dir() -> Path:
    """``<checkout>/build/torch_kernels`` (``.gitignore`` lists it)."""
    return _HERE.parents[2] / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, from the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [_HERE / SOURCES[name][0], *sorted(_HERE.glob("*.cuh"))]:
        h.update(src.read_bytes())
    digest = h.hexdigest()[:12]
    return build_dir() / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` per source, all started together. Returns the seconds
    each build took (0.0 for one already built). The compiler's
    register/shared-memory report lands in ``<name>.log`` beside the
    library. Processes sharing the checkout may build at once: each writes
    its own temporary library and log and renames them into place, so a
    library is either whole or absent."""
    names = list(SOURCES if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    times = {}
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            times[name] = 0.0
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(_HERE / SOURCES[name][0])]
        log = open(out_dir / f"{name}.{os.getpid()}.log", "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, lib, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        os.replace(log.name, out_dir / f"{name}.log")
        times[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    if failed:
        logs = "\n".join(
            f"--- {n} ---\n{(out_dir / f'{n}.log').read_text()[-4000:]}"
            for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return times


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use, with its argtypes set."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for symbol, argtypes in SOURCES[name][1].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def dtype_code(name: str, dtype) -> int:
    """The launch functions' code for ``dtype``; raises for a type the
    kernels do not take."""
    code = _DTYPE_CODES.get(str(dtype).replace("torch.", ""))
    if code is None:
        raise ValueError(f"{name} kernel takes f32/bf16/f16, got {dtype}")
    return code


def check_launch(name: str, err: int) -> None:
    """Raise on a launch function's non-zero return (a ``cudaError_t``,
    or -1 for a shape the kernel does not take)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with error {err}")
