#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version at the shapes the main paths give it, then drives the
port's main paths at full width on Llama-542M (vocab 32000, hidden 2048,
ffn 5632, 8 layers, 16 heads, 16 kv heads, bf16) with random weights made
from ``--seed``: the serving slice's cache-less scoring
``LlamaForCausalLM.forward`` (flash-forward kernel) and
``ContinuousBatchingEngine`` (paged-decode kernel), as
``benchmarks/serving_throughput.py`` configures them; the shared-prefix
workload of that script's router mode on two engines with the prefix cache
behind a ``ClusterRouter``, over int8 KV pools (int8 paged-decode kernel)
and over bf16 pools; and the
training slice's flagship step of ``bench.py:main()`` (B=4, S=2048,
masterless bf16 ``AdamW(lr=1e-4, moment_dtype="bfloat16",
use_stochastic_rounding=True, fused=True)`` through
``jit.to_static(...).multi_step``: flash forward and backward kernels, the
fused-AdamW kernel once a step over all 75 tensors); and the engine's
decode loop (phase 11): its decode programs eager, captured as CUDA graphs
and pipelined with ``overlap=True``, speculative decoding on bf16 and int8
pools, and ``generate`` captured and sampling; and the engine's front
door (phase 12): the prefill programs captured (whole-prompt and chunked),
overload control at twice the calibrated capacity with deadlines and
priorities, tracing and the resource ledger on, and the host-RAM prefix
tier with corrupt-spill chaos; and disaggregated serving (phase 13), that
script's Part 5: a ``prefill_only`` and a ``decode_only`` engine handing
KV blocks over through a store, in one process against the unified
engine's streams (bf16, then int8 pools in overlap mode), then as two
worker processes over a ``TCPKVStore`` in turns with the unified engine,
and a prefill worker killed in the middle of a handoff; and the
low-precision GEMMs (phase 14): the fp8 and int8 GEMMs alone at the
flagship's shapes against their plain versions (``torch._scaled_mm`` and
``torch._int_mm`` on the card's layouts), the fp8 train step
(``amp.convert_to_fp8``, big_mfu_decomp.py's variant) against bf16 in
turns, eager and captured, ``ContinuousBatchingEngine(fp8=True)`` against
bf16 on phase 4's and phase 5b's workloads, and ``generate`` over int8 and
int4 weight-only and llm.int8 models; and the serving control plane (phase
15), ``benchmarks/loadgen.py``'s autoscale scenario: an open-loop trace
over a ``ClusterRouter`` that a ``FleetAutoscaler`` grows from one replica
to three under an ``AlertManager``'s TTFT burn rule, with capture events
and the lock sanitizer on, then a drain whose victim is killed mid-drain
and a retirement back to one replica; and the deployment path (phase
16); and collectives and data-parallel training (phase 17): the 17
collectives, ``DataParallel`` around the flagship step captured under
NCCL at world size 1, then two gloo ranks on the one card through
``python -m paddle_tpu_torch.distributed.launch`` (this script re-run as
each rank, ``--rank17``): the collectives on CUDA against CPU tensors,
``DataParallel`` at full depth, and group-sharded stages 1-3 at two
layers against it; and tensor parallelism (phase 18): ``fleet.init`` with
``mp_degree=2``, ``fleet.distributed_model`` (``TensorParallel``) and
``fleet.distributed_optimizer`` around the flagship step in two gloo ranks
(``--rank17 tp``) against a serial run's losses on the same weights, then
recompute on every layer and the sequence-parallel pair at the MLP's
widths, then dp=2 x mp=2 in four ranks (``--rank17 hybrid``) with the
hybrid clip; and the rest of meta_parallel (phase 19): the flagship as a
``PipelineLayer`` at pp=2 (V=1, then V=2) through
``fleet.distributed_model`` (``PipelineParallel``, point-to-point sends
between two gloo ranks, ``--rank17 pp``) against phase 18's serial run,
ring attention and a ``SegmentParallel`` step at sep=2, MoE with its
experts over ep=2 in both dispatch modes, then dp=2 x pp=2 in four ranks
(``--rank17 ppdp``) with the clip over the stages; and the model zoo
(phase 21): GPT-3-13B at full depth built on the card and served by
``generate`` over dense, paged and int8 paged caches, its train step at
full width and two layers, BERT-base's MLM fine-tune without and with a
padding mask, the SD UNet's train step at ``UNetConfig()`` (the flash
kernels at 77-token keys in its cross-attention), and the layers'
semantics against float64; and the vision slice (phase 22): ResNet-50 at
1000 classes and 224 px, B=128 in f32, trained by the reference's SGD
recipe eager and captured against float64 and an eager twin, its
gradients through the convergence recipe's fused AdamW, the pools at the
stem's shape against float64, and ``nms`` and ``roi_align`` at a
detection-sized input against the CPU. Each main path runs
with every kernel launch count set to 0 just before it and read just
after; a kernel
of the path that did not launch, or launched another number of times than
the path needs, fails the run. Outputs are checked against the plain paths
and, at a small f32 size, against the CPU.

Prints one line per phase, then a ``{"kernels": [...]}`` JSON line, then the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, when CUDA is absent or any phase fails.
Imports nothing of JAX. Timings: CUDA events around repeated launches after
warm-up; the paged decode's and AdamW's kernel times (short kernels behind
a wrapper's host work) from the profiler's device time of the kernel
(or, where its trace holds no launch of it, CUDA events around a CUDA
graph of the calls), taken last (phase 9), since a profiler session slows the host work of the
phases after it; peaks are the H100 SXM data sheet's (3.35 TB/s HBM, 989 TFLOP/s dense
bf16, 67 TFLOP/s f32 outside the tensor cores) at a 700 W power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import random
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12

# benchmarks/serving_throughput.py:848-851 (model) and :111-126 (serving)
LLAMA_542M = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                  num_hidden_layers=8, num_attention_heads=16,
                  num_key_value_heads=16, max_position_embeddings=4608)
SERVE = dict(max_batch=16, max_len=2048, block_size=64,
             num_blocks=16 * (640 // 64) + 16, prompt_pad=512,
             decode_chunk=16)
PROMPT_LENS = (256, 384, 512)
N_REQUESTS, NEW_TOKENS = 32, 32
# benchmarks/serving_throughput.py:341-380 (router mode, on-TPU numbers):
# two replicas behind a ClusterRouter, every third request interactive and
# the rest batch; then 4 exact repeats of its first prompts, each in its
# original's session, so that fully cached prompts fork their last block
# on the card
PREFIX_SERVE = dict(max_batch=8, max_len=1024, block_size=64,
                    prefill_chunk=256, num_blocks=8 * 16 + 8,
                    prefix_cache=True)
PREFIX_FAMILIES, PREFIX_LEN, PREFIX_TAILS = 4, 512, (64, 128)
PREFIX_REQUESTS, PREFIX_REPEATS, PREFIX_NEW = 64, 4, 32
KV_REL_TOL = 0.05  # int8 against bf16 pools, the reference's quality gate
# bench.py:434-441 (flagship model and batch) and :448-477 (optimizer)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 6
TRAIN_LR = 1e-4
# the fused AdamW launches once a step per (p, g, m dtype, SR) group of
# parameters: the flagship's 75 tensors are all bf16 with SR, one group
ADAMW_GROUPS = 1
# phase 2's engine-like decode: phase 5b's batch and table width
# (max_len 1024), every row between one and two thirds of the way in
ENGINE_DECODE = dict(B=8, pages=1024 // 64, lo=512, hi=704)
# phase 13's decode: B=8 rows of a 4096-token prompt and its growth over
# 8-token blocks and 544-page tables (max_len 4352)
DISAGG_DECODE = dict(B=8, pages=4352 // 8, lo=4096, hi=4352, bs=8)
GRAD_DEPTH = 2  # phase 8's layers: the plain attention path holds
                # [4, 16, 2048, 2048] f32 scores per layer for backward

# bf16 kernel vs plain version, |kernel - plain| <= ATOL + RTOL * |plain|:
# paged decode: the plain path rounds logits to bf16, the kernel keeps f32;
# flash: the kernel rounds P to bf16 for P @ V (as the TPU kernel does), the
# plain version keeps f32. Either way about two bf16 ulps of the output
# (2^-7 relative), so RTOL 2e-2 covers outputs of any size.
PAGED_ATOL, FLASH_ATOL, RTOL = 3e-2, 2e-2, 2e-2
# float paged decode, bf16 q and pools: besides PAGED_ATOL + RTOL against
# the plain version, each (sequence, head) row within PAGED_ROW_REL of its
# norm there, and a gate against the plain version run in f32 on the
# kernel's own pre-scaled q, which leaves only the kernel's final rounding
# to bf16: every element within PAGED_F32_ATOL + PAGED_F32_RTOL, each row
# within PAGED_F32_ROW_REL. A long row averages ~1000 V rows, so its
# outputs are ~0.04, as large as PAGED_ATOL. Set from the kernel's first
# measurement on the H100 (phase 2, B=16 and 64, and gate_mutants.py):
# worst row 0.0140 against the plain version (2.5x margin), 0.0021 against
# the f32 version (2.4x), whose elementwise error lies inside rtol 8e-3
# (one bf16 ulp) with an atol of 1e-8: the INT8_F32_* bounds.
PAGED_ROW_REL, PAGED_F32_ATOL, PAGED_F32_RTOL, PAGED_F32_ROW_REL = (
    3.5e-2, 1e-4, 8e-3, 5e-3)
# int8 paged decode, bf16 q, two gates. (1) Against the plain version,
# which rounds logits, probabilities and each dequantized K/V element to
# bf16 where the kernel keeps f32: a long row averages ~1000 V rows, so its
# outputs are ~0.04, as large as PAGED_ATOL; the gate is a few bf16 ulps of
# that scale, and the norm-relative error of each (sequence, head) row,
# whose rounding noise does not average out where a few keys dominate
# (up to 0.017, an f32 emulation of the kernel on the CPU). (2) Against the
# plain version run in f32 on the kernel's own pre-scaled q, which leaves
# only the kernel's final rounding to bf16: one bf16 ulp, 5e-3 per row.
INT8_ATOL, INT8_RTOL, INT8_ROW_REL = 8e-3, 1e-2, 3e-2
INT8_F32_ATOL, INT8_F32_RTOL, INT8_F32_ROW_REL = 1e-4, 8e-3, 5e-3
# flash forward, bf16: besides FLASH_ATOL + RTOL against the plain version
# and lse within FLASH_LSE_ATOL, a gate against the plain version run in
# f32 with P rounded to bf16 before P @ V (the kernel's rounding points):
# each (b, s, h) row of D values within FLASH_ROW_REL of its norm, and
# every element within FLASH_F32_ATOL + FLASH_F32_RTOL. A late row at
# S=2048 averages ~1000 V rows, so its entries are ~0.03: a kernel that
# reads one stale 64-key V tile moves such a row by ~25% of its norm
# (~0.01 absolute, inside FLASH_ATOL), and leaves lse, which depends on K
# alone, as it was. Set from the mma.sync kernel's first measurement on
# the H100 (gate_mutants.py): worst row 0.0038 (2.6x margin); max abs err
# 0.0010 non-causal (2x margin) and 0.0078 causal, on early rows of size ~1
# that the rtol covers.
FLASH_LSE_ATOL = 1e-3
FLASH_ROW_REL, FLASH_F32_ATOL, FLASH_F32_RTOL = 1e-2, 2e-3, 1e-2
LOGITS_REL_TOL = 5e-2  # 8 bf16 layers, kernel vs plain attention
# flash backward, bf16, two gates. (1) Against the plain version, which
# keeps P and dS in f32 where the kernels round them to bf16 before their
# products (the TPU kernels' rounding points): dq/dk/dv of unit scale
# differ by a few bf16 ulps, BWD_ATOL + BWD_RTOL, and BWD_REL in the norm of
# the whole tensor. A stale or dropped tile moves only some rows, and the
# whole tensor's norm dilutes it. (2) Against the plain version run in f32
# with P and dS rounded to bf16 where the kernels round them (p_dtype):
# each row of D values (dq: (b, s, h); dk, dv: (b, s_k, h_kv)) within
# BWD_ROW_REL of its norm, and every element within BWD_F32_ATOL +
# BWD_F32_RTOL. A row's norm counts at least BWD_ROW_FLOOR of the
# tensor's RMS row norm: under causal masking dq's first row sees one key,
# so dP = delta there in exact arithmetic and that row is rounding noise.
# Set from the mma.sync kernels' first measurement on the H100
# (chip_smoke.py and gate_mutants.py, phase 2's three configurations):
# worst row 0.0056 (2.5x margin; the wgmma kernels' worst is 0.0064); atol
# needed beside rtol 1e-2 0.0011 for MHA, but 0.069 for GQA, whose dK/dV
# those kernels wrote per query head in bf16 before the group sum: hence
# BWD_F32_ATOL 0.17 then. The wgmma kernels sum each group in f32 and need
# at most 0.0023, so the bound is now 1e-2 (4.3x).
BWD_ATOL, BWD_RTOL, BWD_REL = 5e-2, 5e-2, 1e-2
BWD_ROW_REL, BWD_F32_ATOL, BWD_F32_RTOL, BWD_ROW_FLOOR = 1.4e-2, 1e-2, 1e-2, 1e-2
# phase 8: gradients of every parameter through 2 bf16 layers, kernels
# against the plain paths (naive attention rounds its logits and
# probabilities to bf16; the kernels keep scores in f32)
GRAD_REL_TOL = 5e-2
ARGMAX_MIN = 0.9
# the flash kernels that bf16 at head_dim 128 must take on the main paths
# (phases 3 and 7 count the forward's launches per variant, phase 7 the
# backward's)
FLASH_MAIN_VARIANT = "wgmma"
BWD_MAIN_VARIANT = "wgmma"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def flash_fwd_counts(n: int):
    """The flash forward's expected launch counts when a path launches it
    ``n`` times: all of them on FLASH_MAIN_VARIANT."""
    from paddle_tpu_torch.ops.flash_attention import FWD_VARIANTS

    counts = {"flash_attention_fwd": n}
    for v in FWD_VARIANTS:
        counts[f"flash_attention_fwd:{v}"] = n if v == FLASH_MAIN_VARIANT else 0
    return counts


def flash_bwd_counts(n: int):
    """The flash backward's expected launch counts when a path runs it
    ``n`` times: ``n`` dq and ``n`` dk/dv launches, all on
    BWD_MAIN_VARIANT."""
    from paddle_tpu_torch.ops.flash_attention import BWD_VARIANTS

    counts = {}
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        counts[name] = n
        for v in BWD_VARIANTS:
            counts[f"{name}:{v}"] = n if v == BWD_MAIN_VARIANT else 0
    return counts


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, match: str, iters: int = 20, warmup: int = 2):
    """The mean device time of a launch of the kernel whose name holds
    ``match``, from the profiler's trace of ``iters`` calls of ``fn``
    (each launching it once): the kernel alone, without the wrapper's host
    work, which CUDA events around a wrapper whose kernel is shorter than
    that host work would measure. The mean is over the launches the trace
    recorded, which can be fewer than ``iters``. Also times the ``iters``
    calls captured in one CUDA graph, by CUDA events around its replay
    (device time without the host work, launch gaps within the graph
    included), and takes that time where the trace holds no launch of the
    kernel. Returns ``(ms, how)``: the time and the words saying how it
    was taken."""
    import torch
    from paddle_tpu_torch.ops import kernels

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and match in e.key]
    launches = sum(e.count for e in seen)
    n0 = sum(f.launches for f in kernels.KERNELS.values())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    if sum(f.launches for f in kernels.KERNELS.values()) - n0 < iters:
        fail(f"the CUDA graph timing {match!r} holds fewer than {iters} "
             f"kernel launches")
    replay_ms = time_ms(graph.replay, 5, warmup=1) / iters
    del graph
    if launches == 0:
        return replay_ms, (f"the profiler's trace held no launch of "
                           f"{match!r}: CUDA events around a CUDA graph of "
                           f"{iters} calls")
    ms = sum(e.self_device_time_total for e in seen) / 1e3 / launches
    return ms, (f"profiler device time; {replay_ms:.4f} ms a call in a CUDA "
                f"graph of {iters}")


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


@contextlib.contextmanager
def plain_paths(optimizers=()):
    """Route the main paths through the plain PyTorch versions: naive
    attention (forward and its autograd backward) in place of the flash
    kernels, the flash backward's plain version should the flash path be
    taken, the gather path for paged decode, and the unfused update for
    each AdamW in ``optimizers``."""
    from paddle_tpu_torch.nn.functional import attention as A
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops import paged_attention as PA

    saved = (A._use_flash, PA.paged_decode, PA.paged_decode_int8,
             FA.flash_attention_bwd)
    fused = [o._fused for o in optimizers]
    A._use_flash = lambda *a, **k: False
    PA.paged_decode = PA.paged_decode_plain
    PA.paged_decode_int8 = PA.paged_decode_int8_plain
    FA.flash_attention_bwd = FA.flash_attention_bwd_plain
    for o in optimizers:
        o._fused = False
    try:
        yield
    finally:
        (A._use_flash, PA.paged_decode, PA.paged_decode_int8,
         FA.flash_attention_bwd) = saved
        for o, f in zip(optimizers, fused):
            o._fused = f


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def row_rel_err(a, b, floor: float = 0.0) -> float:
    """The worst norm-relative error over the rows of the last axis, each
    row's norm counted as at least ``floor`` of the RMS row norm."""
    a, b = a.float(), b.float()
    norms = b.norm(dim=-1)
    least = max(floor * float(norms.pow(2).mean().sqrt().detach()), 1e-30)
    return float(((a - b).norm(dim=-1) / norms.clamp_min(least)).max())


def _prescaled_q32(q):
    """The decode kernels' q in f32: rounded as the kernels round it,
    ``q * (1/sqrt(D))`` in q's dtype, then taken back to unit scale in f32
    for the plain versions' own scaling."""
    import math

    import torch

    d = q.shape[-1]
    scale = q.new_tensor(1.0 / math.sqrt(d), dtype=torch.float32).to(q.dtype)
    return (q * scale).float() * math.sqrt(d)


def int8_plain_f32(q, *rest):
    """The int8 kernel's plain version in f32 on the kernel's q."""
    from paddle_tpu_torch.ops.paged_attention import paged_decode_int8_plain

    return paged_decode_int8_plain(_prescaled_q32(q), *rest)


def paged_plain_f32(q, k_pool, v_pool, *rest):
    """The float kernel's plain version in f32 on the kernel's q and on the
    pools taken to f32 (exactly, as the kernel reads them)."""
    from paddle_tpu_torch.ops.paged_attention import paged_decode_plain

    return paged_decode_plain(_prescaled_q32(q), k_pool.float(),
                              v_pool.float(), *rest)


def flash_references(q, k, v, causal):
    """The flash forward's two references: the plain version (out in q's
    dtype, lse) and the plain version run in f32 with P rounded to q's
    dtype before ``P @ V`` (f32 out)."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd_plain

    want, want_lse = flash_attention_fwd_plain(q, k, v, causal)
    want32, _ = flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                          causal, p_dtype=q.dtype)
    return want, want_lse, want32


def flash_gate(out, lse, want, want_lse, want32):
    """The flash forward's gates (see FLASH_*) on ``(out, lse)`` against
    :func:`flash_references`. Returns a dict of the errors, ``old_ok``
    (the FLASH_ATOL + RTOL and lse gates alone) and ``ok`` (all gates)."""
    import torch

    g, w, w32 = out.float(), want.float(), want32.float()
    r = dict(max_abs_err=float((g - w).abs().max()), rel_err=rel_err(g, w),
             lse_err=float((lse - want_lse).abs().max()),
             row_rel=row_rel_err(g, w32),
             f32_max_abs_err=float((g - w32).abs().max()))
    finite = bool(torch.isfinite(g).all())
    r["old_ok"] = (finite and r["lse_err"] <= FLASH_LSE_ATOL
                   and torch.allclose(g, w, atol=FLASH_ATOL, rtol=RTOL))
    r["ok"] = (r["old_ok"] and r["row_rel"] <= FLASH_ROW_REL
               and torch.allclose(g, w32, atol=FLASH_F32_ATOL,
                                  rtol=FLASH_F32_RTOL))
    return r


def bwd_references(q, k, v, out, lse, do, causal):
    """The flash backward's two references: the plain version ((dq, dk,
    dv) in the input dtypes) and the plain version run in f32 with P and dS
    rounded to q's dtype where the kernels round them (f32)."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_bwd_plain

    want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    want32 = flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(), causal,
        p_dtype=q.dtype)
    return want, want32


def atol_needed(got, want, rtol: float) -> float:
    """The least atol with which ``allclose(got, want, atol, rtol)`` holds."""
    return max(0.0, float(((got - want).abs() - rtol * want.abs()).max()))


def bwd_gate(got, want, want32):
    """The flash backward's gates (see BWD_*) on ``got = (dq, dk, dv)``
    against :func:`bwd_references`. Returns ``{name: errors}`` for dq, dk,
    dv, plus ``old_ok`` (the whole-tensor gate alone) and ``ok`` (all
    gates)."""
    import torch

    r, old_ok, ok = {}, True, True
    for name, g, w, w32 in zip(("dq", "dk", "dv"), got, want, want32):
        g, w, w32 = g.float(), w.float(), w32.float()
        e = dict(max_abs_err=float((g - w).abs().max()), rel_err=rel_err(g, w),
                 row_rel=row_rel_err(g, w32, BWD_ROW_FLOOR),
                 f32_max_abs_err=float((g - w32).abs().max()),
                 f32_atol_needed=atol_needed(g, w32, BWD_F32_RTOL))
        o = (bool(torch.isfinite(g).all()) and e["rel_err"] <= BWD_REL
             and torch.allclose(g, w, atol=BWD_ATOL, rtol=BWD_RTOL))
        r[name] = e
        old_ok &= o
        ok &= (o and e["row_rel"] <= BWD_ROW_REL
               and torch.allclose(g, w32, atol=BWD_F32_ATOL,
                                  rtol=BWD_F32_RTOL))
    r["old_ok"], r["ok"] = old_ok, ok
    return r


def decode_gate(got, want, want_f32, int8: bool = False):
    """The paged-decode kernels' two gates (see PAGED_* and INT8_*):
    against the plain version ``want`` and against ``want_f32`` from
    :func:`paged_plain_f32` or :func:`int8_plain_f32`. Returns a dict of
    the errors, ``old_ok`` (PAGED_ATOL + RTOL alone) and ``ok``."""
    import torch

    atol, rtol, row, f_atol, f_rtol, f_row = (
        (INT8_ATOL, INT8_RTOL, INT8_ROW_REL, INT8_F32_ATOL, INT8_F32_RTOL,
         INT8_F32_ROW_REL) if int8 else
        (PAGED_ATOL, RTOL, PAGED_ROW_REL, PAGED_F32_ATOL, PAGED_F32_RTOL,
         PAGED_F32_ROW_REL))
    g, w, w32 = got.float(), want.float(), want_f32.float()
    r = dict(max_abs_err=float((g - w).abs().max()), row_rel=row_rel_err(g, w),
             f32_max_abs_err=float((g - w32).abs().max()),
             f32_row_rel=row_rel_err(g, w32),
             f32_atol_needed=atol_needed(g, w32, f_rtol))
    finite = bool(torch.isfinite(g).all())
    r["old_ok"] = finite and torch.allclose(g, w, atol=PAGED_ATOL, rtol=RTOL)
    r["ok"] = (finite and r["row_rel"] <= row
               and torch.allclose(g, w, atol=atol, rtol=rtol)
               and r["f32_row_rel"] <= f_row
               and torch.allclose(g, w32, atol=f_atol, rtol=f_rtol))
    return r


# -- phase 2: kernels against their plain versions ----------------------
def paged_inputs(torch, dev, gen, gen_cpu, B, pages=2048 // 64, lo=1,
                 hi=2048, bs=64, heads=16):
    """Phase 2's paged-decode inputs: bf16 pools [heads, B*pages + 1, bs,
    128] behind shuffled tables (pages past the live ones hold the trash
    block), lengths drawn from lo..hi with the spread's two ends, bf16 q
    of ``heads`` heads. Returns ``(q, k_pool, v_pool, tables, cache_len,
    lengths)``."""
    H = KVH = heads
    D, BS, P = 128, bs, pages
    nb = B * P + 1
    trash = nb - 1
    lengths = torch.randint(lo, hi + 1, (B,), generator=gen_cpu)
    lengths[0], lengths[-1] = lo, hi  # the spread's two ends
    perm = torch.randperm(B * P, generator=gen_cpu)
    tables = perm.reshape(B, P).to(torch.int32)
    for b in range(B):  # pages past the live ones hold the trash id
        tables[b, -(-int(lengths[b]) // BS):] = trash
    tables = tables.to(dev)
    kp = torch.randn(KVH, nb, BS, D, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(KVH, nb, BS, D, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(torch.bfloat16)
    cl = (lengths - 1).to(torch.int32).to(dev)
    return q, kp, vp, tables, cl, lengths


def replayed(torch, dev, *states):
    """Fresh generators, on the card then the CPU, in the given states."""
    gens = (torch.Generator(device=dev), torch.Generator(device="cpu"))
    for g, s in zip(gens, states):
        g.set_state(s)
    return gens


def paged_case(torch, dev, gen, gen_cpu, B, int8=False, **shape):
    """The float kernel on bf16 pools; with ``int8`` also the int8 kernel
    on those pools quantized, at the same tables and lengths. ``shape``:
    :func:`paged_inputs`' table width and length range. Each row's
    ``device`` times its kernel (phase 9) on the same inputs made anew."""
    from paddle_tpu_torch.ops.paged_attention import (
        _kv_quantize, decode_splits, paged_decode, paged_decode_int8,
        paged_decode_int8_plain, paged_decode_plain)

    states = (gen.get_state(), gen_cpu.get_state())
    q, kp, vp, tables, cl, lengths = paged_inputs(torch, dev, gen, gen_cpu, B,
                                                  **shape)

    def device(quantized):
        q, kp, vp, tables, cl, _ = paged_inputs(
            torch, dev, *replayed(torch, dev, *states), B, **shape)
        if not quantized:
            return device_ms(lambda: paged_decode(q, kp, vp, tables, cl),
                             "paged_decode_kernel", 50)
        (kq, ks), (vq, vs) = _kv_quantize(kp), _kv_quantize(vp)
        del kp, vp
        return device_ms(lambda: paged_decode_int8(q, kq, vq, ks, vs, tables,
                                                   cl),
                         "paged_decode_kernel", 50)

    KVH, _, BS, D = kp.shape
    H = q.shape[2]
    got = paged_decode(q, kp, vp, tables, cl)
    want = paged_decode_plain(q, kp, vp, tables, cl)
    gate = decode_gate(got, want, paged_plain_f32(q, kp, vp, tables, cl))
    rel = rel_err(got, want)
    if not gate["ok"]:
        fail(f"paged decode B={B}: {gate} beyond the PAGED_* gates")
    call_ms = time_ms(lambda: paged_decode(q, kp, vp, tables, cl), 50)
    plain_ms = time_ms(lambda: paged_decode_plain(q, kp, vp, tables, cl), 10)
    live = int(lengths.sum())
    pages = int(sum(-(-int(n) // BS) for n in lengths))
    nbytes = live * KVH * D * 2 * 2 + 2 * B * H * D * 2 + pages * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4.0 * live * H * D)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = decode_splits(tables.shape[1], B, H, sms)
    row = dict(gate, B=B, rel_err=rel, call_ms=call_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               live_tokens=live, nbytes=nbytes, splits=splits, bs=BS,
               device=lambda: device(False))
    if not int8:
        return row, None
    (kq, ks), (vq, vs) = _kv_quantize(kp), _kv_quantize(vp)
    args = (q, kq, vq, ks, vs, tables, cl)
    got = paged_decode_int8(*args)
    want = paged_decode_int8_plain(*args)
    gate = decode_gate(got, want, int8_plain_f32(*args), int8=True)
    rel = rel_err(got, want)
    if not gate["ok"]:
        fail(f"int8 paged decode B={B}: {gate} beyond the INT8_* gates")
    call_ms = time_ms(lambda: paged_decode_int8(*args), 50)
    plain_ms = time_ms(lambda: paged_decode_int8_plain(*args), 10)
    # int8 K and V plus one f32 scale each per live row and kv head
    nbytes = live * KVH * (2 * D + 2 * 4) + 2 * B * H * D * 2 + pages * 4 + B * 4
    # scores and P @ V, and a multiply and a divide to dequantize each
    # element, all in f32
    b_ms, b_by = bound(nbytes, 4.0 * live * (H + KVH) * D, F32_FLOPS_PER_S)
    return row, dict(gate, B=B, rel_err=rel, call_ms=call_ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, live_tokens=live, nbytes=nbytes,
                     splits=splits, bs=BS, device=lambda: device(True))


# phase 2's flash shape: [B, Sq, H, D] queries over [B, Sk, Hkv, D] keys
FLASH_SHAPE = dict(B=4, Sq=2048, Sk=2048, H=16, D=128)


def flash_inputs(torch, dev, gen, hkv, dtype=None, shape=None):
    """Phase 2's flash inputs: bf16 (or ``dtype``) randn q ``[B, Sq, H,
    D]`` and k/v ``[B, Sk, hkv, D]`` of ``shape`` (FLASH_SHAPE by
    default)."""
    sh = shape or FLASH_SHAPE
    B, Sq, Sk, H, D = sh["B"], sh["Sq"], sh["Sk"], sh["H"], sh["D"]
    dt = dtype or torch.bfloat16
    q = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(B, Sk, hkv, D, generator=gen, device=dev).to(dt)
    v = torch.randn(B, Sk, hkv, D, generator=gen, device=dev).to(dt)
    return q, k, v


def attn_pairs(sq: int, sk: int, causal: bool) -> float:
    """The (query, key) pairs attention computes: under causal masking
    (offset ``sk - sq``) row i sees ``i + 1 + sk - sq`` keys, at most sk."""
    if not causal:
        return float(sq * sk)
    return float(sum(min(i + 1 + sk - sq, sk) for i in range(sq)
                     if i + 1 + sk - sq > 0))


def flash_case(torch, dev, gen, causal, hkv, dtype=None, shape=None):
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.flash_attention import (
        _fwd_variant, flash_attention_fwd, flash_attention_fwd_plain)

    q, k, v = flash_inputs(torch, dev, gen, hkv, dtype, shape)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    out, lse = flash_attention_fwd(q, k, v, causal)
    refs = flash_references(q, k, v, causal)
    torch.cuda.synchronize()
    gate = flash_gate(out, lse, *refs)
    del refs
    if not gate["ok"]:
        fail(f"flash causal={causal} hkv={hkv}: {gate} beyond the FLASH_* "
             f"gates")
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal), 10)
    plain_ms = time_ms(lambda: flash_attention_fwd_plain(q, k, v, causal), 3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: TF.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=hkv != H), 10)
    pairs = attn_pairs(Sq, Sk, causal)
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * hkv * D) * 2 + B * H * Sq * 4
    flops = 4.0 * B * H * pairs * D
    b_ms, b_by = bound(nbytes, flops)
    return dict(gate, causal=causal, hkv=hkv,
                variant=_fwd_variant(q.dtype, D),
                rate=f"{flops / ms / 1e9:.1f} TFLOP/s",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def flash_bwd_inputs(torch, dev, gen, causal, hkv, dtype=None, shape=None):
    """Phase 2's flash backward inputs: bf16 (or ``dtype``) randn q, dO
    ``[B, Sq, H, D]`` and k, v ``[B, Sk, hkv, D]`` of ``shape``
    (FLASH_SHAPE by default), with the flash forward's out and lse.
    Returns ``(q, k, v, out, lse, do)``."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd

    q, k, v = flash_inputs(torch, dev, gen, hkv, dtype, shape)
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    out, lse = flash_attention_fwd(q, k, v, causal)
    return q, k, v, out, lse, do


def flash_bwd_case(torch, dev, gen, causal, hkv, dtype=None, shape=None):
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.flash_attention import (
        _bwd_variant, _delta, flash_attention_bwd, flash_attention_bwd_dkv,
        flash_attention_bwd_dq, flash_attention_bwd_plain)

    q, k, v, out, lse, do = flash_bwd_inputs(torch, dev, gen, causal, hkv,
                                             dtype, shape)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    before = {w: dict(w.variant_launches)
              for w in (flash_attention_bwd_dq, flash_attention_bwd_dkv)}
    got = flash_attention_bwd(q, k, v, out, lse, do, causal)
    for w, counts in before.items():
        counts[BWD_MAIN_VARIANT] += 1
        if w.variant_launches != counts:
            fail(f"flash backward causal={causal} hkv={hkv}: {w.__name__} "
                 f"launched {w.variant_launches}, expected {counts}")
    gate = bwd_gate(got, *bwd_references(q, k, v, out, lse, do, causal))
    if not gate["ok"]:
        fail(f"flash backward causal={causal} hkv={hkv}: {gate} beyond the "
             f"BWD_* gates")
    del got
    scale = 1.0 / D ** 0.5
    delta = _delta(out, do)
    dq_ms = time_ms(lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                   causal, scale), 10)
    dkv_ms = time_ms(lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                     causal, scale), 10)
    plain_ms = time_ms(lambda: flash_attention_bwd_plain(
        q, k, v, out, lse, do, causal), 3)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    lib_out = TF.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=hkv != H)
    do_t = do.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), do_t, retain_graph=True), 10)
    pairs = attn_pairs(Sq, Sk, causal)
    reads = ((2 * B * Sq * H * D + 2 * B * Sk * hkv * D) * 2
             + 2 * B * H * Sq * 4)
    mm = 2.0 * B * H * pairs * D  # one Sq x Sk x D product
    dq_bound = bound(reads + B * Sq * H * D * 2, 3 * mm)
    dkv_bound = bound(reads + 2 * B * Sk * hkv * D * 2, 4 * mm)
    return dict(causal=causal, hkv=hkv, gate=gate,
                variant=_bwd_variant(q.dtype, D), dq_ms=dq_ms, dkv_ms=dkv_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                dq_bound=dq_bound, dkv_bound=dkv_bound,
                dq_rate=f"{3 * mm / dq_ms / 1e9:.1f} TFLOP/s",
                dkv_rate=f"{4 * mm / dkv_ms / 1e9:.1f} TFLOP/s")


def embedding_inputs(torch, dev, gen):
    """p, g, m, v of the flagship's 32000 x 2048 embedding, bf16."""
    shape, bf = (32000, 2048), torch.bfloat16
    return (torch.randn(*shape, generator=gen, device=dev).to(bf),
            (1e-2 * torch.randn(*shape, generator=gen, device=dev)).to(bf),
            (1e-3 * torch.randn(*shape, generator=gen, device=dev)).to(bf),
            (1e-5 * torch.rand(*shape, generator=gen, device=dev)).to(bf))


def adamw_case(torch, dev, gen, sr):
    """The flagship's largest tensor: the 32000 x 2048 bf16 embedding with
    bf16 moments, kernel against plain bit for bit. The row's ``device``
    times the kernel (phase 9) on the same inputs made anew."""
    from paddle_tpu_torch.ops.fused_adamw import (
        fused_adamw_hbm_bytes, fused_adamw_update, fused_adamw_update_plain)

    bf = torch.bfloat16
    state = gen.get_state()
    p, g, m, v = embedding_inputs(torch, dev, gen)
    kw = dict(lr=TRAIN_LR, beta1=0.9, beta2=0.999, epsilon=1e-8,
              beta1_pow=torch.tensor(0.9 ** 3, device=dev),
              beta2_pow=torch.tensor(0.999 ** 3, device=dev), weight_decay=0.01,
              sr_salts=(torch.tensor([0x9E3779B9, 0x2545F491], device=dev)
                        if sr else None))
    ref = [t.clone() for t in (p, m, v)]
    fused_adamw_update(p, g, m, v, **kw)
    fused_adamw_update_plain(ref[0], g, ref[1], ref[2], **kw)
    torch.cuda.synchronize()
    for a, b, name in zip((p, m, v), ref, "pmv"):
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            n_diff = int((a.view(torch.int16) != b.view(torch.int16)).sum())
            fail(f"fused AdamW sr={sr}: {name} differs from the plain version "
                 f"in {n_diff} elements")
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip((p, m, v), ref))
    del ref
    call_ms = time_ms(lambda: fused_adamw_update(p, g, m, v, **kw), 20)
    plain_ms = time_ms(lambda: fused_adamw_update_plain(p, g, m, v, **kw), 3)

    def device():
        again = embedding_inputs(torch, dev, replayed(torch, dev, state)[0])
        return device_ms(lambda: fused_adamw_update(*again, **kw),
                         "adamw_multi_kernel", 20)

    # torch's fused Adam(W) on the same tensors: another function (no SR,
    # another epsilon and bias-correction form), timed for scale only
    pf, gf, mf, vf = (t.clone() for t in (p, g, m, v))
    steps = [torch.tensor(3.0, device=dev)]
    lib_ms = time_ms(lambda: torch._fused_adamw_(
        [pf], [gf], [mf], [vf], [], steps, lr=TRAIN_LR, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False), 20)
    n = p.numel()
    nbytes = fused_adamw_hbm_bytes(n, bf, bf, bf)
    b_ms, b_by = bound(nbytes, 10.0 * n, F32_FLOPS_PER_S)
    return dict(sr=sr, max_abs_err=err, call_ms=call_ms, plain_ms=plain_ms,
                torch_fused_adamw_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                nbytes=nbytes, device=device)


def adamw_shard_case(torch, dev, gen):
    """The embedding's two dimension-0 shards, each updated by the kernel
    with its SR index base (its offset in the whole tensor, as group
    sharding passes it), against the whole tensor's update by the kernel:
    bitwise. Returns the elements a shard without its base rounds
    otherwise (reported: the base is what makes the shards agree)."""
    from paddle_tpu_torch.ops.fused_adamw import (adamw_scalars_multi,
                                                  fused_adamw_multi_update)

    whole = list(embedding_inputs(torch, dev, gen))
    parts = [[t.chunk(2, 0)[r].clone() for t in whole] for r in (0, 1)]
    loose = [t.chunk(2, 0)[1].clone() for t in whole]
    salts = torch.tensor([[0x9E3779B9, 0x2545F491]], device=dev)

    def launch(tensors, base):
        p, g, m, v = tensors
        sc = adamw_scalars_multi(
            lr=TRAIN_LR, epsilon=1e-8,
            beta1_pow=torch.full((1,), 0.9 ** 3, device=dev),
            beta2_pow=torch.full((1,), 0.999 ** 3, device=dev),
            weight_decay=[0.01])
        fused_adamw_multi_update([p], [g], [m], [v], scalars=sc, beta1=0.9,
                                 beta2=0.999, sr_salts=salts,
                                 sr_base=None if base is None else [base])

    half = whole[0].numel() // 2
    launch(whole, None)
    for r in (0, 1):
        launch(parts[r], r * half)
    launch(loose, None)
    torch.cuda.synchronize()
    for r in (0, 1):
        for a, b, name in zip(parts[r], whole, "pgmv"):
            if not torch.equal(a.view(torch.int16),
                               b.chunk(2, 0)[r].view(torch.int16)):
                fail(f"fused AdamW: shard {r}'s {name} with its SR base "
                     "differs from the whole tensor's update")
    return int((loose[0].view(torch.int16)
                != whole[0].chunk(2, 0)[1].view(torch.int16)).sum())


def flagship_shapes(cfg=LLAMA_542M):
    """The flagship's parameter shapes, in ``named_parameters`` order: the
    embedding, per layer two norms and seven projections, the final norm
    and the lm head (75 tensors, 542.1M elements for Llama-542M)."""
    hid, ffn = cfg["hidden_size"], cfg["intermediate_size"]
    vocab = cfg["vocab_size"]
    kv = hid // cfg["num_attention_heads"] * cfg["num_key_value_heads"]
    layer = [(hid,), (hid, hid), (hid, kv), (hid, kv), (hid, hid), (hid,),
             (hid, ffn), (hid, ffn), (ffn, hid)]
    return ([(vocab, hid)] + layer * cfg["num_hidden_layers"]
            + [(hid,), (hid, vocab)])


def adamw_multi_inputs(torch, dev, gen, dtype=None, sr=True):
    """The train step's AdamW launch at its shapes: the flagship's 75 bf16
    (or ``dtype``) tensors (p, g, m and v of that type) as lists, f32 beta
    powers [75] of step 3, per-tensor weight decays (none on the norms),
    the batched scalar rows and [75, 2] salts (None without ``sr``). Fails
    unless each scalar row is bitwise the per-tensor prologue's."""
    from paddle_tpu_torch.ops.fused_adamw import (adamw_scalars,
                                                  adamw_scalars_multi)

    bf = dtype or torch.bfloat16
    shapes = flagship_shapes()
    t = len(shapes)
    x = dict(
        ps=[torch.randn(*s, generator=gen, device=dev).to(bf) for s in shapes],
        gs=[(1e-2 * torch.randn(*s, generator=gen, device=dev)).to(bf)
            for s in shapes],
        ms=[(1e-3 * torch.randn(*s, generator=gen, device=dev)).to(bf)
            for s in shapes],
        vs=[(1e-5 * torch.rand(*s, generator=gen, device=dev)).to(bf)
            for s in shapes],
        b1p=torch.full((t,), 0.9 ** 3, device=dev),
        b2p=torch.full((t,), 0.999 ** 3, device=dev),
        wds=[0.0 if len(s) == 1 else 0.01 for s in shapes],
        salts=(torch.randint(0, 2 ** 32, (t, 2), generator=gen, device=dev)
               if sr else None))
    x["scalars"] = adamw_scalars_multi(lr=TRAIN_LR, epsilon=1e-8,
                                       beta1_pow=x["b1p"], beta2_pow=x["b2p"],
                                       weight_decay=x["wds"])
    for i in range(t):
        row = adamw_scalars(lr=TRAIN_LR, epsilon=1e-8, beta1_pow=x["b1p"][i],
                            beta2_pow=x["b2p"][i], weight_decay=x["wds"][i])
        if not torch.equal(row.view(torch.int32),
                           x["scalars"][i].view(torch.int32)):
            fail(f"fused AdamW: the batched scalar row {i} "
                 f"{x['scalars'][i].tolist()} differs from the per-tensor "
                 f"prologue {row.tolist()}")
    return x


def adamw_multi_plain(x):
    """75 per-tensor plain updates of copies of ``x``'s p, m, v, each with
    its tensor's beta powers, decay and salts: ``[(p, m, v), ...]``."""
    from paddle_tpu_torch.ops.fused_adamw import fused_adamw_update_plain

    out = []
    for i, trio in enumerate(zip(x["ps"], x["ms"], x["vs"])):
        p, m, v = (t.clone() for t in trio)
        fused_adamw_update_plain(p, x["gs"][i], m, v, lr=TRAIN_LR, beta1=0.9,
                                 beta2=0.999, epsilon=1e-8,
                                 beta1_pow=x["b1p"][i], beta2_pow=x["b2p"][i],
                                 weight_decay=x["wds"][i],
                                 sr_salts=(None if x["salts"] is None
                                           else x["salts"][i]))
        out.append((p, m, v))
    return out


def adamw_multi_launch(x, ps, ms, vs):
    """The multi-tensor kernel in place on ``ps``, ``ms``, ``vs`` with
    ``x``'s gradients, scalar rows and salts."""
    from paddle_tpu_torch.ops.fused_adamw import fused_adamw_multi_update

    fused_adamw_multi_update(ps, x["gs"], ms, vs, scalars=x["scalars"],
                             sr_salts=x["salts"], beta1=0.9, beta2=0.999)


def adamw_multi_diff(torch, got, want):
    """``{"<tensor><p|m|v>": elements whose bits differ}`` between two
    lists of (p, m, v): empty when bitwise equal."""
    n_diff = {}
    for i, (trio, ref) in enumerate(zip(got, want)):
        for name, a, b in zip("pmv", trio, ref):
            n = int((bits(torch, a) != bits(torch, b)).sum())
            if n:
                n_diff[f"{i}{name}"] = n
    return n_diff


def bits(torch, t):
    """A tensor's bits as integers of its width (bit-for-bit comparison)."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def adamw_multi_case(torch, dev, gen, dtype=None, sr=True):
    """The train step's launch: the multi-tensor kernel over the flagship's
    75 bf16 tensors with bf16 moments and SR (or p, g, m, v of ``dtype``,
    SR or not), against 75 plain per-tensor updates with the same salts,
    bit for bit."""
    from paddle_tpu_torch.ops.fused_adamw import (
        fused_adamw_hbm_bytes, fused_adamw_multi_update,
        fused_adamw_multi_update_plain)

    bf = dtype or torch.bfloat16
    x = adamw_multi_inputs(torch, dev, gen, dtype, sr)
    want = adamw_multi_plain(x)
    ps, ms, vs = x["ps"], x["ms"], x["vs"]
    t = len(ps)
    before = fused_adamw_multi_update.launches
    adamw_multi_launch(x, ps, ms, vs)
    torch.cuda.synchronize()
    if fused_adamw_multi_update.launches != before + 1:
        fail(f"fused AdamW: {t} tensors took more than one launch")
    n_diff = adamw_multi_diff(torch, list(zip(ps, ms, vs)), want)
    if n_diff:
        fail(f"fused AdamW over the flagship's {t} tensors differs from the "
             f"per-tensor plain updates (tensor, output: elements): {n_diff}")
    del want
    call_ms = time_ms(lambda: adamw_multi_launch(x, ps, ms, vs), 10)
    plain_ms = time_ms(lambda: fused_adamw_multi_update_plain(
        ps, x["gs"], ms, vs, scalars=x["scalars"], sr_salts=x["salts"],
        beta1=0.9, beta2=0.999), 1, warmup=1)
    # torch's fused Adam(W) over the same 75 tensors: another function (no
    # SR, another epsilon and bias-correction form), timed for scale only
    steps = [torch.tensor(3.0, device=dev) for _ in range(t)]
    lib_ms = time_ms(lambda: torch._fused_adamw_(
        ps, x["gs"], ms, vs, [], steps, lr=TRAIN_LR, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False), 10)
    n = sum(p.numel() for p in ps)
    nbytes = fused_adamw_hbm_bytes(n, bf, bf, bf)
    b_ms, b_by = bound(nbytes, 10.0 * n, F32_FLOPS_PER_S)
    def device():  # on fresh tensors: these are freed after phase 2
        y = adamw_multi_inputs(torch, dev, gen, dtype, sr)
        return device_ms(lambda: adamw_multi_launch(y, y["ps"], y["ms"],
                                                    y["vs"]),
                         "adamw_multi_kernel", 10)

    return dict(tensors=t, numel=n, max_abs_err=0.0, call_ms=call_ms,
                plain_ms=plain_ms, torch_fused_adamw_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, device=device)


def step_fn(model, opt):
    """``bench.py:479-488``: model(ids) -> cross_entropy -> backward ->
    step -> clear_grad."""
    from paddle_tpu_torch.nn import functional as F

    def step(ids, labels):
        logits = model(ids)
        b, s, v = logits.shape
        loss = F.cross_entropy(logits.reshape(b * s, v), labels.reshape(b * s))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return step


def bench_step(model, opt):
    """:func:`step_fn` under ``jit.to_static``."""
    from paddle_tpu_torch import jit

    return jit.to_static(step_fn(model, opt), layers=[model], optimizers=[opt])


def prefix_serving_phase(torch, np, model, cfg, card):
    """Phase 5b: the shared-prefix workload served as its source serves it,
    by two engines with the prefix cache on behind a ``ClusterRouter``
    (``InProcessReplica``: one supervised engine each), over int8 and over
    bf16 pools, each run with the launch counts set to 0 just before it;
    then int8 against bf16 pools. Returns the int8 run's launch counts."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.cluster import (ClusterRouter,
                                                    InProcessReplica)
    from paddle_tpu_torch.ops import kernels

    rng = np.random.RandomState(3)  # the source's seed and draw order
    families = [rng.randint(0, cfg.vocab_size, (PREFIX_LEN,))
                for _ in range(PREFIX_FAMILIES)]
    work = [(i, np.concatenate([
        families[i % PREFIX_FAMILIES],
        rng.randint(0, cfg.vocab_size, (PREFIX_TAILS[i % 2],))]),
        "interactive" if i % 3 == 0 else "batch",
        f"r{i}" if i < PREFIX_REPEATS else None)
        for i in range(PREFIX_REQUESTS)]
    # the repeats follow once the workload is served: their originals'
    # blocks are then in the cache of the replica their session pins
    again = [(f"again{i}", work[i][1].copy(), work[i][2], work[i][3])
             for i in range(PREFIX_REPEATS)]
    L = cfg.num_hidden_layers

    def serve_prefix(kv_dtype):
        def factory():
            return ContinuousBatchingEngine(model, **PREFIX_SERVE,
                                            kv_dtype=kv_dtype)

        reps = [InProcessReplica(f"r{i}", factory) for i in range(2)]
        for rep in reps:  # the source's warm-up, outside the counted run
            rep.supervisor.submit(f"warm-{rep.replica_id}",
                                  np.ones(1, np.int32), max_new_tokens=2)
            while rep.supervisor.pending:
                rep.supervisor.step()
        engines = [rep.supervisor.engine for rep in reps]
        router = ClusterRouter(reps, block_size=PREFIX_SERVE["block_size"])
        steps0 = sum(e.decode_steps for e in engines)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for wave in (work, again):
            for rid, p, pri, session in wave:
                router.submit(rid, p, max_new_tokens=PREFIX_NEW, priority=pri,
                              session=session)
            res = router.run(deadline=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        # the router also harvests the replicas' warm-up results
        res = {rid: res.get(rid, {}) for rid, _, _, _ in work + again}
        done = {rid: r for rep in reps
                for rid, r in rep.supervisor.results.items()
                if not str(rid).startswith("warm")}
        return (router, reps, engines, res, done, wall, counts,
                sum(e.decode_steps for e in engines) - steps0)

    runs = {}
    for kv in ("int8", None):
        router, reps, engines, res, done, wall, counts, steps = \
            serve_prefix(kv)
        name = kv or "bf16"
        runs[name] = (res, counts)
        stats = [e.prefix_stats() for e in engines]
        forks = sum(st["forks"] for st in stats)
        hits = sum(st["hit_tokens"] for st in stats)
        ttft = statistics.median(r.ttft() for r in done.values())
        decode_tokens = sum(len(r.out) - 1 for r in done.values())
        print(f"phase 5b shared-prefix serving, {name} KV pools, two "
              f"replicas behind a ClusterRouter: {len(done)} requests "
              f"({PREFIX_FAMILIES} families of {PREFIX_LEN}-token prefixes, "
              f"tails {PREFIX_TAILS}, every third interactive, then "
              f"{PREFIX_REPEATS} exact repeats; {PREFIX_NEW} new tokens each) "
              f"B={PREFIX_SERVE['max_batch']} per replica, chunk "
              f"{PREFIX_SERVE['prefill_chunk']}: wall {wall:.3f} s, "
              f"{decode_tokens / wall:.1f} decode tokens/s of wall time, "
              f"TTFT p50 {ttft * 1e3:.1f} ms (all submitted at t=0), routed "
              f"{router.n_routed}, router prefix hit rate "
              f"{router.prefix_hit_rate():.4f}, {steps} decode steps, prefix "
              f"hit tokens {[st['hit_tokens'] for st in stats]}, forks "
              f"{[st['forks'] for st in stats]}, evicted blocks "
              f"{[st['evicted_blocks'] for st in stats]}, counts "
              f"{json.dumps(counts)} [{card}]")
        want_int8 = L * steps if kv else 0
        if (steps == 0 or counts["paged_decode_attention_int8"] != want_int8
                or counts["paged_decode_attention"] != L * steps - want_int8):
            fail(f"{name} prefix serving: launch counts {counts} for "
                 f"{steps} decode steps x {L} layers")
        if not (forks >= PREFIX_REPEATS and hits > 0):
            fail(f"{name} prefix serving: forks {forks}, hit tokens {hits}")
        for e in engines:
            acc = e.manager.accounting()
            if not (acc["free"] + len(acc["refs"]) == acc["total"]
                    and not acc["owned"]
                    and set(acc["refs"].values()) <= {1}):
                fail(f"{name} prefix serving: blocks neither free nor pinned "
                     f"by the cache alone at the end: {acc}")
        if any(rep.supervisor.restarts for rep in reps) or router.dead:
            fail(f"{name} prefix serving: a replica restarted or died")
        if any(r.get("status") != "ok" or len(r["out"]) != PREFIX_NEW
                or not all(0 <= t < cfg.vocab_size for t in r["out"])
                for r in res.values()):
            fail(f"{name} prefix serving: a request did not complete with "
                 f"in-range tokens")
        del router, reps, engines, done
    # one decode step of each engine, profiled: all 8 slots decoding (the
    # first wave, prefilled, with room for more tokens than the run gives)
    for kv in ("int8", None):
        eng = ContinuousBatchingEngine(model, **PREFIX_SERVE, kv_dtype=kv)
        for rid, p, _, _ in work[:PREFIX_SERVE["max_batch"]]:
            eng.add_request(rid, p, max_new_tokens=4 * PREFIX_NEW)
        while eng._queue or eng.num_prefilling:
            eng.step()
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            eng.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 5 * 1e3
        kernels.reset_launch_counts()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launch_counts()
        kern = [(e.self_device_time_total / 1e3, e.key)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(t for t, _ in kern)
        decode_ms = sum(t for t, k in kern if "paged_decode_kernel" in k)
        name = ("paged_decode_attention_int8" if kv
                else "paged_decode_attention")
        print(f"phase 5b one decode step, {kv or 'bf16'} KV pools, "
              f"{eng.num_active} of {PREFIX_SERVE['max_batch']} slots "
              f"decoding: {step_ms:.3f} ms wall per step (mean of 5), "
              f"{dev_ms:.3f} ms of kernel time in a profiled step "
              f"({100 * dev_ms / step_ms:.1f}% device busy; that step "
              f"{prof_ms:.3f} ms wall under the profiler), the decode kernel "
              f"{decode_ms:.4f} ms in {counts[name]} launches [{card}]")
        if counts[name] != L:
            fail(f"phase 5b: one {kv or 'bf16'} decode step launched "
                 f"{counts[name]} decode kernels, not {L}")
        del eng, prof
    toks8, toks16 = ({rid: r["out"] for rid, r in runs[n][0].items()}
                     for n in ("int8", "bf16"))
    agree = float(np.mean([a == b for rid in toks16
                           for a, b in zip(toks8[rid], toks16[rid])]))
    # int8_decode_bench.py:179-202: last prefill logits, int8 against bf16
    # pools, on the 576-token prompts of the first wave
    ids5 = torch.from_numpy(np.stack([
        p for _, p, _, _ in work[:PREFIX_SERVE["max_batch"]]
        if p.size == work[0][1].size]))
    ids5 = ids5.to(model.device)
    lasts = {}
    with torch.no_grad():
        for kv in ("int8", None):
            c = model.init_cache(ids5.shape[0], ids5.shape[1] + 4,
                                 block_size=PREFIX_SERVE["block_size"],
                                 kv_dtype=kv)
            lg, _ = model.forward_with_cache(ids5, c, 0)
            lasts[kv] = lg[:, -1].float()
            del c, lg
    ref5, q5 = lasts[None], lasts["int8"]
    kv_rel = float((q5 - ref5).abs().mean() / (ref5.abs().mean() + 1e-9))
    top5 = ref5.topk(5, dim=-1).indices
    in_top5 = float((top5 == q5.argmax(-1, keepdim=True)).any(-1).float().mean())
    print(f"phase 5b int8 against bf16 pools: greedy tokens agree on "
          f"{agree:.4f} of {sum(len(t) for t in toks16.values())} positions; "
          f"last prefill logit rel err {kv_rel:.4f} (tol {KV_REL_TOL}), int8 "
          f"argmax in bf16 top-5 {in_top5:.2f} ({ids5.shape[0]} prompts of "
          f"{ids5.shape[1]} tokens)")
    if not (np.isfinite(kv_rel) and kv_rel <= KV_REL_TOL):
        fail(f"int8 KV pools: last-logit rel err {kv_rel} beyond {KV_REL_TOL}")
    return runs["int8"][1]


# -- phase 10: the training recipe ------------------------------------------
# Touvron et al. 2023, "Llama 2", section 2.2 (Training Details): AdamW with
# beta1 0.9, beta2 0.95, weight decay 0.1, gradient clipping at a global norm
# of 1.0, a linear warmup and a cosine decay to 10% of the peak. Cut to 6
# steps: warmup over 2, peak 3e-4 (the 7B model's), cosine over the other 4.
RECIPE = dict(beta1=0.9, beta2=0.95, weight_decay=0.1)
RECIPE_CLIP, RECIPE_PEAK_LR, RECIPE_WARMUP, RECIPE_STEPS = 1.0, 3e-4, 2, 6
# phase 10(a): captured against eager from copies of one state, 2 layers,
# SR off, 7 steps. The captured step forms AdamW's decay factor in f32 on
# the device where the eager one rounds a Python double (ROADMAP C2), which
# could move a parameter by an ulp; at this seed and schedule the first
# measurement on the H100 came out bitwise equal (losses and parameters),
# so the bound is bitwise: nothing in the step is nondeterministic
CAPTURE_LOSS_REL, CAPTURE_PARAM_REL = 0.0, 0.0
FP16_DEPTH = LLAMA_542M["num_hidden_layers"]  # phase 10(b) at full depth


def recipe_schedule():
    """The recipe's ``[6]`` learning rates, from the port's ``LinearWarmup``
    over ``CosineAnnealingDecay``."""
    from paddle_tpu_torch.optimizer import lr

    sched = lr.LinearWarmup(
        lr.CosineAnnealingDecay(RECIPE_PEAK_LR,
                                T_max=RECIPE_STEPS - RECIPE_WARMUP,
                                eta_min=0.1 * RECIPE_PEAK_LR),
        warmup_steps=RECIPE_WARMUP, start_lr=0.0, end_lr=RECIPE_PEAK_LR)
    out = []
    for _ in range(RECIPE_STEPS):
        out.append(float(sched()))
        sched.step()
    return out


def recipe_model(torch, dev, depth, dtype, seed, sr=True, clip=True,
                 **opt_kw):
    """Llama-542M at ``depth`` layers and its recipe AdamW (fused, bf16
    moments and SR for bf16 parameters, f32 otherwise)."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    pt_seed(seed)
    cfg = LlamaConfig(**dict(LLAMA_542M, max_position_embeddings=TRAIN_SEQ,
                             num_hidden_layers=depth))
    m = LlamaForCausalLM(cfg, device=dev, dtype=dtype)
    kw = dict(RECIPE, learning_rate=RECIPE_PEAK_LR, fused=True,
              grad_clip=ClipGradByGlobalNorm(RECIPE_CLIP) if clip else None)
    if dtype == torch.bfloat16:
        kw.update(moment_dtype="bfloat16", use_stochastic_rounding=sr)
    kw.update(opt_kw)
    return m, AdamW(parameters=m.parameters(), **kw)


def recipe_step(model, opt, scaler=None, amp_dtype=None):
    """The recipe's step under ``jit.to_static``: the loss (under
    ``auto_cast(level="O1", dtype=amp_dtype)`` when given), backward
    (through ``scaler`` when given), the step and ``clear_grad``."""
    import contextlib

    from paddle_tpu_torch import amp, jit

    def step(ids, labels):
        ctx = (amp.auto_cast(level="O1", dtype=amp_dtype) if amp_dtype
               else contextlib.nullcontext())
        with ctx:
            loss = model.loss(ids, labels)
        if scaler is None:
            loss.backward()
            opt.step()
        else:
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
        opt.clear_grad()
        return loss

    return jit.to_static(step, layers=[model], optimizers=[opt],
                         scalers=[] if scaler is None else [scaler])


def profile_step(torch, fn):
    """One call of ``fn`` under the profiler: (wall ms, kernel ms by class,
    [(kernel name, launches)])."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split, names = {}, []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            c = kernel_class(e.key)
            split[c] = split.get(c, 0.0) + e.self_device_time_total / 1e3
            names.append((e.key, e.count))
    return wall, split, names


def kernels_seen(names, match):
    return sum(n for k, n in names if match in k)


def state_of(torch, model, opt):
    """Copies of the parameters and every optimizer accumulator."""
    return ([p.detach().clone() for p in model.parameters()],
            {k: v.detach().clone() for k, v in opt.state_dict().items()
             if isinstance(v, torch.Tensor)})


def state_diff(torch, a, b):
    """Names of the parameters and accumulators whose bits differ."""
    out = [f"param {i}" for i, (x, y) in enumerate(zip(a[0], b[0]))
           if not torch.equal(bits(torch, x), bits(torch, y))]
    return out + [k for k in a[1] if not torch.equal(
        bits(torch, a[1][k].reshape(-1)), bits(torch, b[1][k].reshape(-1)))]


def fp16_overflow_check(torch, dev, depth, ids, labels, seed, timed=False):
    """Phase 10(b): ``auto_cast(level="O1", dtype="float16")`` over f32
    parameters, ``GradScaler`` at the reference's defaults and fused AdamW,
    captured with ``scalers=``. A scale of 2**40 set before one replay
    overflows it: parameters, moments and beta powers must come out bitwise
    as they were, the scale and counters as the reference's rule leaves
    them (one bad step of the two that halve the scale), and, with the
    scale set back, the next replay must apply. The overflowed replay is
    profiled: the AdamW kernel ran in it. Returns a dict with ``ok``."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import kernels

    model, opt = recipe_model(torch, dev, depth, torch.float32, seed)
    scaler = amp.GradScaler()
    compiled = recipe_step(model, opt, scaler, amp_dtype="float16")
    lrs = recipe_schedule()
    r = dict(depth=depth)
    compiled(ids, labels)  # warm-up, eager
    compiled(ids, labels)  # captured, then replayed
    if timed:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = compiled.multi_step(ids, labels, steps=3, lr_schedule=lrs[:3])
        torch.cuda.synchronize()
        r["ms_per_step"] = (time.perf_counter() - t0) / 3 * 1e3
        r["counts"] = kernels.launch_counts()
        r["losses"] = [float(x) for x in losses.cpu()]
    good0 = int(scaler._good_steps)
    scale0 = scaler.get_scale_value()
    before = state_of(torch, model, opt)
    scaler.set_scale_value(2.0 ** 40)
    wall, _, names = profile_step(torch, lambda: compiled(ids, labels))
    after = state_of(torch, model, opt)
    r["changed_on_skip"] = state_diff(torch, before, after)
    r["scale_after_skip"] = scaler.get_scale_value()
    r["counters_after_skip"] = (int(scaler._good_steps),
                                int(scaler._bad_steps))
    r["adamw_in_trace"] = kernels_seen(names, "adamw_multi_kernel")
    r["f16_flash_in_trace"] = [(k[:90], n) for k, n in names
                               if "flash" in k and "half" in k]
    del before
    scaler.set_scale_value(scale0)
    compiled(ids, labels)
    after2 = state_of(torch, model, opt)
    r["applied_next"] = len(state_diff(torch, after, after2))
    r["counters_next"] = (int(scaler._good_steps), int(scaler._bad_steps))
    r["graphs"] = len(compiled._graphs)
    r["ok"] = (not r["changed_on_skip"] and r["scale_after_skip"] == 2.0 ** 40
               and r["counters_after_skip"] == (0, 1)
               and r["adamw_in_trace"] >= 1 and r["applied_next"] > 0
               and r["counters_next"] == (1, 0) and r["graphs"] == 1
               and good0 >= 1)
    del model, opt, compiled, after, after2
    torch.cuda.empty_cache()
    return r


def recipe_phase(torch, np, dev, args, card, ids, labels, phase7_profile,
                 device_rows, gen):
    """Phase 10 (a)-(c) and its kernel times. Returns the launch counts of
    (a)'s first captured multi_step."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.ops import kernels

    lrs = recipe_schedule()
    L = LLAMA_542M["num_hidden_layers"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # (a) the captured flagship against its eager step, in turns
    model, opt = recipe_model(torch, dev, L, torch.bfloat16, args.seed)
    compiled = recipe_step(model, opt)
    losses = [float(compiled(ids, labels).detach())]  # warm-up, eager
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses.append(float(compiled(ids, labels)))  # capture, then one replay
    capture_s = time.perf_counter() - t0
    # one eager step first: the capture emptied the allocator's cache, and
    # the first eager turn would pay for refilling it
    jit.enable_to_static(False)
    losses.append(float(compiled(ids, labels).detach()))
    jit.enable_to_static(True)
    turns, counts_a = [], None
    for mode in ("eager", "captured", "captured", "eager"):
        jit.enable_to_static(mode == "captured")
        try:
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = compiled.multi_step(ids, labels, steps=RECIPE_STEPS,
                                      lr_schedule=lrs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            jit.enable_to_static(True)
        counts = kernels.launch_counts()
        if mode == "captured" and counts_a is None:
            counts_a = counts
        losses += [float(x) for x in out.cpu()]
        ms = dt / RECIPE_STEPS * 1e3
        tok_s = tokens * RECIPE_STEPS / dt
        turns.append((mode, ms, tok_s,
                      tok_s * model.flops_per_token(TRAIN_SEQ) / BF16_FLOPS_PER_S,
                      counts))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for mode, ms, tok_s, mfu, counts in turns:
        print(f"phase 10(a) recipe step Llama-542M bf16 B={TRAIN_BATCH} "
              f"S={TRAIN_SEQ} (AdamW b2 {RECIPE['beta2']}, wd "
              f"{RECIPE['weight_decay']}, clip {RECIPE_CLIP}, lr "
              f"{[f'{x:.3g}' for x in lrs]}), {mode} multi_step(steps="
              f"{RECIPE_STEPS}): {ms:.2f} ms/step, {tok_s:.1f} tokens/s, MFU "
              f"{mfu:.4f}, counts {json.dumps(counts)} [{card}]")
    want = {**flash_fwd_counts(L * RECIPE_STEPS),
            **flash_bwd_counts(L * RECIPE_STEPS),
            "fused_adamw": ADAMW_GROUPS * RECIPE_STEPS,
            "paged_decode_attention": 0, "paged_decode_attention_int8": 0}
    print(f"phase 10(a) capture of the step: {capture_s:.2f} s (one replay "
          f"included); graphs {len(compiled._graphs)}; peak memory "
          f"{peak_gb:.2f} GB; losses {[round(x, 4) for x in losses]} "
          f"(warm-up, capture, one eager step, then the four turns)")
    if counts_a != want:
        fail(f"phase 10(a): captured launch counts {counts_a} != {want}")
    if not (all(np.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        fail(f"phase 10(a): losses not finite and falling: {losses}")
    # the profiler can lose kernel records (`flash_ab.py trace`: one of 120
    # profiled replays of this graph lost 64 records, a flash forward among
    # them, through the direct launch as through the operator): two replays
    # are profiled and the trace with more kernel records is read; a kernel
    # missing from the graph is missing from every replay's trace
    profiles = [profile_step(torch, lambda: compiled(ids, labels))
                for _ in range(2)]
    records = [sum(n for _, n in p[2]) for p in profiles]
    wall, split, names = profiles[records.index(max(records))]
    busy = sum(split.values())
    seen = {m: kernels_seen(names, m) for m in
            ("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma",
             "adamw_multi_kernel")}
    p7_wall, p7_busy = phase7_profile
    print(f"phase 10(a) two profiled replays hold {records} kernel records; "
          f"the fuller one: {wall:.2f} ms wall, "
          f"{busy:.2f} ms of kernel time ({100 * busy / wall:.1f}% busy; host "
          f"gaps {wall - busy:.2f} ms) beside phase 7's eager step "
          f"{p7_wall:.2f} ms wall, {p7_busy:.2f} ms of kernels (host gaps "
          f"{p7_wall - p7_busy:.2f} ms): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in
                      sorted(split.items(), key=lambda kv: -kv[1]))
          + f"; kernels in the replay's trace {json.dumps(seen)} [{card}]")
    if seen != {"flash_fwd_wgmma": L, "flash_bwd_dq_wgmma": L,
                "flash_bwd_dkv_wgmma": L, "adamw_multi_kernel": 1}:
        fail(f"phase 10(a): the replay's trace shows {seen}")
    del model, opt, compiled
    torch.cuda.empty_cache()

    # phase 7's bench step (no clipping, flat lr 1e-4, weight decay 0.01),
    # eager and captured in turns: the capture's gain on the same function
    model, opt = recipe_model(torch, dev, L, torch.bfloat16, args.seed,
                              clip=False, beta2=0.999, weight_decay=0.01,
                              learning_rate=TRAIN_LR)
    compiled = bench_step(model, opt)
    compiled(ids, labels)  # warm-up, eager
    compiled(ids, labels)  # capture, then one replay
    jit.enable_to_static(False)
    compiled(ids, labels)  # the eager path's allocator cache
    jit.enable_to_static(True)
    bench_turns = []
    for mode in ("eager", "captured", "captured", "eager"):
        jit.enable_to_static(mode == "captured")
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compiled.multi_step(ids, labels, steps=TRAIN_STEPS)
            torch.cuda.synchronize()
            bench_turns.append((mode, (time.perf_counter() - t0)
                                / TRAIN_STEPS * 1e3))
        finally:
            jit.enable_to_static(True)
    wall_b, split_b, _ = profile_step(torch, lambda: compiled(ids, labels))
    busy_b = sum(split_b.values())
    print(f"phase 10(a) phase 7's bench step in turns, multi_step(steps="
          f"{TRAIN_STEPS}): " + ", ".join(f"{m} {ms:.2f} ms/step" for m, ms in
                                        bench_turns)
          + f"; one profiled replayed step {wall_b:.2f} ms wall, "
          f"{busy_b:.2f} ms of kernels [{card}]")
    del model, opt, compiled
    torch.cuda.empty_cache()

    # (a) captured against eager from copies of one state, SR off
    res = []
    for captured in (True, False):
        m, o = recipe_model(torch, dev, GRAD_DEPTH, torch.bfloat16, args.seed,
                            sr=False)
        c = recipe_step(m, o)
        jit.enable_to_static(captured)
        try:
            first = c(ids, labels).detach()
            out = c.multi_step(ids, labels, steps=RECIPE_STEPS, lr_schedule=lrs)
        finally:
            jit.enable_to_static(True)
        res.append((torch.cat([first.reshape(1), out]).float(),
                    [p.detach().clone() for p in m.parameters()],
                    len(c._graphs)))
        del m, o, c
    (lc, pc, gc), (le, pe, ge) = res
    bitwise = torch.equal(lc, le) and all(torch.equal(a, b)
                                          for a, b in zip(pc, pe))
    loss_rel = float(((lc - le).abs() / le.abs()).max())
    param_rel = max(rel_err(a, b) for a, b in zip(pc, pe))
    print(f"phase 10(a) captured vs eager, {GRAD_DEPTH} layers at full width, "
          f"SR off, {1 + RECIPE_STEPS} steps from copies of one state: "
          f"bitwise equal {bitwise}; worst loss rel diff {loss_rel:.3g} (tol "
          f"{CAPTURE_LOSS_REL}), worst parameter rel err {param_rel:.3g} (tol "
          f"{CAPTURE_PARAM_REL}); graphs {gc} / {ge}")
    if not (gc == 1 and ge == 0 and loss_rel <= CAPTURE_LOSS_REL
            and param_rel <= CAPTURE_PARAM_REL):
        fail("phase 10(a): the captured step disagrees with the eager one")
    del res, pc, pe
    torch.cuda.empty_cache()

    # (b) fp16 with loss scaling, a forced overflow
    r = fp16_overflow_check(torch, dev, FP16_DEPTH, ids, labels, args.seed,
                            timed=True)
    c = r["counts"]
    print(f"phase 10(b) fp16 O1 over f32 parameters, GradScaler, fused AdamW "
          f"(f32 group), captured, {FP16_DEPTH} layers: {r['ms_per_step']:.2f} "
          f"ms/step over 3 replays, losses {[round(x, 4) for x in r['losses']]}"
          f"; launches flash fwd {c['flash_attention_fwd']} ("
          f"wgmma {c['flash_attention_fwd:wgmma']}), dq "
          f"{c['flash_attention_bwd_dq']} (wgmma "
          f"{c['flash_attention_bwd_dq:wgmma']}), dk/dv "
          f"{c['flash_attention_bwd_dkv']} (wgmma "
          f"{c['flash_attention_bwd_dkv:wgmma']}), AdamW {c['fused_adamw']}; "
          f"f16 flash kernels in the overflowed replay's trace "
          f"{r['f16_flash_in_trace']} [{card}]")
    print(f"phase 10(b) forced overflow (scale 2**40): changed on the skipped "
          f"step {r['changed_on_skip'][:6]} (none wanted); scale after "
          f"{r['scale_after_skip']:.6g}, (good, bad) {r['counters_after_skip']}"
          f"; AdamW launches in its trace {r['adamw_in_trace']}; the next "
          f"step changed {r['applied_next']} tensors, (good, bad) "
          f"{r['counters_next']}")
    want_b = {**flash_fwd_counts(3 * FP16_DEPTH), **flash_bwd_counts(
        3 * FP16_DEPTH), "fused_adamw": 3, "paged_decode_attention": 0,
        "paged_decode_attention_int8": 0}
    if not r["ok"] or c != want_b or len(r["f16_flash_in_trace"]) < 3:
        fail(f"phase 10(b): the fp16 recipe failed its checks ({c} vs "
             f"{want_b})")

    # (c) interleaved updates: one captured step against the serial step
    res = []
    for inter in (True, False):
        m, o = recipe_model(torch, dev, L, torch.bfloat16, args.seed, sr=False,
                            clip=False, weight_decay=0.0,
                            interleave_updates=inter)
        c = recipe_step(m, o)
        jit.enable_to_static(inter)
        try:
            first = c(ids, labels).detach()
            kernels.reset_launch_counts()
            second = c(ids, labels).detach()
            torch.cuda.synchronize()
        finally:
            jit.enable_to_static(True)
        res.append((torch.stack([first, second]).float(),
                    [p.detach().clone() for p in m.parameters()],
                    kernels.launch_counts(), len(c._graphs)))
        del m, o, c
        torch.cuda.empty_cache()
    (li, pi, ci, gi), (ls, ps, cs_, gs) = res
    n_tensors = len(pi)
    same = torch.equal(li, ls) and all(torch.equal(a, b) for a, b in zip(pi, ps))
    print(f"phase 10(c) interleave_updates, {L} layers, SR off: one captured "
          f"step against the serial step from the same state: bitwise equal "
          f"{same} (losses {li.tolist()} / {ls.tolist()}); AdamW launches in "
          f"the captured step {ci['fused_adamw']} (one a parameter: "
          f"{n_tensors}) against {cs_['fused_adamw']} serial; graphs {gi}")
    if not (same and gi == 1 and ci["fused_adamw"] == n_tensors
            and cs_["fused_adamw"] == ADAMW_GROUPS
            and ci["flash_attention_bwd_dkv:wgmma"] == L):
        fail("phase 10(c): the interleaved step disagrees with the serial one")
    del res, pi, ps
    torch.cuda.empty_cache()

    # f16 flash at the flagship's shape beside sdpa's f16, and AdamW's f32
    # group over the 75 tensors (its device time in phase 9)
    f16 = torch.float16
    rf = flash_case(torch, dev, gen, True, 16, dtype=f16)
    rb = flash_bwd_case(torch, dev, gen, True, 16, dtype=f16)
    print(f"phase 10 flash_fwd f16 B=4 S=2048 H=16 D=128 causal variant="
          f"{rf['variant']}: worst row {rf['row_rel']:.4g} (row rel "
          f"{FLASH_ROW_REL}), ms={rf['ms']:.4f} bound_ms={rf['bound_ms']:.4f} "
          f"({rf['bound_by']}) {rf['rate']}, library_ms(sdpa f16)="
          f"{rf['library_ms']:.4f}, plain_ms={rf['plain_ms']:.3f} [{card}]")
    print(f"phase 10 flash_bwd f16 same shape variant={rb['variant']}: worst "
          f"rows dq/dk/dv {[round(rb['gate'][n]['row_rel'], 5) for n in ('dq', 'dk', 'dv')]}"
          f" (row rel {BWD_ROW_REL}); dq ms={rb['dq_ms']:.4f} (bound "
          f"{rb['dq_bound'][0]:.4f}), dkv ms={rb['dkv_ms']:.4f} (bound "
          f"{rb['dkv_bound'][0]:.4f}), library_ms(sdpa f16 backward)="
          f"{rb['library_ms']:.4f}, plain_ms={rb['plain_ms']:.3f} [{card}]")
    torch.cuda.empty_cache()
    ra = adamw_multi_case(torch, dev, gen, dtype=torch.float32, sr=False)
    device_rows.append((f"fused_adamw f32 group, {ra['tensors']} tensors", ra))
    print(f"phase 10 fused_adamw f32 p/g/m/v over the flagship's "
          f"{ra['tensors']} tensors ({ra['numel']} elements) in one launch: "
          f"bitwise equal to the per-tensor plain updates; a wrapper call "
          f"{ra['call_ms']:.4f} ms, bound_ms={ra['bound_ms']:.4f} "
          f"({ra['bound_by']}: {ra['nbytes'] / 1e9:.2f} GB), plain_ms="
          f"{ra['plain_ms']:.3f}; torch._fused_adamw_ (another function) "
          f"{ra['torch_fused_adamw_ms']:.4f} ms [{card}]")
    torch.cuda.empty_cache()
    return counts_a, rf, rb, ra


# -- phase 11: the decode loop ----------------------------------------------
# (a) phase 4's workload and SERVE in three engines, run in turns: eager
# (jit.enable_to_static(False)), captured sync and captured overlap. Each
# engine first serves warm-up requests, LOOP_WARM_REQUESTS of each budget
# in LOOP_WARM_NEW in turn: K-step chunks, then single steps (overlap mode
# over-issues chunks where sync mode steps singly), so each decode program
# runs eagerly once and is captured before the counted run
LOOP_ORDER = ("eager", "captured", "overlap", "overlap", "captured", "eager")
LOOP_WARM_REQUESTS, LOOP_WARM_NEW = 2, (40, 8)
# then each engine's steady state: all 16 slots decoding 256-token prompts,
# LOOP_STEADY_STEPS timed engine steps (K-step chunks) after 3 warm ones,
# then LOOP_PROFILE_STEPS profiled ones, taken last
LOOP_STEADY_NEW, LOOP_STEADY_STEPS, LOOP_PROFILE_STEPS = 1 + 16 * 16, 10, 2
# (b) speculative decoding: prompts of a random segment repeated, so that
# the n-gram proposer finds drafts; plain and speculative engines serve
# SERVE with single decode steps (a verify round against one step)
SPEC_K = 4
SPEC_SERVE = dict(SERVE, decode_chunk=1)
SPEC_REQUESTS, SPEC_SEGMENT, SPEC_COPIES, SPEC_NEW = 16, 32, 8, 64
# at a first difference between a speculative and a plain bf16 stream, the
# top-2 gap of the plain stream's logits there (scoring forward over the
# prompt and the plain tokens before it, bf16) must lie below this bound:
# the verify scores through masked attention over the gathered view where
# plain decode runs the paged-decode kernel, which can flip a near tie. Set
# from the first two measurements on the H100: 54 first differences of 64
# streams (bf16 and int8 pools), every gap 0, 0.0078 or once 0.0156 (exact
# bf16 ties, or one or two bf16 ulps of logits between 1 and 2); the bound
# is three such ulps. The random bf16 model's logits tie often (the median
# gap over all plain positions was 0.0547), so the phase prints the share
# of all positions below the bound: a departure at a position drawn at
# random passes the gate with that chance
SPEC_GAP_BOUND = 0.0235
# phase 6's small f32 model: speculative streams equal plain ones exactly
SPEC_SMALL = dict(max_batch=3, max_len=256, block_size=16, num_blocks=48,
                  prompt_pad=128)
SPEC_SMALL_REQUESTS, SPEC_SMALL_SEGMENT, SPEC_SMALL_COPIES = 6, 12, 6
SPEC_SMALL_NEW = 40
# (c) generate at B=16, and the sampler on fixed f32 logits on a 0.25 grid
# (ties at the k-th value); the chi-square test's p must exceed CHI2_P_MIN
GEN_B, GEN_PROMPT, GEN_NEW = 16, 128, 64
SAMPLE_ROWS, SAMPLE_DRAWS, SAMPLE_T, SAMPLE_TOP_K = 16, 4096, 0.8, 50
CHI2_P_MIN = 1e-3


def graph_counts(eng):
    """Captured graphs of each of the engine's programs."""
    return {name: len(getattr(eng, f"_{name}_fn")._graphs)
            for name in ("prefill", "decode", "chunk", "verify")}


def prefill_timer(eng):
    """Count the engine's prefill dispatches and the host seconds of its
    admit and prefill-chunk calls (a sync engine's include the wait for
    each prefill's first tokens; an overlap engine's do not). Returns the
    dict the wrappers fill."""
    acc = {"dispatches": 0, "host_s": 0.0}
    prefill = eng._prefill

    def counted(*a):
        acc["dispatches"] += 1
        return prefill(*a)

    def timed(fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc["host_s"] += time.perf_counter() - t
        return run

    eng._prefill = counted
    eng._admit = timed(eng._admit)
    eng._prefill_step = timed(eng._prefill_step)
    return acc


@contextlib.contextmanager
def static_mode(captured: bool):
    """Run the block with ``jit.to_static`` capturing (True) or eager."""
    from paddle_tpu_torch import jit

    jit.enable_to_static(captured)
    try:
        yield
    finally:
        jit.enable_to_static(True)


def serving_prompts(torch, seed, n_req, vocab):
    """Phase 4's prompts: lengths PROMPT_LENS in turn, from ``seed + n``."""
    rng = torch.Generator(device="cpu").manual_seed(seed + n_req)
    return [torch.randint(0, vocab, (PROMPT_LENS[i % len(PROMPT_LENS)],),
                          generator=rng).numpy() for i in range(n_req)]


def loop_run(torch, model, kind, prompts, L, keep=False, engine_kw=None):
    """One engine of kind ``kind`` over phase 4's workload, after its own
    warm-up; returns what the phase prints and gates on (with ``keep``,
    the engine too, whose prefill phase 12(a) profiles). ``engine_kw``:
    more engine keywords (phase 14's ``fp8=True``)."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import kernels

    eng = ContinuousBatchingEngine(model, **SERVE, overlap=kind == "overlap",
                                   **(engine_kw or {}))
    with static_mode(kind != "eager"):
        for new in LOOP_WARM_NEW:
            for i in range(LOOP_WARM_REQUESTS):
                eng.add_request(("warm", new, i), prompts[i],
                                max_new_tokens=new)
            eng.run()
        graphs0 = graph_counts(eng)
        steps0, disp0, dtok0 = (eng.decode_steps, eng.n_dispatches,
                                eng.decode_tokens)
        reqs = [eng.add_request(i, p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(prompts)]
        pf = prefill_timer(eng)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        warmed = eng.warmed_up
    counts = kernels.launch_counts()
    steps = eng.decode_steps - steps0
    r = dict(kind=kind, wall=wall, steps=steps,
             dispatches=eng.n_dispatches - disp0,
             decode_tokens=eng.decode_tokens - dtok0,
             ttft=statistics.median(q.ttft() for q in reqs),
             tokens={q.req_id: list(q.out) for q in reqs},
             graphs0=graphs0, graphs=graph_counts(eng), counts=counts,
             stats=eng.overlap_stats(), prefill=pf,
             prefill_pool=graph_pool_bytes(torch, eng._prefill_fn),
             warmed_up=warmed, fp8_layers=getattr(eng, "fp8_layers", None))
    if counts["paged_decode_attention"] != L * steps or steps == 0:
        fail(f"phase 11 {kind} serving: {counts['paged_decode_attention']} "
             f"paged-decode launches for {steps} decode steps x {L} layers")
    want = ({"prefill": 0, "decode": 0, "chunk": 0, "verify": 0}
            if kind == "eager" else
            {"prefill": 1, "decode": 1, "chunk": 1, "verify": 0})
    if graphs0 != want or r["graphs"] != want:
        fail(f"phase 11 {kind} serving: captured graphs {graphs0} after the "
             f"warm-up and {r['graphs']} at the end, expected {want}")
    if not r["warmed_up"]:
        fail(f"phase 11 {kind} serving: warmed_up is false after the run")
    if keep:
        r["prefill_engine"] = eng
    return r


def loop_steady(torch, model, kind, prompts):
    """All 16 slots decoding: the wall time of LOOP_STEADY_STEPS engine
    steps over the forwards they ran. Returns the engine (profiled last)
    and ms per decode step."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(model, **SERVE, overlap=kind == "overlap")
    with static_mode(kind != "eager"):
        for i in range(SERVE["max_batch"]):
            eng.add_request(i, prompts[i][:PROMPT_LENS[0]],
                            max_new_tokens=LOOP_STEADY_NEW)
        while eng._queue or len(eng._decode_rows()) < SERVE["max_batch"]:
            eng.step()
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        s0 = eng.decode_steps
        t0 = time.perf_counter()
        for _ in range(LOOP_STEADY_STEPS):
            eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (eng.decode_steps - s0)
    return eng, ms


def loop_profile(torch, eng, kind):
    """LOOP_PROFILE_STEPS steps of a steady engine under the profiler:
    kernel ms and the device's busy share of the wall time."""
    with static_mode(kind != "eager"):
        torch.cuda.synchronize()
        s0 = eng.decode_steps
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(LOOP_PROFILE_STEPS):
                eng.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return dev_ms, wall, eng.decode_steps - s0


def spec_prompts(np, vocab, seed, n, segment, copies):
    rng = np.random.RandomState(seed)
    return [np.tile(rng.randint(0, vocab, (segment,)), copies)
            for _ in range(n)]


_SPEC_COUNTERS = ("spec_proposed", "spec_accepted", "spec_emitted",
                  "spec_dispatches", "spec_slot_rounds", "decode_steps",
                  "n_dispatches")


def spec_serve(torch, model, prompts, new, engine_kw, warm=False, **kw):
    """One engine over ``prompts`` (with ``warm``, after serving them once
    as a warm-up, so that the timed run replays programs captured
    already). Returns the engine's streams, the timed run's wall, its
    counters (``_SPEC_COUNTERS``, deltas over the run) and paged-decode
    launches, which must be one per layer and decode step (verify rounds
    score through the gathered view)."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import kernels

    eng = ContinuousBatchingEngine(model, **engine_kw, **kw)
    for run in (("warm", "timed") if warm else ("timed",)):
        c0 = {k: getattr(eng, k) for k in _SPEC_COUNTERS}
        for i, p in enumerate(prompts):
            eng.add_request((run, i), p, max_new_tokens=new)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    c = {k: getattr(eng, k) - c0[k] for k in _SPEC_COUNTERS}
    name = ("paged_decode_attention_int8" if kw.get("kv_dtype")
            else "paged_decode_attention")
    if counts[name] != model.config.num_hidden_layers * c["decode_steps"]:
        fail(f"phase 11(b): {counts[name]} {name} launches for "
             f"{c['decode_steps']} decode steps")
    return dict(tokens={r[1]: list(q.out) for r, q in done.items()
                        if r[0] == "timed"},
                wall=wall, c=c, launches=counts[name])


def top2_gaps(torch, model, prompt, toks):
    """The top-2 gaps of the logits that chose each of ``toks`` after
    ``prompt``, from one scoring forward in the model's dtype."""
    ids = torch.tensor(list(prompt) + list(toks), dtype=torch.int64,
                       device=model.device)[None]
    with torch.no_grad():
        top = model(ids)[0, len(prompt) - 1:-1].float().topk(2).values
    return (top[:, 0] - top[:, 1]).tolist()


def spec_phase(torch, np, model, small_model, small, cfg, card):
    """Phase 11 (b): speculative against plain serving, sync and overlap,
    on bf16 and int8 pools at full width, and in f32 at phase 6's size."""
    # f32, small: the streams equal the plain engine's exactly
    sp = spec_prompts(np, small.vocab_size, 11, SPEC_SMALL_REQUESTS,
                      SPEC_SMALL_SEGMENT, SPEC_SMALL_COPIES)
    plain = spec_serve(torch, small_model, sp, SPEC_SMALL_NEW, SPEC_SMALL)
    for overlap in (False, True):
        r = spec_serve(torch, small_model, sp, SPEC_SMALL_NEW, SPEC_SMALL,
                       spec_decode_k=SPEC_K, overlap=overlap)
        c = r["c"]
        print(f"phase 11(b) small f32 model, spec_decode_k={SPEC_K} "
              f"{'overlap' if overlap else 'sync'}: streams equal the plain "
              f"engine's: {r['tokens'] == plain['tokens']}; acceptance "
              f"{c['spec_accepted'] / max(c['spec_proposed'], 1):.3f}, "
              f"{c['spec_dispatches']} verify dispatches")
        if r["tokens"] != plain["tokens"] or c["spec_dispatches"] == 0:
            fail("phase 11(b): f32 speculative streams differ from plain")
    # full width, bf16 and int8 pools; each engine warmed on the workload
    prompts = spec_prompts(np, cfg.vocab_size, 12, SPEC_REQUESTS,
                           SPEC_SEGMENT, SPEC_COPIES)
    for kv in (None, "int8"):
        name = kv or "bf16"
        plain = spec_serve(torch, model, prompts, SPEC_NEW, SPEC_SERVE,
                           warm=True, kv_dtype=kv)
        streams = {}
        for overlap in (False, True):
            mode = "overlap" if overlap else "sync"
            r = spec_serve(torch, model, prompts, SPEC_NEW, SPEC_SERVE,
                           warm=True, kv_dtype=kv, spec_decode_k=SPEC_K,
                           overlap=overlap)
            streams[mode] = r["tokens"]
            c, pc = r["c"], plain["c"]
            print(f"phase 11(b) {name} KV pools, spec_decode_k={SPEC_K} "
                  f"{mode}: {SPEC_REQUESTS} requests ({SPEC_COPIES} copies "
                  f"of a {SPEC_SEGMENT}-token segment, {SPEC_NEW} new tokens) "
                  f"wall {r['wall']:.3f} s against the plain engine's "
                  f"{plain['wall']:.3f} s (both warmed on the workload); "
                  f"acceptance "
                  f"{c['spec_accepted'] / max(c['spec_proposed'], 1):.3f} "
                  f"({c['spec_accepted']} of {c['spec_proposed']} drafts), "
                  f"{c['spec_emitted'] / max(c['spec_slot_rounds'], 1):.3f} "
                  f"tokens per slot-round, {c['n_dispatches']} dispatches "
                  f"({c['spec_dispatches']} verify) against the plain "
                  f"engine's {pc['n_dispatches']}; paged-decode launches "
                  f"{r['launches']} against the plain engine's "
                  f"{plain['launches']} [{card}]")
            if c["spec_dispatches"] == 0:
                fail(f"phase 11(b) {name} {mode}: no verify round ran")
        if streams["overlap"] != streams["sync"]:
            fail(f"phase 11(b) {name}: overlap and sync speculative streams "
                 f"differ")
        gaps, every = [], []
        for rid, want in plain["tokens"].items():
            got = streams["sync"][rid]
            g = top2_gaps(torch, model, prompts[rid], want)
            every += g
            j = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                     None)
            if j is not None:
                gaps.append(g[j])
        print(f"phase 11(b) {name}: {len(gaps)} of {len(prompts)} speculative "
              f"streams differ from the plain engine's; top-2 logit gaps at "
              f"the first differences {[round(g, 4) for g in gaps]} (bound "
              f"{SPEC_GAP_BOUND}); over all {len(every)} plain positions the "
              f"median gap is {statistics.median(every):.4f}, "
              f"{sum(g < SPEC_GAP_BOUND for g in every) / len(every):.3f} of "
              f"them below the bound")
        if any(g >= SPEC_GAP_BOUND for g in gaps):
            fail(f"phase 11(b) {name}: a speculative stream departs from the "
                 f"plain one where the plain logits are not a near tie")


def generate_phase(torch, np, model, cfg, card, seed):
    """Phase 11 (c): ``generate`` captured against eager at B=16, greedy
    top_k=1 sampling against argmax, and the sampler's draws."""
    from scipy import stats

    from paddle_tpu_torch import jit
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.models import LlamaForCausalLM, generate
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.ops import kernels

    L = cfg.num_hidden_layers
    rng = torch.Generator().manual_seed(seed + 13)
    ids = torch.randint(0, cfg.vocab_size, (GEN_B, GEN_PROMPT),
                        generator=rng).to(model.device)
    for kw in ({"block_size": 64}, {}):
        label = "paged" if kw else "dense"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = generate(model, ids, max_new_tokens=GEN_NEW, use_jit=False,
                         **kw)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        # the first call captures the decode step, the second the prefill
        first = generate(model, ids, max_new_tokens=GEN_NEW, **kw)
        second = generate(model, ids, max_new_tokens=GEN_NEW, **kw)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = generate(model, ids, max_new_tokens=GEN_NEW, **kw)
        torch.cuda.synchronize()
        jit_s = time.perf_counter() - t0
        n = kernels.launch_counts()["paged_decode_attention"]
        want_n = L * (GEN_NEW - 1) if kw else 0
        print(f"phase 11(c) generate {label} B={GEN_B} prompt {GEN_PROMPT} "
              f"+{GEN_NEW}: use_jit=True (three calls) bitwise equal to "
              f"use_jit=False: {torch.equal(first, eager)} "
              f"{torch.equal(second, eager)} {torch.equal(again, eager)}; "
              f"{jit_s:.3f} s replayed (third call) against {eager_s:.3f} s "
              f"eager, paged-decode launches "
              f"{n} (want {want_n}) [{card}]")
        if not (torch.equal(first, eager) and torch.equal(second, eager)
                and torch.equal(again, eager) and n == want_n):
            fail(f"phase 11(c): generate {label} use_jit=True differs from "
                 f"use_jit=False, or launched {n} decode kernels")
    # top_k=1 keeps every logit tied with the largest, as the reference's
    # rule does, and the random bf16 model's logits tie at the top (phase
    # 11(b)'s gaps of 0): so the check runs on the model in f32
    model32 = LlamaForCausalLM(cfg, device=model.device, dtype=torch.float32,
                               generator=torch.Generator(
                                   device=model.device).manual_seed(seed))
    top1 = generate(model32, ids, max_new_tokens=GEN_NEW, temperature=1.0,
                    top_k=1, block_size=64)
    greedy = generate(model32, ids, max_new_tokens=GEN_NEW, block_size=64)
    del model32
    print(f"phase 11(c) generate f32 temperature=1.0 top_k=1 bitwise equal "
          f"to greedy: {torch.equal(top1, greedy)}")
    if not torch.equal(top1, greedy):
        fail("phase 11(c): top_k=1 sampling differs from greedy")
    # the sampler, captured, on fixed logits
    g = torch.Generator().manual_seed(seed + 14)
    logits = (torch.round(torch.randn(SAMPLE_ROWS, cfg.vocab_size,
                                      generator=g) * 12) / 4).to(model.device)
    sampler = jit.to_static(
        lambda lg: G._sample(lg, SAMPLE_T, SAMPLE_TOP_K))
    sampler(logits)  # eager
    sampler(logits)  # captured
    draws = []
    for _ in range(2):
        pt_seed(seed + 15)
        draws.append(torch.stack([sampler(logits)
                                  for _ in range(SAMPLE_DRAWS)]).cpu())
    masked = G._filter_logits(logits, SAMPLE_T, SAMPLE_TOP_K)
    p = torch.softmax(masked, dim=-1).double().cpu().numpy()
    kept = np.isfinite(masked.cpu().numpy())
    d = draws[0].numpy()
    in_set = bool(kept[np.arange(SAMPLE_ROWS)[None, :], d].all())
    chi2, dof = 0.0, 0
    for row in range(SAMPLE_ROWS):
        support = np.flatnonzero(kept[row])
        counts = np.bincount(d[:, row], minlength=p.shape[1])[support]
        exp = p[row, support] * SAMPLE_DRAWS
        small = exp < 5
        obs = np.append(counts[~small], counts[small].sum())
        e = np.append(exp[~small], exp[small].sum())
        if e[-1] == 0:
            obs, e = obs[:-1], e[:-1]
        chi2 += float(((obs - e) ** 2 / e).sum())
        dof += obs.size - 1
    pval = float(stats.chi2.sf(chi2, dof))
    same = torch.equal(draws[0], draws[1])
    print(f"phase 11(c) sampler captured, [{SAMPLE_ROWS}, {cfg.vocab_size}] "
          f"f32 logits, temperature {SAMPLE_T}, top_k {SAMPLE_TOP_K} "
          f"({int(kept.sum(-1).min())}..{int(kept.sum(-1).max())} kept with "
          f"ties), {SAMPLE_DRAWS} draws: all in the kept set {in_set}; "
          f"chi-square {chi2:.1f} on {dof} dof, p={pval:.4f} (min "
          f"{CHI2_P_MIN}); same seed, same draws bitwise: {same}; graphs "
          f"{len(sampler._graphs)}")
    if not (in_set and pval > CHI2_P_MIN and same
            and len(sampler._graphs) == 1):
        fail("phase 11(c): the captured sampler's draws fail their gates")


def decode_loop_phase(torch, np, dev, args, card):
    """Phase 11: the engine's decode loop at full width (module docstring
    of ``paddle_tpu_torch/inference/serving.py``): (a) eager, captured and
    overlapped serving in turns, (b) speculative decoding, (c) generate."""
    import gc

    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    pt_seed(args.seed)
    cfg = LlamaConfig(**LLAMA_542M)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    model.eval()
    L = cfg.num_hidden_layers
    prompts = serving_prompts(torch, args.seed, N_REQUESTS, cfg.vocab_size)
    # (a) in turns
    runs = []
    for kind in LOOP_ORDER:
        keep = kind == "captured" and not any("prefill_engine" in r
                                              for r in runs)
        runs.append(loop_run(torch, model, kind, prompts, L, keep))
        gc.collect()
        r = runs[-1]
        print(f"phase 11(a) {kind} serving: {N_REQUESTS} requests (phase 4's "
              f"workload) wall {r['wall']:.3f} s, {r['decode_tokens']} decode "
              f"tokens, {r['decode_tokens'] / r['wall']:.1f} decode tokens/s "
              f"of wall time, {r['steps']} decode steps in "
              f"{r['dispatches']} dispatches, TTFT p50 {r['ttft'] * 1e3:.1f} "
              f"ms, host blocked {r['stats']['host_blocked_frac']:.3f} of "
              f"step time, h2d decode bytes/token "
              f"{r['stats']['h2d_decode_bytes_per_token']:.1f}, graphs "
              f"{r['graphs']}, paged-decode launches "
              f"{r['counts']['paged_decode_attention']} [{card}]")
    if any(r["tokens"] != runs[0]["tokens"] for r in runs):
        fail("phase 11(a): the eager, captured and overlap token streams "
             "differ")
    print(f"phase 11(a) all {len(runs)} token streams bitwise equal")
    steady = {}
    steady_prompts = serving_prompts(torch, args.seed + 1, SERVE["max_batch"],
                                     cfg.vocab_size)
    for kind in ("eager", "captured", "overlap"):
        eng, ms = loop_steady(torch, model, kind, steady_prompts)
        steady[kind] = (eng, ms)
        print(f"phase 11(a) {kind} steady decode, {SERVE['max_batch']} "
              f"slots, decode_chunk {SERVE['decode_chunk']}: {ms:.3f} ms per "
              f"decode step (wall "
              f"of {LOOP_STEADY_STEPS} engine steps over their forwards) "
              f"[{card}]")
    # (b) and (c)
    small = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                             num_attention_heads=4, num_key_value_heads=2,
                             vocab_size=512, max_position_embeddings=512)
    small_model = LlamaForCausalLM(
        small, device=dev, generator=torch.Generator(device=dev).manual_seed(
            args.seed))
    spec_phase(torch, np, model, small_model, small, cfg, card)
    generate_phase(torch, np, model, cfg, card, args.seed)
    # the profiled steps, taken last
    for kind, (eng, ms) in steady.items():
        dev_ms, wall, n = loop_profile(torch, eng, kind)
        print(f"phase 11(a) {kind} profiled: {LOOP_PROFILE_STEPS} engine "
              f"steps ({n} decode steps) {wall:.3f} ms wall under the "
              f"profiler, {dev_ms:.3f} ms of kernel time = {dev_ms / n:.3f} "
              f"ms per decode step, {100 * dev_ms / n / ms:.1f}% of the "
              f"unprofiled {ms:.3f} ms per decode step (device busy; "
              f"{100 * dev_ms / wall:.1f}% under the profiler) [{card}]")
    del steady, small_model
    gc.collect()
    torch.cuda.empty_cache()
    return runs, model


# -- phase 12: the serving engine's front door --------------------------------
# (a) prefill capture. Phase 4's workload (whole-prompt prefill, prompt_pad
# 512) is phase 11(a)'s turns; phase 5b's shared-prefix workload (chunked
# prefill, prefill_chunk 256) runs here in eager, captured and overlap
# engines in turns, on bf16 and on int8 pools. Each engine first serves one
# unrelated prompt (its programs run eagerly once and are captured), then
# its prefix cache is cleared.
PREFILL_ORDER = {"bf16": LOOP_ORDER, "int8": ("eager", "captured", "overlap")}
PREFILL_WARM_NEW = 20
TOP_KERNELS = 6  # the kernels of a profiled prefill that phase 12(a) names
# (b) overload control, benchmarks/serving_throughput.py:237-335 (its on-TPU
# cell, unchanged in shape): calibrate capacity closed-loop, then offer 2x
# capacity open-loop, one request in three interactive, per-class
# deadlines, AdmissionConfig(max_queue=B, high_watermark=0.75,
# target_delay_s=interactive_ddl / 2); captured, tracing on, the resource
# ledger on. OVERLOAD_BUDGET_S bounds the open-loop run (the source's
# budget guard)
OVERLOAD = dict(max_batch=16, max_len=1024, block_size=64,
                num_blocks=16 * (1024 // 64) + 2, prompt_pad=512)
OVERLOAD_LENS, OVERLOAD_REQUESTS, OVERLOAD_NEW = (128, 256, 384), 192, 48
OVERLOAD_BUDGET_S = 240.0
# (c) the host-RAM tier: phase 5b's configuration with TIER_FAMILIES
# families of 512-token prefixes, visited round-robin, so that their pinned
# blocks cannot all stay beside the running sequences and HBM evicts. The
# tier keys a frame by the whole block-aligned prompt (as the reference's
# does), so each family keeps one tail (64 or 128 tokens, drawn once) and
# its prompt recurs whole after the other families. Three engines: no tier,
# a HostTier of TIER_CAPACITY bytes, and a pool of TIER_LARGE_BLOCKS that
# never evicts; then the tier engine again with cache.spill corrupting a
# frame with probability TIER_CORRUPT_P (bit TIER_CORRUPT_BIT: inside the
# pages)
TIER_FAMILIES, TIER_REQUESTS, TIER_NEW = 16, 64, 32
TIER_CAPACITY, TIER_LARGE_BLOCKS = 4 << 30, 512
TIER_CORRUPT_P, TIER_CORRUPT_BIT = 0.5, 8 * 200_000


def graph_pool_bytes(torch, fn):
    """Bytes of the segments in ``fn``'s CUDA-graph memory pool (None when
    it captured nothing)."""
    pool = getattr(fn, "_pool", None)
    if pool is None or not fn._graphs:
        return None
    segs = torch.cuda.memory._snapshot()["segments"]
    n = sum(sg["total_size"] for sg in segs
            if tuple(sg.get("segment_pool_id", ())) == tuple(pool))
    return n or None


def gib(n):
    return "not measured" if n is None else f"{n / 2**30:.2f} GiB"


@contextlib.contextmanager
def prefill_ranges(torch, model):
    """Name the parts of a prefill for the profiler: the KV write and the
    gathered view (``paged_update_kv_cache``), the masked attention and
    softmax over it (``F.scaled_dot_product_attention`` with a mask), and
    the lm_head."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import paged_attention as PA

    saved = (F.scaled_dot_product_attention, PA.paged_update_kv_cache)

    def ranged(name, fn):
        def run(*a, **k):
            with torch.profiler.record_function(f"prefill:{name}"):
                return fn(*a, **k)
        return run

    F.scaled_dot_product_attention = ranged("attention", saved[0])
    PA.paged_update_kv_cache = ranged("kv", saved[1])
    model._head = ranged("lm_head", model._head)
    try:
        yield
    finally:
        F.scaled_dot_product_attention, PA.paged_update_kv_cache = saved
        del model._head


def _range_kernels(evt):
    """(kernel name, device us) of every kernel an event's subtree ran."""
    out = [(k.name, k.duration) for k in evt.kernels]
    for ch in evt.cpu_children:
        out += _range_kernels(ch)
    return out


def prefill_profile(torch, eng, label, card):
    """One prefill program of a captured engine (its inputs as the run
    left them): CUDA-event ms of a replay, the profiler's device ms of one
    replay, and the split of one eager call of the same program (the same
    kernels) into the KV write and gather, the masked attention and
    softmax, the lm_head, the other GEMMs (projections, MLP) and the rest
    (norms, RoPE, SwiGLU, residuals, argmax)."""
    from paddle_tpu_torch.ops import kernels

    fn = eng._prefill_fn
    n0 = kernels.launch_counts()
    replay_ms = time_ms(fn, 5, warmup=1)
    kernels.set_launch_counts(n0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    replay_dev = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    with static_mode(False), prefill_ranges(torch, eng.model), \
            torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels.set_launch_counts(n0)
    # the named ranges show up among the device events too (as GPU user
    # annotations spanning their kernels): kernels only
    allk = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("prefill:")]
    total = sum(t for _, t in allk) / 1e3
    parts, inside_gemm = {}, 0.0
    for evt in prof.events():
        if evt.name.startswith("prefill:"):
            ks = _range_kernels(evt)
            name = evt.name.split(":", 1)[1]
            parts[name] = parts.get(name, 0.0) + sum(d for _, d in ks) / 1e3
            inside_gemm += sum(d for k, d in ks
                               if kernel_class(k) == "GEMMs") / 1e3
    gemms = sum(t for k, t in allk if kernel_class(k) == "GEMMs") / 1e3 \
        - inside_gemm
    rest = total - sum(parts.values()) - gemms
    top = sorted(allk, key=lambda kt: -kt[1])[:TOP_KERNELS]
    split = dict(kv_write_gather=parts.get("kv", 0.0),
                 masked_attention_softmax=parts.get("attention", 0.0),
                 lm_head=parts.get("lm_head", 0.0), other_gemms=gemms,
                 rest_and_argmax=rest)
    print(f"phase 12(a) {label} prefill program [{eng.B}, "
          f"{tuple(eng._pids.shape)[1]}]: a replay {replay_ms:.3f} ms "
          f"(CUDA events), {replay_dev:.3f} ms of kernels in a profiled "
          f"replay; an eager call's {total:.3f} ms of kernels split "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f" ms; graph pool {gib(graph_pool_bytes(torch, fn))} [{card}]")
    print(f"phase 12(a) {label} prefill, the eager call's top kernels: "
          + "; ".join(f"{t / 1e3:.3f} ms {kernel_class(k)}: {k[:90]}"
                      for k, t in top))
    return dict(replay_ms=replay_ms, replay_dev=replay_dev, total=total,
                split=split)


def prefix_work(np, vocab, families_n, requests, repeats=0, wave=0,
                fixed_tails=False):
    """Phase 5b's shared-prefix traffic: ``families_n`` 512-token prefixes
    drawn first from seed 3, then each request's tail; request i takes
    family i % families_n. With ``fixed_tails`` each family draws one tail
    (so its whole prompt recurs). ``repeats`` exact repeats of the first
    requests queue behind the first ``wave``."""
    rng = np.random.RandomState(3)  # the source's seed and draw order
    families = [rng.randint(0, vocab, (PREFIX_LEN,))
                for _ in range(families_n)]
    tails = [rng.randint(0, vocab, (PREFIX_TAILS[i % 2],))
             for i in range(families_n if fixed_tails else requests)]
    work = [(i, np.concatenate([families[i % families_n],
                                tails[i % len(tails)]]))
            for i in range(requests)]
    if repeats:
        work = (work[:wave] + [(f"again{i}", work[i][1].copy())
                               for i in range(repeats)] + work[wave:])
    return families, work


def decode_launch_error(counts, kv, L, steps):
    """None when a run of ``steps`` decode steps on ``kv`` pools launched
    its paged-decode kernel ``L`` times a step and the other decode kernel
    never; else what the counts show."""
    name, other = ("paged_decode_attention", "paged_decode_attention_int8")
    if kv:
        name, other = other, name
    got, stray = counts.get(name, 0), counts.get(other, 0)
    if steps and got == L * steps and not stray:
        return None
    return (f"{got} {name} launches for {steps} decode steps x {L} layers, "
            f"{stray} {other} launches")


def chunked_run(torch, np, model, kind, kv, work, L, engine_kw=None,
                label="phase 12(a)"):
    """One engine of kind ``kind`` over phase 5b's workload on ``kv``
    pools, after its own warm-up; returns what 12(a) prints and gates on."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import kernels

    eng = ContinuousBatchingEngine(model, **PREFIX_SERVE, kv_dtype=kv,
                                   overlap=kind == "overlap",
                                   **(engine_kw or {}))
    vocab = model.config.vocab_size
    with static_mode(kind != "eager"):
        warm = np.random.RandomState(99).randint(0, vocab, (PREFIX_LEN + 64,))
        eng.add_request("warm", warm, max_new_tokens=PREFILL_WARM_NEW)
        eng.run()
        eng.prefix_cache.clear()
        graphs0 = graph_counts(eng)
        c0 = (eng.decode_steps, eng.decode_tokens, eng.prefix_hit_tokens,
              eng.prefill_tokens)
        reqs = [eng.add_request(rid, p, max_new_tokens=PREFIX_NEW)
                for rid, p in work]
        pf = prefill_timer(eng)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        warmed = eng.warmed_up
    counts = kernels.launch_counts()
    steps, dtok, hits, ptok = (a - b for a, b in zip(
        (eng.decode_steps, eng.decode_tokens, eng.prefix_hit_tokens,
         eng.prefill_tokens), c0))
    name = ("paged_decode_attention_int8" if kv
            else "paged_decode_attention")
    r = dict(kind=kind, wall=wall, steps=steps, decode_tokens=dtok,
             hit_tokens=hits, prefill_tokens=ptok,
             ttft=statistics.median(q.ttft() for q in reqs),
             tokens={q.req_id: list(q.out) for q in reqs}, graphs0=graphs0,
             graphs=graph_counts(eng), launches=counts[name], prefill=pf,
             prefill_pool=graph_pool_bytes(torch, eng._prefill_fn))
    label = f"{label} {kind} chunked serving, {kv or 'bf16'} pools"
    err = decode_launch_error(counts, kv, L, steps)
    if err:
        fail(f"{label}: {err}")
    want = ({"prefill": 0, "decode": 0, "chunk": 0, "verify": 0}
            if kind == "eager" else
            {"prefill": 1, "decode": 1, "chunk": 0, "verify": 0})
    if graphs0 != want or r["graphs"] != want or not warmed:
        fail(f"{label}: captured graphs {graphs0} after the warm-up and "
             f"{r['graphs']} at the end (expected {want}), warmed_up "
             f"{warmed}")
    if kind == "captured":
        r["prefill_engine"] = eng
    return r


def show_prefill_run(label, r, card):
    pf = r["prefill"]
    per = pf["host_s"] / pf["dispatches"] * 1e3 if pf["dispatches"] else 0.0
    launches = r.get("launches", r.get("counts", {}).get(
        "paged_decode_attention"))
    print(f"{label}: wall {r['wall']:.3f} s, TTFT p50 {r['ttft'] * 1e3:.1f} "
          f"ms, {r['decode_tokens'] / r['wall']:.1f} decode tokens/s, "
          f"{r['steps']} decode steps, {launches} paged-decode launches, "
          f"{pf['dispatches']} prefill dispatches, admit+prefill host "
          f"{pf['host_s']:.3f} s = {per:.2f} ms a dispatch, graphs "
          f"{r['graphs']}, prefill graph pool {gib(r['prefill_pool'])} "
          f"[{card}]")


def prefill_phase(torch, np, model, loop_runs, card):
    """Phase 12(a): the prefill programs captured, whole-prompt (phase
    11(a)'s runs) and chunked (here), and one profiled prefill of each."""
    import gc

    for r in loop_runs:
        show_prefill_run(f"phase 12(a) {r['kind']} whole-prompt serving "
                         f"(phase 11(a)'s run)", r, card)
    whole_eng = next(r.pop("prefill_engine") for r in loop_runs
                     if "prefill_engine" in r)
    for r in loop_runs:
        r.pop("prefill_engine", None)
    prof = {"whole": prefill_profile(torch, whole_eng, "whole-prompt", card)}
    del whole_eng
    gc.collect()
    L = model.config.num_hidden_layers
    _, work = prefix_work(np, model.config.vocab_size, PREFIX_FAMILIES,
                          PREFIX_REQUESTS, PREFIX_REPEATS,
                          PREFIX_SERVE["max_batch"])
    for kv, order in PREFILL_ORDER.items():
        runs = []
        for kind in order:
            runs.append(chunked_run(torch, np, model, kind,
                                    None if kv == "bf16" else kv, work, L))
            show_prefill_run(f"phase 12(a) {kind} chunked serving, {kv} "
                             f"pools", runs[-1], card)
            gc.collect()
        if any(r["tokens"] != runs[0]["tokens"] for r in runs):
            fail(f"phase 12(a): the {kv} chunked eager, captured and "
                 f"overlap token streams differ")
        print(f"phase 12(a) {kv} chunked: all {len(runs)} token streams "
              f"bitwise equal")
        eng = next(r.pop("prefill_engine") for r in runs
                   if "prefill_engine" in r)
        for r in runs:
            r.pop("prefill_engine", None)
        prof[f"chunked {kv}"] = prefill_profile(
            torch, eng, f"chunked {kv} pools", card)
        del eng, runs
        gc.collect()
    torch.cuda.empty_cache()
    return prof


def warm_engine(np, eng, n=2):
    """Serve ``n`` one-token prompts one after another: each program runs
    eagerly once and is captured; the warm requests leave no trace."""
    for i in range(n):
        eng.add_request(("warm", i), np.ones(1, np.int32), max_new_tokens=3)
        eng.run()
        del eng._completed[("warm", i)]


def overlap_expiry_check(torch, np, model, prompts):
    """A captured overlap engine at OVERLOAD's shapes: request 0's deadline
    (on a fake clock) lapses while a dispatch that served it is still on
    the ring. Returns (tokens it had at the expiry, tokens it ends with,
    the other streams, the same streams from a sync engine, blocks free)."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.utils.retries import Deadline

    clock = {"t": 0.0}
    got = {}
    for overlap in (True, False):
        eng = ContinuousBatchingEngine(model, **OVERLOAD, overlap=overlap)
        warm_engine(np, eng)
        reqs = [eng.add_request(i, p, max_new_tokens=OVERLOAD_NEW,
                                deadline=Deadline(1.0, clock=lambda: clock["t"])
                                if overlap and i == 0 else None)
                for i, p in enumerate(prompts)]
        clock["t"] = 0.0
        at_expiry = None
        for _ in range(4 * OVERLOAD_NEW):
            if not (eng._queue or eng.num_active):
                break
            eng.step()
            if (overlap and at_expiry is None and len(reqs[0].out) >= 4
                    and any(row[1] is reqs[0] for e in eng._ring
                            for row in e.rows)):
                clock["t"] = 5.0  # lapses with a dispatch of it in flight
                eng.step()
                at_expiry = len(reqs[0].out)
        eng.run()
        got[overlap] = dict(
            expired=(reqs[0].status, at_expiry, len(reqs[0].out)),
            tokens={q.req_id: list(q.out) for q in reqs[1:]},
            free=eng.manager.free_blocks == eng.manager.num_blocks)
        del eng
    return got


def overlap_expiry_ok(chk) -> bool:
    """The gate over ``overlap_expiry_check``: the request expired, gained
    no token after its expiry, the others equal the sync engine's, and
    every block came back."""
    status, at, final = chk[True]["expired"]
    return (status == "expired" and at is not None and final == at
            and chk[True]["tokens"] == chk[False]["tokens"]
            and chk[True]["free"] and chk[False]["free"])


def overload_phase(torch, np, model, card):
    """Phase 12(b): the reference's overload scenario, captured, with
    tracing and the resource ledger on."""
    import gc

    from paddle_tpu_torch import obs
    from paddle_tpu_torch.inference import (AdmissionConfig,
                                            ContinuousBatchingEngine)
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.utils import resources

    B, L = OVERLOAD["max_batch"], model.config.num_hidden_layers
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, model.config.vocab_size,
                           (int(OVERLOAD_LENS[i % len(OVERLOAD_LENS)]),))
               for i in range(OVERLOAD_REQUESTS)]
    obs.set_enabled(True)
    obs.ring().clear()
    led = resources.instrument_resources()
    try:
        calib = ContinuousBatchingEngine(model, **OVERLOAD)
        warm_engine(np, calib)
        n_cal = min(3 * B, OVERLOAD_REQUESTS)
        t0 = time.perf_counter()
        for i in range(n_cal):
            calib.add_request(i, prompts[i], max_new_tokens=OVERLOAD_NEW)
        calib.run()
        cal_wall = time.perf_counter() - t0
        capacity = (calib.prefill_tokens + calib.decode_tokens) / cal_wall
        lat_scale = cal_wall / max(n_cal / B, 1)
        del calib
        inter_ddl = max(8 * lat_scale, 1.0)
        batch_ddl = max(24 * lat_scale, 3.0)
        per_req = float(np.mean([p.size for p in prompts])) + OVERLOAD_NEW
        arrival_dt = per_req / (2.0 * capacity)  # 2x offered load
        eng = ContinuousBatchingEngine(model, **OVERLOAD, admission=(
            AdmissionConfig(max_queue=B, high_watermark=0.75,
                            target_delay_s=inter_ddl / 2)))
        warm_engine(np, eng)
        # the warm steps carried the captures: drop them from the EWMAs
        eng.ewma_step_s = eng.ewma_step_tokens = None
        expired_at = {}
        expire = eng._expire

        def recorded_expire(req):
            expired_at[req.req_id] = len(req.out)
            expire(req)

        eng._expire = recorded_expire
        submitted, stopped = 0, False
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        steps0 = eng.decode_steps
        t0 = time.perf_counter()
        while submitted < OVERLOAD_REQUESTS or eng._queue or eng.num_active:
            now = time.perf_counter() - t0
            if now > OVERLOAD_BUDGET_S:
                stopped = True
                break
            while submitted < OVERLOAD_REQUESTS and now >= submitted * arrival_dt:
                i = submitted
                pri = "interactive" if i % 3 == 0 else "batch"
                eng.add_request(i, prompts[i], max_new_tokens=OVERLOAD_NEW,
                                priority=pri, deadline=inter_ddl
                                if pri == "interactive" else batch_ddl)
                submitted += 1
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        steps = eng.decode_steps - steps0
        done = dict(eng._completed)
        graphs = graph_counts(eng)
        acc = eng.manager.accounting()
        try:
            led.verify(eng.manager)
            leaks = led.leak_check()
        except resources.ResourceLeakError as e:
            leaks = str(e)
        level, n_expired = eng.admission.level, eng.n_expired
        n_shed = dict(eng.n_shed.items())
        events = obs.ring().dump()
        del eng
        gc.collect()
    finally:
        resources.uninstrument_resources()
    ok = [r for r in done.values() if r.status == "ok"]
    ok_inter = [r for r in ok if r.priority == "interactive"]
    ttfts = sorted(r.ttft() for r in ok_inter if r.ttft() is not None)
    reasons = {}
    for r in done.values():
        if r.status == "shed":
            key = f"{r.priority}:{r.shed_reason}"
            reasons[key] = reasons.get(key, 0) + 1
    goodput = sum(len(r.out) for r in ok) / wall
    pct = lambda xs, q: (xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3  # noqa: E731
                         if xs else float("nan"))
    print(f"phase 12(b) overload: capacity {capacity:.1f} tokens/s "
          f"(closed-loop calibration, {n_cal} requests, {cal_wall:.3f} s), "
          f"offered 2x: {submitted} requests, one in {arrival_dt * 1e3:.2f} "
          f"ms, deadlines interactive {inter_ddl * 1e3:.0f} ms / batch "
          f"{batch_ddl * 1e3:.0f} ms; wall {wall:.3f} s, goodput "
          f"{goodput:.1f} ok tokens/s, ok {len(ok)} ({len(ok_inter)} "
          f"interactive), shed {n_shed} by reason {reasons}, "
          f"accepted-then-expired {n_expired}, interactive TTFT p50 "
          f"{pct(ttfts, 0.5):.1f} ms p99 {pct(ttfts, 0.99):.1f} ms against "
          f"its {inter_ddl * 1e3:.0f} ms deadline, admission level {level}, "
          f"graphs {graphs}, {steps} decode steps, paged-decode launches "
          f"{counts.get('paged_decode_attention', 0)} bf16 / "
          f"{counts.get('paged_decode_attention_int8', 0)} int8 [{card}]")
    statuses = {r.status for r in done.values()}
    if (len(done) != OVERLOAD_REQUESTS or not statuses <= {"ok", "shed",
                                                             "expired"}
            or stopped):
        fail(f"phase 12(b): {len(done)} of {OVERLOAD_REQUESTS} requests "
             f"ended ({statuses}), budget stop {stopped}")
    if graphs != {"prefill": 1, "decode": 1, "chunk": 0, "verify": 0}:
        fail(f"phase 12(b): captured graphs {graphs}")
    err = decode_launch_error(counts, None, L, steps)
    if err:
        fail(f"phase 12(b): {err}")
    if not (acc["free"] == acc["total"] and not acc["owned"]):
        fail(f"phase 12(b): blocks not all free at the end: {acc}")
    if leaks != 0:
        fail(f"phase 12(b): the resource ledger is not clean: {leaks}")
    late = {rid: (n, len(done[rid].out)) for rid, n in expired_at.items()
            if len(done[rid].out) != n}
    if late:
        fail(f"phase 12(b): expired requests gained tokens after their "
             f"expiry: {late}")
    # the span tree of an admitted request that led a dispatch
    spans = [e for e in events if e.get("ph") == "X"]
    by_trace = {}
    for e in spans:
        by_trace.setdefault(e["trace_id"], []).append(e)
    ok_traces = {r.trace_id for r in ok}
    full = None
    for tid in sorted(ok_traces):
        ev = by_trace.get(tid, [])
        names = {e["name"] for e in ev}
        ids = {e["span_id"] for e in ev}
        if ({"admission", "prefill", "decode", "dispatch", "harvest"} <= names
                and all(not e.get("parent_id") or e["parent_id"] in ids
                        for e in ev)):
            full = (tid, sorted(names), len(ev))
            break
    if full is None:
        fail("phase 12(b): no admitted request's trace holds its admission, "
             "prefill, decode, dispatch and harvest spans")
    print(f"phase 12(b) the span tree of one admitted request: trace "
          f"{full[0]}, {full[2]} spans named {full[1]}, no orphans; "
          f"{len(spans)} spans in the ring")
    # ok streams against an unloaded engine (same shapes, no admission)
    ref = ContinuousBatchingEngine(model, **OVERLOAD)
    warm_engine(np, ref)
    for r in ok:
        ref.add_request(r.req_id, prompts[r.req_id],
                        max_new_tokens=r.max_new_tokens)
    want = ref.run()
    del ref
    bad = [r.req_id for r in ok if list(r.out) != list(want[r.req_id].out)]
    if bad:
        fail(f"phase 12(b): {len(bad)} of {len(ok)} ok streams differ from "
             f"the unloaded engine's: {bad[:8]}")
    print(f"phase 12(b) all {len(ok)} ok streams bitwise equal to the "
          f"unloaded engine's; every block free, the ledger clean, no "
          f"expired request gained a token after its expiry")
    chk = overlap_expiry_check(torch, np, model, prompts[:6])
    _, at, final = chk[True]["expired"]
    ok_chk = overlap_expiry_ok(chk)
    print(f"phase 12(b) deadline under overlap: request 0 expired with a "
          f"dispatch of it in flight, {at} tokens at the expiry and {final} "
          f"at the end; the other {len(chk[True]['tokens'])} streams "
          f"{'equal' if chk[True]['tokens'] == chk[False]['tokens'] else 'DIFFER FROM'} "
          f"the sync engine's -> {'pass' if ok_chk else 'FAIL'}")
    if not ok_chk:
        fail(f"phase 12(b): deadline under overlap: {chk}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(goodput=goodput, ok=len(ok), n_shed=n_shed,
                expired=n_expired)


class CrcAudit(dict):
    """A tier backend that checks each frame a lookup fetches against its
    own CRC, independently of the tier's decoder."""

    def __init__(self):
        super().__init__()
        self.fetched = self.corrupt_fetched = 0

    def get(self, key, default=None):
        import struct
        import zlib

        frame = super().get(key, default)
        if frame is not None:
            self.fetched += 1
            (crc,) = struct.unpack(">I", frame[-4:])
            if zlib.crc32(frame[:-4]) & 0xFFFFFFFF != crc:
                self.corrupt_fetched += 1
        return frame


def tier_run(torch, np, model, kv, work, num_blocks, tier, corrupt=False):
    """One engine of 12(c) over ``work``: captured, sync, warmed on an
    unrelated prompt first; ``tier`` is attached after the warm-up. Each
    restore is checked as it lands: the pools keep their addresses, and
    the restored blocks re-export bitwise as the frame's pages (and
    scales)."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.testing import chaos

    eng = ContinuousBatchingEngine(
        model, **dict(PREFIX_SERVE, num_blocks=num_blocks), kv_dtype=kv)
    vocab = model.config.vocab_size
    warm = np.random.RandomState(98).randint(0, vocab, (PREFIX_LEN + 64,))
    eng.add_request("warm", warm, max_new_tokens=PREFILL_WARM_NEW)
    eng.run()
    eng.prefix_cache.clear()
    eng.cache_tier = tier
    ptrs = [[t.data_ptr() for t in e] for e in eng._pools]
    checks = []
    mgr = eng.manager
    real_import = mgr.import_blocks

    def checked_import(seq_id, pages, scales, meta, pools):
        out = real_import(seq_id, pages, scales, meta, pools)
        again, sc, meta2 = mgr.export_blocks(seq_id, eng._pools)
        same = (meta2 == dict(meta) and np.array_equal(again, pages)
                and (scales is None or np.array_equal(sc, scales)))
        moved = [[t.data_ptr() for t in e] for e in eng._pools] != ptrs
        checks.append((same, moved))
        return out

    mgr.import_blocks = checked_import
    spill_host = [0.0]
    spill = eng._tier_spill

    def timed_spill(*a):
        t = time.perf_counter()
        try:
            return spill(*a)
        finally:
            spill_host[0] += time.perf_counter() - t

    eng._tier_spill = timed_spill
    c0 = (eng.prefix_hit_tokens, eng.decode_tokens,
          eng.prefix_stats()["evicted_blocks"], eng.decode_steps)
    if corrupt:
        chaos.install(chaos.ChaosSchedule(seed=3).with_probability(
            "cache.spill", TIER_CORRUPT_P, "corrupt", TIER_CORRUPT_BIT))
    try:
        reqs = [eng.add_request(rid, p, max_new_tokens=TIER_NEW)
                for rid, p in work]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    finally:
        if corrupt:
            chaos.uninstall()
    st = eng.prefix_stats()
    steps = eng.decode_steps - c0[3]
    r = dict(wall=wall, ttft=statistics.median(q.ttft() for q in reqs),
             tokens={q.req_id: list(q.out) for q in reqs},
             hit_tokens=eng.prefix_hit_tokens - c0[0],
             decode_tokens=eng.decode_tokens - c0[1],
             evicted=st["evicted_blocks"] - c0[2], tier=st.get("tier"),
             checks=checks, spill_host_s=spill_host[0],
             ptrs_kept=[[t.data_ptr() for t in e] for e in eng._pools] == ptrs,
             graphs=graph_counts(eng), steps=steps,
             launches=(counts.get("paged_decode_attention", 0),
                       counts.get("paged_decode_attention_int8", 0)),
             launch_error=decode_launch_error(
                 counts, kv, model.config.num_hidden_layers, steps))
    del eng, mgr
    return r


TIER_ENGINES = ("no tier", "tier", "large pool", "tier, corrupt spills")


def tier_runs(torch, np, model, kv, n_requests, which=TIER_ENGINES):
    """12(c)'s engines (``which`` of ``TIER_ENGINES``) on ``kv`` pools over
    ``n_requests`` requests: no tier, the tier, the large pool, and the
    tier under corrupt spills. Returns {name: run}."""
    import gc

    from paddle_tpu_torch.inference import HostTier

    _, work = prefix_work(np, model.config.vocab_size, TIER_FAMILIES,
                          n_requests, fixed_tails=True)
    out = {}
    for name, blocks, tier, corrupt in (
            ("no tier", PREFIX_SERVE["num_blocks"], None, False),
            ("tier", PREFIX_SERVE["num_blocks"],
             HostTier(capacity_bytes=TIER_CAPACITY), False),
            ("large pool", TIER_LARGE_BLOCKS, None, False),
            ("tier, corrupt spills", PREFIX_SERVE["num_blocks"],
             HostTier(capacity_bytes=TIER_CAPACITY, backend=CrcAudit()),
             True)):
        if name not in which:
            continue
        out[name] = tier_run(torch, np, model, kv, work, blocks, tier,
                             corrupt)
        if tier is not None:
            out[name]["audit"] = (getattr(tier._data, "fetched", None),
                                  getattr(tier._data, "corrupt_fetched", None))
        del tier
        gc.collect()
    return out


def tier_failures(res):
    """12(c)'s gates over ``tier_runs``'s result: the failures, worded."""
    bad = [f"{name}: {r['launch_error']}" for name, r in res.items()
           if r["launch_error"]]
    want = res["large pool"]["tokens"]
    for name in ("tier", "tier, corrupt spills"):
        r = res[name]
        if r["tokens"] != want:
            n = sum(r["tokens"][k] != want[k] for k in want)
            bad.append(f"{name}: {n} streams differ from the large pool's")
        if not r["tier"]["restores"]:
            bad.append(f"{name}: no tier restore happened")
        if not all(same for same, _ in r["checks"]):
            bad.append(f"{name}: a restored prefix re-exports other bytes "
                       f"than its frame's")
        if any(moved for _, moved in r["checks"]) or not r["ptrs_kept"]:
            bad.append(f"{name}: a restore rebound the pools")
        if r["graphs"]["prefill"] != 1 or r["graphs"]["decode"] != 1:
            bad.append(f"{name}: graphs {r['graphs']}")
    c = res["tier, corrupt spills"]
    fetched, corrupt = c["audit"]
    if not corrupt or corrupt != c["tier"]["corrupt_rejected"]:
        bad.append(f"tier, corrupt spills: {corrupt} corrupt frames looked "
                   f"up, {c['tier']['corrupt_rejected']} CRC rejections")
    return bad


def tier_phase(torch, np, model, card):
    """Phase 12(c): the host-RAM tier on bf16 and int8 pools."""
    for kv in (None, "int8"):
        res = tier_runs(torch, np, model, kv, TIER_REQUESTS)
        for name, r in res.items():
            t = r["tier"] or {}
            print(f"phase 12(c) {kv or 'bf16'} pools, {name}: "
                  f"{len(r['tokens'])} requests ({TIER_FAMILIES} families "
                  f"of {PREFIX_LEN}-token prefixes with one tail each of "
                  f"{PREFIX_TAILS}, round-robin, {TIER_NEW} new tokens) wall "
                  f"{r['wall']:.3f} s, TTFT p50 {r['ttft'] * 1e3:.1f} ms, "
                  f"HBM hit tokens {r['hit_tokens']}, evicted blocks "
                  f"{r['evicted']}, tier restores {t.get('restores', 0)} "
                  f"({t.get('restore_tokens', 0)} tokens), spills "
                  f"{t.get('puts', 0)} ({t.get('spill_bytes', 0) / 2**20:.1f}"
                  f" MiB read from the card in {t.get('spill_s', 0.0) * 1e3:.1f}"
                  f" ms; the whole write-through {r['spill_host_s'] * 1e3:.1f}"
                  f" ms of host), tier bytes {t.get('bytes', 0) / 2**20:.1f} "
                  f"MiB, CRC rejections {t.get('corrupt_rejected', 0)}, "
                  f"lookups audited {r.get('audit')}, {r['steps']} decode "
                  f"steps, paged-decode launches {r['launches'][0]} bf16 / "
                  f"{r['launches'][1]} int8 [{card}]")
        want = res["large pool"]["tokens"]
        recompute = sum(res["no tier"]["tokens"][k] != want[k] for k in want)
        print(f"phase 12(c) {kv or 'bf16'} pools: the no-tier engine's "
              f"streams differ from the large pool's in {recompute} of "
              f"{len(want)} (reported, not gated: a recomputed prefix "
              f"rounds as a prefill of its own)")
        bad = tier_failures(res)
        if bad:
            fail(f"phase 12(c) {kv or 'bf16'} pools: " + "; ".join(bad))
        print(f"phase 12(c) {kv or 'bf16'} pools: tier streams equal the "
              f"large pool's bitwise, {sum(len(r['checks']) for r in res.values())} "
              f"restores re-export bitwise, pools never rebound, every "
              f"corrupt frame looked up rejected by its CRC, every engine's "
              f"paged-decode launches = layers x decode steps")


def front_door_phase(torch, np, model, loop_runs, card):
    """Phase 12: (a) prefill capture, (b) overload control, (c) the
    host-RAM tier."""
    prof = prefill_phase(torch, np, model, loop_runs, card)
    overload = overload_phase(torch, np, model, card)
    tier_phase(torch, np, model, card)
    return prof, overload


# -- phase 13: disaggregated serving ---------------------------------------
# benchmarks/serving_throughput.py:455-461 (Part 5, on-TPU numbers): one
# prefill_only and one decode_only engine against the unified chunked
# engine, 12 prompts of 128 tokens (48 new each) and 4 of 4096 (16 new);
# block_size 8 is the worker processes' (testing/disagg_worker.py)
DISAGG = dict(max_batch=8, max_len=4352, block_size=8, prefill_chunk=512,
              num_blocks=8 * (-(-4352 // 8)) + 8)
DISAGG_SHORT = (12, 128, 48)  # requests, prompt tokens, new tokens
# Llama-542M's widths at this depth: a handoff is host work in proportion
# to its pages (a 4096-token prompt's 268 MB at 8 layers, ~0.09 GB/s),
# which held each of (c)'s process turns near 30 s
DISAGG_DEPTH = 2
DISAGG_LONG = (4, 4096, 16)
DISAGG_STEPS_PER_PUMP = 8  # the source's decode worker (:522)
# the warm-up prompt spans two chunks, so that each program is called twice
# (eager, then captured) before a counted or timed run
DISAGG_WARM = (600, 4)
# 13(c)'s kill: 4 parts and a commit a transfer, so the fault at leg 7 ends
# the prefill worker on the second part of its second transfer
DISAGG_KILL_PARTS, DISAGG_KILL = 4, "handoff.transfer@7=kill"
DISAGG_KILL_REQUESTS, DISAGG_FALLBACK_REQUESTS, DISAGG_KILL_NEW = 5, 3, 8
# 13(c)'s store moves ~40 MB/s each way, so a 4096-token handoff (268 MB of
# pages) takes seconds, and a pump that settles several of them outlasts the
# reference's 15 s heartbeat and 30 s handoff budget: the router reads
# liveness from the process handles, and a handoff gets DISAGG_BUDGET_S
DISAGG_BUDGET_S = 300.0


def disagg_work(np, vocab, seed, n_long=DISAGG_LONG[0]):
    """Phase 13's traffic: ``[(req_id, prompt, new tokens)]``, the short
    prompts then the long ones, drawn in the source's order (its
    ``RandomState(4)`` at ``--seed 0``)."""
    rng = np.random.RandomState(seed + 4)
    (ns, ls, gs), (nl, ll, gl) = DISAGG_SHORT, DISAGG_LONG
    shorts = [(f"s{i}", rng.randint(0, vocab, (ls,)), gs) for i in range(ns)]
    longs = [(f"l{i}", rng.randint(0, vocab, (ll,)), gl) for i in range(nl)]
    return shorts + longs[:n_long]


def itl_ms(times_by_rid):
    """p50 and p99 of the inter-token latencies (ms) of some streams'
    per-token ``perf_counter`` stamps."""
    import numpy as np

    xs = [b - a for ts in times_by_rid for a, b in zip(ts, ts[1:])]
    if not xs:
        return float("nan"), float("nan")
    return (float(np.percentile(xs, 50)) * 1e3,
            float(np.percentile(xs, 99)) * 1e3)


def warm_prompt(np, vocab):
    return np.random.RandomState(97).randint(0, vocab, (DISAGG_WARM[0],))


def unified_engine(np, model, kv=None, overlap=False):
    """The unified chunked engine of phase 13, warmed: its programs are
    captured."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(model, **DISAGG, kv_dtype=kv,
                                   overlap=overlap)
    eng.add_request("warm", warm_prompt(np, model.config.vocab_size),
                    max_new_tokens=DISAGG_WARM[1])
    eng.run()
    return eng


def unified_run(torch, eng, work, tag):
    """``work`` on the unified engine: its streams (keyed by the work's
    ids), the short requests' ITL p50/p99 and the wall."""
    for rid, p, n in work:
        eng.add_request(tag + rid, p, max_new_tokens=n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    short = {f"s{i}" for i in range(DISAGG_SHORT[0])}
    return dict(tokens={rid: list(done[tag + rid].out) for rid, _, _ in work},
                itl=itl_ms([done[tag + rid].times for rid, _, _ in work
                            if rid in short]), wall=wall,
                ok=all(done[tag + rid].status == "ok" for rid, _, _ in work))


def stream_departures(torch, model, work, got, want):
    """``(departures, worst gap)``: the requests whose stream departs from
    ``want``, each with the top-2 logit gap of ``want``'s logits at the
    first differing position (a near tie when below ``SPEC_GAP_BOUND``)."""
    out = []
    prompts = {rid: p for rid, p, _ in work}
    for rid, w in want.items():
        g = got.get(rid)
        if g is None or len(g) != len(w):
            out.append((rid, float("inf")))
            continue
        j = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is not None:
            out.append((rid, top2_gaps(torch, model, prompts[rid], w)[j]))
    return out, max((gap for _, gap in out), default=0.0)


def _expected_body(blocks, cfg, kv, itemsize=2):
    """The bytes a payload's pages and scale rows take: blocks x layers x
    2 (K, V) x KVH x block_size x D x the element size (1 for int8 pools,
    else the model's: 2 in bf16), plus the f32 scale rows of int8 pools."""
    kvh, bs = cfg.num_key_value_heads, DISAGG["block_size"]
    d = cfg.hidden_size // cfg.num_attention_heads
    n = blocks * cfg.num_hidden_layers * 2 * kvh * bs
    return n * d * (1 if kv else itemsize) + (n * 4 if kv else 0)


def disagg_inprocess(torch, np, model, work, kv=None, overlap=False,
                     uni=None):
    """One ``prefill_only`` and one ``decode_only`` engine behind a
    ``DisaggRouter`` over a ``MemKVStore``, in this process, on ``work``,
    held against the unified engine's streams ``uni``. Counts each worker's
    kernel launches around its pumps, times each handoff's legs, and
    checks a partial transfer is never imported. Returns a dict with
    ``failures`` (empty when every gate holds)."""
    from paddle_tpu_torch.distributed.store import MemKVStore
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.disagg import (DecodeWorker, DisaggRouter,
                                                   HandoffPayload,
                                                   KVHandoffSender,
                                                   PrefillWorker)
    from paddle_tpu_torch.ops import kernels

    L = model.config.num_hidden_layers
    engines = {"pf": [], "dx": []}
    hand = {}  # req_id -> the handoff's legs and bytes

    def factory(role):
        def make():
            eng = ContinuousBatchingEngine(
                model, **DISAGG, kv_dtype=kv, overlap=overlap,
                role="prefill_only" if role == "pf" else "decode_only")
            if role == "pf":
                export = eng.export_kv

                def export_kv(req_id, kv_len=None):
                    h = hand.setdefault(req_id, {})
                    h["owned"] = len(eng.manager.owned_blocks(req_id))
                    t0 = time.perf_counter()
                    out = export(req_id, kv_len=kv_len)
                    h["export_s"] = time.perf_counter() - t0
                    h["blocks"] = out[2]["num_blocks"]
                    h["scales"] = out[1] is not None
                    return out
                eng.export_kv = export_kv
            else:
                imp = eng.import_kv

                def import_kv(req, first, pages, scales, meta):
                    t0 = time.perf_counter()
                    imp(req, first, pages, scales, meta)
                    torch.cuda.synchronize()  # the upload, timed whole
                    hand.setdefault(req.req_id, {})["import_s"] = \
                        time.perf_counter() - t0
                eng.import_kv = import_kv
            engines[role].append(eng)
            return eng
        return make

    store = MemKVStore()
    pf = PrefillWorker("pf0", factory("pf"), store, ["dx0"],
                       handoff_budget=DISAGG_BUDGET_S)
    dx = DecodeWorker("dx0", factory("dx"), store,
                      steps_per_pump=DISAGG_STEPS_PER_PUMP)
    sender, receiver = pf.senders[0], dx.receiver
    send, put, settle = (sender.send_handoff, sender._put_transfer,
                         receiver._settle)

    def send_handoff(payload, deadline=None):
        t0 = time.perf_counter()
        seq = send(payload, deadline=deadline)
        h = hand.setdefault(payload.req_id, {})
        h["send_s"] = h.get("send_s", 0.0) + time.perf_counter() - t0
        return seq

    def put_transfer(seq, req_id, data, dl):
        h = hand.setdefault(req_id, {})
        h["bytes"] = len(data)
        h["header"] = 4 + int.from_bytes(data[:4], "big")
        return put(seq, req_id, data, dl)

    def settle_(seq, key):
        t0 = time.perf_counter()
        p = settle(seq, key)
        if p is not None:
            hand.setdefault(p.req_id, {})["recv_s"] = time.perf_counter() - t0
        return p

    sender.send_handoff, sender._put_transfer = send_handoff, put_transfer
    receiver._settle = settle_
    counts = {}

    def counted(name, pump):
        def run(deadline=None):
            c0 = kernels.launch_counts()
            pump(deadline)
            d = kernels.count_delta(c0, kernels.launch_counts())
            counts[name] = {k: counts.get(name, {}).get(k, 0) + v
                            for k, v in d.items()}
        return run

    pf.pump, dx.pump = counted("pf", pf.pump), counted("dx", dx.pump)
    router = DisaggRouter([pf], [dx])
    router.submit("warm", warm_prompt(np, model.config.vocab_size),
                  max_new_tokens=DISAGG_WARM[1])
    router.run(deadline=DISAGG_BUDGET_S)
    dx_eng = dx.supervisor.engine
    ptrs = [t.data_ptr() for e in dx_eng._pools for t in e]
    counts.clear()
    hand.clear()
    steps0 = {r: sum(e.decode_steps for e in engines[r]) for r in engines}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, p, n in work:
        router.submit(rid, p, max_new_tokens=n)
    res = router.run(deadline=DISAGG_BUDGET_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = {r: sum(e.decode_steps for e in engines[r]) - steps0[r]
             for r in engines}
    failures = []
    tokens = {rid: res.get(rid, {}).get("out") for rid, _, _ in work}
    if any(res.get(rid, {}).get("status") != "ok" for rid, _, _ in work):
        failures.append(f"statuses {[res.get(r, {}).get('status') for r, _, _ in work]}")
    if (router.n_fallback or router.n_handoff_failed or sender.n_nacked
            or receiver.n_nacked or dx_eng.n_imported < len(work)):
        failures.append(
            f"every request must hand off once, cleanly: fallback "
            f"{router.n_fallback}, failed {router.n_handoff_failed}, nacked "
            f"{sender.n_nacked}/{receiver.n_nacked}, imported "
            f"{dx_eng.n_imported}")
    deps, worst = [], 0.0
    if uni is not None:
        deps, worst = stream_departures(torch, model, work, tokens, uni)
        if worst >= SPEC_GAP_BOUND:
            failures.append(f"streams depart from the unified engine's where "
                            f"its logits are not a near tie: {deps}")
    name, other = (("paged_decode_attention_int8", "paged_decode_attention")
                   if kv else ("paged_decode_attention",
                               "paged_decode_attention_int8"))
    pfc, dxc = counts.get("pf", {}), counts.get("dx", {})
    if steps["pf"] or pfc.get(name, 0) or pfc.get(other, 0):
        failures.append(f"the prefill engine decoded: {steps['pf']} steps, "
                        f"counts {pfc}")
    err = decode_launch_error(dxc, kv, L, steps["dx"])
    if err:
        failures.append(f"the decode engine: {err}")
    if [t.data_ptr() for e in dx_eng._pools for t in e] != ptrs:
        failures.append("an import rebound the decode engine's pools")
    prompts = {rid: p for rid, p, _ in work}
    itemsize = torch.empty((), dtype=model.dtype).element_size()
    for rid, h in hand.items():
        want = -(-prompts[rid].size // DISAGG["block_size"])
        body = h.get("bytes", 0) - h.get("header", 0)
        expect = _expected_body(want, model.config, kv, itemsize)
        if (h.get("owned") != want or h.get("blocks") != want
                or body != expect or h.get("scales") != bool(kv)):
            failures.append(f"handoff {rid}: {h}, want {want} blocks held "
                            f"and sent, body {expect}")
    # a transfer whose sender died between its parts: never imported,
    # never acked
    n_recv, n_imp = receiver.n_received, dx_eng.n_imported
    data = HandoffPayload(
        req_id="dead", prompt=np.arange(4, dtype=np.int32), first_token=1,
        max_new_tokens=4, priority="interactive", deadline_unix=None,
        retries=0, pages=np.zeros((L, 2, 16, 1, 8, 128), np.float32),
        scales=None, meta={"num_blocks": 1, "block_size": 8, "layers": L,
                           "dtype": "float32", "quantized": False,
                           "kv_len": 4}).pack()
    parts = KVHandoffSender(store, "dx0", n_parts=4)._split(data)
    for i in (0, 1):
        store.put_bytes(f"disagg/dx0/xfer/dead-00000001/part/{i:04d}",
                        parts[i])
    for _ in range(3):
        dx.pump()
    if (receiver.n_received != n_recv or dx_eng.n_imported != n_imp
            or store.get("disagg/dx0/ack/dead-00000001") is not None):
        failures.append("a partial transfer (parts without a commit) was "
                        "taken up")
    return dict(failures=failures, tokens=tokens, wall=wall, steps=steps,
                counts=counts, hand=hand, departures=deps, worst=worst,
                itl=itl_ms([res.get(rid, {}).get("times", [])
                            for rid, _, _ in work if rid.startswith("s")]),
                router=router)


def show_handoffs(label, r, card):
    """One line of handoff bytes and legs per request kind."""
    for kind, pre in (("128-token", "s"), ("4096-token", "l")):
        hs = [h for rid, h in r["hand"].items() if rid.startswith(pre)]
        if not hs:
            continue
        ms = [1e3 * (h["export_s"] + h["send_s"] + h["recv_s"] + h["import_s"])
              for h in hs]
        body = [h["bytes"] - h["header"] for h in hs]
        print(f"phase 13{label} handoff of a {kind} prompt ({len(hs)} "
              f"requests): {hs[0]['bytes']} bytes = header {hs[0]['header']} "
              f"+ {body[0]} of pages{' and scale rows' if hs[0]['scales'] else ''} "
              f"({hs[0]['blocks']} blocks), mean {statistics.mean(ms):.1f} ms a "
              f"handoff (export {1e3 * statistics.mean(h['export_s'] for h in hs):.1f}"
              f" + pack and put {1e3 * statistics.mean(h['send_s'] for h in hs):.1f}"
              f" + assemble, verify and unpack "
              f"{1e3 * statistics.mean(h['recv_s'] for h in hs):.1f} + import "
              f"{1e3 * statistics.mean(h['import_s'] for h in hs):.1f}), "
              f"{statistics.mean(body) / (statistics.mean(ms) / 1e3) / 1e9:.3f} "
              f"GB/s of pages [{card}]")


def disagg_processes(torch, np, model, args, card, uni_eng, work):
    """Phase 13(c): a prefill and a decode worker process on this card over
    a ``TCPKVStore`` (``python -m paddle_tpu_torch.testing.disagg_worker``),
    the source's Part 5: decode ITL against the unified engine in turns,
    then a second pair whose prefill worker dies to a ``kill`` in the middle
    of a handoff. Each worker publishes its own launch counts."""
    import dataclasses
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from paddle_tpu_torch.distributed.store import TCPKVStore, TCPStoreServer
    from paddle_tpu_torch.inference.cluster import ProcessReplica
    from paddle_tpu_torch.inference.disagg import DisaggRouter
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.utils.retries import Deadline

    L = model.config.num_hidden_layers
    repo = str(Path(__file__).resolve().parent)
    tmp = tempfile.mkdtemp(prefix="disagg_")
    server = TCPStoreServer("127.0.0.1", 0)
    store = TCPKVStore("127.0.0.1", server.port)
    procs = []

    def start(pf_id, dx_id, chaos=None, n_parts=None):
        reps, mine = [], []
        for wid, role in ((pf_id, "prefill"), (dx_id, "decode")):
            env = dict(os.environ)
            env.pop("PADDLE_CHAOS", None)
            env.update(
                DISAGG_DEVICE=model.device.type, DISAGG_ROLE=role,
                DISAGG_STORE_PORT=str(server.port), DISAGG_WORKER_ID=wid,
                DISAGG_JOURNAL_DIR=f"{tmp}/{wid}", DISAGG_DECODE_IDS=dx_id,
                DISAGG_BUDGET="900", DISAGG_CHUNK=str(DISAGG["prefill_chunk"]),
                DISAGG_MAX_LEN=str(DISAGG["max_len"]),
                DISAGG_BLOCKS=str(DISAGG["num_blocks"]),
                DISAGG_BATCH=str(DISAGG["max_batch"]),
                DISAGG_STEPS_PER_PUMP=str(DISAGG_STEPS_PER_PUMP),
                DISAGG_MODEL_JSON=json.dumps(dataclasses.asdict(model.config)),
                DISAGG_SEED=str(args.seed),
                DISAGG_BF16="1" if model.dtype == torch.bfloat16 else "",
                PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""))
            if role == "prefill" and chaos:
                env["PADDLE_CHAOS"] = chaos
            if role == "prefill" and n_parts:
                env["DISAGG_N_PARTS"] = str(n_parts)
            if role == "prefill":
                env["DISAGG_HANDOFF_BUDGET"] = str(DISAGG_BUDGET_S)
            log = open(f"{tmp}/{wid}.log", "w")
            p = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.testing.disagg_worker"],
                env=env, cwd=repo, stdout=log, stderr=subprocess.STDOUT)
            procs.append((p, log, wid))
            mine.append(p)
            reps.append(ProcessReplica(TCPKVStore("127.0.0.1", server.port),
                                       wid, journal_dir=f"{tmp}/{wid}",
                                       proc=p,
                                       heartbeat_timeout=DISAGG_BUDGET_S))
        dl = Deadline(300)
        while not all(store.get(f"cluster/{w}/hb") for w in (pf_id, dx_id)):
            if dl.expired() or any(p.poll() is not None for p in mine):
                logs = {w: Path(f"{tmp}/{w}.log").read_text()[-3000:]
                        for w in (pf_id, dx_id)}
                fail(f"phase 13(c): the workers did not come up: {logs}")
            time.sleep(0.25)
        return DisaggRouter([reps[0]], [reps[1]])

    def worker_logs():
        return {w: Path(f"{tmp}/{w}.log").read_text()[-2000:]
                for _, _, w in procs}

    def launches(wid):
        raw = store.get(f"cluster/{wid}/launches")
        return json.loads(raw) if raw else {"counts": {}, "decode_steps": 0}

    def delta(after, before):
        return (kernels.count_delta(before["counts"], after["counts"]),
                after["decode_steps"] - before["decode_steps"])

    def check_counts(label, pf_id, dx_id, before):
        time.sleep(0.5)  # the workers publish their counts every poll
        pc, ps = delta(launches(pf_id), before[pf_id])
        dc, ds = delta(launches(dx_id), before[dx_id])
        err = decode_launch_error(dc, None, L, ds)
        if ps or pc.get("paged_decode_attention") or \
                pc.get("paged_decode_attention_int8"):
            err = (err or "") + f"; the prefill worker decoded: {ps}, {pc}"
        print(f"phase 13(c) {label}: the prefill worker's paged-decode "
              f"launches {pc.get('paged_decode_attention', 0)}/"
              f"{pc.get('paged_decode_attention_int8', 0)} (float/int8) over "
              f"{ps} decode steps; the decode worker's "
              f"{dc.get('paged_decode_attention', 0)}/"
              f"{dc.get('paged_decode_attention_int8', 0)} over {ds} decode "
              f"steps x {L} layers")
        if err:
            fail(f"phase 13(c) {label}: {err}")

    def disagg_turn(router, tag, pf_id, dx_id):
        before = {w: launches(w) for w in (pf_id, dx_id)}
        for rid, p, n in work:
            router.submit(tag + rid, p, max_new_tokens=n)
        t0 = time.perf_counter()
        res = router.run(deadline=DISAGG_BUDGET_S)
        wall = time.perf_counter() - t0
        short = [tag + f"s{i}" for i in range(DISAGG_SHORT[0])]
        toks = {rid: res.get(tag + rid, {}).get("out") for rid, _, _ in work}
        missing = [rid for rid, _, _ in work
                   if res.get(tag + rid, {}).get("status") != "ok"]
        if missing:
            fail(f"phase 13(c) turn {tag[:-1]}: {missing} did not finish "
                 f"(router: inflight {router.inflight}, dead prefill "
                 f"{router.dead_prefill}, dead decode {router.dead_decode}, "
                 f"events {router.events}); {worker_logs()}")
        check_counts(f"turn {tag[:-1]}", pf_id, dx_id, before)
        return dict(tokens=toks, ok=True, wall=wall,
                    itl=itl_ms([res[r]["times"] for r in short if r in res]),
                    fallback=router.n_fallback)

    try:
        router = start("pf0", "dx0")
        router.submit("warm", warm_prompt(np, model.config.vocab_size),
                      max_new_tokens=DISAGG_WARM[1])
        router.run(deadline=DISAGG_BUDGET_S)
        turns = []
        for kind, tag in (("unified", "A1-"), ("disagg", "B1-"),
                          ("disagg", "B2-"), ("unified", "A2-")):
            r = (unified_run(torch, uni_eng, work, tag) if kind == "unified"
                 else disagg_turn(router, tag, "pf0", "dx0"))
            turns.append((kind, tag[:-1], r))
            print(f"phase 13(c) turn {tag[:-1]} {kind}: decode ITL p50 "
                  f"{r['itl'][0]:.3f} ms, p99 {r['itl'][1]:.3f} ms over the "
                  f"{DISAGG_SHORT[0]} short requests, wall {r['wall']:.3f} s "
                  f"[{card}]")
            if not r["ok"]:
                fail(f"phase 13(c) turn {tag[:-1]}: a request did not finish")
        want = turns[0][2]["tokens"]
        for kind, name, r in turns[1:]:
            deps, worst = stream_departures(torch, model, work, r["tokens"],
                                            want)
            if deps:
                print(f"phase 13(c) turn {name}: {len(deps)} streams depart "
                      f"from turn A1's, top-2 gaps {deps} (bound "
                      f"{SPEC_GAP_BOUND})")
            if worst >= SPEC_GAP_BOUND or (kind == "disagg" and r["fallback"]):
                fail(f"phase 13(c) turn {name}: streams depart where the "
                     f"logits are not a near tie, or fell back: {deps}")
        router.stop(deadline=60)
        for p, log, _ in procs:
            p.wait(timeout=60)

        # the kill: new prompts, and their unified streams first
        rng = np.random.RandomState(args.seed + 13)
        vocab = model.config.vocab_size
        kill_work = [(f"k{i}", rng.randint(0, vocab, (DISAGG_SHORT[1],)),
                      DISAGG_KILL_NEW) for i in range(DISAGG_KILL_REQUESTS)]
        fb_work = [(f"f{i}", rng.randint(0, vocab, (DISAGG_SHORT[1],)),
                    DISAGG_KILL_NEW) for i in range(DISAGG_FALLBACK_REQUESTS)]
        want = unified_run(torch, uni_eng, kill_work + fb_work, "U-")["tokens"]
        router = start("pf1", "dx1", chaos=DISAGG_KILL,
                       n_parts=DISAGG_KILL_PARTS)
        before = {w: launches(w) for w in ("pf1", "dx1")}
        for rid, p, n in kill_work:
            router.submit(rid, p, max_new_tokens=n)
        res = router.run(deadline=DISAGG_BUDGET_S)
        pf_rc = procs[-2][0].wait(timeout=60)
        xfer = store.keys("disagg/dx1/xfer/")
        parts = {k.split("/xfer/")[1].split("/part/")[0] for k in xfer
                 if "/part/" in k}
        commits = {k.split("/xfer/")[1].rsplit("/", 1)[0] for k in xfer
                   if k.endswith("/commit")}
        partial = sorted(parts - commits)
        acked = [s for s in partial if store.get(f"disagg/dx1/ack/{s}")]
        pools = [router.submit(rid, p, max_new_tokens=n)[0]
                 for rid, p, n in fb_work]
        res.update(router.run(deadline=DISAGG_BUDGET_S))
        got = {rid: res.get(rid, {}).get("out")
               for rid, _, _ in kill_work + fb_work}
        lost = [rid for rid, _, _ in kill_work + fb_work
                if res.get(rid, {}).get("status") != "ok"]
        deps, worst = stream_departures(torch, model, kill_work + fb_work,
                                        got, want)
        print(f"phase 13(c) kill at {DISAGG_KILL} ({DISAGG_KILL_PARTS} parts a "
              f"transfer): prefill worker exit {pf_rc}, dead prefill "
              f"{sorted(router.dead_prefill)}, {len(lost)} of "
              f"{len(kill_work) + len(fb_work)} requests lost, partial "
              f"transfers {partial} ({len(acked)} acked), recovery events "
              f"{router.events}, fallback placements {router.n_fallback} "
              f"(the {len(fb_work)} new prompts went to {pools}), streams "
              f"departing from the unified engine's {deps} [{card}]")
        check_counts("kill", "pf1", "dx1", before)
        if (router.dead_prefill != {0} or lost or not partial or acked
                or set(pools) != {"decode"} or worst >= SPEC_GAP_BOUND
                or router.n_fallback < len(fb_work)):
            fail(f"phase 13(c): the mid-handoff kill lost work, imported a "
                 f"partial transfer, or the fallback did not serve; "
                 f"{worker_logs()}")
        router.stop(deadline=60)
        return turns
    finally:
        for p, log, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
            log.close()
        server.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def disagg_phase(torch, np, dev, args, card):
    """Phase 13: disaggregated prefill/decode serving on Llama-542M's
    widths at DISAGG_DEPTH layers in bf16, Part 5's settings: (a) in
    process, against the unified chunked engine; (b) the same over int8
    pools in overlap mode; (c) two worker processes."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    pt_seed(args.seed)  # the workers draw the same weights from the seed
    cfg = LlamaConfig(**dict(LLAMA_542M, num_hidden_layers=DISAGG_DEPTH))
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    model.eval()
    work = disagg_work(np, cfg.vocab_size, args.seed)
    for part, kv, overlap, n in (("(a)", None, False, len(work)),
                                 ("(b)", "int8", True, DISAGG_SHORT[0] + 1)):
        w = work[:n]
        t0 = time.perf_counter()
        uni_eng = unified_engine(np, model, kv, overlap)
        uni = unified_run(torch, uni_eng, w, "u-")
        del uni_eng
        r = disagg_inprocess(torch, np, model, w, kv, overlap, uni["tokens"])
        name = ("paged_decode_attention_int8" if kv
                else "paged_decode_attention")
        print(f"phase 13{part} in process, {kv or 'bf16'} KV pools"
              f"{', overlap' if overlap else ''}: {len(w)} requests "
              f"(prompts {sorted({p.size for _, p, _ in w})}), unified wall "
              f"{uni['wall']:.3f} s (decode ITL p50/p99 "
              f"{uni['itl'][0]:.3f}/{uni['itl'][1]:.3f} ms), disaggregated "
              f"wall {r['wall']:.3f} s (ITL {r['itl'][0]:.3f}/"
              f"{r['itl'][1]:.3f} ms); {len(r['departures'])} streams depart "
              f"from the unified engine's {r['departures']} (bound "
              f"{SPEC_GAP_BOUND}); decode steps prefill/decode engine "
              f"{r['steps']['pf']}/{r['steps']['dx']}, the decode engine's "
              f"{name} launches {r['counts'].get('dx', {}).get(name, 0)}, "
              f"the prefill "
              f"engine's {r['counts'].get('pf', {}).get(name, 0)}; "
              f"{time.perf_counter() - t0:.1f} s in all [{card}]")
        show_handoffs(part, r, card)
        if r["failures"]:
            fail(f"phase 13{part}: " + "; ".join(r["failures"]))
        del r
        torch.cuda.empty_cache()
    uni_eng = unified_engine(np, model)
    disagg_processes(torch, np, model, args, card, uni_eng, work)
    del uni_eng, model
    torch.cuda.empty_cache()


# -- phase 14: low-precision GEMMs --------------------------------------------
# (a) the GEMMs alone: x [8192, 2048] (the train step's B=4 x S=2048 tokens,
# and phase 4's whole-prompt prefill [16, 512]) against the flagship's
# projection and MLP weights, a decode's 16 rows, and an odd shape whose
# depth and width the card refuses unpadded. Each as (M, K, N)
LOWP_GEMM_SHAPES = ((8192, 2048, 2048), (8192, 2048, 5632),
                    (8192, 5632, 2048), (16, 2048, 5632), (5, 30, 40))
# int8_dynamic_matmul's int32 product, card against CPU: a decode's rows
# and the whole-prompt prefill's tokens
LOWP_INT8_SHAPES = ((16, 2048, 5632), (8192, 2048, 2048))
LOWP_CAST_N = 1 << 20  # values cast to e4m3 and e5m2, card against CPU
FP8_FLOPS_PER_S = 1979e12  # H100 SXM dense fp8 (the data sheet's)
# the fp8 GEMM against the plain version (the same fp8 images up-cast and
# multiplied in f32, then the same divide), the worst row's norm-relative
# error. Both sum exact products; the card's fp8 tensor cores accumulate
# in a narrower format between promotions to f32. The first card run's
# worst row was 1.42e-4 (PERF.md §6): a 3.5x margin
FP8_GEMM_ROW_REL = 5e-4
# the wrapper's bf16 outputs (y, dx, dw) against that plain f32 result: the
# GEMM's error and one bf16 rounding (at most 2^-9 of each element)
FP8_OUT_ROW_REL = FP8_GEMM_ROW_REL + 2.0 ** -8
# (b) the fp8 train step: big_mfu_decomp.py:64-74's fp8 variant of the
# flagship step (every Linear but the lm_head an Fp8Linear) with the bench
# step's AdamW (bench.py:448-477: fused, bf16 moments, SR), against the
# same bf16 step, in turns, eager and then captured
FP8_TRAIN_ORDER = ("bf16", "fp8", "fp8", "bf16")
FP8_LINEARS = 56  # 8 layers x 7 Linears
# the fp8 losses against bf16's, step by step (28 steps on one batch, each
# model from its own state after the same steps), in nats: the e4m3/e5m2
# rounding of 56 GEMMs. The first card run's worst gap was 0.054 nats, near
# step 12 (a relative bound fails where both losses near 0): a 2.8x margin
FP8_LOSS_ABS = 0.15
# (c) fp8 serving: phase 4's workload in eager, captured and overlap
# engines, each kind bf16 and fp8 in turns; phase 5b's chunked
# shared-prefix workload on int8 pools in overlap engines, bf16 then fp8.
# Per-tensor just-in-time scales (the engine's model is in eval mode) span
# the whole batch, so a row's fp8 result depends on the other rows: streams
# are compared only across engines whose batches match (phase 4's), never
# fp8 against bf16
FP8_SERVE_ORDER = (("eager", ("bf16", "fp8")), ("captured", ("fp8", "bf16")),
                   ("overlap", ("bf16", "fp8")))
# phase 4's prompts scored by the fp8 and the bf16 model, last position:
# the norm-relative error of the logits and the share of equal argmaxes
# over the 32 prompts. The first card run gave 0.0752 and 0.8125 (26 of
# 32; random weights leave near ties) (PERF.md §6): margins of 1.6x and
# 3 more flips
FP8_LOGIT_REL, FP8_ARGMAX_MIN = 0.12, 0.7
# the KV write where many lanes share a cell (the rows pointed at the trash
# block), repeated on the card: every write's pools bitwise the CPU's. Those
# rows' activations enter fp8's per-tensor scales, so a write whose winner
# varied from run to run made the fp8 streams vary with it
FP8_TRASH_WRITE_REPS = 20
# (d) generate (paged, B=16, prompt 128, +32) on Llama-542M converted three
# ways; the last-logit norm-relative error against the bf16 model's. The
# first card run gave int8 0.0175, int4 0.187, llm.int8 0.0317 (PERF.md
# §6): margins of 2.1x-2.9x
LOWP_GEN_B, LOWP_GEN_PROMPT, LOWP_GEN_NEW = 16, 128, 32
WO_LOGIT_REL = {"int8": 0.05, "int4": 0.4, "llm.int8": 0.08}


def fp8_gemm_case(torch, dev, gen, m, k, n):
    """Phase 14(a) at one shape: the forward, dgrad and wgrad GEMMs on the
    card against their plain versions, the wrapper's bf16 outputs against
    the same, and the times of the GEMMs beside a bf16 matmul."""
    from paddle_tpu_torch.amp import fp8 as F8
    from paddle_tpu_torch.nn import quant as Q

    bf = torch.bfloat16
    x = torch.randn(m, k, generator=gen, device=dev).to(bf)
    w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5).to(bf)
    dy = torch.randn(m, n, generator=gen, device=dev).to(bf)
    xs, ws = F8._jit_scale(x, F8.E4M3_MAX), F8._jit_scale(w, F8.E4M3_MAX)
    dys = F8._jit_scale(dy, F8.E5M2_MAX)
    qx = F8._cast_fp8(x, xs, F8.E4M3, F8.E4M3_MAX)
    qw = F8._cast_fp8(w, ws, F8.E4M3, F8.E4M3_MAX)
    qdy = F8._cast_fp8(dy, dys, F8.E5M2, F8.E5M2_MAX)
    plain, row = {}, {}
    for name, (a, b, s) in {"forward": (qx, qw, xs * ws),
                            "dgrad": (qdy, qw.t(), dys * ws),
                            "wgrad": (qx.t(), qdy, xs * dys)}.items():
        plain[name] = F8._mm_plain(a, b) / s
        row[name] = row_rel_err(F8._mm(a, b) / s, plain[name])
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = F8.fp8_linear(xr, wr)
    y.backward(dy)
    out = {"y": row_rel_err(y, plain["forward"]),
           "dx": row_rel_err(xr.grad, plain["dgrad"]),
           "dw": row_rel_err(wr.grad, plain["wgrad"])}
    del xr, wr, y, plain
    qwc = qw.t().contiguous().t()  # the layout _scaled_mm takes
    q8, s8 = Q.weight_quantize(w)
    q8c = q8.t().contiguous().t()
    qa, _ = Q._quantize_rows(x)
    with torch.no_grad():
        ms = dict(
            bf16=time_ms(lambda: torch.matmul(x, w), 10),
            fp8_gemm=time_ms(lambda: F8._mm(qx, qwc), 10),
            fp8_linear=time_ms(lambda: F8.fp8_linear(x, w), 10),
            int8_gemm=time_ms(lambda: Q._int8_mm(qa, q8c), 10),
            int8_linear=time_ms(lambda: Q.int8_dynamic_matmul(x, q8c, s8),
                                10))
    flops = 2.0 * m * k * n
    fp8_bound = max((m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S,
                    flops / FP8_FLOPS_PER_S) * 1e3
    return dict(shape=(m, k, n), row=row, out=out, ms=ms, fp8_bound=fp8_bound,
                bf16_bound=bound(2 * (m * k + k * n + m * n), flops)[0])


def int8_bitwise_case(torch, dev, gen, m, k, n):
    """``int8_dynamic_matmul``'s pieces on the card against the CPU: the
    weight's int8 image and scales, and the int32 product (bitwise)."""
    from paddle_tpu_torch.nn import quant as Q

    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    q, s = Q.weight_quantize(w)
    qc, sc = Q.weight_quantize(w.cpu())
    qa, _ = Q._quantize_rows(x)
    acc = Q._int8_mm(qa, q).cpu()
    want = Q._int8_mm(qa.cpu(), q.cpu())
    return dict(shape=(m, k, n), weight=torch.equal(q.cpu(), qc) and
                torch.equal(s.cpu(), sc), product=torch.equal(acc, want))


def cast_bitwise(torch, dev):
    """The e4m3 and e5m2 casts of LOWP_CAST_N values of every magnitude, on
    the card against the CPU, at unit and odd scales."""
    from paddle_tpu_torch.amp import fp8 as F8

    g = torch.Generator().manual_seed(14)
    x = torch.randn(LOWP_CAST_N, generator=g) * torch.exp2(torch.randint(
        -24, 20, (LOWP_CAST_N,), generator=g).float())
    xd = x.to(dev)
    out = {}
    for dt, fmax in ((F8.E4M3, F8.E4M3_MAX), (F8.E5M2, F8.E5M2_MAX)):
        for s in (1.0, 0.37, 1234.5):
            a = F8._cast_fp8(xd, torch.tensor(s, device=dev), dt, fmax)
            b = F8._cast_fp8(x, torch.tensor(s), dt, fmax)
            out[f"{str(dt).split('_')[1]} x{s}"] = torch.equal(
                a.view(torch.uint8).cpu(), b.view(torch.uint8))
    return out


def fp8_gemm_failures(torch, dev, gen, card, shapes=LOWP_GEMM_SHAPES,
                      show=True):
    """Phase 14(a): returns the failures."""
    bad = []
    for m, k, n in shapes:
        r = fp8_gemm_case(torch, dev, gen, m, k, n)
        worst, worst_out = max(r["row"].values()), max(r["out"].values())
        if show:
            t = r["ms"]
            print(f"phase 14(a) fp8 GEMM [{m}, {k}] x [{k}, {n}]: worst row "
                  f"rel err against the plain f32 product of the same "
                  f"images " + ", ".join(f"{a} {b:.3g}"
                                         for a, b in r["row"].items())
                  + f" (bound {FP8_GEMM_ROW_REL}); the wrapper's bf16 "
                  f"outputs " + ", ".join(f"{a} {b:.3g}"
                                          for a, b in r["out"].items())
                  + f" (bound {FP8_OUT_ROW_REL:.4g}); ms: bf16 matmul "
                  f"{t['bf16']:.4f} (bound {r['bf16_bound']:.4f}), fp8 GEMM "
                  f"{t['fp8_gemm']:.4f} (bound {r['fp8_bound']:.4f}), "
                  f"fp8_linear with its casts {t['fp8_linear']:.4f}, int8 "
                  f"GEMM {t['int8_gemm']:.4f}, int8_dynamic_matmul "
                  f"{t['int8_linear']:.4f} [{card}]")
        if not worst <= FP8_GEMM_ROW_REL:
            bad.append(f"fp8 GEMM {r['shape']}: worst row {worst:.3g}")
        if not worst_out <= FP8_OUT_ROW_REL:
            bad.append(f"fp8_linear {r['shape']}: worst output row "
                       f"{worst_out:.3g}")
    torch.cuda.empty_cache()
    return bad


def fp8_ranges_split(torch, fn):
    """One call of ``fn`` under the profiler with the fp8 module's casts,
    amax reductions and GEMM calls named: kernel ms by part (the fp8
    GEMMs themselves, their operands' relayout and padding, casts, amax
    reductions) and the rest by kernel class."""
    from paddle_tpu_torch.amp import fp8 as F8

    saved = {n: getattr(F8, n) for n in ("_cast_fp8", "_amax", "_mm")}

    def ranged(name, f):
        def run(*a, **k):
            with torch.profiler.record_function(f"fp8:{name}"):
                return f(*a, **k)
        return run

    for n, f in saved.items():
        setattr(F8, n, ranged(n, f))
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for n, f in saved.items():
            setattr(F8, n, f)
    allk = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("fp8:")]
    split = {}
    inside = 0.0
    for evt in prof.events():
        if not evt.name.startswith("fp8:"):
            continue
        for k, d in _range_kernels(evt):
            part = {"_cast_fp8": "fp8 casts", "_amax": "amax reductions"}.get(
                evt.name[4:], "fp8 GEMMs" if kernel_class(k) == "GEMMs"
                else "fp8 operand relayout and padding")
            split[part] = split.get(part, 0.0) + d / 1e3
            inside += d / 1e3
    for k, t in allk:
        c = kernel_class(k)
        split[c] = split.get(c, 0.0) + t
    # the ranged kernels were counted by class too: take them back out
    for k, d in ((k, d) for evt in prof.events()
                 if evt.name.startswith("fp8:") for k, d in
                 _range_kernels(evt)):
        c = kernel_class(k)
        split[c] -= d / 1e3
    return wall, {k: v for k, v in split.items() if abs(v) > 1e-6}


def fp8_history(torch, model):
    return {n: (b.data_ptr(), b.detach().clone())
            for n, b in model.named_buffers() if "amax_history" in n}


def fp8_history_failures(torch, before, after, k):
    """``k`` training forwards between two snapshots of the histories: each
    kept its address, shifted by ``k`` and recorded ``k`` amaxes > 0."""
    bad = []
    for n, (ptr, h0) in before.items():
        ptr1, h1 = after[n]
        if ptr1 != ptr:
            bad.append(f"{n} moved")
        elif not (torch.equal(h1[:-k], h0[k:]) and bool((h1[-k:] > 0).all())):
            bad.append(f"{n} did not advance by {k}: {h0[-k - 1:].tolist()}"
                       f" -> {h1[-k - 1:].tolist()}")
    if not before or set(before) != set(after):
        bad.append("the amax histories are missing or renamed")
    return bad


def fp8_train_model(torch, dev, seed, depth, fp8, sr=True):
    """The flagship at ``depth`` layers in bf16 (fp8: every Linear but the
    lm_head converted) with the bench step's AdamW, and its step."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.amp import convert_to_fp8
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    pt_seed(seed)
    cfg = LlamaConfig(**dict(LLAMA_542M, max_position_embeddings=TRAIN_SEQ,
                             num_hidden_layers=depth))
    m = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    n = convert_to_fp8(m, exclude=lambda s: "lm_head" in s) if fp8 else 0
    o = AdamW(learning_rate=TRAIN_LR, parameters=m.parameters(),
              moment_dtype="bfloat16", use_stochastic_rounding=sr,
              fused=True)
    return m, o, bench_step(m, o), n


def fp8_capture_failures(torch, dev, seed, ids, labels, depth=GRAD_DEPTH,
                         steps=TRAIN_STEPS):
    """The fp8 step captured against eager from copies of one state (SR
    off, ``depth`` layers): losses, parameters and histories bitwise, and
    the captured model's histories rolled in place by every replay.
    Returns (failures, losses)."""
    from paddle_tpu_torch import jit

    res, bad = [], []
    for captured in (True, False):
        m, o, c, _ = fp8_train_model(torch, dev, seed, depth, True, sr=False)
        h0 = fp8_history(torch, m)
        jit.enable_to_static(captured)
        try:
            first = [c(ids, labels).detach() for _ in range(2)]
            h1 = fp8_history(torch, m)
            out = c.multi_step(ids, labels, steps=steps)
        finally:
            jit.enable_to_static(True)
        h2 = fp8_history(torch, m)
        tag = "captured" if captured else "eager"
        bad += [f"{tag}: {b}" for b in fp8_history_failures(torch, h0, h1, 2)
                + fp8_history_failures(torch, h1, h2, steps)]
        if captured and len(c._graphs) != 1:
            bad.append(f"captured: {len(c._graphs)} graphs")
        res.append((torch.cat([torch.stack(first), out]).float(),
                    [p.detach().clone() for p in m.parameters()],
                    {n: h for n, (_, h) in h2.items()}))
        del m, o, c
    (lc, pc, hc), (le, pe, he) = res
    if not (torch.equal(lc, le) and all(torch.equal(a, b)
                                        for a, b in zip(pc, pe))
            and all(torch.equal(hc[n], he[n]) for n in hc)):
        bad.append(f"captured differs from eager: losses {lc.tolist()} / "
                   f"{le.tolist()}")
    torch.cuda.empty_cache()
    return bad, lc.tolist()


def fp8_train_phase(torch, np, dev, args, card, ids, labels):
    """Phase 14(b): the fp8 train step against bf16 in turns, eager and
    captured, at full width; then captured against eager bitwise at
    GRAD_DEPTH layers. Returns the failures."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.ops import kernels

    L, K = LLAMA_542M["num_hidden_layers"], TRAIN_STEPS
    bad, v = [], {}
    for name in ("bf16", "fp8"):
        m, o, c, n = fp8_train_model(torch, dev, args.seed, L, name == "fp8")
        if name == "fp8" and n != FP8_LINEARS:
            bad.append(f"{n} Linears converted, not {FP8_LINEARS}")
        v[name] = dict(model=m, opt=o, step=c, losses=[], ms={}, counts=[])
    want = {**flash_fwd_counts(L * K), **flash_bwd_counts(L * K),
            "fused_adamw": ADAMW_GROUPS * K, "paged_decode_attention": 0,
            "paged_decode_attention_int8": 0}
    torch.cuda.reset_peak_memory_stats()
    hist = fp8_history(torch, v["fp8"]["model"])
    addr = {n: p for n, (p, _) in hist.items()}
    for mode in ("eager", "captured"):
        for name in ("bf16", "fp8"):
            x = v[name]
            with static_mode(mode == "captured"):
                # eager: optimizer state, then the allocator's cache;
                # captured: the warm-up call, then the capture (and one
                # replay)
                for _ in range(2):
                    x["losses"].append(float(x["step"](ids, labels).detach()))
        h0 = fp8_history(torch, v["fp8"]["model"])
        for name in FP8_TRAIN_ORDER:
            x = v[name]
            with static_mode(mode == "captured"):
                kernels.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = x["step"].multi_step(ids, labels, steps=K)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            counts = kernels.launch_counts()
            x["ms"].setdefault(mode, []).append(dt / K * 1e3)
            x["losses"] += [float(t) for t in out.cpu()]
            if counts != want:
                bad.append(f"{name} {mode}: launch counts {counts} != {want}")
        h1 = fp8_history(torch, v["fp8"]["model"])
        bad += [f"{mode} turns: {b}" for b in fp8_history_failures(
            torch, h0, h1, K * FP8_TRAIN_ORDER.count("fp8"))]
        if mode == "eager":
            torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = [n for n, (p, _) in fp8_history(torch, v["fp8"]["model"]).items()
             if p != addr[n]]
    if moved:
        bad.append(f"histories moved across the capture: {moved[:3]}")
    if len(v["fp8"]["step"]._graphs) != 1:
        bad.append(f"fp8 step graphs {len(v['fp8']['step']._graphs)}")
    fpt = v["bf16"]["model"].flops_per_token(TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for name, x in v.items():
        ls = x["losses"]
        mfu = {mode: [round(tokens * fpt / (ms / 1e3) / BF16_FLOPS_PER_S, 4)
                      for ms in t] for mode, t in x["ms"].items()}
        print(f"phase 14(b) train Llama-542M bf16 B={TRAIN_BATCH} "
              f"S={TRAIN_SEQ}, {name} Linears (big_mfu_decomp.py's "
              f"{'fp8' if name == 'fp8' else 'adamw'} variant with the bench "
              f"step's fused AdamW), multi_step(steps={K}) in turns "
              f"{FP8_TRAIN_ORDER}: eager {[round(t, 2) for t in x['ms']['eager']]}"
              f" ms/step, captured {[round(t, 2) for t in x['ms']['captured']]}"
              f" ms/step, MFU (the bf16 step's flops_per_token {fpt:.0f} over "
              f"989 TFLOP/s) {mfu}; peak memory of both {peak_gb:.2f} GB; "
              f"losses {[round(t, 4) for t in ls]} [{card}]")
        if not (all(np.isfinite(t) for t in ls) and ls[-1] < ls[0]):
            bad.append(f"{name}: losses not finite and falling: {ls}")
    lb, lf = v["bf16"]["losses"], v["fp8"]["losses"]
    worst = max(abs(a - b) for a, b in zip(lf, lb))
    print(f"phase 14(b) fp8 losses against bf16's, step by step: worst gap "
          f"{worst:.4g} nats (bound {FP8_LOSS_ABS}); the fp8 model's "
          f"{len(hist)} amax histories kept their addresses and advanced "
          f"by one entry a training forward: {not any('advance' in b or 'moved' in b for b in bad)}")
    if not worst <= FP8_LOSS_ABS:
        bad.append(f"fp8 losses depart from bf16's by {worst:.4g}")
    def eager_fp8_step():
        with static_mode(False):
            v["fp8"]["step"](ids, labels)

    wall, split = fp8_ranges_split(torch, eager_fp8_step)
    busy = sum(split.values())
    print(f"phase 14(b) one profiled eager fp8 step: {wall:.2f} ms wall, "
          f"{busy:.2f} ms of kernels: " + ", ".join(
              f"{k} {t:.2f} ms" for k, t in sorted(split.items(),
                                                  key=lambda kv: -kv[1]))
          + f" [{card}]")
    del v
    torch.cuda.empty_cache()
    cb, lc = fp8_capture_failures(torch, dev, args.seed, ids, labels)
    print(f"phase 14(b) fp8 step captured against eager, {GRAD_DEPTH} layers "
          f"at full width, SR off, {2 + TRAIN_STEPS} steps from copies of one "
          f"state: losses, parameters and amax histories bitwise equal, "
          f"histories rolled in place by every replay: "
          f"{'yes' if not cb else '; '.join(cb)}; losses "
          f"{[round(t, 4) for t in lc]}")
    return bad + cb


def trash_write_check(torch, dev, reps=FP8_TRASH_WRITE_REPS):
    """The engine's KV write at the whole-prompt prefill's shape, with 15
    of 16 rows pointed at the trash block (every lane of theirs shares a
    cell with 63 others) and the live row running past its table: ``reps``
    writes on the card into fresh zero pools, each against the CPU's.
    Returns the number of writes whose pools differ bitwise from the
    CPU's."""
    from paddle_tpu_torch.ops.paged_attention import paged_write_kv

    cfg = LLAMA_542M
    b, s, bs = SERVE["max_batch"], SERVE["prompt_pad"], SERVE["block_size"]
    kvh = cfg["num_key_value_heads"]
    d = cfg["hidden_size"] // cfg["num_attention_heads"]
    per_seq = s // bs
    nb = per_seq + 1  # the live row's blocks, then the trash block
    gen = torch.Generator(device="cpu").manual_seed(14)
    kk, vv = (torch.randn(b, s, kvh, d, generator=gen).to(torch.bfloat16)
              for _ in range(2))
    tables = torch.full((b, per_seq), nb - 1, dtype=torch.int32)
    tables[0] = torch.arange(per_seq)
    cl = torch.zeros(b, dtype=torch.int32)
    cl[0] = bs // 2  # the live row's tail runs past its table

    def write(device):
        kp = torch.zeros(kvh, nb, bs, d, dtype=torch.bfloat16, device=device)
        vp = torch.zeros_like(kp)
        paged_write_kv(kk.to(device), vv.to(device), kp, vp,
                       tables.to(device), cl.to(device), s)
        return torch.stack([kp, vp]).cpu()

    want = write("cpu")
    return sum(not torch.equal(write(dev), want) for _ in range(reps))


def fp8_logit_check(torch, np, bf, f8, prompts):
    """Phase 4's prompts scored by both models, last position: the
    norm-relative error of the fp8 logits, argmax agreement, and the fp8
    argmax in bf16's top 5."""
    got, want = [], []
    with torch.no_grad():
        for n in PROMPT_LENS:
            ids = torch.from_numpy(np.stack(
                [p for p in prompts if p.size == n]).astype(np.int64)).to(
                bf.device)
            want.append(bf(ids)[:, -1].float())
            got.append(f8(ids)[:, -1].float())
    got, want = torch.cat(got), torch.cat(want)
    top5 = want.topk(5, dim=-1).indices
    return dict(rel=rel_err(got, want),
                argmax=float((got.argmax(-1) == want.argmax(-1)).float()
                             .mean()),
                top5=float((top5 == got.argmax(-1, keepdim=True)).any(-1)
                           .float().mean()))


def fp8_serving_phase(torch, np, dev, args, card):
    """Phase 14(c): ``ContinuousBatchingEngine(fp8=True)`` against bf16 on
    phase 4's workload (eager, captured, overlap) and phase 5b's on int8
    pools. Returns the failures."""
    import gc

    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.amp import Fp8Linear
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels

    trash_bad = trash_write_check(torch, dev)
    print(f"phase 14(c) KV write with 15 of 16 rows on the trash block, "
          f"[{SERVE['max_batch']}, {SERVE['prompt_pad']}] lanes: "
          f"{FP8_TRASH_WRITE_REPS - trash_bad} of {FP8_TRASH_WRITE_REPS} "
          f"card writes bitwise the CPU's [{card}]")
    bad = [f"{trash_bad} of {FP8_TRASH_WRITE_REPS} KV writes with shared "
           f"cells differ from the CPU's"] if trash_bad else []
    cfg = LlamaConfig(**LLAMA_542M)
    models = {}
    for name in ("bf16", "fp8"):
        pt_seed(args.seed)
        models[name] = LlamaForCausalLM(cfg, device=dev,
                                        dtype=torch.bfloat16).eval()
    L = cfg.num_hidden_layers
    prompts = serving_prompts(torch, args.seed, N_REQUESTS, cfg.vocab_size)
    runs, kept = {"bf16": [], "fp8": []}, {}
    for kind, order in FP8_SERVE_ORDER:
        for name in order:
            r = loop_run(torch, models[name], kind, prompts, L,
                         keep=kind == "captured",
                         engine_kw=dict(fp8=True) if name == "fp8" else None)
            if kind == "captured":
                kept[name] = r.pop("prefill_engine")
            runs[name].append(r)
            gc.collect()
            print(f"phase 14(c) {name} {kind} serving: {N_REQUESTS} requests "
                  f"(phase 4's workload) wall {r['wall']:.3f} s, TTFT p50 "
                  f"{r['ttft'] * 1e3:.1f} ms, {r['decode_tokens']} decode "
                  f"tokens in {r['steps']} decode steps, "
                  f"{r['counts']['paged_decode_attention']} paged-decode "
                  f"launches, graphs {r['graphs']}, fp8_layers "
                  f"{r['fp8_layers']} [{card}]")
    n_fp8 = sum(isinstance(m, Fp8Linear) for m in models["fp8"].modules())
    if runs["fp8"][0]["fp8_layers"] != FP8_LINEARS or n_fp8 != FP8_LINEARS:
        bad.append(f"fp8_layers {runs['fp8'][0]['fp8_layers']}, "
                   f"{n_fp8} Fp8Linears in the model")
    for name, rs in runs.items():
        if any(r["tokens"] != rs[0]["tokens"] for r in rs):
            diff = {r["kind"]: sum(t != rs[0]["tokens"][rid]
                                   for rid, t in r["tokens"].items())
                    for r in rs[1:]}
            bad.append(f"{name}: the eager, captured and overlap streams "
                       f"differ (requests departing from eager's: {diff})")
    agree = np.mean([a == b for rid, t in runs["fp8"][0]["tokens"].items()
                     for a, b in zip(t, runs["bf16"][0]["tokens"][rid])])
    # a replay of each captured engine's programs as its run left them:
    # the whole-prompt prefill [16, 512] and a 16-step decode chunk
    prefill_ms, decode_ms = {}, {}
    for name, eng in kept.items():
        n0 = kernels.launch_counts()
        prefill_ms[name] = time_ms(eng._prefill_fn, 5, warmup=1)
        decode_ms[name] = time_ms(eng._chunk_fn, 5, warmup=1) \
            / SERVE["decode_chunk"]
        kernels.set_launch_counts(n0)
    del kept, eng
    gc.collect()
    lg = fp8_logit_check(torch, np, models["bf16"], models["fp8"], prompts)
    print(f"phase 14(c) fp8 against bf16 serving, phase 4's workload: fp8 "
          f"streams bitwise equal across eager, captured and overlap: "
          f"{not any('fp8: the' in b for b in bad)}; greedy tokens agree "
          f"with bf16's on {agree:.4f} of positions (reported); last "
          f"prefill logit rel err {lg['rel']:.4g} (bound {FP8_LOGIT_REL}), "
          f"argmax agreement {lg['argmax']:.4f} (min {FP8_ARGMAX_MIN}), "
          f"fp8 argmax in bf16's top 5 {lg['top5']:.4f}; whole-prompt "
          f"prefill replay [16, 512] bf16 {prefill_ms['bf16']:.3f} / fp8 "
          f"{prefill_ms['fp8']:.3f} ms, a decode step in a replayed "
          f"{SERVE['decode_chunk']}-step chunk bf16 {decode_ms['bf16']:.3f} / "
          f"fp8 {decode_ms['fp8']:.3f} ms (CUDA events) [{card}]")
    if not (lg["rel"] <= FP8_LOGIT_REL and lg["argmax"] >= FP8_ARGMAX_MIN):
        bad.append(f"fp8 last prefill logits: rel err {lg['rel']:.4g}, "
                   f"argmax agreement {lg['argmax']:.4f}")
    # phase 5b's chunked shared-prefix workload on int8 pools
    _, work = prefix_work(np, cfg.vocab_size, PREFIX_FAMILIES,
                          PREFIX_REQUESTS, PREFIX_REPEATS,
                          PREFIX_SERVE["max_batch"])
    for name in ("bf16", "fp8"):
        r = chunked_run(torch, np, models[name], "overlap", "int8", work, L,
                        dict(fp8=True) if name == "fp8" else None,
                        label=f"phase 14(c) {name}")
        show_prefill_run(f"phase 14(c) {name} overlap chunked serving, int8 "
                         f"pools (phase 5b's workload)", r, card)
        del r
        gc.collect()
    del models
    gc.collect()
    torch.cuda.empty_cache()
    return bad


def wo_convert(torch, model, kind):
    from paddle_tpu_torch import quantization as QZ
    from paddle_tpu_torch.nn import quant as Q

    if kind == "llm.int8":
        qat = QZ.QAT(QZ.QuantConfig(activation=None, weight=None))
        model = qat.convert(qat.quantize(model), execute_dtype="int8")
        return model, sum(isinstance(m, QZ.Int8InferenceLinear)
                          for m in model.modules())
    return model, Q.convert_to_weight_only(model, weight_dtype=kind)


def lowp_generate_failures(torch, np, dev, args, card,
                           kinds=("int8", "int4", "llm.int8")):
    """Phase 14(d): ``generate`` (paged, captured) over Llama-542M
    converted each of ``kinds`` ways, against the bf16 model. Returns the
    failures."""
    import gc

    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, generate
    from paddle_tpu_torch.ops import kernels

    cfg = LlamaConfig(**LLAMA_542M)
    L = cfg.num_hidden_layers
    ids = torch.from_numpy(np.random.RandomState(args.seed + 14).randint(
        0, cfg.vocab_size, (LOWP_GEN_B, LOWP_GEN_PROMPT))).to(dev)
    bad, ref = [], None
    for kind in ("bf16",) + tuple(kinds):
        pt_seed(args.seed)
        m = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16).eval()
        n = 0
        if kind != "bf16":
            m, n = wo_convert(torch, m, kind)
        with torch.no_grad():
            last = m(ids)[:, -1].float()
            for _ in range(2):  # eager, then captured
                generate(m, ids, max_new_tokens=LOWP_GEN_NEW, block_size=64)
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generate(m, ids, max_new_tokens=LOWP_GEN_NEW, block_size=64)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = kernels.launch_counts()["paged_decode_attention"]
        if ref is None:
            ref = (last, out)
            e, agree = 0.0, 1.0
        else:
            e = rel_err(last, ref[0])
            new = slice(LOWP_GEN_PROMPT, None)
            agree = float((out[:, new] == ref[1][:, new]).float().mean())
        print(f"phase 14(d) generate {kind} (paged, B={LOWP_GEN_B}, prompt "
              f"{LOWP_GEN_PROMPT}, +{LOWP_GEN_NEW}, captured) Llama-542M"
              f"{f' with {n} converted Linears' if n else ''}: last-logit "
              f"rel err against bf16 {e:.4g}"
              f"{f' (bound {WO_LOGIT_REL[kind]})' if kind in WO_LOGIT_REL else ''}"
              f", tokens agree with bf16's on {agree:.4f}; {wall * 1e3:.1f} "
              f"ms a call = {wall * 1e3 / LOWP_GEN_NEW:.3f} ms a generated "
              f"token (the prefill included), paged-decode launches "
              f"{launches} (want {L * (LOWP_GEN_NEW - 1)}) [{card}]")
        # every Linear, the lm_head too, as the reference's tests convert
        if kind != "bf16" and (n != FP8_LINEARS + 1 or
                               not e <= WO_LOGIT_REL[kind]):
            bad.append(f"{kind}: {n} Linears converted, last-logit rel err "
                       f"{e:.4g}")
        if launches != L * (LOWP_GEN_NEW - 1):
            bad.append(f"{kind}: {launches} paged-decode launches")
        del m
        gc.collect()
        torch.cuda.empty_cache()
    return bad


def lowp_phase(torch, np, dev, args, card, ids, labels):
    """Phase 14: the low-precision GEMMs. (a) fp8 and int8 GEMMs alone, (b)
    the fp8 train step, (c) fp8 serving, (d) weight-only and llm.int8
    generate."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 14)
    bad = fp8_gemm_failures(torch, dev, gen, card)
    casts = cast_bitwise(torch, dev)
    int8 = [int8_bitwise_case(torch, dev, gen, *s) for s in LOWP_INT8_SHAPES]
    print(f"phase 14(a) e4m3/e5m2 casts of {LOWP_CAST_N} values, card against "
          f"CPU, bitwise: {json.dumps(casts)}; int8_dynamic_matmul card "
          f"against CPU bitwise (weight image and scales, int32 product): "
          + ", ".join(f"{r['shape']} {r['weight']}/{r['product']}"
                      for r in int8))
    bad += [f"cast {k} differs from the CPU's" for k, ok in casts.items()
            if not ok]
    bad += [f"int8 {r['shape']} differs from the CPU's" for r in int8
            if not (r["weight"] and r["product"])]
    t1 = time.perf_counter()
    bad += fp8_train_phase(torch, np, dev, args, card, ids, labels)
    t2 = time.perf_counter()
    bad += fp8_serving_phase(torch, np, dev, args, card)
    t3 = time.perf_counter()
    bad += lowp_generate_failures(torch, np, dev, args, card)
    t4 = time.perf_counter()
    print(f"phase 14 {t4 - t0:.1f} s: (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, "
          f"(c) {t3 - t2:.1f}, (d) {t4 - t3:.1f}")
    if bad:
        fail("phase 14: " + "; ".join(b[:300] for b in bad))


# -- phase 15: an autoscaled fleet ---------------------------------------------
# benchmarks/loadgen.py:499-700 (autoscale_smoke) on the port: an open-loop
# trace over a 1..3-replica ClusterRouter grown by a FleetAutoscaler under a
# TTFT burn-rate rule and the trace's own envelope as feed-forward, then a
# drain whose first victim is killed mid-drain. The schedule generator and
# its driver are copies of loadgen.py's (TraceSpec :70-93, generate_schedule
# :118, schedule_json, feedforward_from_spec :178; RouterFront and
# run_schedule :226-320), so this script imports nothing from benchmarks/;
# tests/test_torch_slo.py holds the copy byte-equal to loadgen's.


@dataclasses.dataclass
class TraceSpec:
    """The seeded workload shape (loadgen's)."""

    seed: int = 0
    n_requests: int = 48
    duration_s: float = 8.0
    burst_factor: float = 3.0
    burst_frac: float = 0.15
    diurnal_amp: float = 0.5
    tenants: int = 3
    zipf_s: float = 1.2
    batch_frac: float = 0.25
    prompt_len_median: float = 10.0
    prompt_len_sigma: float = 0.5
    prompt_len_max: int = 24
    output_len_median: float = 6.0
    output_len_sigma: float = 0.5
    output_len_max: int = 12

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _zipf_cdf(n: int, s: float):
    w = [1.0 / (k + 1) ** s for k in range(n)]
    tot = sum(w)
    acc, out = 0.0, []
    for x in w:
        acc += x / tot
        out.append(acc)
    return out


def _burst_windows(rng, spec: TraceSpec):
    """Seeded burst episodes covering ~burst_frac of the horizon."""
    windows = []
    covered, target = 0.0, spec.burst_frac * spec.duration_s
    while covered < target:
        width = rng.uniform(0.03, 0.10) * spec.duration_s
        start = rng.uniform(0.0, spec.duration_s - width)
        windows.append((start, start + width))
        covered += width
    return windows


def generate_schedule(spec: TraceSpec):
    """The open-loop arrival trace: Poisson arrivals thinned against a
    diurnal x burst rate envelope, lognormal lengths, a zipf tenant mix,
    all from one ``random.Random(seed)``."""
    if not 0.0 <= spec.diurnal_amp < 1.0:
        raise ValueError("diurnal_amp must be in [0, 1)")
    rng = random.Random(spec.seed)
    bursts = _burst_windows(rng, spec)
    cdf = _zipf_cdf(spec.tenants, spec.zipf_s)
    base_rate = spec.n_requests / spec.duration_s
    rate_max = base_rate * (1.0 + spec.diurnal_amp) * spec.burst_factor

    def rate(t: float) -> float:
        r = base_rate * (1.0 + spec.diurnal_amp
                         * math.sin(2.0 * math.pi * t / spec.duration_s))
        if any(a <= (t % spec.duration_s) < b for a, b in bursts):
            r *= spec.burst_factor
        return r

    def _length(median: float, sigma: float, cap: int) -> int:
        v = rng.lognormvariate(math.log(median), sigma)
        return max(1, min(int(cap), int(round(v))))

    out = []
    t = 0.0
    while len(out) < spec.n_requests:
        t += rng.expovariate(rate_max)
        if rng.random() * rate_max > rate(t):
            continue
        u = rng.random()
        tenant = next(k for k, c in enumerate(cdf) if u <= c)
        out.append({
            "i": len(out),
            "req_id": f"lg-{spec.seed}-{len(out):04d}",
            "t": round(t, 6),
            "tenant": f"tenant{tenant}",
            "priority": ("batch" if rng.random() < spec.batch_frac
                         else "interactive"),
            "prompt_len": _length(spec.prompt_len_median,
                                  spec.prompt_len_sigma,
                                  spec.prompt_len_max),
            "max_new_tokens": _length(spec.output_len_median,
                                      spec.output_len_sigma,
                                      spec.output_len_max),
            "prompt_seed": rng.getrandbits(32),
        })
    return out


def schedule_json(spec: TraceSpec, schedule) -> str:
    """Canonical bytes of the schedule (loadgen's schema name)."""
    return json.dumps({"schema": "paddle_tpu.loadgen/1",
                       "spec": spec.to_dict(), "schedule": schedule},
                      sort_keys=True, indent=2)


def feedforward_from_spec(spec: TraceSpec):
    """The trace's rate envelope, ``t -> expected-rate multiple``, from the
    same seeded burst windows as the schedule."""
    rng = random.Random(spec.seed)
    bursts = _burst_windows(rng, spec)

    def multiple(t: float) -> float:
        m = 1.0 + spec.diurnal_amp * math.sin(
            2.0 * math.pi * t / spec.duration_s)
        if any(a <= (t % spec.duration_s) < b for a, b in bursts):
            m *= spec.burst_factor
        return m

    return multiple


class RouterFront:
    """Drive a ``ClusterRouter``; per-token times come from the replicas'
    supervisors, status alone from the router's result records."""

    def __init__(self, router):
        self.router = router
        self.results = {}

    def submit(self, item: dict, prompt) -> None:
        self.router.submit(
            item["req_id"], prompt, item["max_new_tokens"],
            priority=item["priority"], tenant=item["tenant"])

    def pump(self) -> None:
        for d in self.router.step():
            self.results[d["req_id"]] = d

    def unfinished(self, ids) -> int:
        return sum(1 for r in ids if r not in self.results)

    def harvest(self, ids):
        by_id = {}
        for w in self.router.replicas:
            sup = getattr(w, "supervisor", None)
            if sup is not None:
                by_id.update(sup.results)
        out = []
        for rid in ids:
            if rid in by_id:
                out.append(by_id[rid])
            elif rid in self.results:
                d = dict(self.results[rid])
                d.setdefault("times", [])
                out.append(d)
            else:
                out.append(None)
        return out


def schedule_prompts(np, schedule, vocab_size):
    """Each entry's prompt, from its own seed (loadgen's draw)."""
    return {item["req_id"]: np.random.RandomState(
        item["prompt_seed"] % (2 ** 32)).randint(
            0, vocab_size, (item["prompt_len"],)).astype(np.int32)
        for item in schedule}


def run_schedule(front, schedule, prompts, on_tick, drain_s):
    """Submit every entry at its arrival instant, pumping (and calling
    ``on_tick``) between arrivals and never gating a submission on
    completions; then drain (at most ``drain_s``). Returns
    ``(records, wall_s)``."""
    ids = [item["req_id"] for item in schedule]
    t0 = time.perf_counter()
    for item in schedule:
        due = t0 + item["t"]
        while time.perf_counter() < due:
            front.pump()
            on_tick()
        front.submit(item, prompts[item["req_id"]])
    t_drain = time.perf_counter()
    while front.unfinished(ids):
        if time.perf_counter() - t_drain > drain_s:
            break
        front.pump()
        on_tick()
    wall = time.perf_counter() - t0
    return front.harvest(ids), wall


def autoscale_trace_kwargs(seed: int) -> dict:
    """loadgen's autoscale trace (60 requests over 10 s, 3 tenants, 4x
    bursts over a fifth of the horizon) with its lengths scaled to the
    shared-prefix cell: prompts median 256 (max 512), outputs median 24
    (max 48)."""
    return dict(seed=seed, n_requests=60, duration_s=10.0, tenants=3,
                burst_factor=4.0, burst_frac=0.2,
                prompt_len_median=256.0, prompt_len_sigma=0.5,
                prompt_len_max=512, output_len_median=24.0,
                output_len_sigma=0.5, output_len_max=48)


# loadgen.py:636-645 (its time_scale 1)
AUTOSCALE_CFG = dict(min_replicas=1, max_replicas=3, scale_up_cooldown_s=0.75,
                     scale_down_cooldown_s=1.0, recover_budget_frac=0.2,
                     recover_hold_s=0.75, spawn_backoff_s=0.25,
                     drain_timeout_s=8.0, feedforward_headroom=0.3,
                     evaluate_interval_s=0.2)
# the controller's TTFT burn rule (loadgen.py:610-614: objective 0.5, one
# 2 s window) at a target below any TTFT the card reaches, an exact bucket
# bound: every first token counts against the budget, so the rule fires
# whenever first tokens arrive, whatever their times (a chunked [8, 256]
# prefill alone takes ~14 ms); 15(b) swaps in a target no TTFT reaches
AUTOSCALE_FORCED_S = 2.0 ** -10
AUTOSCALE_QUIET_S = 2.0 ** 6
AUTOSCALE_DRAIN_S = 120.0  # bound on every wait of the phase
AUTOSCALE_BACKLOG = 4  # 15(b): session-pinned requests per live replica
AUTOSCALE_BACKLOG_NEW = 32
AUTOSCALE_STEPS = 16  # 15(b): bound on the autoscaler steps of each wait
PROGRAM_KINDS = ("prefill", "decode", "decode_chunk", "spec_verify")


def engine_accounting(kernels, acc):
    """Wrap an engine's ``step`` so that its launches and decode steps are
    added to ``acc[engine id]`` (the launches a step's dispatches count,
    captured replays included); the wrapper keeps no reference to
    anything but the engine itself."""

    def wrap(eng):
        step, key = eng.step, eng._obs_id
        acc[key] = {"launches": {}, "decode_steps": 0}

        def counted(*a, **k):
            c0, s0 = kernels.launch_counts(), eng.decode_steps
            try:
                return step(*a, **k)
            finally:
                rec = acc[key]
                for n, d in kernels.count_delta(
                        c0, kernels.launch_counts()).items():
                    rec["launches"][n] = rec["launches"].get(n, 0) + d
                rec["decode_steps"] += eng.decode_steps - s0

        eng.step = counted
        return eng

    return wrap


def per_engine_launch_failures(acc, per_step):
    """Each engine's float paged-decode launches against ``per_step`` x its
    decode steps, and no int8 launch (bf16 pools)."""
    bad = []
    for key, rec in sorted(acc.items()):
        got = rec["launches"].get("paged_decode_attention", 0)
        stray = rec["launches"].get("paged_decode_attention_int8", 0)
        if got != per_step * rec["decode_steps"] or stray:
            bad.append(f"{key}: {got} paged-decode launches for "
                       f"{rec['decode_steps']} decode steps x {per_step}, "
                       f"{stray} int8 launches")
    return bad


def capture_failures(obs, eng, per_kind):
    """None when every program of ``eng`` was captured at most once, its
    ``graph_captures_total`` (capture events named ``<engine id>:<program>``)
    equals the graphs it holds, and a warmed-up engine holds ``per_kind``
    graphs per kind of program it dispatched; else what it shows.
    Also returns ``(captures, graphs, kinds)`` summed over the programs."""
    m = obs.registry()._metrics.get("graph_captures_total")
    by_program = {} if m is None else {
        dict(labels).get("program"): int(h.value)
        for labels, h in m.series.items()}
    fns = (eng._prefill_fn, eng._decode_fn, eng._chunk_fn, eng._verify_fn)
    got = [(by_program.get(fn.name, 0), len(fn._graphs)) for fn in fns]
    captures = sum(c for c, _ in got)
    graphs = sum(g for _, g in got)
    kinds = len(eng._phases_run & set(PROGRAM_KINDS))
    bad = any(c != g or g > 1 for c, g in got) or (
        eng.warmed_up and graphs != per_kind * kinds)
    err = (f"{eng._obs_id}: captures/graphs per program {got}, {kinds} "
           f"program kinds run, warmed_up {eng.warmed_up}") if bad else None
    return err, (captures, graphs, kinds)


def fleet_oracle(np, model, engine_kw, reqs, prompts):
    """Every request's stream from one unloaded engine of the same shape
    (warmed as the replicas are: its programs captured)."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine

    ref = ContinuousBatchingEngine(model, **engine_kw)
    warm_engine(np, ref)
    if ref.prefix_cache is not None:
        ref.prefix_cache.clear()
    for rid, n in reqs:
        ref.add_request(rid, prompts[rid], max_new_tokens=n)
    done = ref.run()
    out = {rid: list(done[rid].out) for rid, _ in reqs}
    del ref, done
    return out


CAPACITY_ORDER = (1, 3, 3, 1)  # 15(c): fixed fleets, in turns


def fleet_capacity(np, model, engine_kw, schedule, prompts, want, card, sync):
    """15(c): the trace's requests all submitted at once into fixed fleets of
    1 and of 3 replicas (each engine warmed first), in CAPACITY_ORDER's
    turns: wall to drain, decode tokens per wall second, TTFT p50/max.
    Returns the failures (a request not ok, a stream other than the
    unloaded engine's); the times are reported, not gated."""
    import gc

    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.cluster import (ClusterRouter,
                                                    InProcessReplica)

    failures, rows = [], []
    for n in CAPACITY_ORDER:
        reps = [InProcessReplica(
            f"cap{n}-{i}", lambda: ContinuousBatchingEngine(model,
                                                            **engine_kw))
            for i in range(n)]
        for rep in reps:
            warm_engine(np, rep.supervisor.engine)
        router = ClusterRouter(reps, block_size=engine_kw["block_size"])
        sync()
        t0 = time.perf_counter()
        for item in schedule:
            router.submit(item["req_id"], prompts[item["req_id"]],
                          item["max_new_tokens"], priority=item["priority"],
                          tenant=item["tenant"])
        res = router.run(deadline=AUTOSCALE_DRAIN_S)
        sync()
        wall = time.perf_counter() - t0
        reqs = [r for rep in reps for r in rep.supervisor.results.values()
                if not isinstance(r.req_id, tuple)]
        bad = [item["req_id"] for item in schedule
               if res.get(item["req_id"], {}).get("status") != "ok"
               or list(res[item["req_id"]]["out"]) != want[item["req_id"]]]
        if bad:
            failures.append(f"15(c) {n} replicas: {len(bad)} requests not ok "
                            f"or not the unloaded engine's: {bad[:6]}")
        ttfts = sorted(r.ttft() for r in reqs if r.times)
        rows.append((n, wall, sum(len(r.out) - 1 for r in reqs) / wall,
                     ttfts[len(ttfts) // 2], ttfts[-1]))
        router.stop()
        del reps, router, reqs, res
        gc.collect()
    print(f"phase 15(c) capacity, the trace's {len(schedule)} requests at "
          f"once into a fixed fleet, in turns: " + "; ".join(
              f"{n} replica{'s' if n > 1 else ''} wall {w:.3f} s, "
              f"{tps:.1f} decode tokens/s, TTFT p50/max {p50 * 1e3:.1f}/"
              f"{pmax * 1e3:.1f} ms" for n, w, tps, p50, pmax in rows)
          + f" [{card}]")
    return failures


def submit_backlog(router, live, prompts, between=None):
    """15(b)'s backlog: session ``drain-s<n>`` (requests ``drain-<n>-<j>``
    of ``prompts``) on live replica ``live[n]``. Each session is pinned to
    its replica through the router's session affinity before its first
    request, and the affinity outweighs any load while the backlog goes in:
    the replicas' loads (``est_queue_delay_s`` grows with each replica's
    measured step time) would otherwise move a session's later requests,
    and with them the session, to an idle replica. ``between(idx)`` runs
    after each request (the CPU test moves the load there). Returns the
    request ids in submission order."""
    ids = []
    weight = router.session_weight
    for n, idx in enumerate(live):
        router._sessions[f"drain-s{n}"] = idx
    router.session_weight = float("inf")
    try:
        for n, idx in enumerate(live):
            for j in range(AUTOSCALE_BACKLOG):
                rid = f"drain-{n}-{j}"
                router.submit(rid, prompts[rid],
                              max_new_tokens=AUTOSCALE_BACKLOG_NEW,
                              session=f"drain-s{n}")
                ids.append(rid)
                if between is not None:
                    between(idx)
    finally:
        router.session_weight = weight
    return ids


def autoscale_phase(torch, np, dev, args, card, trace_kw=None,
                    capacity=True):
    """Phase 15: loadgen's autoscale scenario on the port at full width
    (``trace_kw`` shortens the trace).

    (a) An open-loop trace over a ``ClusterRouter`` that starts with one
    ``InProcessReplica`` (journaled, the shared-prefix cell's engine), a
    ``FleetAutoscaler`` ticked beside every pump, its ``AlertManager`` (the
    process default, so ``router.health()`` shows it) holding a TTFT burn
    rule that every first token breaches; capture events installed and the
    lock sanitizer on. (b) A session-pinned backlog on every live replica, a
    rule that cannot fire, the autoscaler stepped on an explicit clock until
    a drain starts; chaos kills the first victim mid-drain; the router's
    recovery finishes its accepted work; the autoscaler retires the fleet
    down to one replica, whose retired and killed engines are then freed.
    Every gate is an outcome the forced and quiet thresholds fix; times are
    reported, never gated. (c), unless ``capacity`` is false: the trace's
    requests at once into fixed fleets (``fleet_capacity``). Returns the
    launch counts of (a)."""
    import gc
    import os
    import shutil
    import tempfile
    import weakref
    from collections import Counter

    from paddle_tpu_torch import obs
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.autoscale import (AutoscalerConfig,
                                                      FleetAutoscaler)
    from paddle_tpu_torch.inference.cluster import (ClusterRouter,
                                                    InProcessReplica)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.obs import alerts, slo
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.testing import chaos
    from paddle_tpu_torch.utils import locks

    cuda = dev.type == "cuda"
    # what the gates expect a step and a program kind to leave: on the CPU
    # the wrappers run their plain versions (no launch) and nothing is
    # captured
    per_kind = 1 if cuda else 0
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    engine_kw = dict(PREFIX_SERVE)
    spec = TraceSpec(**(trace_kw or autoscale_trace_kwargs(args.seed)))
    schedule = generate_schedule(spec)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
    t_phase = time.perf_counter()
    locks.reset()
    locks.instrument_locks()  # before any lock of the fleet is made
    obs.install_compile_events()
    old_manager = alerts.set_default_manager(None)
    journals = tempfile.mkdtemp(prefix="chip-smoke-ascale-")
    try:
        pt_seed(args.seed)
        cfg = LlamaConfig(**LLAMA_542M)
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
        model.eval()
        per_step = per_kind * cfg.num_hidden_layers  # paged-decode launches
        prompts = schedule_prompts(np, schedule, cfg.vocab_size)
        acc = {}
        account = engine_accounting(kernels, acc)
        engines = {}  # engine id -> weak reference
        replica_engine = {}  # replica id -> engine id

        def make_engine():
            eng = account(ContinuousBatchingEngine(model, **engine_kw))
            engines[eng._obs_id] = weakref.ref(eng)
            return eng

        def replica_factory(rid):
            rep = InProcessReplica(rid, make_engine,
                                   journal_dir=os.path.join(journals, rid))
            replica_engine[rid] = rep.supervisor.engine._obs_id
            return rep

        # the seed replica, warmed outside the counted run as phase 5b's
        seed_rep = replica_factory("seed0")
        warm_engine(np, seed_rep.supervisor.engine)
        seed_rep.supervisor.engine.prefix_cache.clear()
        for rec in acc.values():  # the warm-up is not the counted run
            rec["launches"].clear()
            rec["decode_steps"] = 0
        router = ClusterRouter([seed_rep], block_size=engine_kw["block_size"])
        front = RouterFront(router)
        mgr = alerts.AlertManager([alerts.BurnRateRule(
            "ttft_burn_fast", "serving_ttft_seconds", objective=0.5,
            threshold_s=AUTOSCALE_FORCED_S, windows=((2.0, 1.0),),
            resolve_for_s=0.25)], emit_trace=False)
        alerts.set_default_manager(mgr)
        envelope = feedforward_from_spec(spec)
        t0_cell = [None]

        def feedforward(now):
            if t0_cell[0] is None:
                return 1.0
            t = now - t0_cell[0]
            return 1.0 if t >= spec.duration_s else envelope(t)

        scaler = FleetAutoscaler(router, replica_factory,
                                 config=AutoscalerConfig(**AUTOSCALE_CFG),
                                 alerts=mgr, feedforward=feedforward,
                                 clock=time.perf_counter)
        peak, firing_seen, last_tick = [1], [0], [0.0]

        def on_tick():
            now = time.perf_counter()
            if now - last_tick[0] < 0.05:
                return
            last_tick[0] = now
            rec = scaler.step(now)
            peak[0] = max(peak[0], int(rec["live"]))
            firing_seen[0] = max(firing_seen[0],
                                 router.health()["alerts"]["firing"])

        # -- 15(a) --------------------------------------------------------------
        kernels.reset_launch_counts()
        t0_cell[0] = time.perf_counter()
        recs, wall = run_schedule(front, schedule, prompts, on_tick,
                                  AUTOSCALE_DRAIN_S)
        sync()
        t0_cell[0] = None
        counts_a = kernels.launch_counts()
        failures = []
        ids = [item["req_id"] for item in schedule]
        status = {rid: front.results.get(rid, {}).get("status", "lost")
                  for rid in ids}
        if any(s != "ok" for s in status.values()):
            failures.append(f"not every request ended ok: "
                            f"{dict(Counter(status.values()))}")
        if peak[0] != AUTOSCALE_CFG["max_replicas"]:
            failures.append(f"the fleet peaked at {peak[0]} live replicas, "
                            f"not {AUTOSCALE_CFG['max_replicas']}")
        if firing_seen[0] < 1:
            failures.append("router.health() never showed the burn rule "
                            "firing")
        launch_bad = per_engine_launch_failures(acc, per_step)
        total_pd = sum(r["launches"].get("paged_decode_attention", 0)
                       for r in acc.values())
        if counts_a.get("paged_decode_attention", 0) != total_pd:
            launch_bad.append(
                f"{counts_a.get('paged_decode_attention', 0)} paged-decode "
                f"launches in all, {total_pd} inside the engines' steps")
        failures += launch_bad
        live_engines = [rep.supervisor.engine for i, rep in
                        enumerate(router.replicas) if i not in router.dead]
        caps = {}
        for e in live_engines:
            err, caps[e._obs_id] = capture_failures(obs, e, per_kind)
            if err:
                failures.append(err)
        seed_caps = caps[replica_engine["seed0"]]
        if seed_caps[1] != 2 * per_kind:
            failures.append(f"the warmed seed replica holds {seed_caps[1]} "
                            f"graphs, not one prefill and one decode")
        del live_engines, e
        ok_ids = [rid for rid in ids if status[rid] == "ok"]
        streams = {rid: list(front.results[rid]["out"]) for rid in ok_ids}
        want = fleet_oracle(np, model, engine_kw,
                            [(item["req_id"], item["max_new_tokens"])
                             for item in schedule], prompts)
        differ = [rid for rid in ok_ids if streams[rid] != want[rid]]
        if differ:
            failures.append(f"{len(differ)} of {len(ok_ids)} ok streams "
                            f"differ from the unloaded engine's: {differ[:6]}")
        if locks.violation_count():
            failures.append(f"{locks.violation_count()} lock-order "
                            f"violations")
        graded = [r if r is not None else
                  {"req_id": item["req_id"], "tenant": item["tenant"],
                   "priority": item["priority"], "status": "lost",
                   "t_submit": 0.0, "times": [], "out": []}
                  for r, item in zip(recs, schedule)]
        report = slo.attainment_report(
            graded, slo.SLOSpec(default=slo.SLOClass(
                ttft_s=8.0, itl_p95_s=2.0, e2e_s=20.0),
                per_priority={"batch": slo.SLOClass(ttft_s=15.0,
                                                    e2e_s=30.0)}),
            wall, extra={"trace_spec": spec.to_dict()})
        ov = report["overall"]
        # (each spawn leaves its own record, with the replica, beside the
        # step's summary record)
        spawns = [d for d in scaler.decisions
                  if d["action"] == "scale-up" and "replica" in d]
        capture_s = obs.registry()._metrics.get("graph_capture_seconds")
        firsts = {}
        for d in spawns:
            rep = router.replicas[d["index"]]
            t_first = [r.times[0] for r in rep.supervisor.results.values()
                       if r.times]
            eid = replica_engine[d["replica"]]
            cap_s = sum(
                h.sum for labels, h in
                (capture_s.series.items() if capture_s else ())
                if dict(labels)["program"].startswith(f"{eid}:"))
            firsts[d["replica"]] = (
                (min(t_first) - d["t"]) if t_first else None, cap_s,
                d["reason"])
        actions = {}
        for d in scaler.decisions:
            if "live" not in d:  # the actions' own records
                actions[d["action"]] = actions.get(d["action"], 0) + 1
        print(f"phase 15(a) autoscaled fleet, Llama-542M bf16, "
              f"{spec.n_requests} requests over {spec.duration_s:g} s "
              f"(loadgen's autoscale trace, seed {spec.seed}; prompts median "
              f"{spec.prompt_len_median:g} max {spec.prompt_len_max}, outputs "
              f"median {spec.output_len_median:g} max {spec.output_len_max}), "
              f"the shared-prefix cell's engine per replica: wall "
              f"{wall:.3f} s, statuses {ov['statuses']}, peak "
              f"{peak[0]} live replicas, decisions {actions}, replica-seconds "
              f"{scaler.replica_seconds:.3f}, TTFT p50/p99 "
              f"{ov['ttft']['p50']}/{ov['ttft']['p99']} s, burn rule firing "
              f"seen in router.health() {firing_seen[0]}, lock-order "
              f"violations {locks.violation_count()} [{card}]")
        for rid, (first, cap_s, reason) in firsts.items():
            print(f"phase 15(a) spawn {rid} ({reason}): first token "
                  + (f"{first * 1e3:.1f} ms" if first is not None else "none")
                  + f" after the spawn decision, its captures "
                  f"{cap_s * 1e3:.1f} ms [{card}]")
        print(f"phase 15(a) per engine: " + ", ".join(
            f"{k} {r['decode_steps']} decode steps "
            f"{r['launches'].get('paged_decode_attention', 0)} paged-decode "
            f"launches" for k, r in sorted(acc.items()))
              + f"; captures/graphs/program kinds {caps}; counts "
              f"{json.dumps(counts_a)}; {len(ok_ids)} ok streams bitwise "
              f"the unloaded engine's: {not differ}")
        print("phase 15(a) SLO report (obs.slo.attainment_report), overall: "
              + json.dumps({k: ov[k] for k in (
                  "requests", "statuses", "ttft", "itl_p95", "e2e",
                  "attainment", "goodput_tokens_per_s")}, sort_keys=True)
              + "; tenants: " + json.dumps(
                  {t: {"requests": row["requests"],
                       "ttft_p99": row["ttft"]["p99"],
                       "attainment_all": row["attainment"]["all"]}
                   for t, row in report["tenants"].items()}, sort_keys=True))
        if failures:
            fail("phase 15(a): " + "; ".join(failures)
                 + f"; decisions {scaler.decisions}")

        # -- 15(b) --------------------------------------------------------------
        mgr_b = alerts.AlertManager([alerts.BurnRateRule(
            "ttft_burn_fast", "serving_ttft_seconds", objective=0.5,
            threshold_s=AUTOSCALE_QUIET_S, windows=((2.0, 1.0),),
            resolve_for_s=0.25)], emit_trace=False)
        alerts.set_default_manager(mgr_b)
        scaler.alerts = mgr_b
        rng = np.random.RandomState(args.seed + 15)
        live = [i for i in range(len(router.replicas)) if i not in router.dead]
        for i in live:
            # the idle replicas' cached prefixes pin blocks, which the
            # router reads as load: drop them, so that each new session
            # goes to a replica no other session holds
            cache = router.replicas[i].supervisor.engine.prefix_cache
            if cache is not None:
                cache.clear()
        del cache
        prompts_b = {
            f"drain-{n}-{j}": rng.randint(0, cfg.vocab_size, (schedule[
                (n * AUTOSCALE_BACKLOG + j) % len(schedule)]["prompt_len"],)
            ).astype(np.int32)
            for n in range(len(live)) for j in range(AUTOSCALE_BACKLOG)}
        backlog = submit_backlog(router, live, prompts_b)
        placed = sorted({router._sessions[f"drain-s{n}"]
                         for n in range(len(live))})
        failures = []
        if placed != live:
            failures.append(f"the sessions landed on {placed}, not on every "
                            f"live replica {live}")
        for i in live:
            acc[router.replicas[i].supervisor.engine._obs_id] = {
                "launches": {}, "decode_steps": 0}
        chaos.install(chaos.ChaosSchedule(seed=args.seed)
                      .at("scale.drain", 1, "drop"))
        try:
            kernels.reset_launch_counts()
            t = time.perf_counter()
            victim = held = None
            for _ in range(AUTOSCALE_STEPS):
                t += 1.0
                rec = scaler.step(t)
                if rec["action"] == "drain-start":
                    victim = scaler.decisions[-2]["index"]  # its own record
                    held = router.inflight_on(victim)
                    break
            if victim is None:
                fail(f"phase 15(b): no drain started within "
                     f"{AUTOSCALE_STEPS} steps; decisions {scaler.decisions}")
            killed = not router.replicas[victim].alive()
            victim_rid = router.replicas[victim].replica_id
            res = router.run(deadline=AUTOSCALE_DRAIN_S)
            t += 1.0
            scaler.step(t)
            retire_steps = 0
            while len(scaler._live_idxs()) > AUTOSCALE_CFG["min_replicas"] \
                    or scaler._draining:
                if retire_steps >= AUTOSCALE_STEPS:
                    break
                router.step()
                t += 1.0
                scaler.step(t)
                retire_steps += 1
            sync()
        finally:
            chaos.uninstall()
        counts_b = kernels.launch_counts()
        acts = [d["action"] for d in scaler.decisions]
        if not killed or held is None or held < 1:
            failures.append(f"the drain victim {victim} was "
                            f"{'killed' if killed else 'not killed'} holding "
                            f"{held} accepted unfinished requests")
        st_b = {rid: res.get(rid, {}).get("status", "lost")
                for rid in backlog}
        if any(s != "ok" for s in st_b.values()):
            failures.append(f"backlog statuses {st_b}")
        if router.n_recoveries != 1 or router.poisoned_ids:
            failures.append(f"recoveries {router.n_recoveries}, poisoned "
                            f"{router.poisoned_ids}")
        if "drain-died" not in acts:
            failures.append("no drain-died decision")
        live_end = scaler._live_idxs()
        if len(live_end) != AUTOSCALE_CFG["min_replicas"] or scaler._draining:
            failures.append(f"{len(live_end)} live replicas and drains "
                            f"{sorted(scaler._draining)} after "
                            f"{retire_steps} steps")
        streams_b = {rid: list(res[rid]["out"]) for rid in backlog
                     if st_b[rid] == "ok"}
        want_b = fleet_oracle(np, model, engine_kw,
                              [(rid, AUTOSCALE_BACKLOG_NEW)
                               for rid in streams_b], prompts_b)
        differ_b = [rid for rid in streams_b if streams_b[rid] != want_b[rid]]
        if differ_b:
            failures.append(f"{len(differ_b)} backlog streams differ from "
                            f"the unloaded engine's: {differ_b}")
        launch_bad = per_engine_launch_failures(acc, per_step)
        total_b = sum(r["launches"].get("paged_decode_attention", 0)
                      for r in acc.values())
        if counts_b.get("paged_decode_attention", 0) != total_b:
            launch_bad.append(
                f"{counts_b.get('paged_decode_attention', 0)} paged-decode "
                f"launches in all, {total_b} inside the engines' steps")
        failures += launch_bad
        if live_end:
            survivor = router.replicas[live_end[0]].supervisor.engine
            err, _ = capture_failures(obs, survivor, per_kind)
            if err:
                failures.append(f"the survivor {err}")
            survivor_id = survivor._obs_id
            del survivor
        else:
            survivor_id = None
        del rec, res
        gc.collect()
        alive = sorted(k for k, ref in engines.items()
                       if ref() is not None and k != survivor_id)
        if alive:
            failures.append(f"engines of retired or killed replicas still "
                            f"alive after gc.collect(): {alive}")
        if locks.violation_count():
            failures.append(f"{locks.violation_count()} lock-order "
                            f"violations")
        print(f"phase 15(b) drain, kill mid-drain, retire: backlog "
              f"{len(backlog)} requests ({AUTOSCALE_BACKLOG} session-pinned "
              f"on each of {len(live)} replicas, {AUTOSCALE_BACKLOG_NEW} new "
              f"tokens), victim {victim_rid} killed mid-drain holding {held} "
              f"accepted unfinished requests, statuses "
              f"{dict(Counter(st_b.values()))}, "
              f"recoveries {router.n_recoveries}, poisoned "
              f"{router.poisoned_ids}, bitwise the unloaded engine's: "
              f"{not differ_b}; retired down to {len(live_end)} replica in "
              f"{retire_steps} steps; decisions {acts}; engines freed "
              f"{len(engines) - 1 - len(alive)} of {len(engines) - 1}; "
              f"replica-seconds {scaler.replica_seconds:.3f}; per engine "
              + ", ".join(f"{k} {r['decode_steps']} decode steps "
                          f"{r['launches'].get('paged_decode_attention', 0)}"
                          f" launches" for k, r in sorted(acc.items())
                          if r["decode_steps"])
              + f"; lock-order violations {locks.violation_count()}, lock "
              f"order edges {len(locks.lock_order_edges())}"
              + (f"; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
                 f" GB ({mem0 / 1e9:.2f} GB allocated before the phase)"
                 if cuda else "")
              + f"; phase 15 {time.perf_counter() - t_phase:.1f} s [{card}]")
        if failures:
            fail("phase 15(b): " + "; ".join(failures)
                 + f"; decisions {scaler.decisions}")
        router.stop()
        del router, front, scaler, seed_rep
        if capacity:
            failures = fleet_capacity(np, model, engine_kw, schedule,
                                      prompts, want, card, sync)
            if locks.violation_count():
                failures.append(f"{locks.violation_count()} lock-order "
                                f"violations")
            if failures:
                fail("phase 15(c): " + "; ".join(failures))
        return counts_a
    finally:
        alerts.set_default_manager(old_manager)
        obs.uninstall_compile_events()
        locks.uninstrument_locks()
        shutil.rmtree(journals, ignore_errors=True)


# -- phase 16: the deployment path, control flow and piecewise capture, and
# amp.debugging -----------------------------------------------------------------
# (a) Llama-542M at 8 layers, bf16, saved with jit.save (a torch.export
# program over explicit weights), loaded, and served by a Predictor; (b) the
# Llama 2 recipe step at DEPLOY_TRAIN_DEPTH layers, SR off so that eager and
# captured twins draw nothing: a loss-spike guard (a Python `if` on a device
# value, captured as one graph with both branches selected) and a host read
# between backward and opt.step() (full_graph=False: two graphs, the read
# eager); (c) phase 10(b)'s fp16 recipe with its forced overflow under the
# tensor checker and the operator stats
DEPLOY_SPEC = [([TRAIN_BATCH, TRAIN_SEQ], "int64")]
DEPLOY_TURN_ITERS = 5  # forward calls per timed turn (A, B, B, A)
DEPLOY_TRAIN_DEPTH = LLAMA_542M["num_hidden_layers"]  # full depth
SPIKE_SCALE = 0.5  # the guard's scaling of a spiking loss
PIECEWISE_TURN_STEPS = 3  # steps per timed turn of 16(b)
DEPLOY_CPU_DEPTH = 2  # layers of 16(a)'s model saved on the CPU


def flash_nodes(program):
    """(flash_fwd operator nodes, softmax nodes) of an exported program."""
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    return (targets.count("paddle_tpu_torch.flash_fwd.default"),
            sum("softmax" in t for t in targets))


def turns(torch, fns, iters):
    """Wall ms per call of each of ``fns`` (two), in turns A, B, B, A of
    ``iters`` calls each: ([A ms, A ms], [B ms, B ms])."""
    out = ([], [])
    for which in (0, 1, 1, 0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fns[which]()
        torch.cuda.synchronize()
        out[which].append((time.perf_counter() - t0) / iters * 1e3)
    return out


def fmt_turns(ms):
    return "/".join(f"{x:.2f}" for x in ms)


def cpu_saved_serving(torch, dev, seed, ids):
    """Phase 16(a)'s second save: Llama-542M's widths at DEPLOY_CPU_DEPTH
    layers, bf16, built and saved by ``jit.save`` on the CPU, then loaded
    onto the card by ``jit.load`` (its default device). Returns (flash_fwd
    nodes of the loaded program, flash-forward launches of one call, logits
    rel err against the same weights' live forward on the card, whether
    they are bitwise equal)."""
    import os
    import tempfile

    from paddle_tpu_torch import jit
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels

    pt_seed(seed)
    cfg = LlamaConfig(**dict(LLAMA_542M, num_hidden_layers=DEPLOY_CPU_DEPTH))
    model = LlamaForCausalLM(cfg, device="cpu", dtype=torch.bfloat16)
    model.eval()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "saved_on_cpu")
        jit.save(model, path, input_spec=DEPLOY_SPEC)
        layer = jit.load(path)
    n_flash, _ = flash_nodes(layer.program)
    model.to(dev)
    n0 = kernels.launch_counts()["flash_attention_fwd"]
    got = layer(ids)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()["flash_attention_fwd"] - n0
    with torch.no_grad():
        live = model(ids)
    e = rel_err(got, live)
    bitwise = bool(torch.equal(got, live))
    del layer, model, got, live
    torch.cuda.empty_cache()
    return n_flash, launched, e, bitwise


def deploy_serving(torch, np, dev, args, card, ids):
    """Phase 16(a): the saved model served by a Predictor against the live
    forward. Returns the flash-forward launches of one ``Predictor.run``."""
    import os
    import tempfile

    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import kernels

    pt_seed(args.seed)
    cfg = LlamaConfig(**LLAMA_542M)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    model.eval()
    L = cfg.num_hidden_layers
    ids = ids.to(torch.int64)  # the spec's dtype
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "llama542m")
        t0 = time.perf_counter()
        jit.save(model, path, input_spec=DEPLOY_SPEC)
        save_s = time.perf_counter() - t0
        sizes = {ext: os.path.getsize(path + ext)
                 for ext in (".pdiparams", ".pdmodel")}
        t0 = time.perf_counter()
        layer = jit.load(path)
        load_s = time.perf_counter() - t0
        n_flash, n_softmax = flash_nodes(layer.program)
        t0 = time.perf_counter()
        pred = inference.create_predictor(inference.Config(path))
        pred_s = time.perf_counter() - t0
    del layer
    if (n_flash, n_softmax) != (L, 0):
        fail(f"phase 16(a): the exported program holds {n_flash} "
             f"paddle_tpu_torch::flash_fwd nodes and {n_softmax} softmax "
             f"nodes, expected {L} and 0")
    feed = ids.cpu().numpy()
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(feed)
    pred.run()  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    pred.run()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    got = torch.from_numpy(out).to(dev)
    with torch.no_grad():
        live = model(ids)
    want_counts = flash_fwd_counts(L)
    if any(counts[k] != n for k, n in want_counts.items()):
        fail(f"phase 16(a): a Predictor.run launched "
             f"{ {k: counts[k] for k in want_counts} }, expected {want_counts}")
    e = rel_err(got, live)
    agree = float((got.argmax(-1) == live.argmax(-1)).float().mean())
    bitwise = bool(torch.equal(got, live.float()))
    if tuple(got.shape) != (TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size) or \
            not torch.isfinite(got).all():
        fail(f"phase 16(a): Predictor logits {tuple(got.shape)} or non-finite")
    del got, out

    def run_pred():
        pred.run()

    def run_live():
        with torch.no_grad():
            model(ids)

    live_ms, pred_ms = turns(torch, (run_live, run_pred), DEPLOY_TURN_ITERS)
    # phase 3's scoring forward with the flash forward as the registered
    # operator (A) against the direct launch the port made before (B)
    def run_direct():
        op = fa.flash_fwd_op
        fa.flash_fwd_op = fa.flash_attention_fwd
        try:
            run_live()
        finally:
            fa.flash_fwd_op = op

    op_ms, direct_ms = turns(torch, (run_live, run_direct), DEPLOY_TURN_ITERS)
    print(f"phase 16(a) deployed Llama-542M bf16 [4, 2048]: jit.save "
          f"{save_s:.2f} s (.pdiparams {sizes['.pdiparams']} bytes, .pdmodel "
          f"{sizes['.pdmodel']} bytes, {n_flash} flash_fwd nodes, "
          f"{n_softmax} softmax), jit.load {load_s:.2f} s, create_predictor "
          f"{pred_s:.2f} s; a Predictor.run launched "
          f"{json.dumps({k: counts[k] for k in want_counts})}; logits rel err "
          f"vs the live forward {e:.3g} (tol {LOGITS_REL_TOL}), argmax "
          f"agreement {agree:.4f} (min {ARGMAX_MIN}), bitwise equal: "
          f"{bitwise}; turns A, B, B, A of {DEPLOY_TURN_ITERS} calls: live "
          f"forward {fmt_turns(live_ms)} ms, Predictor.run "
          f"{fmt_turns(pred_ms)} ms [{card}]")
    print(f"phase 16(a) phase 3's scoring forward, flash forward as the "
          f"registered operator {fmt_turns(op_ms)} ms against the direct "
          f"launch {fmt_turns(direct_ms)} ms (turns A, B, B, A of "
          f"{DEPLOY_TURN_ITERS} calls) [{card}]")
    if not (e <= LOGITS_REL_TOL and agree >= ARGMAX_MIN):
        fail("phase 16(a): the deployed forward disagrees with the live one")
    del pred, model
    torch.cuda.empty_cache()
    n_cpu, launched, e_cpu, bitwise_cpu = cpu_saved_serving(
        torch, dev, args.seed, ids)
    print(f"phase 16(a) Llama-542M bf16 at {DEPLOY_CPU_DEPTH} layers saved "
          f"on the CPU, loaded onto the card: {n_cpu} flash_fwd nodes; a "
          f"call launched the flash forward {launched} times; logits rel err "
          f"vs the same weights' live forward on the card {e_cpu:.3g} (tol "
          f"{LOGITS_REL_TOL}), bitwise equal: {bitwise_cpu} [{card}]")
    if (n_cpu, launched) != (DEPLOY_CPU_DEPTH, DEPLOY_CPU_DEPTH) or \
            not e_cpu <= LOGITS_REL_TOL:
        fail(f"phase 16(a): the program saved on the CPU holds {n_cpu} "
             f"flash_fwd nodes and launched the kernel {launched} times on "
             f"the card (expected {DEPLOY_CPU_DEPTH} each), logits rel err "
             f"{e_cpu:.3g}")
    return counts["flash_attention_fwd"]


def spike_guard_step(model, opt):
    """The recipe step with a loss-spike guard: a Python `if` on a device
    value (converted by dy2static: both branches, then a select)."""
    def step(ids, labels, limit):
        loss = model.loss(ids, labels)
        if loss > limit:
            loss = loss * SPIKE_SCALE
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return step


def logged_step(model, opt, log):
    """The recipe step with a host read between backward and the step."""
    def step(ids, labels):
        loss = model.loss(ids, labels)
        loss.backward()
        log.append(float(loss))
        opt.step()
        opt.clear_grad()
        return loss

    return step


def twins(torch, dev, depth, seed):
    """Two copies of one recipe state (SR off: nothing is drawn)."""
    return [recipe_model(torch, dev, depth, torch.bfloat16, seed, sr=False)
            for _ in range(2)]


def step_launches(counts):
    return {k: counts[k] for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv", "fused_adamw")}


def control_flow_phase(torch, np, dev, args, card, ids, labels):
    """Phase 16(b): the spike guard captured as one graph, both branches
    bitwise equal to eager; the logged step piecewise, two graphs, bitwise
    equal to eager; the piecewise and whole-eager steps in turns."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.ops import kernels

    D = DEPLOY_TRAIN_DEPTH
    want = {"flash_attention_fwd": D, "flash_attention_bwd_dq": D,
            "flash_attention_bwd_dkv": D, "fused_adamw": ADAMW_GROUPS}
    (m1, o1), (m2, o2) = twins(torch, dev, D, args.seed)
    guarded = jit.to_static(spike_guard_step(m1, o1), layers=[m1],
                            optimizers=[o1])
    eager = spike_guard_step(m2, o2)
    never = torch.full((), 1e9, device=dev)
    always = torch.zeros((), device=dev)
    diffs, counts, taken = [], None, []
    # warm-up (eager), the capture, then replays: each branch twice
    for i, limit in enumerate((never, always, never, always, never)):
        kernels.reset_launch_counts()
        a = guarded(ids, labels, limit)
        torch.cuda.synchronize()
        if i == 2:
            counts = step_launches(kernels.launch_counts())
        b = eager(ids, labels, limit)
        taken.append(limit is always)
        if not torch.equal(bits(torch, a.reshape(1)), bits(torch, b.reshape(1))):
            diffs.append(f"loss of call {i}")
    diffs += state_diff(torch, state_of(torch, m1, o1), state_of(torch, m2, o2))
    graphs = len(guarded._graphs)
    print(f"phase 16(b) spike guard (`if loss > limit: loss = loss * "
          f"{SPIKE_SCALE}`), recipe step Llama-542M bf16 B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ} {D} layers, SR off: {graphs} captured graph; "
          f"branch taken on calls {[i for i, t in enumerate(taken) if t]}; "
          f"a replay launched {json.dumps(counts)}; captured vs eager twin: "
          f"{'bitwise equal' if not diffs else diffs[:4]} (losses, "
          f"parameters, moments) [{card}]")
    if graphs != 1 or diffs or counts != want:
        fail(f"phase 16(b): the spike-guard step: graphs {graphs}, "
             f"launches {counts} (expected {want}), differences {diffs[:4]}")
    del guarded, eager, m1, o1, m2, o2
    torch.cuda.empty_cache()

    (m1, o1), (m2, o2) = twins(torch, dev, D, args.seed + 1)
    log1, log2 = [], []
    split = jit.to_static(logged_step(m1, o1, log1), layers=[m1],
                          optimizers=[o1], full_graph=False)
    eager = logged_step(m2, o2, log2)
    diffs, counts = [], None
    n_calls = 5
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(n_calls):
            kernels.reset_launch_counts()
            a = split(ids, labels)
            torch.cuda.synchronize()
            if i == n_calls - 1:
                counts = step_launches(kernels.launch_counts())
            b = eager(ids, labels)
            if not torch.equal(bits(torch, a.reshape(1)), bits(torch, b.reshape(1))):
                diffs.append(f"loss of call {i}")
    diffs += state_diff(torch, state_of(torch, m1, o1), state_of(torch, m2, o2))
    pw = split._piecewise
    graphs = (None if pw is None else
              (len(pw._prefix_sf._graphs), len(pw._suffix_sf._graphs)))
    steps = (o1._global_step, o2._global_step)
    notes = [str(w.message)[:100] for w in caught]
    print(f"phase 16(b) host read between backward and opt.step() "
          f"(`log.append(float(loss))`), full_graph=False, {n_calls} calls: "
          f"piecewise {pw is not None}, graphs (prefix, suffix) {graphs}, "
          f"eager fallback {split._fallback_eager}; the last call launched "
          f"{json.dumps(counts)}; _global_step {steps[0]} (eager twin "
          f"{steps[1]}); logged losses equal: {log1 == log2}; split vs eager "
          f"twin: {'bitwise equal' if not diffs else diffs[:4]}; warnings "
          f"{notes[:2]} [{card}]")
    if (pw is None or graphs != (1, 1) or split._fallback_eager or diffs
            or counts != want or steps != (n_calls, n_calls) or log1 != log2):
        fail(f"phase 16(b): the piecewise step: graphs {graphs}, launches "
             f"{counts} (expected {want}), steps {steps}, differences "
             f"{diffs[:4]}")
    whole = jit.to_static(logged_step(m2, o2, log2), layers=[m2],
                          optimizers=[o2], full_graph=False)
    whole._fallback_eager = True  # what a split that is not safe leaves
    eager_ms, split_ms = turns(
        torch, (lambda: whole(ids, labels), lambda: split(ids, labels)),
        PIECEWISE_TURN_STEPS)

    def peak_gb(fn):
        """Device memory a call allocates at its peak above its start."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    eager_gb = peak_gb(lambda: whole(ids, labels))
    split_gb = peak_gb(lambda: split(ids, labels))
    print(f"phase 16(b) a step in turns A, B, B, A of {PIECEWISE_TURN_STEPS}: "
          f"whole-function eager {fmt_turns(eager_ms)} ms, piecewise (two "
          f"replays, the read eager) {fmt_turns(split_ms)} ms; a call's "
          f"peak allocation above its start: whole eager {eager_gb:.3f} GB, "
          f"piecewise {split_gb:.3f} GB [{card}]")
    del split, whole, eager, m1, o1, m2, o2
    torch.cuda.empty_cache()


def debugging_phase(torch, np, dev, args, card, ids, labels):
    """Phase 16(c): phase 10(b)'s fp16 recipe (eager) under the tensor
    checker: the clean step passes, the forced overflow raises and names
    its first non-finite op; the operator stats of one step, the kernels'
    reports among them; with debugging off the launches are as before."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.amp import debugging as dbg
    from paddle_tpu_torch.ops import kernels

    model, opt = recipe_model(torch, dev, FP16_DEPTH, torch.float32, args.seed)
    scaler = amp.GradScaler()

    def step():
        with amp.auto_cast(level="O1", dtype="float16"):
            loss = model.loss(ids, labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss

    step()  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step()
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
        True, debug_mode=dbg.DebugMode.CHECK_NAN_INF_AND_ABORT))
    clean_err = forced_err = None
    try:
        try:
            step()
        except FloatingPointError as e:
            clean_err = str(e).splitlines()[0]
        scale0 = scaler.get_scale_value()
        scaler.set_scale_value(2.0 ** 40)
        try:
            step()
        except FloatingPointError as e:
            forced_err = str(e).splitlines()[0]
        opt.clear_grad()
        scaler.set_scale_value(scale0)
    finally:
        dbg.disable_tensor_checker()
    t0 = time.perf_counter()
    with dbg.collect_operator_stats(print_summary=False) as col:
        step()
    stats_s = time.perf_counter() - t0
    rows = col.rows()
    by_op = {}  # invocations per op: a row counts them per output dtype
    for r in rows:
        by_op[r["op"]] = max(by_op.get(r["op"], 0), r["calls"])
    L = FP16_DEPTH
    want_reports = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                    "flash_attention_bwd_dkv": L, "fused_adamw": ADAMW_GROUPS}
    reports = {k: by_op.get(k, 0) for k in want_reports}
    top = sorted(rows, key=lambda r: -r["absmax"])[:5]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step()
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    print(f"phase 16(c) fp16 O1 recipe, {L} layers, eager, tensor checker "
          f"CHECK_NAN_INF_AND_ABORT: clean step raised: {clean_err}; forced "
          f"overflow (scale 2**40) raised: {forced_err!r} [{card}]")
    print(f"phase 16(c) operator stats of one eager step ({stats_s:.2f} s "
          f"with the stats on): {len(rows)} (op, dtype) rows over "
          f"{sum(by_op.values())} op calls; the kernels' own reports "
          f"{json.dumps(reports)}; largest absmax "
          + "; ".join(f"{r['op']} {r['dtype']} {r['absmax']:.4g}" for r in top)
          + f" [{card}]")
    print(f"phase 16(c) launches of a step before the debugging "
          f"{json.dumps(step_launches(before))}, after it "
          f"{json.dumps(step_launches(after))}")
    if clean_err is not None or not forced_err or "op '" not in forced_err:
        fail(f"phase 16(c): the tensor checker: clean step {clean_err!r}, "
             f"forced overflow {forced_err!r}")
    if reports != want_reports or before != after:
        fail(f"phase 16(c): the kernels reported {reports} (expected "
             f"{want_reports}); launches before {step_launches(before)}, "
             f"after {step_launches(after)}")
    del model, opt, scaler
    torch.cuda.empty_cache()


def deploy_phase(torch, np, dev, args, card, ids, labels):
    """Phase 16 (a)-(c)."""
    deploy_serving(torch, np, dev, args, card, ids)
    gc.collect()
    torch.cuda.empty_cache()
    control_flow_phase(torch, np, dev, args, card, ids, labels)
    gc.collect()
    debugging_phase(torch, np, dev, args, card, ids, labels)


# -- phase 17: collectives and data-parallel training -------------------------
# (a) NCCL at world size 1 in this process; (b) and (c) two ranks on the one
# card through `python -m paddle_tpu_torch.distributed.launch --nproc 2`,
# gloo forced (NCCL puts no two ranks on one device), each rank running
# this script with --rank17
DP_STEPS = 3  # (a): the eager warm-up, the capture, a replay; (b): eager
DP_PER_RANK = TRAIN_BATCH // 2  # (b): B=2 a rank, B=4 in all
# (b): the two ranks' mean loss against one process's B=4 step (17(a)'s
# twin), relative: a bf16 step over other GEMM shapes and a bf16 mean of
# two gradients in place of one, about two bf16 ulps (2 * 2**-8)
DP_LOSS_REL = 1e-2
SHARD_DEPTH, SHARD_STEPS = 2, 2  # (c): layers and steps (SR off)
HALF_BAND = (0.45, 0.55)  # (c): "about halved", as a ratio to DataParallel's
P17_PROBE_TIMEOUT_S = 180  # a probe launch, building nothing
P17_RANK_TIMEOUT_S = 900  # the (b)+(c) launch
COLL_TIMED_NUMEL = 1 << 24  # 64 MB of f32 per timed collective (reported)
P17_LEVELS = ("os", "os_g", "p_g_os")


def p17_inputs(np, world: int, rank: int, seed: int) -> dict:
    """Rank ``rank``'s inputs of the collective battery (any rank can make
    every rank's, so each checks its results against numpy)."""
    rng = np.random.RandomState(seed * 1000 + rank)
    n = 4 * world
    return dict(f=rng.randn(n, 6).astype(np.float32),
                i=rng.randint(-50, 50, (n, 6)).astype(np.int64),
                lst=rng.randn(world, 2, 3).astype(np.float32))


def collective_battery(torch, np, dev, seed: int):
    """The port's 17 collectives and ``barrier`` on ``dev``'s tensors in the
    current world, each result against numpy over every rank's inputs:
    returns ``(results, failures)``. At world sizes 1 and 2 every
    expectation is exact (a sum of two f32 values has one rounding, as
    numpy's has)."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import ReduceOp
    from paddle_tpu_torch.distributed.communication import stream

    world, rank = D.get_world_size(), D.get_rank()
    xs = [p17_inputs(np, world, k, seed) for k in range(world)]
    mine = xs[rank]
    on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    f, i = on(mine["f"]), on(mine["i"])
    want, got = {}, {}
    stack = lambda key: np.stack([x[key] for x in xs])  # noqa: E731
    for op, name, fn in ((ReduceOp.SUM, "sum", np.sum),
                         (ReduceOp.MAX, "max", np.max),
                         (ReduceOp.MIN, "min", np.min),
                         (ReduceOp.PROD, "prod", np.prod)):
        t = f.clone()
        D.all_reduce(t, op)
        got[f"all_reduce_{name}"] = t
        want[f"all_reduce_{name}"] = fn(stack("f"), axis=0).astype(np.float32)
        t = i.clone()
        D.all_reduce(t, op)
        got[f"all_reduce_{name}_int"] = t
        want[f"all_reduce_{name}_int"] = fn(stack("i"), axis=0)
    t = f.clone()
    D.all_reduce(t, ReduceOp.AVG, sync_op=False).wait()
    got["all_reduce_avg_async"] = t
    want["all_reduce_avg_async"] = (np.sum(stack("f"), 0).astype(np.float32)
                                    / np.float32(world))
    rows = []
    D.all_gather(rows, i)
    got["all_gather"] = torch.stack(rows)
    want["all_gather"] = stack("i")
    out = torch.empty(world * f.shape[0], 6, device=dev)
    D.all_gather_into_tensor(out, f)
    got["all_gather_into_tensor"] = out
    want["all_gather_into_tensor"] = np.concatenate(stack("f"), 0)
    objs = []
    D.all_gather_object(objs, {"rank": rank})
    got["all_gather_object"] = objs
    want["all_gather_object"] = [{"rank": k} for k in range(world)]
    t = f.clone()
    D.reduce(t, dst=world - 1)
    got["reduce"] = t
    want["reduce"] = (np.sum(stack("f"), 0).astype(np.float32)
                      if rank == world - 1 else mine["f"])
    t = i.clone()
    D.broadcast(t, src=world - 1)
    got["broadcast"] = t
    want["broadcast"] = xs[world - 1]["i"]
    n = f.shape[0] // world
    t = torch.empty(n, 6, device=dev)
    D.reduce_scatter(t, f.clone())
    got["reduce_scatter"] = t
    want["reduce_scatter"] = np.sum(stack("f"), 0).astype(
        np.float32)[rank * n:(rank + 1) * n]
    t = torch.empty(2, 3, device=dev)
    D.scatter(t, list(on(xs[0]["lst"])) if rank == 0 else None, src=0)
    got["scatter"] = t
    want["scatter"] = xs[0]["lst"][rank]
    got["gather"] = torch.stack(D.gather(i, dst=0))
    want["gather"] = stack("i")
    outs = []
    D.alltoall(outs, list(on(mine["lst"])))
    got["alltoall"] = torch.stack(outs)
    want["alltoall"] = np.stack([x["lst"][rank] for x in xs])
    t = torch.empty_like(f)
    D.alltoall_single(t, f.clone())
    got["alltoall_single"] = t
    want["alltoall_single"] = np.concatenate(
        [x["f"][rank * n:(rank + 1) * n] for x in xs], 0)
    got["p2p_sendrecv"] = D.p2p_sendrecv(f, src=0, dst=world - 1)
    want["p2p_sendrecv"] = (xs[0]["f"] if rank == world - 1
                            else np.zeros_like(mine["f"]))
    ring = [(k, (k + 1) % world) for k in range(world)]
    got["ppermute"] = D.ppermute(i, ring)
    want["ppermute"] = xs[(rank - 1) % world]["i"]
    if world > 1:
        right, left = (rank + 1) % world, (rank - 1) % world
        t = torch.empty_like(i)
        works = [D.isend(i, dst=right), D.irecv(t, src=left)]
        for w in works:
            w.wait()
        got["isend_irecv"] = t
        want["isend_irecv"] = xs[left]["i"]
        t = torch.empty_like(f)
        if rank == 0:
            D.send(f, dst=right)
            D.recv(t, src=left)
        else:
            D.recv(t, src=left)
            D.send(f, dst=right)
        got["send_recv"] = t
        want["send_recv"] = xs[left]["f"]
    t = f.clone()
    stream.all_reduce(t, use_calc_stream=True)
    got["stream_all_reduce"] = t
    want["stream_all_reduce"] = want["all_reduce_sum"]
    objs = [None]
    if rank == 0:
        objs = [{"seed": seed}]
    D.broadcast_object_list(objs, src=0)
    got["broadcast_object_list"] = objs
    want["broadcast_object_list"] = [{"seed": seed}]
    got["rank_in_trace"] = D.get_rank_in_trace()
    want["rank_in_trace"] = rank
    D.barrier()
    res, failures = {}, []
    for k, g in got.items():
        if isinstance(g, torch.Tensor):
            if g.device.type != torch.device(dev).type:
                failures.append(f"{k} came back on {g.device}")
            g = g.cpu().numpy()
        res[k] = g
        w = want[k]
        same = (np.array_equal(g, w) and np.asarray(g).dtype == np.asarray(w).dtype
                if isinstance(g, np.ndarray) else g == w)
        if not same:
            failures.append(f"{k} differs from numpy")
    return res, failures


def time_collectives(torch, dev):
    """Wall ms (synchronized) of the large collectives on one 64 MB f32
    tensor, with the bytes each staged through host memory: {name: (ms,
    GB/s of the tensor's bytes, staged bytes)}. Reported, never gated."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import communication as C

    world = D.get_world_size()
    x = torch.ones(COLL_TIMED_NUMEL, device=dev)
    out = torch.empty(world * COLL_TIMED_NUMEL, device=dev)
    shard = torch.empty(COLL_TIMED_NUMEL // world, device=dev)
    calls = {
        "all_reduce": lambda: D.all_reduce(x),
        "broadcast": lambda: D.broadcast(x, src=0),
        "all_gather_into_tensor": lambda: D.all_gather_into_tensor(out, x),
        "reduce_scatter": lambda: D.reduce_scatter(shard, x),
        "alltoall_single": lambda: D.alltoall_single(out[:COLL_TIMED_NUMEL], x),
    }
    rows = {}
    for name, fn in calls.items():
        fn()  # warm-up
        torch.cuda.synchronize()
        C.reset_staged_bytes()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows[name] = (ms, x.numel() * 4 / ms / 1e6,
                      sum(C.staged_bytes().values()))
    return rows


def p17_model(torch, dev, depth, seed, sr):
    """The flagship's model and optimizer (``bench.py``'s AdamW) at
    ``depth`` layers, from ``seed``."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    pt_seed(seed)
    cfg = LlamaConfig(**dict(LLAMA_542M, max_position_embeddings=2048,
                             num_hidden_layers=depth))
    m = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    o = AdamW(learning_rate=TRAIN_LR, parameters=m.parameters(),
              moment_dtype="bfloat16", use_stochastic_rounding=sr, fused=True)
    return m, o


def p17_batch(torch, np, dev, seed):
    """Phase 7's global batch (labels = ids)."""
    ids_np = np.random.RandomState(seed).randint(
        0, LLAMA_542M["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ))
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
    return ids, ids.clone()


def dp_local_phase(torch, np, dev, args, card):
    """17(a): NCCL at world size 1 in this process. Returns the twin's
    (one process, no DataParallel) losses, which (b) is held against."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.distributed.communication import flight_recorder
    from paddle_tpu_torch.ops import kernels

    group = D.init_parallel_env()
    failures = []
    if group.backend != "nccl" or D.get_world_size() != 1:
        fail(f"phase 17(a): expected NCCL at world size 1, got {group}")
    _, bad = collective_battery(torch, np, dev, args.seed)
    failures += [f"NCCL battery: {b}" for b in bad]
    ids, labels = p17_batch(torch, np, dev, args.seed)
    runs = {}
    for name in ("DataParallel", "twin"):
        model, opt = p17_model(torch, dev, LLAMA_542M["num_hidden_layers"],
                               args.seed, sr=True)
        wrapped = D.DataParallel(model) if name == "DataParallel" else model
        step = jit.to_static(step_fn(wrapped, opt), layers=[model],
                             optimizers=[opt])
        flight_recorder.reset()
        losses, per_call, times = [], [], []
        for _ in range(DP_STEPS):
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(ids, labels).detach()))
            times.append((time.perf_counter() - t0) * 1e3)
            per_call.append(step_launches(kernels.launch_counts()))
        captured = [s for s in flight_recorder.recorder().snapshot()
                    if "captured" in s.detail]
        runs[name] = dict(
            losses=losses, per_call=per_call, times=times,
            graphs=len(step._graphs), captured=len(captured),
            buckets=len(wrapped._buckets) if name == "DataParallel" else 0,
            params=[p.detach().cpu() for p in model.parameters()])
        del model, opt, wrapped, step
        gc.collect()
        torch.cuda.empty_cache()
    dp, twin = runs["DataParallel"], runs["twin"]
    want = {"flash_attention_fwd": LLAMA_542M["num_hidden_layers"],
            "flash_attention_bwd_dq": LLAMA_542M["num_hidden_layers"],
            "flash_attention_bwd_dkv": LLAMA_542M["num_hidden_layers"],
            "fused_adamw": ADAMW_GROUPS}
    if dp["per_call"][-1] != want:
        failures.append(f"a replay's launches {dp['per_call'][-1]} != {want}")
    if dp["graphs"] != 1 or dp["captured"] != dp["buckets"]:
        failures.append(f"{dp['graphs']} graphs, {dp['captured']} all-reduces "
                        f"issued while capturing for {dp['buckets']} buckets")
    differ = [i for i, (a, b) in enumerate(zip(dp["params"], twin["params"]))
              if not torch.equal(a, b)]
    if differ:
        failures.append(f"after {DP_STEPS} steps {len(differ)} parameters "
                        f"differ from the twin's (first: {differ[:3]})")
    if dp["losses"] != twin["losses"]:
        failures.append(f"losses {dp['losses']} != the twin's {twin['losses']}")
    print(f"phase 17(a) NCCL world size 1: the 17 collectives and barrier on "
          f"CUDA tensors equal numpy; DataParallel(Llama-542M bf16, "
          f"B={TRAIN_BATCH} S={TRAIN_SEQ}, SR on, AdamW fused) under "
          f"to_static: {dp['buckets']} gradient buckets, all-reduces issued "
          f"inside the capture {dp['captured']}, graphs {dp['graphs']}, "
          f"launches a call {dp['per_call']}, losses {dp['losses']} (twin "
          f"{twin['losses']}), parameters bitwise the twin's after "
          f"{DP_STEPS} steps: {not differ}; ms a call "
          f"{[round(t, 2) for t in dp['times']]} (twin "
          f"{[round(t, 2) for t in twin['times']]}) [{card}]")
    D.destroy_process_group()
    if failures:
        fail("phase 17(a): " + "; ".join(failures))
    return twin["losses"]


def launch_ranks(mode, out, args, script=None, extra=(), backend="gloo",
                 timeout=P17_RANK_TIMEOUT_S, nproc=2):
    """``python -m paddle_tpu_torch.distributed.launch --nproc <nproc>`` of
    ``script`` (this file by default) in rank mode ``mode``; returns
    ``(exit code, the ranks' logs)``."""
    import os
    from pathlib import Path

    here = Path(__file__).resolve().parent
    env = dict(os.environ)
    env.pop("PADDLE_DISTRI_BACKEND", None)
    if backend:
        env["PADDLE_DISTRI_BACKEND"] = backend
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(nproc), "--log_dir", str(out / "logs"), "--job_id", mode,
           "--max_restart", "0", str(script or Path(__file__).resolve()),
           "--rank17", mode, "--out", str(out), "--seed", str(args.seed),
           *extra]
    try:
        rc = subprocess.run(cmd, cwd=here, env=env, timeout=timeout).returncode
    except subprocess.TimeoutExpired:
        rc = 124
    logs = "".join(f"--- {f.name} ---\n{_log_excerpt(f)}\n"
                   for f in sorted((out / "logs").glob("*.log")))
    return rc, logs


def _log_excerpt(path, n=3000):
    """A rank log's traceback (from its first), else its last ``n``
    characters."""
    text = path.read_text(errors="replace")
    at = text.find("Traceback")
    return text[at:at + n] if at >= 0 else text[-n:]


def rank_results(out, n=2):
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(n)]


def p17_probes(torch, np, args, card, tmp):
    """Phase 17's probes of the card's backends, printed first: NCCL with
    two ranks on the one device, and which collectives gloo takes on CUDA
    tensors and whether it reduces bf16."""
    out = tmp / "nccl2"
    out.mkdir()
    rc, logs = launch_ranks("nccl2", out, args, backend="",
                            timeout=P17_PROBE_TIMEOUT_S)
    if rc == 0:
        got = rank_results(out)
        print(f"phase 17 probe: NCCL with two ranks on one card: "
              f"{got[0]['nccl2']} | {got[1]['nccl2']} [{card}]")
    else:
        print(f"phase 17 probe: NCCL with two ranks on one card: the launch "
              f"exited {rc} (124: timed out after {P17_PROBE_TIMEOUT_S} s) "
              f"[{card}]\n{logs[-2000:]}")
    out = tmp / "probe"
    out.mkdir()
    rc, logs = launch_ranks("probe", out, args, timeout=P17_PROBE_TIMEOUT_S)
    if rc != 0:
        fail(f"phase 17 probe: the gloo probe launch exited {rc}\n{logs}")
    got = rank_results(out)
    print(f"phase 17 probe: gloo on CUDA tensors, per collective: "
          f"{json.dumps(got[0]['gloo_cuda'])} [{card}]")
    print(f"phase 17 probe: gloo reduces bf16: CPU tensors "
          f"{got[0]['bf16_cpu']}, CUDA tensors {got[0]['bf16_cuda']} [{card}]")


def dp_ranks(torch, np, args, card, twin_losses, tmp, script=None, extra=(),
             parts="bc"):
    """17(b) and (c) through the launcher; returns the failures."""
    out = tmp / f"ranks-{parts}"
    out.mkdir()
    rc, logs = launch_ranks("train", out, args, script=script,
                            extra=("--parts", parts, *extra))
    if rc != 0:
        return [f"the two-rank launch exited {rc}:\n{logs}"]
    ranks = rank_results(out)
    failures = []
    for r, res in enumerate(ranks):
        failures += [f"rank {r}: {f}" for f in res["failures"]]
    if "b" in parts:
        dp_losses = [float(np.mean(x)) for x in zip(*(r["dp_losses"]
                                                     for r in ranks))]
        rel = [abs(a - b) / abs(b) for a, b in zip(dp_losses, twin_losses)] \
            if twin_losses else [float("nan")]
        if twin_losses and max(rel) > DP_LOSS_REL:
            failures.append(f"the ranks' mean losses {dp_losses} are "
                            f"{max(rel):.3g} from one process's B="
                            f"{TRAIN_BATCH} step {twin_losses} (tol "
                            f"{DP_LOSS_REL})")
        r0 = ranks[0]
        print(f"phase 17(b) two gloo ranks on the one card (launcher, "
              f"cuda:0 each): the collectives on CUDA tensors bitwise the "
              f"same on CPU tensors and numpy's: "
              f"{not any('battery' in f for f in failures)}; "
              f"DataParallel(Llama-542M, B={DP_PER_RANK} a rank, SR on): "
              f"mean losses {[round(x, 5) for x in dp_losses]} against one "
              f"process's B={TRAIN_BATCH} "
              f"{[round(x, 5) for x in twin_losses or []]}"
              f" (worst rel {max(rel):.3g}, tol {DP_LOSS_REL}), ranks' "
              f"parameters bitwise equal after each step "
              f"{[r['dp_equal'] for r in ranks]}, gradients the ranks' mean "
              f"bitwise {[r['dp_mean_ok'] for r in ranks]}, launches per rank "
              f"{[r['dp_counts'] for r in ranks]}, ms a step "
              f"{[[round(t, 1) for t in r['dp_ms']] for r in ranks]}, peak "
              f"memory GB {[r['dp_peak_gb'] for r in ranks]}, collective "
              f"contract {[r['contract'] for r in ranks]} [{card}]")
        print("phase 17(b) collectives, 64 MB f32 on CUDA tensors under gloo "
              "(ms, GB/s, bytes staged through host): " + "; ".join(
                  f"{k} {v[0]:.2f} ms {v[1]:.2f} GB/s staged {v[2]}"
                  for k, v in r0["coll_times"].items()) + f" [{card}]")
    if "c" in parts:
        for r, res in enumerate(ranks):
            mem = res["mem"]
            print(f"phase 17(c) rank {r}, Llama-542M at {SHARD_DEPTH} layers, "
                  f"SR off, {SHARD_STEPS} steps: " + "; ".join(
                      f"{lv}: params {m['params'] / 1e9:.3f} GB moments "
                      f"{m['moments'] / 1e9:.3f} GB grads {m['grads'] / 1e9:.3f}"
                      f" GB peak {m['peak'] / 1e9:.2f} GB, bitwise "
                      f"DataParallel's {m['equal']}, AdamW launches "
                      f"{m['adamw']}, ms a step {[round(t, 1) for t in m['ms']]}"
                      for lv, m in mem.items()) + f" [{card}]")
    return failures


def bytecode_cache() -> None:
    """Keep the compiled bytecode of every module this run imports under
    ``build/pycache/`` of the checkout, for this process and each one it
    starts (``PYTHONPYCACHEPREFIX``). Where the interpreter's packages hold
    no bytecode it can use, every process compiles each module it imports
    from source: a rank of phase 20(c) compiled 1058 of them in its body,
    5.5 s (its ``cProfile``; PERF.md §6)."""
    cache = Path(__file__).resolve().parent / "build" / "pycache"
    cache.mkdir(parents=True, exist_ok=True)
    sys.pycache_prefix = str(cache)
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = str(cache)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


def phase17_rank(mode, out, seed, parts="bc", steps=None):
    """One rank of a phase-17 or phase-18 launch (``chip_smoke.py --rank17
    MODE``): writes ``<out>/rank<r>.json``."""
    import numpy as np
    import torch

    import paddle_tpu_torch.distributed as D

    torch.backends.cuda.matmul.allow_tf32 = False
    if mode == "tf":  # 20(b): a dp replica of its own, no process group
        res = {"failures": []}
        tf_rank(torch, np, out, seed, res)
        return 0
    if mode == "nccl2":  # two ranks, NCCL, one device
        try:
            D.init_parallel_env()
            t = torch.ones(4, device="cuda")
            D.all_reduce(t)
            torch.cuda.synchronize()
            res = {"nccl2": f"ran: all_reduce gave {t.tolist()}"}
        except Exception as e:  # noqa: BLE001 - the probe reports the refusal
            res = {"nccl2": f"refused: {type(e).__name__}: {str(e)[:300]}"}
        import os

        with open(f"{out}/rank{os.environ['RANK']}.json", "w") as f:
            json.dump(res, f)
        return 0
    group = D.init_parallel_env()
    rank, dev = D.get_rank(), group.device
    res = {"failures": []}
    if mode == "probe":
        import torch.distributed as tdist

        x = torch.ones(8, device=dev)
        ops = {
            "all_reduce": lambda: tdist.all_reduce(x.clone()),
            "broadcast": lambda: tdist.broadcast(x.clone(), 0),
            "all_gather": lambda: tdist.all_gather(
                [torch.empty_like(x) for _ in range(2)], x),
            "all_gather_into_tensor": lambda: tdist.all_gather_into_tensor(
                torch.empty(16, device=dev), x),
            "reduce": lambda: tdist.reduce(x.clone(), 0),
            "reduce_scatter": lambda: tdist.reduce_scatter(
                torch.empty(4, device=dev), [x[:4].clone(), x[4:].clone()]),
            "scatter": lambda: tdist.scatter(
                torch.empty_like(x), [x, x] if rank == 0 else None, 0),
            "gather": lambda: tdist.gather(
                x, [torch.empty_like(x) for _ in range(2)] if rank == 0
                else None, 0),
            "all_to_all": lambda: tdist.all_to_all(
                [torch.empty(4, device=dev) for _ in range(2)],
                [x[:4].clone(), x[4:].clone()]),
            "all_to_all_single": lambda: tdist.all_to_all_single(
                torch.empty_like(x), x.clone()),
        }
        table = {}
        for name, fn in ops.items():
            try:
                fn()
                torch.cuda.synchronize()
                table[name] = "takes"
            except Exception as e:  # noqa: BLE001 - the probe reports it
                table[name] = f"refuses ({str(e).splitlines()[0][:80]})"
            tdist.barrier()
        res["gloo_cuda"] = table
        for where in ("cpu", "cuda"):
            t = torch.full((8,), 1.5 + rank, dtype=torch.bfloat16,
                           device=where if where == "cpu" else dev)
            try:
                tdist.all_reduce(t)
                res[f"bf16_{where}"] = f"yes, {t[0].item()} (want 4.0)"
            except Exception as e:  # noqa: BLE001 - the probe reports it
                res[f"bf16_{where}"] = f"no ({str(e).splitlines()[0][:80]})"
            tdist.barrier()
    elif mode == "tp":
        tp_rank(torch, np, D, rank, dev, seed, parts, res, out, steps)
    elif mode == "hybrid":
        hybrid_rank(torch, np, D, rank, dev, seed, res, out)
    elif mode == "pp":
        pp_rank(torch, np, D, rank, dev, seed, parts, res, out, steps)
    elif mode == "ppdp":
        ppdp_rank(torch, np, D, rank, dev, seed, res, out)
    elif mode == "elastic":
        elastic_rank(torch, np, D, rank, dev, seed, parts, res, out)
    else:
        train_rank(torch, np, D, group, rank, dev, seed, parts, res, out)
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    D.destroy_process_group()
    return 0


def train_rank(torch, np, D, group, rank, dev, seed, parts, res, out):
    """17(b) and (c) on this rank; appends to ``res['failures']``."""
    from pathlib import Path

    from paddle_tpu_torch.base.random import model_parallel_random_seed
    from paddle_tpu_torch.distributed.communication import flight_recorder
    from paddle_tpu_torch.distributed.store import FileKVStore
    from paddle_tpu_torch.ops import kernels

    failures = res["failures"]
    world = D.get_world_size()
    ids, labels = p17_batch(torch, np, dev, seed)
    x = ids[rank * DP_PER_RANK:(rank + 1) * DP_PER_RANK]
    y = labels[rank * DP_PER_RANK:(rank + 1) * DP_PER_RANK]
    if "b" in parts:
        got_gpu, bad = collective_battery(torch, np, dev, seed)
        failures += [f"battery on CUDA tensors: {b}" for b in bad]
        got_cpu, bad = collective_battery(torch, np, torch.device("cpu"), seed)
        failures += [f"battery on CPU tensors: {b}" for b in bad]
        for k in got_gpu:
            a, b = got_gpu[k], got_cpu[k]
            same = (np.array_equal(a, b) if isinstance(a, np.ndarray)
                    else a == b)
            if not same:
                failures.append(f"battery: {k} on CUDA differs from the CPU")
        res["coll_times"] = time_collectives(torch, dev)
        model, opt = p17_model(torch, dev, LLAMA_542M["num_hidden_layers"],
                               seed, sr=True)
        # the salts follow the global branch, equal on both ranks; the
        # local branch differs by rank
        model_parallel_random_seed(seed, rank)
        dp = D.DataParallel(model)
        params = list(model.parameters())
        probe = params[-2]  # the final norm: its gradient, mean of the ranks'
        with dp.no_sync():
            model.loss(x, y).backward()
        rows = []
        D.all_gather(rows, probe.grad.detach())
        mean = (rows[0] + rows[1]) / world
        opt.clear_grad()
        model.loss(x, y).backward()
        res["dp_mean_ok"] = bool(torch.equal(probe.grad, mean))
        if not res["dp_mean_ok"]:
            failures.append("DataParallel's gradient is not the ranks' mean")
        opt.clear_grad()
        step = step_fn(dp, opt)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, ms, equal = [], [], []
        for _ in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(x, y).detach()))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            ok = True
            for p in params:  # rank 0's parameters against this rank's
                buf = p.detach().clone()
                D.broadcast(buf, src=0)
                ok &= bool(torch.equal(buf, p))
            flags = []
            D.all_gather_object(flags, ok)
            equal.append(all(flags))
        res["dp_counts"] = step_launches(kernels.launch_counts())
        res["dp_losses"], res["dp_ms"], res["dp_equal"] = losses, ms, equal
        res["dp_peak_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
        want = {k: LLAMA_542M["num_hidden_layers"] * DP_STEPS for k in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")}
        want["fused_adamw"] = ADAMW_GROUPS * DP_STEPS
        if res["dp_counts"] != want:
            failures.append(f"launches {res['dp_counts']} != {want}")
        if not all(equal):
            failures.append(f"the ranks' parameters differ after steps "
                            f"{[i for i, e in enumerate(equal) if not e]}")
        del model, opt, dp, step, params, probe, rows, mean
        gc.collect()
        torch.cuda.empty_cache()
    if "c" in parts:
        mem, base = {}, None
        for level in ("dp", *P17_LEVELS):
            gc.collect()
            torch.cuda.empty_cache()
            m0 = torch.cuda.memory_allocated()
            model, opt = p17_model(torch, dev, SHARD_DEPTH, seed, sr=False)
            if level == "dp":
                wrapped = D.DataParallel(model)
            else:
                wrapped, opt, _ = D.group_sharded_parallel(model, opt, level)
            torch.cuda.reset_peak_memory_stats()
            row = {"params": torch.cuda.memory_allocated() - m0, "ms": []}
            kernels.reset_launch_counts()
            for i in range(SHARD_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i == SHARD_STEPS - 1:
                    row["moments"] = (torch.cuda.memory_allocated() - m0
                                      - row["params"])
                    before = torch.cuda.memory_allocated()
                loss = wrapped.loss(x, y)
                loss.backward()
                if i == SHARD_STEPS - 1:
                    row["grads"] = torch.cuda.memory_allocated() - before
                del loss
                opt.step()
                opt.clear_grad()
                torch.cuda.synchronize()
                row["ms"].append((time.perf_counter() - t0) * 1e3)
            row["adamw"] = kernels.launch_counts()["fused_adamw"]
            row["peak"] = torch.cuda.max_memory_allocated() - m0
            whole = ([p.detach() for p in model.parameters()] if level == "dp"
                     else list(model._group_sharded.full_state().values()))
            if level == "dp":
                base = [t.clone() for t in whole]
                row["equal"] = True
            else:
                row["equal"] = all(torch.equal(a, b)
                                   for a, b in zip(whole, base))
            mem[level] = row
            del model, opt, wrapped, whole
        del base
        res["mem"] = mem
        dp_row = mem["dp"]
        for level in P17_LEVELS:
            row = mem[level]
            if not row["equal"]:
                failures.append(f"{level}: parameters after {SHARD_STEPS} "
                                "steps are not DataParallel's, bitwise")
            if row["adamw"] != SHARD_STEPS:
                failures.append(f"{level}: {row['adamw']} AdamW launches in "
                                f"{SHARD_STEPS} steps")
            halved = {"moments": True, "grads": level != "os",
                      "params": level == "p_g_os"}
            for what, should in halved.items():
                ratio = row[what] / dp_row[what]
                if (not HALF_BAND[0] <= ratio <= HALF_BAND[1] if should
                        else ratio < HALF_BAND[1]):
                    failures.append(f"{level}: {what} {row[what]} bytes, "
                                    f"{ratio:.3f} of DataParallel's (halved: "
                                    f"{should})")
    store = FileKVStore(str(Path(out) / "contract"))
    try:
        flight_recorder.contract(store, rank, world, deadline=120.0)
        res["contract"] = "agrees"
    except Exception as e:  # noqa: BLE001 - a gate: recorded as a failure
        res["contract"] = "mismatch"
        failures.append(f"collective contract: {str(e)[:400]}")


def collectives_phase(torch, np, dev, args, card):
    """Phase 17: the probes, then (a), then (b) and (c)."""
    import shutil
    import tempfile
    from pathlib import Path

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_p17_"))
    try:
        p17_probes(torch, np, args, card, tmp)
        twin_losses = dp_local_phase(torch, np, dev, args, card)
        gc.collect()
        torch.cuda.empty_cache()
        failures = dp_ranks(torch, np, args, card, twin_losses, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        fail("phase 17(b)-(c): " + "; ".join(failures))


# -- phase 18: tensor parallelism, recompute, sequence parallel ----------------
# __graft_entry__.py:170-243's mp half on the port: fleet.init(mp_degree=2),
# fleet.distributed_model (TensorParallel: every weight cut on its tp_axis,
# Megatron's collectives) and fleet.distributed_optimizer around the Llama
# step, ranks launched as phase 17(b)'s (gloo on cuda:0: NCCL refuses two
# ranks on one card). The weights are a serial run's, made in this process
# from --seed and carried into each rank's shards by utils.load_jax_params.
# (a) the flagship at full width and depth, B=4, S=2048, bf16, SR on, 3
# eager steps; (b) recompute on every decoder layer (SR off) and the SP
# pair at the flagship's MLP widths; (c) dp=2 x mp=2 on four ranks, 2
# layers, SR off, ClipGradByGlobalNorm through HybridParallelOptimizer.
TP_DEGREE, TP_STEPS = 2, 3
# (a), (c): each step's loss against the serial step's on the same weights
# and data, relative. Each row-parallel all-reduce adds two bf16-rounded
# partial products (1.5 bf16 ulps of 2**-8 per element at most, against the
# serial GEMM's 0.5); these errors are unbiased, and the loss, an f32 mean
# over 8192 tokens' cross entropies, averages them: one ulp of every logit
# (logits have a std of ~0.36 here) moves a token's loss by at most ~1.4e-3
# nats, ~1.6e-5 nats (1.5e-6 rel.) averaged with random signs. After a step
# the two runs' parameters also differ by one bf16 ulp where SR's bits
# differ (column shards draw other bits). The card measured 1.95e-5 rel.
# (a) and 3.7e-6 (c) over two calls: the estimate is ~13x low, as the
# rounding differences of 8 layers add up in the residual stream, not just
# at the logits. 2e-4 is ~10x the measured worst: a loss of ~10.4 nats
# sits ~0.065 nats above ln 32000, so a looser band would hide a sizeable
# share of the model's whole signal (wrong kv heads, say); the first
# step's gradients below hold the numbers element by element
TP_LOSS_REL = 2e-4
# (a): the first step's gradients, gathered over mp, against the serial
# step's on the same weights and data: the worst over the 75 parameters of
# |g - g_serial| / |g_serial| (f32 norms). Reasoned before the first card
# call: both are bf16 (rounding ~1e-3 rms rel. each); the TP run adds a
# bf16 rounding of two partial sums at each of the 16 forward all-reduces
# and 17 backward ones, each ~1e-3 rms rel. of the signal it carries;
# independent, they add to ~sqrt(33) * 1e-3 ~ 6e-3 (gate then 3e-2). The
# card measured 2.33e-2, the same in every call: that estimate took no
# worst-of-75 factor and too small an error per rounding (three bf16
# roundings against one, ~1.6e-3 rms). 0.1 is ~4x the measured worst and
# 10x below the nearest fault gate_mutants.py shows (0.98: a column layer
# whose backward skips its all-reduce; a head paired with the next kv
# head 1.42, a row layer that skips its all-reduce 1.61)
TP_GRAD_REL = 0.1
TP_BYTES_BAND = (0.45, 0.55)  # (a): a rank's parameter bytes / serial's
# (a): ParallelCrossEntropy over the vocab-sharded logits against the plain
# cross entropy on the gathered logits, per token, in nats: the same f32
# maths but for the order of the sums of 32000 exponentials (~1e-6 of a
# ~10-nat loss)
PCE_ATOL = 1e-4
# (b): the SP pair's gathered output against the serial pair's on the
# gathered weights, norm-relative: the reduce-scatter adds two bf16 partials
# (as (a)'s all-reduce), ~1 bf16 ulp (2**-8) of each element at most
SP_REL = 1e-2
SP_SHAPE = (2048, TRAIN_BATCH, 2048)  # [s, b, h]
HYBRID_DEPTH, HYBRID_STEPS = 2, 2  # (c)
# (c): the clip's bound, below the gradients' global norm at these steps
# (0.6068 in the first card run), so the clip scales every gradient
TP_CLIP_NORM = 0.5
# (c): the clip's global norm against one computed from the same
# gradients gathered whole (f32 sums in another order), relative; and
# against the serial step's norm (other bf16 gradients; 9.7e-6 in the
# first card run), relative
CLIP_SAME_REL, CLIP_SERIAL_REL = 1e-4, 1e-3
P18_RANK_TIMEOUT_S = 600
# (e): TensorParallel on GPT (GPT-3-13B's widths at P18E_GPT_DEPTH layers)
# and BERT-base (full depth) in f32, each rank's serial model built from
# the same seed as its TP model: the TP forward against the serial one on
# the same weights, each rank's shards against the serial tensors' slices. Reasoned before the first card call: both run f32
# GEMMs with TF32 off; TP splits each row layer's sum into two halves
# added by the all-reduce, and the loss's logsumexp over two vocabulary
# shards: reorderings of f32 sums, ~1e-6 relative. Gates at 1e-4 (loss
# rel) and 1e-4 (logits and the gathered qkv gradients, norm-relative):
# ~100x that, and far below a wrong cut (a rank holding all of q and half
# of k mixes heads: an error of the logits' own size)
P18E_GPT_DEPTH = 2
P18E_GPT_BATCH, P18E_GPT_SEQ = 1, 1024
P18E_BERT_BATCH, P18E_BERT_SEQ = 4, 512
P18E_LOSS_REL, P18E_REL = 1e-4, 1e-4


def p18_model(torch, dev, depth, seed, sr, clip=None):
    """The flagship's model and optimizer (``bench.py``'s AdamW, with
    ``ClipGradByGlobalNorm(clip)`` where given) at ``depth`` layers, from
    ``seed``."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    pt_seed(seed)
    cfg = LlamaConfig(**dict(LLAMA_542M, max_position_embeddings=2048,
                             num_hidden_layers=depth))
    m = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    o = AdamW(learning_rate=TRAIN_LR, parameters=m.parameters(),
              moment_dtype="bfloat16", use_stochastic_rounding=sr, fused=True,
              grad_clip=None if clip is None else ClipGradByGlobalNorm(clip))
    return m, o


def tp_serial(torch, np, dev, args, depth, steps, sr, clip, path,
              save_grads=False):
    """One process's steps on the global batch, the weights saved to
    ``path`` first (and with ``save_grads`` the first step's gradients to
    :func:`grads_path`): returns the losses and (with ``clip``) the global
    norms."""
    model, opt = p18_model(torch, dev, depth, args.seed, sr, clip)
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
               path)
    ids, labels = p17_batch(torch, np, dev, args.seed)
    losses, norms = [], []
    for i in range(steps):
        loss = model.loss(ids, labels)
        loss.backward()
        if save_grads and i == 0:
            torch.save({n: p.grad.cpu() for n, p in model.named_parameters()},
                       grads_path(path))
        if clip is not None:
            pg = [(p, p.grad) for p in model.parameters() if p.grad is not None]
            norms.append(float(opt._grad_clip.global_norm(pg)))
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return losses, norms


def grads_path(path):
    """Where :func:`tp_serial` saves the first step's gradients."""
    return path.with_name(path.stem + "_grads.pt")


def tp_phase(torch, np, dev, args, card, tmp):
    """Phase 18: the serial runs here, then (a)+(b) in two launched ranks
    and (c) in four. The serial run of (a) stays in ``tmp`` (weights and
    first-step gradients) for phase 19; returns its losses."""
    serial_a, _ = tp_serial(torch, np, dev, args,
                            LLAMA_542M["num_hidden_layers"], TP_STEPS,
                            True, None, tmp / "serial_a.pt",
                            save_grads=True)
    serial_c, norms_c = tp_serial(torch, np, dev, args, HYBRID_DEPTH,
                                  HYBRID_STEPS, False, TP_CLIP_NORM,
                                  tmp / "serial_c.pt")
    failures = tp_ranks(torch, np, args, card, serial_a, tmp, parts="abe")
    failures += hybrid_ranks(torch, np, args, card, serial_c, norms_c, tmp)
    if failures:
        fail("phase 18: " + "; ".join(failures))
    return serial_a


def _rel(a, b):
    return abs(a - b) / abs(b)


def tp_ranks(torch, np, args, card, serial, tmp, script=None, extra=(),
             parts="ab"):
    """18(a) and (b) through the launcher (two ranks); returns the
    failures. ``serial``: the serial step's losses (None: not held)."""
    out = tmp / f"tp-{parts}"
    out.mkdir()
    for f in ("serial_a.pt", "serial_a_grads.pt"):
        (out / f).symlink_to((tmp / f).resolve())
    rc, logs = launch_ranks("tp", out, args, script=script,
                            extra=("--parts", parts, *extra),
                            timeout=P18_RANK_TIMEOUT_S)
    if rc != 0:
        return [f"the two-rank TP launch exited {rc}:\n{logs}"]
    ranks = rank_results(out)
    failures = [f"rank {r}: {f}" for r, res in enumerate(ranks)
                for f in res["failures"]]
    if "a" in parts:
        r0 = ranks[0]
        losses = r0["losses"]
        if ranks[1]["losses"] != losses:
            failures.append(f"the ranks' losses differ: {losses} | "
                            f"{ranks[1]['losses']}")
        rel = [_rel(a, b) for a, b in zip(losses, serial or [])]
        if serial and max(rel) > TP_LOSS_REL:
            failures.append(f"losses {losses} are {max(rel):.3g} from the "
                            f"serial step's {serial} (tol {TP_LOSS_REL})")
        print(f"phase 18(a) TensorParallel(Llama-542M) at mp={TP_DEGREE}, two "
              f"gloo ranks on the one card, B={TRAIN_BATCH} S={TRAIN_SEQ} bf16 "
              f"SR on, {len(losses)} eager steps: losses "
              f"{[round(x, 6) for x in losses]} against the serial step's "
              f"{[round(x, 6) for x in serial or []]} (worst rel "
              f"{max(rel) if rel else float('nan'):.3g}, tol {TP_LOSS_REL}); "
              f"the first step's gradients, gathered, against the serial "
              f"step's: worst norm-rel {[r['grad_rel'] for r in ranks]} at "
              f"{[r['grad_worst'] for r in ranks]} (tol {TP_GRAD_REL}); "
              f"launches per rank {[r['counts'] for r in ranks]}; "
              f"ParallelCrossEntropy against the plain one on the gathered "
              f"logits {[r['pce_err'] for r in ranks]} nats (tol {PCE_ATOL});"
              f" shards "
              f"loaded bitwise the serial weights {[r['loaded'] for r in ranks]}"
              f"; the rank's first forward (cold) ms "
              f"{[round(r['first_fwd_ms'], 1) for r in ranks]}"
              f"; norms bitwise equal across ranks after each step "
              f"{r0['repl_equal']}; parameter bytes "
              f"{[round(r['bytes_ratio'], 4) for r in ranks]} of the serial "
              f"model's; collective contract {[r['contract'] for r in ranks]}"
              f" [{card}]")
        print(f"phase 18(a) per rank: ms a step "
              f"{[[round(t, 1) for t in r['ms']] for r in ranks]}, tokens/s "
              f"{[round(TRAIN_BATCH * TRAIN_SEQ / (min(r['ms']) / 1e3)) for r in ranks]}"
              f", peak memory GB {[r['peak_gb'] for r in ranks]}; a step's "
              f"collectives {r0['coll_step']}; bytes staged through host a "
              f"step {r0['staged_step']}; alone: " + "; ".join(
                  f"{k} {v[0]:.2f} ms {v[1]:.2f} GB/s staged {v[2]}"
                  for k, v in r0["coll_times"].items()) + f" [{card}]")
    if "b" in parts:
        r0 = ranks[0]
        print(f"phase 18(b) recompute on all {LLAMA_542M['num_hidden_layers']}"
              f" layers at mp={TP_DEGREE}, SR off: the first step's gradients "
              f"bitwise the step's without recompute "
              f"{[r['rc_equal'] for r in ranks]}, loss equal "
              f"{[r['rc_loss_equal'] for r in ranks]}; launches per rank "
              f"{[r['rc_counts'] for r in ranks]}; peak GB with / without "
              f"recompute {[(r['rc_peak_gb'], r['plain_peak_gb']) for r in ranks]}"
              f"; ms fwd+bwd with / without "
              f"{[(round(r['rc_ms'], 1), round(r['plain_ms'], 1)) for r in ranks]}"
              f" [{card}]")
        print(f"phase 18(b) SP pair {SP_SHAPE[2]} -> "
              f"{LLAMA_542M['intermediate_size']} -> {SP_SHAPE[2]} on "
              f"{list(SP_SHAPE)} bf16: gathered output against the serial "
              f"pair's norm-rel {[r['sp_rel'] for r in ranks]} (tol {SP_REL}),"
              f" the row bias's gradient bitwise equal across ranks after the "
              f"hooks {r0['sp_bias_equal']}, ms fwd+bwd "
              f"{[round(r['sp_ms'], 1) for r in ranks]}, staged bytes "
              f"{r0['sp_staged']} [{card}]")
    if "e" in parts:
        shapes = {"GPT": f"GPT-3-13B widths at {P18E_GPT_DEPTH} layers, "
                         f"B={P18E_GPT_BATCH} S={P18E_GPT_SEQ}",
                  "BERT": f"BERT-base, 12 layers, MLM B={P18E_BERT_BATCH} "
                          f"S={P18E_BERT_SEQ}"}
        for name, shape in shapes.items():
            rows = [r["qkv_tp"][name] for r in ranks]

            def col(key):
                return [float(f"{r[key]:.3g}") for r in rows]

            print(f"phase 18(e) TensorParallel({name}) at mp={TP_DEGREE} in "
                  f"f32 ({shape}) against the serial model on the same "
                  f"weights: local heads {[r['local_heads'] for r in rows]}; "
                  f"loss (TP, serial) {[r['loss'] for r in rows]} rel "
                  f"{col('loss_rel')} (tol {P18E_LOSS_REL}); the rank's "
                  f"logits shard against the serial slice norm-rel "
                  f"{col('logits_rel')}, every layer's qkv gradient shard "
                  f"(weight and bias) against the serial slice of whole "
                  f"heads of q, k and v worst norm-rel {col('qkv_rel')} "
                  f"(tol {P18E_REL}) [{card}]")
        print(f"phase 18(e) took {[round(r['qkv_tp_s'], 1) for r in ranks]} s "
              f"in the ranks [{card}]")
    return failures


def hybrid_ranks(torch, np, args, card, serial, serial_norms, tmp,
                 script=None, extra=()):
    """18(c) through the launcher (four ranks); returns the failures."""
    out = tmp / "hybrid"
    out.mkdir()
    (out / "serial_c.pt").symlink_to((tmp / "serial_c.pt").resolve())
    rc, logs = launch_ranks("hybrid", out, args, script=script, extra=extra,
                            nproc=4, timeout=P18_RANK_TIMEOUT_S)
    if rc != 0:
        return [f"the four-rank launch exited {rc}:\n{logs}"]
    ranks = rank_results(out, 4)
    failures = [f"rank {r}: {f}" for r, res in enumerate(ranks)
                for f in res["failures"]]
    # the global loss: the mean of the dp ranks' (mp peers agree)
    losses = [float(np.mean(x)) for x in zip(ranks[0]["losses"],
                                             ranks[2]["losses"])]
    rel = [_rel(a, b) for a, b in zip(losses, serial or [])]
    if serial and max(rel) > TP_LOSS_REL:
        failures.append(f"(c) losses {losses} are {max(rel):.3g} from the "
                        f"serial step's {serial} (tol {TP_LOSS_REL})")
    norms = ranks[0]["norms"]
    nrel = [_rel(a, b) for a, b in zip(norms, serial_norms or [])]
    scales = ranks[0]["scales"]
    serial_scales = [min(1.0, TP_CLIP_NORM / n) for n in serial_norms or []]
    if not all(s < 1.0 for s in scales):
        failures.append(f"(c) the clip did not scale: factors {scales}")
    if serial_norms and max(nrel) > CLIP_SERIAL_REL:
        failures.append(f"(c) clip norms {norms} are {max(nrel):.3g} from the "
                        f"serial step's {serial_norms} (tol {CLIP_SERIAL_REL})")
    print(f"phase 18(c) dp=2 x mp=2, four gloo ranks on the one card, "
          f"Llama-542M at {HYBRID_DEPTH} layers, SR off, ClipGradByGlobalNorm"
          f"({TP_CLIP_NORM}) through HybridParallelOptimizer, "
          f"{HYBRID_STEPS} steps: groups as get_comm_list gives "
          f"{[r['groups_ok'] for r in ranks]}; losses "
          f"{[round(x, 6) for x in losses]} against the serial step's "
          f"{[round(x, 6) for x in serial or []]} (worst rel "
          f"{max(rel) if rel else float('nan'):.3g}); clip norms {norms} "
          f"(factors {scales}, the serial step's {serial_scales}) against "
          f"the serial "
          f"{serial_norms} (worst rel {max(nrel) if nrel else float('nan'):.3g}"
          f", tol {CLIP_SERIAL_REL}) and the gathered gradients' "
          f"{ranks[0]['whole_norms']} (tol {CLIP_SAME_REL}); shards bitwise "
          f"across dp peers, norms across all four "
          f"{[r['bitwise'] for r in ranks]}; ms a step "
          f"{[[round(t, 1) for t in r['ms']] for r in ranks]} (forward, "
          f"backward, optimizer: {[r['split'] for r in ranks]}), peak GB "
          f"{[r['peak_gb'] for r in ranks]} [{card}]")
    return failures


def p18_arrays(torch, path):
    """The serial run's weights as f32 numpy (bf16 values exactly)."""
    sd = torch.load(path)
    return {n: t.float().numpy() for n, t in sd.items()}


def tp_axis(p):
    """A parameter's shard dimension (None where it is replicated)."""
    return p.tp_axis if getattr(p, "is_distributed", False) else None


def tp_gather(torch, D, t, axis, group):
    """``t`` whole: gathered over ``group`` along ``axis`` (None: ``t``
    itself)."""
    if axis is None:
        return t.detach()
    shape = list(t.shape)
    shape[axis] *= group.nranks
    whole = torch.empty(shape, dtype=t.dtype, device=t.device)
    D.all_gather_into_tensor(whole, t.detach().contiguous(), group=group,
                             axis=axis)
    return whole


def grads_rel(torch, D, params, path, group):
    """The worst over ``params`` (name, parameter) of |g - g_serial| /
    |g_serial|, each gradient gathered over ``group`` whole, against the
    serial step's saved at ``path``: (value, the parameter's name)."""
    serial = torch.load(path)
    worst, name = 0.0, None
    for n, p in params:
        whole = tp_gather(torch, D, p.grad, tp_axis(p), group).float()
        want = serial.pop(n).to(whole.device).float()
        rel = float((whole - want).norm() / want.norm())
        if not rel <= worst:  # a NaN is the worst
            worst, name = rel, n
    return worst, name


def all_true(D, flag: bool) -> bool:
    flags = []
    D.all_gather_object(flags, bool(flag))
    return all(flags)


def equal_across(torch, D, tensors, group) -> bool:
    """Whether every tensor is bitwise the group's first rank's (on every
    rank of ``group``)."""
    ok = True
    for t in tensors:
        buf = t.detach().clone()
        D.broadcast(buf, src=group.ranks[0], group=group)
        ok &= bool(torch.equal(buf, t))
    return ok


def coll_stats(seq0):
    """{op: [count, MB]} of the collectives recorded after ``seq0``."""
    from paddle_tpu_torch.distributed.communication import flight_recorder

    sizes = {"bfloat16": 2, "float32": 4, "float16": 2, "int64": 8}
    out = {}
    for s in flight_recorder.recorder().snapshot():
        if s.seq <= seq0:
            continue
        n = 1
        for d in s.shape:
            n *= d
        row = out.setdefault(s.op, [0, 0.0])
        row[0] += 1
        row[1] = round(row[1] + n * sizes.get(s.dtype, 4) / 1e6, 3)
    return out


def recorder_seq():
    from paddle_tpu_torch.distributed.communication import flight_recorder

    snap = flight_recorder.recorder().snapshot()
    return snap[-1].seq if snap else 0


def tp_rank(torch, np, D, rank, dev, seed, parts, res, out, steps=None):
    """18(a) and (b) on this rank; appends to ``res['failures']``."""
    import functools
    from pathlib import Path

    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.communication import flight_recorder
    from paddle_tpu_torch.distributed.fleet.layers.mpu import \
        ParallelCrossEntropy
    from paddle_tpu_torch.distributed.fleet.utils.recompute import recompute
    from paddle_tpu_torch.distributed.store import FileKVStore
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.utils import load_jax_params

    failures = res["failures"]
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": TP_DEGREE}
    hcg = fleet.init(strategy=strategy)
    g = hcg.get_model_parallel_group()
    L = LLAMA_542M["num_hidden_layers"]
    ids, labels = p17_batch(torch, np, dev, seed)
    if "a" in parts or "b" in parts:  # (e) builds its own serial models
        arrays = p18_arrays(torch, Path(out) / "serial_a.pt")
        serial_bytes = sum(a.size * 2 for a in arrays.values())

    def tp_model(sr):
        model, opt = p18_model(torch, dev, L, seed, sr)
        tp = fleet.distributed_model(model)
        load_jax_params(model, arrays)
        return model, tp, fleet.distributed_optimizer(opt)

    if "a" in parts:
        n_steps = steps or TP_STEPS
        model, tp, opt = tp_model(True)
        params = list(model.named_parameters())
        res["loaded"] = all(
            torch.equal(tp_gather(torch, D, p, tp_axis(p), g),
                        torch.from_numpy(arrays[n]).to(dev, p.dtype))
            for n, p in params)
        if not res["loaded"]:
            failures.append("the shards, gathered, are not the serial weights")
        res["bytes_ratio"] = sum(p.numel() * p.element_size()
                                 for _, p in params) / serial_bytes
        if not TP_BYTES_BAND[0] <= res["bytes_ratio"] <= TP_BYTES_BAND[1]:
            failures.append(f"parameter bytes {res['bytes_ratio']:.4f} of the "
                            f"serial model's (band {TP_BYTES_BAND})")
        repl = [p for _, p in params if not p.is_distributed]
        # the vocab-sharded cross entropy against the plain one on the
        # gathered logits, per token (the rank's first forward: timed)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            shard = tp(ids)
            torch.cuda.synchronize()
            res["first_fwd_ms"] = (time.perf_counter() - t0) * 1e3
            v = shard.shape[-1]
            mine = ParallelCrossEntropy(g)(shard.reshape(-1, v),
                                           labels.reshape(-1))
            whole = tp_gather(torch, D, shard, 2, g)
            plain = F.cross_entropy(whole.reshape(-1, TP_DEGREE * v),
                                    labels.reshape(-1), reduction="none")
            res["pce_err"] = float((mine - plain).abs().max())
            del shard, mine, whole, plain
        if not res["pce_err"] <= PCE_ATOL:
            failures.append(f"ParallelCrossEntropy is {res['pce_err']:.3g} "
                            f"nats from the plain cross entropy on the "
                            f"gathered logits (tol {PCE_ATOL})")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, ms, equal = [], [], []
        for i in range(n_steps):
            if i == n_steps - 1:
                seq0 = recorder_seq()
                C.reset_staged_bytes()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = tp.loss(ids, labels)
            loss.backward()
            if i == 0:  # held against the serial step's, off the clock
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                res["grad_rel"], res["grad_worst"] = grads_rel(
                    torch, D, params, Path(out) / "serial_a_grads.pt", g)
                t0 += time.perf_counter() - t1
                if not res["grad_rel"] <= TP_GRAD_REL:
                    failures.append(
                        f"the first step's gradients are {res['grad_rel']:.3g}"
                        f" (norm-rel., {res['grad_worst']}) from the serial "
                        f"step's (tol {TP_GRAD_REL})")
            opt.step()
            opt.clear_grad()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.detach()))
            if i == n_steps - 1:
                res["coll_step"] = coll_stats(seq0)
                res["staged_step"] = C.staged_bytes()
            equal.append(all_true(D, equal_across(torch, D, repl, g)))
        counts = kernels.launch_counts()
        want = {**flash_fwd_counts(L * n_steps), **flash_bwd_counts(L * n_steps),
                "fused_adamw": ADAMW_GROUPS * n_steps}
        res["counts"] = step_launches(counts)
        got = {k: counts.get(k, 0) for k in want}
        if got != want:
            failures.append(f"launches {got} != {want}")
        res["losses"], res["ms"], res["repl_equal"] = losses, ms, equal
        res["peak_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
        if not all(equal):
            failures.append(f"the replicated parameters differ across ranks "
                            f"after steps {[i for i, e in enumerate(equal) if not e]}")
        res["coll_times"] = time_tp_collectives(torch, D, dev, g)
        del model, tp, opt, params, repl, loss
        gc.collect()
        torch.cuda.empty_cache()
    if "b" in parts:
        model, tp, opt = tp_model(False)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss0 = tp.loss(ids, labels)
        loss0.backward()
        torch.cuda.synchronize()
        res["plain_ms"] = (time.perf_counter() - t0) * 1e3
        res["plain_peak_gb"] = round((torch.cuda.max_memory_allocated() - base)
                                     / 1e9, 3)
        grads = [p.grad.clone() for p in model.parameters()]
        opt.clear_grad()
        for layer in model.llama.layers:
            layer.forward = functools.partial(recompute, layer.forward)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss1 = tp.loss(ids, labels)
        loss1.backward()
        torch.cuda.synchronize()
        res["rc_ms"] = (time.perf_counter() - t0) * 1e3
        res["rc_peak_gb"] = round((torch.cuda.max_memory_allocated() - base)
                                  / 1e9, 3)
        res["rc_equal"] = all(torch.equal(p.grad, q) for p, q in
                              zip(model.parameters(), grads))
        res["rc_loss_equal"] = bool(torch.equal(loss0.detach(), loss1.detach()))
        opt.step()
        opt.clear_grad()
        counts = kernels.launch_counts()
        want = {**flash_fwd_counts(2 * L), **flash_bwd_counts(L),
                "fused_adamw": ADAMW_GROUPS}
        res["rc_counts"] = step_launches(counts)
        got = {k: counts.get(k, 0) for k in want}
        if got != want:
            failures.append(f"(b) launches {got} != {want}")
        if not res["rc_equal"] or not res["rc_loss_equal"]:
            failures.append("(b) the recomputed step's gradients or loss are "
                            "not bitwise the step's without recompute")
        if not res["rc_peak_gb"] < res["plain_peak_gb"]:
            failures.append(f"(b) peak {res['rc_peak_gb']} GB with recompute, "
                            f"{res['plain_peak_gb']} GB without")
        del model, tp, opt, grads, loss0, loss1
        gc.collect()
        torch.cuda.empty_cache()
        sp_pair(torch, D, dev, seed, g, res)
    if "e" in parts:
        qkv_tp_check(torch, np, dev, seed, g, res)
    store = FileKVStore(str(Path(out) / "contract"))
    try:
        flight_recorder.contract(store, rank, D.get_world_size(),
                                 deadline=120.0)
        res["contract"] = "agrees"
    except Exception as e:  # noqa: BLE001 - a gate: recorded as a failure
        res["contract"] = "mismatch"
        failures.append(f"collective contract: {str(e)[:400]}")


def qkv_slice(t, rank: int, n: int, axis: int):
    """Rank ``rank`` of ``n``'s part of a whole fused qkv tensor ``t`` (or
    its gradient) along ``axis``: whole heads of each of q, k and v, side
    by side (written here apart from ``fleet``'s own cut)."""
    parts = t.unflatten(axis, (3, n, -1)).select(axis + 1, rank)
    return parts.flatten(axis, axis + 1)


def qkv_tp_check(torch, np, dev, seed, g, res):
    """18(e): ``TensorParallel`` on GPT (GPT-3-13B's widths) and BERT-base
    against the serial model on the same weights, built on each rank: the
    rank's vocabulary shard of the logits against the serial logits'
    slice, the loss through the vocab-sharded head, every layer's qkv
    gradient shard (weight and bias) against the serial gradient's slice
    of whole heads of q, k and v. Nothing large crosses gloo. Appends to
    ``res['failures']``."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                         GPTConfig, GPTForCausalLM)

    t_part = time.perf_counter()
    rs = np.random.RandomState(seed + 18)
    gcfg = GPTConfig.gpt3_13b(num_hidden_layers=P18E_GPT_DEPTH)
    gids = rs.randint(0, gcfg.vocab_size, (P18E_GPT_BATCH, P18E_GPT_SEQ))
    bcfg = BertConfig.base()
    bids = rs.randint(0, bcfg.vocab_size, (P18E_BERT_BATCH, P18E_BERT_SEQ))
    blabels = np.where(rs.rand(*bids.shape) < P21_BERT_MASKED, bids, -100)
    cases = (
        ("GPT", lambda: GPTForCausalLM(gcfg, device=dev),
         lambda m: [b.attn.qkv_proj for b in m.transformer.h],
         gids, np.roll(gids, -1, axis=1)),
        ("BERT", lambda: BertForMaskedLM(bcfg, device=dev),
         lambda m: [layer.qkv for layer in m.bert.encoder], bids, blabels))
    out = {}
    for name, build, qkvs, ids, labels in cases:
        ids = torch.from_numpy(ids).to(dev)
        labels = torch.from_numpy(labels).to(dev)
        pt_seed(seed)
        serial = build()
        with torch.no_grad():
            want_logits = serial(ids)
        loss = serial.loss(ids, labels)
        loss.backward()
        want_loss = float(loss.detach())
        want_qkv = [(q.weight.grad.clone(), q.bias.grad.clone())
                    for q in qkvs(serial)]
        del serial, loss
        gc.collect()
        torch.cuda.empty_cache()
        pt_seed(seed)
        model = build()
        tp = fleet.distributed_model(model)
        head_dim = gcfg.hidden_size // gcfg.num_attention_heads \
            if name == "GPT" else bcfg.hidden_size // bcfg.num_attention_heads
        heads = qkvs(model)[0].weight.shape[1] // (3 * head_dim)
        with torch.no_grad():
            logits = tp(ids)
        v = logits.shape[-1]
        want_logits = want_logits[..., g.rank * v:(g.rank + 1) * v]
        loss = tp.loss(ids, labels)
        loss.backward()
        got_loss = float(loss.detach())
        qkv_rel = 0.0
        for q, (wg, bg) in zip(qkvs(model), want_qkv):
            for p, want in ((q.weight, wg), (q.bias, bg)):
                want = qkv_slice(want, g.rank, g.nranks, p.dim() - 1)
                rel = rel_err(p.grad, want)
                qkv_rel = rel if not rel <= qkv_rel else qkv_rel
        row = dict(loss=(got_loss, want_loss),
                   loss_rel=abs(got_loss - want_loss) / abs(want_loss),
                   logits_rel=rel_err(logits, want_logits), qkv_rel=qkv_rel,
                   local_heads=heads)
        out[name] = row
        if not (row["loss_rel"] <= P18E_LOSS_REL
                and row["logits_rel"] <= P18E_REL
                and row["qkv_rel"] <= P18E_REL
                and heads * g.nranks == model.config.num_attention_heads):
            res["failures"].append(
                f"(e) {name} at mp={g.nranks} against serial: {row} (tol "
                f"loss {P18E_LOSS_REL}, logits and qkv gradients "
                f"{P18E_REL})")
        del model, tp, logits, loss, want_logits, want_qkv
        gc.collect()
        torch.cuda.empty_cache()
    res["qkv_tp"] = out
    res["qkv_tp_s"] = time.perf_counter() - t_part


def time_tp_collectives(torch, D, dev, g):
    """Wall ms (synchronized) of the TP step's two collectives at their
    shapes on the mp group: a row layer's all-reduce of ``[B, S, h]`` bf16
    and the embedding's all-gather of ``[B, S, h/mp]`` along h. Reported."""
    from paddle_tpu_torch.distributed import communication as C

    h = LLAMA_542M["hidden_size"]
    x = torch.ones(TRAIN_BATCH, TRAIN_SEQ, h, dtype=torch.bfloat16, device=dev)
    part = torch.ones(TRAIN_BATCH, TRAIN_SEQ, h // g.nranks,
                      dtype=torch.bfloat16, device=dev)
    calls = {"all_reduce": lambda: D.all_reduce(x, group=g),
             "all_gather_into_tensor(axis=2)": lambda: D.all_gather_into_tensor(
                 x, part, group=g, axis=2)}
    rows = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        C.reset_staged_bytes()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows[name] = (ms, x.numel() * 2 / ms / 1e6,
                      sum(C.staged_bytes().values()))
    return rows


def sp_pair(torch, D, dev, seed, g, res):
    """18(b)'s SP pair on this rank: the sequence-sharded input through
    ``ColumnSequenceParallelLinear`` and ``RowSequenceParallelLinear``, the
    output gathered and held against the serial pair on the gathered
    weights; the row bias's gradient after the hooks."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed.fleet.utils import \
        sequence_parallel_utils as SP

    failures = res["failures"]
    pt_seed(seed)
    h, f = SP_SHAPE[2], LLAMA_542M["intermediate_size"]
    col = SP.ColumnSequenceParallelLinear(h, f, has_bias=False, device=dev,
                                          dtype=torch.bfloat16)
    row = SP.RowSequenceParallelLinear(f, h, has_bias=True, device=dev,
                                       dtype=torch.bfloat16)
    with torch.no_grad():
        row.bias.normal_(0.0, 0.02, generator=torch.Generator(dev).manual_seed(seed))
    pair = torch.nn.Sequential(col, row)
    SP.register_sequence_parallel_allreduce_hooks(pair)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    x = torch.randn(SP_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
    c = torch.randn(SP_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
    C.reset_staged_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = SP.GatherOp.apply(pair(SP.ScatterOp.apply(x, g)), g)
    (y.float() * c.float()).sum().backward()
    torch.cuda.synchronize()
    res["sp_ms"] = (time.perf_counter() - t0) * 1e3
    res["sp_staged"] = C.staged_bytes()
    with torch.no_grad():
        wc = tp_gather(torch, D, col.weight, 1, g)
        wr = tp_gather(torch, D, row.weight, 0, g)
        want = torch.matmul(torch.matmul(x, wc), wr) + row.bias
        res["sp_rel"] = float((y.float() - want.float()).norm()
                              / want.float().norm())
    if not res["sp_rel"] <= SP_REL:
        failures.append(f"(b) SP pair norm-rel {res['sp_rel']:.3g} > {SP_REL}")
    res["sp_bias_equal"] = all_true(D, equal_across(torch, D, [row.bias.grad], g))
    if not res["sp_bias_equal"]:
        failures.append("(b) the row bias's gradient differs across ranks "
                        "after the hooks")


def hybrid_rank(torch, np, D, rank, dev, seed, res, out):
    """18(c) on this rank: dp=2 x mp=2 at HYBRID_DEPTH layers."""
    from pathlib import Path

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import kernels  # noqa: F401  (built by the parent)
    from paddle_tpu_torch.utils import load_jax_params

    failures = res["failures"]
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": TP_DEGREE}
    hcg = fleet.init(strategy=strategy)
    topo = hcg.topology()
    dp_g, mp_g = hcg.get_data_parallel_group(), hcg.get_model_parallel_group()
    res["groups_ok"] = (
        dp_g.ranks == next(x for x in topo.get_comm_list("dp") if rank in x)
        and mp_g.ranks == next(x for x in topo.get_comm_list("mp") if rank in x))
    if not res["groups_ok"]:
        failures.append(f"groups dp {dp_g.ranks} mp {mp_g.ranks} are not "
                        "get_comm_list's")
    arrays = p18_arrays(torch, Path(out) / "serial_c.pt")
    model, opt = p18_model(torch, dev, HYBRID_DEPTH, seed, False, TP_CLIP_NORM)
    tp = fleet.distributed_model(model)
    load_jax_params(model, arrays)
    opt = fleet.distributed_optimizer(opt)
    clip = opt._inner_opt._grad_clip
    ids, labels = p17_batch(torch, np, dev, seed)
    b = TRAIN_BATCH // 2
    r = hcg.get_data_parallel_rank()
    x, y = ids[r * b:(r + 1) * b], labels[r * b:(r + 1) * b]
    params = list(model.parameters())
    torch.cuda.reset_peak_memory_stats()
    losses, norms, scales, whole, ms, bitwise = [], [], [], [], [], []
    split = []  # (forward, backward, optimizer) ms of each step
    for _ in range(HYBRID_STEPS):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        loss = tp.loss(x, y)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        opt.step()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ms.append((t[3] - t[0]) * 1e3)
        split.append([round((b - a) * 1e3, 1) for a, b in zip(t, t[1:])])
        losses.append(float(loss.detach()))
        norms.append(float(clip.last_global_norm))
        scales.append(float(clip.last_scale))
        # the same (dp-averaged) gradients whole: their f32 global norm
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for p in params:
            g = tp_gather(torch, D, p.grad, tp_axis(p), mp_g)
            sq = sq + g.float().square().sum()
        whole.append(float(torch.sqrt(sq)))
        opt.clear_grad()
        shards = [p for p in params if p.is_distributed]
        repl = [p for p in params if not p.is_distributed]
        world = D.collective._get_global_group()
        bitwise.append(all_true(D, equal_across(torch, D, shards, dp_g)
                                and equal_across(torch, D, repl, world)))
    res.update(losses=losses, norms=norms, scales=scales, whole_norms=whole,
               ms=ms, split=split, bitwise=bitwise,
               peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    if not all(bitwise):
        failures.append(f"(c) shards across dp peers or norms across ranks "
                        f"not bitwise equal: {bitwise}")
    gathered = []
    D.all_gather_object(gathered, scales)
    if any(s != scales for s in gathered):
        failures.append(f"(c) the clip factors differ across ranks: {gathered}")
    bad = [(a, b) for a, b in zip(norms, whole) if _rel(a, b) > CLIP_SAME_REL]
    if bad:
        failures.append(f"(c) the clip's global norms {norms} are not the "
                        f"gathered gradients' {whole} (tol {CLIP_SAME_REL})")


# -- phase 19: the pipeline, ring attention and sep, MoE and ep ----------------
# __graft_entry__.py's pp, sep and ep axes on the port, launched as phase
# 18's ranks (gloo on cuda:0). (a) The flagship (8 layers, full width) as a
# PipelineLayer([embedding, 8 x LayerDesc(decoder), norm, head]) at pp=2
# through fleet.distributed_model (PipelineParallel: point-to-point sends
# between the two stages), accumulate_steps 4, B=4, S=2048, bench.py's
# AdamW (bf16, SR on), 3 steps at V=1 then 3 at V=2, each from phase 18's
# serial weights, against 18(a)'s serial steps on the same weights and
# data; (b) ring attention at sep=2 (S=2048, 1024 a rank) against plain f32
# attention over the whole sequence, and a SegmentParallel step of the
# reference tests' attention block at width 2048; (c) MoE at ep=2 in both
# dispatch modes against the serial layer; (d) dp=2 x pp=2 in four ranks at
# PP_DP_DEPTH layers with the clip over the stages.
PP_DEGREE, PP_MICRO = 2, 4
# (a): each step's loss against the serial step's, relative. The pipeline
# runs the serial model's bf16 ops on a microbatch of one sequence instead
# of four: the GEMMs see 2048 rows, not 8192 (cuBLAS may pick other tiles,
# so other f32 sums before the bf16 rounding, ~0.5 bf16 ulp where they
# differ), and each stage's weight gradients add four microbatches' bf16
# gradients. Between steps SR draws other bits (a stacked parameter's
# elements have other flat indices than the layers'). So the losses differ
# as 18(a)'s do, by rounding that averages over 8192 tokens: predicted
# ~1e-5 rel. (18(a) measured 1.95e-5 with the extra partial sums of TP). 2e-4
# is TP_LOSS_REL's reasoning: a looser band would hide a share of the
# model's ~0.065-nat signal above ln 32000
PP_LOSS_REL = 2e-4
# (a): the first step's gradients of each stage against the serial step's,
# the worst over the parameters of |g - g_serial| / |g_serial| (f32 norms,
# a stacked row held against its layer's). Predicted: the sum of four bf16
# microbatch gradients rounds three more times than the serial GEMM's one
# (~sqrt(3) * 2**-9 rms rel. ~3e-3), plus the GEMMs' other tiles (~1e-3):
# ~5e-3 at most; measured 3.6e-3 to 3.8e-3 on an H100 over three runs (the
# worst parameter a norm's weight, which sums all 8192 tokens' bf16
# products). 1.5e-2 is three times the predicted bound: a gradient path
# rounded to bf16 once more per microbatch stays under it, a partial
# gradient (a microbatch's output gradient sent as zeros moves a stage's
# gradients by a quarter or more) or an f16/fp8 path does not
PP_GRAD_REL = 1.5e-2
# (b): B, S, heads, head dim of the ring; the worst row of the output and
# of dq/dk/dv (bf16) against plain f32 attention over the whole sequence,
# norm-relative, each row's norm counted as at least RING_ROW_FLOOR of the
# RMS row norm. The ring is f32 from bf16 inputs and rounds once, to bf16:
# 2**-9 rel. per element, ~2e-3 a row; gate 1e-2
RING_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 16, 128)
RING_ROW_REL, RING_ROW_FLOOR = 1e-2, 0.1
# (b): the SegmentParallel step of the attention block (width 2048, 16
# heads, bf16, SGD) against the serial block's (plain attention through the
# flash kernels): each parameter's gradient, norm-relative (a bf16
# parameter's update is too coarse to compare). The two attentions differ
# by the flash kernel's bf16 P (2**-9 rel.) against the ring's f32:
# predicted ~5e-3, measured 3.84e-3 on an H100; gate 1.5e-2, three times
# the prediction
SEP_WIDTH, SEP_HEADS, SEP_LR, SEP_REL = 2048, 16, 0.1, 1.5e-2
# (c): benchmarks/moe_bench.py's sizing: top-2 at the dense FFN's FLOPs
# (d_hidden half of 5632), over B*S = 8192 tokens, bf16. The ep layer runs
# the serial layer's ops on its half of the experts and gathers them: its
# output and gradients against the serial layer's, norm-relative, 1e-5.
# With top_k <= 2 a token's two slots add in one order whatever the
# atomics' order, and each expert's GEMMs see the rows the serial layer's
# do: measured bitwise equal on an H100 in every run, both modes (bitwise
# is reported). 1e-5 leaves room only for a GEMM that picks other tiles
# for the half batch of experts; one bf16 rounding more (2**-9) fails it.
# The MoE clip's factor against the serial dense clip's, relative, 1e-6
# (the same squares summed in another order)
MOE = dict(d_model=2048, d_hidden=2816, num_experts=8, top_k=2,
           capacity_factor=1.25)
MOE_REL, MOE_CLIP_REL, MOE_CLIP_NORM = 1e-5, 1e-6, 1e-3
PP_DP_DEPTH, PP_DP_STEPS = 4, 2  # (d)
P19_RANK_TIMEOUT_S = 600
_PRE_POST = {"_pre.0.weight": "llama.embed_tokens.weight",
             "_post.0.weight": "llama.norm.weight",
             "_post.1.weight": "lm_head.weight"}


def pp_loss(logits, labels):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def pp_llama(torch, dev, depth, V, seed):
    """The flagship at ``depth`` layers as a ``PipelineLayer`` (the
    embedding, the decoder layers, the final norm and the head, built in
    ``LlamaForCausalLM``'s order from ``seed``)."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.base.random import get_generator
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer)
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.llama import LlamaDecoderLayer
    from paddle_tpu_torch.nn import Embedding, Linear, RMSNorm

    pt_seed(seed)
    cfg = LlamaConfig(**dict(LLAMA_542M, max_position_embeddings=2048,
                             num_hidden_layers=depth))
    gen = get_generator(dev)
    kw = dict(device=dev, dtype=torch.bfloat16)
    h = cfg.hidden_size
    return PipelineLayer(
        [LayerDesc(Embedding, cfg.vocab_size, h, generator=gen, **kw)]
        + [LayerDesc(LlamaDecoderLayer, cfg, generator=gen, **kw)
           for _ in range(depth)]
        + [LayerDesc(RMSNorm, h, cfg.rms_norm_eps, **kw),
           LayerDesc(Linear, h, cfg.vocab_size, bias=False, generator=gen,
                     **kw)],
        num_virtual_pipeline_stages=V, loss_fn=pp_loss)


def pp_serial_name(pipe, name, row):
    """The serial model's name of stacked parameter ``name``'s ``row`` (of
    the reference layout's ``[S*V, ...]``), or of a prologue/epilogue
    parameter."""
    if not name.startswith("pipeline_stacked_"):
        return _PRE_POST[name]
    S, V = pipe._num_stages, pipe._num_virtual
    per = pipe._num_layers_per_stage // V
    i, rest = pipe._template_names[int(name.rsplit("_", 1)[1])].split(".", 1)
    v, s = row % V, row // V
    return f"llama.layers.{(v * S + s) * per + int(i)}.{rest}"


def pp_arrays(np, pipe, serial):
    """The serial model's arrays in the reference pipeline's layout (every
    stacked parameter whole, ``[S*V, ...]``), for ``load_jax_params``."""
    S, V = pipe._num_stages, pipe._num_virtual
    out = {}
    for n, _ in pipe.named_parameters():
        if n.startswith("pipeline_stacked_"):
            out[n] = np.stack([serial[pp_serial_name(pipe, n, j)]
                               for j in range(S * V)])
        else:
            out[n] = serial[_PRE_POST[n]]
    out.update({n: serial[m] for n, m in _PRE_POST.items()})
    return out


def pp_rows(pipe):
    """The reference-layout rows this stage holds."""
    V = pipe._num_virtual
    return [pipe._stage * V + v for v in range(V)]


def pp_grads_rel(torch, pipe, path):
    """The worst over this stage's parameters (a stacked row each) of
    |g - g_serial| / |g_serial| against the serial step's gradients saved
    at ``path``: (value, the serial name)."""
    serial = torch.load(path)
    worst, name = 0.0, None
    for n, p in pipe.named_parameters():
        rows = (list(enumerate(pp_rows(pipe)))
                if n.startswith("pipeline_stacked_") else [(None, None)])
        for i, j in rows:
            g = (p.grad if i is None else p.grad[i]).float()
            sn = pp_serial_name(pipe, n, j)
            want = serial[sn].to(g.device).float()
            rel = float((g - want).norm() / want.norm())
            if not rel <= worst:  # a NaN is the worst
                worst, name = rel, sn
    return worst, name


class _CheckFirstStep:
    """The optimizer as ``train_batch`` sees it: before the first step it
    runs ``check`` on the step's gradients, and keeps the check's time in
    ``off_ms`` (off the step's clock)."""

    def __init__(self, torch, opt, check):
        self.torch, self.opt, self.check = torch, opt, check
        self.calls, self.off_ms = 0, 0.0

    def step(self):
        if self.calls == 0:
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.check()
            self.torch.cuda.synchronize()
            self.off_ms = (time.perf_counter() - t0) * 1e3
        self.calls += 1
        self.opt.step()

    def clear_grad(self, set_to_zero=False):
        self.opt.clear_grad(set_to_zero)


def pp_model(torch, np, dev, seed, depth, V, arrays, sr, clip=None):
    """The pipeline at ``depth`` layers and V chunks a stage on this rank,
    the serial weights ``arrays`` loaded into its stage, wrapped by fleet
    (model and optimizer, ``bench.py``'s AdamW); ``loaded``: whether the
    stage holds the serial weights bitwise."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils import load_jax_params

    pipe = pp_llama(torch, dev, depth, V, seed)
    whole = pp_arrays(np, pipe, arrays)
    load_jax_params(pipe, whole)
    rows = pp_rows(pipe)
    loaded = all(torch.equal(p, torch.from_numpy(
        whole[n][rows] if n.startswith("pipeline_stacked_") else whole[n]
    ).to(dev, p.dtype)) for n, p in pipe.named_parameters())
    del whole
    model = fleet.distributed_model(pipe)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=TRAIN_LR, parameters=pipe.parameters(),
        moment_dtype="bfloat16", use_stochastic_rounding=sr, fused=True,
        grad_clip=None if clip is None else ClipGradByGlobalNorm(clip)))
    return pipe, model, opt, loaded


def pp_train(torch, np, D, dev, seed, V, arrays, out, steps, res):
    """19(a) at V chunks a stage on this rank: a dict of results; appends
    to ``res['failures']``."""
    from pathlib import Path

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import kernels

    failures = res["failures"]
    L = LLAMA_542M["num_hidden_layers"]
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"pp_degree": PP_DEGREE}
    s.pipeline_configs = {"accumulate_steps": PP_MICRO}
    fleet.init(strategy=s)
    pipe, model, opt, loaded = pp_model(torch, np, dev, seed, L, V, arrays,
                                        True)
    r = {"loaded": loaded,
         "bytes_ratio": sum(p.numel() * p.element_size()
                            for p in pipe.parameters())
         / sum(a.size * 2 for a in arrays.values())}
    tag = f"(a) V={V}"
    if not loaded:
        failures.append(f"{tag}: the stage's parameters are not the serial "
                        "weights")
    if not TP_BYTES_BAND[0] <= r["bytes_ratio"] <= TP_BYTES_BAND[1]:
        failures.append(f"{tag}: parameter bytes {r['bytes_ratio']:.4f} of "
                        f"the serial model's (band {TP_BYTES_BAND})")

    def check():
        r["grad_rel"], r["grad_worst"] = pp_grads_rel(
            torch, pipe, Path(out) / "serial_a_grads.pt")

    probe = _CheckFirstStep(torch, opt, check)
    ids, labels = p17_batch(torch, np, dev, seed)
    n_steps = steps or TP_STEPS
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, ms, hops, mb = [], [], [], []
    for i in range(n_steps):
        h0, b0 = model.hops, model.hop_bytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.train_batch((ids, labels), probe)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3
                  - (probe.off_ms if i == 0 else 0.0))
        losses.append(float(loss))
        hops.append(model.hops - h0)
        mb.append(round((model.hop_bytes - b0) / 1e6, 3))
    counts = kernels.launch_counts()
    n = L // PP_DEGREE * PP_MICRO * n_steps
    want = {**flash_fwd_counts(n), **flash_bwd_counts(n),
            "fused_adamw": ADAMW_GROUPS * n_steps}
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        failures.append(f"{tag}: launches {got} != {want}")
    if not r["grad_rel"] <= PP_GRAD_REL:
        failures.append(f"{tag}: the first step's gradients are "
                        f"{r['grad_rel']:.3g} (norm-rel., {r['grad_worst']}) "
                        f"from the serial step's (tol {PP_GRAD_REL})")
    r.update(losses=losses, ms=ms, hops=hops, hop_mb=mb,
             counts={k: v // n_steps for k, v in step_launches(counts).items()},
             peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    del pipe, model, opt, probe, loss
    gc.collect()
    torch.cuda.empty_cache()
    return r


def plain_attention32(torch, q, k, v, causal):
    """Attention over the whole sequence in f32 (``[B, S, H, D]``)."""
    q, k, v = (t.float().transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool,
                                      device=s.device).tril(), float("-inf"))
    return torch.matmul(torch.softmax(s, -1), v).transpose(1, 2)


def ring_check(torch, D, dev, seed, res):
    """19(b)'s ring: ``sep_parallel_attention`` over the two ranks on the
    global q/k/v (bf16), the output and dq/dk/dv against plain f32
    attention over the whole sequence, causal and not."""
    from paddle_tpu_torch.ops.ring_attention import sep_parallel_attention

    failures = res["failures"]
    g = D.collective._get_global_group()
    gen = torch.Generator(dev).manual_seed(seed + 19)
    q, k, v, c = (torch.randn(RING_SHAPE, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    rows = {}
    for causal in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sep_parallel_attention(*leaves, g, causal=causal)
        (got.float() * c.float()).sum().backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref = [t.float().requires_grad_() for t in (q, k, v)]
        want = plain_attention32(torch, *ref, causal)
        (want * c.float()).sum().backward()
        errs = {"out": row_rel_err(got, want, RING_ROW_FLOOR)}
        for name, a, b in zip(("dq", "dk", "dv"), leaves, ref):
            errs[name] = row_rel_err(a.grad, b.grad, RING_ROW_FLOOR)
        rows["causal" if causal else "full"] = dict(
            errs={k_: round(e, 5) for k_, e in errs.items()}, ms=round(ms, 2))
        bad = {k_: e for k_, e in errs.items() if not e <= RING_ROW_REL}
        if bad:
            failures.append(f"(b) ring {'causal' if causal else 'full'}: "
                            f"worst row {bad} (tol {RING_ROW_REL})")
        del leaves, ref, got, want
    res["ring"] = rows


def sep_block(torch, width, heads, use_sep, dev):
    """The reference tests' attention block (tests/test_hybrid_parallel.py
    SepBlock): qkv, causal attention (over the sep group, or plain), o, the
    residual."""
    from paddle_tpu_torch.base.random import get_generator
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.ring_attention import sep_parallel_attention

    class SepBlock(torch.nn.Module):
        def __init__(self):
            super().__init__()
            kw = dict(device=dev, dtype=torch.bfloat16,
                      generator=get_generator(dev))
            self.qkv = Linear(width, 3 * width, **kw)
            self.o = Linear(width, width, **kw)

        def forward(self, x):
            b, s, hh = x.shape
            qkv = self.qkv(x).reshape(b, s, 3, heads, hh // heads)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            if use_sep:
                out = sep_parallel_attention(q, k, v, causal=True)
            else:
                out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                     training=False)
            return x + self.o(out.reshape(b, s, hh))

    return SepBlock()


def sep_check(torch, D, dev, seed, res):
    """19(b)'s SegmentParallel step: ``fleet.init(sep_degree=2)``,
    ``distributed_model`` around the attention block, one SGD step, against
    the serial block on the same weights and data."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import SGD

    failures = res["failures"]
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"sep_degree": 2}
    hcg = fleet.init(strategy=s)
    pt_seed(seed)
    blk = sep_block(torch, SEP_WIDTH, SEP_HEADS, True, dev)
    ser = sep_block(torch, SEP_WIDTH, SEP_HEADS, False, dev)
    ser.load_state_dict(blk.state_dict())
    model = fleet.distributed_model(blk)
    gen = torch.Generator(dev).manual_seed(seed + 20)
    shape = (TRAIN_BATCH, TRAIN_SEQ, SEP_WIDTH)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    c = torch.randn(shape, generator=gen, device=dev)
    times, grads = {}, {}
    for name, net, fwd in (("sep", blk, model), ("serial", ser, ser)):
        opt = SGD(learning_rate=SEP_LR, parameters=net.parameters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = (fwd(x).float() * c).mean()
        loss.backward()
        grads[name] = [p.grad.clone() for p in net.parameters()]
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        times[name] = round((time.perf_counter() - t0) * 1e3, 2)
    rel = max(rel_err(a, b) for a, b in zip(grads["sep"], grads["serial"]))
    same = all_true(D, equal_across(torch, D, list(blk.parameters()),
                                    hcg.get_sep_parallel_group()))
    res["sep"] = dict(grad_rel=rel, bitwise=same, ms=times,
                      wrapper=type(model).__name__)
    if not rel <= SEP_REL:
        failures.append(f"(b) the SegmentParallel step's gradients are "
                        f"{rel:.3g} (norm-rel.) from the serial block's (tol "
                        f"{SEP_REL})")
    if not same:
        failures.append("(b) the block's parameters differ across the sep "
                        "ranks after the step")
    del blk, ser, model, x, c, grads


def moe_check(torch, D, dev, seed, res):
    """19(c): ``MoELayer`` with its experts over the two ranks
    (``place_experts_on_mesh``) against the serial layer from the same seed,
    in both dispatch modes: output, gradients, the MoE clip's factor."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers import \
        _all_gather
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ClipGradForMOEByGlobalNorm, MoELayer, place_experts_on_mesh)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    failures = res["failures"]
    g = D.collective._get_global_group()
    gen = torch.Generator(dev).manual_seed(seed + 21)
    shape = (TRAIN_BATCH, TRAIN_SEQ, MOE["d_model"])
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    c = torch.randn(shape, generator=gen, device=dev)
    res["moe"] = {}
    for mode in ("einsum", "sort"):
        runs = {}
        for name in ("serial", "ep"):
            pt_seed(seed)
            moe = MoELayer(**MOE, dispatch_mode=mode, device=dev,
                           dtype=torch.bfloat16)
            if name == "ep":
                place_experts_on_mesh(moe, g)
            tx = x.clone().requires_grad_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = moe(tx)
            ((out.float() * c).mean() + 0.01 * moe.l_aux).backward()
            torch.cuda.synchronize()
            ms = round((time.perf_counter() - t0) * 1e3, 2)
            pg = [(p, p.grad) for p in moe.parameters()]
            if name == "ep":
                norm = ClipGradForMOEByGlobalNorm(
                    MOE_CLIP_NORM, moe_group=g).global_norm(pg)
            else:
                norm = ClipGradByGlobalNorm(MOE_CLIP_NORM).global_norm(pg)
            scale = float(torch.clamp(MOE_CLIP_NORM / norm, max=1.0))
            grads = {n: (_all_gather(p.grad, g, 0) if name == "ep" and
                         getattr(p, "_ep_shard", None) else p.grad)
                     for n, p in moe.named_parameters()}
            grads["x"] = tx.grad
            runs[name] = dict(out=out.detach(), grads=grads, scale=scale,
                              ms=ms, shapes={n: list(p.shape) for n, p in
                                             moe.named_parameters()})
            del moe, tx, out, pg
        ser, ep = runs["serial"], runs["ep"]
        errs = {"out": rel_err(ep["out"], ser["out"])}
        errs.update({n: rel_err(ep["grads"][n], t)
                     for n, t in ser["grads"].items()})
        bitwise = torch.equal(ep["out"], ser["out"]) and all(
            torch.equal(ep["grads"][n], t) for n, t in ser["grads"].items())
        clip_rel = abs(ep["scale"] - ser["scale"]) / ser["scale"]
        res["moe"][mode] = dict(
            errs={k: round(e, 6) for k, e in errs.items()}, bitwise=bitwise,
            scale=ep["scale"], serial_scale=ser["scale"], clip_rel=clip_rel,
            ms={"ep": ep["ms"], "serial": ser["ms"]},
            experts=ep["shapes"]["experts.w1"][0])
        bad = {k: e for k, e in errs.items() if not e <= MOE_REL}
        if bad:
            failures.append(f"(c) {mode}: the ep layer against the serial "
                            f"one {bad} (norm-rel., tol {MOE_REL})")
        if ep["shapes"]["experts.w1"][0] != MOE["num_experts"] // 2:
            failures.append(f"(c) {mode}: a rank holds "
                            f"{ep['shapes']['experts.w1'][0]} experts")
        if not clip_rel <= MOE_CLIP_REL:
            failures.append(f"(c) {mode}: the MoE clip's factor "
                            f"{ep['scale']!r} is {clip_rel:.3g} from the "
                            f"serial clip's {ser['scale']!r} (tol "
                            f"{MOE_CLIP_REL})")
        del runs, ser, ep
        gc.collect()
        torch.cuda.empty_cache()


def pp_rank(torch, np, D, rank, dev, seed, parts, res, out, steps=None):
    """19(a)-(c) on this rank; appends to ``res['failures']``."""
    from pathlib import Path

    from paddle_tpu_torch.distributed.communication import flight_recorder
    from paddle_tpu_torch.distributed.store import FileKVStore

    if "a" in parts:
        arrays = p18_arrays(torch, Path(out) / "serial_a.pt")
        for V in (1, 2):
            res[f"v{V}"] = pp_train(torch, np, D, dev, seed, V, arrays, out,
                                    steps, res)
        del arrays
    if "b" in parts:
        ring_check(torch, D, dev, seed, res)
        sep_check(torch, D, dev, seed, res)
    if "c" in parts:
        moe_check(torch, D, dev, seed, res)
    if "e" in parts:
        qkv_tp_check(torch, np, dev, seed, g, res)
    store = FileKVStore(str(Path(out) / "contract"))
    try:
        flight_recorder.contract(store, rank, D.get_world_size(),
                                 deadline=120.0)
        res["contract"] = "agrees"
    except Exception as e:  # noqa: BLE001 - a gate: recorded as a failure
        res["contract"] = "mismatch"
        res["failures"].append(f"collective contract: {str(e)[:400]}")


def ppdp_rank(torch, np, D, rank, dev, seed, res, out):
    """19(d) on this rank: dp=2 x pp=2 at PP_DP_DEPTH layers, SR off,
    ClipGradByGlobalNorm through HybridParallelOptimizer."""
    from pathlib import Path

    from paddle_tpu_torch.distributed import fleet

    failures = res["failures"]
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "pp_degree": PP_DEGREE}
    s.pipeline_configs = {"accumulate_steps": 2}
    hcg = fleet.init(strategy=s)
    arrays = p18_arrays(torch, Path(out) / "serial_d.pt")
    pipe, model, opt, loaded = pp_model(torch, np, dev, seed, PP_DP_DEPTH, 1,
                                        arrays, False, TP_CLIP_NORM)
    del arrays
    if not loaded:
        failures.append("(d) the stage's parameters are not the serial "
                        "weights")
    clip = opt._inner_opt._grad_clip
    ids, labels = p17_batch(torch, np, dev, seed)
    b = TRAIN_BATCH // 2
    r = hcg.get_data_parallel_rank()
    x, y = ids[r * b:(r + 1) * b], labels[r * b:(r + 1) * b]
    dp_g = hcg.get_data_parallel_group()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, scales, ms, bitwise = [], [], [], [], []
    for _ in range(PP_DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.train_batch((x, y), opt)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        norms.append(float(clip.last_global_norm))
        scales.append(float(clip.last_scale))
        bitwise.append(all_true(D, equal_across(
            torch, D, list(pipe.parameters()), dp_g)))
    res.update(losses=losses, norms=norms, scales=scales, ms=ms,
               bitwise=bitwise, stage=hcg.get_stage_id(), dp_rank=r,
               n_syncs=model._dp.n_syncs,
               peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    if not all(bitwise):
        failures.append(f"(d) the stage's parameters differ across dp peers: "
                        f"{bitwise}")
    if model._dp.n_syncs != PP_DP_STEPS:
        failures.append(f"(d) {model._dp.n_syncs} dp averages in "
                        f"{PP_DP_STEPS} steps")


def pp_phase(torch, np, dev, args, card, tmp, serial_a):
    """Phase 19: (a)-(c) in two launched ranks (against phase 18's serial
    run, kept in ``tmp``), then (d)'s serial run here and its four ranks."""
    t0 = time.perf_counter()
    failures = pp_ranks(torch, np, args, card, serial_a, tmp, parts="abc")
    serial_d, norms_d = tp_serial(torch, np, dev, args, PP_DP_DEPTH,
                                  PP_DP_STEPS, False, TP_CLIP_NORM,
                                  tmp / "serial_d.pt")
    failures += ppdp_ranks(torch, np, args, card, serial_d, norms_d, tmp)
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s [{card}]")
    if failures:
        fail("phase 19: " + "; ".join(failures))


def pp_ranks(torch, np, args, card, serial, tmp, script=None, extra=(),
             parts="abc"):
    """19(a)-(c) through the launcher (two ranks); returns the failures.
    ``serial``: 18(a)'s serial losses (a prefix of them with ``--steps``)."""
    out = tmp / f"pp-{parts}"
    out.mkdir()
    for f in ("serial_a.pt", "serial_a_grads.pt"):
        (out / f).symlink_to((tmp / f).resolve())
    rc, logs = launch_ranks("pp", out, args, script=script,
                            extra=("--parts", parts, *extra),
                            timeout=P19_RANK_TIMEOUT_S)
    if rc != 0:
        return [f"the two-rank pipeline launch exited {rc}:\n{logs}"]
    ranks = rank_results(out)
    failures = [f"rank {r}: {f}" for r, res in enumerate(ranks)
                for f in res["failures"]]
    if "a" in parts:
        for V in (1, 2):
            a, b = ranks[0][f"v{V}"], ranks[1][f"v{V}"]
            losses = a["losses"]
            if b["losses"] != losses:
                failures.append(f"(a) V={V}: the ranks' losses differ: "
                                f"{losses} | {b['losses']}")
            rel = [_rel(x, y) for x, y in zip(losses, serial)]
            if max(rel) > PP_LOSS_REL:
                failures.append(f"(a) V={V}: losses {losses} are "
                                f"{max(rel):.3g} from the serial step's "
                                f"{serial} (tol {PP_LOSS_REL})")
            print(f"phase 19(a) PipelineParallel(Llama-542M) at pp="
                  f"{PP_DEGREE} V={V}, accumulate_steps {PP_MICRO}, two gloo "
                  f"ranks on the one card, B={TRAIN_BATCH} S={TRAIN_SEQ} bf16 "
                  f"SR on, {len(losses)} eager steps: losses "
                  f"{[round(x, 6) for x in losses]} against the serial step's "
                  f"{[round(x, 6) for x in serial[:len(losses)]]} (worst rel "
                  f"{max(rel):.3g}, tol {PP_LOSS_REL}); the first step's "
                  f"gradients against the serial step's: worst norm-rel "
                  f"{[r[f'v{V}']['grad_rel'] for r in ranks]} at "
                  f"{[r[f'v{V}']['grad_worst'] for r in ranks]} (tol "
                  f"{PP_GRAD_REL}); launches a step per rank "
                  f"{[r[f'v{V}']['counts'] for r in ranks]}; stages loaded "
                  f"bitwise the serial weights "
                  f"{[r[f'v{V}']['loaded'] for r in ranks]}; parameter bytes "
                  f"{[round(r[f'v{V}']['bytes_ratio'], 4) for r in ranks]} of "
                  f"the serial model's [{card}]")
            print(f"phase 19(a) V={V} per rank: ms a step "
                  f"{[[round(t, 1) for t in r[f'v{V}']['ms']] for r in ranks]}"
                  f", tokens/s "
                  f"{[round(TRAIN_BATCH * TRAIN_SEQ / (min(r[f'v{V}']['ms']) / 1e3)) for r in ranks]}"
                  f"; P2P hops sent a step "
                  f"{[r[f'v{V}']['hops'] for r in ranks]}, MB a step "
                  f"{[r[f'v{V}']['hop_mb'] for r in ranks]}; peak memory GB "
                  f"{[r[f'v{V}']['peak_gb'] for r in ranks]}; collective "
                  f"contract {[r['contract'] for r in ranks]} [{card}]")
    if "b" in parts:
        print(f"phase 19(b) ring attention at sep=2, B, S, H, D "
              f"{list(RING_SHAPE)} bf16 ({RING_SHAPE[1] // 2} a rank), "
              f"against plain f32 attention over the whole sequence, worst "
              f"row (floor {RING_ROW_FLOOR}, tol {RING_ROW_REL}) and ms "
              f"fwd+bwd: {[r['ring'] for r in ranks]}; SegmentParallel step "
              f"of the attention block (width {SEP_WIDTH}, {SEP_HEADS} heads, "
              f"SGD lr {SEP_LR}) against the serial block's: "
              f"{[r['sep'] for r in ranks]} (tol {SEP_REL}) [{card}]")
    if "c" in parts:
        for mode in ("einsum", "sort"):
            scales = [r["moe"][mode]["scale"] for r in ranks]
            if scales[0] != scales[1]:
                failures.append(f"(c) {mode}: the MoE clip's factors differ "
                                f"across ranks: {scales}")
            print(f"phase 19(c) MoELayer({MOE}) {mode} dispatch over "
                  f"{TRAIN_BATCH * TRAIN_SEQ} tokens bf16, experts over ep=2 "
                  f"against the serial layer (norm-rel, tol {MOE_REL}): "
                  f"{[r['moe'][mode] for r in ranks]} [{card}]")
    return failures


def ppdp_ranks(torch, np, args, card, serial, serial_norms, tmp,
               script=None, extra=()):
    """19(d) through the launcher (four ranks); returns the failures."""
    out = tmp / "ppdp"
    out.mkdir()
    (out / "serial_d.pt").symlink_to((tmp / "serial_d.pt").resolve())
    rc, logs = launch_ranks("ppdp", out, args, script=script, extra=extra,
                            nproc=4, timeout=P19_RANK_TIMEOUT_S)
    if rc != 0:
        return [f"the four-rank dp x pp launch exited {rc}:\n{logs}"]
    ranks = rank_results(out, 4)
    failures = [f"rank {r}: {f}" for r, res in enumerate(ranks)
                for f in res["failures"]]
    losses = ranks[0]["losses"]
    if any(r["losses"] != losses for r in ranks):
        failures.append(f"(d) the ranks' losses differ: "
                        f"{[r['losses'] for r in ranks]}")
    rel = [_rel(a, b) for a, b in zip(losses, serial)]
    if max(rel) > PP_LOSS_REL:
        failures.append(f"(d) losses {losses} are {max(rel):.3g} from the "
                        f"serial step's {serial} (tol {PP_LOSS_REL})")
    norms = ranks[0]["norms"]
    nrel = [_rel(a, b) for a, b in zip(norms, serial_norms)]
    if max(nrel) > CLIP_SERIAL_REL:
        failures.append(f"(d) clip norms {norms} are {max(nrel):.3g} from "
                        f"the serial step's {serial_norms} (tol "
                        f"{CLIP_SERIAL_REL})")
    if not all(s < 1.0 for s in ranks[0]["scales"]):
        failures.append(f"(d) the clip did not scale: {ranks[0]['scales']}")
    print(f"phase 19(d) dp=2 x pp={PP_DEGREE}, four gloo ranks on the one "
          f"card, Llama-542M at {PP_DP_DEPTH} layers, SR off, "
          f"ClipGradByGlobalNorm({TP_CLIP_NORM}) through "
          f"HybridParallelOptimizer, {PP_DP_STEPS} steps: losses "
          f"{[round(x, 6) for x in losses]} against the serial step's "
          f"{[round(x, 6) for x in serial]} (worst rel {max(rel):.3g}, tol "
          f"{PP_LOSS_REL}); clip norms {norms} against the serial "
          f"{serial_norms} (worst rel {max(nrel):.3g}, tol {CLIP_SERIAL_REL})"
          f"; (stage, dp rank) {[(r['stage'], r['dp_rank']) for r in ranks]}"
          f", shards bitwise across dp peers "
          f"{[r['bitwise'] for r in ranks]}, dp averages "
          f"{[r['n_syncs'] for r in ranks]}; ms a step "
          f"{[[round(t, 1) for t in r['ms']] for r in ranks]}, peak GB "
          f"{[r['peak_gb'] for r in ranks]} [{card}]")
    return failures


# -- phase 20: fault-tolerant training ---------------------------------------
P20_DEPTH = LLAMA_542M["num_hidden_layers"]  # (a) and (b)'s disk tier: full
P20_STEPS, P20_SNAP = 8, 2  # (a): steps of each run, snapshot interval
P20_WARMUP = 3  # (a)-(c): the detector's warm-up before its spike gate arms
# (a): executed-step indices of the injected NaN and spike (chaos sites fire
# once per executed step, replays included): NaN at step 4 rolls back to the
# step-2 snapshot, the spike lands on step 5's first run and rolls back to 4
P20_NAN_AT, P20_SPIKE_AT = 4, 7
P20_POISON = 3  # (a): the poison run's data index with NaN loss weights
P20_POISON_STEPS = 5
P20_SAVE_AT = 5  # (a)'s clean eager run saves its disk checkpoint here
P20_QUIET_STEPS = 5  # (a)'s timed steps with nothing else running
P20_PEER_DEPTH = 1  # (b): the peer tier's layers (its payload rides the store)
P20_CORRUPT_BIT = 8 * 4096 + 3  # (b): a bit of the payload, past its header
P20_TF_STEPS, P20_TF_SNAP, P20_TF_WAIT = 6, 2, 4  # (b): steps, interval, drain
P20_TF_PEER = 4  # (b): peer publishes (at 0 and 4: a payload is ~1.1 GB)
P20_TF_NAN, P20_TF_KILL = 3, 5  # (b): rank 0's NaN, rank 1's kill (executed)
P20_SHARD_DEPTH = 2  # (c): layers (as 17(c))
# (c): snapshot and peer intervals; the cut (the last publish before the
# kill, where the file checkpoint is written too); the last step of both
# the two-rank wave and the relaunch. The relaunch resumes the cut and runs
# steps 5 and 6, which the wave ran uninterrupted before the kill: step 5's
# loss reads the restored parameters, step 6's also the restored moments,
# step count, SR salts and generator offsets through step 5's update.
# Both hold every parameter whole in the forward, take identical gradients
# (each rank runs the same batch: the mean of two equal values is exact)
# and draw the SR salts by global element index, so the losses must agree
# bitwise (step 5 alone read 0.0 apart on the card).
P20_SHARD_SNAP, P20_SHARD_PEER, P20_SHARD_CUT, P20_SHARD_STEPS = 2, 4, 4, 6
# (c): rank 0's SDC and rank 1's kill, as executed steps: 1, 2, 3 (flagged,
# rolled back), 3, 4, 5, 6, then step 7's start
P20_SDC_AT, P20_KILL_AT = 3, 8
P20_SETTLE_S = 1.5  # (c): the relaunch waits out the dead wave's heartbeats
P20_RANK_TIMEOUT_S = 600


def p20_batch(np, seed, index, vocab=None, poison=None):
    """Data index ``index``'s batch, pure in the index: per-token loss
    weights (ones; NaN at the poison index), input ids, labels, the index."""
    rng = np.random.RandomState((seed * 7919 + int(index)) % 2 ** 31)
    toks = rng.randint(0, vocab or LLAMA_542M["vocab_size"],
                       (TRAIN_BATCH, TRAIN_SEQ + 1))
    w = np.ones((TRAIN_BATCH, TRAIN_SEQ), np.float32)
    if poison is not None and int(index) == poison:
        w *= np.float32("nan")
    return (w, toks[:, :-1].astype(np.int64), toks[:, 1:].astype(np.int64),
            np.array([int(index)]))


def p20_step(torch, model, opt, dev, captured, rec):
    """A supervised flagship step: the per-token cross entropy weighted by
    the batch's loss weights (the chaos sites corrupt the first float leaf
    of a batch), one AdamW step, and the packed health word (one 20-byte
    host read a step; ``float(loss)`` would be a graph break in the
    capture). ``rec`` collects each data index's word (a replay overwrites
    it), the executed steps, and the captured program's graphs and pool."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.training import pack_health

    def body(w, ids, labels):
        logits = model(ids)
        b, s, v = logits.shape
        ce = F.cross_entropy(logits.reshape(b * s, v), labels.reshape(b * s),
                             reduction="none")
        loss = (ce * w.reshape(b * s)).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return pack_health(loss)

    fn = jit.to_static(body, layers=[model], optimizers=[opt]) \
        if captured else body

    def step(batch):
        w, ids, labels, idx = batch
        word = fn(*(torch.from_numpy(a).to(dev) for a in (w, ids, labels)))
        rec["words"][int(idx[0])] = word
        rec["first"].setdefault(int(idx[0]), word)
        rec["executed"] += 1
        if captured:
            rec["graphs"].append((len(fn._graphs), graph_pool_bytes(torch, fn)))
        return word

    return step, fn


def p20_record():
    return {"words": {}, "first": {}, "executed": 0, "graphs": []}


def p20_losses(rec) -> dict:
    """Data index -> the f32 loss of its last run, as the word holds it."""
    return {i: float(w[0]) for i, w in sorted(rec["words"].items())}


def p20_sup(step, batch_fn, model, opt, **kw):
    from paddle_tpu_torch.training import AnomalyDetector, TrainingSupervisor

    kw.setdefault("snapshot_interval", P20_SNAP)
    return TrainingSupervisor(
        step, batch_fn, layers=[model], optimizers=[opt],
        detector=AnomalyDetector(warmup_steps=P20_WARMUP), **kw)


def p20_ledger() -> dict:
    """A rank process's supervisor's goodput ledger (s), read from the
    registry series it keeps (``training_wall_seconds``)."""
    from paddle_tpu_torch import obs

    return {b: obs.registry().value("training_wall_seconds", {"bucket": b})
            for b in ("productive", "rollback", "checkpoint", "stall")}


def p20_want_counts(n_steps: int, depth: int) -> dict:
    return {**flash_fwd_counts(depth * n_steps),
            **flash_bwd_counts(depth * n_steps), "fused_adamw": n_steps,
            "paged_decode_attention": 0, "paged_decode_attention_int8": 0}


def bitwise_same(a: dict, b: dict, keys) -> bool:
    import numpy as np

    return all(np.float32(a[k]).tobytes() == np.float32(b[k]).tobytes()
               for k in keys)


def p20_rollback_runs(torch, np, dev, args, card, tmp,
                      modes=("eager", "captured"), extras=True):
    """20(a): rollback at full depth in ``modes`` (eager, captured) against
    clean runs; with ``extras``, the clean eager run also saves (b)'s
    full-depth disk checkpoint and times a snapshot and a restore, and the
    poison batch runs. Returns (failures, the clean eager run's losses,
    the checkpoint dir, the clean eager run)."""
    from paddle_tpu_torch.incubate.checkpoint import AutoCheckpoint
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.testing import chaos

    failures, clean, runs = [], {}, {}
    ckpt_dir = tmp / "p20_disk"
    batch_fn = lambda i: p20_batch(np, args.seed, i)  # noqa: E731
    for mode in modes:
        for kind in ("clean", "injected"):
            model, opt = p17_model(torch, dev, P20_DEPTH, args.seed, True)
            rec = p20_record()
            step, fn = p20_step(torch, model, opt, dev, mode == "captured", rec)
            kw = {}
            if extras and (mode, kind) == ("eager", "clean"):
                kw["auto_checkpoint"] = AutoCheckpoint(
                    str(ckpt_dir), layers=[model], optimizers=[opt],
                    save_interval_steps=P20_SAVE_AT, keep_last_k=1)
            sup = p20_sup(step, batch_fn, model, opt, **kw)
            sched = chaos.ChaosSchedule()
            if kind == "injected":
                sched = (sched.at("train.nan", P20_NAN_AT, "drop")
                         .at("train.spike", P20_SPIKE_AT, "drop"))
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with chaos.active(sched):
                rep = sup.run(P20_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            losses = p20_losses(rec)
            r = {"rep": rep, "losses": losses, "executed": rec["executed"],
                 "counts": counts, "wall": wall, "graphs": rec["graphs"],
                 "wall_seconds": sup.health()["wall_seconds"]}
            runs[(mode, kind)] = r
            if kind == "clean":
                clean[mode] = losses
            want = p20_want_counts(rec["executed"], P20_DEPTH)
            if torch.cuda.is_available() and counts != want:
                failures.append(f"(a) {mode} {kind}: launch counts {counts} "
                                f"!= {want} ({rec['executed']} executed "
                                f"steps x {P20_DEPTH} layers)")
            del model, opt, step, fn, sup, rec
            gc.collect()
            torch.cuda.empty_cache()
    for mode in modes:
        c, i = runs[(mode, "clean")], runs[(mode, "injected")]
        if c["rep"]["rollbacks"] != 0:
            failures.append(f"(a) {mode}: the clean run rolled back: "
                            f"{c['rep']['anomalies']}")
        kinds = [a[1].split(":")[0] for a in i["rep"]["anomalies"]]
        if i["rep"]["rollbacks"] != 2 or kinds != ["loss_nonfinite",
                                                   "loss_spike"]:
            failures.append(f"(a) {mode}: rollbacks {i['rep']['rollbacks']} "
                            f"(want 2: a NaN then a spike): "
                            f"{i['rep']['anomalies']}")
        keys = list(range(1, P20_STEPS + 1))
        if sorted(i["losses"]) != keys or sorted(c["losses"]) != keys or \
                not bitwise_same(i["losses"], c["losses"], keys):
            failures.append(f"(a) {mode}: the injected run's losses "
                            f"{i['losses']} are not bitwise the clean run's "
                            f"{c['losses']}")
        print(f"phase 20(a) {mode}, Llama-542M full depth ({P20_DEPTH} "
              f"layers) B={TRAIN_BATCH} S={TRAIN_SEQ} bf16 SR on, "
              f"{P20_STEPS} supervised steps, snapshot every {P20_SNAP}: "
              f"NaN at executed step {P20_NAN_AT}, spike at "
              f"{P20_SPIKE_AT}: rollbacks {i['rep']['rollbacks']} "
              f"({kinds}), executed {i['executed']} steps; losses bitwise "
              f"the clean run's at every step "
              f"{bitwise_same(i['losses'], c['losses'], keys)}: "
              f"{[round(c['losses'][k], 5) for k in keys]}; wall "
              f"{c['wall']:.2f} s clean, {i['wall']:.2f} s injected; launches "
              f"{i['counts'].get('flash_attention_fwd')} fwd "
              f"{i['counts'].get('flash_attention_bwd_dq')} dq "
              f"{i['counts'].get('flash_attention_bwd_dkv')} dkv "
              f"{i['counts'].get('fused_adamw')} AdamW for "
              f"{i['executed']} executed steps; goodput ledger (s) "
              f"{i['wall_seconds']} [{card}]")
    if "captured" in modes:
        cap = runs[("captured", "injected")]["graphs"]
        after = cap[1:]  # the warm-up call is eager
        flat = bool(after) and after[0][0] == 1 and all(
            g == after[0] for g in after)
        if not flat:
            failures.append(f"(a) captured: graphs and pool bytes per "
                            f"executed step {cap} are not flat at one graph")
        print(f"phase 20(a) captured: (graphs, pool bytes) per executed step "
              f"{cap}: flat at one graph across both rollbacks {flat} "
              f"[{card}]")
    if not extras:
        return failures, None, ckpt_dir, None
    # the poison batch: its NaN weights come back on every replay
    model, opt = p17_model(torch, dev, P20_DEPTH, args.seed, True)
    rec = p20_record()
    step, _ = p20_step(torch, model, opt, dev, False, rec)
    sup = p20_sup(step, lambda i: p20_batch(np, args.seed, i,
                                            poison=P20_POISON), model, opt)
    rep = sup.run(P20_POISON_STEPS)
    ok = (rep["quarantined"] == [P20_POISON]
          and rep["rollbacks"] == sup.max_rollback_retries + 1
          and math.isfinite(rep["final_loss"]))
    if not ok:
        failures.append(f"(a) poison batch: {rep}")
    print(f"phase 20(a) poison batch at data index {P20_POISON}: "
          f"quarantined {rep['quarantined']} after {rep['rollbacks']} "
          f"rollbacks (max_rollback_retries {sup.max_rollback_retries}), "
          f"final loss {rep['final_loss']:.5f}, executed {rec['executed']} "
          f"steps [{card}]")
    del model, opt, step, sup, rec
    gc.collect()
    torch.cuda.empty_cache()
    return failures, clean["eager"], ckpt_dir, runs[("eager", "clean")]


def p20_quiet_costs(torch, np, dev, args, card):
    """20(a)'s costs, taken after (b)'s and (c)'s processes have ended, so
    that nothing else runs on the card or in this process: a supervised
    eager step's wall at full depth, a snapshot's device time (CUDA events
    around the supervisor's capture) and a restore's wall (the rollback's
    copies into the live tensors and the generators' reset)."""
    model, opt = p17_model(torch, dev, P20_DEPTH, args.seed, True)
    step, _ = p20_step(torch, model, opt, dev, False, p20_record())
    sup = p20_sup(step, lambda i: p20_batch(np, args.seed, i), model, opt,
                  snapshot_interval=10 ** 6)
    sup.run(P20_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sup.run(P20_WARMUP + P20_QUIET_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / P20_QUIET_STEPS
    ev0, ev1 = torch.cuda.Event(True), torch.cuda.Event(True)
    ev0.record()
    snap = sup._capture(P20_WARMUP + P20_QUIET_STEPS)
    ev1.record()
    torch.cuda.synchronize()
    snap_ms = ev0.elapsed_time(ev1)
    snap_gb = sum(t.numel() * t.element_size() for part in
                  (snap["model"], snap["optim"]) for sd in part
                  for t in sd.values() if torch.is_tensor(t)) / 1e9
    t0 = time.perf_counter()
    sup._restore(snap)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    print(f"phase 20(a) with nothing else running: a snapshot of the full "
          f"state ({snap_gb:.3f} GB: parameters and moments, bf16) device "
          f"time {snap_ms:.3f} ms; a rollback's restore (copies into the "
          f"live tensors, generators reset) {restore_ms:.3f} ms wall; a "
          f"supervised eager step {step_ms:.1f} ms wall (the mean of "
          f"{P20_QUIET_STEPS}) [{card}]")
    del model, opt, step, sup, snap
    gc.collect()
    torch.cuda.empty_cache()


def p20_disk_resume(torch, np, dev, args, card, clean, ckpt_dir, clean_run):
    """20(b), the full-depth disk tier: a fresh model resumes (a)'s clean
    eager run's async checkpoint of step P20_SAVE_AT (written while steps
    5-8 changed the state in place) and must continue bitwise."""
    from paddle_tpu_torch.incubate.checkpoint import AutoCheckpoint

    failures = []
    model, opt = p17_model(torch, dev, P20_DEPTH, args.seed + 1, True)
    rec = p20_record()
    step, _ = p20_step(torch, model, opt, dev, False, rec)
    ac = AutoCheckpoint(str(ckpt_dir), layers=[model], optimizers=[opt],
                        save_interval_steps=10 ** 6)
    sup = p20_sup(step, lambda i: p20_batch(np, args.seed, i), model, opt,
                  auto_checkpoint=ac)
    t0 = time.perf_counter()
    nxt = sup.resume()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    sup.run(P20_STEPS)
    got = p20_losses(rec)
    keys = list(range(P20_SAVE_AT + 1, P20_STEPS + 1))
    tier = [d for k, d in sup.events if k == "resume"]
    if nxt != P20_SAVE_AT + 1 or not tier or "disk" not in tier[0] or \
            sorted(got) != keys or not bitwise_same(got, clean, keys):
        failures.append(f"(b) disk tier: resumed {nxt} ({tier}), losses "
                        f"{got} against the uninterrupted run's {clean}")
    payload = sum(os.path.getsize(os.path.join(r, f))
                  for r, _, fs in os.walk(ckpt_dir) for f in fs)
    print(f"phase 20(b) disk tier at full depth: (a)'s clean run saved step "
          f"{P20_SAVE_AT} asynchronously ({payload / 1e9:.3f} GB on disk; the "
          f"run's goodput ledger, whose checkpoint bucket holds its "
          f"snapshots and the save's drain at its end: "
          f"{clean_run['wall_seconds']} s, over {clean_run['wall']:.2f} s of "
          f"wall) and a fresh model resumed "
          f"{tier} in {restore_s:.2f} s; losses of steps {keys} bitwise the "
          f"uninterrupted run's {bitwise_same(got, clean, keys)} [{card}]")
    del model, opt, step, sup, rec
    gc.collect()
    torch.cuda.empty_cache()
    return failures


def p20_corrupt_peer(torch, np, dev, args, card, tmp, out=None):
    """20(b), the fallback: the newest peer publish is corrupted on its way
    into the store (``ckpt.peer``); resume() must reject it, see that the
    older verified replica is staler than the verified disk checkpoint, and
    take the disk tier; the continued losses equal a clean run's."""
    from paddle_tpu_torch.distributed.store import MemKVStore
    from paddle_tpu_torch.incubate.checkpoint import AutoCheckpoint
    from paddle_tpu_torch.testing import chaos
    from paddle_tpu_torch.training import PeerReplicator

    failures = []
    batch_fn = lambda i: p20_batch(np, args.seed, i)  # noqa: E731
    runs = {}
    store = MemKVStore()
    for kind in ("clean", "faulted", "resumed"):
        model, opt = p17_model(torch, dev, P20_PEER_DEPTH, args.seed, True)
        rec = p20_record()
        step, _ = p20_step(torch, model, opt, dev, False, rec)
        kw = {}
        if kind != "clean":
            kw = dict(peer=PeerReplicator(store, 0, 1, tag="p20b"),
                      auto_checkpoint=AutoCheckpoint(
                          str(tmp / "p20b_disk"), layers=[model],
                          optimizers=[opt], save_interval_steps=P20_TF_WAIT,
                          async_save=False))
        sup = p20_sup(step, batch_fn, model, opt, **kw)
        # publishes at steps 0, 2, 4: two legs each (data, meta); the
        # step-4 publish's data leg is corrupted
        sched = chaos.ChaosSchedule().at("ckpt.peer", 5, "corrupt",
                                         P20_CORRUPT_BIT) \
            if kind == "faulted" else chaos.ChaosSchedule()
        with chaos.active(sched):
            if kind == "resumed":
                nxt = sup.resume()
                tier = [d for k, d in sup.events if k.startswith("resume")]
            sup.run(P20_TF_WAIT if kind == "faulted" else P20_TF_STEPS)
        if sup.peer is not None:
            sup.peer.wait()
        runs[kind] = p20_losses(rec)
        del model, opt, step, sup, rec
        gc.collect()
    keys = list(range(P20_TF_WAIT + 1, P20_TF_STEPS + 1))
    ok = (nxt == P20_TF_WAIT + 1 and any("disk" in d for d in tier)
          and any("stale" in d or "step 2" in d for d in tier)
          and bitwise_same(runs["resumed"], runs["clean"], keys))
    if not ok:
        failures.append(f"(b) corrupt peer: resumed {nxt} via {tier}, "
                        f"losses {runs['resumed']} against {runs['clean']}")
    if out is not None:
        out["clean"] = runs["clean"]
    print(f"phase 20(b) a corrupt newest peer publish (ckpt.peer corrupt on "
          f"step {P20_TF_WAIT}'s data leg, {P20_PEER_DEPTH} layer): resume() "
          f"-> {tier}, next step {nxt}; losses of steps {keys} bitwise a "
          f"clean run's {ok} [{card}]")
    return failures


def p20_tf_ranks(torch, np, args, card, tmp, script=None, extra=()):
    """20(b), two tiers and a kill: two dp replicas in processes (one model
    each, telemetry over a TCPStoreServer here): rank 0 on the disk tier
    takes a NaN and rolls back; rank 1 on the peer tier is SIGKILLed after
    a publish and relaunched. Returns (failures, the two final losses' f32
    hex), for the caller to hold against a clean run."""
    from paddle_tpu_torch.distributed.store import TCPStoreServer

    out = tmp / "p20_tf"
    out.mkdir()
    srv = TCPStoreServer(host="127.0.0.1")
    here = Path(__file__).resolve()

    def spawn(rank, tier, label, spec=None):
        env = dict(os.environ)
        env.pop("PADDLE_CHAOS", None)
        env.update({"TF_STORE": f"127.0.0.1:{srv.port}", "TF_RANK": str(rank),
                    "TF_WORLD": "2", "TF_TAG": "fault", "TF_TIER": tier,
                    "TF_LABEL": label})
        if spec:
            env["PADDLE_CHAOS"] = spec
        log = open(out / f"{label}.log", "w")
        return subprocess.Popen(
            [sys.executable, str(script or here), "--rank17", "tf", "--out",
             str(out), "--seed", str(args.seed), *extra],
            env=env, cwd=here.parent, stdout=log, stderr=subprocess.STDOUT)

    def finish(p, label):
        try:
            return p.wait(timeout=P20_RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            return f"timed out ({label})"

    failures = []
    t0 = time.perf_counter()
    try:
        r0 = spawn(0, "disk", "rank0", f"train.nan@{P20_TF_NAN}=drop")
        r1 = spawn(1, "peer", "rank1", f"train.kill_rank.1@{P20_TF_KILL}=kill")
        rcs = {"rank1": finish(r1, "rank1")}
        relaunch = spawn(1, "peer", "rank1b")
        rcs.update(rank1b=finish(relaunch, "rank1b"), rank0=finish(r0, "rank0"))
    finally:
        srv.stop()
    wall = time.perf_counter() - t0
    if rcs["rank1"] != -9:
        failures.append(f"(b) rank 1 was not killed (exit {rcs['rank1']}):\n"
                        f"{_log_excerpt(out / 'rank1.log')}")
    for label in ("rank1b", "rank0"):
        if rcs[label] != 0:
            failures.append(f"(b) {label} exited {rcs[label]}:\n"
                            f"{_log_excerpt(out / f'{label}.log')}")
    if failures:
        return failures, None
    res = {k: json.loads((out / f"{k}.json").read_text())
           for k in ("rank0", "rank1b")}
    if res["rank1b"]["tier"] != "peer" or \
            res["rank1b"]["start"] != P20_TF_WAIT + 1:
        failures.append(f"(b) the relaunched rank 1 resumed "
                        f"{res['rank1b']['tier']} at {res['rank1b']['start']}"
                        f" (want peer at {P20_TF_WAIT + 1})")
    if res["rank0"]["rollbacks"] != 1 or res["rank0"]["disk_step"] != \
            P20_TF_PEER:
        failures.append(f"(b) rank 0 rolled back {res['rank0']['rollbacks']} "
                        f"times (want 1), disk tier at "
                        f"{res['rank0']['disk_step']} (want {P20_TF_PEER})")
    for k in res:
        failures += [f"(b) {k}: {f}" for f in res[k]["failures"]]
    print(f"phase 20(b) two tiers and a kill, Llama-542M widths at "
          f"{P20_PEER_DEPTH} layer, two dp replicas in processes (telemetry "
          f"over a TCPStoreServer here), {P20_TF_STEPS} steps, snapshot "
          f"every {P20_TF_SNAP}: rank 0 (disk tier, an async save every "
          f"{P20_TF_PEER}) NaN at executed step {P20_TF_NAN} -> rollbacks "
          f"{res['rank0']['rollbacks']}, goodput ledger (s; checkpoint: "
          f"snapshots and the save's drain) {res['rank0']['ledger']}; "
          f"rank 1 (peer tier, a publish every {P20_TF_PEER}) SIGKILLed at "
          f"executed step {P20_TF_KILL} (exit {rcs['rank1']}), relaunched: "
          f"resumed tier={res['rank1b']['tier']} at step "
          f"{res['rank1b']['start']} in {res['rank1b']['restore_s']:.2f} s; "
          f"before the kill (its ledger's checkpoint: snapshots and the "
          f"publishes' drains) {_log_publishes(out / 'rank1.log')}; "
          f"final losses "
          f"{res['rank0']['final_loss']!r} (rank 0) and "
          f"{res['rank1b']['final_loss']!r} (rank 1); {wall:.1f} s for the "
          f"processes [{card}]")
    return failures, [res["rank0"]["final_hex"], res["rank1b"]["final_hex"]]


def _log_publishes(path):
    """What a killed rank printed of its publishes before it died."""
    return [json.loads(line.split("PUBLISHED ", 1)[1])
            for line in path.read_text(errors="replace").splitlines()
            if line.startswith("PUBLISHED ")]


def tf_rank(torch, np, out, seed, res, dev=None):
    """One process of 20(b) (``--rank17 tf``, the TF_* environment): a dp
    replica of the flagship at P20_PEER_DEPTH layers under a supervisor
    with telemetry over the parent's TCP store and one recovery tier
    (``TF_TIER``: ``peer``, whose publishes it prints as it makes them, or
    ``disk``), resumed from it, trained to the end."""
    from paddle_tpu_torch.distributed.store import TCPKVStore
    from paddle_tpu_torch.incubate.checkpoint import AutoCheckpoint
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.training import PeerReplicator, TrainTelemetry
    from paddle_tpu_torch.utils.retries import Deadline

    host, port = os.environ["TF_STORE"].rsplit(":", 1)
    rank, world = int(os.environ["TF_RANK"]), int(os.environ["TF_WORLD"])
    tag, label = os.environ["TF_TAG"], os.environ["TF_LABEL"]
    dev = dev or torch.device("cuda", 0)
    store = TCPKVStore(host, int(port), timeout=120.0)
    store.wait_alive(deadline=Deadline(60.0))
    model, opt = p17_model(torch, dev, P20_PEER_DEPTH, seed, True)
    rec = p20_record()
    step, _ = p20_step(torch, model, opt, dev, False, rec)
    kw = dict(telemetry=TrainTelemetry(store, rank, world, tag=tag,
                                       straggler_patience=10 ** 4),
              telemetry_interval=2)
    if os.environ["TF_TIER"] == "peer":
        kw.update(peer=PeerReplicator(store, rank, world, tag=tag,
                                      deadline_s=300.0),
                  peer_interval=P20_TF_PEER)
    else:
        kw.update(auto_checkpoint=AutoCheckpoint(
            str(Path(out) / f"disk{rank}"), layers=[model], optimizers=[opt],
            save_interval_steps=P20_TF_PEER))
    sup = p20_sup(step, lambda i: p20_batch(np, seed, i), model, opt,
                  snapshot_interval=P20_TF_SNAP, **kw)
    t0 = time.perf_counter()
    start = sup.resume()
    res["restore_s"] = time.perf_counter() - t0
    done = [d for k, d in sup.events if k == "resume"]
    res["tier"] = ("peer" if done and "peer RAM" in done[-1] else
                   "disk" if done and "disk" in done[-1] else "fresh")
    res["start"] = start
    print(f"resumed step={start} tier={res['tier']}", flush=True)
    kernels.reset_launch_counts()
    if start <= P20_TF_WAIT:
        # run() drains the step-4 publish at its end: whole before the kill
        sup.run(P20_TF_WAIT)
        if sup.peer is not None:
            meta = json.loads(store.get(f"{tag}/snap/{rank}/meta"))
            print("PUBLISHED " + json.dumps({
                "publishes": sup.peer.n_published, "last": meta["step"],
                "MB": round(meta["payload_bytes"] / 1e6, 1),
                "ledger": p20_ledger()}), flush=True)
    rep = sup.run(P20_TF_STEPS)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = p20_want_counts(rec["executed"], P20_PEER_DEPTH)
    if dev.type == "cuda" and counts != want:
        res["failures"].append(f"launch counts {counts} != {want}")
    res.update(ledger=p20_ledger(), final_loss=rep["final_loss"],
               final_hex=np.float32(rep["final_loss"]).tobytes().hex(),
               rollbacks=rep["rollbacks"],
               disk_step=(sup.auto_checkpoint.latest_step()
                          if sup.auto_checkpoint is not None else None))
    with open(Path(out) / f"{label}.json", "w") as f:
        json.dump(res, f)


def p20_shard_ranks(torch, np, args, card, tmp, script=None, extra=()):
    """20(c): group-sharded stage 3 on two gloo ranks under the elastic
    manager, telemetry each step and sharded peer payloads: an SDC flagged
    and healed, the distributed file checkpoint written at the cut, rank 1
    killed; then the relaunch at world 1 resharding from the peer tier and
    continuing against the two-rank run."""
    failures = []
    t0 = time.perf_counter()
    base = tmp / "p20_shard"
    base.mkdir()
    fault_out, re_out = base / "fault", base / "relaunch"
    fault_out.mkdir()
    re_out.mkdir()
    rc, logs = launch_ranks("elastic", fault_out, args, script=script,
                            extra=("--parts", "fault", *extra),
                            timeout=P20_RANK_TIMEOUT_S)
    # rank 1 dies by SIGKILL; the launcher then stops rank 0
    fault = [json.loads(p.read_text())
             for p in sorted(fault_out.glob("progress*.json"))]
    if rc == 0 or len(fault) != 2:
        return [f"(c) the faulted launch exited {rc} with {len(fault)} "
                f"progress records (want rank 1 killed, two records)"
                f"\n{logs}"]
    rc, logs = launch_ranks("elastic", re_out, args, script=script, nproc=1,
                            extra=("--parts", "relaunch", *extra),
                            timeout=P20_RANK_TIMEOUT_S)
    if rc != 0:
        return [f"(c) the relaunch exited {rc}:\n{logs}"]
    re1 = rank_results(re_out, 1)[0]
    failures += [f"(c) relaunch: {f}" for f in re1["failures"]]
    failures += [f"(c) rank {r}: {f}" for r, p in enumerate(fault)
                 for f in p["failures"]]
    # the SDC on rank 0: both replicas flagged (two replicas cannot tell
    # which one is wrong) and rolled back; rank 1's first run of the step
    # had a clean batch on clean state, so the healed replays must equal it
    sdc = [p["anomalies"] for p in fault]
    if not all(any("sdc" in a[1] for a in s) for s in sdc):
        failures.append(f"(c) the SDC was not flagged on both ranks: {sdc}")
    k = str(P20_SDC_AT)
    want = fault[1]["first"][k]
    healed = [p["losses"][k] for p in fault]
    if healed != [want, want] or fault[0]["first"][k] == want:
        failures.append(f"(c) step {k}: first runs "
                        f"{[p['first'][k] for p in fault]}, replays {healed}"
                        f" (want both replays {want}, rank 0's first run "
                        f"apart)")
    if re1["reshard_resumes"] != 1 or re1["world"] != 1 or \
            re1["tier_note"] is None:
        failures.append(f"(c) relaunch: world {re1['world']}, reshard_resumes "
                        f"{re1['reshard_resumes']}, {re1['tier_note']}")
    if not re1["cut_bitwise"]:
        failures.append(f"(c) the restored state is not bitwise the two "
                        f"ranks' shards at the cut: {re1['cut_detail']}")
    # the steps after the cut, as the two ranks ran them before the kill
    after = [str(s) for s in range(P20_SHARD_CUT + 1, P20_SHARD_STEPS + 1)]
    ref = {s: fault[0]["losses"].get(s) for s in after}
    same = (re1["losses"] == ref
            and all(fault[1]["losses"].get(s) == ref[s] for s in after))
    if not same:
        failures.append(f"(c) the relaunch's losses {re1['losses']} are not "
                        f"bitwise the two-rank run's {ref} (rank 1: "
                        f"{ {s: fault[1]['losses'].get(s) for s in after} })")
    for name, ok in (("a target layout with no divisible dimension did not "
                      "raise ReshardLayoutError naming both layouts",
                      re1["layout_error"]),
                     ("rank 0's payload alone assembled without raising the "
                      "coverage error", re1["hole_error"])):
        if not ok:
            failures.append(f"(c) {name}")
    if not re1["distcp_bitwise"]:
        failures.append(f"(c) load_state_dict at world 1 of the two ranks' "
                        f"save_state_dict is not the gathered whole state: "
                        f"{re1['distcp_detail']}")
    print(f"phase 20(c) elastic group-sharded stage 3 (p_g_os) on two gloo "
          f"ranks, Llama-542M widths at {P20_SHARD_DEPTH} layers, B="
          f"{TRAIN_BATCH} S={TRAIN_SEQ} bf16 SR on, telemetry every step "
          f"(lockstep), sharded peer payloads every {P20_SHARD_PEER}: "
          f"train.sdc on rank 0 at executed step {P20_SDC_AT} flagged "
          f"{[len([a for a in s if 'sdc' in a[1]]) for s in sdc]} (per rank) "
          f"and healed (step {k}: first runs "
          f"{[p['first'][k] for p in fault]}, replays {healed}); "
          f"save_state_dict at step {P20_SHARD_CUT}; rank 1 SIGKILLed at "
          f"executed step {P20_KILL_AT}; the relaunch registered world "
          f"{re1['world']} (re-mesh), resumed {re1['tier_note']} "
          f"(reshard_resumes {re1['reshard_resumes']}) in "
          f"{re1['restore_s']:.2f} s, restored state bitwise the ranks' "
          f"shards at the cut {re1['cut_bitwise']}; continued losses "
          f"{re1['losses']} bitwise the two-rank run's {ref} before the "
          f"kill {same}; one "
          f"rank's payload alone refused for its holes {re1['hole_error']}; "
          f"load_state_dict at world 1 bitwise the two ranks' "
          f"save_state_dict {re1['distcp_bitwise']}; ReshardLayoutError "
          f"naming both layouts {re1['layout_error']}; launches a step per "
          f"rank {[p['per_step'] for p in fault]} (two ranks), "
          f"{re1['per_step']} (relaunch); ms a step "
          f"{[p['ms'] for p in fault]}; goodput ledger (s; checkpoint: "
          f"snapshots and the sharded publishes' drains) "
          f"{[p['ledger'] for p in fault]} (two ranks), {re1['ledger']} "
          f"(relaunch); "
          f"{time.perf_counter() - t0:.1f} s for the two launches [{card}]")
    return failures


def elastic_rank(torch, np, D, rank, dev, seed, kind, res, out):
    """One rank of 20(c) (``--rank17 elastic --parts fault|relaunch``).
    ``fault``: two ranks, stage 3, the elastic manager, lockstep telemetry
    each step, sharded peer payloads; rank 0's batch corrupted once (SDC),
    the live shards and the distributed file checkpoint written at the
    cut, rank 1 killed after it; progress (losses, first runs, anomalies,
    launches) written after each step. ``relaunch``: one rank resuming the
    cut at world 1."""
    from paddle_tpu_torch.distributed.checkpoint import reshard
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.distributed.store import FileKVStore
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.testing import chaos
    from paddle_tpu_torch.training import PeerReplicator, TrainTelemetry
    from paddle_tpu_torch.utils.retries import Deadline

    wave = Path(out).parent / "fault"
    if kind == "relaunch":
        time.sleep(P20_SETTLE_S)
    mgr = ElasticManager(str(wave / "elastic"), node_id=f"n{rank}",
                         np=("2" if kind == "fault" else "1:2"),
                         heartbeat_interval=0.2, elastic_timeout=1.2)
    W = len(mgr.register(deadline=Deadline(120.0)))
    res["world"] = W
    store = FileKVStore(str(wave / "store"))
    peer = PeerReplicator(store, rank, W, tag="p20c", deadline_s=300.0)
    model, opt = p17_model(torch, dev, P20_SHARD_DEPTH, seed, True)
    rec = p20_record()
    step, _ = p20_step(torch, model, opt, dev, False, rec)
    ms = []

    def timed_step(batch):
        t0 = time.perf_counter()
        word = step(batch)
        torch.cuda.synchronize()
        ms.append(round((time.perf_counter() - t0) * 1e3, 1))
        progress()
        return word

    tele = TrainTelemetry(store, rank, W, tag="p20c", lockstep=True,
                          lockstep_deadline_s=120.0,
                          straggler_patience=10 ** 4)
    sup = p20_sup(timed_step, lambda i: p20_batch(np, seed, i), model, opt,
                  snapshot_interval=P20_SHARD_SNAP, peer=peer,
                  peer_interval=P20_SHARD_PEER, telemetry=tele, elastic=mgr,
                  rank=rank, sharded_state=True,
                  state_layout={"world": W, "mesh": {"sharding": W}})
    if kind == "relaunch":
        # the gather before the placement: the restore writes whole tensors
        payloads = {}
        orig_fetch = peer.fetch_at

        def fetch_at(r, s, _o=orig_fetch):
            payloads[r] = _o(r, s)
            return payloads[r]

        peer.fetch_at = fetch_at
        t0 = time.perf_counter()
        nxt = sup.resume()
        torch.cuda.synchronize()
        res["restore_s"] = time.perf_counter() - t0
        notes = [d for k, d in sup.events if k == "resume"]
        res["tier_note"] = next((d for d in notes if "sharded" in d), None)
        res["reshard_resumes"] = sup.reshard_resumes
        res["cut_bitwise"], res["cut_detail"] = p20_cut_check(
            torch, wave, nxt - 1, model, opt)
        try:  # one rank's payload alone leaves holes: refused, not zeros
            reshard.loads_combined([payloads[0]])
            res["hole_error"] = False
        except ValueError as e:
            res["hole_error"] = "incomplete shard coverage" in str(e)
        try:
            reshard.loads_combined([payloads[r] for r in sorted(payloads)],
                                   target_layout={"world": 1,
                                                  "mesh": {"sharding": 3}})
            res["layout_error"] = False
        except reshard.ReshardLayoutError as e:
            res["layout_error"] = ("'world': 2" in str(e)
                                   and "'sharding': 3" in str(e))
        del payloads
        res["distcp_bitwise"], res["distcp_detail"] = p20_distcp_check(
            torch, wave, dev, nxt - 1)
    else:
        group_sharded_parallel(model, opt, "p_g_os")
        # rank 0's batch is corrupted once; rank 1 dies (the site's suffix
        # names it)
        sched = chaos.ChaosSchedule().at("train.kill_rank.1", P20_KILL_AT,
                                         "kill")
        if rank == 0:
            sched = sched.at("train.sdc", P20_SDC_AT, "drop")
        chaos.install(sched)
    kernels.reset_launch_counts()

    def progress():
        """Written after each step (the wave's ranks: atomically, as the
        launcher may stop rank 0 any time after rank 1's death)."""
        counts = kernels.launch_counts()
        res["per_step"] = {k: v / max(rec["executed"], 1)
                           for k, v in counts.items() if v and ":" not in k}
        want = p20_want_counts(rec["executed"], P20_SHARD_DEPTH)
        res["failures"] = [] if dev.type != "cuda" or counts == want else [
            f"launch counts {counts} != {want}"]
        res.update(losses={str(k): v for k, v in p20_losses(rec).items()},
                   first={str(k): float(w[0])
                          for k, w in sorted(rec["first"].items())},
                   anomalies=sup.anomalies, ms=ms, ledger=p20_ledger())
        if kind == "fault":
            tmp_path = Path(out) / f"progress{rank}.json.tmp"
            tmp_path.write_text(json.dumps(res))
            os.replace(tmp_path, Path(out) / f"progress{rank}.json")

    if kind == "fault":
        # run() drains the peer publish at its end: the cut's is whole
        sup.run(P20_SHARD_CUT)
        # the cut: the live shards (the step's snapshot) and the file
        # checkpoint, beside the payloads
        p20_save_shards(torch, sup, wave, rank, P20_SHARD_CUT)
        D.save_state_dict(
            {"model": reshard.place(model.state_dict(),
                                    reshard.layer_placements(model)),
             "opt": reshard.place(opt.state_dict(),
                                  reshard.optimizer_placements(opt,
                                                               [model]))},
            str(wave / "distcp"))
        sup.run(P20_SHARD_STEPS + 1)  # rank 1 dies in it
    else:
        sup.run(P20_SHARD_STEPS)
    peer.wait()
    torch.cuda.synchronize()
    progress()
    mgr.exit()
    tele.close()


def p20_save_shards(torch, sup, wave, rank, tag):
    """This rank's live local tensors with the dimension group sharding cut
    them along, saved beside the payloads for the relaunch's bitwise
    checks."""
    model, opt = sup.layers[0], sup.optimizers[0]
    gs = model._group_sharded
    by_name = {opt._name(p): p for p in opt._parameter_list}
    named = dict(model.named_parameters())
    out = {}
    for k, t in model.state_dict().items():
        s = gs.shards.get(named.get(k))
        out[f"model.{k}"] = (t.detach().cpu(), None if s is None else s.dim)
    for k, t in opt.state_dict().items():
        if torch.is_tensor(t):
            s = gs.shards.get(by_name.get(k.rpartition(".")[0]))
            dim = None if s is None or t.dim() == 0 else s.dim
            out[f"opt.{k}"] = (t.detach().cpu(), dim)
    torch.save(out, wave / f"shards_{tag}_rank{rank}.pt")


def p20_whole(torch, wave, tag):
    """The whole state from the two ranks' saved shards: each sharded
    tensor the concatenation of rank 0's and rank 1's along its dimension,
    each replicated one rank 0's."""
    parts = [torch.load(wave / f"shards_{tag}_rank{r}.pt") for r in (0, 1)]
    whole = {}
    for k, (t0, dim) in parts[0].items():
        whole[k] = t0 if dim is None else torch.cat(
            [t0, parts[1][k][0]], dim)
    return whole


def p20_cut_check(torch, wave, cut, model, opt):
    """The relaunch's restored tensors (whole, before placement) against the
    two ranks' shards at the cut, bitwise."""
    try:
        whole = p20_whole(torch, wave, cut)
    except FileNotFoundError as e:
        return False, f"no shards saved at step {cut}: {e}"
    got = {f"model.{k}": v for k, v in model.state_dict().items()}
    got.update({f"opt.{k}": v for k, v in opt.state_dict().items()
                if torch.is_tensor(v)})
    bad = [k for k, v in whole.items()
           if k not in got or not torch.equal(got[k].cpu(), v)]
    return not bad, f"step {cut}: {len(bad)} of {len(whole)} differ {bad[:4]}"


def p20_distcp_check(torch, wave, dev, tag):
    """``load_state_dict`` at world 1, into whole tensors, of the two-rank
    ``save_state_dict`` at step ``tag``, against the ranks' own shards
    saved beside it, bitwise."""
    from paddle_tpu_torch.distributed import checkpoint as dcp

    try:
        whole = p20_whole(torch, wave, tag)
    except FileNotFoundError as e:
        return False, str(e)
    target = {"model": {}, "opt": {}}
    for k, v in whole.items():
        part, _, key = k.partition(".")
        target[part][key] = torch.zeros_like(v, device=dev)
    dcp.load_state_dict(target, str(wave / "distcp"))
    bad = [k for k, v in whole.items()
           if not torch.equal(target[k.partition(".")[0]][
               k.partition(".")[2]].cpu(), v)]
    return not bad, f"{len(bad)} of {len(whole)} differ {bad[:4]}"


def trainfault_phase(torch, np, dev, args, card, tmp):
    """Phase 20: (a) rollback at full depth, (b) the disk and peer tiers
    and a kill, (c) elastic sharded training across two gloo ranks. (b)'s
    rank processes and (c)'s launches run beside (a) and the in-process
    parts of (b), each waited on by a thread here: their time goes mostly
    to host work (the peer payloads' base64 through the stores, gloo's
    staging, process starts), and the card has room for all of them; in
    turn, the three parts take about twice as long. (a)'s step, snapshot
    and restore are timed after they end."""
    import threading

    # whole before the threads start: two threads importing the same
    # package chain can deadlock on the import locks
    import paddle_tpu_torch.distributed  # noqa: F401
    import paddle_tpu_torch.incubate.checkpoint  # noqa: F401
    import paddle_tpu_torch.testing.chaos  # noqa: F401
    import paddle_tpu_torch.training  # noqa: F401

    t0 = time.perf_counter()
    beside = {}

    def run(name, fn):
        try:
            beside[name] = fn()
        except Exception as e:  # noqa: BLE001 - reported as a failure below
            beside[name] = ([f"({name}) raised {e!r}"], None)

    threads = [threading.Thread(target=run, name=f"p20{name}", args=(
        name, fn)) for name, fn in (
        ("b", lambda: p20_tf_ranks(torch, np, args, card, tmp)),
        ("c", lambda: (p20_shard_ranks(torch, np, args, card, tmp), None)))]
    for t in threads:
        t.start()
    clean_b = {}
    try:
        failures, clean, ckpt_dir, clean_run = p20_rollback_runs(
            torch, np, dev, args, card, tmp)
        failures += p20_disk_resume(torch, np, dev, args, card, clean,
                                    ckpt_dir, clean_run)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        failures += p20_corrupt_peer(torch, np, dev, args, card, tmp,
                                     out=clean_b)
    finally:
        for t in threads:
            t.join()
    p20_quiet_costs(torch, np, dev, args, card)
    for name in ("b", "c"):
        failures += beside[name][0]
    finals = beside["b"][1]
    if finals is not None and "clean" in clean_b:
        want = np.float32(clean_b["clean"][P20_TF_STEPS]).tobytes().hex()
        ok = finals == [want, want]
        if not ok:
            failures.append(f"(b) the ranks' final losses (f32 hex) {finals} "
                            f"are not bitwise a clean run's {want}")
        print(f"phase 20(b) both ranks' final losses bitwise the clean "
              f"in-process run's (step {P20_TF_STEPS}, {P20_PEER_DEPTH} layer)"
              f" {ok} [{card}]")
    print(f"phase 20 took {time.perf_counter() - t0:.1f} s [{card}]")
    if failures:
        fail("phase 20: " + "; ".join(failures))


# -- phase 21: GPT, BERT and the SD UNet -------------------------------------
# the attention shapes of phase 21's models ([B, Sq, H, D] over [B, Sk, H,
# D], MHA), each held per row by phase 2's FLASH_* and BWD_* gates:
# GPT-3-13B's train step, BERT-base's, and the SD UNet's self- and
# cross-attention (the 77-token context) at its 32x32 and 16x16 levels
P21_ATTN = (
    ("GPT-3-13B", dict(B=2, Sq=2048, Sk=2048, H=40, D=128), True),
    ("BERT-base", dict(B=8, Sq=512, Sk=512, H=12, D=64), False),
    ("UNet self 32x32", dict(B=1, Sq=1024, Sk=1024, H=10, D=64), False),
    ("UNet self 16x16", dict(B=1, Sq=256, Sk=256, H=20, D=64), False),
    ("UNet cross 32x32", dict(B=1, Sq=1024, Sk=77, H=10, D=64), False),
    ("UNet cross 16x16", dict(B=1, Sq=256, Sk=77, H=20, D=64), False),
)
P21_PROMPTS, P21_PROMPT_LEN, P21_NEW, P21_BLOCK = 4, 512, 32, 64
# phase 2's paged decode at 21(a)'s shape: its rows' lengths over the decode
P21_DECODE = dict(B=P21_PROMPTS, heads=40, lo=P21_PROMPT_LEN + 1,
                  hi=P21_PROMPT_LEN + P21_NEW,
                  pages=-(-(P21_PROMPT_LEN + P21_NEW) // P21_BLOCK))
P21_GPT_DEPTH = 2  # 21(b): GPT-3-13B's widths at two layers
P21_GPT_BATCH, P21_GPT_SEQ = 2, 2048
P21_BERT_BATCH, P21_BERT_SEQ = 8, 512
P21_BERT_MASKED = 0.15  # MLM: the share of positions with a label
P21_UNET_LATENT = (1, 4, 64, 64)  # SD-1.x at 512x512: 4 x 64 x 64 latents
P21_UNET_CONTEXT = (77, 768)  # SD-1.x's text encoder: 77 tokens of 768
P21_EAGER_STEPS = 3  # then the captured: a warm-up, the capture, replays
P21_CAPTURED_STEPS = 3
# 21(b)-(d): the first step's loss and gradients with the kernels against
# the same model on the plain paths (naive attention with its autograd
# backward), as (loss rel, worst gradient rel) per part. Each set from its
# own readings on the card (the same in four runs) with a 2.5-3.6x margin
# (PERF.md §6). The masked BERT takes no kernel: both sides run the same
# operations, bit for bit.
P21_FIRST_STEP_TOL = {
    "b": (2e-5, 2e-2),  # read 5.76e-6, 6.4e-3
    "c": (1.5e-5, 5e-2),  # read 4.69e-6, 2.01e-2
    "c masked": (0.0, 0.0),  # read 0, 0
    "d": (2e-3, 5e-2),  # read 5.58e-4, 1.67e-2
}
# 21(e): the library's own semantics on the card against independent
# float64 references: interpolate's sampling and weights, GroupNorm's
# grouping, and the f32 convolution at full f32 precision (TF32 rounds
# operands to 10 mantissa bits: a 64-channel 3x3 convolution then moves by
# ~1e-3 of its norm; f32 by ~1e-7)
P21_INTERP_ATOL = 1e-5
P21_GROUPNORM_ATOL = 1e-4
P21_CONV_REL = 1e-5


def unet_flash_calls(cfg, h: int, w: int) -> int:
    """The flash forward launches of one UNet forward at latents ``h x
    w``: two (self- and cross-attention) per spatial transformer whose
    tokens at its level (``h * w / 4**level``) are a multiple of 128 at a
    head_dim the kernels take (``nn.functional.attention._use_flash``; the
    key length, 77 for the context, does not enter). Down block i and up
    block i run at level i, the middle at the last level."""
    chs = cfg.block_out_channels

    def flash(level, c):
        heads = max(1, c // cfg.attention_head_dim)
        return ((h >> level) * (w >> level) % 128 == 0
                and c // heads in (64, 128, 256))

    n = sum((2 * cfg.layers_per_block + 1) * flash(i, c)
            for i, c in enumerate(chs) if i in cfg.attn_resolutions)
    n += flash(len(chs) - 1, chs[-1])
    return 2 * n


def p21_step_counts(flash: int, adamw: int) -> dict:
    """Launch counts of one train step with ``flash`` attentions on the
    flash path: each a forward, a dq and a dk/dv, all on the main
    variants, and ``adamw`` fused AdamW launches."""
    return {**flash_fwd_counts(flash), **flash_bwd_counts(flash),
            "fused_adamw": adamw, "paged_decode_attention": 0,
            "paged_decode_attention_int8": 0}


def _scaled(counts: dict, k: int) -> dict:
    return {n: v * k for n, v in counts.items()}


def p21_serving(torch, np, dev, args, card):
    """21(a): GPT-3-13B at full depth and width (bf16, random weights drawn
    on the card) through ``generate``: P21_PROMPTS prompts of
    P21_PROMPT_LEN tokens, P21_NEW greedy tokens, over a dense cache
    (plain attention), a paged one (the float decode kernel) and an int8
    paged one (the int8 kernel). Returns the failures."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, generate
    from paddle_tpu_torch.models.generation import _get_compiled
    from paddle_tpu_torch.ops import kernels

    failures = []
    cfg = GPTConfig.gpt3_13b()
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                           generator=torch.Generator(device=dev).manual_seed(
                               args.seed)).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = torch.randint(
        0, cfg.vocab_size, (P21_PROMPTS, P21_PROMPT_LEN),
        generator=torch.Generator().manual_seed(args.seed + 21)).to(dev)
    steps = P21_NEW - 1  # the prefill makes the first token
    L = cfg.num_hidden_layers
    runs = {}
    for kind, kw in (("dense", {}), ("paged", dict(block_size=P21_BLOCK)),
                     ("int8", dict(block_size=P21_BLOCK, kv_dtype="int8"))):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = generate(model, prompts, max_new_tokens=P21_NEW, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        want = {"paged_decode_attention": L * steps if kind == "paged" else 0,
                "paged_decode_attention_int8": (L * steps if kind == "int8"
                                                else 0),
                "flash_attention_fwd": 0}
        if any(counts[k] != n for k, n in want.items()):
            failures.append(f"(a) {kind}: launches "
                            f"{ {k: counts[k] for k in want} } != {want}")
        new = out[:, P21_PROMPT_LEN:]
        if tuple(out.shape) != (P21_PROMPTS, P21_PROMPT_LEN + P21_NEW) or \
                not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
            failures.append(f"(a) {kind}: output {tuple(out.shape)} or a "
                            f"token out of range")
        # the decode step alone: the captured program's replay
        with torch.no_grad():
            _, prefill, decode = _get_compiled(
                model, P21_PROMPTS, P21_PROMPT_LEN, P21_PROMPT_LEN + P21_NEW,
                0.0, 0, True, kw.get("block_size"),
                kv_dtype=kw.get("kv_dtype"))
            tok = prefill(prompts, torch.zeros((), dtype=torch.int32,
                                               device=dev))
            pos = torch.tensor(P21_PROMPT_LEN, dtype=torch.int32, device=dev)
            step_ms = time_ms(lambda: decode(tok, pos), 10)
        runs[kind] = dict(tokens=new.cpu().tolist(), wall=wall,
                          step_ms=step_ms, counts=counts)
    dense = runs["dense"]["tokens"]
    for kind in ("paged", "int8"):
        firsts = []
        for r, (got, want) in enumerate(zip(runs[kind]["tokens"], dense)):
            j = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                     None)
            if j is not None:
                gap = top2_gaps(torch, model, prompts[r].tolist(), want)[j]
                firsts.append((r, j, round(gap, 4)))
        runs[kind]["departures"] = firsts
        if any(g >= SPEC_GAP_BOUND for _, _, g in firsts):
            failures.append(f"(a) {kind}: tokens depart from the dense "
                            f"cache's where its top-2 gap is not a near tie "
                            f"(row, position, gap): {firsts}")
    print(f"phase 21(a) GPT-3-13B serving at full depth ({L} layers, hidden "
          f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, vocab "
          f"{cfg.vocab_size}; {model.num_params()} params, bf16, built on the "
          f"card in {build_s:.2f} s): generate {P21_PROMPTS} x "
          f"{P21_PROMPT_LEN} prompts, {P21_NEW} greedy tokens: " + "; ".join(
              f"{k} cache wall {r['wall']:.2f} s, a decode step "
              f"{r['step_ms']:.3f} ms (captured replay), decode launches a "
              f"step {r['counts']['paged_decode_attention'] / steps:g} float "
              f"/ {r['counts']['paged_decode_attention_int8'] / steps:g} int8"
              + (f", departures from dense (row, position, top-2 gap) "
                 f"{r['departures']} (bound {SPEC_GAP_BOUND})"
                 if k != "dense" else "")
              for k, r in runs.items()) + f" [{card}]")
    model.__dict__.pop("_generation_programs", None)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return failures


def p21_adamw_check(torch, model, make_opt, grads, steps=2):
    """B4 at the model's own tensor set: ``steps`` steps of a fresh
    optimizer from ``make_opt()`` on ``grads``, each fused launch's p, m
    and v copied before it and the plain version run on the copies with
    the same scalar rows, salts and bases. From the second step on the
    moments are not zero, and past MAX_TENSORS_PER_LAUNCH tensors the call
    splits into launches that read their rows at an offset. The parameters
    are restored after. Returns ``(tensors a call, {step: elements whose
    bits differ})``."""
    import paddle_tpu_torch.optimizer.optimizer as O
    from paddle_tpu_torch.ops.fused_adamw import fused_adamw_multi_update_plain

    fused = O.fused_adamw_multi_update
    diffs, sizes = {}, []

    def checked(ps, gs, ms, vs, **kw):
        want = [tuple(t.clone() for t in trio) for trio in zip(ps, ms, vs)]
        fused(ps, gs, ms, vs, **kw)
        wp, wm, wv = (list(c) for c in zip(*want))
        fused_adamw_multi_update_plain(wp, gs, wm, wv, **kw)
        sizes.append(len(ps))
        diffs.update({f"{step}:{k}": n for k, n in adamw_multi_diff(
            torch, list(zip(ps, ms, vs)), list(zip(wp, wm, wv))).items()})

    params = [p for p in model.parameters() if p.requires_grad]
    saved = [p.detach().clone() for p in params]
    opt = make_opt()
    O.fused_adamw_multi_update = checked
    try:
        for step in range(steps):
            for n, p in model.named_parameters():
                p.grad = grads.get(n)
            opt.step()
    finally:
        O.fused_adamw_multi_update = fused
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
    return sizes, diffs


def p21_train(torch, np, dev, args, card, label, build, batch, flash, tol):
    """One of 21(b)-(d): ``build()`` gives the model (bf16, on the card,
    from ``args.seed``), ``batch`` its ``loss`` arguments, ``flash`` the
    attentions a step takes on the flash path, ``tol`` the first step's
    (loss, gradient) limits; the fused AdamW launches once a step per
    MAX_TENSORS_PER_LAUNCH of the tensors with gradients (one group). The
    first step's loss and gradients with the kernels against the plain
    paths on the same weights, and two fused AdamW steps on those
    gradients bit for bit against the plain version
    (:func:`p21_adamw_check`); then P21_EAGER_STEPS eager steps and
    P21_CAPTURED_STEPS through ``jit.to_static`` (a warm-up, the capture,
    replays) with the fused AdamW of phase 7's recipe, counts gated per
    step, the loss falling. Returns the failures."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.fused_adamw import MAX_TENSORS_PER_LAUNCH
    from paddle_tpu_torch.optimizer import AdamW

    failures = []
    loss_tol, grad_tol = tol
    pt_seed(args.seed)
    model = build()

    def make_opt():
        return AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                     moment_dtype="bfloat16", use_stochastic_rounding=True,
                     fused=True)

    opt = make_opt()

    def loss_and_grads(plain):
        with plain_paths([opt]) if plain else contextlib.nullcontext():
            loss = model.loss(*batch)
            loss.backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    kernels.reset_launch_counts()
    lk, gk = loss_and_grads(False)
    first = kernels.launch_counts()
    lp, gp = loss_and_grads(True)
    loss_rel = abs(lk - lp) / max(abs(lp), 1e-30)
    worst = max(((rel_err(gk[n], gp[n]), n) for n in gp), key=lambda x: x[0])
    finite = all(bool(torch.isfinite(g).all()) for g in gk.values())
    per_step = p21_step_counts(flash, -(-len(gk) // MAX_TENSORS_PER_LAUNCH))
    del gp
    kernels.reset_launch_counts()
    sizes, adamw_diff = p21_adamw_check(torch, model, make_opt, gk)
    adamw_launches = kernels.launch_counts()["fused_adamw"]
    if sizes != [len(gk)] * 2 or adamw_diff or \
            adamw_launches != 2 * per_step["fused_adamw"]:
        failures.append(f"{label}: two fused AdamW steps over the model's "
                        f"{len(gk)} tensors (calls of {sizes}, "
                        f"{adamw_launches} launches) against the plain "
                        f"version: elements whose bits differ (step:tensor "
                        f"p|m|v) {adamw_diff}")
    del gk
    want_first = {k: v for k, v in per_step.items() if k != "fused_adamw"}
    if any(first[k] != v for k, v in want_first.items()):
        failures.append(f"{label}: the first forward and backward launched "
                        f"{ {k: first[k] for k in want_first} } != "
                        f"{want_first}")
    if not (finite and loss_rel <= loss_tol and worst[0] <= grad_tol):
        failures.append(f"{label}: first step against the plain paths: loss "
                        f"rel {loss_rel:.3g} (tol {loss_tol}), worst "
                        f"gradient rel {worst[0]:.3g} ({worst[1]}; tol "
                        f"{grad_tol}), finite {finite}")

    def step(*a):
        loss = model.loss(*a)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    compiled = jit.to_static(step, layers=[model], optimizers=[opt])
    losses, ms = [], {}
    for mode, n in (("eager", P21_EAGER_STEPS),
                    ("captured", P21_CAPTURED_STEPS)):
        with static_mode(mode == "captured"):
            kernels.reset_launch_counts()
            times = []
            for _ in range(n):
                t0 = time.perf_counter()
                losses.append(float(compiled(*batch).detach()))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            counts = kernels.launch_counts()
        ms[mode] = times
        if counts != _scaled(per_step, n):
            failures.append(f"{label} {mode}: {n} steps launched {counts} != "
                            f"{_scaled(per_step, n)}")
    graphs = len(compiled._graphs)
    if graphs != 1:
        failures.append(f"{label}: {graphs} captured graphs (want 1)")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        failures.append(f"{label}: losses {losses} non-finite or not falling")
    print(f"phase 21{label}, {model.num_params()} params: first step against "
          f"the plain paths loss {lk:.5f} vs {lp:.5f} (rel {loss_rel:.3g}, "
          f"tol {loss_tol}), worst gradient rel {worst[0]:.3g} "
          f"({worst[1]}; tol {grad_tol}); two fused AdamW steps on those "
          f"gradients over {sizes[0]} tensors ({adamw_launches} launches) "
          f"bitwise the plain version's: {not adamw_diff}; launches a step "
          f"{ {k: v for k, v in per_step.items() if v and ':' not in k} }; "
          f"losses {[round(x, 5) for x in losses]} ({P21_EAGER_STEPS} eager, "
          f"then captured: warm-up, capture, replay); ms a step eager "
          f"{[round(t, 1) for t in ms['eager']]}, captured "
          f"{[round(t, 1) for t in ms['captured']]} (the last a replay) "
          f"[{card}]")
    del model, opt, compiled
    gc.collect()
    torch.cuda.empty_cache()
    return failures


def _np_resize_weights(np, n_in: int, n_out: int, cubic: bool):
    """``jax.image.resize``'s antialiased weights in float64, ``[n_in,
    n_out]``, written out independently of the port."""
    inv = n_in / n_out
    ks = max(inv, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / ks
    if cubic:
        w = np.where(x >= 2, 0.0, np.where(
            x >= 1, ((-0.5 * x + 2.5) * x - 4) * x + 2,
            ((1.5 * x - 2.5) * x) * x + 1))
    else:
        w = np.maximum(0.0, 1 - x)
    w = w / w.sum(0, keepdims=True)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def p21_semantics(torch, np, dev, card):
    """21(e): the layers' semantics on the card against float64 references
    written here: ``interpolate`` (half-pixel nearest and the antialiased
    bilinear and bicubic weights, up and down, non-integer), ``GroupNorm``
    (contiguous channel groups, channels first and last) and the f32
    convolution with ``cudnn.allow_tf32`` set globally (the library must
    keep TF32 off). Returns the failures."""
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.nn import functional as F

    failures, shown = [], []
    rs = np.random.RandomState(21)
    x = rs.randn(2, 3, 10, 12)
    xt = torch.from_numpy(x).float().to(dev)
    for size, mode in (([14, 18], "nearest"), ([7, 5], "nearest"),
                       ([20, 24], "nearest"), ([15, 17], "bilinear"),
                       ([6, 7], "bilinear"), ([13, 9], "bicubic")):
        got = F.interpolate(xt, size=size, mode=mode).double().cpu().numpy()
        if mode == "nearest":
            iy = np.floor((np.arange(size[0]) + 0.5) * 10 / size[0]).astype(int)
            ix = np.floor((np.arange(size[1]) + 0.5) * 12 / size[1]).astype(int)
            want = x[:, :, iy][:, :, :, ix]
        else:
            wy = _np_resize_weights(np, 10, size[0], mode == "bicubic")
            wx = _np_resize_weights(np, 12, size[1], mode == "bicubic")
            want = np.einsum("nchw,hy,wx->ncyx", x, wy, wx)
        err = float(np.abs(got - want).max())
        shown.append(f"{mode} {size} {err:.2g}")
        if err > P21_INTERP_ATOL:
            failures.append(f"(e) interpolate {mode} 10x12 -> {size}: max abs "
                            f"err {err:.3g} against the half-pixel reference "
                            f"(tol {P21_INTERP_ATOL})")
    g = rs.randn(2, 64, 9, 7) * 3 + 1
    for fmt in ("NCHW", "NHWC"):
        gn = tnn.GroupNorm(8, 64, data_format=fmt, device=dev)
        arr = g if fmt == "NCHW" else g.transpose(0, 2, 3, 1)
        with torch.no_grad():
            got = gn(torch.from_numpy(np.ascontiguousarray(arr)).float().to(
                dev)).double().cpu().numpy()
        if fmt == "NHWC":
            got = got.transpose(0, 3, 1, 2)
        grp = g.reshape(2, 8, -1)
        want = ((grp - grp.mean(-1, keepdims=True))
                / np.sqrt(grp.var(-1, keepdims=True) + 1e-5)).reshape(g.shape)
        err = float(np.abs(got - want).max())
        shown.append(f"GroupNorm {fmt} {err:.2g}")
        if err > P21_GROUPNORM_ATOL:
            failures.append(f"(e) GroupNorm(8, 64) {fmt}: max abs err "
                            f"{err:.3g} against contiguous channel groups "
                            f"(tol {P21_GROUPNORM_ATOL})")
    a = torch.from_numpy(rs.randn(1, 64, 32, 32))
    w = torch.from_numpy(rs.randn(64, 64, 3, 3) / 24)
    want = torch.nn.functional.conv2d(a, w, padding=1)
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = F.conv2d(a.float().to(dev), w.float().to(dev), padding=1)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = was
    conv_rel = rel_err(got.double().cpu(), want)
    shown.append(f"f32 conv under a global allow_tf32 {conv_rel:.2g}")
    if conv_rel > P21_CONV_REL:
        failures.append(f"(e) f32 conv2d 64->64 3x3 on 32x32 with "
                        f"cudnn.allow_tf32 set globally: rel err "
                        f"{conv_rel:.3g} against float64 (tol {P21_CONV_REL};"
                        f" TF32 took the call)")
    print(f"phase 21(e) layer semantics on the card against float64 "
          f"references (max abs err; the conv's norm-relative): "
          f"{'; '.join(shown)} (tols interpolate {P21_INTERP_ATOL}, GroupNorm "
          f"{P21_GROUPNORM_ATOL}, conv {P21_CONV_REL}) [{card}]")
    return failures


def models_phase(torch, np, dev, args, card):
    """Phase 21: (a) GPT-3-13B serving at full depth over three caches;
    (b) its train step at full width, P21_GPT_DEPTH layers; (c) the
    BERT-base MLM fine-tune without and with a padding mask; (d) the SD
    UNet's train step at the JAX package's default ``UNetConfig()``; (e)
    the layers' semantics. Fails the run on any failure, after all parts
    have run."""
    from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                         GPTConfig, GPTForCausalLM,
                                         UNet2DConditionModel, UNetConfig)

    t_phase = time.perf_counter()
    failures = p21_semantics(torch, np, dev, card)
    failures += p21_serving(torch, np, dev, args, card)
    bf16 = dict(device=dev, dtype=torch.bfloat16)
    rs = np.random.RandomState(args.seed + 21)

    gcfg = GPTConfig.gpt3_13b(num_hidden_layers=P21_GPT_DEPTH)
    ids = torch.from_numpy(rs.randint(0, gcfg.vocab_size, (
        P21_GPT_BATCH, P21_GPT_SEQ))).to(dev)
    failures += p21_train(
        torch, np, dev, args, card,
        f"(b) GPT-3-13B train step, full width at {P21_GPT_DEPTH} layers, "
        f"B={P21_GPT_BATCH} S={P21_GPT_SEQ} bf16, fused AdamW (bf16 "
        f"moments, SR)", lambda: GPTForCausalLM(gcfg, **bf16),
        (ids, ids), P21_GPT_DEPTH, P21_FIRST_STEP_TOL["b"])

    bcfg = BertConfig.base()
    ids = rs.randint(0, bcfg.vocab_size, (P21_BERT_BATCH, P21_BERT_SEQ))
    labels = np.where(rs.rand(*ids.shape) < P21_BERT_MASKED, ids, -100)
    mask = np.ones_like(ids)
    for r in range(1, P21_BERT_BATCH):  # row r padded from 512 - 32 r on
        mask[r, P21_BERT_SEQ - 32 * r:] = 0
    ids, labels, mask = (torch.from_numpy(a).to(dev)
                         for a in (ids, labels, mask))
    for masked in (False, True):
        failures += p21_train(
            torch, np, dev, args, card,
            f"(c) BERT-base MLM fine-tune ({bcfg.num_hidden_layers} layers), "
            f"B={P21_BERT_BATCH} S={P21_BERT_SEQ} bf16, "
            + ("a padding mask (plain attention)" if masked else
               "no mask (flash)"),
            lambda: BertForMaskedLM(bcfg, **bf16),
            (ids, labels) + ((mask,) if masked else ()),
            0 if masked else bcfg.num_hidden_layers,
            P21_FIRST_STEP_TOL["c masked" if masked else "c"])

    ucfg = UNetConfig()
    b, c, h, w = P21_UNET_LATENT
    gen = torch.Generator().manual_seed(args.seed + 22)
    sample, noise = (torch.randn(P21_UNET_LATENT, generator=gen).to(
        dev, torch.bfloat16) for _ in range(2))
    context = torch.randn((b,) + P21_UNET_CONTEXT, generator=gen).to(
        dev, torch.bfloat16)
    t = torch.randint(0, 1000, (b,), generator=gen).to(dev)
    n_flash = unet_flash_calls(ucfg, h, w)
    failures += p21_train(
        torch, np, dev, args, card,
        f"(d) SD UNet train step, UNetConfig() (channels "
        f"{ucfg.block_out_channels}), latents {list(P21_UNET_LATENT)}, "
        f"context {[b, *P21_UNET_CONTEXT]}, bf16, {n_flash} flash attentions "
        f"a forward", lambda: UNet2DConditionModel(ucfg, **bf16),
        (sample, t, context, noise), n_flash, P21_FIRST_STEP_TOL["d"])
    print(f"phase 21 took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        fail("phase 21: " + " | ".join(failures))


# -- phase 22: ResNet-50 and the pooling layers --------------------------------
P22_BATCH, P22_IMAGE, P22_CLASSES = 128, 224, 1000
P22_PARAMS = 25_557_032  # ResNet-50 at 1000 classes (tests/test_vision.py:90)
P22_SUB = 4  # (a): the float64 gate's sub-batch
P22_LR = 0.01  # (a): tests/test_vision.py:122's SGD recipe
P22_EAGER_STEPS = 3  # (a): then the captured: a warm-up, the capture, replays
P22_CAPTURED_STEPS = 4
P22_TURNS = ("eager", "replay", "replay", "eager") * 2  # (a): timed steps
# (b): benchmarks/convergence_resnet.py:60's optimizer, with the fused step
P22_ADAMW = dict(learning_rate=1e-3, weight_decay=1e-4)
P22_TENSORS = 161  # 53 convolution weights, 53 BatchNorm pairs, fc's two
# (a): the first step on P22_SUB images in f32 (TF32 off in every
# convolution and GEMM) against the same model in float64, the loss
# relative and each gradient norm-relative. Reasoned before the first card
# call: f32 rounds each product and sum to ~6e-8 relative; over ~50 layers
# with BatchNorm renormalizing each, the loss (~7 nats) carries ~1e-6;
# gradients ~1e-4 at the worst of the 161 tensors (gate then 1e-2). The
# card read loss 1.76e-6 and worst gradients of 2.67e-2 at a BatchNorm
# shift (layer1.2.bn1.bias) and 2.16e-2 at a convolution weight
# (layer1.0.conv2.weight), the same in two calls: each sums its channel's
# upstream gradient (times the input, for a weight) over 4 x 56 x 56
# positions, and the next train-mode BatchNorm leaves that gradient nearly
# zero-mean, so the sum cancels to a few percent of its terms and keeps
# their absolute rounding (the CPU's f32, in the reference and the port
# alike, strays as far from float64 at small sizes). 0.1 is ~4x those
# readings; a wrong backward moves a gradient by its own size
P22_LOSS_REL = 1e-5
P22_GRAD_REL = 0.1
# (c): the pools against float64 on the same f32 inputs: a max and its
# index exactly (a max of f32 values is one of them); a mean of 9 (avg
# pool) or 12544 (the global pool) f32 values, summed in f32, to ~1e-6
P22_AVG_ATOL = 1e-5
P22_STEM = (P22_BATCH, 64, 112, 112)  # ResNet's stem output


def sync(torch, dev):
    """Wait for the card (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()


def p22_batch(torch, dev, seed):
    """Seeded random images ``[B, 3, H, W]`` and labels in [0, classes)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 22)
    x = torch.randn((P22_BATCH, 3, P22_IMAGE, P22_IMAGE), generator=gen,
                    device=dev)
    y = torch.randint(0, P22_CLASSES, (P22_BATCH,), generator=gen,
                      device=dev)
    return x, y


def p22_resnet(torch, dev, dtype=None):
    from paddle_tpu_torch.vision.models import resnet50

    return resnet50(num_classes=P22_CLASSES, device=dev,
                    dtype=dtype or torch.float32)


def p22_stats(model):
    """The BatchNorm running statistics, by name."""
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("_mean", "_variance"))}


def p22_f64_gate(torch, dev, model, x, y):
    """(a)'s first step on ``P22_SUB`` images against a float64 twin on the
    same weights and statistics: (loss rel, {"weights" | "vectors": (worst
    gradient rel, name)}, tensors with gradients). ``model`` is left as it
    was."""
    from paddle_tpu_torch.nn import functional as F

    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    twin = p22_resnet(torch, dev, torch.float64)
    twin.load_state_dict({k: v.double() if v.is_floating_point() else v
                          for k, v in saved.items()})
    out = []
    for m, dt in ((model, torch.float32), (twin, torch.float64)):
        m.train()
        loss = F.cross_entropy(m(x[:P22_SUB].to(dt)), y[:P22_SUB])
        loss.backward()
        out.append((float(loss.detach()),
                    {n: p.grad.detach().clone() for n, p in
                     m.named_parameters() if p.grad is not None}))
        m.zero_grad(set_to_none=True)
    model.load_state_dict(saved)
    (l32, g32), (l64, g64) = out
    worst = {}
    for kind in ("weights", "vectors"):
        rows = [(rel_err(g32[n].double(), g64[n]), n) for n in g64
                if (g64[n].dim() > 1) == (kind == "weights")]
        worst[kind] = max(rows, key=lambda t: t[0])
    del twin
    return abs(l32 - l64) / abs(l64), worst, len(g64)


def p22_recipe(torch, np, dev, args, card):
    """22(a) and (b); returns the failures."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import SGD, AdamW

    failures = []
    pt_seed(args.seed)
    model = p22_resnet(torch, dev)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != P22_PARAMS:
        failures.append(f"(a) ResNet-50 holds {n_params} parameters, not "
                        f"{P22_PARAMS}")
    x, y = p22_batch(torch, dev, args.seed)
    loss_rel, worst, n_grads = p22_f64_gate(torch, dev, model, x, y)
    gate = (f"loss rel {loss_rel:.3g} (tol {P22_LOSS_REL}), worst gradient "
            f"rel of the weights {worst['weights'][0]:.3g} at "
            f"{worst['weights'][1]}, of the 1-d tensors (BatchNorm, fc's "
            f"bias) {worst['vectors'][0]:.3g} at {worst['vectors'][1]} (tol "
            f"{P22_GRAD_REL}) over {n_grads} tensors")
    if not (loss_rel <= P22_LOSS_REL
            and worst["weights"][0] <= P22_GRAD_REL
            and worst["vectors"][0] <= P22_GRAD_REL
            and n_grads == P22_TENSORS):
        failures.append(f"(a) the first step on {P22_SUB} images against "
                        f"float64: {gate} (want {P22_TENSORS})")
    twin = p22_resnet(torch, dev)  # the eager twin, on the same state
    twin.load_state_dict(model.state_dict())
    opt = SGD(learning_rate=P22_LR, parameters=model.parameters())
    twin_opt = SGD(learning_rate=P22_LR, parameters=twin.parameters())

    def body(m, o):
        def step(a, b):
            loss = F.cross_entropy(m(a), b)
            loss.backward()
            o.step()
            o.clear_grad()
            return loss
        return step

    compiled = jit.to_static(body(model, opt), layers=[model],
                             optimizers=[opt])
    twin_step = body(twin, twin_opt)
    losses, stats_equal, worst_stat, losses_equal = [], [], 0.0, True
    for mode, n in (("eager", P22_EAGER_STEPS),
                    ("captured", P22_CAPTURED_STEPS)):
        with static_mode(mode == "captured"):
            for _ in range(n):
                loss = compiled(x, y)
                twin_loss = twin_step(x, y)
                losses.append(float(loss.detach()))
                losses_equal &= bool(torch.equal(loss.detach(),
                                                 twin_loss.detach()))
                mine, ref = p22_stats(model), p22_stats(twin)
                stats_equal.append(all(torch.equal(mine[k], ref[k])
                                       for k in ref))
                worst_stat = max([worst_stat] + [
                    float((mine[k] - ref[k]).abs().max()) for k in ref])
    graphs = len(compiled._graphs)
    want_graphs = 1 if dev.type == "cuda" else 0
    if graphs != want_graphs:
        failures.append(f"(a) {graphs} captured graphs (want {want_graphs})")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        failures.append(f"(a) losses {losses} non-finite or not falling")
    if not all(stats_equal) or not losses_equal:
        failures.append(f"(a) the BatchNorm running statistics after each "
                        f"step bitwise the eager twin's: {stats_equal} "
                        f"(worst {worst_stat:.3g}); losses bitwise "
                        f"{losses_equal}")
    ms = {"eager": [], "replay": []}
    for turn in P22_TURNS:
        sync(torch, dev)
        t0 = time.perf_counter()
        if turn == "eager":
            twin_step(x, y)
        else:
            compiled(x, y)
        sync(torch, dev)
        ms[turn].append((time.perf_counter() - t0) * 1e3)
    print(f"phase 22(a) ResNet-50 ({n_params} params, {P22_CLASSES} "
          f"classes) f32, B={P22_BATCH} at {P22_IMAGE} px, SGD lr {P22_LR} "
          f"over one batch: the first step on {P22_SUB} images against "
          f"float64 {gate}; losses {[round(v, 5) for v in losses]} "
          f"({P22_EAGER_STEPS} eager, then captured: warm-up, capture, "
          f"replays; {graphs} graph); BatchNorm statistics bitwise an eager "
          f"twin's after each step {stats_equal} (worst {worst_stat:.3g}), "
          f"losses bitwise {losses_equal}; ms a step eager "
          f"{[round(t, 2) for t in ms['eager']]}, replayed "
          f"{[round(t, 2) for t in ms['replay']]} (in turns "
          f"{'/'.join(t[0] for t in P22_TURNS)}); images/s eager "
          f"{P22_BATCH / (min(ms['eager']) / 1e3):.1f}, replayed "
          f"{P22_BATCH / (min(ms['replay']) / 1e3):.1f} [{card}]")
    del compiled, twin, twin_opt, opt

    # (b): the convergence recipe's optimizer, B4 over the model's tensors
    loss = F.cross_entropy(model(x), y)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)

    def make_opt():
        return AdamW(parameters=model.parameters(), fused=True, **P22_ADAMW)

    kernels.reset_launch_counts()
    sizes, adamw_diff = p21_adamw_check(torch, model, make_opt, grads)
    launches = kernels.launch_counts()["fused_adamw"]
    want_launches = 2 if dev.type == "cuda" else 0
    if sizes != [P22_TENSORS] * 2 or adamw_diff or launches != want_launches:
        failures.append(f"(b) two fused AdamW steps: calls over {sizes} "
                        f"tensors (want {P22_TENSORS} twice), {launches} "
                        f"launches (want {want_launches}), elements whose "
                        f"bits differ from the plain version's {adamw_diff}")
    times = p22_adamw_times(torch, dev, model, grads) \
        if dev.type == "cuda" else "not measured (no card)"
    print(f"phase 22(b) AdamW(fused=True, lr {P22_ADAMW['learning_rate']}, "
          f"weight_decay {P22_ADAMW['weight_decay']}), f32 moments, on "
          f"ResNet-50's gradients at B={P22_BATCH}: two steps, calls over "
          f"{sizes} tensors, {launches} launches, bitwise the plain "
          f"version's: {not adamw_diff}; {times} [{card}]")
    del model, grads
    return failures


def p22_adamw_times(torch, dev, model, grads):
    """B4 at ResNet-50's tensor set (f32 p, g, m, v, no SR), on copies: the
    kernel's device time, a wrapper call's, the plain version's and torch's
    fused AdamW's (another function, for scale), beside the bound."""
    from paddle_tpu_torch.ops.fused_adamw import (
        adamw_scalars_multi, fused_adamw_hbm_bytes, fused_adamw_multi_update,
        fused_adamw_multi_update_plain)

    named = [(n, p) for n, p in model.named_parameters() if n in grads]
    ps = [p.detach().clone() for _, p in named]
    gs = [grads[n] for n, _ in named]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    t = len(ps)
    pows = torch.full((t,), 0.9, device=dev), torch.full((t,), 0.999,
                                                         device=dev)
    scalars = adamw_scalars_multi(
        lr=P22_ADAMW["learning_rate"], epsilon=1e-8, beta1_pow=pows[0],
        beta2_pow=pows[1], weight_decay=P22_ADAMW["weight_decay"])

    def launch():
        fused_adamw_multi_update(ps, gs, ms, vs, scalars=scalars, beta1=0.9,
                                 beta2=0.999)

    kernel_ms, how = device_ms(launch, "adamw_multi_kernel", 10)
    call_ms = time_ms(launch, 10)
    plain_ms = time_ms(lambda: fused_adamw_multi_update_plain(
        ps, gs, ms, vs, scalars=scalars, beta1=0.9, beta2=0.999), 1,
        warmup=1)
    steps = [torch.tensor(3.0, device=dev) for _ in range(t)]
    lib_ms = time_ms(lambda: torch._fused_adamw_(
        ps, gs, ms, vs, [], steps, lr=P22_ADAMW["learning_rate"], beta1=0.9,
        beta2=0.999, weight_decay=P22_ADAMW["weight_decay"], eps=1e-8,
        amsgrad=False, maximize=False), 10)
    n = sum(p.numel() for p in ps)
    nbytes = fused_adamw_hbm_bytes(n, torch.float32, torch.float32,
                                   torch.float32)
    b_ms, b_by = bound(nbytes, 10.0 * n, F32_FLOPS_PER_S)
    return (f"B4 over these {t} tensors ({n} elements): kernel ms "
            f"{kernel_ms:.4f} ({how}), a wrapper call {call_ms:.4f}, bound "
            f"{b_ms:.4f} ({b_by}, {nbytes / 1e9:.3f} GB), "
            f"{100 * b_ms / kernel_ms:.1f}% of bound; plain ms "
            f"{plain_ms:.3f}; torch._fused_adamw_ (another function) "
            f"{lib_ms:.4f}")


def p22_pool_reference(torch, x64, k, s, p, ceil_mode, fill):
    """Windows of ``x64`` (float64) as the reference lays them: padded by
    ``p`` with ``fill`` (and, in ceil mode, on the high side to the last
    partial window), ``[N, C, oh, ow, k*k]``."""
    h, w = x64.shape[-2:]
    hi = []
    for size in (h, w):
        rem = (size + 2 * p - k) % s
        hi.append(p + (s - rem if ceil_mode and rem else 0))
    xp = torch.nn.functional.pad(x64, (p, hi[1], p, hi[0]), value=fill)
    win = xp.unfold(2, k, s).unfold(3, k, s)
    return win.reshape(*win.shape[:4], k * k)


def p22_pools(torch, np, dev, args, card):
    """22(c): the pools at ResNet's stem shape on signed inputs against
    float64; returns the failures."""
    from paddle_tpu_torch.nn import functional as F

    failures = []
    gen = torch.Generator(device=dev).manual_seed(args.seed + 23)
    x = torch.randn(P22_STEM, generator=gen, device=dev)
    x64 = x.double()
    res = {}
    # max_pool2d(3, 2, 1) with its mask: padded with -inf, first max wins
    out, mask = F.max_pool2d(x, 3, 2, 1, return_mask=True)
    win = p22_pool_reference(torch, x64, 3, 2, 1, False, float("-inf"))
    want, arg = win.max(-1)
    oy = torch.arange(want.shape[2], device=dev).reshape(1, 1, -1, 1)
    ox = torch.arange(want.shape[3], device=dev).reshape(1, 1, 1, -1)
    idx = (oy * 2 + arg // 3 - 1) * x.shape[3] + (ox * 2 + arg % 3 - 1)
    res["max"] = int((out.double() != want).sum())
    res["mask"] = int((mask.long() != idx).sum())
    del win, want, arg, idx, out, mask
    # the global average (ResNet's head) and a ceil-mode average both ways
    g = F.adaptive_avg_pool2d(x, 1)
    res["adaptive"] = float((g.double() - x64.mean((2, 3), keepdim=True))
                            .abs().max())
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=torch.float64,
                      device=dev)
    sums = p22_pool_reference(torch, x64, 3, 2, 1, True, 0.0).sum(-1)
    counts = p22_pool_reference(torch, ones, 3, 2, 1, True, 0.0).sum(-1)
    for exclusive in (True, False):
        got = F.avg_pool2d(x, 3, 2, 1, ceil_mode=True, exclusive=exclusive)
        want = sums / (counts if exclusive else 9.0)
        if got.shape != want.shape:
            res[f"avg_exclusive={exclusive}"] = float("inf")
            continue
        res[f"avg_exclusive={exclusive}"] = float(
            (got.double() - want).abs().max())
    exact = res["max"] == 0 and res["mask"] == 0
    close = all(res[k] <= P22_AVG_ATOL for k in res if k not in
                ("max", "mask"))
    if not (exact and close):
        failures.append(f"(c) pools at {list(P22_STEM)} against float64: "
                        f"{res} (max and mask exactly, averages to "
                        f"{P22_AVG_ATOL})")
    print(f"phase 22(c) pools at ResNet's stem shape {list(P22_STEM)} on "
          f"signed inputs against float64: max_pool2d(3, 2, 1) elements "
          f"off {res['max']}, mask indices off {res['mask']}; "
          f"adaptive_avg_pool2d(1) max err {res['adaptive']:.3g}; "
          f"avg_pool2d(3, 2, 1, ceil_mode) exclusive max err "
          f"{res['avg_exclusive=True']:.3g}, inclusive "
          f"{res['avg_exclusive=False']:.3g} (tol {P22_AVG_ATOL}) [{card}]")
    return failures


def vision_phase(torch, np, dev, args, card):
    """Phase 22: (a) ResNet-50 at full width through the reference's SGD
    recipe, eager and captured; (b) the convergence recipe's fused AdamW
    on its gradients; (c) the pools at the stem's shape; (d) ``nms`` and
    ``roi_align`` at a detection-sized input against the CPU. Fails the
    run on any failure, after all parts have run. The phase runs with
    cuDNN's deterministic algorithms (restored after)."""
    t_phase = time.perf_counter()
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        failures = p22_recipe(torch, np, dev, args, card)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        failures += p22_pools(torch, np, dev, args, card)
        failures += p22_detection(torch, np, dev, args, card)
    finally:
        torch.backends.cudnn.deterministic = was
    print(f"phase 22 took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        fail("phase 22: " + " | ".join(failures))


P22_NMS_BOXES = 4000  # (d): an RPN's proposals before NMS (pre_nms_top_n)
P22_NMS_IOU = 0.7
P22_FPN = (2, 256, 200, 272)  # (d): an FPN level at stride 4 of 800 x 1088
P22_ROIS = 512  # (d): boxes an image, roi_align to 7 x 7
# (d): card against CPU. The card divides by a scalar as a product with its
# reciprocal, so a sample's coordinate (up to 272 here, where an f32 ulp is
# 3.05e-5) can land one ulp off the CPU's; a bilinear sample then moves by
# that ulp times its neighbours' difference (up to ~8 for N(0, 1) inputs).
# The first card call read 6.32e-5 (tol then 1e-5); 3e-4 bounds an ulp of
# every coordinate at the largest neighbour step
P22_ROI_ATOL = 3e-4


def p22_detection(torch, np, dev, args, card):
    """22(d): ``nms`` and ``roi_align`` at a detection-sized input on the
    card against the same functions on the CPU; returns the failures."""
    from paddle_tpu_torch.vision import ops

    failures = []
    rng = np.random.RandomState(args.seed + 24)
    n, c, h, w = P22_FPN
    xy = rng.rand(P22_NMS_BOXES, 2) * [w * 4, h * 4]
    wh = rng.rand(P22_NMS_BOXES, 2) * 200 + 8
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.permutation(P22_NMS_BOXES).astype(np.float32)
    scores /= P22_NMS_BOXES
    cats = rng.randint(0, 4, P22_NMS_BOXES)
    b_d, s_d = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
    res, ms = {}, {}
    for label, kw in (("plain", {}), ("categories", dict(
            category_idxs=torch.from_numpy(cats).to(dev),
            categories=[0, 1, 2, 3]))):
        sync(torch, dev)
        t0 = time.perf_counter()
        keep = ops.nms(b_d, P22_NMS_IOU, s_d, **kw)
        sync(torch, dev)
        ms[f"nms {label}"] = (time.perf_counter() - t0) * 1e3
        cpu_kw = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                  for k, v in kw.items()}
        want = ops.nms(torch.from_numpy(boxes), P22_NMS_IOU,
                       torch.from_numpy(scores), **cpu_kw)
        res[f"nms {label}"] = (int(keep.numel()), bool(torch.equal(
            keep.cpu(), want)))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 25)
    x = torch.randn(P22_FPN, generator=gen, device=dev)
    rxy = rng.rand(n * P22_ROIS, 2) * [w * 4 - 64, h * 4 - 64]
    rwh = rng.rand(n * P22_ROIS, 2) * 256 + 16
    rois = np.concatenate([rxy, rxy + rwh], 1).astype(np.float32)
    num = np.full(n, P22_ROIS, np.int64)
    args_d = (x, torch.from_numpy(rois).to(dev), torch.from_numpy(num).to(dev))
    sync(torch, dev)
    t0 = time.perf_counter()
    got = ops.roi_align(*args_d, output_size=7, spatial_scale=0.25)
    sync(torch, dev)
    ms["roi_align"] = (time.perf_counter() - t0) * 1e3
    want = ops.roi_align(x.cpu(), torch.from_numpy(rois),
                         torch.from_numpy(num), output_size=7,
                         spatial_scale=0.25)
    err = float((got.cpu() - want).abs().max())
    if not all(same for _, same in res.values()) or not err <= P22_ROI_ATOL:
        failures.append(f"(d) card against CPU: nms (kept, equal) {res}; "
                        f"roi_align max err {err:.3g} (tol {P22_ROI_ATOL})")
    print(f"phase 22(d) nms over {P22_NMS_BOXES} boxes at IoU "
          f"{P22_NMS_IOU}, plain and over 4 categories: (kept, indices equal "
          f"to the CPU's) {res}; roi_align of {n} x {P22_ROIS} boxes to 7x7 "
          f"on {list(P22_FPN)} at scale 1/4: max err against the CPU "
          f"{err:.3g} (tol {P22_ROI_ATOL}); ms on the card (first call, "
          f"host sweep included) { {k: round(v, 2) for k, v in ms.items()} } "
          f"[{card}]")
    return failures


def kernel_class(name: str) -> str:
    """Bucket a profiled kernel name for the training step's time split."""
    n = name.lower()
    if "flash_fwd" in n:
        return "attention forward"
    if any(k in n for k in ("flash_bwd", "dq_scalar", "dkv_scalar")):
        return "attention backward"
    if "adamw_multi_kernel" in n:
        return "AdamW kernel"
    if any(k in n for k in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
        return "GEMMs"
    if any(k in n for k in ("logsumexp", "softmax", "nll", "reduce")):
        return "reductions (loss, norms)"
    return "elementwise and copies"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of phase 17's two-rank launch (the launcher passes these)
    ap.add_argument("--rank17", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parts", default="bc", help=argparse.SUPPRESS)
    ap.add_argument("--steps", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    bytecode_cache()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    if args.rank17:
        return phase17_rank(args.rank17, args.out, args.seed, args.parts,
                            args.steps or None)
    try:
        from paddle_tpu_torch import seed as pt_seed
        from paddle_tpu_torch.inference import ContinuousBatchingEngine
        from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                             generate)
        from paddle_tpu_torch.ops import kernels
        from paddle_tpu_torch.ops.paged_attention import paged_decode
        from paddle_tpu_torch.utils import load_jax_params
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    if any(m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu") for m in sys.modules):
        fail("JAX or the JAX package was imported")

    t_start = time.perf_counter()
    starts = []  # (phase, seconds after t_start), printed before the total
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    build_s = kernels.build()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s wall for "
          f"{json.dumps(build_s)} (one nvcc per source, in parallel)")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    gen_cpu = torch.Generator(device="cpu").manual_seed(args.seed)

    starts.append(("2", time.perf_counter() - t_start))
    # -- phase 2 ---------------------------------------------------------
    def show_paged(label, r, r8, heads=16):
        print(f"phase 2 paged_decode {label} H=KVH={heads} D=128 bs={r['bs']} "
              f"live_tokens={r['live_tokens']} splits x pages={r['splits']}: "
              f"max_abs_err={r['max_abs_err']:.3g} "
              f"rel_err={r['rel_err']:.3g} worst row rel_err="
              f"{r['row_rel']:.3g} (atol {PAGED_ATOL} + rtol {RTOL}, row rel "
              f"{PAGED_ROW_REL}); against the plain version in f32: "
              f"max_abs_err={r['f32_max_abs_err']:.3g} worst row rel_err="
              f"{r['f32_row_rel']:.3g} (atol {PAGED_F32_ATOL} + rtol "
              f"{PAGED_F32_RTOL}, row rel {PAGED_F32_ROW_REL}; atol needed "
              f"{r['f32_atol_needed']:.3g}); a wrapper call "
              f"{r['call_ms']:.4f} ms, plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) [{card}]")
        if r8 is not None:
            print(f"phase 2 paged_decode_int8 {label} H=KVH={heads} D=128 "
                  f"bs={r8['bs']} "
                  f"int8 pools, f32 scales, bf16 q, same tables: "
                  f"max_abs_err={r8['max_abs_err']:.3g} "
                  f"rel_err={r8['rel_err']:.3g} worst row rel_err="
                  f"{r8['row_rel']:.3g} (atol {INT8_ATOL} + rtol "
                  f"{INT8_RTOL}, row rel {INT8_ROW_REL}); against the plain "
                  f"version in f32: max_abs_err={r8['f32_max_abs_err']:.3g} "
                  f"worst row rel_err={r8['f32_row_rel']:.3g} (atol "
                  f"{INT8_F32_ATOL} + rtol {INT8_F32_RTOL}, row rel "
                  f"{INT8_F32_ROW_REL}; atol needed "
                  f"{r8['f32_atol_needed']:.3g}); a wrapper call "
                  f"{r8['call_ms']:.4f} ms, plain_ms={r8['plain_ms']:.4f} "
                  f"bound_ms={r8['bound_ms']:.4f} ({r8['bound_by']}) "
                  f"[{card}]")

    # kernels timed by device time in phase 9: (label, row with "device")
    device_rows = []
    paged_rows = []
    for B in (16, 64):
        r, r8 = paged_case(torch, dev, gen, gen_cpu, B, int8=B == 16)
        paged_rows.append(r)
        device_rows.append((f"paged_decode B={B}", r))
        if r8 is not None:
            int8_row = r8
            device_rows.append((f"paged_decode_int8 B={B}", r8))
        show_paged(f"B={B}", r, r8)
    flash_rows = []
    for causal, hkv in ((True, 16), (False, 16), (True, 4)):
        r = flash_case(torch, dev, gen, causal, hkv)
        flash_rows.append(r)
        print(f"phase 2 flash_fwd B=4 S=2048 H=16 KVH={hkv} D=128 "
              f"causal={causal} variant={r['variant']}: "
              f"max_abs_err={r['max_abs_err']:.3g} rel_err={r['rel_err']:.3g} "
              f"(atol {FLASH_ATOL} + rtol {RTOL}) lse_err={r['lse_err']:.3g} "
              f"(atol {FLASH_LSE_ATOL}); against the plain version in f32 "
              f"with P rounded to bf16: worst row rel_err={r['row_rel']:.4g} "
              f"(row rel {FLASH_ROW_REL}) max_abs_err="
              f"{r['f32_max_abs_err']:.3g} (atol {FLASH_F32_ATOL} + rtol "
              f"{FLASH_F32_RTOL}) ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) {r['rate']}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound, "
              f"library_ms(sdpa)={r['library_ms']:.4f} [{card}]")

    bwd_rows = []
    for causal, hkv in ((True, 16), (False, 16), (True, 4)):
        r = flash_bwd_case(torch, dev, gen, causal, hkv)
        bwd_rows.append(r)
        g = r["gate"]
        errs = " ".join(f"{n}={g[n]['max_abs_err']:.3g}/{g[n]['rel_err']:.3g}"
                        for n in ("dq", "dk", "dv"))
        rows = " ".join(f"{n}={g[n]['row_rel']:.4g}/{g[n]['f32_max_abs_err']:.3g}"
                        f"/{g[n]['f32_atol_needed']:.3g}"
                        for n in ("dq", "dk", "dv"))
        print(f"phase 2 flash_bwd B=4 S=2048 H=16 KVH={hkv} D=128 "
              f"causal={causal} variant={r['variant']}: max abs/rel err "
              f"{errs} (atol {BWD_ATOL} + rtol {BWD_RTOL}, rel {BWD_REL}); "
              f"against the plain version in f32 with P and dS rounded to "
              f"bf16: worst row rel_err/max_abs_err/atol needed {rows} (row "
              f"rel {BWD_ROW_REL}, floor {BWD_ROW_FLOOR} of the RMS row; atol "
              f"{BWD_F32_ATOL} + rtol {BWD_F32_RTOL}); dq ms={r['dq_ms']:.3f} "
              f"bound_ms={r['dq_bound'][0]:.4f} ({r['dq_bound'][1]}) "
              f"{r['dq_rate']}, {100 * r['dq_bound'][0] / r['dq_ms']:.1f}% of "
              f"bound; dkv ms={r['dkv_ms']:.3f} bound_ms="
              f"{r['dkv_bound'][0]:.4f} ({r['dkv_bound'][1]}) {r['dkv_rate']}, "
              f"{100 * r['dkv_bound'][0] / r['dkv_ms']:.1f}% of bound; plain "
              f"(dq+dk+dv) ms={r['plain_ms']:.3f}, library_ms(sdpa backward, "
              f"dq+dk+dv)={r['library_ms']:.4f} [{card}]")
    # phase 21's attention shapes (GPT-3-13B, BERT-base, the UNet's self-
    # and cross-attention at Sk=77), the same per-row gates
    for label, shape, causal in P21_ATTN:
        h, sh = shape["H"], " ".join(f"{k}={v}" for k, v in shape.items())
        r = flash_case(torch, dev, gen, causal, h, shape=shape)
        print(f"phase 2 flash_fwd {label} {sh} causal={causal} "
              f"variant={r['variant']}: max_abs_err={r['max_abs_err']:.3g} "
              f"rel_err={r['rel_err']:.3g} lse_err={r['lse_err']:.3g}; worst "
              f"row rel_err against f32={r['row_rel']:.4g} (row rel "
              f"{FLASH_ROW_REL}) max_abs_err={r['f32_max_abs_err']:.3g}; "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.3f} bound_ms="
              f"{r['bound_ms']:.4f} ({r['bound_by']}) {r['rate']}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound, "
              f"library_ms(sdpa)={r['library_ms']:.4f} [{card}]")
        r = flash_bwd_case(torch, dev, gen, causal, h, shape=shape)
        g = r["gate"]
        rows = " ".join(f"{n}={g[n]['row_rel']:.4g}/{g[n]['f32_max_abs_err']:.3g}"
                        for n in ("dq", "dk", "dv"))
        print(f"phase 2 flash_bwd {label} {sh} causal={causal} "
              f"variant={r['variant']}: worst row rel_err/max_abs_err "
              f"against f32 {rows} (row rel {BWD_ROW_REL}); dq "
              f"ms={r['dq_ms']:.4f} bound_ms={r['dq_bound'][0]:.4f} "
              f"({r['dq_bound'][1]}); dkv ms={r['dkv_ms']:.4f} bound_ms="
              f"{r['dkv_bound'][0]:.4f} ({r['dkv_bound'][1]}); plain "
              f"(dq+dk+dv) ms={r['plain_ms']:.3f}, library_ms(sdpa backward, "
              f"dq+dk+dv)={r['library_ms']:.4f} [{card}]")
    adamw_rows = []
    for sr in (False, True):
        r = adamw_case(torch, dev, gen, sr)
        adamw_rows.append(r)
        device_rows.append((f"fused_adamw 32000x2048 sr={sr}", r))
        print(f"phase 2 fused_adamw 32000x2048 bf16 p/g/m/v sr={sr}: bitwise "
              f"equal to plain (max abs err {r['max_abs_err']}); a wrapper "
              f"call with its prologue {r['call_ms']:.4f} ms, "
              f"plain_ms={r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}); torch._fused_adamw_ on the same tensors "
              f"(another function, for scale) "
              f"{r['torch_fused_adamw_ms']:.4f} ms [{card}]")
    n_loose = adamw_shard_case(
        torch, dev, torch.Generator(device=dev).manual_seed(args.seed + 2))
    print(f"phase 2 fused_adamw 32000x2048 bf16 SR, two dimension-0 shards "
          f"with their SR index bases: bitwise the whole tensor's update; "
          f"without the base the second shard rounds {n_loose} elements "
          f"otherwise [{card}]")
    r = adamw_multi_case(torch, dev, gen)
    adamw_multi_row = r
    device_rows.append((f"fused_adamw multi-tensor, {r['tensors']} tensors",
                        r))
    print(f"phase 2 fused_adamw multi-tensor, the flagship's {r['tensors']} "
          f"bf16 tensors ({r['numel']} elements) with bf16 moments and SR in "
          f"one launch: bitwise equal to {r['tensors']} per-tensor plain "
          f"updates with the same salts, batched scalar rows bitwise the "
          f"per-tensor prologue; a wrapper call {r['call_ms']:.4f} ms, "
          f"plain_ms={r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} "
          f"({r['bound_by']}); torch._fused_adamw_ over the same tensors "
          f"(another function, for scale) {r['torch_fused_adamw_ms']:.4f} ms "
          f"[{card}]")
    torch.cuda.empty_cache()
    eng = ENGINE_DECODE
    r, r8 = paged_case(torch, dev, gen, gen_cpu, eng["B"], int8=True,
                       pages=eng["pages"], lo=eng["lo"], hi=eng["hi"])
    label = (f"engine-like B={eng['B']}, lengths {eng['lo']}..{eng['hi']}, "
             f"{eng['pages']}-page tables")
    device_rows += [(f"paged_decode {label}", r),
                    (f"paged_decode_int8 {label}", r8)]
    show_paged(label, r, r8)
    torch.cuda.empty_cache()
    # phase 13's disaggregated decode: 8-token blocks, 544-page tables,
    # rows of a 4096-token prompt and its growth
    eng = DISAGG_DECODE
    r, r8 = paged_case(torch, dev, gen, gen_cpu, eng["B"], int8=True,
                       pages=eng["pages"], lo=eng["lo"], hi=eng["hi"],
                       bs=eng["bs"])
    label = (f"disaggregated B={eng['B']}, lengths {eng['lo']}..{eng['hi']}, "
             f"{eng['pages']}-page tables")
    device_rows += [(f"paged_decode {label}", r),
                    (f"paged_decode_int8 {label}", r8)]
    show_paged(label, r, r8)
    torch.cuda.empty_cache()
    # phase 21(a)'s decode: GPT-3-13B's 40 heads over its prompts' pages
    eng = P21_DECODE
    r, r8 = paged_case(torch, dev, gen, gen_cpu, eng["B"], int8=True,
                       pages=eng["pages"], lo=eng["lo"], hi=eng["hi"],
                       heads=eng["heads"])
    label = (f"GPT-3-13B B={eng['B']}, lengths {eng['lo']}..{eng['hi']}, "
             f"{eng['pages']}-page tables")
    device_rows += [(f"paged_decode {label}", r),
                    (f"paged_decode_int8 {label}", r8)]
    show_paged(label, r, r8, eng["heads"])
    torch.cuda.empty_cache()

    starts.append(("3", time.perf_counter() - t_start))
    # -- phase 3: scoring forward (main path of the flash kernel) ----------
    pt_seed(args.seed)
    cfg = LlamaConfig(**LLAMA_542M)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    model.eval()
    ids = torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen_cpu).to(dev)
    with torch.no_grad():
        model(ids[:, :128])  # warm-up outside the counted run
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits = model(ids)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        score_counts = kernels.launch_counts()
        with plain_paths():
            logits_plain = model(ids)
    want3 = flash_fwd_counts(cfg.num_hidden_layers)
    if any(score_counts[k] != n for k, n in want3.items()):
        fail(f"scoring forward's flash launches "
             f"{ {k: score_counts[k] for k in want3} }, expected {want3}")
    if tuple(logits.shape) != (4, 2048, cfg.vocab_size) or not torch.isfinite(logits).all():
        fail(f"scoring logits: shape {tuple(logits.shape)} or non-finite")
    e3 = rel_err(logits, logits_plain)
    agree3 = float((logits.argmax(-1) == logits_plain.argmax(-1)).float().mean())
    print(f"phase 3 scoring forward [4, 2048] Llama-542M bf16 "
          f"({model.num_params()} params): counts {json.dumps(score_counts)}, "
          f"logits rel err vs plain {e3:.3g} (tol {LOGITS_REL_TOL}), argmax "
          f"agreement {agree3:.4f} (min {ARGMAX_MIN}), {fwd_s * 1e3:.1f} ms "
          f"[{card}]")
    if not (e3 <= LOGITS_REL_TOL and agree3 >= ARGMAX_MIN):
        fail("scoring forward disagrees with the plain attention path")
    del logits, logits_plain

    starts.append(("4", time.perf_counter() - t_start))
    # -- phase 4: serving (main path of the paged-decode kernel) -----------
    def serve(n_req, new_tokens):
        eng = ContinuousBatchingEngine(model, **SERVE)
        for i, p in enumerate(serving_prompts(torch, args.seed, n_req,
                                              cfg.vocab_size)):
            eng.add_request(i, p, max_new_tokens=new_tokens)
        return eng

    serve(2, 20).run()  # warm-up: first prefill and decode launches
    torch.cuda.synchronize()
    eng = serve(N_REQUESTS, NEW_TOKENS)
    # host time of the two phases of a step; each ends in a device->host
    # read of its tokens, so it covers the device work it launched
    phase_s = {"admit+prefill": 0.0, "decode": 0.0}

    def timed(fn, key):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                phase_s[key] += time.perf_counter() - t
        return run

    eng._admit = timed(eng._admit, "admit+prefill")
    eng._decode_step = timed(eng._decode_step, "decode")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_counts = kernels.launch_counts()
    if len(done) != N_REQUESTS or any(
            len(r.out) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in r.out)
            for r in done.values()):
        fail("serving: a request did not complete with in-range tokens")
    if eng.decode_steps == 0 or serve_counts["paged_decode_attention"] != \
            cfg.num_hidden_layers * eng.decode_steps:
        fail(f"serving: paged kernel launched "
             f"{serve_counts['paged_decode_attention']} times for "
             f"{eng.decode_steps} decode steps x {cfg.num_hidden_layers} layers")
    ttft_p50 = statistics.median(r.ttft() for r in done.values())
    print(f"phase 4 serving: {N_REQUESTS} requests (prompts {PROMPT_LENS}, "
          f"{NEW_TOKENS} new tokens each) B={SERVE['max_batch']} "
          f"decode_chunk={SERVE['decode_chunk']}: wall {wall:.3f} s, "
          f"decode tokens {eng.decode_tokens} over {eng.decode_steps} decode "
          f"steps in {eng.n_dispatches} dispatches, "
          f"{eng.decode_tokens / wall:.1f} decode tokens/s of wall time "
          f"(prefill included), TTFT p50 {ttft_p50 * 1e3:.1f} ms (all "
          f"requests submitted at t=0), admit+prefill "
          f"{phase_s['admit+prefill']:.3f} s for {eng.prefill_tokens} prompt "
          f"tokens, decode {phase_s['decode']:.3f} s = "
          f"{phase_s['decode'] / eng.decode_steps * 1e3:.3f} ms per decode "
          f"step, counts {json.dumps(serve_counts)} [{card}]")

    starts.append(("5", time.perf_counter() - t_start))
    # -- phase 5: one full-width decode step, kernel vs plain ----------------
    B5, L5 = 16, 512
    per = SERVE["max_len"] // SERVE["block_size"]
    perm = torch.randperm(B5 * per + 1, generator=gen_cpu)[: B5 * per]
    caches = model.init_cache(B5, SERVE["max_len"], block_size=SERVE["block_size"],
                              num_blocks=B5 * per + 1,
                              tables=perm.reshape(B5, per).to(torch.int32).numpy())
    with torch.no_grad():
        model.forward_with_cache(
            torch.randint(0, cfg.vocab_size, (B5, L5), generator=gen_cpu).to(dev),
            caches, torch.zeros(B5, dtype=torch.int32, device=dev))
        saved = [(c.k_pool.clone(), c.v_pool.clone()) for c in caches]
        tok = torch.randint(0, cfg.vocab_size, (B5, 1), generator=gen_cpu).to(dev)
        cl = torch.randint(1, L5, (B5,), generator=gen_cpu).to(torch.int32).to(dev)
        before = paged_decode.launches
        lk, _ = model.forward_with_cache(tok, caches, cl)
        if paged_decode.launches - before != cfg.num_hidden_layers:
            fail("decode step did not launch the paged kernel once per layer")
        for c, (k, v) in zip(caches, saved):
            c.k_pool.copy_(k)
            c.v_pool.copy_(v)
        with plain_paths():
            lp, _ = model.forward_with_cache(tok, caches, cl)
    e5 = rel_err(lk, lp)
    agree5 = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    print(f"phase 5 decode step in the model (B=16, ragged lengths 1..511): "
          f"logits rel err kernel vs plain {e5:.3g} (tol {LOGITS_REL_TOL}), "
          f"argmax agreement {agree5:.4f}")
    if not (torch.isfinite(lk).all() and e5 <= LOGITS_REL_TOL and agree5 >= ARGMAX_MIN):
        fail("decode step disagrees with the plain paged path")

    # where a decode step's time goes: host wall per step against the sum of
    # the kernels' device time in one profiled step (repeating the step
    # rewrites the same KV cells with the same values)
    def decode_step():
        model.forward_with_cache(tok, caches, cl)

    with torch.no_grad():
        decode_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            decode_step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 10 * 1e3
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            decode_step()
            torch.cuda.synchronize()
    by_kernel = sorted(
        ((e.self_device_time_total, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    dev_ms = sum(t for t, _, _ in by_kernel) / 1e3
    if dev_ms > 0:
        top = ", ".join(f"{k[:40]} x{n} {t / 1e3:.3f} ms"
                        for t, n, k in by_kernel[:5])
        print(f"phase 5 decode step B=16: {step_ms:.3f} ms wall per step, "
              f"{dev_ms:.3f} ms of kernel time in a profiled step "
              f"({100 * dev_ms / step_ms:.1f}% device busy); top: {top} [{card}]")
    else:
        print(f"phase 5 decode step B=16: {step_ms:.3f} ms wall per step; "
              f"device time not measured (the profiler saw no device time)")
    del caches, saved
    torch.cuda.empty_cache()

    starts.append(("5b", time.perf_counter() - t_start))
    # -- phase 5b: shared-prefix serving, int8 against bf16 KV pools --------
    prefix_int8_counts = prefix_serving_phase(torch, np, model, cfg, card)
    del model
    torch.cuda.empty_cache()

    starts.append(("6", time.perf_counter() - t_start))
    # -- phase 6: small f32 reference, card against CPU ----------------------
    small = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                             num_attention_heads=4, num_key_value_heads=2,
                             vocab_size=512, max_position_embeddings=512)
    cpu_model = LlamaForCausalLM(small, device="cpu",
                                 generator=torch.Generator().manual_seed(args.seed))
    gpu_model = LlamaForCausalLM(small, device=dev)
    load_jax_params(gpu_model, {n: p.detach().numpy()
                                for n, p in cpu_model.named_parameters()})
    ids6 = torch.randint(0, small.vocab_size, (2, 128), generator=gen_cpu)
    kernels.reset_launch_counts()
    with torch.no_grad():
        lg_gpu = gpu_model(ids6.to(dev)).cpu()
        lg_cpu = cpu_model(ids6)
    e6 = float((lg_gpu - lg_cpu).abs().max())
    toks = {}
    for name, m in (("cuda", gpu_model), ("cpu", cpu_model)):
        e = ContinuousBatchingEngine(m, max_batch=3, max_len=256, block_size=16,
                                     num_blocks=48, prompt_pad=64, decode_chunk=4)
        rng = torch.Generator().manual_seed(args.seed + 6)
        for i, n in enumerate((9, 33, 64, 17)):
            e.add_request(i, torch.randint(0, small.vocab_size, (n,),
                                           generator=rng).numpy(),
                          max_new_tokens=12)
        toks[name] = {r: q.out for r, q in e.run().items()}
    # the int8 engine with the prefix cache: shared prefixes and a fully
    # cached repeat, so that adopt, fork and the block copy run too
    toks8, forks8 = {}, {}
    for name, m in (("cuda", gpu_model), ("cpu", cpu_model)):
        e = ContinuousBatchingEngine(m, max_batch=2, max_len=256, block_size=16,
                                     num_blocks=48, prompt_pad=96,
                                     kv_dtype="int8", prefix_cache=True)
        rng = torch.Generator().manual_seed(args.seed + 7)
        pre = torch.randint(0, small.vocab_size, (48,), generator=rng)
        prompts = [torch.cat([pre, torch.randint(0, small.vocab_size, (n,),
                                                 generator=rng)]).numpy()
                   for n in (16, 5, 0, 9)]
        for i, p in enumerate(prompts + prompts[:1]):  # 0 again: fully cached
            e.add_request(i, p, max_new_tokens=12)
        toks8[name] = {r: q.out for r, q in e.run().items()}
        forks8[name] = e.prefix_stats()["forks"]
    c6 = kernels.launch_counts()
    # generate over contiguous int8 tables: on the card every decode step
    # of every layer launches the int8 kernel
    gen_ids = torch.randint(0, small.vocab_size, (2, 9), generator=gen_cpu)
    gen_new = 7
    kernels.reset_launch_counts()
    with torch.no_grad():
        gen_gpu = generate(gpu_model, gen_ids.to(dev), max_new_tokens=gen_new,
                           block_size=16, kv_dtype="int8").cpu()
    c6g = kernels.launch_counts()["paged_decode_attention_int8"]
    with torch.no_grad():
        gen_cpu_out = generate(cpu_model, gen_ids, max_new_tokens=gen_new,
                               block_size=16, kv_dtype="int8")
    want_g = small.num_hidden_layers * (gen_new - 1)
    print(f"phase 6 small f32 reference (hidden 256, head_dim 64): logits max "
          f"abs err card vs CPU {e6:.3g} (tol 1e-3), engine tokens equal: "
          f"{toks['cuda'] == toks['cpu']}, int8 KV + prefix cache engine "
          f"tokens equal: {toks8['cuda'] == toks8['cpu']} (forks card "
          f"{forks8['cuda']}, CPU {forks8['cpu']}), counts {json.dumps(c6)}; "
          f"generate(block_size=16, kv_dtype='int8') tokens equal: "
          f"{torch.equal(gen_gpu, gen_cpu_out)}, int8 kernel launches {c6g} "
          f"(want {want_g})")
    if not (e6 <= 1e-3 and toks["cuda"] == toks["cpu"]
            and toks8["cuda"] == toks8["cpu"] and forks8["cuda"] >= 1
            and forks8["cuda"] == forks8["cpu"]
            and c6["flash_attention_fwd"] >= 1 and c6["paged_decode_attention"] >= 1
            and c6["paged_decode_attention_int8"] >= 1
            and torch.equal(gen_gpu, gen_cpu_out) and c6g == want_g):
        fail("the card disagrees with the CPU at the small f32 size")

    del cpu_model, gpu_model
    torch.cuda.empty_cache()

    starts.append(("7", time.perf_counter() - t_start))
    # -- phase 7: the flagship train step at full width ----------------------
    # phases 7 and 8 run the step eagerly, as before the capture existed;
    # phase 10 runs it captured
    from paddle_tpu_torch import jit as pt_jit

    pt_jit.enable_to_static(False)
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    def flagship(depth, fused=True):
        pt_seed(args.seed)
        cfg7 = LlamaConfig(**dict(LLAMA_542M, max_position_embeddings=2048,
                                  num_hidden_layers=depth))
        m = LlamaForCausalLM(cfg7, device=dev, dtype=torch.bfloat16)
        o = AdamW(learning_rate=TRAIN_LR, parameters=m.parameters(),
                  moment_dtype="bfloat16", use_stochastic_rounding=True,
                  fused=fused)
        return cfg7, m, o

    cfg7, model, opt = flagship(LLAMA_542M["num_hidden_layers"])
    n_tensors = len(list(model.parameters()))
    shapes7 = [tuple(p.shape) for p in model.parameters()]
    if shapes7 != flagship_shapes():
        fail(f"phase 2's AdamW shapes {flagship_shapes()} are not the "
             f"flagship's {shapes7}")
    compiled = bench_step(model, opt)
    ids_np = np.random.RandomState(args.seed).randint(
        0, cfg7.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
    labels = ids.clone()  # bench.py trains on labels = ids
    torch.cuda.reset_peak_memory_stats()
    warm = compiled(ids, labels)  # first step: lazy optimizer state
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = compiled.multi_step(ids, labels, steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L7 = cfg7.num_hidden_layers
    want_counts = {**flash_fwd_counts(L7 * TRAIN_STEPS),
                   **flash_bwd_counts(L7 * TRAIN_STEPS),
                   "fused_adamw": ADAMW_GROUPS * TRAIN_STEPS,
                   "paged_decode_attention": 0,
                   "paged_decode_attention_int8": 0}
    loss_list = [float(warm.detach())] + [float(x) for x in losses.cpu()]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = train_s / TRAIN_STEPS * 1e3
    tok_s = tokens * TRAIN_STEPS / train_s
    mfu = tok_s * model.flops_per_token(TRAIN_SEQ) / BF16_FLOPS_PER_S
    print(f"phase 7 train Llama-542M bf16 ({model.num_params()} params in "
          f"{n_tensors} tensors) B={TRAIN_BATCH} S={TRAIN_SEQ} "
          f"multi_step(steps={TRAIN_STEPS}): {step_ms:.2f} ms/step, "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} (flops_per_token "
          f"{model.flops_per_token(TRAIN_SEQ):.0f} over 989 TFLOP/s), peak "
          f"memory {peak_gb:.2f} GB, losses {[round(x, 4) for x in loss_list]} "
          f"(first: the warm-up step), counts {json.dumps(train_counts)} "
          f"[{card}]")
    if tuple(losses.shape) != (TRAIN_STEPS,) or not all(
            np.isfinite(x) for x in loss_list):
        fail(f"training losses: shape {tuple(losses.shape)} or non-finite")
    if not loss_list[-1] < loss_list[0]:
        fail(f"training loss did not fall: {loss_list}")
    if train_counts != want_counts:
        fail(f"training launch counts {train_counts} != {want_counts} "
             f"(per step: {L7} flash forward, {L7} dq, {L7} dk/dv, "
             f"{ADAMW_GROUPS} fused AdamW over {n_tensors} tensors; every "
             f"flash forward on "
             f"{FLASH_MAIN_VARIANT}, every dq and dk/dv on "
             f"{BWD_MAIN_VARIANT})")

    # where a train step's time goes: kernel classes in one profiled step,
    # against the host wall of that step; the loss alone by CUDA events
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        compiled(ids, labels)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    split, top = {}, []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            c = kernel_class(e.key)
            split[c] = split.get(c, 0.0) + e.self_device_time_total / 1e3
            top.append((e.self_device_time_total / 1e3, e.count, e.key, c))
    busy = sum(split.values())
    top.sort(reverse=True)
    with torch.no_grad():
        logits7 = model(ids)
    lg = logits7.detach().requires_grad_()
    flat_labels = labels.reshape(-1)
    loss_ms = time_ms(lambda: F.cross_entropy(
        lg.reshape(-1, cfg7.vocab_size), flat_labels).backward(), 5)
    del logits7, lg
    if busy > 0:
        parts = ", ".join(f"{k} {v:.2f} ms" for k, v in
                          sorted(split.items(), key=lambda kv: -kv[1]))
        print(f"phase 7 one profiled train step: {prof_wall_ms:.2f} ms wall, "
              f"{busy:.2f} ms of kernel time ({100 * busy / prof_wall_ms:.1f}% "
              f"device busy; host gaps {prof_wall_ms - busy:.2f} ms): {parts}; "
              f"cross_entropy forward+backward alone {loss_ms:.3f} ms [{card}]")
        print("phase 7 top kernels of that step: " + "; ".join(
            f"{k[:60]} x{n} {t:.2f} ms ({c})" for t, n, k, c in top[:12]))
    else:
        print(f"phase 7 one profiled train step: {prof_wall_ms:.2f} ms wall; "
              f"device time not measured (the profiler saw no device time); "
              f"cross_entropy forward+backward alone {loss_ms:.3f} ms")
    del model, opt, compiled, prof
    torch.cuda.empty_cache()

    starts.append(("8", time.perf_counter() - t_start))
    # -- phase 8: kernels against plain paths inside the model --------------
    _, mk, ok = flagship(GRAD_DEPTH)
    _, mp, op = flagship(GRAD_DEPTH)
    step_k, step_p = bench_step(mk, ok), bench_step(mp, op)

    def grads_of(m):
        m.loss(ids, labels).backward()
        return {n: p.grad.detach().clone() for n, p in m.named_parameters()}

    kernels.reset_launch_counts()
    gk = grads_of(mk)
    with plain_paths([op]):
        gp = grads_of(mp)
    c8 = kernels.launch_counts()
    worst = max(((rel_err(gk[n], gp[n]), n) for n in gk), key=lambda x: x[0])
    finite = all(torch.isfinite(g).all() for g in gk.values())
    for m in (mk, mp):
        m.zero_grad(set_to_none=True)
    del gk, gp
    # one bench step each (same salts: the seed restarts the salt stream),
    # then the next step's losses
    pt_seed(args.seed)
    step_k(ids, labels)
    pt_seed(args.seed)
    with plain_paths([op]):
        step_p(ids, labels)
    with torch.no_grad():
        next_k = float(mk.loss(ids, labels))
        with plain_paths([op]):
            next_p = float(mp.loss(ids, labels))
    print(f"phase 8 gradients at full width, {GRAD_DEPTH} layers, kernels vs "
          f"plain paths: worst rel err {worst[0]:.3g} ({worst[1]}; tol "
          f"{GRAD_REL_TOL}); after one bench step (fused AdamW vs unfused) the "
          f"next loss {next_k:.5f} vs {next_p:.5f}; counts {json.dumps(c8)}")
    if not (finite and worst[0] <= GRAD_REL_TOL
            and abs(next_k - next_p) <= LOGITS_REL_TOL * abs(next_p)
            and c8["flash_attention_bwd_dq"] == GRAD_DEPTH):
        fail("gradients or the stepped model disagree with the plain paths")
    del mk, mp, ok, op, step_k, step_p
    torch.cuda.empty_cache()

    small8 = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                              num_attention_heads=4, num_key_value_heads=2,
                              vocab_size=512, max_position_embeddings=512)
    ids8 = torch.randint(0, small8.vocab_size, (2, 128), generator=gen_cpu)
    m8_cpu = LlamaForCausalLM(small8, device="cpu",
                              generator=torch.Generator().manual_seed(args.seed))
    m8_gpu = LlamaForCausalLM(small8, device=dev)
    load_jax_params(m8_gpu, {n: p.detach().numpy()
                             for n, p in m8_cpu.named_parameters()})
    losses8 = {}
    kernels.reset_launch_counts()
    for name, m in (("cuda", m8_gpu), ("cpu", m8_cpu)):
        st = bench_step(m, AdamW(learning_rate=1e-3, parameters=m.parameters(),
                                 fused=True))
        x = ids8.to(m.device)
        losses8[name] = [float(st(x, x)) for _ in range(3)]
    c8b = kernels.launch_counts()
    e8 = max(abs(a - b) for a, b in zip(losses8["cuda"], losses8["cpu"]))
    print(f"phase 8 small f32 model trained 3 steps (fused AdamW lr 1e-3), card "
          f"vs CPU: losses {losses8['cuda']} vs {losses8['cpu']}, max diff "
          f"{e8:.3g} (tol 1e-4), counts {json.dumps(c8b)}")
    if not (e8 <= 1e-4 and c8b["flash_attention_bwd_dkv"] >= 1
            and c8b["fused_adamw"] >= 1):
        fail("the small f32 training run on the card disagrees with the CPU")

    pt_jit.enable_to_static(True)

    starts.append(("10", time.perf_counter() - t_start))
    # -- phase 10: the training recipe, captured -------------------------------
    phase7_profile = (prof_wall_ms, busy if busy > 0 else float("nan"))
    recipe_counts, f16_fwd, f16_bwd, f32_adamw = recipe_phase(
        torch, np, dev, args, card, ids, labels, phase7_profile, device_rows,
        gen)

    starts.append(("11", time.perf_counter() - t_start))
    # -- phase 11: the decode loop ---------------------------------------------
    loop_runs, serve_model = decode_loop_phase(torch, np, dev, args, card)

    starts.append(("12", time.perf_counter() - t_start))
    # -- phase 12: the serving engine's front door --------------------------
    front_door_phase(torch, np, serve_model, loop_runs, card)
    del serve_model, loop_runs
    import gc
    gc.collect()
    torch.cuda.empty_cache()

    starts.append(("13", time.perf_counter() - t_start))
    # -- phase 13: disaggregated serving -----------------------------------------
    disagg_phase(torch, np, dev, args, card)
    gc.collect()
    torch.cuda.empty_cache()

    starts.append(("14", time.perf_counter() - t_start))
    # -- phase 14: low-precision GEMMs ------------------------------------------
    lowp_phase(torch, np, dev, args, card, ids, labels)
    gc.collect()
    torch.cuda.empty_cache()

    starts.append(("15", time.perf_counter() - t_start))
    # -- phase 15: an autoscaled fleet ------------------------------------------
    autoscale_phase(torch, np, dev, args, card)
    gc.collect()
    torch.cuda.empty_cache()

    starts.append(("16", time.perf_counter() - t_start))
    # -- phase 16: deployment, control flow and piecewise capture, debugging --
    deploy_phase(torch, np, dev, args, card, ids, labels)
    gc.collect()
    torch.cuda.empty_cache()

    starts.append(("17", time.perf_counter() - t_start))
    # -- phase 17: collectives and data-parallel training ----------------------
    collectives_phase(torch, np, dev, args, card)
    gc.collect()
    torch.cuda.empty_cache()

    starts.append(("18", time.perf_counter() - t_start))
    # -- phase 18: tensor parallelism, recompute, sequence parallel ------------
    import shutil
    import tempfile
    from pathlib import Path

    p18_tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_p18_"))
    try:
        serial_a = tp_phase(torch, np, dev, args, card, p18_tmp)
        gc.collect()
        torch.cuda.empty_cache()

        starts.append(("19", time.perf_counter() - t_start))
        # -- phase 19: the pipeline, ring attention and sep, MoE and ep --------
        pp_phase(torch, np, dev, args, card, p18_tmp, serial_a)
    finally:
        shutil.rmtree(p18_tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    starts.append(("20", time.perf_counter() - t_start))
    # -- phase 20: fault-tolerant training -----------------------------------
    p20_tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_p20_"))
    try:
        trainfault_phase(torch, np, dev, args, card, p20_tmp)
    finally:
        shutil.rmtree(p20_tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    starts.append(("21", time.perf_counter() - t_start))
    # -- phase 21: GPT, BERT and the SD UNet ---------------------------------
    models_phase(torch, np, dev, args, card)
    gc.collect()
    torch.cuda.empty_cache()

    starts.append(("22", time.perf_counter() - t_start))
    # -- phase 22: ResNet-50, the pools and the detection ops -----------------
    vision_phase(torch, np, dev, args, card)
    gc.collect()
    torch.cuda.empty_cache()

    starts.append(("9", time.perf_counter() - t_start))
    # -- phase 9: the decode and AdamW kernels' device times ----------------
    # taken last: a profiler session slows the host work of the phases
    # after it (phases 4, 5 and 5b are host-bound)
    for label, r in device_rows:
        r["ms"], how = r.pop("device")()
        print(f"phase 9 {label}: kernel ms={r['ms']:.4f} ({how}; a wrapper "
              f"call {r['call_ms']:.4f} ms) bound_ms="
              f"{r['bound_ms']:.4f} ({r['bound_by']}), "
              f"{r['nbytes'] / r['ms'] / 1e6:.1f} GB/s, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound [{card}]")
    if int8_row["ms"] > paged_rows[0]["ms"]:
        print(f"phase 9 note: the int8 decode ({int8_row['ms']:.4f} ms) is "
              f"slower than the float decode on the same tokens "
              f"({paged_rows[0]['ms']:.4f} ms)")

    # -- result ---------------------------------------------------------------
    paged16, flash_main = paged_rows[0], flash_rows[0]
    entries = [
        dict(name="paged_decode_attention", route="cuda",
             source="paddle_tpu_torch/ops/kernels/paged_decode_attention.cu",
             replaces="paddle_tpu/ops/paged_attention.py:984",
             launches=serve_counts["paged_decode_attention"],
             max_abs_err=paged16["max_abs_err"], ms=paged16["ms"],
             plain_ms=paged16["plain_ms"], bound_ms=paged16["bound_ms"],
             bound_by=paged16["bound_by"], library_ms=None),
        dict(name="paged_decode_attention_int8", route="cuda",
             source="paddle_tpu_torch/ops/kernels/paged_decode_attention.cu",
             replaces="paddle_tpu/ops/paged_attention.py:984",
             launches=prefix_int8_counts["paged_decode_attention_int8"],
             max_abs_err=int8_row["max_abs_err"], ms=int8_row["ms"],
             plain_ms=int8_row["plain_ms"], bound_ms=int8_row["bound_ms"],
             bound_by=int8_row["bound_by"], library_ms=None),
        dict(name="flash_attention_fwd", route="cuda",
             source="paddle_tpu_torch/ops/kernels/flash_attention_fwd.cu",
             replaces="paddle_tpu/ops/flash_attention.py:64",
             launches=score_counts["flash_attention_fwd"],
             max_abs_err=flash_main["max_abs_err"], ms=flash_main["ms"],
             plain_ms=flash_main["plain_ms"], bound_ms=flash_main["bound_ms"],
             bound_by=flash_main["bound_by"],
             library_ms=flash_main["library_ms"]),
    ]
    bwd_main = bwd_rows[0]
    for name, ms_key, b_key in (("flash_attention_bwd_dq", "dq_ms", "dq_bound"),
                                ("flash_attention_bwd_dkv", "dkv_ms",
                                 "dkv_bound")):
        outs = ("dq",) if name.endswith("dq") else ("dk", "dv")
        err = max(bwd_main["gate"][o]["max_abs_err"] for o in outs)
        entries.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/ops/kernels/flash_attention_bwd.cu",
            replaces=("paddle_tpu/ops/flash_attention.py:172"
                      if name.endswith("dq") else
                      "paddle_tpu/ops/flash_attention.py:215"),
            launches=train_counts[name], max_abs_err=err, ms=bwd_main[ms_key],
            plain_ms=bwd_main["plain_ms"], bound_ms=bwd_main[b_key][0],
            bound_by=bwd_main[b_key][1], library_ms=bwd_main["library_ms"]))
    # the train step's launch: all 75 tensors at once (adamw_multi_row)
    entries.append(dict(
        name="fused_adamw", route="cuda",
        source="paddle_tpu_torch/ops/kernels/fused_adamw.cu",
        replaces="paddle_tpu/ops/fused_adamw.py:111",
        launches=train_counts["fused_adamw"],
        max_abs_err=adamw_multi_row["max_abs_err"], ms=adamw_multi_row["ms"],
        plain_ms=adamw_multi_row["plain_ms"],
        bound_ms=adamw_multi_row["bound_ms"],
        bound_by=adamw_multi_row["bound_by"], library_ms=None))
    print("phase starts (s after the start): " + ", ".join(
        f"{name} {t:.1f}" for name, t in starts))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
