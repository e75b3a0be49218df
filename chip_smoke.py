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
``benchmarks/serving_throughput.py`` configures them; the engine with the
prefix cache on the shared-prefix workload of that script's router mode,
over int8 KV pools (int8 paged-decode kernel) and over bf16 pools; and the
training slice's flagship step of ``bench.py:main()`` (B=4, S=2048,
masterless bf16 ``AdamW(lr=1e-4, moment_dtype="bfloat16",
use_stochastic_rounding=True, fused=True)`` through
``jit.to_static(...).multi_step``: flash forward and backward kernels, the
fused-AdamW kernel once a step over all 75 tensors); and the engine's
decode loop (phase 11): its decode programs eager, captured as CUDA graphs
and pipelined with ``overlap=True``, speculative decoding on bf16 and int8
pools, and ``generate`` captured and sampling. Each main path runs
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
import json
import statistics
import subprocess
import sys
import time

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
# benchmarks/serving_throughput.py:346-370 (router mode, on-TPU numbers):
# one engine where the source runs two replicas behind a ClusterRouter (the
# router is a later slice), no priorities (admission control is a later
# slice); plus 4 exact repeats of earlier prompts, so that fully cached
# prompts fork their last block on the card
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
    least = max(floor * float(norms.pow(2).mean().sqrt()), 1e-30)
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
                 hi=2048):
    """Phase 2's paged-decode inputs: bf16 pools [16, B*pages + 1, 64, 128]
    behind shuffled tables (pages past the live ones hold the trash block),
    lengths drawn from lo..hi with the spread's two ends, bf16 q. Returns
    ``(q, k_pool, v_pool, tables, cache_len, lengths)``."""
    H = KVH = 16
    D, BS, P = 128, 64, pages
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
               live_tokens=live, nbytes=nbytes, splits=splits,
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
                     splits=splits, device=lambda: device(True))


def flash_inputs(torch, dev, gen, hkv, dtype=None):
    """Phase 2's flash inputs: bf16 (or ``dtype``) randn q ``[4, 2048, 16,
    128]`` and k/v ``[4, 2048, hkv, 128]``."""
    B, S, H, D = 4, 2048, 16, 128
    dt = dtype or torch.bfloat16
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(B, S, hkv, D, generator=gen, device=dev).to(dt)
    v = torch.randn(B, S, hkv, D, generator=gen, device=dev).to(dt)
    return q, k, v


def flash_case(torch, dev, gen, causal, hkv, dtype=None):
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.flash_attention import (
        _fwd_variant, flash_attention_fwd, flash_attention_fwd_plain)

    q, k, v = flash_inputs(torch, dev, gen, hkv, dtype)
    B, S, H, D = q.shape
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
    pairs = S * (S + 1) / 2 if causal else S * S
    nbytes = (2 * B * S * H * D + 2 * B * S * hkv * D) * 2 + B * H * S * 4
    flops = 4.0 * B * H * pairs * D
    b_ms, b_by = bound(nbytes, flops)
    return dict(gate, causal=causal, hkv=hkv,
                variant=_fwd_variant(q.dtype, D),
                rate=f"{flops / ms / 1e9:.1f} TFLOP/s",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def flash_bwd_inputs(torch, dev, gen, causal, hkv, dtype=None):
    """Phase 2's flash backward inputs: bf16 (or ``dtype``) randn q, dO
    ``[4, 2048, 16, 128]`` and k, v ``[4, 2048, hkv, 128]``, with the flash
    forward's out and lse. Returns ``(q, k, v, out, lse, do)``."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd

    B, S, H, D = 4, 2048, 16, 128
    dt = dtype or torch.bfloat16
    q, do = (torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, S, hkv, D, generator=gen, device=dev).to(dt)
            for _ in range(2))
    out, lse = flash_attention_fwd(q, k, v, causal)
    return q, k, v, out, lse, do


def flash_bwd_case(torch, dev, gen, causal, hkv, dtype=None):
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.flash_attention import (
        _bwd_variant, _delta, flash_attention_bwd, flash_attention_bwd_dkv,
        flash_attention_bwd_dq, flash_attention_bwd_plain)

    q, k, v, out, lse, do = flash_bwd_inputs(torch, dev, gen, causal, hkv,
                                             dtype)
    B, S, H, D = q.shape
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
    pairs = S * (S + 1) / 2 if causal else S * S
    reads = (2 * B * S * H * D + 2 * B * S * hkv * D) * 2 + 2 * B * H * S * 4
    mm = 2.0 * B * H * pairs * D  # one Sq x Sk x D product
    dq_bound = bound(reads + B * S * H * D * 2, 3 * mm)
    dkv_bound = bound(reads + 2 * B * S * hkv * D * 2, 4 * mm)
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


def bench_step(model, opt):
    """``bench.py:479-488``: model(ids) -> cross_entropy -> backward ->
    step -> clear_grad, under ``jit.to_static``."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.nn import functional as F

    def step(ids, labels):
        logits = model(ids)
        b, s, v = logits.shape
        loss = F.cross_entropy(logits.reshape(b * s, v), labels.reshape(b * s))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return jit.to_static(step, layers=[model], optimizers=[opt])


def prefix_serving_phase(torch, np, model, cfg, card):
    """Phase 5b: the engine with the prefix cache on the shared-prefix
    workload, over int8 and over bf16 pools, each run with the launch
    counts set to 0 just before it; then int8 against bf16 pools. Returns
    the int8 run's launch counts."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import kernels

    rng = np.random.RandomState(3)  # the source's seed and draw order
    families = [rng.randint(0, cfg.vocab_size, (PREFIX_LEN,))
                for _ in range(PREFIX_FAMILIES)]
    work = [(i, np.concatenate([
        families[i % PREFIX_FAMILIES],
        rng.randint(0, cfg.vocab_size, (PREFIX_TAILS[i % 2],))]))
        for i in range(PREFIX_REQUESTS)]
    # the repeats queue behind the first wave of max_batch requests, so
    # their originals' blocks are in the cache when they are admitted
    wave = PREFIX_SERVE["max_batch"]
    work = (work[:wave] + [(f"again{i}", work[i][1].copy())
                           for i in range(PREFIX_REPEATS)] + work[wave:])
    L = cfg.num_hidden_layers

    def serve_prefix(kv_dtype, requests):
        eng = ContinuousBatchingEngine(model, **PREFIX_SERVE, kv_dtype=kv_dtype)
        for rid, p in requests:
            eng.add_request(rid, p, max_new_tokens=PREFIX_NEW)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        return eng, done, time.perf_counter() - t0, kernels.launch_counts()

    runs = {}
    for kv in ("int8", None):
        serve_prefix(kv, work[:2])  # warm-up outside the counted run
        eng, done, wall, counts = serve_prefix(kv, work)
        name = kv or "bf16"
        runs[name] = (eng, done, counts)
        st = eng.prefix_stats()
        acc = eng.manager.accounting()
        ttft = statistics.median(r.ttft() for r in done.values())
        print(f"phase 5b shared-prefix serving, {name} KV pools: "
              f"{len(done)} requests ({PREFIX_FAMILIES} families of "
              f"{PREFIX_LEN}-token prefixes, tails {PREFIX_TAILS}, "
              f"{PREFIX_REPEATS} exact repeats, {PREFIX_NEW} new tokens each) "
              f"B={PREFIX_SERVE['max_batch']} chunk "
              f"{PREFIX_SERVE['prefill_chunk']}: wall {wall:.3f} s, "
              f"{eng.decode_tokens / wall:.1f} decode tokens/s of wall time, "
              f"TTFT p50 {ttft * 1e3:.1f} ms (all submitted at t=0), "
              f"{eng.decode_steps} decode steps, prefix hit tokens "
              f"{st['hit_tokens']}, hit rate {st['hit_rate']:.4f}, forks "
              f"{st['forks']}, evicted blocks {st['evicted_blocks']}, "
              f"counts {json.dumps(counts)} [{card}]")
        want_int8 = L * eng.decode_steps if kv else 0
        if (eng.decode_steps == 0
                or counts["paged_decode_attention_int8"] != want_int8
                or counts["paged_decode_attention"] != L * eng.decode_steps
                - want_int8):
            fail(f"{name} prefix serving: launch counts {counts} for "
                 f"{eng.decode_steps} decode steps x {L} layers")
        if not (st["forks"] >= PREFIX_REPEATS and st["hit_tokens"] > 0):
            fail(f"{name} prefix serving: forks {st['forks']}, hit tokens "
                 f"{st['hit_tokens']}")
        if not (acc["free"] + len(acc["refs"]) == acc["total"]
                and not acc["owned"] and set(acc["refs"].values()) <= {1}):
            fail(f"{name} prefix serving: blocks neither free nor pinned by "
                 f"the cache alone at the end: {acc}")
        if len(done) != len(work) or any(
                len(r.out) != PREFIX_NEW
                or not all(0 <= t < cfg.vocab_size for t in r.out)
                for r in done.values()):
            fail(f"{name} prefix serving: a request did not complete with "
                 f"in-range tokens")
    # one decode step of each engine, profiled: all 8 slots decoding (the
    # first wave, prefilled, with room for more tokens than the run gives)
    for kv in ("int8", None):
        eng = ContinuousBatchingEngine(model, **PREFIX_SERVE, kv_dtype=kv)
        for rid, p in work[:wave]:
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
    toks8, toks16 = ({rid: r.out for rid, r in runs[n][1].items()}
                     for n in ("int8", "bf16"))
    agree = float(np.mean([a == b for rid in toks16
                           for a, b in zip(toks8[rid], toks16[rid])]))
    # int8_decode_bench.py:179-202: last prefill logits, int8 against bf16
    # pools, on the 576-token prompts of the first wave
    ids5 = torch.from_numpy(np.stack([p for rid, p in work[:wave]
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
    return runs["int8"][2]


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
    wall, split, names = profile_step(torch, lambda: compiled(ids, labels))
    busy = sum(split.values())
    seen = {m: kernels_seen(names, m) for m in
            ("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma",
             "adamw_multi_kernel")}
    p7_wall, p7_busy = phase7_profile
    print(f"phase 10(a) one profiled replayed step: {wall:.2f} ms wall, "
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
    """Captured graphs of each of the engine's decode programs."""
    return {name: len(getattr(eng, f"_{name}_fn")._graphs)
            for name in ("decode", "chunk", "verify")}


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


def loop_run(torch, model, kind, prompts, L):
    """One engine of kind ``kind`` over phase 4's workload, after its own
    warm-up; returns what the phase prints and gates on."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import kernels

    eng = ContinuousBatchingEngine(model, **SERVE, overlap=kind == "overlap")
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
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    steps = eng.decode_steps - steps0
    r = dict(kind=kind, wall=wall, steps=steps,
             dispatches=eng.n_dispatches - disp0,
             decode_tokens=eng.decode_tokens - dtok0,
             ttft=statistics.median(q.ttft() for q in reqs),
             tokens={q.req_id: list(q.out) for q in reqs},
             graphs0=graphs0, graphs=graph_counts(eng), counts=counts,
             stats=eng.overlap_stats())
    if counts["paged_decode_attention"] != L * steps or steps == 0:
        fail(f"phase 11 {kind} serving: {counts['paged_decode_attention']} "
             f"paged-decode launches for {steps} decode steps x {L} layers")
    want = {"decode": 0, "chunk": 0, "verify": 0} if kind == "eager" else \
        {"decode": 1, "chunk": 1, "verify": 0}
    if graphs0 != want or r["graphs"] != want:
        fail(f"phase 11 {kind} serving: captured graphs {graphs0} after the "
             f"warm-up and {r['graphs']} at the end, expected {want}")
    del eng
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
        runs.append(loop_run(torch, model, kind, prompts, L))
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
    del steady, model, small_model
    gc.collect()
    torch.cuda.empty_cache()
    return runs


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
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
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

    # -- phase 2 ---------------------------------------------------------
    def show_paged(label, r, r8):
        print(f"phase 2 paged_decode {label} H=KVH=16 D=128 bs=64 "
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
            print(f"phase 2 paged_decode_int8 {label} H=KVH=16 D=128 bs=64 "
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

    # -- phase 5b: shared-prefix serving, int8 against bf16 KV pools --------
    prefix_int8_counts = prefix_serving_phase(torch, np, model, cfg, card)
    del model
    torch.cuda.empty_cache()

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

    # -- phase 10: the training recipe, captured -------------------------------
    phase7_profile = (prof_wall_ms, busy if busy > 0 else float("nan"))
    recipe_counts, f16_fwd, f16_bwd, f32_adamw = recipe_phase(
        torch, np, dev, args, card, ids, labels, phase7_profile, device_rows,
        gen)

    # -- phase 11: the decode loop ---------------------------------------------
    decode_loop_phase(torch, np, dev, args, card)

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
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
