#!/usr/bin/env python3
"""Times the flash kernels or the paged decode of the checkout it is run from.

    cd <checkout> && python3 <path>/flash_ab.py LABEL [fwd|bwd]
    cd <checkout> && python3 <path>/flash_ab.py LABEL decode [BLOCKS_PER_SM..]
    cd <checkout> && python3 <path>/flash_ab.py LABEL steady [TURN ..] [split]
    cd <checkout> && python3 <path>/flash_ab.py LABEL trace [N] [direct]

Builds that checkout's flash kernels, then times them at
``chip_smoke.py`` phase 2's three configurations (B=4, S=2048, H=16,
D=128, bf16: causal MHA, non-causal MHA, causal GQA with 4 kv heads):
three CUDA-event means of 20 launches each, after warm-up. ``fwd`` (the
default) times ``flash_attention_fwd``; ``bwd`` times the backward's two
wrappers, ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``, and
beside them the backward of ``F.scaled_dot_product_attention`` (dq, dk
and dv) on the same inputs. Prints one JSON line: the label, the mode, the
build's seconds, the times in ms, ptxas' non-zero spill reports and its
count of serialised-``wgmma`` warnings for the source timed. To compare two
versions of a kernel, unpack both into directories that ``.gitignore``
lists and run this in each in turns (A, B, B, A) within one call on the
card. ``decode`` times the float and int8 paged-decode kernels at
``chip_smoke.py`` phase 2's B=16 and B=64 cases and its engine-like B=8
case: the kernel's device time per launch from the profiler, three means of
20 launches; each BLOCKS_PER_SM given (default: the wrapper's own) sets the
wrapper's split target for one pass over the cases. ``steady`` times the
serving engine's steady decode of that checkout (the window of its
``chip_smoke.py`` phase 11(a) ``loop_steady``: Llama-542M, 16 slots,
16-step chunks, LOOP_STEADY_STEPS dispatches after 3 warm ones) in a
captured sync and an overlap engine per TURN, in the order given: per
decode step, the wall ms and the ms the replayed chunk program held the
device (CUDA events around each dispatch of it), whose difference is the
host's share. A TURN is ``default`` (the only one when none is given),
``on`` or ``off`` (tracing), ``lean`` (tracing off and the front door's
per-step host work taken out of the engine, ``strip``), ``eagerprefill``
(the prefill program left uncaptured), ``decodefirst`` (the chunk
program captured before any prefill) or ``ballast`` (``eagerprefill``
with 4 GiB held on the card). With ``split``,
each window is followed by two profiled dispatches whose device time is
split by kernel name (a window that follows a profiled one in the same
process may carry the profiler's cost). Needs an NVIDIA card and
``nvcc``.

``trace`` counts the kernels in the profiler's trace of one replay of
``chip_smoke.py`` phase 10(a)'s captured recipe step (Llama-542M at its
depth, bf16, fused AdamW; random ids from seed 0), N times (default 20)
for each of two ways: ``plain``, the profiled window holding the replay
alone as the gate's ``profile_step`` does, and ``lead``, a small kernel
and a sync first in the same window. Per replay it records the flash
forward, dQ, dK/dV and AdamW kernels the trace shows, the number of kernel
records and the first three kernels by start time. With ``direct`` (in a
checkout whose flash forward is a registered operator), the step is
captured with the forward's direct launch in place of the operator.
"""
import json
import os
import sys
import time


def mean_ms(torch, fn, iters=20, reps=3):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        ts.append(round(s.elapsed_time(e) / iters, 4))
    return ts


def decode(torch, targets):
    """``{target: {case: {"float": [ms...], "int8": [ms...], "splits": ...}}}``
    for each blocks-per-SM target of the decode wrappers' split."""
    import chip_smoke as cs
    from paddle_tpu_torch.ops import paged_attention as PA

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = {"B=16": dict(B=16), "B=64": dict(B=64),
             "engine B=8": dict(B=cs.ENGINE_DECODE["B"],
                                pages=cs.ENGINE_DECODE["pages"],
                                lo=cs.ENGINE_DECODE["lo"],
                                hi=cs.ENGINE_DECODE["hi"])}
    inputs = {}
    for name, kw in cases.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        gen_cpu = torch.Generator().manual_seed(0)
        q, kp, vp, tables, cl, _ = cs.paged_inputs(torch, dev, gen, gen_cpu,
                                                   **kw)
        (kq, ks), (vq, vs) = PA._kv_quantize(kp), PA._kv_quantize(vp)
        inputs[name] = ((q, kp, vp, tables, cl),
                        (q, kq, vq, ks, vs, tables, cl))
    res = {}
    default = PA._DECODE_BLOCKS_PER_SM
    try:
        for target in targets or [default]:
            PA._DECODE_BLOCKS_PER_SM = target
            row = res[str(target)] = {}
            for name, (f_args, i_args) in inputs.items():
                b, _, h, _ = f_args[0].shape
                row[name] = dict(splits=PA.decode_splits(
                    f_args[3].shape[1], b, h, sms))
                for kind, fn, args in (("float", PA.paged_decode, f_args),
                                       ("int8", PA.paged_decode_int8, i_args)):
                    row[name][kind] = [
                        round(cs.device_ms(lambda: fn(*args),
                                           "paged_decode_kernel"), 4)
                        for _ in range(3)]
    finally:
        PA._DECODE_BLOCKS_PER_SM = default
    return res


# steady turns: name -> (tracing on/off or the tree's default, strip the
# front door's per-step host work, run the prefill program eagerly,
# capture the chunk program before any prefill, hold 4 GiB of ballast)
TURNS = {"default": (None, False, False, False, False),
         "on": (True, False, False, False, False),
         "off": (False, False, False, False, False),
         "lean": (False, True, False, False, False),
         "eagerprefill": (None, False, True, False, False),
         "decodefirst": (None, False, False, True, False),
         "ballast": (None, False, True, False, True)}


def strip(eng):
    """Take the front door's per-step host work out of ``eng``, where its
    tree has it: the expiry scans, the execution lock and fence checks
    around a dispatch, and the SLO histograms fed at each token."""
    if not hasattr(eng, "_evict_expired"):
        return

    def append(req, tok):
        req.out.append(tok)
        req.times.append(time.perf_counter())

    eng._expire_queued = eng._evict_expired = lambda: None
    eng._run = lambda fn, phase: fn()
    eng._append_token = append


def kernel_split(torch, eng, dispatches=2):
    """Profile ``dispatches`` more engine steps: device ms per decode step
    by kernel name, {name: [ms, launches per step]}, largest first."""
    s0 = eng.decode_steps
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(dispatches):
            eng.step()
        torch.cuda.synchronize()
    steps = eng.decode_steps - s0
    split = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0):
            # names cut short may collide: sum them
            ms, n = split.get(e.key[:120], (0.0, 0.0))
            split[e.key[:120]] = (ms + e.self_device_time_total / 1e3 / steps,
                                  n + e.count / steps)
    return {k: [round(ms, 4), round(n, 2)]
            for k, (ms, n) in sorted(split.items(), key=lambda kv: -kv[1][0])}


def steady_window(torch, cs, model, kind, prompts, lean=False,
                  eager_prefill=False, decode_first=False, split=False):
    """One engine's steady window: (wall ms, chunk-program device ms) per
    decode step, and with ``split`` the ``kernel_split`` of two more
    dispatches (else None). ``lean`` strips the engine after its warm
    steps; ``eager_prefill`` runs its prefill program uncaptured (a tree
    whose prefill is eager already is left as it is); ``decode_first``
    runs the chunk program twice over the idle state (every row on the
    trash block) before any request, so that it is captured first."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(model, **cs.SERVE,
                                   overlap=kind == "overlap")
    if eager_prefill and hasattr(eng, "_prefill_program"):
        eng._prefill_fn = eng._prefill_program
    with cs.static_mode(True):
        if decode_first:
            eng._chunk_fn()
            eng._chunk_fn()
        for i in range(cs.SERVE["max_batch"]):
            eng.add_request(i, prompts[i][:cs.PROMPT_LENS[0]],
                            max_new_tokens=cs.LOOP_STEADY_NEW)
        while eng._queue or len(eng._decode_rows()) < cs.SERVE["max_batch"]:
            eng.step()
        for _ in range(3):
            eng.step()
        if lean:
            strip(eng)
        program, marks = eng._chunk_fn, []

        def timed():
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = program()
            e.record()
            marks.append((s, e))
            return out

        eng._chunk_fn = timed
        torch.cuda.synchronize()
        s0 = eng.decode_steps
        t0 = time.perf_counter()
        for _ in range(cs.LOOP_STEADY_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        steps = eng.decode_steps - s0
        dev = sum(s.elapsed_time(e) for s, e in marks)
        kernels = kernel_split(torch, eng) if split else None
    return wall / steps, dev / steps, kernels


def steady(torch, turns, split: bool):
    """The checkout's steady decode over ``turns`` (names of ``TURNS``), a
    captured sync and an overlap engine each: {"<turn> <kind>": [[wall
    ms, device ms] a decode step, ...]}; with ``split``, each entry also
    holds the window's ``kernel_split``."""
    import gc

    import chip_smoke as cs
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels

    kernels.build(["paged_decode_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
    pt_seed(0)
    cfg = LlamaConfig(**cs.LLAMA_542M)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16)
    model.eval()
    prompts = cs.serving_prompts(torch, 1, cs.SERVE["max_batch"],
                                 cfg.vocab_size)
    out = {}
    for name in turns:
        trace, lean, eager_prefill, decode_first, ballast = TURNS[name]
        if trace is not None:
            from paddle_tpu_torch import obs

            obs.set_enabled(trace)
        hold = (torch.empty(4 << 30, dtype=torch.uint8, device="cuda")
                if ballast else None)
        for kind in ("captured", "overlap"):
            wall, dev, kernels = steady_window(
                torch, cs, model, kind, prompts, lean, eager_prefill,
                decode_first, split)
            out.setdefault(f"{name} {kind}", []).append(
                [round(wall, 4), round(dev, 4)]
                + ([kernels] if split else []))
            gc.collect()
        del hold
    return out


TRACE_KERNELS = ("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma",
                 "adamw_multi_kernel")


def traced_kernels(torch, fn, lead: bool):
    """One call of ``fn`` under the profiler (after a small kernel and a
    sync when ``lead``): the TRACE_KERNELS' counts as the gate reads them
    (``key_averages``), the number of kernel records, the first three
    kernels by start time."""
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        if lead:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    names = [(e.key, e.count) for e in prof.key_averages()
             if e.device_type == cuda]
    counts = {m: sum(n for k, n in names if m in k) for m in TRACE_KERNELS}
    events = sorted((e for e in prof.events() if e.device_type == cuda),
                    key=lambda e: e.time_range.start)
    return counts, len(events), [e.name[:40] for e in events[:3]]


def trace(torch, n: int, direct: bool):
    """Phase 10(a)'s profiled replay, ``n`` times each way (see the
    module's docstring): {"plain": [...], "lead": [...]}, one entry a
    replay, and the launch counts one unprofiled replay added."""
    import chip_smoke as cs
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import kernels

    kernels.build(["flash_attention_fwd", "flash_attention_bwd",
                   "fused_adamw"])
    torch.backends.cuda.matmul.allow_tf32 = False
    if direct:
        fa.flash_fwd_op = fa.flash_attention_fwd
    dev = torch.device("cuda")
    depth = cs.LLAMA_542M["num_hidden_layers"]
    model, opt = cs.recipe_model(torch, dev, depth, torch.bfloat16, 0)
    step = cs.recipe_step(model, opt)
    g = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, cs.LLAMA_542M["vocab_size"],
                        (cs.TRAIN_BATCH, cs.TRAIN_SEQ), generator=g,
                        device=dev)
    step(ids, ids)  # warm-up, eager
    step(ids, ids)  # capture, then one replay
    kernels.reset_launch_counts()
    step(ids, ids)
    torch.cuda.synchronize()
    out = {"depth": depth, "graphs": len(step._graphs),
           "replay_counts": kernels.launch_counts()}
    for _ in range(n):
        for way in ("plain", "lead"):
            out.setdefault(way, []).append(traced_kernels(
                torch, lambda: step(ids, ids), way == "lead"))
    return out


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.flash_attention import (
        _delta, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_fwd)

    if not torch.cuda.is_available():
        print("flash_ab: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    mode = sys.argv[2] if len(sys.argv) > 2 else "fwd"
    if mode == "trace":
        n = int(sys.argv[3]) if len(sys.argv) > 3 and sys.argv[3].isdigit() \
            else 20
        print(json.dumps({"label": sys.argv[1], "mode": mode,
                          **trace(torch, n, "direct" in sys.argv[3:])}))
        return 0
    if mode == "steady":
        turns = [a for a in sys.argv[3:] if a in TURNS] or ["default"]
        print(json.dumps({"label": sys.argv[1], "mode": mode, "turns": turns,
                          "ms": steady(torch, turns,
                                       "split" in sys.argv[3:])}))
        return 0
    lib = {"fwd": "flash_attention_fwd", "bwd": "flash_attention_bwd",
           "decode": "paged_decode_attention"}[mode]
    t0 = time.time()
    kernels.build(["flash_attention_fwd", "flash_attention_bwd"]
                  if mode != "decode" else [lib])
    build_s = time.time() - t0
    log = (kernels.build_dir() / f"{lib}.log").read_text()
    if mode == "decode":
        res = decode(torch, [int(x) for x in sys.argv[3:]])
        lines = log.splitlines()
        regs = sorted({ln.split("Used ")[1].split(",")[0] for ln in lines
                       if "Used " in ln})
        print(json.dumps({"label": sys.argv[1], "mode": mode,
                          "build_s": round(build_s, 1), "ms": res,
                          "registers": regs}))
        return 0
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for causal, hkv in ((True, 16), (False, 16), (True, 4)):
        q = torch.randn(4, 2048, 16, 128, generator=g, device=dev).bfloat16()
        k = torch.randn(4, 2048, hkv, 128, generator=g, device=dev).bfloat16()
        v = torch.randn(4, 2048, hkv, 128, generator=g, device=dev).bfloat16()
        key = f"causal={causal},hkv={hkv}"
        if mode == "fwd":
            res[key] = mean_ms(torch, lambda: flash_attention_fwd(q, k, v,
                                                                  causal))
            continue
        do = torch.randn(4, 2048, 16, 128, generator=g, device=dev).bfloat16()
        out, lse = flash_attention_fwd(q, k, v, causal)
        delta, scale = _delta(out, do), 128 ** -0.5
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        lib_out = TF.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=hkv != 16)
        res[key] = dict(
            dq=mean_ms(torch, lambda: flash_attention_bwd_dq(
                q, k, v, do, lse, delta, causal, scale)),
            dkv=mean_ms(torch, lambda: flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, causal, scale)),
            sdpa_backward=mean_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), do.transpose(1, 2),
                retain_graph=True)))
    lines = log.splitlines()
    spill = [ln.strip() for ln in lines
             if "spill" in ln and "0 bytes spill" not in ln]
    regs = sorted({ln.split("Used ")[1].split(",")[0] for ln in lines
                   if "Used " in ln})
    print(json.dumps({"label": sys.argv[1] if len(sys.argv) > 1 else "",
                      "mode": mode, "build_s": round(build_s, 1), "ms": res,
                      "registers": regs, "nonzero_spills": spill[:4],
                      "serialized": sum("serialized" in ln for ln in lines)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
