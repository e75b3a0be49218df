#!/usr/bin/env python3
"""Times the flash kernels or the paged decode of the checkout it is run from.

    cd <checkout> && python3 <path>/flash_ab.py LABEL [fwd|bwd]
    cd <checkout> && python3 <path>/flash_ab.py LABEL decode [BLOCKS_PER_SM..]

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
wrapper's split target for one pass over the cases. Needs an NVIDIA card
and ``nvcc``.
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
