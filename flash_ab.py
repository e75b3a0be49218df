#!/usr/bin/env python3
"""Times the flash forward of the checkout it is run from.

    cd <checkout> && python3 <path>/flash_ab.py LABEL

Builds that checkout's ``flash_attention_fwd.cu``, then times
``flash_attention_fwd`` at ``chip_smoke.py`` phase 2's three
configurations (B=4, S=2048, H=16, D=128, bf16: causal MHA, non-causal
MHA, causal GQA with 4 kv heads): three CUDA-event means of 20 launches
each, after warm-up. Prints one JSON line: the label, the build's
seconds, the times in ms, ptxas' non-zero spill reports and its count of
serialised-``wgmma`` warnings. To compare two versions of the kernel,
unpack both into directories that ``.gitignore`` lists and run this in
each in turns (A, B, B, A) within one call on the card. Needs an NVIDIA
card and ``nvcc``.
"""
import json
import os
import sys
import time


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd

    if not torch.cuda.is_available():
        print("flash_ab: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    t0 = time.time()
    kernels.build(["flash_attention_fwd"])
    build_s = time.time() - t0
    log = (kernels.build_dir() / "flash_attention_fwd.log").read_text()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for causal, hkv in ((True, 16), (False, 16), (True, 4)):
        q = torch.randn(4, 2048, 16, 128, generator=g, device=dev).bfloat16()
        k = torch.randn(4, 2048, hkv, 128, generator=g, device=dev).bfloat16()
        v = torch.randn(4, 2048, hkv, 128, generator=g, device=dev).bfloat16()
        for _ in range(3):
            flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        ts = []
        for _ in range(3):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(20):
                flash_attention_fwd(q, k, v, causal)
            e.record()
            torch.cuda.synchronize()
            ts.append(s.elapsed_time(e) / 20)
        res[f"causal={causal},hkv={hkv}"] = [round(x, 4) for x in ts]
    lines = log.splitlines()
    spill = [ln.strip() for ln in lines
             if "spill" in ln and "0 bytes spill" not in ln]
    print(json.dumps({"label": sys.argv[1] if len(sys.argv) > 1 else "",
                      "build_s": round(build_s, 1), "ms": res,
                      "nonzero_spills": spill[:4],
                      "serialized": sum("serialized" in ln for ln in lines)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
