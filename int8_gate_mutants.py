#!/usr/bin/env python3
"""Shows that ``chip_smoke.py``'s gate for the int8 paged-decode kernel
rejects a wrong kernel.

    python3 int8_gate_mutants.py [--seed N]

Builds ``paddle_tpu_torch/ops/kernels/paged_decode_attention.cu`` as it is
and in three broken forms, each from its own copy of the kernel sources in
a temporary directory (the checkout is not touched):

- ``scale row + 1``: every K/V row is dequantized with the next row's scale;
- ``last partial page dropped``: each sequence stops at its last full page;
- ``last token dropped``: each sequence attends over one token too few.

Each variant runs through the ``paged_decode_int8`` wrapper at phase 2's
int8 case (B=16, lengths 1..2048 with both ends, H=KVH=16, D=128, bf16 q)
and is held against the plain version by ``chip_smoke.int8_gate``, over all
rows and over the rows of the sequences longer than one token. For
comparison it also prints the verdict of the float kernel's looser gate
(atol 3e-2 + rtol 2e-2), which the int8 case used before. Exits 0 only if
the source as it is passes and every broken form fails on the long rows
alone. Needs an NVIDIA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import chip_smoke as cs

LIB = "paged_decode_attention"
MUTANTS = {
    "as is": None,
    "scale row + 1": ("s = scales[row];", "s = scales[row + 1];"),
    "last partial page dropped": (
        "const int len = min(lengths[b], P * BS);",
        "const int len = min(lengths[b] / BS * BS, P * BS);"),
    "last token dropped": (
        "const int len = min(lengths[b], P * BS);",
        "const int len = min(lengths[b] - 1, P * BS);"),
}


def build_variants(kernels, tmp: Path):
    """One library per variant, every ``nvcc`` started together."""
    src_dir = Path(kernels.__file__).resolve().parent
    source, symbols = kernels.SOURCES[LIB]
    procs = {}
    for i, (name, sub) in enumerate(MUTANTS.items()):
        d = tmp / f"v{i}"
        d.mkdir()
        for f in [*src_dir.glob("*.cu"), *src_dir.glob("*.cuh")]:
            shutil.copy(f, d)
        text = (d / source).read_text()
        if sub is not None:
            if text.count(sub[0]) != 1:
                raise SystemExit(f"int8_gate_mutants: '{sub[0]}' is not once "
                                 f"in {source}; update MUTANTS")
            (d / source).write_text(text.replace(*sub))
        lib = d / f"{LIB}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
               str(d / source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), lib)
    libs = {}
    for name, (proc, path) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"int8_gate_mutants: nvcc failed for {name}:\n"
                             f"{out[-4000:]}")
        lib = ctypes.CDLL(str(path))
        for symbol, argtypes in symbols.items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("int8_gate_mutants: CUDA is not available; this script runs on "
              "the card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.paged_attention import (
        _kv_quantize, paged_decode_int8, paged_decode_int8_plain)

    card = cs.card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    gen_cpu = torch.Generator(device="cpu").manual_seed(args.seed)
    q, kp, vp, tables, cl, lengths = cs.paged_inputs(torch, dev, gen, gen_cpu,
                                                     16)
    (kq, ks), (vq, vs) = _kv_quantize(kp), _kv_quantize(vp)
    inputs = (q, kq, vq, ks, vs, tables, cl)
    want = paged_decode_int8_plain(*inputs)
    want_f32 = cs.int8_plain_f32(*inputs)
    long_rows = (lengths > 1).to(dev)

    ok = True
    results = {}
    tmp = Path(tempfile.mkdtemp(prefix="int8_gate_mutants_"))
    try:
        libs = build_variants(kernels, tmp)
        for name, lib in libs.items():
            kernels._libs[LIB] = lib  # the wrapper launches this variant
            got = paged_decode_int8(*inputs)
            torch.cuda.synchronize()
            every = cs.int8_gate(got, want, want_f32)
            long = cs.int8_gate(got[long_rows], want[long_rows],
                                want_f32[long_rows])
            long["old_gate_ok"] = bool(torch.allclose(
                got[long_rows].float(), want[long_rows].float(),
                atol=cs.PAGED_ATOL, rtol=cs.RTOL))
            results[name] = dict(all_rows=every, rows_longer_than_1=long)
            print(f"{name}: {every} -> {'pass' if every['ok'] else 'FAIL'}; "
                  f"rows of length > 1: {long} -> "
                  f"{'pass' if long['ok'] else 'FAIL'} (the old atol "
                  f"{cs.PAGED_ATOL} + rtol {cs.RTOL} gate alone: "
                  f"{'pass' if long['old_gate_ok'] else 'FAIL'}) [{card}]")
            ok &= every["ok"] if name == "as is" else not long["ok"]
    finally:
        kernels._libs.pop(LIB, None)
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"gate": dict(
        atol=cs.INT8_ATOL, rtol=cs.INT8_RTOL, row_rel=cs.INT8_ROW_REL,
        f32_atol=cs.INT8_F32_ATOL, f32_rtol=cs.INT8_F32_RTOL,
        f32_row_rel=cs.INT8_F32_ROW_REL), "variants": results}))
    print(card)
    print("int8_gate_mutants: " + ("ok" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
