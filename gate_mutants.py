#!/usr/bin/env python3
"""Shows that ``chip_smoke.py``'s kernel gates refuse wrong kernels.

    python3 gate_mutants.py [--seed N]

Builds two kernel sources as they are and in broken forms, each form from
its own copy of the kernel sources in a temporary directory (the checkout
is not touched), every ``nvcc`` started together:

``flash_attention_fwd.cu`` (the flash forward, bf16), held by
``chip_smoke.flash_gate`` at phase 2's three configurations (B=4, S=2048,
H=16, D=128; causal MHA, non-causal MHA, causal GQA with 4 kv heads):

- ``stale V tile``: the last key tile's P @ V reads the other ring stage,
  which holds the previous tile's V;
- ``last key tile dropped``: each query tile stops one key tile short;
- ``causal diagonal + 1``: each row also sees the key past its diagonal;
- ``GQA head h % HKV``: query head h reads kv head ``h % HKV``.

``paged_decode_attention.cu`` (the int8 paged decode), held by
``chip_smoke.int8_gate`` at phase 2's int8 case (B=16, lengths 1..2048
with both ends, H=KVH=16, D=128, bf16 q), over all rows and over the rows
of the sequences longer than one token:

- ``scale row + 1``: every K/V row is dequantized with the next row's scale;
- ``last partial page dropped``: each sequence stops at its last full page;
- ``last token dropped``: each sequence attends over one token too few.

Each variant runs through the kernel's own wrapper. It also prints the
verdict of the looser gates used before (flash: atol 2e-2 + rtol 2e-2 and
lse; int8: atol 3e-2 + rtol 2e-2). Exits 0 only if each source as it is
passes and every broken form fails: a flash mutant in every configuration
where it changes the result, an int8 mutant on the long rows alone. The
last line names the mutants refused. Needs an NVIDIA card and ``nvcc``.
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

# library -> {variant: (text found exactly once in its source, replacement)}
MUTANTS = {
    "flash_attention_fwd": {
        "as is": None,
        "stale V tile": (
            "const uint32_t v_tile = kt + Tile::KV_BYTES;",
            "const uint32_t v_tile = (tile > 0 && tile == n_tiles - 1 ?\n"
            "      kv_tiles + (st ^ 1) * 2 * Tile::KV_BYTES : kt) + Tile::KV_BYTES;"),
        "last key tile dropped": (
            "const int n_tiles = key_tiles(q0, Sq, Sk, BK, causal);",
            "const int n_tiles = max(key_tiles(q0, Sq, Sk, BK, causal) - 1, 0);"),
        "causal diagonal + 1": (
            "if (kj >= Sk || (causal && kj > qi + off)) s[4 * n + e] = -INFINITY;",
            "if (kj >= Sk || (causal && kj > qi + off + 1)) s[4 * n + e] = "
            "-INFINITY;"),
        "GQA head h % HKV": (
            "const int kv_head = h / (H / HKV);",
            "const int kv_head = h % HKV;"),
    },
    "paged_decode_attention": {
        "as is": None,
        "scale row + 1": ("s = scales[row];", "s = scales[row + 1];"),
        "last partial page dropped": (
            "const int len = min(lengths[b], P * BS);",
            "const int len = min(lengths[b] / BS * BS, P * BS);"),
        "last token dropped": (
            "const int len = min(lengths[b], P * BS);",
            "const int len = min(lengths[b] - 1, P * BS);"),
    },
}
FLASH_CONFIGS = ((True, 16), (False, 16), (True, 4))  # (causal, kv heads)


def build_variants(kernels, tmp: Path):
    """``{(library, variant): CDLL}``, one ``nvcc`` per variant, all
    started together."""
    src_dir = Path(kernels.__file__).resolve().parent
    procs = {}
    for lib_name, variants in MUTANTS.items():
        source, _ = kernels.SOURCES[lib_name]
        for i, (name, sub) in enumerate(variants.items()):
            d = tmp / f"{lib_name}-{i}"
            d.mkdir()
            for f in [*src_dir.glob("*.cu"), *src_dir.glob("*.cuh")]:
                shutil.copy(f, d)
            text = (d / source).read_text()
            if sub is not None:
                if text.count(sub[0]) != 1:
                    raise SystemExit(f"gate_mutants: {sub[0]!r} is not once "
                                     f"in {source}; update MUTANTS")
                (d / source).write_text(text.replace(*sub))
            lib = d / f"{lib_name}.so"
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                   str(d / source)]
            procs[lib_name, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    libs = {}
    for (lib_name, name), (proc, path) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"gate_mutants: nvcc failed for {lib_name} "
                             f"{name}:\n{out[-4000:]}")
        lib = ctypes.CDLL(str(path))
        for symbol, argtypes in kernels.SOURCES[lib_name][1].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[lib_name, name] = lib
    return libs


def flash_mutants(torch, kernels, libs, dev, gen, card):
    """Every flash variant at every configuration. Returns (ok, refused)."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd

    lib_name = "flash_attention_fwd"
    cases = []
    for causal, hkv in FLASH_CONFIGS:
        q, k, v = cs.flash_inputs(torch, dev, gen, hkv)
        cases.append((causal, hkv, (q, k, v), cs.flash_references(q, k, v,
                                                                  causal)))
    ok, refused, as_is = True, [], {}
    for name in MUTANTS[lib_name]:
        kernels._libs[lib_name] = libs[lib_name, name]
        failed_where_changed = True
        for causal, hkv, qkv, refs in cases:
            out, lse = flash_attention_fwd(*qkv, causal)
            torch.cuda.synchronize()
            gate = cs.flash_gate(out, lse, *refs)
            if name == "as is":
                as_is[causal, hkv] = (out, lse)
                changed = False
                ok &= gate["ok"]
            else:
                out0, lse0 = as_is[causal, hkv]
                changed = not (torch.equal(out, out0) and torch.equal(lse, lse0))
                if changed and gate["ok"]:
                    failed_where_changed = False
            shown = {k: (round(x, 6) if isinstance(x, float) else x)
                     for k, x in gate.items()}
            print(f"flash_fwd {name}, causal={causal} KVH={hkv}: {shown} -> "
                  f"{'pass' if gate['ok'] else 'FAIL'} (the old atol "
                  f"{cs.FLASH_ATOL} + rtol {cs.RTOL} and lse gates alone: "
                  f"{'pass' if gate['old_ok'] else 'FAIL'}); "
                  f"{'changes' if changed else 'leaves'} the result [{card}]")
        if name != "as is":
            ok &= failed_where_changed
            if failed_where_changed:
                refused.append(f"flash_fwd: {name}")
    del cases, as_is
    return ok, refused


def int8_mutants(torch, kernels, libs, dev, gen, gen_cpu, card):
    """Every int8 paged-decode variant at phase 2's int8 case. Returns
    (ok, refused)."""
    from paddle_tpu_torch.ops.paged_attention import (
        _kv_quantize, paged_decode_int8, paged_decode_int8_plain)

    lib_name = "paged_decode_attention"
    q, kp, vp, tables, cl, lengths = cs.paged_inputs(torch, dev, gen, gen_cpu,
                                                     16)
    (kq, ks), (vq, vs) = _kv_quantize(kp), _kv_quantize(vp)
    inputs = (q, kq, vq, ks, vs, tables, cl)
    want = paged_decode_int8_plain(*inputs)
    want_f32 = cs.int8_plain_f32(*inputs)
    long_rows = (lengths > 1).to(dev)
    ok, refused = True, []
    for name in MUTANTS[lib_name]:
        kernels._libs[lib_name] = libs[lib_name, name]
        got = paged_decode_int8(*inputs)
        torch.cuda.synchronize()
        every = cs.int8_gate(got, want, want_f32)
        long = cs.int8_gate(got[long_rows], want[long_rows],
                            want_f32[long_rows])
        long["old_gate_ok"] = bool(torch.allclose(
            got[long_rows].float(), want[long_rows].float(),
            atol=cs.PAGED_ATOL, rtol=cs.RTOL))
        print(f"paged_decode_int8 {name}: {every} -> "
              f"{'pass' if every['ok'] else 'FAIL'}; rows of length > 1: "
              f"{long} -> {'pass' if long['ok'] else 'FAIL'} (the old atol "
              f"{cs.PAGED_ATOL} + rtol {cs.RTOL} gate alone: "
              f"{'pass' if long['old_gate_ok'] else 'FAIL'}) [{card}]")
        if name == "as is":
            ok &= every["ok"]
        else:
            ok &= not long["ok"]
            if not long["ok"]:
                refused.append(f"paged_decode_int8: {name}")
    return ok, refused


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("gate_mutants: CUDA is not available; this script runs on the "
              "card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import kernels

    card = cs.card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    gen_cpu = torch.Generator(device="cpu").manual_seed(args.seed)
    tmp = Path(tempfile.mkdtemp(prefix="gate_mutants_"))
    try:
        libs = build_variants(kernels, tmp)
        ok_f, refused_f = flash_mutants(torch, kernels, libs, dev, gen, card)
        ok_i, refused_i = int8_mutants(torch, kernels, libs, dev, gen, gen_cpu,
                                       card)
    finally:
        for lib_name in MUTANTS:
            kernels._libs.pop(lib_name, None)
        shutil.rmtree(tmp, ignore_errors=True)
    ok = ok_f and ok_i
    print(json.dumps({"flash_gate": dict(
        atol=cs.FLASH_ATOL, rtol=cs.RTOL, lse_atol=cs.FLASH_LSE_ATOL,
        row_rel=cs.FLASH_ROW_REL, f32_atol=cs.FLASH_F32_ATOL,
        f32_rtol=cs.FLASH_F32_RTOL), "int8_gate": dict(
        atol=cs.INT8_ATOL, rtol=cs.INT8_RTOL, row_rel=cs.INT8_ROW_REL,
        f32_atol=cs.INT8_F32_ATOL, f32_rtol=cs.INT8_F32_RTOL,
        f32_row_rel=cs.INT8_F32_ROW_REL)}))
    print(card)
    n = sum(len(v) - 1 for v in MUTANTS.values())
    print(f"gate_mutants: {'ok' if ok else 'FAIL'}; refused "
          f"{len(refused_f) + len(refused_i)} of {n} mutants: "
          f"{'; '.join(refused_f + refused_i)}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
