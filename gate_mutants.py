#!/usr/bin/env python3
"""Shows that ``chip_smoke.py``'s kernel gates refuse wrong kernels.

    python3 gate_mutants.py [--seed N]

Builds four kernel sources as they are and in broken forms, each form
from its own copy of the kernel sources in a temporary directory (the
checkout is not touched), every ``nvcc`` started together:

``flash_attention_fwd.cu`` (the flash forward, bf16), held by
``chip_smoke.flash_gate`` at phase 2's three configurations (B=4, S=2048,
H=16, D=128; causal MHA, non-causal MHA, causal GQA with 4 kv heads):

- ``stale V tile``: the last key tile's P @ V reads the other ring stage,
  which holds the previous tile's V;
- ``last key tile dropped``: each query tile stops one key tile short;
- ``causal diagonal + 1``: each row also sees the key past its diagonal;
- ``GQA head h % HKV``: query head h reads kv head ``h % HKV``.

``flash_attention_bwd.cu`` (the flash backward, bf16), held by
``chip_smoke.bwd_gate`` at the same three configurations:

- ``dQ: stale K/V tile``: the dQ kernel's last key tile reads the other
  ring stage, which holds the previous tile's K and V;
- ``dK/dV: stale Q/dO tile``: the dK/dV kernel's last query tile reads the
  previous tile's Q and dO the same way;
- ``dQ: last key tile dropped``: the dQ kernel stops one key tile short;
- ``dK/dV: last query tile dropped``: the dK/dV kernel stops one query
  tile short of each query head;
- ``causal diagonal + 1``: both kernels let each row see the key past its
  diagonal;
- ``GQA group``: the dQ kernel reads kv head ``h % HKV``, and the dK/dV
  kernel sums query heads ``hk, hk + HKV, ...`` into kv head ``hk`` in
  place of its own group.

``paged_decode_attention.cu`` (the split paged decode, float and int8
pools), held by ``chip_smoke.decode_gate`` at phase 2's B=16 case (lengths
1..2048 with both ends, H=KVH=16, D=128, bf16 q, 8 splits of 4 pages; the
int8 kernel on the same pools quantized), over all rows and over the rows
of the sequences longer than one token:

- ``scale row + 1``: every K/V row is scaled with the next row's scale
  (int8 only);
- ``last partial page dropped``: each sequence stops at its last full page;
- ``last token dropped``: each sequence attends over one token too few;
- ``last page's table slot + 1``: each sequence reads its last page
  through the next slot of its table row (sequences whose last page is the
  row's last slot are unchanged);
- ``merge skips the last split``: the block that merges a sequence's
  splits leaves out the last live one.

``fused_adamw.cu`` (the multi-tensor AdamW), held bitwise by
``chip_smoke.adamw_multi_diff`` at the train step's launch (the flagship's
75 bf16 tensors, bf16 moments, SR) against 75 per-tensor plain updates:

- ``chunk offset + 1 past a tensor boundary``: every tensor but the first
  starts one chunk late, so its first chunk is never updated;
- ``the next tensor's salts``: tensor t rounds with tensor t + 1's salts;
- ``the table's last tensor skipped``: the grid ends at the last tensor's
  first chunk;
- ``skip veto ignored``: the kernel updates p, m and v where the found-inf
  veto is set. The bitwise gate runs without the veto, so it is
  ``chip_smoke.fp16_overflow_check`` (phase 10(b)'s check, at one layer of
  full width) that must refuse it: a step overflowed by a scale of 2**40
  must leave parameters, moments and beta powers as they were.

Each variant runs through the kernel's own wrapper (``paged_decode`` and
``paged_decode_int8`` for the decode, ``fused_adamw_multi_update`` for
AdamW). It also prints the verdict of the
looser gates used before (flash forward: atol 2e-2 + rtol 2e-2 and lse;
flash backward: atol 5e-2 + rtol 5e-2 and 1e-2 over each whole gradient;
decode: atol 3e-2 + rtol 2e-2). Exits 0 only if each source as it is
passes and every broken form fails wherever it changes the result: a flash
mutant in every configuration where it does, a decode mutant on the long
rows alone, an AdamW mutant on the launch. The last line names the
mutants refused. Needs an NVIDIA card and ``nvcc``.
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

# library -> {variant: None (as is) or [(text found exactly once in its
# source, replacement), ...]}
MUTANTS = {
    "flash_attention_fwd": {
        "as is": None,
        "stale V tile": [(
            "const uint32_t v_tile = kt + Tile::KV_BYTES;",
            "const uint32_t v_tile = (tile > 0 && tile == n_tiles - 1 ?\n"
            "      kv_tiles + (st ^ 1) * 2 * Tile::KV_BYTES : kt) + Tile::KV_BYTES;")],
        "last key tile dropped": [(
            "const int n_tiles = key_tiles(q0, Sq, Sk, BK, causal);",
            "const int n_tiles = max(key_tiles(q0, Sq, Sk, BK, causal) - 1, 0);")],
        "causal diagonal + 1": [(
            "if (kj >= Sk || (causal && kj > qi + off)) s[4 * n + e] = -INFINITY;",
            "if (kj >= Sk || (causal && kj > qi + off + 1)) s[4 * n + e] = "
            "-INFINITY;")],
        "GQA head h % HKV": [(
            "const int kv_head = h / (H / HKV);",
            "const int kv_head = h % HKV;")],
    },
    "flash_attention_bwd": {
        "as is": None,
        "dQ: stale K/V tile": [(
            "const int k0 = tile * BK;\n"
            "    const uint32_t kt = kv_tiles + st * 2 * Tile::KV_BYTES;",
            "const int k0 = tile * BK;\n"
            "    const uint32_t kt = kv_tiles + (tile > 0 && tile == n_tiles - 1 ?\n"
            "      (st + DQ_STAGES - 1) % DQ_STAGES : st) * 2 * Tile::KV_BYTES;")],
        "dK/dV: stale Q/dO tile": [(
            "const int qs0 = (first + t % per_head) * BQ;\n"
            "    const uint32_t qt = qo_tiles + st * 2 * Tile::QO_BYTES;",
            "const int qs0 = (first + t % per_head) * BQ;\n"
            "    const uint32_t qt = qo_tiles + (t > 0 && t == n_tiles - 1 ?\n"
            "      (st + DKV_STAGES - 1) % DKV_STAGES : st) * 2 * Tile::QO_BYTES;")],
        "dQ: last key tile dropped": [(
            "const int n_tiles = key_tiles(q0, DQ_BQ, Sq, Sk, BK, causal);",
            "const int n_tiles = max(key_tiles(q0, DQ_BQ, Sq, Sk, BK, causal) - 1, "
            "0);")],
        "dK/dV: last query tile dropped": [(
            "const int per_head = max((Sq + BQ - 1) / BQ - first, 0);",
            "const int per_head = max((Sq + BQ - 1) / BQ - first - 1, 0);")],
        "causal diagonal + 1": [
            ("if (edge && (kj >= Sk || (causal && kj > qi + off))) p = 0.f;",
             "if (edge && (kj >= Sk || (causal && kj > qi + off + 1))) p = 0.f;"),
            ("if (edge && qi + off < kj) p = 0.f;",
             "if (edge && qi + off + 1 < kj) p = 0.f;")],
        "GQA group": [
            ("const int kv_head = h / (H / HKV);",
             "const int kv_head = h % HKV;"),
            ("const int h = hk * group + t / per_head;",
             "const int h = (t / per_head) * HKV + hk;")],
    },
    "paged_decode_attention": {
        "as is": None,
        "scale row + 1": [("s = __ldg(scales + row);",
                           "s = __ldg(scales + row + 1);")],
        "last partial page dropped": [(
            "const int len = min(cache_len[b * cl_stride] + 1, P * BS);",
            "const int len = min((cache_len[b * cl_stride] + 1) / BS * BS, "
            "P * BS);")],
        "last token dropped": [(
            "const int len = min(cache_len[b * cl_stride] + 1, P * BS);",
            "const int len = min(cache_len[b * cl_stride], P * BS);")],
        "last page's table slot + 1": [(
            "s_pages[i] = trow[i];",
            "s_pages[i] = trow[min(i + (split * pps + i == (len - 1) / BS), "
            "P - 1 - split * pps)];")],
        "merge skips the last split": [(
            "merge_splits<T, D>(partials + bh * splits * (D + 2), n_live, o);",
            "merge_splits<T, D>(partials + bh * splits * (D + 2), n_live - 1, "
            "o);")],
    },
    "fused_adamw": {
        "as is": None,
        "chunk offset + 1 past a tensor boundary": [(
            "const int64_t local = c - tab.chunk0[t];",
            "const int64_t local = c - tab.chunk0[t] + (t > 0);")],
        "the next tensor's salts": [(
            "const long long* st = salts + 2 * t;",
            "const long long* st = salts + 2 * ((t + 1) % tab.n_tensors);")],
        "the table's last tensor skipped": [(
            "const int grid = tab.chunk0[T];",
            "const int grid = tab.chunk0[T - 1];")],
        "skip veto ignored": [(
            "if (sc[3] != 0.f) return;",
            "if (sc[3] != 0.f && false) return;")],
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
        for i, (name, subs) in enumerate(variants.items()):
            d = tmp / f"{lib_name}-{i}"
            d.mkdir()
            for f in [*src_dir.glob("*.cu"), *src_dir.glob("*.cuh")]:
                shutil.copy(f, d)
            text = (d / source).read_text()
            for old, new in subs or ():
                if text.count(old) != 1:
                    raise SystemExit(f"gate_mutants: {old!r} is not once in "
                                     f"{source}; update MUTANTS")
                text = text.replace(old, new)
            (d / source).write_text(text)
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


def _shown(gate):
    return {k: ({kk: round(x, 6) if isinstance(x, float) else x
                 for kk, x in v.items()} if isinstance(v, dict)
                else round(v, 6) if isinstance(v, float) else v)
            for k, v in gate.items()}


def flash_mutants(torch, kernels, libs, lib_name, cases, run, gate_of, old,
                  card):
    """Every variant of a flash library at every configuration: ``run``
    launches the kernels on a case's inputs, ``gate_of`` grades the result
    against the case's references. A mutant that changes the result
    nowhere fails the run (it tests nothing). Returns (ok, refused,
    mutants counted)."""
    ok, refused, as_is = True, [], {}
    tag = "flash_fwd" if lib_name.endswith("fwd") else "flash_bwd"
    for name in MUTANTS[lib_name]:
        kernels._libs[lib_name] = libs[lib_name, name]
        failed_where_changed, changed_any = True, False
        for key, inputs, refs in cases:
            got = run(*inputs)
            torch.cuda.synchronize()
            gate = gate_of(got, refs)
            if name == "as is":
                as_is[key] = got
                changed = False
                ok &= gate["ok"]
            else:
                changed = not all(torch.equal(a, b)
                                  for a, b in zip(got, as_is[key]))
                changed_any |= changed
                if changed and gate["ok"]:
                    failed_where_changed = False
            print(f"{tag} {name}, causal={key[0]} KVH={key[1]}: "
                  f"{_shown(gate)} -> {'pass' if gate['ok'] else 'FAIL'} "
                  f"(the old gate alone, {old}: "
                  f"{'pass' if gate['old_ok'] else 'FAIL'}); "
                  f"{'changes' if changed else 'leaves'} the result [{card}]")
        if name != "as is":
            ok &= failed_where_changed and changed_any
            if failed_where_changed and changed_any:
                refused.append(f"{tag}: {name}")
    return ok, refused, len(MUTANTS[lib_name]) - 1


def fwd_mutants(torch, kernels, libs, dev, gen, card):
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd

    cases = []
    for causal, hkv in FLASH_CONFIGS:
        q, k, v = cs.flash_inputs(torch, dev, gen, hkv)
        cases.append(((causal, hkv), (q, k, v, causal),
                      cs.flash_references(q, k, v, causal)))
    return flash_mutants(
        torch, kernels, libs, "flash_attention_fwd", cases,
        flash_attention_fwd, lambda got, refs: cs.flash_gate(*got, *refs),
        f"atol {cs.FLASH_ATOL} + rtol {cs.RTOL} and lse", card)


def bwd_mutants(torch, kernels, libs, dev, gen, card):
    from paddle_tpu_torch.ops.flash_attention import flash_attention_bwd

    cases = []
    for causal, hkv in FLASH_CONFIGS:
        q, k, v, out, lse, do = cs.flash_bwd_inputs(torch, dev, gen, causal,
                                                    hkv)
        cases.append(((causal, hkv), (q, k, v, out, lse, do, causal),
                      cs.bwd_references(q, k, v, out, lse, do, causal)))
    return flash_mutants(
        torch, kernels, libs, "flash_attention_bwd", cases,
        flash_attention_bwd, lambda got, refs: cs.bwd_gate(got, *refs),
        f"atol {cs.BWD_ATOL} + rtol {cs.BWD_RTOL}, rel {cs.BWD_REL}", card)


def decode_mutants(torch, kernels, libs, dev, gen, gen_cpu, card):
    """Every paged-decode variant through the float and the int8 kernels
    at phase 2's B=16 case; a mutant counts once per kernel whose result
    it changes. Returns (ok, refused, mutants counted)."""
    from paddle_tpu_torch.ops.paged_attention import (
        _kv_quantize, paged_decode, paged_decode_int8, paged_decode_int8_plain,
        paged_decode_plain)

    lib_name = "paged_decode_attention"
    q, kp, vp, tables, cl, lengths = cs.paged_inputs(torch, dev, gen, gen_cpu,
                                                     16)
    (kq, ks), (vq, vs) = _kv_quantize(kp), _kv_quantize(vp)
    runs = {  # kernel -> (wrapper, inputs, plain version, f32 version, int8)
        "paged_decode": (paged_decode, (q, kp, vp, tables, cl),
                         paged_decode_plain(q, kp, vp, tables, cl),
                         cs.paged_plain_f32(q, kp, vp, tables, cl), False),
        "paged_decode_int8": (
            paged_decode_int8, (q, kq, vq, ks, vs, tables, cl),
            paged_decode_int8_plain(q, kq, vq, ks, vs, tables, cl),
            cs.int8_plain_f32(q, kq, vq, ks, vs, tables, cl), True)}
    long_rows = (lengths > 1).to(dev)
    ok, refused, as_is, counted = True, [], {}, 0
    for name in MUTANTS[lib_name]:
        kernels._libs[lib_name] = libs[lib_name, name]
        for kernel, (wrapper, inputs, want, want_f32, int8) in runs.items():
            got = wrapper(*inputs)
            torch.cuda.synchronize()
            every = cs.decode_gate(got, want, want_f32, int8)
            long = cs.decode_gate(got[long_rows], want[long_rows],
                                  want_f32[long_rows], int8)
            if name == "as is":
                as_is[kernel] = got
                changed = False
                ok &= every["ok"]
            else:
                changed = not torch.equal(got, as_is[kernel])
                if changed:
                    counted += 1
                    ok &= not long["ok"]
                    if not long["ok"]:
                        refused.append(f"{kernel}: {name}")
            print(f"{kernel} {name}: {_shown(every)} -> "
                  f"{'pass' if every['ok'] else 'FAIL'}; rows of length > 1: "
                  f"{_shown(long)} -> {'pass' if long['ok'] else 'FAIL'} (the "
                  f"old atol {cs.PAGED_ATOL} + rtol {cs.RTOL} gate alone: "
                  f"{'pass' if long['old_ok'] else 'FAIL'}); "
                  f"{'changes' if changed else 'leaves'} the result [{card}]")
    return ok, refused, counted


def adamw_mutants(torch, kernels, libs, dev, gen, card, ids):
    """Every AdamW variant on the train step's launch, each from the same
    p, m, v, and through phase 10(b)'s forced-overflow check; the launch's
    gate is bitwise, so a mutant is refused where either check fails, and
    one that both pass fails the run. Returns (ok, refused, mutants
    counted)."""
    lib_name = "fused_adamw"
    x = cs.adamw_multi_inputs(torch, dev, gen)
    want = cs.adamw_multi_plain(x)
    ok, refused = True, []
    for name in MUTANTS[lib_name]:
        kernels._libs[lib_name] = libs[lib_name, name]
        ps, ms, vs = ([t.clone() for t in x[k]] for k in ("ps", "ms", "vs"))
        cs.adamw_multi_launch(x, ps, ms, vs)
        torch.cuda.synchronize()
        n_diff = cs.adamw_multi_diff(torch, list(zip(ps, ms, vs)), want)
        del ps, ms, vs
        skip = cs.fp16_overflow_check(torch, dev, 1, ids, ids, seed=0)
        failed = bool(n_diff) or not skip["ok"]
        if name == "as is":
            ok &= not failed
        elif failed:
            refused.append(f"fused_adamw: {name}")
        else:
            ok = False
        shown = dict(list(n_diff.items())[:6], tensors_differing=len(
            {k[:-1] for k in n_diff}))
        print(f"fused_adamw {name}: elements differing from the per-tensor "
              f"plain updates {shown}; forced overflow at one layer: changed "
              f"{skip['changed_on_skip'][:4]}, next step changed "
              f"{skip['applied_next']} tensors -> "
              f"{'FAIL' if failed else 'pass'} [{card}]")
    return ok, refused, len(MUTANTS[lib_name]) - 1


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
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    gen_cpu = torch.Generator(device="cpu").manual_seed(args.seed)
    tmp = Path(tempfile.mkdtemp(prefix="gate_mutants_"))
    results = []
    try:
        libs = build_variants(kernels, tmp)
        results.append(fwd_mutants(torch, kernels, libs, dev, gen, card))
        torch.cuda.empty_cache()
        results.append(bwd_mutants(torch, kernels, libs, dev, gen, card))
        torch.cuda.empty_cache()
        results.append(decode_mutants(torch, kernels, libs, dev, gen, gen_cpu,
                                      card))
        torch.cuda.empty_cache()
        ids = torch.randint(0, cs.LLAMA_542M["vocab_size"],
                            (cs.TRAIN_BATCH, cs.TRAIN_SEQ),
                            generator=gen_cpu).to(dev)
        results.append(adamw_mutants(torch, kernels, libs, dev, gen, card,
                                     ids))
    finally:
        for lib_name in MUTANTS:
            kernels._libs.pop(lib_name, None)
        shutil.rmtree(tmp, ignore_errors=True)
    ok = all(r[0] for r in results)
    refused = [m for r in results for m in r[1]]
    print(json.dumps({
        "flash_gate": dict(
            atol=cs.FLASH_ATOL, rtol=cs.RTOL, lse_atol=cs.FLASH_LSE_ATOL,
            row_rel=cs.FLASH_ROW_REL, f32_atol=cs.FLASH_F32_ATOL,
            f32_rtol=cs.FLASH_F32_RTOL),
        "bwd_gate": dict(
            atol=cs.BWD_ATOL, rtol=cs.BWD_RTOL, rel=cs.BWD_REL,
            row_rel=cs.BWD_ROW_REL, row_floor=cs.BWD_ROW_FLOOR,
            f32_atol=cs.BWD_F32_ATOL, f32_rtol=cs.BWD_F32_RTOL),
        "paged_gate": dict(
            atol=cs.PAGED_ATOL, rtol=cs.RTOL, row_rel=cs.PAGED_ROW_REL,
            f32_atol=cs.PAGED_F32_ATOL, f32_rtol=cs.PAGED_F32_RTOL,
            f32_row_rel=cs.PAGED_F32_ROW_REL),
        "int8_gate": dict(
            atol=cs.INT8_ATOL, rtol=cs.INT8_RTOL, row_rel=cs.INT8_ROW_REL,
            f32_atol=cs.INT8_F32_ATOL, f32_rtol=cs.INT8_F32_RTOL,
            f32_row_rel=cs.INT8_F32_ROW_REL)}))
    print(card)
    n = sum(r[2] for r in results)
    print(f"gate_mutants: {'ok' if ok else 'FAIL'}; refused {len(refused)} "
          f"of {n} mutants: {'; '.join(refused)}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
