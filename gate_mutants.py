#!/usr/bin/env python3
"""Shows that ``chip_smoke.py``'s gates refuse wrong kernels and wrong
serving host code.

    python3 gate_mutants.py [--seed N] [--phase18 | --phase19 | --phase20 |
                                         --phase21 | --phase22]

(``--phase18``, ``--phase19``, ``--phase20``, ``--phase21``,
``--phase22``: only that phase's mutants, below.)

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

The serving engine's host code, held by ``chip_smoke.py`` phase 12's
gates at full width (Llama-542M, random weights): each broken form is the
function's own source with one edit, compiled into a copy of the function
and patched in (the checkout is not touched):

- ``restore rebinds the pools``: a host-tier restore imports into new pool
  tensors, as the reference's rebinding import does; phase 12(c)'s
  address and stream gates (``chip_smoke.tier_failures``) must refuse it;
- ``harvest credits an expired slot's in-flight tokens``: overlap mode's
  harvest appends a dispatch's tokens to a request that expired while the
  dispatch was in flight; phase 12(b)'s deadline-under-overlap gate
  (``chip_smoke.overlap_expiry_ok``) must refuse it;
- ``frame decoder skips the CRC``: the host tier's frame decoder accepts a
  frame whose CRC does not match; phase 12(c)'s corrupt-spill gate must
  refuse it.

The disaggregated serving host code, the same way, held by
``chip_smoke.disagg_inprocess`` (phase 13(a)'s in-process gates: a
``prefill_only`` and a ``decode_only`` engine behind a ``DisaggRouter``,
Llama-542M at Part 5's settings, four 128-token prompts and one of 4096
tokens against the unified engine's streams):

- ``receiver takes up a transfer without its commit``: the receiver
  settles every transfer it sees parts of, so a sender killed between its
  parts leaves an acked (nacked) partial transfer; the partial-transfer
  gate must refuse it;
- ``prefill-only engine reserves decode blocks``: the prefill engine
  budgets a request's decode growth too; the held-blocks gate must refuse
  it;
- ``import rebinds the pools``: the decode engine's import writes into new
  pool tensors; the pool-address and stream gates must refuse it;
- ``sender skips the CRC``: the commit record carries no whole-payload
  CRC; the clean-handoff gate (no nack, no fallback) must refuse it.

The low-precision GEMMs, the same way, each variant through phase 14's
gates (``chip_smoke.fp8_gemm_failures`` at three of phase 14(a)'s shapes,
``chip_smoke.fp8_capture_failures``: the fp8 train step at two layers of
full width captured against eager, ``chip_smoke.trash_write_check``, and
``chip_smoke.lowp_generate_failures`` for int4 weight-only ``generate``):

- ``fp8 forward divides by one scale only``: the forward divides the f32
  product by the activation's scale alone; phase 14(a)'s output gate must
  refuse it;
- ``amax history rebound instead of rolled in place``: ``Fp8Linear``
  binds new history tensors, so a captured step keeps writing the old
  ones; phase 14(b)'s history gates (address kept, one entry a forward)
  must refuse it;
- ``int4 nibbles unpacked in swapped order``: ``_unpack_int4`` puts each
  byte's high nibble first; phase 14(d)'s last-logit gate must refuse it;
- ``KV write lanes sharing a cell race``: ``paged_write_kv`` lets every
  lane write its own value, so the lanes of rows on the trash block race
  for its cells; phase 14(c)'s write gate (``chip_smoke.trash_write_check``:
  repeated writes bitwise the CPU's) must refuse it.

The serving control plane, the same way, each variant through phase 15's
gates (``chip_smoke.autoscale_phase``: the autoscaled fleet at full width
over phase 15's trace cut to 30 requests over 5 s):

- ``kill() leaves the replica alive``: ``InProcessReplica.kill`` does
  nothing, so the drain victim is never killed; 15(b)'s kill, recovery
  and ``drain-died`` gates must refuse it;
- ``recovery skips the journal requeue``: the router's recovery drops the
  dead replica's accepted work instead of requeueing it; 15(b)'s every-
  request-ok gate must refuse it;
- ``capture listener never fires``: ``jit`` calls no capture listener;
  15(a)'s captures-equal-graphs gate must refuse it;
- ``retire_replica keeps a reference to the engine``: the router keeps
  each retired replica's engine; 15(b)'s freed-engines gate must refuse
  it.

Phase 16's host code, the same way, each variant through the part of
phase 16 whose gates must refuse it:

- ``the exported program holds the plain attention``: attention takes the
  plain path while ``jit.save`` exports; 16(a)'s node and launch gates
  (``chip_smoke.deploy_serving``) must refuse it;
- ``the export asks the tracing device``: the export takes the flash path
  only for tensors on the card, so a model saved on the CPU holds the plain
  attention wherever it is loaded; 16(a)'s gate on the model saved on the
  CPU (``chip_smoke.cpu_saved_serving``: nodes, launches on the card) must
  refuse it;
- ``the dy2static select runs only the true branch``: a converted ``if``
  on a device value returns the true branch's results; 16(b)'s spike-guard
  gate (captured against eager, bitwise, both branches) must refuse it;
- ``the piecewise path replays the prefix twice`` (once it is captured)
  and ``the piecewise path skips the breaking statement``: 16(b)'s
  piecewise gates (bitwise against eager, launches, the logged losses)
  must refuse them;
- ``the tensor checker never fires``: 16(c)'s forced-overflow gate
  (``chip_smoke.debugging_phase``) must refuse it.

Phase 17's data-parallel and sharding host code, the same way, but
patched into the two ranks that ``chip_smoke.dp_ranks`` launches (this
script runs as each rank, ``--rank17 ... --mutant NAME``, patches the
variant in, then runs ``chip_smoke.phase17_rank``), each through the part
of 17(b)-(c) whose gates must refuse it:

- ``DataParallel sums without averaging``: the gradient buckets are
  all-reduced but not divided by the group size; 17(b)'s gradient-mean
  gate (the final norm's gradient bitwise the mean of the ranks' own) must
  refuse it;
- ``the last gradient bucket is not reduced``: each rank keeps its own
  gradients of the first parameters; 17(b)'s cross-rank equality of the
  parameters must refuse it;
- ``stage 2 gives rank r the other rank's gradient shard``: the
  reduce-scatter's inputs are handed over in reverse order; 17(c)'s
  bitwise gates against ``DataParallel`` must refuse it;
- ``stage 3 gathers the parameter from before the update``: the step
  updates a copy of the shard, so the next forward gathers the old one;
  17(c)'s bitwise gate on stage 3 must refuse it;
- ``SR salts come from the local branch``: the salt generators follow
  the tracker's rank-offset branch; 17(b)'s cross-rank equality (SR on)
  must refuse it.

Phase 18's tensor-parallel host code, the same way, patched into the
ranks that ``chip_smoke.tp_ranks`` (two) or ``hybrid_ranks`` (four)
launch, against this process's serial runs (``P18_MUTANTS``, each with
its launch in ``P18_RUNS``; 18(a) at one step):

- ``a row-parallel layer skips its forward all-reduce`` and ``a
  column-parallel layer's backward skips the input-gradient all-reduce``:
  18(a)'s bitwise equality of the norms across ranks must refuse them;
- ``ParallelCrossEntropy shifts by the local max``: 18(a)'s per-token
  gate against the plain cross entropy on the gathered logits;
- ``a rank loads its neighbour's slice``: 18(a)'s check that the
  gathered shards are the serial weights;
- ``each query head attends with the next kv head``: 18(a)'s first-step
  gradients against the serial step's (the loss moves too little);
- ``the clip counts replicated parameters once per rank``: 18(c)'s clip
  norm against the gathered gradients' norm;
- ``recompute's rerun skips its forward all-reduce``: 18(b)'s bitwise
  gradients against the step without recompute.

Phase 19's pipeline, ring-attention and MoE host code, the same way,
patched into the ranks that ``chip_smoke.pp_ranks`` (two) or
``ppdp_ranks`` (four) launch, against this process's serial runs
(``P19_MUTANTS``, each with its launch in ``P19_RUNS``; 19(a) at one step
a V):

- ``a microbatch's output gradient sent as zeros``: a stage hands the
  previous one zeros instead of its input's gradient; 19(a)'s first-step
  gradients against the serial step's must refuse it;
- ``stacked rows loaded into the wrong chunk``: ``load_jax_params`` gives
  a stage the other stage's rows; 19(a)'s check that the stage holds the
  serial weights;
- ``the clip without the pp all-reduce``: each stage clips by its own
  norm; 19(d)'s clip norms against the serial step's;
- ``the ring's diagonal block treated as full``: the causal ring attends
  the diagonal block without its mask; 19(b)'s causal ring against plain
  attention;
- ``the ring's backward without the reversed ppermute``: each rank keeps
  the gradient of the kv block it received; 19(b)'s dk/dv against plain
  attention;
- ``the MoE clip without moe_group``: the expert squares are not summed
  over ep; 19(c)'s clip factor against the serial clip's;
- ``the ep gather's backward summed instead of split``: the experts'
  output gradient is summed over ep before each rank takes its rows;
  19(c)'s gradients against the serial layer's.

Phase 20's fault-tolerant training host code (``P20_MUTANTS``, each with
the part of phase 20 that must refuse it in ``P20_RUNS``; 20(a) without
its disk checkpoint and poison run):

- ``a snapshot that keeps references``: the in-RAM (and disk) capture
  keeps the live tensors, which the next steps write in place; 20(a)'s
  bitwise loss parity after a rollback (eager);
- ``a restore that rebinds under capture without a recapture``: the
  rollback binds fresh optimizer accumulators, as the reference does,
  while the captured graph keeps its old ones; 20(a) captured;
- ``an RNG restore that misses the graph's generator offsets``: the
  rollback restores every generator but the SR salts' the graph reads;
  20(a)'s bitwise parity (eager);
- ``a peer fetch that skips the inner CRC``: a payload corrupted on its
  way into the store restores as if intact; 20(b)'s corrupt-peer fallback
  to the disk tier;
- ``a resume that prefers a stale peer over fresher disk``: the older
  verified peer replica wins over the fresher disk checkpoint; the same;
- ``an assembly that fills a missing rank's shard with zeros``: the
  coverage check is gone; 20(c)'s relaunch assembling one rank's payload
  alone (patched into the three launches' ranks).

Phase 21's models (``P21_KERNEL_MUTANTS``, ``P21_MUTANTS``):

- ``dK/dV: the ragged key tile dropped``: the dK/dV kernel's grid stops at
  the last whole 64-key tile, so a key length of 77 (the UNet's
  cross-attention over the text context) leaves keys 64..76 unwritten;
  phase 2's BWD_* gates at ``chip_smoke.P21_ATTN``'s shapes;
- ``interpolate samples torch's nearest``: ``floor(i * in / out)`` in
  place of the half-pixel ``floor((i + 0.5) * in / out)``;
- ``GroupNorm over the wrong axis``: each channel normalized over its own
  positions, not over its group's channels;
- ``f32 convolution on TF32``: the f32 convolution lets cuDNN take TF32;
  these three by 21(e)'s float64 references
  (``chip_smoke.p21_semantics``).

Phase 22's vision slice and 18(e) (``P22_MUTANTS``, each with its part in
``P22_PARTS``; ``--phase22`` runs them alone, the original through every
part first):

- ``a max pool padded with zeros``: the max pool always pads explicitly,
  with zeros; 22(c)'s float64 gate on signed inputs at the stem's shape;
- ``adaptive bins off by one``: the adaptive average drops the last row
  and column of every channel; 22(c);
- ``BatchNorm statistics frozen inside the replay``: a batch norm under
  capture skips its running-statistics update; 22(a)'s statistics against
  the eager twin after each step;
- ``the fused step skips one of the tensors``: AdamW's fused step leaves
  out the group's last tensor; 22(b)'s 161-tensor calls against the plain
  version;
- ``the fused qkv cut in contiguous blocks``: ``fleet`` cuts GPT's and
  BERT's fused qkv as one block (rank 0 all of q and half of k); 18(e)
  in the two ranks, patched in as phase 18's are.

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
import contextlib
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


def build_variants(kernels, tmp: Path, table=None):
    """``{(library, variant): CDLL}`` of ``table`` (default ``MUTANTS``),
    one ``nvcc`` per variant, all started together."""
    src_dir = Path(kernels.__file__).resolve().parent
    procs = {}
    for lib_name, variants in (table or MUTANTS).items():
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
                  card, table=None):
    """Every variant of a flash library at every configuration: ``run``
    launches the kernels on a case's inputs, ``gate_of`` grades the result
    against the case's references. A mutant that changes the result
    nowhere fails the run (it tests nothing). Returns (ok, refused,
    mutants counted)."""
    ok, refused, as_is = True, [], {}
    tag = "flash_fwd" if lib_name.endswith("fwd") else "flash_bwd"
    variants = (table or MUTANTS)[lib_name]
    for name in variants:
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
            where = (f"causal={key[0]} KVH={key[1]}"
                     if isinstance(key[1], int) else f"{key[1]} "
                     f"causal={key[0]}")
            print(f"{tag} {name}, {where}: "
                  f"{_shown(gate)} -> {'pass' if gate['ok'] else 'FAIL'} "
                  f"(the old gate alone, {old}: "
                  f"{'pass' if gate['old_ok'] else 'FAIL'}); "
                  f"{'changes' if changed else 'leaves'} the result [{card}]")
        if name != "as is":
            ok &= failed_where_changed and changed_any
            if failed_where_changed and changed_any:
                refused.append(f"{tag}: {name}")
    return ok, refused, len(variants) - 1


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


# the serving engine's host code: variant -> (module, function's qualified
# name, [(text found exactly once in its dedented source, replacement),
# ...])
HOST_MUTANTS = {
    "as is": None,
    "restore rebinds the pools": (
        "paddle_tpu_torch.inference.serving",
        "ContinuousBatchingEngine._tier_restore", [(
            "        _, blocks = self.manager.import_blocks(",
            "        self._pools = [tuple(t.clone() for t in e)\n"
            "                       for e in self._pools]\n"
            "        _, blocks = self.manager.import_blocks(")]),
    "harvest credits an expired slot's in-flight tokens": (
        "paddle_tpu_torch.inference.serving",
        "ContinuousBatchingEngine._apply_decode", [(
            "        if slot.req is not req:\n            continue",
            "        if slot.req is not req:\n"
            "            if req.status == \"expired\":\n"
            "                req.out.extend(int(x) for x in toks[:, i])\n"
            "            continue")]),
    "frame decoder skips the CRC": (
        "paddle_tpu_torch.inference.cache_tier", "_decode", [(
            "    if zlib.crc32(frame[:-4]) & 0xFFFFFFFF != crc:\n"
            "        return None\n", "")]),
}


# the disaggregated serving host code, in HOST_MUTANTS' form
DISAGG_MUTANTS = {
    "as is": None,
    "receiver takes up a transfer without its commit": (
        "paddle_tpu_torch.inference.disagg",
        "KVHandoffReceiver.recv_handoff", [(
            "for seq in sorted(committed):", "for seq in sorted(seqs):")]),
    "prefill-only engine reserves decode blocks": (
        "paddle_tpu_torch.inference.serving",
        "ContinuousBatchingEngine._blocks_needed", [(
            "new = 0", "new = new")]),
    "import rebinds the pools": (
        "paddle_tpu_torch.inference.serving",
        "ContinuousBatchingEngine.import_kv", [(
            "self.manager.import_blocks(req.req_id, pages, scales, meta,",
            "self._pools = [tuple(t.clone() for t in e) "
            "for e in self._pools]; "
            "self.manager.import_blocks(req.req_id, pages, scales, meta,")]),
    "sender skips the CRC": (
        "paddle_tpu_torch.inference.disagg",
        "KVHandoffSender._put_transfer", [(
            '"crc": zlib.crc32(data) & 0xFFFFFFFF,', '"crc": 0,')]),
}


# the low-precision GEMMs, in HOST_MUTANTS' form
LOWP_MUTANTS = {
    "as is": None,
    "fp8 forward divides by one scale only": (
        "paddle_tpu_torch.amp.fp8", "_Fp8Dot.forward", [(
            "y = (acc / (x_scale * w_scale)).to(x.dtype)",
            "y = (acc / x_scale).to(x.dtype)")]),
    "amax history rebound instead of rolled in place": (
        "paddle_tpu_torch.amp.fp8", "Fp8Linear.forward", [(
            "self._roll(self.amax_history_x, cur_x)",
            "self.amax_history_x = torch.cat([self.amax_history_x[1:], "
            "cur_x.reshape(1)])"), (
            "self._roll(self.amax_history_w, cur_w)",
            "self.amax_history_w = torch.cat([self.amax_history_w[1:], "
            "cur_w.reshape(1)])")]),
    "int4 nibbles unpacked in swapped order": (
        "paddle_tpu_torch.nn.quant", "_unpack_int4", [(
            "torch.stack([lo, hi], dim=1)", "torch.stack([hi, lo], dim=1)")]),
    "KV write lanes sharing a cell race": (
        "paddle_tpu_torch.ops.paged_attention", "paged_write_kv", [(
            "        vals = vals.reshape(vals.shape[0], b * s, "
            "*vals.shape[3:])[:, src]\n"
            "        vals = vals.reshape(vals.shape[0], b, s, "
            "*vals.shape[2:])\n", "")]),
}
# the serving control plane (phase 15), in HOST_MUTANTS' form
CONTROL_MUTANTS = {
    "as is": None,
    "kill() leaves the replica alive": (
        "paddle_tpu_torch.inference.cluster", "InProcessReplica.kill", [(
            "    self._dead = True\n    self.supervisor.close()",
            "    pass")]),
    "recovery skips the journal requeue": (
        "paddle_tpu_torch.inference.cluster",
        "ClusterRouter.recover_replica", [(
            "    for rid, rec in pending.items():",
            "    for rid in pending:\n"
            "        self.inflight.pop(rid, None)\n"
            "    for rid, rec in {}.items():")]),
    "capture listener never fires": (
        "paddle_tpu_torch.jit", "_notify_capture", [(
            "    for fn in list(_capture_listeners):\n        fn(name, seconds)",
            "    return")]),
    "retire_replica keeps a reference to the engine": (
        "paddle_tpu_torch.inference.cluster",
        "ClusterRouter.retire_replica", [(
            "    try:\n        rep.stop(deadline=deadline)",
            "    self.__dict__.setdefault('_kept', []).append(\n"
            "        rep.supervisor.engine)\n"
            "    try:\n        rep.stop(deadline=deadline)")]),
}
# phase 16: the deployed forward, dy2static, the piecewise split and the
# tensor checker, in HOST_MUTANTS' form, each with the part of phase 16
# whose gates must refuse it
DEPLOY_MUTANTS = {
    "as is": None,
    "the exported program holds the plain attention": (
        "paddle_tpu_torch.nn.functional.attention", "_use_flash", [(
            "if mask is not None or dropout_p > 0:",
            "if mask is not None or dropout_p > 0 or "
            "torch.compiler.is_exporting():")]),
    "the export asks the tracing device": (
        "paddle_tpu_torch.nn.functional.attention", "_use_flash", [(
            'if q.device.type != "cuda" and not torch.compiler.is_exporting():',
            'if q.device.type != "cuda":')]),
    "the dy2static select runs only the true branch": (
        "paddle_tpu_torch.jit.dy2static", "convert_ifelse", [(
            "    f_out = false_fn(*init_args)\n"
            "    return tuple(_select_leaf(pred, a, b) "
            "for a, b in zip(t_out, f_out))",
            "    return t_out")]),
    "the piecewise path replays the prefix twice": (
        "paddle_tpu_torch.jit", "StaticFunction._build_piecewise", [(
            "        carry = pre_sf(*args, **kw)\n",
            # once captured (a second call that captured would record a
            # backward into the first call's eager gradients, which the
            # suffix frees)
            "        carry = pre_sf(*args, **kw)\n"
            "        if pre_sf._graphs:\n"
            "            carry = pre_sf(*args, **kw)\n")]),
    "the piecewise path skips the breaking statement": (
        "paddle_tpu_torch.jit", "StaticFunction._build_piecewise", [(
            "carry2 = brk_fn(detached(carry))", "carry2 = detached(carry)")]),
    "the tensor checker never fires": (
        "paddle_tpu_torch.amp.debugging", "TensorCheckerConfig.__call__", [(
            "    if not self.enable or not self._step_active():\n"
            "        return\n", "    return\n")]),
}
DEPLOY_PARTS = {
    "the exported program holds the plain attention": ("16(a)",),
    "the export asks the tracing device": ("16(a)",),
    "the dy2static select runs only the true branch": ("16(b)",),
    "the piecewise path replays the prefix twice": ("16(b)",),
    "the piecewise path skips the breaking statement": ("16(b)",),
    "the tensor checker never fires": ("16(c)",),
}
# phase 17, in HOST_MUTANTS' form, each with the parts of 17(b)-(c) whose
# gates must refuse it; patched into the launched ranks
P17_MUTANTS = {
    "as is": None,
    "DataParallel sums without averaging": (
        "paddle_tpu_torch.distributed.parallel", "DataParallel._sync_grads", [(
            "flat.div_(n)", "flat.div_(1)")]),
    "the last gradient bucket is not reduced": (
        "paddle_tpu_torch.distributed.parallel", "DataParallel._sync_grads", [(
            "for bucket in self._buckets:",
            "for bucket in self._buckets[:-1]:")]),
    "stage 2 gives rank r the other rank's gradient shard": (
        "paddle_tpu_torch.distributed.sharding",
        "_GroupSharded._after_backward", [(
            "reduce_scatter(g, parts, group=self.group)",
            "reduce_scatter(g, parts[::-1], group=self.group)")]),
    "stage 3 gathers the parameter from before the update": (
        "paddle_tpu_torch.distributed.sharding",
        "_GroupSharded._after_backward", [(
            "p.data = s.shard\n", "p.data = s.shard.clone()\n")]),
    "SR salts come from the local branch": (
        "paddle_tpu_torch.base.random", "_salt_seed", [(
            "RNGStatesTracker.GLOBAL)", "RNGStatesTracker.LOCAL)")]),
}
P17_PARTS = {
    "as is": "bc",
    "DataParallel sums without averaging": "b",
    "the last gradient bucket is not reduced": "b",
    "stage 2 gives rank r the other rank's gradient shard": "c",
    "stage 3 gathers the parameter from before the update": "c",
    "SR salts come from the local branch": "b",
}
# phase 18, in HOST_MUTANTS' form, each with the launch ("tp" with its
# parts, or "hybrid") whose gates must refuse it; patched into the ranks
P18_MUTANTS = {
    "as is": None,
    "a row-parallel layer skips its forward all-reduce": (
        "paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers",
        "RowParallelLinear.forward", [(
            "y = _ReduceFromMP.apply(y, self.model_parallel_group)",
            "y = y")]),
    "a column-parallel layer's backward skips the input-gradient all-reduce": (
        "paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers",
        "_CopyToMP.backward", [(
            "all_reduce(dy, group=ctx.group)", "pass")]),
    "ParallelCrossEntropy shifts by the local max": (
        "paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers",
        "_ParallelCE.forward", [(
            "all_reduce(gmax, op=ReduceOp.MAX, group=group)", "pass")]),
    "a rank loads its neighbour's slice": (
        "paddle_tpu_torch.utils.convert", "_cut", [(
            "np.split(g, n, axis=axis)[rank]",
            "np.split(g, n, axis=axis)[(rank + 1) % n]")]),
    "each query head attends with the next kv head": (
        "paddle_tpu_torch.models.llama", "LlamaAttention.forward", [(
            "theta = self.config.rope_theta",
            "theta = self.config.rope_theta\n"
            "    k, v = k.roll(1, 2), v.roll(1, 2)")]),
    "the clip counts replicated parameters once per rank": (
        "paddle_tpu_torch.distributed.fleet.meta_optimizers",
        "HybridParallelClipGrad.__call__", [(
            'if getattr(p, "is_distributed", False):', "if True:")]),
    "recompute's rerun skips its forward all-reduce": (
        "paddle_tpu_torch.distributed.fleet.utils.recompute", "recompute", [(
            "        with _random.replay_rng(captured):\n"
            "            return function(*a, **kwargs)",
            "        from paddle_tpu_torch.distributed.fleet.layers.mpu "
            "import mp_layers as _m\n"
            "        _m._ReduceFromMP.apply = lambda x, g: x\n"
            "        try:\n"
            "            with _random.replay_rng(captured):\n"
            "                return function(*a, **kwargs)\n"
            "        finally:\n"
            "            del _m._ReduceFromMP.apply")]),
}
# the launch each runs through: ("tp", parts, steps) or ("hybrid",)
P18_RUNS = {
    "as is": None,
    "a row-parallel layer skips its forward all-reduce": ("tp", "a", 1),
    "a column-parallel layer's backward skips the input-gradient all-reduce":
        ("tp", "a", 1),
    "ParallelCrossEntropy shifts by the local max": ("tp", "a", 1),
    "a rank loads its neighbour's slice": ("tp", "a", 1),
    "each query head attends with the next kv head": ("tp", "a", 1),
    "the clip counts replicated parameters once per rank": ("hybrid",),
    "recompute's rerun skips its forward all-reduce": ("tp", "b", 1),
}
# phase 19, in HOST_MUTANTS' form, each with the launch whose gates must
# refuse it; patched into the ranks
P19_MUTANTS = {
    "as is": None,
    "a microbatch's output gradient sent as zeros": (
        "paddle_tpu_torch.distributed.fleet.meta_parallel.pipeline_parallel",
        "PipelineParallel._backward_ticks", [(
            "grads.append(torch.zeros_like(outs[t]) if g is None else g)",
            "grads.append(torch.zeros_like(outs[t]))")]),
    "stacked rows loaded into the wrong chunk": (
        "paddle_tpu_torch.utils.convert", "_tp_slice", [(
            'a = _cut(a, t, getattr(t, "_pp_rows", None), 0)',
            'pr = getattr(t, "_pp_rows", None)\n'
            '    a = _cut(a, t, pr and ((pr[0] + 1) % pr[1], pr[1]), 0)')]),
    "the clip without the pp all-reduce": (
        "paddle_tpu_torch.distributed.fleet.meta_optimizers",
        "HybridParallelClipGrad.__call__", [(
            "all_reduce(total, group=self._pp_group)", "pass")]),
    "the ring's diagonal block treated as full": (
        "paddle_tpu_torch.ops.ring_attention", "ring_attention", [(
            "causal and src == rank)", "False)")]),
    "the ring's backward without the reversed ppermute": (
        "paddle_tpu_torch.distributed.communication", "_PPermute.backward", [(
            "_ppermute(dy, back, ctx.g, ctx.name)", "dy")]),
    "the MoE clip without moe_group": (
        "paddle_tpu_torch.distributed.fleet.meta_parallel.moe",
        "ClipGradForMOEByGlobalNorm._reduce_expert_sq", [(
            "all_reduce(sq, group=self.moe_group)", "pass")]),
    "the ep gather's backward summed instead of split": (
        "paddle_tpu_torch.distributed.fleet.meta_parallel.moe",
        "ExpertMLP.forward", [(
            "import _GatherFromMP, _ScatterToMP",
            "import _CopyToMP, _GatherFromMP, _ScatterToMP"), (
            "_GatherFromMP.apply(out, g, 0)",
            "_GatherFromMP.apply(_CopyToMP.apply(out, g), g, 0)")]),
}
# the launch each runs through: ("pp", parts, steps) or ("ppdp",)
P19_RUNS = {
    "as is": None,
    "a microbatch's output gradient sent as zeros": ("pp", "a", 1),
    "stacked rows loaded into the wrong chunk": ("pp", "a", 1),
    "the clip without the pp all-reduce": ("ppdp",),
    "the ring's diagonal block treated as full": ("pp", "b", 1),
    "the ring's backward without the reversed ppermute": ("pp", "b", 1),
    "the MoE clip without moe_group": ("pp", "c", 1),
    "the ep gather's backward summed instead of split": ("pp", "c", 1),
}
# phase 20, in HOST_MUTANTS' form, each with the part of phase 20 whose
# gates must refuse it: ("a", modes), ("b",) the corrupt-peer fallback,
# ("c",) the elastic launches (the variant patched into their ranks)
P20_MUTANTS = {
    "as is": None,
    "a snapshot that keeps references": (
        "paddle_tpu_torch.incubate.checkpoint.auto_checkpoint",
        "AutoCheckpoint._snapshot", [(
            "return obj.detach().clone()", "return obj.detach()")]),
    "a restore that rebinds under capture without a recapture": (
        "paddle_tpu_torch.training.supervisor", "TrainingSupervisor._restore",
        [("restore_optimizer(opt, _unplaced(sd))",
          "opt.set_state_dict(_unplaced(sd))")]),
    "an RNG restore that misses the graph's generator offsets": (
        "paddle_tpu_torch.training.supervisor", "TrainingSupervisor._restore",
        [('_random.restore_rng_state(state["rng"])',
          '_random.restore_rng_state({**state["rng"], "salts": {}})')]),
    "a peer fetch that skips the inner CRC": (
        "paddle_tpu_torch.training.peer_snapshot", "PeerReplicator.fetch", [(
            "if binascii.crc32(payload) & 0xFFFFFFFF != want:", "if False:")]),
    "a resume that prefers a stale peer over fresher disk": (
        "paddle_tpu_torch.training.supervisor",
        "TrainingSupervisor._resume_tiers", [(
            "and got[0] < disk_step:", "and False:")]),
    "an assembly that fills a missing rank's shard with zeros": (
        "paddle_tpu_torch.distributed.checkpoint.reshard", "_fill", [(
            "if not covered.all():", "if False:")]),
}
P20_RUNS = {
    "as is": None,
    "a snapshot that keeps references": ("a", ("eager",)),
    "a restore that rebinds under capture without a recapture": (
        "a", ("captured",)),
    "an RNG restore that misses the graph's generator offsets": (
        "a", ("eager",)),
    "a peer fetch that skips the inner CRC": ("b",),
    "a resume that prefers a stale peer over fresher disk": ("b",),
    "an assembly that fills a missing rank's shard with zeros": ("c",),
}
# phase 21: the flash backward with the dK/dV grid one key tile short where
# the key length is ragged (Sk = 77: its keys 64..76 are never written),
# held by phase 2's BWD_* gates at phase 21's attention shapes
P21_KERNEL_MUTANTS = {
    "flash_attention_bwd": {
        "as is": None,
        "dK/dV: the ragged key tile dropped": [(
            "const int nk = (a.Sk + DKV_BK - 1) / DKV_BK;",
            "const int nk = a.Sk / DKV_BK;")],
    },
}
# phase 21's layer semantics, in HOST_MUTANTS' form, held by
# chip_smoke.p21_semantics (21(e))
P21_MUTANTS = {
    "as is": None,
    "interpolate samples torch's nearest": (
        "paddle_tpu_torch.nn.functional.common", "_nearest_axis", [(
            "idx = ((torch.arange(n_out, dtype=torch.float32, "
            "device=x.device) + 0.5)",
            "idx = ((torch.arange(n_out, dtype=torch.float32, "
            "device=x.device))")]),
    "GroupNorm over the wrong axis": (
        "paddle_tpu_torch.nn.functional.norm", "group_norm", [(
            "_normalize(g, tuple(range(2, g.dim())), epsilon)",
            "_normalize(g, tuple(range(3, g.dim())), epsilon)")]),
    "f32 convolution on TF32": (
        "paddle_tpu_torch.nn.functional.conv", "_precision", [(
            "allow_tf32=False", "allow_tf32=True")]),
}
# phase 22, in HOST_MUTANTS' form, each with the part of phase 22 (or 18(e),
# in the two ranks) whose gates must refuse it
P22_MUTANTS = {
    "as is": None,
    "a max pool padded with zeros": (
        "paddle_tpu_torch.nn.functional.pooling", "_max_pool", [
            ("tpad = _torch_pads(ks, pads)", "tpad = None"),
            ("value=_lowest(x.dtype)", "value=0.0")]),
    "adaptive bins off by one": (
        "paddle_tpu_torch.nn.functional.pooling", "_adaptive", [(
            "return _from_channels_first(_AAVG[n](x, size), moved)",
            "return _from_channels_first(_AAVG[n](\n"
            "            x[(Ellipsis,) + (slice(0, -1),) * n], size), moved)")]),
    "BatchNorm statistics frozen inside the replay": (
        "paddle_tpu_torch.nn.functional.norm", "batch_norm", [(
            "    with torch.no_grad():",
            "    if torch.cuda.is_current_stream_capturing():\n"
            "        return _affine(out, weight, bias, shape)\n"
            "    with torch.no_grad():")]),
    "the fused step skips one of the tensors": (
        "paddle_tpu_torch.optimizer.optimizer", "AdamW._fused_step", [(
            "ps, pvs, gs, ms, vs, lrs, masters = map(list, zip(*items))",
            "ps, pvs, gs, ms, vs, lrs, masters = map(list, zip(*items[:-1]))"
        )]),
    "the fused qkv cut in contiguous blocks": (
        "paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers", "_split", [(
            "parts = x.unflatten(dim, (groups, -1))",
            "parts = x.unflatten(dim, (1, -1))")]),
}
# the part that runs each: "recipe" (22(a)-(b)), "pools" (22(c)) or "ranks"
# (18(e), the two-rank launch with the variant patched into the ranks)
P22_PARTS = {
    "a max pool padded with zeros": ("pools",),
    "adaptive bins off by one": ("pools",),
    "BatchNorm statistics frozen inside the replay": ("recipe",),
    "the fused step skips one of the tensors": ("recipe",),
    "the fused qkv cut in contiguous blocks": ("ranks",),
}
# control_mutants' trace: phase 15's, shortened (the gates count no requests)
CONTROL_TRACE = dict(n_requests=30, duration_s=5.0)
# lowp_mutants' GEMM shapes: a train/prefill shape, a decode's and the odd
LOWP_MUTANT_SHAPES = (cs.LOWP_GEMM_SHAPES[0],) + cs.LOWP_GEMM_SHAPES[-2:]


def host_variant(name, table=None):
    """Patch in the broken form ``name`` of a host function (from
    ``table``, default ``HOST_MUTANTS``); returns the callable that puts
    the original back."""
    import importlib
    import inspect
    import textwrap

    module, qual, edits = (HOST_MUTANTS if table is None else table)[name]
    mod = importlib.import_module(module)
    owner, attr = mod, qual
    if "." in qual:
        cls, attr = qual.split(".")
        owner = getattr(mod, cls)
    real = owner.__dict__[attr]
    src = textwrap.dedent(inspect.getsource(real))
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"gate_mutants: {name!r}: the text to replace "
                             f"is not in {qual} exactly once; update "
                             f"HOST_MUTANTS")
        src = src.replace(old, new)
    scope = dict(vars(mod))
    exec(compile(src, f"<{name}>", "exec"), scope)
    # a module-level function its package re-exports is patched there too
    owners = [owner]
    parent = importlib.import_module(module.rpartition(".")[0] or module)
    if owner is mod and parent is not mod and \
            parent.__dict__.get(attr) is real:
        owners.append(parent)
    for o in owners:
        setattr(o, attr, scope[attr])
    return lambda: [setattr(o, attr, real) for o in owners]


def host_mutants(torch, np, dev, args, card):
    """Every host variant through phase 12(b)'s deadline-under-overlap
    check and 12(c)'s tier gates (bf16 pools, HOST_TIER_REQUESTS
    requests), on one full-width model. Returns (ok, refused, mutants
    counted)."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    pt_seed(args.seed)
    model = LlamaForCausalLM(LlamaConfig(**cs.LLAMA_542M), device=dev,
                             dtype=torch.bfloat16)
    model.eval()
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cs.LLAMA_542M["vocab_size"],
                           (int(cs.OVERLOAD_LENS[i % 3]),)) for i in range(6)]
    ok, refused = True, []
    for name in HOST_MUTANTS:
        restore = (lambda: None) if HOST_MUTANTS[name] is None else \
            host_variant(name)
        try:
            try:
                exp_ok = cs.overlap_expiry_ok(
                    cs.overlap_expiry_check(torch, np, model, prompts))
            except Exception as e:  # noqa: BLE001 - a crash refuses too
                exp_ok = False
                print(f"host {name}: the overlap expiry check raised {e!r}")
            try:
                bad = cs.tier_failures(cs.tier_runs(
                    torch, np, model, None, HOST_TIER_REQUESTS,
                    which=cs.TIER_ENGINES[1:]))
            except Exception as e:  # noqa: BLE001 - a crash refuses too
                bad = [f"the tier runs raised {e!r}"]
        finally:
            restore()
            torch.cuda.synchronize()
        failed = not exp_ok or bool(bad)
        if name == "as is":
            ok &= not failed
        elif failed:
            refused.append(f"serving host code: {name}")
        else:
            ok = False
        print(f"host {name}: deadline under overlap "
              f"{'pass' if exp_ok else 'FAIL'}; tier gates "
              f"{'; '.join(bad) if bad else 'pass'} -> "
              f"{'FAIL' if failed else 'pass'} [{card}]")
    del model
    torch.cuda.empty_cache()
    return ok, refused, len(HOST_MUTANTS) - 1


# the tier gates' traffic in host_mutants: every family once, then again
HOST_TIER_REQUESTS = 2 * cs.TIER_FAMILIES
# disagg_mutants' traffic: phase 13's first short prompts and a long one
DISAGG_MUTANT_SHORT = 4


def disagg_mutants(torch, np, dev, args, card):
    """Every disaggregated-serving variant through phase 13(a)'s
    in-process gates (``chip_smoke.disagg_inprocess``) on one full-width
    model, against the unified engine's streams. Returns (ok, refused,
    mutants counted)."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    pt_seed(args.seed)
    model = LlamaForCausalLM(LlamaConfig(**cs.LLAMA_542M), device=dev,
                             dtype=torch.bfloat16)
    model.eval()
    work = cs.disagg_work(np, model.config.vocab_size, args.seed)
    work = work[:DISAGG_MUTANT_SHORT] + work[-1:]
    uni_eng = cs.unified_engine(np, model)
    uni = cs.unified_run(torch, uni_eng, work, "u-")["tokens"]
    del uni_eng
    ok, refused = True, []
    for name in DISAGG_MUTANTS:
        restore = (lambda: None) if DISAGG_MUTANTS[name] is None else \
            host_variant(name, DISAGG_MUTANTS)
        try:
            try:
                bad = cs.disagg_inprocess(torch, np, model, work,
                                          uni=uni)["failures"]
            except Exception as e:  # noqa: BLE001 - a crash refuses too
                bad = [f"the disaggregated run raised {e!r}"]
        finally:
            restore()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        if name == "as is":
            ok &= not bad
        elif bad:
            refused.append(f"disaggregated serving: {name}")
        else:
            ok = False
        print(f"disagg {name}: "
              f"{'; '.join(b[:300] for b in bad) if bad else 'pass'} -> "
              f"{'FAIL' if bad else 'pass'} [{card}]")
    del model
    torch.cuda.empty_cache()
    return ok, refused, len(DISAGG_MUTANTS) - 1


def lowp_mutants(torch, np, dev, args, card, ids):
    """Every low-precision variant through phase 14's gates (the GEMMs at
    LOWP_MUTANT_SHAPES, the fp8 step captured against eager at two layers,
    int4 weight-only generate). Returns (ok, refused, mutants counted)."""
    ok, refused = True, []
    for name in LOWP_MUTANTS:
        restore = (lambda: None) if LOWP_MUTANTS[name] is None else \
            host_variant(name, LOWP_MUTANTS)
        bad = []
        try:
            for label, check in (
                    ("14(a)", lambda: cs.fp8_gemm_failures(
                        torch, dev, torch.Generator(device=dev).manual_seed(
                            args.seed + 14), card, LOWP_MUTANT_SHAPES,
                        show=False)),
                    ("14(b)", lambda: cs.fp8_capture_failures(
                        torch, dev, args.seed, ids, ids)[0]),
                    ("14(c)", lambda: [f"{n} KV writes differ from the "
                                       f"CPU's"] if (n := cs.trash_write_check(
                                           torch, dev)) else []),
                    ("14(d)", lambda: cs.lowp_generate_failures(
                        torch, np, dev, args, card, kinds=("int4",)))):
                try:
                    bad += [f"{label} {b}" for b in check()]
                except Exception as e:  # noqa: BLE001 - a crash refuses too
                    bad.append(f"{label} raised {e!r}")
        finally:
            restore()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        if name == "as is":
            ok &= not bad
        elif bad:
            refused.append(f"low-precision GEMMs: {name}")
        else:
            ok = False
        print(f"lowp {name}: {len(bad)} failures "
              f"{'; '.join(b[:200] for b in bad[:3]) if bad else 'pass'} -> "
              f"{'FAIL' if bad else 'pass'} [{card}]")
    return ok, refused, len(LOWP_MUTANTS) - 1


def control_mutants(torch, np, dev, args, card):
    """Every control-plane variant through phase 15's gates
    (``chip_smoke.autoscale_phase`` at full width, over a shortened trace).
    Returns (ok, refused, mutants counted)."""
    import io

    trace = dict(cs.autoscale_trace_kwargs(args.seed), **CONTROL_TRACE)
    ok, refused = True, []
    for name in CONTROL_MUTANTS:
        restore = (lambda: None) if CONTROL_MUTANTS[name] is None else \
            host_variant(name, CONTROL_MUTANTS)
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                cs.autoscale_phase(torch, np, dev, args, card,
                                   trace_kw=trace, capacity=False)
            bad = None
        except SystemExit as e:  # chip_smoke.fail: a gate refused it
            bad = str(e)
        except Exception as e:  # noqa: BLE001 - a crash refuses too
            bad = f"phase 15 raised {e!r}"
        finally:
            restore()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        if name == "as is":
            ok &= bad is None
        elif bad:
            refused.append(f"control plane: {name}")
        else:
            ok = False
        print(f"control {name}: {bad[:400] if bad else 'pass'} -> "
              f"{'FAIL' if bad else 'pass'} [{card}]")
    return ok, refused, len(CONTROL_MUTANTS) - 1


def p17_mutants(torch, np, args, card):
    """Every phase-17 variant through the parts of 17(b)-(c) that must
    refuse it, in two launched ranks (no loss gate: it needs 17(a)'s
    twin). Returns (ok, refused, mutants counted)."""
    import tempfile as _tempfile

    ok, refused = True, []
    for name in P17_MUTANTS:
        tmp = Path(_tempfile.mkdtemp(prefix="gate_mutants_p17_"))
        try:
            bad = cs.dp_ranks(torch, np, args, card, None, tmp,
                              script=Path(__file__).resolve(),
                              extra=("--mutant", name),
                              parts=P17_PARTS[name])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if name == "as is":
            ok &= not bad
        elif bad:
            refused.append(f"phase 17: {name}")
        else:
            ok = False
        print(f"p17 {name}: {'; '.join(b[:300] for b in bad) if bad else 'pass'}"
              f" -> {'FAIL' if bad else 'pass'} [{card}]")
    return ok, refused, len(P17_MUTANTS) - 1


def p18_mutants(torch, np, dev, args, card):
    """Every phase-18 variant through the launch whose gates must refuse it
    (``chip_smoke.tp_ranks`` or ``hybrid_ranks``, against this process's
    serial runs); the original through both. Returns (ok, refused,
    mutants counted)."""
    import tempfile as _tempfile

    tmp = Path(_tempfile.mkdtemp(prefix="gate_mutants_p18_"))
    ok, refused = True, []
    try:
        serial_a, _ = cs.tp_serial(torch, np, dev, args,
                                   cs.LLAMA_542M["num_hidden_layers"], 1,
                                   True, None, tmp / "serial_a.pt",
                                   save_grads=True)
        serial_c, norms_c = cs.tp_serial(
            torch, np, dev, args, cs.HYBRID_DEPTH, cs.HYBRID_STEPS, False,
            cs.TP_CLIP_NORM, tmp / "serial_c.pt")
        for name, run in P18_RUNS.items():
            extra = ("--mutant", name)
            script = Path(__file__).resolve()
            bad = []
            for kind in ((("tp", "ab", 1), ("hybrid",)) if run is None
                         else (run,)):
                sub = Path(_tempfile.mkdtemp(dir=tmp))
                for f in ("serial_a.pt", "serial_a_grads.pt", "serial_c.pt"):
                    (sub / f).symlink_to(tmp / f)
                if kind[0] == "tp":
                    bad += cs.tp_ranks(torch, np, args, card, serial_a[:1],
                                       sub, script=script,
                                       extra=(*extra, "--steps", "1"),
                                       parts=kind[1])
                else:
                    bad += cs.hybrid_ranks(torch, np, args, card, serial_c,
                                           norms_c, sub, script=script,
                                           extra=extra)
            if name == "as is":
                ok &= not bad
            elif bad:
                refused.append(f"phase 18: {name}")
            else:
                ok = False
            print(f"p18 {name}: "
                  f"{'; '.join(b[:300] for b in bad) if bad else 'pass'} -> "
                  f"{'FAIL' if bad else 'pass'} [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ok, refused, len(P18_MUTANTS) - 1


def p19_mutants(torch, np, dev, args, card):
    """Every phase-19 variant through the launch whose gates must refuse it
    (``chip_smoke.pp_ranks`` or ``ppdp_ranks``, against this process's
    serial runs); the original through both. Returns (ok, refused, mutants
    counted)."""
    import tempfile as _tempfile

    tmp = Path(_tempfile.mkdtemp(prefix="gate_mutants_p19_"))
    ok, refused = True, []
    try:
        serial_a, _ = cs.tp_serial(torch, np, dev, args,
                                   cs.LLAMA_542M["num_hidden_layers"], 1,
                                   True, None, tmp / "serial_a.pt",
                                   save_grads=True)
        serial_d, norms_d = cs.tp_serial(
            torch, np, dev, args, cs.PP_DP_DEPTH, cs.PP_DP_STEPS, False,
            cs.TP_CLIP_NORM, tmp / "serial_d.pt")
        for name, run in P19_RUNS.items():
            extra = ("--mutant", name)
            script = Path(__file__).resolve()
            bad = []
            for kind in ((("pp", "abc", 1), ("ppdp",)) if run is None
                         else (run,)):
                sub = Path(_tempfile.mkdtemp(dir=tmp))
                for f in ("serial_a.pt", "serial_a_grads.pt", "serial_d.pt"):
                    (sub / f).symlink_to(tmp / f)
                if kind[0] == "pp":
                    bad += cs.pp_ranks(torch, np, args, card, serial_a, sub,
                                       script=script,
                                       extra=(*extra, "--steps", "1"),
                                       parts=kind[1])
                else:
                    bad += cs.ppdp_ranks(torch, np, args, card, serial_d,
                                         norms_d, sub, script=script,
                                         extra=extra)
            if name == "as is":
                ok &= not bad
            elif bad:
                refused.append(f"phase 19: {name}")
            else:
                ok = False
            print(f"p19 {name}: "
                  f"{'; '.join(b[:300] for b in bad) if bad else 'pass'} -> "
                  f"{'FAIL' if bad else 'pass'} [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ok, refused, len(P19_MUTANTS) - 1


def p20_mutants(torch, np, dev, args, card):
    """Every phase-20 variant through the part of phase 20 whose gates
    must refuse it (``P20_RUNS``); the original through all three. Returns
    (ok, refused, mutants counted)."""
    import gc
    import io
    import tempfile as _tempfile

    tmp = Path(_tempfile.mkdtemp(prefix="gate_mutants_p20_"))
    ok, refused = True, []
    try:
        for name, run in P20_RUNS.items():
            bad = []
            for kind in ((("a", ("eager", "captured")), ("b",), ("c",))
                         if run is None else (run,)):
                sub = Path(_tempfile.mkdtemp(dir=tmp))
                restore = (lambda: None)
                if kind[0] != "c" and P20_MUTANTS[name] is not None:
                    restore = host_variant(name, P20_MUTANTS)
                out = io.StringIO()
                try:
                    with contextlib.redirect_stdout(out):
                        if kind[0] == "a":
                            bad += cs.p20_rollback_runs(
                                torch, np, dev, args, card, sub,
                                modes=kind[1], extras=False)[0]
                        elif kind[0] == "b":
                            bad += cs.p20_corrupt_peer(torch, np, dev, args,
                                                       card, sub)
                        else:
                            bad += cs.p20_shard_ranks(
                                torch, np, args, card, sub,
                                script=Path(__file__).resolve(),
                                extra=("--mutant", name))
                except SystemExit as e:  # chip_smoke.fail: a gate refused it
                    bad.append(str(e))
                except Exception as e:  # noqa: BLE001 - a crash refuses too
                    bad.append(f"{kind[0]} raised {e!r}")
                finally:
                    restore()
                    gc.collect()
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
            if name == "as is":
                ok &= not bad
            elif bad:
                refused.append(f"phase 20: {name}")
            else:
                ok = False
            print(f"p20 {name}: "
                  f"{'; '.join(b[:300] for b in bad) if bad else 'pass'} -> "
                  f"{'FAIL' if bad else 'pass'} [{card}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ok, refused, len(P20_MUTANTS) - 1


def p21_mutants(torch, np, dev, args, card, kernels, gen):
    """Phase 21's mutants: the flash backward's through phase 2's BWD_*
    gates at every shape of ``chip_smoke.P21_ATTN`` (a mutant must change
    the result somewhere and be refused wherever it does), each layer
    mutant through ``chip_smoke.p21_semantics``. Returns (ok, refused,
    mutants counted)."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_bwd

    tmp = Path(tempfile.mkdtemp(prefix="gate_mutants_p21_"))
    try:
        libs = build_variants(kernels, tmp, P21_KERNEL_MUTANTS)
        cases = []
        for label, shape, causal in cs.P21_ATTN:
            q, k, v, out, lse, do = cs.flash_bwd_inputs(
                torch, dev, gen, causal, shape["H"], shape=shape)
            cases.append(((causal, label), (q, k, v, out, lse, do, causal),
                          cs.bwd_references(q, k, v, out, lse, do, causal)))
        ok, refused, n = flash_mutants(
            torch, kernels, libs, "flash_attention_bwd", cases,
            flash_attention_bwd, lambda got, refs: cs.bwd_gate(got, *refs),
            f"atol {cs.BWD_ATOL} + rtol {cs.BWD_RTOL}, rel {cs.BWD_REL}",
            card, P21_KERNEL_MUTANTS)
        del cases
        torch.cuda.empty_cache()
    finally:
        kernels._libs.pop("flash_attention_bwd", None)
        shutil.rmtree(tmp, ignore_errors=True)
    for name in P21_MUTANTS:
        restore = (lambda: None) if P21_MUTANTS[name] is None else \
            host_variant(name, P21_MUTANTS)
        try:
            bad = cs.p21_semantics(torch, np, dev, card)
        except Exception as e:  # noqa: BLE001 - a crash refuses too
            bad = [f"raised {e!r}"]
        finally:
            restore()
        if name == "as is":
            ok &= not bad
        elif bad:
            refused.append(f"phase 21: {name}")
        else:
            ok = False
        print(f"p21 {name}: {'; '.join(b[:300] for b in bad) if bad else 'pass'}"
              f" -> {'FAIL' if bad else 'pass'} [{card}]", flush=True)
    return ok, refused, n + len(P21_MUTANTS) - 1


def p22_mutants(torch, np, dev, args, card):
    """Phase 22's mutants: each through the part whose gates must refuse it
    (``chip_smoke.p22_recipe``, ``p22_pools`` under cuDNN's deterministic
    algorithms, or 18(e) in ``chip_smoke.tp_ranks``' two ranks with the
    variant patched in); the original through all three and 22(d). Returns
    (ok, refused, mutants counted)."""
    import tempfile as _tempfile

    parts = {
        "recipe": lambda: cs.p22_recipe(torch, np, dev, args, card),
        "pools": lambda: cs.p22_pools(torch, np, dev, args, card),
        "detection": lambda: cs.p22_detection(torch, np, dev, args, card),
    }
    ok, refused = True, []
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in P22_MUTANTS:
            run = P22_PARTS.get(name, ("recipe", "pools", "detection",
                                       "ranks"))
            restore = (lambda: None) if P22_MUTANTS[name] is None or \
                run == ("ranks",) else host_variant(name, P22_MUTANTS)
            bad = []
            try:
                for part in run:
                    try:
                        if part == "ranks":
                            tmp = Path(_tempfile.mkdtemp(prefix="gm_p22_"))
                            try:
                                bad += cs.tp_ranks(
                                    torch, np, args, card, None, tmp,
                                    script=Path(__file__).resolve(),
                                    extra=("--mutant", name), parts="e")
                            finally:
                                shutil.rmtree(tmp, ignore_errors=True)
                        else:
                            bad += parts[part]()
                    except Exception as e:  # noqa: BLE001 - a crash refuses
                        bad.append(f"{part} raised {e!r}")
            finally:
                restore()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            if name == "as is":
                ok &= not bad
            elif bad:
                refused.append(f"phase 22: {name}")
            else:
                ok = False
            print(f"p22 {name}: "
                  f"{'; '.join(b[:300] for b in bad) if bad else 'pass'} -> "
                  f"{'FAIL' if bad else 'pass'} [{card}]", flush=True)
    finally:
        torch.backends.cudnn.deterministic = was
    return ok, refused, len(P22_MUTANTS) - 1


def deploy_mutants(torch, np, dev, args, card, ids):
    """Every phase-16 variant through the part of phase 16 whose gates must
    refuse it (``chip_smoke.deploy_serving``, ``control_flow_phase``,
    ``debugging_phase`` at full width); the original through all three.
    Returns (ok, refused, mutants counted)."""
    import io

    parts = {
        "16(a)": lambda: cs.deploy_serving(torch, np, dev, args, card, ids),
        "16(b)": lambda: cs.control_flow_phase(torch, np, dev, args, card,
                                               ids, ids),
        "16(c)": lambda: cs.debugging_phase(torch, np, dev, args, card,
                                            ids, ids),
    }
    ok, refused = True, []
    for name in DEPLOY_MUTANTS:
        restore = (lambda: None) if DEPLOY_MUTANTS[name] is None else \
            host_variant(name, DEPLOY_MUTANTS)
        bad = []
        try:
            for part in DEPLOY_PARTS.get(name, tuple(parts)):
                out = io.StringIO()
                try:
                    with contextlib.redirect_stdout(out):
                        parts[part]()
                except SystemExit as e:  # chip_smoke.fail: a gate refused it
                    bad.append(f"{part}: {e}")
                except Exception as e:  # noqa: BLE001 - a crash refuses too
                    bad.append(f"{part} raised {e!r}")
        finally:
            restore()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        if name == "as is":
            ok &= not bad
        elif bad:
            refused.append(f"phase 16: {name}")
        else:
            ok = False
        print(f"deploy {name}: {'; '.join(b[:300] for b in bad) if bad else 'pass'}"
              f" -> {'FAIL' if bad else 'pass'} [{card}]")
    return ok, refused, len(DEPLOY_MUTANTS) - 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of a phase-17 mutant's launch (chip_smoke.dp_ranks)
    ap.add_argument("--rank17", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parts", default="bc", help=argparse.SUPPRESS)
    ap.add_argument("--mutant", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--steps", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--phase18", action="store_true",
                    help="only phase 18's tensor-parallel mutants")
    ap.add_argument("--phase19", action="store_true",
                    help="only phase 19's pipeline, ring and MoE mutants")
    ap.add_argument("--phase20", action="store_true",
                    help="only phase 20's fault-tolerant training mutants")
    ap.add_argument("--phase21", action="store_true",
                    help="only phase 21's attention and layer mutants")
    ap.add_argument("--phase22", action="store_true",
                    help="only phase 22's vision and 18(e)'s qkv mutants")
    args = ap.parse_args()

    import torch

    if args.rank17:
        table = next(t for t in (P22_MUTANTS, P20_MUTANTS, P19_MUTANTS,
                                 P18_MUTANTS, P17_MUTANTS)
                     if args.mutant in t)
        if table[args.mutant] is not None:
            host_variant(args.mutant, table)
        return cs.phase17_rank(args.rank17, args.out, args.seed, args.parts,
                               args.steps or None)

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
    import numpy as np

    if args.phase21:
        kernels.build()
        ok, refused, n = p21_mutants(torch, np, dev, args, card, kernels, gen)
        print(card)
        print(f"gate_mutants --phase21: {'ok' if ok else 'FAIL'}; refused "
              f"{len(refused)} of {n} mutants: {'; '.join(refused)}")
        return 0 if ok else 1
    for flag, run in (("phase18", p18_mutants), ("phase19", p19_mutants),
                      ("phase20", p20_mutants), ("phase22", p22_mutants)):
        if getattr(args, flag):
            kernels.build()  # the ranks use the parent's build
            ok, refused, n = run(torch, np, dev, args, card)
            print(card)
            print(f"gate_mutants --{flag}: {'ok' if ok else 'FAIL'}; refused "
                  f"{len(refused)} of {n} mutants: {'; '.join(refused)}")
            return 0 if ok else 1
    tmp = Path(tempfile.mkdtemp(prefix="gate_mutants_"))
    results = []
    try:
        libs = build_variants(kernels, tmp)
        # first, while this process holds next to nothing on the card: the
        # two ranks it launches each hold a full-width model
        results.append(p17_mutants(torch, np, args, card))
        results.append(p18_mutants(torch, np, dev, args, card))
        results.append(p19_mutants(torch, np, dev, args, card))
        results.append(p20_mutants(torch, np, dev, args, card))
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
        results.append(lowp_mutants(torch, np, dev, args, card, ids))
        results.append(deploy_mutants(torch, np, dev, args, card, ids))
        del ids
        torch.cuda.empty_cache()
        results.append(host_mutants(torch, np, dev, args, card))
        results.append(disagg_mutants(torch, np, dev, args, card))
        results.append(control_mutants(torch, np, dev, args, card))
        results.append(p21_mutants(torch, np, dev, args, card, kernels, gen))
        results.append(p22_mutants(torch, np, dev, args, card))
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
