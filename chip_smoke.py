#!/usr/bin/env python3
"""Smoke run of foldcomp_tpu_torch's `decompress --fast` and
`compress --fast` on one CUDA card.

    python3 chip_smoke.py          (from the repository root)

Phases, one JSON line each; a failing phase raises and the exit code is
non-zero:

1. setup: the card, the toolchain, and the build of the CUDA kernels
   (kernels/csrc/fused_decode.cu and fused_encode.cu, one nvcc each, then
   one link) from this checkout into the port's user cache
   (<backend.cache_dir()>/kernels/; the path printed whole), with each
   kernel's ptxas report and the
   float instructions of one step of k1's loop from its SASS (the count
   of a sincosf in every decode kernel's bound);
2. kernels: k1, k2 and k3 against their plain PyTorch versions on the
   card, on the same inputs: a mixed batch of 512 entries (refine_iters 1
   and 2), a corpus with segments wider than 96 residues, and one packed
   without the 8-row bucket, so that SEG is not a multiple of 4; then the
   mixed batch with lane 0 a continuation, so that k2's seed roll wraps;
   offsets within 1 i16 unit (1 mA), f32 coordinates within 1e-3 A on
   the rows each lane owns (k3 on the rows k2 staged on the card, 0 units
   and 0.0 A); then the
   whole device decode against the plain versions on every visible card
   (card 0 alone on a one-card machine), since each card holds its own
   copy of the kernels' constant tables;
3. parity: the port's decode against the exact host decoder, per protein
   no farther than the JAX reference (tests/data/torch_port_ref_dev.json)
   + 1e-3 A, or the 5 mA / RMSD gates where FOLDCOMP_REF_TEST has
   test.pdb; and its encode, by each wire route, byte-identical to the
   exact encoder (foldcomp_tpu_torch/verify.py);
4. device: decode of B=8192 entries of bench.py's 8 synthetic lengths
   (~4.1M residues) through the kernels and through the plain versions,
   timed with CUDA events, the kernels' output byte-identical to the
   plain versions' on every real row, with each kernel's time beside its
   plain version's; k1 and k2 also with the lanes in pack order
   (`pack_order_ms`), the lane order's own time (`k2.order_ms`), k0 (the
   kernels' inputs and the lane order in one launch, `prep`): its outputs
   against its plain version's (class_prep and lane_order) bit for bit,
   every field and the order, its device time (each run queued before
   the first runs, `queued_ms`) against its bound, and its time a call as
   the host issues it beside its plain version's (torch's operations,
   which synchronize); and the glue (`glue_ms`: the device decode less
   the three kernels, k0 included);
5. e2e: `python -m foldcomp_tpu_torch decompress --fast <db> <out> --db`
   on a 4096-entry FCZ database in a subprocess (FOLDCOMP_TPU_WCLASS=auto,
   the default), timed; 64 sampled outputs held to the phase-3 bound (the
   corpus and the database from foldcomp_tpu_torch/bench.py's builders,
   which the bench's e2e databases share);
6. main path: the same CLI entry point in this process with the kernel
   launch counters reset just before and read just after, and the decode
   calls counted: a batch must have taken width classes exactly where
   the auto rule splits one of the batches the stream forms
   (bench_routing.lane_batches replays them; at cli.FAST_BATCH none of
   this corpus's), k0 and k1 must have launched once a batch, and k2 and
   k3 each once a single-class batch and once a class of each classed
   batch;
7. encode_kernels: the fused encode kernel (k4 with the epilogue) against
   its plain version, parity_tail(merged_plain(...)), on the same inputs:
   a mixed 256-entry batch of the 8 lengths by the compact wire and by the
   f32 loader, a batch longer than 1536 residues, degenerate frames, and
   proteins of 6,200 residues by each loader. Its five outputs bit-equal
   on every slot. Then the kernel's acos against torch.arccos on every
   float32 in [-1, 1]: 0 mismatches;
8. encode_parity: the port's batched encode against the exact encoder,
   FCZ bytes identical for every entry of a fuzz corpus (8 lengths x 3
   seeds, n_res < 4, degenerate and off-grid frames), with the share of
   values flagged for host rescue;
9. encode_device: one CLI batch, B=2048 entries of the 8 lengths packed
   by the native wire: pack and H2D seconds; the fused kernel against its
   plain version and the whole device encode, by CUDA events; the device
   encode's kernels by torch.profiler; the CLI's host stages;
10. e2e_compress: `python -m foldcomp_tpu_torch compress --fast <dir>
   <db> --db` on 4096 PDB files in a subprocess, timed; every entry
   byte-identical by name to the port's exact route's (`python -m
   foldcomp_tpu_torch compress <dir> <db> --db`, which the CPU tests hold
   byte-identical to `python -m foldcomp_tpu compress`); then the same
   entry point in this process
   with the launch counters reset just before and read just after: k4
   must have launched;
11. bb_wire, the backbone-only decode wire (`FOLDCOMP_TPU_WIRE=bb`; its
   kernel and device parts run after phase 4, its CLI parts after phase 6):
   the bb call, one kernel (k2_backbone_bb, `fused_decode.backbone_only`),
   against its plain version on phase 2's corpora at refine_iters 1 and 2
   and at B=8192, bit-equal (0 i16 units, 0.0 A CA) on the rows each lane
   owns; at B=8192 k0's bb mode against its full mode (tat, mins6, cont6
   and the order bit for bit, no code plane; each mode's device time),
   and the bb pack as arrays_to_torch holds it (no side-chain codes)
   decoded bit-equal to the same dict with them held, three dispatches
   launching k0 in bb mode three times and no k3; the bb call and the
   whole bb device decode timed with CUDA events beside the full wire's,
   the call against its bound; the D2H bytes and seconds of one B=8192
   batch on each wire; the link probe's MB/s and the wire it chooses;
   then `decompress --fast` on phase 5's database with
   FOLDCOMP_TPU_WIRE=bb in a subprocess, 64 sampled outputs held to phase
   5's bound, and the same entry point in this process with the launch
   counters around it: k1 and k2_bb must have launched, k2 and k3 not,
   and every k0 launch in bb mode;
12. db_jobs, the database jobs through the hybrid CPU + GPU scheduler
   (after phase 11's CLI parts, with -t T, T = min(8, CPU count), on a
   database of cli.FAST_DEFAULT_MIN + 1 entries, phase 5's draw extended,
   the least a no-flag db job routes to the scheduler): `warmup` in a
   subprocess with HOME in a scratch
   directory (its estimate only in .cache/foldcomp_tpu_torch/, beside the
   kernel library this process built, linked in by build.seed_cache, as
   phases 15 and 16 link it into their children's caches); then
   `decompress <db> <out> --db` with no flag in a subprocess twice, the
   guard as shipped (reading the warmup's estimate) and with
   FOLDCOMP_TPU_WARMUP_EST=0 (eager claims), beside `--exact -t T`: every
   entry under its key and name, byte-identical to the exact route or
   within phase 5's bound; then `compress` the same two ways on the exact
   route's PDB database, every entry byte-identical by name to `--exact
   -t T`; each run's device share from the scheduler's closing [Info]
   line; then each mode through `cli.main` in this process with
   FOLDCOMP_TPU_WARMUP_EST=0, -t 1 and 512-entry batches, and the launch
   counters around it: decompress must launch k1, k2 and k3 (or k2_bb),
   compress k4;
13. multi_device, the multi-device layers on torch.distributed
   (foldcomp_tpu_torch/dryrun.py dryrun_multichip, one spawned process a
   rank): a one-rank run under NCCL on card 0 beside an n-rank run, NCCL
   with one rank a card where the machine has two or more, else two ranks
   on card 0 under gloo, whose collectives stage through host memory (the
   line names the backend). In each: the data-parallel roundtrip step on
   a batch of bench.py's 8 lengths, 2048 entries a rank, with k1, k2, k3
   and k4 launched on every rank, records byte-identical and decoded
   atoms bit-identical to the one-rank run row for row, the global RMSD
   beside phase 3's per-protein gate; sharded_backbone_features and
   sharded_encode_features on a 34,350-residue chain (titin's length),
   and encode_long_chain on its first 6,200 residues, bit-identical to
   the one-rank run; then measure_scaling's rows, one world size per
   count of cards, of 2048 entries a rank;
14. wclass, width-classed lanes (split_lanes_classes and decode_lanes
   of several classes; its kernel and device parts run after phase
   11's, its CLI part after phase 5): the classed decode's kernels (k1
   over every class in one launch into the shared tails, k2 seeded
   through prev_idx, k3 into the flat buffer) against
   decode_seg_fused_classes_plain on phase 2's corpora
   split with the savings gate off and on phase 4's B=8192 batch split by
   the auto rule, bit-equal on the rows each lane owns; at B=8192 the
   classed decode against the single-class one, gathered per protein,
   bit-equal on every row; each form's slots, output and D2H bytes, D2H
   seconds, device decode time and peak device memory; k1 over the
   classes in one launch beside the same kernel launched once a class;
   k0 over the classes in one launch against class_prep and lane_order a
   class, every field and the order bit for bit; each class's k1, k2 and
   k3 and the glue; the launches of a batch (k0, k1 and k2 once,
   k3 once a class, every k3 on k2's staged rows); then phase 5's
   `decompress --fast` again with FOLDCOMP_TPU_WCLASS=1, 0 and 1 (after
   phase 5's auto run: the classed route through the CLI, which auto does
   not take at cli.FAST_BATCH), every output byte-identical to phase 5's;
15. bench, the port's bench and its single-device entry:
   `python3 -m foldcomp_tpu_torch.bench --quick` in a subprocess, its one
   line parsed, every key of bench.KEYS present, the parity check passed
   and no gate failed (the paired hybrid gate is not computed at the quick
   size); then dryrun.entry() on the card, bit-equal on the rows each lane
   owns to the same entry through the plain versions on the card, and
   within 1 i16 unit and 1e-3 A of them on the CPU (torch's CPU and CUDA
   sin and cos differ by ulps, so the two devices are not bit-equal);
16. routing, the routing constants on this card (cli.FAST_DEFAULT_MIN,
   FAST_BATCH and fast_batch_size's steps, batch_host._WCLASS_MIN_LANES
   and _WCLASS_MIN_SAVE, hybrid.COLD_HORIZON_S; `python3 -m
   foldcomp_tpu_torch.bench --routing` measures them): with no
   FOLDCOMP_TPU_* setting, fast_batch_size() under the link probe's real
   answer is the step for its rate; a no-flag `decompress <dir> <out>
   --db` of FAST_DEFAULT_MIN + 1 .fcz files in a subprocess takes the
   device route on an ok link (its [Info] line; k1, and k2 and k3 or
   k2_bb, launched in its process), 64 sampled outputs held to phase 5's
   bound;
   pack_decode_wire on one batch of FAST_BATCH entries takes width
   classes only where the auto rule's lane count and savings say; and
   EndgameGuard.cold_horizon() in a fresh process with no warmup file is
   COLD_HORIZON_S;
17. cache, the port's user cache (after phase 12, on phase 5's database):
   a copy of foldcomp_tpu_torch/ and native/ in a scratch directory, its
   libfcio.so pre-built there (the JAX package's rule), every step a
   fresh process importing that copy with HOME and
   FOLDCOMP_TPU_TORCH_CACHE in scratch directories: `decompress --fast`
   on an empty cache (rc 0, k1, k2 and k3 launched, phase 5's hold, the
   library in <cache>/kernels/) and again warm (no build, the same bytes);
   four `warmup` commands at once on another empty cache, nvcc wrapped to
   count its runs (one build: one nvcc a source and one link); that
   library overwritten with 4 KiB of garbage (one rebuild, the same
   bytes), then nvcc a stub that fails and garbage at its library's name
   (exit 1, KernelBuildError, no output); FOLDCOMP_TPU_TORCH_CACHE=0 (a
   temporary library, gone with the process, nothing kept under HOME);
   the copy's package tree (names, sizes, mtimes) unchanged by every
   step;
18. prep, k0 (after phase 2): tests/test_torch_prep.py's card tests in a
   subprocess (pytest, the suite's conftest skipped: it imports JAX): k0
   against class_prep + lane_order bit for bit (ties in tat, a one-lane
   and an empty class, SEG over several sort passes, unaligned records),
   the decode's dispatch bit-equal on the rows each lane owns to the same
   dispatch through torch's glue on the classed, single, bb and wide
   packs, no synchronize in it under torch.cuda.set_sync_debug_mode
   ("error") (and the glue's raising there), one prep launch a dispatch.

Then the kernel summary (each kernel's launches on the main path, its
largest difference from its plain version, its time and its plain
version's (k0's plain version synchronizes, so its time is the host's
pace a call, phase 4's `plain_paced_by`), and its bound: the larger of
the bytes it must move over the card's memory rate and its float
operations over the float32 rate without FMA, from this run's inputs),
the card's `nvidia-smi` name and power limit, and as the last line
{"ok": true, "device": {...}}. Exits non-zero without a CUDA
device or outside a checkout of the repository.

    python3 chip_smoke.py --quick       phases 1-4, 18 and the kernel
                                        checks and device timings of
                                        phases 11 and 14, no last line
    python3 chip_smoke.py --encode      phases 1, 7 and 9, no last line
    python3 chip_smoke.py --db-jobs     phases 1, 5 and 12, no last line
    python3 chip_smoke.py --multi-device
                                        phases 1 and 13, no last line
    python3 chip_smoke.py --bench       phases 1 and 15, no last line
    python3 chip_smoke.py --routing     phases 1 and 16, no last line
    python3 chip_smoke.py --cache       phases 1, 5 and 17, no last line
    python3 chip_smoke.py --ptxas F.cu  also the ptxas report of another
                                        source (an older k3, say) in phase 1
"""
import contextlib
import io
import json
import os
import pathlib
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
BENCH_LENGTHS = (120, 200, 280, 360, 480, 640, 840, 1080)
TOL_A = 1e-3
TOL_I16 = 1
_DEC = "foldcomp_tpu_torch/kernels/csrc/fused_decode.cu"
SOURCES = {"prep": _DEC, "k1": _DEC, "k2": _DEC, "k2_bb": _DEC, "k3": _DEC,
           "k4": "foldcomp_tpu_torch/kernels/csrc/fused_encode.cu"}
# k0 does _class_prep's work and the port's lane order (torch.argsort in
# lane_order: the TPU kernels walk the lanes in pack order)
REPLACES = {"prep": "foldcomp_tpu/kernels/pallas_decode.py:405-437 + "
                    "lane_order's argsort",
            "k1": "foldcomp_tpu/kernels/pallas_decode.py:186",
            "k2": "foldcomp_tpu/kernels/pallas_decode.py:227",
            "k2_bb": "foldcomp_tpu/kernels/pallas_decode.py:529",
            "k3": "foldcomp_tpu/kernels/pallas_decode.py:338",
            "k4": "foldcomp_tpu/kernels/pallas_encode.py:147 + :370-432"}
NAMES = {"prep": "k0_prep", "k1": "k1_tails", "k2": "k2_backbone",
         "k2_bb": "k2_backbone_bb",
         "k3": "k3_sidechain", "k4": "k4_fused_encode"}
# the bb wire's offsets: 0.1 mA units
BB_UNIT_A = 1e-4
# one H100 SXM's published peaks (NVIDIA's data sheet, at a 700 W limit):
# HBM bytes/s, and float32 instructions/s outside the tensor cores. The
# sheet's 67 T float32 operations/s count an FMA as two. Every kernel here
# is built with -fmad=false (kernels/build.py), so the compiler contracts
# none of their arithmetic into FMA (library code such as sincosf keeps its
# own fmaf): an operation is one float instruction, at 33.5 T a second
# (132 SMs x 128 lanes x 1.98 GHz), not 67 T.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 33.5e12
# What each decode kernel must do, counted from this run's inputs: inputs
# read once, outputs written once, real lanes and residues only. A lane of
# seg_m residues takes seg_m - 1 forward steps (k1, k2) and as many reverse
# ones (k2); per residue, per step and per lane, (bytes, float operations):
#  - a step reads its residue's 8 B record (the last residue's is never
#    read; the N-CA length comes from the record's residue code) and costs
#    3 NeRF placements of 69 (62 in place_frame, 5 to scale the offsets, 2
#    angles to radians) with 2 sincosf each, and 6 dequantized fields of 2;
#    k2's reverse step 3 more placements of 68 (62, 5, the torsion to
#    radians) with 1 sincosf each (the bond angle comes from
#    bond_angle_cs), 3 bond angles of 31 and 3 torsions of 2 (an rsqrtf,
#    sqrtf or division counts as one);
#  - a sincosf counts as the float instructions of its compiled fast path
#    (|x| small enough for the three-part reduction, no Payne-Hanek), not
#    as one: SINCOS_OPS, read from the SASS of one step of k1's loop in
#    this run's build (k1_step_sass), as that step's float instructions
#    less the 219 of the rest of the step, over 6;
#  - a k1 lane reads its seed fwd9, its next anchor rev9, tat and 12
#    quantizer floats (124 B) and writes a 9-float tail (36 B), blended at
#    4 operations a float;
#  - a k2 lane reads one 36 B seed (lane l-1's tail, or its own fwd9 where
#    it is a protein's first segment), is_first, rev9, tat and the 12
#    floats (125 B); k2 writes and blends 9 floats a residue (36 B, 3 x 12);
#  - k3 reads 9 backbone floats, a code and 11 torsion codes and writes 42
#    int16 and 3 floats a residue (147 B), 11 placements of 66 and 42
#    offsets of 5;
#  - the bb call (k2_backbone_bb, _run_backbone_only's function) does k2's
#    work but writes 6 int16 offsets and 3 floats a residue (24 B), each
#    offset a subtraction, a product, a rounding and a clip of 2.
K1_STEP_OTHER_OPS = 3 * 69 + 6 * 2
SINCOS_OPS = None       # set by main() from k1_step_sass before any bound


def decode_work(k):
    """What decode kernel k must do, {unit: (bytes, operations)}, a
    sincosf at SINCOS_OPS operations."""
    fwd = K1_STEP_OTHER_OPS + 6 * SINCOS_OPS
    rev = 3 * (68 + SINCOS_OPS + 31 + 2)
    return {
        "k1": {"residue": (0, 0), "step": (8, fwd),
               "lane": (124 + 36, 9 * 4)},
        "k2": {"residue": (36, 3 * 12), "step": (8, fwd + rev),
               "lane": (125, 0)},
        "k2_bb": {"residue": (24, 3 * 12 + 6 * 5), "step": (8, fwd + rev),
                  "lane": (125, 0)},
        "k3": {"residue": (36 + 4 + 11 + 84 + 12, 11 * 66 + 42 * 5),
               "step": (0, 0), "lane": (0, 0)},
    }[k]


def work_bound(k, count):
    """(bytes, operations, bound ms, "bytes" or "operations") of decode
    kernel k on `count` {"residue", "step", "lane"} of this run."""
    w = decode_work(k)
    n_bytes, n_ops = (sum(w[u][i] * count[u] for u in w) for i in (0, 1))
    return (n_bytes, n_ops, *bound(n_bytes, n_ops))


# The fused encode kernel (fused_encode.cu k4_fused_encode), float
# operations a real residue, counted from its code (an acosf, rsqrtf,
# sqrtf, floorf, rintf or division counts as one): the correctly rounded
# /1000 of 42 coordinates (21 each; the compact loader only), 3 torsion
# cosines with their bits (131 each: 64 for the cross products and sums,
# 54 for the double-f32 quotient), 3 bond cosines (83), 15 backbone
# differences and 9 negations, the angle and error budget of 3 torsion
# and 3 bond streams (28, 24), 11 side-chain dihedral cosines with their
# quantization (61 + 25), and per stream the two reduction sweeps (8 + 6)
# and the quantization sweep (29). Bytes: each input read once for the
# real residues (the wire, the code, n_res), each output written once for
# every slot of [B, L] (24 B: the padding slots are outputs too).
K4_FLOPS_PER_RES = {"wire": 42 * 21, "cosines": 3 * 131 + 3 * 83 + 24,
                    "tails": 3 * 28 + 3 * 24, "side_chains": 11 * (61 + 25),
                    "sweeps": 6 * (8 + 6 + 29)}
K4_OUT_BYTES_PER_SLOT = 8 + 1 + 2 + 11 + 2
ENC_BATCH = 2048        # the encode batch phases 9 and 13 time
E2E_FILES = 4096


def bound(n_bytes, n_flops):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take to move n_bytes and to do n_flops float32 operations."""
    t_b, t_f = n_bytes / PEAK_BYTES_S * 1e3, n_flops / PEAK_F32_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def ptxas_report(log):
    """{kernel: {registers, stack_frame, spill_stores, spill_loads, smem}}
    (bytes, but registers) from `nvcc -Xptxas -v` output."""
    import re
    out, cur = {}, None
    for line in (log or "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = next((k for k in ("k0_prep", "k1_tails", "k2_backbone_bb",
                                    "k2_backbone",
                                    "k3_sidechain", "k3_tables",
                                    "k4_fused_encode", "k4_acos")
                        if k in m.group(1)), m.group(1))
            if cur == "k4_fused_encode":     # the template's two loaders
                cur += "_f32" if "ILb1E" in m.group(1) else "_wire"
            out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack_frame=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem"] = int(s.group(1)) if s else 0
    return out


# SASS opcodes counted as float instructions: the F* family (FADD, FMUL,
# FFMA, FSETP, FSEL, FMNMX, F2I, ...), MUFU and the int-to-float
# conversions
SASS_FLOAT_OP = r"^(F[A-Z0-9]+|MUFU|I2F|I2FP)$"


def k1_step_sass(lib_path):
    """{"float_instructions", "instructions", "loop"} of one step of
    k1_tails's loop on its fast path, from `cuobjdump -sass` of the built
    library. The loop is the function's backward branch of the widest
    span; the fast path is the path from its head to that branch with the
    fewest instructions (forward edges only), which takes no sincosf slow
    path (the Payne-Hanek reduction of a large argument) and no load a step
    ahead. Predicated instructions on it count."""
    import re
    from foldcomp_tpu_torch.backend import nvcc_path
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    r = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"cuobjdump rc {r.returncode}: {r.stderr}")
    body = next(f for f in re.split(r"\n\s*Function : ", r.stdout)[1:]
                if "k1_tails" in f.split("\n", 1)[0])
    ins = []            # (address, conditional, opcode, branch target)
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", body):
        txt = m.group(2)
        cond = txt.startswith("@")
        if cond:
            txt = txt.split(None, 1)[1]
        op = txt.split()[0].split(".")[0]
        tgt = None
        if op == "BRA":
            tgt = int(re.findall(r"0x([0-9a-f]+)", txt)[-1], 16)
            cond = cond or "P" in txt.split(",")[0]     # BRA !P0, 0x...
        ins.append((int(m.group(1), 16), cond, op, tgt))
    at = {a: i for i, (a, *_) in enumerate(ins)}
    _, end = max((a - t, i) for i, (a, _, op, t) in enumerate(ins)
                 if op == "BRA" and t < a)
    head = at[ins[end][3]]
    isf = [int(bool(re.match(SASS_FLOAT_OP, op))) for _, _, op, _ in ins]
    best = {head: (1, isf[head])}      # (instructions, float ones) to here
    for i in range(head, end):
        if i not in best:
            continue
        _, cond, op, tgt = ins[i]
        nxt = [] if op in ("BRA", "EXIT", "RET") and not cond else [i + 1]
        if op == "BRA" and at[tgt] > i:
            nxt.append(at[tgt])
        for j in nxt:
            if j <= end:
                c = (best[i][0] + 1, best[i][1] + isf[j])
                if j not in best or c < best[j]:
                    best[j] = c
    n, f = best[end]
    return {"float_instructions": f, "instructions": n,
            "loop": [hex(ins[head][0]), hex(ins[end][0])]}


def ptxas_of(src):
    """ptxas_report of one CUDA source compiled with the build's flags."""
    from foldcomp_tpu_torch.backend import nvcc_path
    from foldcomp_tpu_torch.kernels import build
    with tempfile.TemporaryDirectory() as d:
        r = subprocess.run([nvcc_path(), *build.NVCC_FLAGS, "-c", "-o",
                            os.path.join(d, "k.o"), src],
                           capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"nvcc {src}: {r.stdout}{r.stderr}")
    return ptxas_report(r.stdout + r.stderr)


def emit(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def cuda_ms(torch, fn, reps):
    """Mean device time of fn over reps runs after one warm-up, by CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


DECODE_KEYS = ("seg_records", "mins_lane", "cont_lane", "sc_codes_seg",
               "fwd9", "rev9", "is_first", "seg_m")


def plain_decode(ta, nl_out):
    """decode_seg_fused (refine_iters 2) through the plain versions of the
    functions the kernels compute, on a packed tensor dict."""
    from foldcomp_tpu_torch.kernels import fused_decode as FD
    pr = FD.class_prep(*(ta[k] for k in DECODE_KEYS[:6]), ta["seg_m"])
    lane = (pr["rev9"], pr["tat"], pr["mins6"], pr["cont6"])
    t9 = FD.tails_plain(pr["recs"], FD.n_ca_lengths(pr["recs"]),
                        pr["fwd9"], *lane)
    bb = FD.backbone_rolled_plain(pr["recs"], t9, pr["fwd9"],
                                  ta["is_first"], *lane)
    return FD.sidechain_plain(*bb, pr["code"], pr["sct"], nl_out)


def prep_of(fczs, dev, seg_bucket=8):
    """Pack fczs onto dev -> (arrays, metas, tensors, class_prep dict with
    the lane order and the lane tensors k1 and k2 share)."""
    from foldcomp_tpu_torch.codec.batch import arrays_to_torch
    from foldcomp_tpu_torch.codec.batch_host import pack_decode_batch_lanes
    from foldcomp_tpu_torch.kernels import fused_decode as FD
    arrays, metas = pack_decode_batch_lanes(fczs, seg_bucket=seg_bucket)
    ta = arrays_to_torch(arrays, dev)
    pr = FD.class_prep(*(ta[k] for k in DECODE_KEYS[:6]), ta["seg_m"])
    pr["order"] = FD.lane_order(pr["tat"])
    pr["lane"] = (pr["rev9"], pr["tat"], pr["mins6"], pr["cont6"])
    return arrays, metas, ta, pr


def owned_max(got, want, tat):
    """Largest |difference| of two backbone row triples on the rows each
    lane owns (r < tat); the rest is pack padding."""
    import torch
    own = torch.arange(got[0].shape[0], device=tat.device)[:, None] \
        < tat[None, :]
    return max((a - b).abs()[own].max().item() for a, b in zip(got, want))


def per_device_check():
    """decode_seg_fused through the kernels against the plain versions on
    each visible CUDA device, the last device first, after device 0 has
    loaded the library: __constant__ tables are per device, and a device
    that decodes before its tables are set gets zeros. Then the fused
    encode against fused_plain on a small compact batch, by both loaders,
    with the gate of phase 7 (its predecessor table is a per-device
    tensor). -> one dict per device with the maxima; raises past the
    tolerances."""
    import torch

    from foldcomp_tpu_torch import verify
    from foldcomp_tpu_torch.codec.batch import arrays_to_torch
    from foldcomp_tpu_torch.codec.batch_host import (fragment_to_tensors,
                                                     pack_decode_batch_lanes)
    from foldcomp_tpu_torch.kernels import build
    from foldcomp_tpu_torch.kernels import fused_decode as FD
    from foldcomp_tpu_torch.kernels import fused_encode as FE

    uniq = verify.synthetic_corpus(BENCH_LENGTHS[:3])
    enc = [fragment_to_tensors(verify.on_milli_grid(a)) for a in
           verify.synthetic_structures(BENCH_LENGTHS[:3]).values()] * 4
    arrays, _ = pack_decode_batch_lanes(
        [uniq[n] for n in BENCH_LENGTHS[:3] for _ in range(8)])
    nl_out = arrays["nl_out"]
    build.load(0)
    out = []
    for idx in reversed(range(torch.cuda.device_count())):
        dev = torch.device("cuda", idx)
        ta = arrays_to_torch(arrays, dev)
        ko, kc = FD.decode_seg_fused(*(ta[k] for k in DECODE_KEYS),
                                     nl_out=nl_out)
        po, pc = plain_decode(ta, nl_out)
        own = torch.arange(ko.shape[1], device=dev)[None, :] \
            < ta["seg_m"][:nl_out, None]
        d_off = (ko.int() - po.int()).abs()[own].max().item()
        d_ca = (kc - pc).abs()[own].max().item()
        out.append({"device": idx, "name": torch.cuda.get_device_name(idx),
                    "off_units": d_off, "ca_A": d_ca})
        if not (d_off <= TOL_I16 and d_ca <= TOL_A):
            raise AssertionError(f"cuda:{idx} kernels vs plain: off {d_off} "
                                 f"units, ca {d_ca} A")
        # the fused encode and its per-card predecessor table, both loaders
        bt = pack_batch(enc, dev)
        out[-1]["k4_max_abs"] = 0.0
        for loader in ("wire", "atom14"):
            arg = {loader: bt[loader]}
            _, bad, worst = hold_fused(
                f"cuda:{idx} {loader}",
                FE.fused(bt["code"], bt["n_res"], **arg),
                FE.fused_plain(bt["code"], bt["n_res"], **arg))
            if bad:
                raise AssertionError(f"fused encode vs plain: {bad}")
            out[-1]["k4_max_abs"] = max(out[-1]["k4_max_abs"], worst)
    return out


def synthesize(n, seed):
    from foldcomp_tpu_torch.verify import synthesize as synth
    return synth(n, seed)


def degenerate_frames():
    """Frames with a CA duplicated onto the atom before it (a zero-length
    bond: NaN guards, ties, flagged rows), as tests/test_pallas_encode.py
    builds them, at a residue inside the chain, at its first and at its
    last residue."""
    from foldcomp_tpu_torch.verify import on_milli_grid
    out = []
    for n, seed, at in ((30, 5, 10), (60, 6, 0), (45, 7, 44)):
        a = on_milli_grid(synthesize(n, seed))
        ca = [i for i, nm in enumerate(a.atom_name) if nm == "CA"]
        a.coords[ca[at]] = a.coords[ca[at] - 1]
        out.append(a)
    return out


def pack_batch(tensors, dev):
    """What encode_submit hands the fused encode kernel for these fragment
    tensors, on `dev`, in its order (longest first): the native
    plane-major wire (None when the batch is off the compact form) and the
    filled atom14, with the seconds of the pack and of the H2D copies of
    the wire."""
    import numpy as np
    import torch

    from foldcomp_tpu_torch.codec.batch import _pack_encode_wire, longest_first

    live = longest_first([(i, t[:3]) for i, t in enumerate(tensors)])
    b = len(live)
    n_res = np.asarray([t[0].shape[0] for _, t in live], np.int32)
    l = -(-int(n_res.max()) // 32) * 32
    res_code = np.zeros((b, l), np.int32)
    for k, (_, t) in enumerate(live):
        res_code[k, :n_res[k]] = t[1]
    atom14 = np.empty((b, l, 14, 3), np.float32)
    t0 = time.perf_counter()
    wire = _pack_encode_wire(live, atom14)
    pack_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wire_t = tuple(torch.from_numpy(a).to(dev) for a in wire) \
        if isinstance(wire, tuple) else None
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    return dict(wire=wire_t, atom14=torch.from_numpy(atom14).to(dev),
                code=torch.from_numpy(res_code).to(dev),
                n_res=torch.from_numpy(n_res).to(dev), b=b, l=l,
                residues=int(n_res.sum()), pack_seconds=pack_s,
                h2d_seconds=h2d_s)


ENC_KEYS = ("records", "bb_flags", "cand_bits", "sc_q", "sc_flag_bits")
K4_TOL = "bit-equal on every slot: " + ", ".join(ENC_KEYS)


def hold_fused(label, got, want):
    """The fused kernel's outputs against fused_plain's on identical
    inputs: every slot of the five outputs bit-equal. -> ({output:
    differing elements}, failed names, max |difference| as integers)."""
    mism = {k: int((got[k] != want[k]).sum()) for k in ENC_KEYS}
    worst = max(float((got[k].int() - want[k].int()).abs().max())
                for k in ENC_KEYS)
    return mism, [f"{label}: {k}" for k, v in mism.items() if v], worst


def acos_check(dev):
    """The fused kernel's acos (fused_encode.acos, k4_acos) against
    torch.arccos on the card on every float32 in [-1, 1]: the bit patterns
    0..0x3F800000 of each sign, in chunks of 2**27. -> (values, mismatches,
    first mismatching value or None)."""
    import torch

    from foldcomp_tpu_torch.kernels import fused_encode as FE

    top, chunk = 0x3F800000 + 1, 1 << 27
    n = bad = 0
    first = None
    for sign in (0, -(1 << 31)):
        for lo in range(0, top, chunk):
            hi = min(lo + chunk, top)
            x = torch.arange(sign + lo, sign + hi, dtype=torch.int32,
                             device=dev).view(torch.float32)
            d = FE.acos(x).view(torch.int32) \
                != torch.arccos(x).view(torch.int32)
            c = int(d.sum())
            if c and first is None:
                first = float(x[d][0])
            n += hi - lo
            bad += c
            del x, d
    return n, bad, first


def encode_kernels(dev):
    """Phase 7: the fused encode kernel against fused_plain on the card,
    then its acos on every float32 in [-1, 1]. -> max |difference| (0 when
    bit-equal); raises past the gates."""
    import torch

    from foldcomp_tpu_torch.codec.batch_host import fragment_to_tensors
    from foldcomp_tpu_torch.kernels import fused_encode as FE
    from foldcomp_tpu_torch.verify import on_milli_grid

    def tens(frames):
        return [fragment_to_tensors(a) for a in frames]

    uniq = dict(zip(BENCH_LENGTHS, tens(
        [on_milli_grid(synthesize(n, n)) for n in BENCH_LENGTHS])))
    rng = random.Random(3)
    mixed = [uniq[rng.choice(BENCH_LENGTHS)] for _ in range(256)]
    long_ = tens([on_milli_grid(synthesize(n, n)) for n in (1600, 2000)])
    huge = tens([on_milli_grid(synthesize(6200, 62))])
    cases = (("mixed256", mixed, "wire"), ("mixed256_f32", mixed, "atom14"),
             ("long", long_ * 4, "wire"),
             ("degenerate", tens(degenerate_frames()), "wire"),
             ("huge", huge * 3 + mixed[:5], "wire"),
             ("huge_f32", huge * 3 + mixed[:5], "atom14"))
    worst = 0.0
    for label, tensors, loader in cases:
        bt = pack_batch(tensors, dev)
        if bt["wire"] is None:
            raise AssertionError(f"{label}: batch is off the compact form")
        arg = {loader: bt[loader]}
        mism, bad, w = hold_fused(
            label, FE.fused(bt["code"], bt["n_res"], **arg),
            FE.fused_plain(bt["code"], bt["n_res"], **arg))
        torch.cuda.synchronize()
        emit("encode_kernels", case=label, loader=loader, b=bt["b"],
             l=bt["l"], residues=bt["residues"], mismatches=mism,
             max_abs=w, tol=K4_TOL)
        if bad:
            raise AssertionError(f"fused encode vs plain: {bad}")
        worst = max(worst, w)
    t0 = time.perf_counter()
    n, bad, first = acos_check(dev)
    emit("encode_acos", values=n, mismatches=bad, first_mismatch=first,
         seconds=time.perf_counter() - t0,
         against="torch.arccos on the card, bit for bit")
    if bad:
        raise AssertionError(f"acos: {bad} of {n} floats differ from "
                             f"torch.arccos (first {first})")
    return worst


def encode_parity(dev):
    """Phase 8: the port's batched encode on the card against the exact
    encoder over a fuzz corpus; FCZ bytes identical for every entry."""
    import numpy as np

    from foldcomp_tpu_torch.codec.batch import encode_finish, encode_submit
    from foldcomp_tpu_torch.codec.batch_host import fragment_to_tensors
    from foldcomp_tpu_torch.codec.encoder import encode as encode_exact
    from foldcomp_tpu_torch.codec.fcz import serialize
    from foldcomp_tpu_torch.core.aatable import N_SC_TORSION
    from foldcomp_tpu_torch.core.codes import NUM_AA
    from foldcomp_tpu_torch.verify import on_milli_grid

    grid = [on_milli_grid(synthesize(n, 100 * s + n))
            for n in BENCH_LENGTHS for s in range(3)]
    grid += [on_milli_grid(synthesize(n, s)) for n in (2, 3) for s in (0, 1)]
    grid += degenerate_frames()
    off = [synthesize(n, 7 + n) for n in (3, 60, 480, 1080)]
    off.append(degenerate_frames()[0])
    off[-1].coords[0, 0] += np.float32(1e-4)     # one coordinate off grid
    summary = {}
    for label, frames, route in (("grid", grid, "native"),
                                 ("off_grid", off, "f32")):
        tensors = [fragment_to_tensors(a) for a in frames]
        h = encode_submit([t[:3] for t in tensors], [t[3] for t in tensors],
                          device=dev)
        if h["wire"] != route:
            raise AssertionError(f"{label}: route {h['wire']}, "
                                 f"expected {route}")
        parts = {k: v.cpu().numpy() for k, v in h["parts"].items()}
        n_res = h["res_mask"].sum(axis=1)
        rows = np.arange(h["res_mask"].shape[1])[None, :] \
            < (n_res[:, None] - 1)
        bb = np.unpackbits(parts["bb_flags"][rows][:, None], axis=1)
        rc = h["res_code"]
        counts = np.where(rc < NUM_AA,
                          N_SC_TORSION[np.minimum(rc, NUM_AA - 1)], 0)
        emitted = (np.arange(11)[None, None, :] < counts[..., None]) \
            & h["res_mask"][..., None]
        sc = ((parts["sc_flag_bits"][..., None] >> np.arange(11)) & 1) > 0
        got = encode_finish(h)
        bad = [i for i, (a, g) in enumerate(zip(frames, got))
               if g is None or serialize(g) != serialize(encode_exact(a))]
        summary[label] = dict(
            entries=len(frames), route=route, mismatches=bad,
            bb_values=int(rows.sum()) * 6,
            bb_flagged_share=float(bb.sum()) / max(int(rows.sum()) * 6, 1),
            sc_values=int(emitted.sum()),
            sc_flagged_share=float((sc & emitted).sum())
            / max(int(emitted.sum()), 1))
    emit("encode_parity", **summary)
    for label, v in summary.items():
        if v["mismatches"]:
            raise AssertionError(f"encode parity {label}: entries "
                                 f"{v['mismatches']} differ")


def device_kernels(torch, fn):
    """The names of the device kernels one call of fn runs, by
    torch.profiler (CUPTI), or None where the profiler saw no device
    activity at all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return names or None


def encode_device(dev, card):
    """Phase 9: one CLI batch through the fused kernel and its plain
    version, timed with CUDA events in turns and held against each other;
    the device encode (encode_parity_fused_planar) and its kernels; then
    the same batch through the CLI's host stages, timed on the host clock.
    -> {"ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by"} of the
    fused kernel."""
    import torch

    from foldcomp_tpu_torch.codec.batch import encode_finish, encode_submit
    from foldcomp_tpu_torch.codec.batch_host import (encode_pdb_device,
                                                     fragment_to_tensors)
    from foldcomp_tpu_torch.codec.fcz import serialize
    from foldcomp_tpu_torch.io.pdb import format_pdb
    from foldcomp_tpu_torch.kernels import fused_encode as FE
    from foldcomp_tpu_torch.verify import on_milli_grid

    frames = {n: on_milli_grid(synthesize(n, n)) for n in BENCH_LENGTHS}
    uniq = {n: fragment_to_tensors(a) for n, a in frames.items()}
    rng = random.Random(0)
    picks = [rng.choice(BENCH_LENGTHS) for _ in range(ENC_BATCH)]
    bt = pack_batch([uniq[n] for n in picks], dev)
    code, n_res, wire = bt["code"], bt["n_res"], bt["wire"]

    def kern():
        return FE.fused(code, n_res, wire=wire)

    def plain():
        return FE.fused_plain(code, n_res, wire=wire)

    def device_encode():
        return FE.encode_parity_fused_planar(*wire, code, n_res)

    p1 = cuda_ms(torch, plain, 2)
    k1 = cuda_ms(torch, kern, 20)
    e1 = cuda_ms(torch, device_encode, 20)
    e2 = cuda_ms(torch, device_encode, 20)
    k2 = cuda_ms(torch, kern, 20)
    p2 = cuda_ms(torch, plain, 2)
    # the timed batch is the main path's shape: hold it as phase 7 does
    mism, bad, worst = hold_fused("cli_batch", kern(), plain())
    torch.cuda.synchronize()
    names = device_kernels(torch, device_encode)
    emit("encode_device_kernels", entries=bt["b"], l=bt["l"],
         mismatches=mism, tol=K4_TOL, device_encode_kernels=names)
    if bad:
        raise AssertionError(f"fused encode vs plain: {bad}")
    if names is not None and len(names) != 1:
        raise AssertionError(f"the device encode ran {len(names)} device "
                             f"kernels: {names}")
    out = device_encode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = {k: v.cpu().numpy() for k, v in out.items()}
    d2h_s = time.perf_counter() - t0

    slots = bt["b"] * bt["l"]
    # each input read once for the real residues, each output written once
    # for every slot
    in_per_slot = (sum(a.nbytes for a in wire) + code.nbytes) / slots
    n_bytes = (in_per_slot * bt["residues"] + n_res.nbytes
               + K4_OUT_BYTES_PER_SLOT * slots)
    n_ops = sum(K4_FLOPS_PER_RES.values()) * bt["residues"]
    b_ms, b_by = bound(n_bytes, n_ops)
    kern_ms, enc_ms = min(k1, k2), min(e1, e2)
    result = dict(
        gpu=card, entries=bt["b"], l=bt["l"], residues=bt["residues"],
        slots=slots, padded_slots_per_residue=slots / bt["residues"],
        k4_bytes=n_bytes, k4_operations=n_ops, k4_bound_ms=b_ms,
        k4_bound_by=b_by, k4_bound_share=b_ms / kern_ms,
        k4_bytes_real_residues_only=(in_per_slot + K4_OUT_BYTES_PER_SLOT)
        * bt["residues"] + n_res.nbytes,
        pack_seconds=bt["pack_seconds"], h2d_seconds=bt["h2d_seconds"],
        d2h_seconds=d2h_s, d2h_bytes=sum(v.nbytes for v in host.values()),
        k4_ms=kern_ms, k4_plain_ms=min(p1, p2),
        k4_runs_ms={"plain": [p1, p2], "kernel": [k1, k2]},
        device_encode_ms=enc_ms, device_encode_runs_ms=[e1, e2],
        device_encode_kernel_count=None if names is None else len(names),
        device_encode_residues_per_s=bt["residues"] / (enc_ms * 1e-3))
    # the CLI's stages for this batch: native PDB parse, submit (pack,
    # H2D, launches), finish (D2H, sparse host rescue, FczData), serialize
    texts = {n: format_pdb(a, f"L{n}").encode() for n, a in frames.items()}
    stages = {}
    t0 = time.perf_counter()
    parsed = [encode_pdb_device(texts[n]) for n in picks]
    stages["parse"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = encode_submit([t for ts, _ in parsed for t in ts],
                      [m for _, ms in parsed for m in ms], device=dev)
    torch.cuda.synchronize()
    stages["submit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fczs = encode_finish(h)
    stages["finish"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    blobs = [serialize(f) for f in fczs]
    stages["serialize"] = time.perf_counter() - t0
    if len(blobs) != ENC_BATCH or h["wire"] != "native":
        raise AssertionError(f"{len(blobs)} entries by {h['wire']}")
    emit("encode_device", **result, host_stage_seconds=stages)
    return {"ms": kern_ms, "plain_ms": min(p1, p2), "max_abs_err": worst,
            "bound_ms": b_ms, "bound_by": b_by}


def e2e_compress(work, card, uniq):
    """Phase 10: `compress --fast` through the CLI on E2E_FILES PDB files,
    against the exact route, then in this process with the launch
    counters around it. -> the main path's launch counts."""
    import torch

    from foldcomp_tpu_torch import cli
    from foldcomp_tpu_torch.codec.decoder import decode as decode_exact
    from foldcomp_tpu_torch.io.db import DatabaseReader
    from foldcomp_tpu_torch.io.pdb import format_pdb
    from foldcomp_tpu_torch.kernels import fused_decode as FD
    from foldcomp_tpu_torch.kernels import fused_encode as FE

    texts = {n: format_pdb(decode_exact(f), f"L{n}")
             for n, f in uniq.items()}
    pdb_dir = work / "pdbs"
    pdb_dir.mkdir()
    rng = random.Random(4)
    picks = [rng.choice(BENCH_LENGTHS) for _ in range(E2E_FILES)]
    for i, n in enumerate(picks):
        (pdb_dir / f"e{i}_L{n}.pdb").write_text(texts[n])
    residues = sum(uniq[n].n_residue for n in picks)

    def read_db(path):
        reader = DatabaseReader(str(path))
        try:
            return {name: bytes(data) for _, name, data in reader.entries()}
        finally:
            reader.close()

    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("FOLDCOMP_TORCH_DEVICE", None)
    walls = {}
    for key, fast in (("fast", ["--fast"]), ("exact", [])):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "foldcomp_tpu_torch", "compress", *fast,
             str(pdb_dir),
             str(work / f"db_{key}"), "--db"], cwd=str(REPO), env=env,
            capture_output=True, text=True, timeout=900)
        walls[key] = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"{key} compress rc {r.returncode}: "
                                 f"{r.stderr[-4000:]}")
    fast_db, exact_db = read_db(work / "db_fast"), read_db(work / "db_exact")
    differ = sorted(n for n in exact_db if fast_db.get(n) != exact_db[n])
    emit("e2e_compress", gpu=card, files=len(picks), residues=residues,
         command="python -m foldcomp_tpu_torch compress --fast <dir> <db> "
                 "--db", wall_seconds=walls["fast"],
         residues_per_s=residues / walls["fast"],
         exact_route_wall_seconds=walls["exact"],
         exact_route_residues_per_s=residues / walls["exact"],
         entries=len(fast_db), entries_exact=len(exact_db),
         differing_entries=len(differ), first_differing=differ[:5])
    if differ or len(fast_db) != len(exact_db) or len(fast_db) != len(picks):
        raise AssertionError(f"compress --fast vs exact: {len(differ)} "
                             f"entries differ, {len(fast_db)} vs "
                             f"{len(exact_db)} entries")

    FD.reset_launch_counts()
    FE.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli.main(["compress", "--fast", str(pdb_dir),
                       str(work / "db_main"), "--db"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**FD.launch_counts(), **FE.launch_counts()}
    emit("main_path_compress", rc=rc, launches=counts, wall_seconds=wall,
         residues_per_s=residues / wall, gpu=card)
    if rc != 0 or counts["k4"] <= 0:
        raise AssertionError(f"compress main path rc {rc}, "
                             f"launches {counts}")
    return counts


def decode_kernels(dev, uniq, err):
    """Phase 2: k1, k2 and k3 against their plain versions on `dev`, on
    the same inputs (kernel_cases). k1 and k2 within TOL_A on the rows each
    lane owns, k3 (on the rows k2 staged) within TOL_CLASSES, byte-equal,
    on its residues. err keeps each kernel's largest difference; raises
    past a tolerance."""
    import torch

    from foldcomp_tpu_torch.kernels import fused_decode as FD

    def compare(arrays, ta, pr, refine_iters, is_first):
        recs, fwd9, lane, order = (pr["recs"], pr["fwd9"], pr["lane"],
                                   pr["order"])
        got = {}
        tails9 = None
        if refine_iters >= 2:
            tails9 = FD.tails(recs, fwd9, *lane, order=order)
            tp = FD.tails_plain(recs, FD.n_ca_lengths(recs), fwd9, *lane)
            got["k1"] = (tails9 - tp).abs().max().item()
        bk = FD.backbone(recs, tails9, fwd9, is_first, *lane, order=order)
        rows = bk.rows()
        got["k2"] = owned_max(rows, FD.backbone_rolled_plain(
            recs, tails9, fwd9, is_first, *lane), pr["tat"])
        nl_out = arrays["nl_out"]
        # k3 on the staged rows k2 left on the card, against the plain
        # version on the same rows in lane columns
        ok_, ck = FD.sidechain(bk, pr["code"], pr["sct"], nl_out,
                               seg_m=ta["seg_m"])
        op, cp = FD.sidechain_plain(*rows, pr["code"], pr["sct"], nl_out)
        own_res = torch.arange(ok_.shape[1], device=dev)[None, :] \
            < ta["seg_m"][:ok_.shape[0], None]
        d_off = (ok_.int() - op.int()).abs()[own_res].max().item()
        d_ca = (ck - cp).abs()[own_res].max().item()
        got["k3_off_units"] = d_off
        got["k3_ca"] = d_ca
        got["k3"] = max(d_off * 1e-3, d_ca)
        for k in ("k1", "k2"):
            if k in got and not got[k] <= TOL_A:
                raise AssertionError(f"{k} vs plain: {got[k]} A")
        if not (d_off <= TOL_CLASSES["i16_units"]
                and d_ca <= TOL_CLASSES["f32_A"]):
            raise AssertionError(f"k3 vs plain: off {d_off} units, "
                                 f"ca {d_ca} A")
        for k in ("k1", "k2", "k3"):
            if k in got:
                err[k] = max(err[k], got[k])
        return got

    for label, arrays, ta, pr, r, first in kernel_cases(dev, uniq):
        got = compare(arrays, ta, pr, r, first)
        torch.cuda.synchronize()
        emit("kernels", corpus=label, refine_iters=r,
             lane0_wraps=first is not ta["is_first"],
             seg=int(arrays["seg_records"].shape[1]),
             lanes=int(arrays["seg_records"].shape[2]),
             max_abs=got, tol={"k1_k2_f32_A": TOL_A,
                               "k3_f32_A": TOL_CLASSES["f32_A"],
                               "k3_i16_units": TOL_CLASSES["i16_units"]})


def phase2_corpora(uniq):
    """Phase 2's corpora: (label, FczData list, the pack's seg_bucket) of a
    mixed batch of 512 entries, a corpus with SEG > 96 and one packed
    without the 8-row bucket (SEG % 4 != 0)."""
    from foldcomp_tpu_torch.codec.encoder import encode

    rng = random.Random(0)
    mixed = [uniq[rng.choice(BENCH_LENGTHS)] for _ in range(512)]
    wide_u = [encode(synthesize(n, seed=i), anchor_threshold=200)
              for i, n in enumerate((120, 220))]
    wide = [wide_u[i % 2] for i in range(256)]
    # k3 copies out with 16-byte stores only where SEG % 4 == 0
    odd = [encode(synthesize(n, seed=n)) for n in (37, 45, 61, 83, 97)] * 40
    return (("mixed512", mixed, 8), ("wide", wide, 8), ("odd_seg", odd, 1))


def kernel_cases(dev, uniq):
    """Phase 2's inputs: yields (corpus, arrays, tensors, class_prep dict,
    refine_iters, is_first) for phase2_corpora at refine_iters 1 and 2,
    then the mixed batch at 2 with lane 0 made a continuation (is_first[0]
    false), so that k2's seed roll wraps to lane NL-1."""
    for label, fczs, bucket in phase2_corpora(uniq):
        arrays, _, ta, pr = prep_of(fczs, dev, bucket)
        seg = arrays["seg_records"].shape[1]
        if label == "wide" and not seg > 96:
            raise AssertionError("wide corpus does not exceed SEG 96")
        if label == "odd_seg" and not seg % 4:
            raise AssertionError(f"odd_seg corpus has SEG {seg}")
        yield label, arrays, ta, pr, 1, ta["is_first"]
        yield label, arrays, ta, pr, 2, ta["is_first"]
        if label == "mixed512":
            first = ta["is_first"].clone()
            first[0] = False
            yield label, arrays, ta, pr, 2, first


def device_decode(dev, card, uniq, err, entries=8192):
    """Phase 4: decode of `entries` entries of the 8 lengths through the
    kernels and through the plain versions, timed with CUDA events; each
    kernel's time beside its plain version's, its bound, and k1 and k2 in
    the pack's lane order (pack_order_ms); the lane order's own time; the
    glue (device decode less the kernels). -> per-kernel times."""
    import torch

    from foldcomp_tpu_torch.kernels import fused_decode as FD

    rng = random.Random(0)
    big = [uniq[rng.choice(BENCH_LENGTHS)] for _ in range(entries)]
    n_res = sum(f.n_residue for f in big)
    t0 = time.perf_counter()
    arrays, _, ta, pr = prep_of(big, dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    fused_args = tuple(ta[k] for k in DECODE_KEYS)
    nl_out = arrays["nl_out"]

    def kernel_decode():
        return FD.decode_seg_fused(*fused_args, refine_iters=2,
                                   nl_out=nl_out)

    def plain():
        return plain_decode(ta, nl_out)

    ms_plain_a = cuda_ms(torch, plain, 2)
    ms_kern_a = cuda_ms(torch, kernel_decode, 10)
    ms_kern_b = cuda_ms(torch, kernel_decode, 10)
    ms_plain_b = cuda_ms(torch, plain, 2)
    ko, kc = kernel_decode()
    po, pc = plain()
    own_res = torch.arange(ko.shape[1], device=dev)[None, :] \
        < ta["seg_m"][:ko.shape[0], None]
    d_off = (ko.int() - po.int()).abs()[own_res].max().item()
    d_ca = (kc - pc).abs()[own_res].max().item()
    # byte-identical on every real row
    if not (d_off <= TOL_CLASSES["i16_units"]
            and d_ca <= TOL_CLASSES["f32_A"]):
        raise AssertionError(f"B={entries} kernel vs plain decode: off "
                             f"{d_off}, ca {d_ca}")
    del ko, kc, po, pc

    recs, fwd9, lane, order, first, tat = (pr["recs"], pr["fwd9"],
                                           pr["lane"], pr["order"],
                                           ta["is_first"], pr["tat"])
    pack_order = FD.lane_order(tat, by_length=False)
    t9 = FD.tails(recs, fwd9, *lane, order=order)
    t9p = FD.tails_plain(recs, FD.n_ca_lengths(recs), fwd9, *lane)
    bb = FD.backbone(recs, t9, fwd9, first, *lane, order=order)
    bb_rows = bb.rows()
    diffs = {"k1": (t9 - t9p).abs().max().item(),
             "k2": owned_max(bb_rows, FD.backbone_rolled_plain(
                 recs, t9, fwd9, first, *lane), tat)}
    del t9p
    for k, d in diffs.items():
        if not d <= TOL_A:
            raise AssertionError(f"B={entries} {k} vs plain: {d} A")
        err[k] = max(err[k], d)

    def k1(o=order):
        return FD.tails(recs, fwd9, *lane, order=o)

    def k2(o=order):
        return FD.backbone(recs, t9, fwd9, first, *lane, order=o)

    per_kernel = {
        "k1": (k1, lambda: FD.tails_plain(recs, FD.n_ca_lengths(recs), fwd9,
                                          *lane)),
        "k2": (k2, lambda: FD.backbone_rolled_plain(recs, t9, fwd9, first,
                                                    *lane)),
        "k3": (lambda: FD.sidechain(bb, pr["code"], pr["sct"], nl_out,
                                    seg_m=ta["seg_m"]),
               lambda: FD.sidechain_plain(*bb_rows, pr["code"], pr["sct"],
                                          nl_out)),
    }
    # the work each kernel must do: the real lanes, their residue rows and
    # their forward steps
    nl_real = sum(f.n_anchor - 1 for f in big)
    rows = int(ta["seg_m"][:nl_real].sum())
    count = {"residue": rows, "step": rows - nl_real, "lane": nl_real}
    times = {}
    for k, (kern, plain_k) in per_kernel.items():
        p1 = cuda_ms(torch, plain_k, 2)
        r1 = cuda_ms(torch, kern, 10)
        r2 = cuda_ms(torch, kern, 10)
        p2 = cuda_ms(torch, plain_k, 2)
        n_bytes, n_ops, b_ms, b_by = work_bound(k, count)
        times[k] = {"ms": min(r1, r2), "plain_ms": min(p1, p2),
                    "runs_ms": [p1, r1, r2, p2], "bytes": n_bytes,
                    "operations": n_ops, "bound_ms": b_ms, "bound_by": b_by,
                    "bound_share": b_ms / min(r1, r2)}
    # k1 and k2 with the lanes in pack order: what the lane order saves
    for k, kern in (("k1", k1), ("k2", k2)):
        times[k]["pack_order_ms"] = cuda_ms(torch,
                                            lambda: kern(pack_order), 10)
    times["k2"]["order_ms"] = cuda_ms(torch, lambda: FD.lane_order(tat), 10)
    times["prep"] = prep_times(ta, nl_real, err)
    # k3 over every row, the padding's too: what skipping it saves
    every_row = torch.full_like(ta["seg_m"], int(recs.shape[1]))
    times["k3"]["all_rows_ms"] = cuda_ms(
        torch, lambda: FD.sidechain(bb, pr["code"], pr["sct"], nl_out,
                                    seg_m=every_row), 10)
    del bb, bb_rows, t9
    ms_kern = min(ms_kern_a, ms_kern_b)
    ms_plain = min(ms_plain_a, ms_plain_b)
    emit("device", gpu=card, entries=len(big), residues=n_res,
         lanes_real=nl_real, rows_real=rows,
         seg=int(arrays["seg_records"].shape[1]),
         lanes=int(arrays["seg_records"].shape[2]), nl_out=nl_out,
         pack_and_h2d_seconds=pack_s,
         kernel_decode_ms=ms_kern, plain_decode_ms=ms_plain,
         kernel_decode_runs_ms=[ms_kern_a, ms_kern_b],
         plain_decode_runs_ms=[ms_plain_a, ms_plain_b],
         glue_ms=ms_kern - sum(times[k]["ms"] for k in ("k1", "k2", "k3")),
         prep=times["prep"],
         kernel_residues_per_s=n_res / (ms_kern * 1e-3),
         plain_residues_per_s=n_res / (ms_plain * 1e-3),
         kernel_vs_plain={"off_units": d_off, "ca_A": d_ca,
                          "k1_A": diffs["k1"], "k2_owned_rows_A":
                          diffs["k2"]},
         per_kernel=times)
    return times


def queued_ms(torch, fn, reps):
    """Mean device time of fn over reps runs, each queued before the first
    runs (behind torch.cuda._sleep): the card's time alone, where a run's
    host time exceeds its device time and cuda_ms would read the host's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PREP_FIELDS = ("recs", "code", "sct", "fwd9", "rev9", "tat", "mins6",
               "cont6", "order")


def prep_diff(label, got, want, err):
    """k0's outputs (prep's dicts) against class_prep + lane_order's on the
    same inputs, class by class: every field and the lane order's perm
    bit for bit (shape, dtype, values). Raises on any difference.
    -> {classes, lanes, differing fields, largest |difference|}."""
    import torch
    if len(got) != len(want):
        raise AssertionError(f"{label}: k0 gave {len(got)} classes for "
                             f"{len(want)}")
    bad, worst = [], 0.0
    for c, (g, w) in enumerate(zip(got, want)):
        for k in PREP_FIELDS:
            a, b = (g[k].perm, w[k].perm) if k == "order" else (g[k], w[k])
            if a.shape != b.shape or a.dtype != b.dtype:
                bad.append(f"class {c} {k}: {a.dtype}{tuple(a.shape)} for "
                           f"{b.dtype}{tuple(b.shape)}")
            elif not torch.equal(a, b):
                worst = max(worst, (a.double() - b.double()).abs().max()
                            .item())
                bad.append(f"class {c} {k}")
    if bad:
        raise AssertionError(f"{label}: k0 vs class_prep + lane_order: "
                             f"{bad}, largest |difference| {worst}")
    err["prep"] = max(err["prep"], worst)
    return {"classes": len(got), "lanes": [int(w["tat"].numel())
                                           for w in want],
            "fields": len(PREP_FIELDS), "differing": bad,
            "max_abs_diff": worst}


def prep_times(ta, nl_real, err):
    """k0 on a single-class pack's tensors: its outputs against its plain
    version's (class_prep and lane_order, prep_diff); its device time
    (queued_ms, twice), and in turns with the plain version on the card
    (torch's operations, which synchronize, so cannot be queued) the time
    a call as the host issues it (cuda_ms; plain_ms is the plain
    version's, host-paced); k0's bound: the bytes it must move, the code
    plane's byte in and i32 out a slot, seg_m twice, tat, the 12
    quantizer floats in and out and the order a lane (the pack's lanes,
    pad lanes included: k0 fills every one), at the card's memory rate."""
    import torch

    from foldcomp_tpu_torch.kernels import fused_decode as FD
    args = [tuple(ta[k] for k in DECODE_KEYS[:6]) + (ta["seg_m"],)]

    def plain():
        pr = FD.class_prep(*args[0])
        pr["order"] = FD.lane_order(pr["tat"])
        return [pr]

    def k0():
        return FD.prep(args)

    check = prep_diff("B=8192 one class", k0(), plain(), err)
    runs = [queued_ms(torch, k0, 20) for _ in range(2)]
    host = [cuda_ms(torch, fn, 20) for fn in (plain, k0, k0, plain)]
    _, seg, nl = ta["seg_records"].shape
    n_bytes = 5 * seg * nl + (8 + 4 + 96 + 4) * nl
    b_ms = n_bytes / PEAK_BYTES_S * 1e3
    ms = min(runs)
    return {"ms": ms, "runs_ms": runs, "host_paced_ms": min(host[1:3]),
            "plain_ms": min(host[0], host[3]), "plain_paced_by": "host",
            "host_paced_runs_ms": host, "bytes": n_bytes, "bound_ms": b_ms,
            "bound_by": "bytes", "bound_share": b_ms / ms, "lanes": nl,
            "lanes_real": nl_real, "seg": seg, "vs_plain": check}


def prep_tests(card):
    """Phase 18: tests/test_torch_prep.py's card tests in a subprocess
    (module docstring); raises unless they ran and passed."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-m", "card", "-q",
         str(REPO / "tests" / "test_torch_prep.py")],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    lines = r.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    passed = sum(int(n) for n in re.findall(r"(\d+) passed", summary))
    emit("prep", gpu=card, rc=r.returncode, passed=passed, summary=summary,
         seconds=time.perf_counter() - t0)
    if r.returncode != 0 or passed == 0:
        print(r.stdout[-20000:], r.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"k0 card tests: rc {r.returncode}, {summary}")


# k0's outputs that its bb mode writes too (no code plane, no sct)
PREP_BB_FIELDS = ("recs", "fwd9", "rev9", "tat", "mins6", "cont6", "order")


def prep_bb_vs_full(ta):
    """k0 in bb mode (fused_decode.prep(..., wire="bb"), the side-chain
    codes not given) against k0 in full mode on one single-class pack's
    tensors: every output the bb mode writes bit for bit, no code plane;
    each mode's device time (queued_ms) and the workspace's bytes. Raises
    on any difference."""
    import torch

    from foldcomp_tpu_torch.kernels import fused_decode as FD
    full = [tuple(ta[k] for k in DECODE_KEYS[:6]) + (ta["seg_m"],)]
    bb = [full[0][:3] + (None,) + full[0][4:]]
    want, got = FD.prep(full)[0], FD.prep(bb, wire="bb")[0]
    torch.cuda.synchronize()
    bad = [k for k in ("code", "sct") if k in got]
    for k in PREP_BB_FIELDS:
        a, b = (got[k].perm, want[k].perm) if k == "order" \
            else (got[k], want[k])
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                a.view(torch.int32) if a.dtype == torch.float32 else a,
                b.view(torch.int32) if b.dtype == torch.float32 else b):
            bad.append(k)
    if bad:
        raise AssertionError(f"k0 bb mode vs full mode: {bad}")
    _, seg, nl = ta["seg_records"].shape
    ws = {m: FD.class_layout([nl], [seg], m).k0_size * 4
          for m in ("full", "bb")}
    ms = {"full": min(queued_ms(torch, lambda: FD.prep(full), 20)
                      for _ in range(2)),
          "bb": min(queued_ms(torch, lambda: FD.prep(bb, wire="bb"), 20)
                    for _ in range(2))}
    return {"fields": list(PREP_BB_FIELDS), "differing": bad,
            "queued_ms": ms, "workspace_bytes": ws, "lanes": nl, "seg": seg}


def bb_resident_form(big, dev, err):
    """The bb pack as arrays_to_torch holds it (no side-chain codes): its
    dispatch (codec/batch._seg_decode_arrays) against the same dispatch
    with the side-chain codes held, every row each lane owns bit for bit;
    three dispatches launch k0 three times, all in bb mode, and no k3;
    the bytes each form holds on the card. Raises on any difference."""
    import torch

    from foldcomp_tpu_torch.codec import batch as CB
    from foldcomp_tpu_torch.kernels import fused_decode as FD
    arrays, _ = CB.pack_decode_wire(big, True)
    lean = CB.arrays_to_torch(arrays, dev)
    if lean["sc_codes_seg"] is not None:
        raise AssertionError("the bb form holds the side-chain codes")
    fat = dict(lean, sc_codes_seg=torch.from_numpy(
        arrays["sc_codes_seg"]).to(dev))
    got, want = CB._seg_decode_arrays(lean), CB._seg_decode_arrays(fat)
    torch.cuda.synchronize()
    d = hold_bb("bb resident form", got[1:], want[1:], lean["seg_m"], err)
    FD.reset_launch_counts()
    for _ in range(3):
        CB._seg_decode_arrays(lean)
    torch.cuda.synchronize()
    counts = FD.launch_counts()
    if not (counts["prep"] == counts["prep_bb"] == counts["k1"]
            == counts["k2_bb"] == 3 and counts["k2"] == counts["k3"] == 0):
        raise AssertionError(f"bb dispatch launches {counts}")

    def held(ta):
        return sum(v.numel() * v.element_size() for v in ta.values()
                   if torch.is_tensor(v))
    return {"vs_sc_held": d, "launches_3_dispatches": counts,
            "held_bytes": {"bb_form": held(lean), "with_sc": held(fat)},
            "slots": int(arrays["seg_records"].shape[1]
                         * arrays["seg_records"].shape[2])}


def bb_owned_max(got, want, seg_m):
    """(offset units, CA A): the largest |difference| of two bb-wire
    outputs (off [NL_out, SEG, 6], ca [NL_out, SEG, 3]) on the rows each
    lane owns (s < seg_m)."""
    import torch
    own = torch.arange(got[0].shape[1], device=seg_m.device)[None, :] \
        < seg_m[:got[0].shape[0], None]
    return ((got[0].int() - want[0].int()).abs()[own].max().item(),
            (got[1] - want[1]).abs()[own].max().item())


# the one-kernel bb call against its plain version: the gate is
# bit-equality on the rows each lane owns
TOL_BB = {"i16_units": 0, "ca_A": 0.0}


def hold_bb(label, got, want, seg_m, err):
    """Gate a bb-wire output against its plain version: TOL_BB (bit-equal)
    on owned rows. -> the difference."""
    d_off, d_ca = bb_owned_max(got, want, seg_m)
    if not (d_off <= TOL_BB["i16_units"] and d_ca <= TOL_BB["ca_A"]):
        raise AssertionError(f"{label}: k2_bb vs plain: off {d_off} units, "
                             f"ca {d_ca} A")
    err["k2_bb"] = max(err["k2_bb"], d_off * BB_UNIT_A, d_ca)
    return {"off_units": d_off, "ca_A": d_ca}


def bb_kernels(dev, uniq, err):
    """Phase 11, kernels: backbone_only (one kernel, k2_backbone_bb)
    against bb_epilogue_plain(backbone_rolled_plain(...)) on phase 2's
    inputs, at refine_iters 1 and 2."""
    import torch

    from foldcomp_tpu_torch.kernels import fused_decode as FD

    for label, arrays, ta, pr, r, first in kernel_cases(dev, uniq):
        recs, fwd9, lane = pr["recs"], pr["fwd9"], pr["lane"]
        tails9 = FD.tails(recs, fwd9, *lane, order=pr["order"]) \
            if r >= 2 else None
        nl_out = arrays["nl_out"]
        got = FD.backbone_only(recs, tails9, fwd9, first, *lane, ta["seg_m"],
                               nl_out, order=pr["order"])
        want = FD.bb_epilogue_plain(*FD.backbone_rolled_plain(
            recs, tails9, fwd9, first, *lane), nl_out)
        d = hold_bb(label, got, want, ta["seg_m"], err)
        torch.cuda.synchronize()
        emit("bb_wire", part="kernels", corpus=label, refine_iters=r,
             lane0_wraps=first is not ta["is_first"],
             seg=int(arrays["seg_records"].shape[1]),
             lanes=int(arrays["seg_records"].shape[2]), max_abs=d,
             tol=TOL_BB)


def d2h(outs):
    """(seconds, bytes) of one decode output's copy to the host, as the
    stream makes it (codec/batch.py _outs_to_host: pageable memory)."""
    import torch

    from foldcomp_tpu_torch.codec.batch import _outs_to_host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = _outs_to_host(outs)
    dt = time.perf_counter() - t0
    return dt, sum(a.nbytes for a in host if not isinstance(a, str))


def bb_device(dev, card, uniq, err, entries=8192):
    """Phase 11, device: the B=8192 batch of phase 4 on the bb wire.
    backbone_only (one kernel, k2_backbone_bb) against its plain version;
    the bb call beside the full wire's k2 (k2_backbone) and
    its plain version, and the whole device decode on each wire, all by
    CUDA events in turns; the D2H seconds and bytes of each wire's output;
    the link probe. -> k2_bb's times and bound."""
    import torch

    from foldcomp_tpu_torch import cli
    from foldcomp_tpu_torch.codec import batch as CB
    from foldcomp_tpu_torch.kernels import fused_decode as FD

    rng = random.Random(0)
    big = [uniq[rng.choice(BENCH_LENGTHS)] for _ in range(entries)]
    arrays, _, ta, pr = prep_of(big, dev)
    fused_args = tuple(ta[k] for k in DECODE_KEYS)
    nl_out = arrays["nl_out"]
    recs, fwd9, lane, order, first, seg_m = (pr["recs"], pr["fwd9"],
                                             pr["lane"], pr["order"],
                                             ta["is_first"], ta["seg_m"])
    seg, nl = recs.shape[1], recs.shape[2]
    t9 = FD.tails(recs, fwd9, *lane, order=order)

    def bb_call():
        return FD.backbone_only(recs, t9, fwd9, first, *lane, seg_m, nl_out,
                                order=order)

    def full_k2():
        return FD.backbone(recs, t9, fwd9, first, *lane, order=order)

    def plain():
        return FD.bb_epilogue_plain(*FD.backbone_rolled_plain(
            recs, t9, fwd9, first, *lane), nl_out)

    d = hold_bb(f"B={entries}", bb_call(), plain(), seg_m, err)
    k0_bb = prep_bb_vs_full(ta)
    form = bb_resident_form(big, dev, err)
    runs = {"bb_call": [], "full_k2": []}
    for name, fn in (("bb_call", bb_call), ("full_k2", full_k2),
                     ("full_k2", full_k2), ("bb_call", bb_call)):
        runs[name].append(cuda_ms(torch, fn, 10))
    p1 = cuda_ms(torch, plain, 2)
    p2 = cuda_ms(torch, plain, 2)

    def decode(wire):
        return FD.decode_seg_fused(*fused_args, refine_iters=2,
                                   nl_out=nl_out, wire=wire)

    dec = {"full": [], "bb": []}
    xfer = {"full": [], "bb": []}
    for wire in ("full", "bb", "bb", "full"):
        dec[wire].append(cuda_ms(torch, lambda: decode(wire), 10))
        outs = decode(wire)
        dt, nbytes = d2h(("bb",) + outs if wire == "bb" else outs)
        xfer[wire].append({"seconds": dt, "bytes": nbytes,
                           "mb_per_s": nbytes / dt / 1e6})
        del outs

    probes = [cli._run_probe() for _ in range(2)]
    in_band = [r in ("ok", "slow")
               and CB._BB_WIRE_MIN_MBS <= m < CB._BB_WIRE_MAX_MBS
               for r, m in probes]

    nl_real = sum(f.n_anchor - 1 for f in big)
    rows = int(seg_m[:nl_real].sum())
    count = {"residue": rows, "step": rows - nl_real, "lane": nl_real}
    n_bytes, n_ops, b_ms, b_by = work_bound("k2_bb", count)
    ms = min(runs["bb_call"])
    out_bytes = 24 * rows
    emit("bb_wire", part="device", gpu=card, entries=len(big),
         lanes_real=nl_real, rows_real=rows, seg=int(seg), lanes=int(nl),
         nl_out=nl_out, kernel_vs_plain=d, tol=TOL_BB,
         bb_call_ms=ms, bb_call_runs_ms=runs["bb_call"],
         full_k2_ms=min(runs["full_k2"]), full_k2_runs_ms=runs["full_k2"],
         bb_call_plain_ms=min(p1, p2), bb_call_plain_runs_ms=[p1, p2],
         bb_call_bytes=n_bytes, bb_call_operations=n_ops,
         bb_call_bound_ms=b_ms, bb_call_bound_by=b_by,
         bb_call_bound_share=b_ms / ms, bb_real_rows_bytes=out_bytes,
         device_decode_ms={w: min(v) for w, v in dec.items()},
         device_decode_runs_ms=dec, d2h=xfer,
         d2h_share_of_full=min(x["seconds"] for x in xfer["bb"])
         / min(x["seconds"] for x in xfer["full"]),
         probe=[{"result": r, "mb_per_s": m} for r, m in probes],
         probe_chooses_bb=in_band,
         bb_band_mb_per_s=[CB._BB_WIRE_MIN_MBS, CB._BB_WIRE_MAX_MBS],
         k0_bb_mode=k0_bb, resident_form=form)
    return {"ms": ms, "plain_ms": min(p1, p2), "bound_ms": b_ms,
            "bound_by": b_by}


def bb_cli(work, db, names, card, hold):
    """Phase 11, CLI: `decompress --fast` with FOLDCOMP_TPU_WIRE=bb on
    phase 5's database in a subprocess, 64 sampled outputs held by `hold`
    (phase 5's bound), then in this process with the launch counters
    around it. -> the in-process run's launch counts."""
    import torch

    from foldcomp_tpu_torch import cli
    from foldcomp_tpu_torch.kernels import fused_decode as FD
    from foldcomp_tpu_torch.kernels import fused_encode as FE

    env = dict(os.environ, PYTHONPATH=str(REPO), FOLDCOMP_TPU_WIRE="bb")
    env.pop("FOLDCOMP_TORCH_DEVICE", None)
    out = work / "pdb_db_bb"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "foldcomp_tpu_torch", "decompress", "--fast",
         str(db), str(out), "--db"], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"bb CLI rc {r.returncode}: {r.stderr[-4000:]}")
    worst = hold(out, names)
    emit("bb_wire", part="e2e", gpu=card, entries=len(names),
         command="FOLDCOMP_TPU_WIRE=bb python -m foldcomp_tpu_torch "
                 "decompress --fast <db> <out> --db", wall_seconds=wall,
         sampled=64, worst_dev_over_ref_A=worst)

    saved = os.environ.get("FOLDCOMP_TPU_WIRE")
    os.environ["FOLDCOMP_TPU_WIRE"] = "bb"
    try:
        FD.reset_launch_counts()
        FE.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            rc = cli.main(["decompress", "--fast", str(db),
                           str(work / "pdb_db_bb_main"), "--db"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**FD.launch_counts(), **FE.launch_counts()}
    finally:
        if saved is None:
            os.environ.pop("FOLDCOMP_TPU_WIRE")
        else:
            os.environ["FOLDCOMP_TPU_WIRE"] = saved
    emit("bb_wire", part="main_path", rc=rc, launches=counts,
         wall_seconds=wall, gpu=card)
    # the bb call is one kernel, counted as k2_bb and not as k2; k0 runs
    # in bb mode once a dispatch
    if rc != 0 or not (counts["k1"] > 0 and counts["k2"] == 0
                       and counts["k2_bb"] > 0 and counts["k3"] == 0
                       and counts["prep"] == counts["prep_bb"]
                       == counts["k1"]):
        raise AssertionError(f"bb main path rc {rc}, launches {counts}")
    return counts


# the classed decode against its plain version: the gate is bit-equality
# on the rows each lane owns
TOL_CLASSES = {"i16_units": 0, "f32_A": 0.0}


def class_inputs(ta):
    """The per-class kernel inputs of a classed tensor dict
    (arrays_to_torch of split_lanes_classes' dict): (decode args, class_prep
    dicts with their lane orders, the classes' first lanes in the shared
    tails, NL_total appended)."""
    from foldcomp_tpu_torch.codec.batch import _CLASS_DTYPES
    from foldcomp_tpu_torch.kernels import fused_decode as FD
    c = ta["classes"]
    args = tuple(c[k] for k in _CLASS_DTYPES)
    prs, bases = [], [0]
    for i in range(len(c["recs"])):
        pr = FD.class_prep(*(a[i] for a in args[:6]), c["segm"][i])
        pr["order"] = FD.lane_order(pr["tat"])
        pr["lane"] = (pr["rev9"], pr["tat"], pr["mins6"], pr["cont6"])
        pr["isf"], pr["segm"] = c["isf"][i], c["segm"][i]
        prs.append(pr)
        bases.append(bases[-1] + pr["recs"].shape[2])
    return args, prs, bases


def k1_classed(prs, bases, out=None):
    """k1 over every class of class_inputs' prs in one launch, into out
    (None: a new [9, NL_total] buffer). -> out."""
    import torch

    from foldcomp_tpu_torch.kernels import fused_decode as FD
    if out is None:
        out = torch.empty((9, bases[-1]), dtype=torch.float32,
                          device=prs[0]["recs"].device)
    return FD.tails_classes([(pr["recs"], pr["fwd9"], *pr["lane"],
                              pr["order"]) for pr in prs], out)


def k2_inputs(prs, bases, prev, tails_g):
    """backbone_classes' classes of class_inputs' prs: each class's lanes
    seeded through its slice of prev (none where tails_g is None)."""
    return [(pr["recs"], pr["fwd9"], pr["isf"], *pr["lane"], pr["order"],
             None if tails_g is None else prev[bases[i]:bases[i + 1]])
            for i, pr in enumerate(prs)]


def owned_rows(rows, tat):
    """The rows r < tat[l] of each lane l of [3*SEG, NL] planes, as one
    flat tensor of their bits a plane."""
    import torch
    own = torch.arange(rows[0].shape[0], device=tat.device)[:, None] < tat
    return [r[own].view(torch.int32) for r in rows]


def hold_classes(label, ta, refine_iters, err):
    """decode_lanes of width classes through the kernels against
    decode_seg_fused_classes_plain on the same classed inputs, on the rows
    each lane of each class owns (s < seg_m), with k1 (one launch over
    every class into the shared tails) and k2 (one launch over every
    class, seeded through prev_idx) against their plain versions too.
    Raises past TOL_CLASSES. -> the differences."""
    import torch

    from foldcomp_tpu_torch.kernels import fused_decode as FD
    args, prs, bases = class_inputs(ta)
    prev, nl_outs = ta["prev_idx"], ta["nl_outs"]
    got = FD.decode_lanes(*args, prev, refine_iters=refine_iters,
                          nl_outs=nl_outs)
    want = FD.decode_seg_fused_classes_plain(
        *args, prev, refine_iters=refine_iters, nl_outs=nl_outs)
    d = {"k1": 0.0, "k2": 0.0, "k3_off_units": 0, "k3_ca": 0.0}
    for (go, gc), (wo, wc), pr in zip(got, want, prs):
        own = torch.arange(go.shape[1], device=go.device)[None, :] \
            < pr["segm"][:go.shape[0], None]
        d["k3_off_units"] = max(d["k3_off_units"], (go.int() - wo.int())
                                .abs()[own].max().item())
        d["k3_ca"] = max(d["k3_ca"], (gc - wc).abs()[own].max().item())
    del got, want
    tails_g = None
    if refine_iters >= 2:
        tails_g = k1_classed(prs, bases)
        tp = torch.cat([FD.tails_plain(pr["recs"], FD.n_ca_lengths(
            pr["recs"]), pr["fwd9"], *pr["lane"]) for pr in prs], dim=1)
        d["k1"] = (tails_g - tp).abs().max().item()
    k2_in = k2_inputs(prs, bases, prev, tails_g)
    for c, bk in zip(k2_in, FD.backbone_classes(k2_in, tails_g)):
        d["k2"] = max(d["k2"], owned_max(bk.rows(), FD.backbone_rolled_plain(
            c[0], tails_g, c[1], c[2], *c[3:7], c[8]), c[4]))
    if not (d["k3_off_units"] <= TOL_CLASSES["i16_units"]
            and max(d["k1"], d["k2"], d["k3_ca"]) <= TOL_CLASSES["f32_A"]):
        raise AssertionError(f"{label} r={refine_iters}: classed kernels vs "
                             f"plain: {d}")
    err["k1"] = max(err["k1"], d["k1"])
    err["k2"] = max(err["k2"], d["k2"])
    err["k3"] = max(err["k3"], d["k3_off_units"] * 1e-3, d["k3_ca"])
    return d


def class_kernels(dev, uniq, err):
    """Phase 14, kernels: the classed decode's kernels against their plain
    versions on phase 2's corpora, each split into width classes with the
    savings gate off (min_save -100), at refine_iters 1 and 2."""
    import torch

    from foldcomp_tpu_torch.codec.batch import arrays_to_torch
    from foldcomp_tpu_torch.codec.batch_host import (pack_decode_batch_lanes,
                                                     split_lanes_classes)
    for label, fczs, bucket in phase2_corpora(uniq):
        arrays, metas = pack_decode_batch_lanes(fczs, seg_bucket=bucket)
        split = split_lanes_classes(dict(arrays), metas, min_save=-100.0)
        if split is None:     # a corpus of one width class has no split
            if label == "mixed512":
                raise AssertionError("mixed512: no width classes")
            emit("wclass", part="kernels", corpus=label, classes=1)
            continue
        ta = arrays_to_torch(split[0], dev)
        for r in (1, 2):
            d = hold_classes(label, ta, r, err)
            torch.cuda.synchronize()
            emit("wclass", part="kernels", corpus=label, refine_iters=r,
                 classes=len(ta["classes"]["recs"]),
                 seg=[int(t.shape[1]) for t in ta["classes"]["recs"]],
                 lanes=[int(t.shape[2]) for t in ta["classes"]["recs"]],
                 max_abs=d, tol=TOL_CLASSES)


def class_device(dev, card, uniq, err, entries=8192):
    """Phase 14, device: the B=8192 batch of phase 4, packed as the full
    wire's auto rule packs it (FOLDCOMP_TPU_WCLASS=auto: classes) and as
    one class. The classed kernels against their plain versions; the
    classed decode against the single-class one, gathered per protein
    through each pack's metas, bit-equal on every row; each form's slots,
    output bytes, D2H seconds (pageable, as the stream copies), device
    decode time in turns and peak device memory; k1 and k2 over every
    class in one launch beside the same kernel launched once a class (a
    one-entry table each; bit-equal on every row a lane owns), in turns;
    each class's k1, k2 and k3 by CUDA events and the glue, k3 also with
    its groups in k0's lane order; the launches of a batch (k0, k1 and k2 once,
    classed or not, k2 over every class, k3 once a class on k2's staged
    rows); the host seconds of the pack alone and of the pack with the
    split."""
    import numpy as np
    import torch

    from foldcomp_tpu_torch.codec import batch as CB
    from foldcomp_tpu_torch.codec.batch_host import pack_decode_batch_lanes
    from foldcomp_tpu_torch.kernels import fused_decode as FD

    rng = random.Random(0)
    big = [uniq[rng.choice(BENCH_LENGTHS)] for _ in range(entries)]
    t0 = time.perf_counter()
    arrays, metas = pack_decode_batch_lanes(big)
    t1 = time.perf_counter()
    cls_arrays, cls_metas = CB.pack_decode_wire(big, False, wclass="auto")
    host_s = {"pack": t1 - t0, "pack_and_split": time.perf_counter() - t1}
    if "classes" not in cls_arrays:
        raise AssertionError(f"B={entries}: the auto rule made no classes")
    forms = {"single": CB.arrays_to_torch(arrays, dev),
             "classed": CB.arrays_to_torch(cls_arrays, dev)}
    d = hold_classes(f"B={entries}", forms["classed"], 2, err)

    def decode(form):
        return CB._seg_decode_arrays(forms[form], 2)

    # every protein's rows through its own pack's metas
    seg = arrays["seg_records"].shape[1]
    idx = {"single": np.concatenate([m.lane_of * seg + m.rec_of
                                     for m in metas]),
           "classed": np.concatenate([m.lane_of for m in cls_metas])}
    rows = {}
    for form in forms:
        off, ca = decode(form)
        i = torch.from_numpy(idx[form]).to(dev)
        rows[form] = (off.reshape(-1, 42)[i], ca.reshape(-1, 3)[i])
        del off, ca
    n_rows = rows["single"][0].shape[0]
    diff_rows = int(((rows["single"][0] != rows["classed"][0]).any(1)
                     | (rows["single"][1] != rows["classed"][1]).any(1))
                    .sum().item())
    if diff_rows:
        raise AssertionError(f"B={entries}: {diff_rows} of {n_rows} rows "
                             "differ between the classed and single decode")
    del rows

    dec = {"single": [], "classed": []}
    xfer = {"single": [], "classed": []}
    mem = {}
    slots = {}
    for form in ("single", "classed", "classed", "single"):
        dec[form].append(cuda_ms(torch, lambda: decode(form), 10))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs = decode(form)
        torch.cuda.synchronize()
        mem[form] = torch.cuda.max_memory_allocated() - base
        slots[form] = outs[0].shape[0] * outs[0].shape[1]
        dt, nbytes = d2h(outs)
        xfer[form].append({"seconds": dt, "bytes": nbytes,
                           "mb_per_s": nbytes / dt / 1e6})
        del outs

    launches = {}
    for form in forms:
        FD.reset_launch_counts()
        decode(form)
        torch.cuda.synchronize()
        launches[form] = FD.launch_counts()

    # k1 over the classes in one launch, and the same kernel launched once
    # a class with a one-entry table each, in turns; then each class's k2
    # and k3 alone
    args, prs, bases = class_inputs(forms["classed"])
    prev, nl_outs = forms["classed"]["prev_idx"], forms["classed"]["nl_outs"]
    # k0 over the classed pack in one launch against class_prep +
    # lane_order a class (class_inputs' prs)
    segm = forms["classed"]["classes"]["segm"]
    k0_check = prep_diff(f"B={entries} classed", FD.prep(
        [tuple(a[i] for a in args[:6]) + (segm[i],)
         for i in range(len(prs))]), prs, err)
    tails_g = k1_classed(prs, bases)
    tails_c = torch.empty_like(tails_g)
    k1_each = [lambda pr=pr, i=i: FD.tails(
        pr["recs"], pr["fwd9"], *pr["lane"], order=pr["order"],
        out=tails_c[:, bases[i]:bases[i + 1]]) for i, pr in enumerate(prs)]

    def k1_per_class():
        for fn in k1_each:
            fn()

    k1_per_class()
    if not torch.equal(tails_g, tails_c):
        raise AssertionError(f"B={entries}: k1 in one launch and once a "
                             "class differ")
    k1_runs = {"one_launch": [], "per_class": []}
    for form, fn in (("one_launch", lambda: k1_classed(prs, bases, tails_g)),
                     ("per_class", k1_per_class),
                     ("per_class", k1_per_class),
                     ("one_launch", lambda: k1_classed(prs, bases, tails_g))):
        k1_runs[form].append(cuda_ms(torch, fn, 20))
    # k2 the same way: one launch over every class, and once a class
    k2_in = k2_inputs(prs, bases, prev, tails_g)
    k2_one = FD.backbone_classes(k2_in, tails_g)
    for c, one in zip(k2_in, k2_one):
        each = FD.backbone_classes([c], tails_g)[0]
        if not all(torch.equal(a, b) for a, b in zip(
                owned_rows(one.rows(), c[4]),
                owned_rows(each.rows(), c[4]))):
            raise AssertionError(f"B={entries}: k2 in one launch and once a "
                                 f"class differ (SEG {c[0].shape[1]})")
    del k2_one, each

    def k2_per_class():
        for c in k2_in:
            FD.backbone_classes([c], tails_g)

    k2_runs = {"one_launch": [], "per_class": []}
    for form, fn in (("one_launch",
                      lambda: FD.backbone_classes(k2_in, tails_g)),
                     ("per_class", k2_per_class),
                     ("per_class", k2_per_class),
                     ("one_launch",
                      lambda: FD.backbone_classes(k2_in, tails_g))):
        k2_runs[form].append(cuda_ms(torch, fn, 20))
    per_class = []
    for i, pr in enumerate(prs):
        def k2(pr=pr, i=i):
            return FD.backbone(pr["recs"], tails_g, pr["fwd9"], pr["isf"],
                               *pr["lane"], order=pr["order"],
                               prev=prev[bases[i]:bases[i + 1]])
        bb = k2()

        def k3(pr=pr, bb=bb, i=i):
            return FD.sidechain(bb, pr["code"], pr["sct"], nl_outs[i],
                                seg_m=pr["segm"])
        t = {k: min(cuda_ms(torch, fn, 10), cuda_ms(torch, fn, 10))
             for k, fn in (("k1", k1_each[i]), ("k2", k2), ("k3", k3))}
        per_class.append(dict(seg=int(pr["recs"].shape[1]),
                              lanes=int(pr["recs"].shape[2]),
                              nl_out=nl_outs[i],
                              rows=int(pr["recs"].shape[1]) * nl_outs[i],
                              **{f"{k}_ms": v for k, v in t.items()}))
        del bb
    del tails_g, tails_c, k1_each, k2_in, args, prs
    ms = {f: min(v) for f, v in dec.items()}
    k1_ms = {f: min(v) for f, v in k1_runs.items()}
    k2_ms = {f: min(v) for f, v in k2_runs.items()}
    kernels_ms = k1_ms["one_launch"] + k2_ms["one_launch"] + sum(
        c["k3_ms"] for c in per_class)
    emit("wclass", part="device", gpu=card, entries=len(big),
         classes=len(per_class), class_seg=[c["seg"] for c in per_class],
         host_seconds=host_s, kernel_vs_plain=d,
         rows_compared=n_rows, rows_differing=diff_rows, slots=slots,
         out_bytes={f: 96 * n for f, n in slots.items()}, d2h=xfer,
         device_decode_ms=ms, device_decode_runs_ms=dec,
         k1_classed_ms=k1_ms, k1_classed_runs_ms=k1_runs,
         k2_classed_ms=k2_ms, k2_classed_runs_ms=k2_runs,
         per_class=per_class, k0_vs_plain=k0_check,
         classed_kernels_ms=kernels_ms,
         classed_glue_ms=ms["classed"] - kernels_ms,
         peak_device_bytes=mem, launches=launches,
         k2_backbone_ptxas=k2_occupancy())
    if any(launches[f][k] != 1 for f in ("classed", "single")
           for k in ("prep", "k1", "k2")) or \
            launches["classed"]["k2_classes"] != len(per_class) or \
            launches["single"]["k2_classes"] != 1 or \
            any(launches[f]["k3_staged"] != launches[f]["k3"]
                or launches[f]["k3"] != launches[f]["k2_classes"]
                for f in forms):
        raise AssertionError(f"B={entries}: k0, k1, k2 and k3 launches "
                             f"{launches}")
    return ms


# the registers of an SM, and its resident threads
SM_REGISTERS = 65536
SM_THREADS = 2048


def k2_occupancy():
    """k2_backbone's ptxas report from this run's build, with the blocks
    of 128 threads an SM holds at its registers (allocated 8 a thread at
    a time). Raises below 7 blocks, the occupancy its walk is tuned at,
    or on a spill; None where the library was built before this
    process."""
    from foldcomp_tpu_torch.kernels import build
    if build.BUILD_LOG is None:
        return None
    rep = ptxas_report(build.BUILD_LOG)["k2_backbone"]
    regs = -(-rep["registers"] // 8) * 8
    rep["blocks_per_sm"] = min(SM_REGISTERS // (regs * 128),
                               SM_THREADS // 128)
    if rep["blocks_per_sm"] < 7 or rep.get("spill_stores"):
        raise AssertionError(f"k2_backbone: {rep}")
    return rep


def wclass_cli(db, out_auto, names, card, auto_wall):
    """Phase 14, CLI: `decompress --fast` on phase 5's database in a
    subprocess with FOLDCOMP_TPU_WCLASS=1, =0 and =1 again, so that with
    phase 5's run (auto, which at cli.FAST_BATCH splits no batch of this
    corpus) the modes run auto, 1, 0, 1; every output of every run
    byte-identical, by name, to phase 5's."""
    from foldcomp_tpu_torch.bench import read_entries
    want = {nm: data for nm, data in read_entries(out_auto).values()}
    if len(want) != len(names):
        raise AssertionError(f"phase 5 wrote {len(want)} of {len(names)}")
    walls = {"auto": [auto_wall], "0": [], "1": []}
    differ = {"auto": 0, "0": 0, "1": 0}
    for mode in ("1", "0", "1"):
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   FOLDCOMP_TPU_WCLASS=mode)
        env.pop("FOLDCOMP_TORCH_DEVICE", None)
        out = out_auto.parent / f"pdb_db_wclass_{mode}"
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "foldcomp_tpu_torch", "decompress",
             "--fast", str(db), str(out), "--db"], cwd=str(REPO), env=env,
            capture_output=True, text=True, timeout=600)
        walls[mode].append(time.perf_counter() - t0)
        if r.returncode != 0:
            raise AssertionError(f"WCLASS={mode} CLI rc {r.returncode}: "
                                 f"{r.stderr[-4000:]}")
        got = {nm: data for nm, data in read_entries(out).values()}
        differ[mode] += sum(got.get(nm) != want[nm] for nm in names) \
            + (len(got) != len(names))
        for p in out.parent.glob(out.name + "*"):
            p.unlink()
    emit("wclass", part="e2e", gpu=card, entries=len(names),
         command="FOLDCOMP_TPU_WCLASS=0|1 python -m foldcomp_tpu_torch "
                 "decompress --fast <db> <out> --db",
         order=["auto", "1", "0", "1"], wall_seconds=walls,
         outputs_compared=len(names), outputs_differing=differ)
    if any(differ.values()):
        raise AssertionError(f"WCLASS=0|1 vs auto: outputs differ {differ}")


def db_jobs(work, uniq, card, pdb_gate):
    """Phase 12: warmup, then db -> db decompress and compress through the
    hybrid CPU + GPU scheduler (no flag) against the exact route (the
    decompressed entries held by phase 5's `pdb_gate`), then each mode in
    this process with the launch counters around it, on a database of
    cli.FAST_DEFAULT_MIN + 1 entries (phase 5's draw, extended): a no-flag
    db job of fewer runs on native workers only.
    -> {"decompress": launch counts, "compress": launch counts}."""
    import torch

    from foldcomp_tpu_torch import bench, cli
    from foldcomp_tpu_torch.backend import cache_dir
    from foldcomp_tpu_torch.bench import read_entries
    from foldcomp_tpu_torch.kernels import build
    from foldcomp_tpu_torch.kernels import fused_decode as FD
    from foldcomp_tpu_torch.kernels import fused_encode as FE

    picks = bench.draw_lengths(cli.FAST_DEFAULT_MIN + 1, seed=1)
    db = work / "fcz_db_hybrid"
    bench.write_fcz_db(db, uniq, picks)

    threads = min(8, os.cpu_count() or 1)
    residues = sum(uniq[n].n_residue for n in picks)
    home = work / "home"
    home.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(home))
    for k in ("FOLDCOMP_TORCH_DEVICE", "FOLDCOMP_TPU_WARMUP_EST",
              "FOLDCOMP_TPU_TORCH_CACHE"):
        env.pop(k, None)
    seeded = pathlib.Path(build.seed_cache(env))
    link, mbs = cli._probe_info()
    emit("db_jobs", part="setup", threads=threads, cpu_count=os.cpu_count(),
         probe=link, probe_mbs=mbs, batch_size=cli.fast_batch_size(),
         entries=len(picks), residues=residues, gpu=card)

    def run(args, **extra):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "foldcomp_tpu_torch", *args],
            cwd=str(REPO), env=dict(env, **extra), capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"{args} rc {r.returncode}: "
                                 f"{r.stderr[-4000:]}")
        return wall, r

    def hybrid_lines(err):
        """The route's [Info] line and the device stream's entry count."""
        info = [ln for ln in err.splitlines()
                if ln.startswith("[Info] hybrid")]
        if len(info) != 2 or "device stream on cuda" not in info[0] or \
                "the device stream finished" not in info[1]:
            raise AssertionError(f"no device stream: {err[-2000:]}")
        return info[0], int(info[1].split("finished ")[1].split()[0])

    # -- warmup, its estimate in the port's own cache only (beside the
    # kernel library seeded there)
    wall, r = run(["warmup", str(db)])
    wfile = pathlib.Path(cache_dir(env)) / "device_warmup.json"
    warmup_s = json.loads(wfile.read_text())["warmup_s"]
    strays = sorted(str(q.relative_to(home)) for q in home.rglob("*")
                    if q.is_file() and q not in (wfile, seeded))
    lines = r.stdout.strip().splitlines()
    if (home / ".cache" / "foldcomp_tpu_jax").exists() or strays or \
            "(built in " in lines[-2] or str(wfile) not in lines[-1]:
        raise AssertionError(f"warmup wrote {strays}: {lines[-2:]}")
    emit("db_jobs", part="warmup", wall_seconds=wall, warmup_s=warmup_s,
         file=str(wfile.relative_to(home)), lines=lines[-2:], gpu=card)

    # -- decompress: the exact route, then the hybrid as shipped and eager
    want_keys = {i: f"e{i}_L{n}" for i, n in enumerate(picks)}
    exact_wall, _ = run(["decompress", "--exact", "-t", str(threads),
                         str(db), str(work / "pdb_exact"), "--db"])
    exact = read_entries(work / "pdb_exact")
    if {k: nm for k, (nm, _) in exact.items()} != want_keys:
        raise AssertionError("exact decompress: keys or names differ")
    for label, extra in (("guarded", {}),
                         ("eager", {"FOLDCOMP_TPU_WARMUP_EST": "0"})):
        out = work / f"pdb_hybrid_{label}"
        wall, r = run(["decompress", "-t", str(threads), str(db), str(out),
                       "--db"], **extra)
        line, n_dev = hybrid_lines(r.stderr)
        got = read_entries(out)
        if {k: nm for k, (nm, _) in got.items()} != want_keys:
            raise AssertionError(f"hybrid decompress {label}: keys or "
                                 "names differ")
        differ = [k for k, (_, d) in got.items() if d != exact[k][1]]
        bad, worst = pdb_gate.check(f"hybrid decompress {label}", got, exact)
        if bad:
            raise AssertionError("; ".join(bad[:5]))
        emit("db_jobs", part="decompress", mode=label, info=line,
             wall_seconds=wall, residues_per_s=residues / wall,
             entries=len(got), device_entries=n_dev,
             not_identical_to_exact=len(differ),
             worst_dev_over_ref_A=worst, exact_route_wall_seconds=exact_wall,
             threads=threads, gpu=card)
        for q in work.glob(out.name + "*"):
            q.unlink()

    # -- compress the exact route's PDB database the same ways
    pdb_db = work / "pdb_exact"
    exact_wall, _ = run(["compress", "--exact", "-t", str(threads),
                         str(pdb_db), str(work / "fcz_exact"), "--db"])
    by_name = {nm: d for nm, d in read_entries(work / "fcz_exact").values()}
    if sorted(by_name) != sorted(want_keys.values()):
        raise AssertionError("exact compress: names differ")
    for label, extra in (("guarded", {}),
                         ("eager", {"FOLDCOMP_TPU_WARMUP_EST": "0"})):
        out = work / f"fcz_hybrid_{label}"
        wall, r = run(["compress", "-t", str(threads), str(pdb_db), str(out),
                       "--db"], **extra)
        line, n_dev = hybrid_lines(r.stderr)
        got = {nm: d for nm, d in read_entries(out).values()}
        differ = sorted(nm for nm in by_name if got.get(nm) != by_name[nm])
        emit("db_jobs", part="compress", mode=label, info=line,
             wall_seconds=wall, residues_per_s=residues / wall,
             entries=len(got), device_entries=n_dev,
             differing_entries=len(differ),
             first_differing=differ[:5], exact_route_wall_seconds=exact_wall,
             threads=threads, gpu=card)
        if differ or len(got) != len(by_name):
            raise AssertionError(f"hybrid compress {label}: {len(differ)} "
                                 f"entries differ, {len(got)} entries")
        for q in work.glob(out.name + "*"):
            q.unlink()

    # -- each mode in this process, the launch counters around it. One
    # CPU worker and 512-entry batches: with T workers the native codec
    # can drain the list before the device stream has parsed one 2048-entry
    # batch of PDB text, and the ragged tail goes to the native mop-up.
    counts = {}
    saved = {k: os.environ.get(k)
             for k in ("FOLDCOMP_TPU_WARMUP_EST", "FOLDCOMP_TPU_BATCH")}
    os.environ.update(FOLDCOMP_TPU_WARMUP_EST="0", FOLDCOMP_TPU_BATCH="512")
    try:
        for mode, src in (("decompress", db), ("compress", pdb_db)):
            out = work / f"{mode}_main"
            FD.reset_launch_counts()
            FE.reset_launch_counts()
            t0 = time.perf_counter()
            err = io.StringIO()
            with contextlib.redirect_stdout(sys.stderr), \
                    contextlib.redirect_stderr(err):
                rc = cli.main([mode, "-t", "1", str(src), str(out), "--db"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = counts[mode] = {**FD.launch_counts(), **FE.launch_counts()}
            print(err.getvalue(), file=sys.stderr, end="")
            n_out = len(read_entries(out))
            emit("db_jobs", part="main_path", mode=mode, rc=rc, launches=c,
                 device_entries=hybrid_lines(err.getvalue())[1],
                 wall_seconds=wall, residues_per_s=residues / wall,
                 entries=n_out, threads=1, batch_size=512, gpu=card)
            ok = (c["k1"] > 0 and (c["k2"] > 0 and c["k3"] > 0
                                   or c["k2_bb"] > 0)) \
                if mode == "decompress" else c["k4"] > 0
            if rc != 0 or not ok or n_out != len(picks):
                raise AssertionError(f"hybrid {mode} in process: rc {rc}, "
                                     f"{n_out} entries, launches {c}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return counts


def multi_device(card):
    """Phase 13: dryrun_multichip at 2048 entries a rank of the 8 lengths,
    then measure_scaling over 1, 2, 4 and 8 ranks, as many as the cards.
    Raises if a rank fails or a check does not hold."""
    import torch

    from foldcomp_tpu_torch.dryrun import dryrun_multichip
    from foldcomp_tpu_torch.parallel.scaling import measure_scaling

    count = torch.cuda.device_count()
    t0 = time.perf_counter()
    out = dryrun_multichip(entries_per_rank=ENC_BATCH, lengths=BENCH_LENGTHS,
                           timeout=300)
    emit("multi_device", part="dryrun", gpu=card, device_count=count,
         wall_seconds=time.perf_counter() - t0, **out)
    t0 = time.perf_counter()
    counts = [n for n in (1, 2, 4, 8) if n <= count]
    rows = measure_scaling(counts, b_per_device=ENC_BATCH,
                           lengths=BENCH_LENGTHS, iters=2)
    emit("multi_device", part="scaling", gpu=card, b_per_device=ENC_BATCH,
         iters=2, wall_seconds=time.perf_counter() - t0,
         rows=[dict(devices=n, residues_per_s=thr,
                    residues_per_s_per_device=thr / n, linearity=lin)
               for n, thr, lin in rows])


def bench_phase(card):
    """Phase 15: `python3 -m foldcomp_tpu_torch.bench --quick` in a
    subprocess, its line parsed and held (every key of bench.KEYS, the
    parity check passed, no gate failed; hybrid_ge_native is not computed
    at the quick size); then dryrun.entry() on the card against the same
    entry through the plain versions on the card (bit-equal) and on the
    CPU (TOL_I16, TOL_A), on the rows each lane owns."""
    import torch

    from foldcomp_tpu_torch import bench
    from foldcomp_tpu_torch.dryrun import entry
    from foldcomp_tpu_torch.kernels import build

    work = pathlib.Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=REPO))
    try:
        env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(work))
        env.pop("FOLDCOMP_TORCH_DEVICE", None)
        env.pop("FOLDCOMP_TPU_TORCH_CACHE", None)
        build.seed_cache(env)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "foldcomp_tpu_torch.bench", "--quick",
             "--out-dir", str(work)], cwd=str(REPO), env=env,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lines = r.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        raise AssertionError(f"bench rc {r.returncode}, no JSON line: "
                             f"{r.stdout[-2000:]}{r.stderr[-4000:]}")
    missing = [k for k in bench.KEYS if k not in line]
    emit("bench", part="quick", gpu=card, rc=r.returncode,
         wall_seconds=wall, stdout_lines=len(lines), missing_keys=missing,
         line=line)
    if r.returncode != 0 or len(lines) != 1 or missing or \
            line["device_parity_ok"] is not True or line["gates_failed"]:
        raise AssertionError(f"bench rc {r.returncode}, {len(lines)} lines, "
                             f"missing {missing}, gates "
                             f"{line.get('gates_failed')}: "
                             f"{r.stderr[-4000:]}")

    fn, args = entry("cuda")
    off, ca = fn(*args)
    nl_out = fn.keywords["nl_out"]
    off_p, ca_p = plain_decode(dict(zip(DECODE_KEYS, args)), nl_out)
    fn_c, args_c = entry("cpu")
    off_c, ca_c = fn_c(*args_c)
    torch.cuda.synchronize()
    own = torch.arange(off_c.shape[1])[None, :] \
        < args_c[-1][:nl_out, None]
    diffs = {}
    for label, (o, c) in (("card_plain", (off_p.cpu(), ca_p.cpu())),
                          ("cpu_plain", (off_c, ca_c))):
        d_off = (off.cpu().int() - o.int()).abs()[own]
        d_ca = (ca.cpu() - c).abs()[own]
        diffs[label] = dict(off_units_max=d_off.max().item(),
                            ca_A_max=d_ca.max().item(),
                            off_differing=int((d_off != 0).sum()),
                            ca_differing=int((d_ca != 0).sum()))
    emit("bench", part="entry", gpu=card, nl_out=nl_out,
         shapes=[list(off.shape), list(ca.shape)], owned_rows=int(own.sum()),
         vs=diffs, tol={"f32_A": TOL_A, "i16_units": TOL_I16})
    worst = max(diffs.values(), key=lambda d: (d["off_units_max"],
                                               d["ca_A_max"]))
    if diffs["card_plain"]["off_units_max"] or \
            diffs["card_plain"]["ca_A_max"] or \
            not (worst["off_units_max"] <= TOL_I16
                 and worst["ca_A_max"] <= TOL_A):
        raise AssertionError(f"dryrun.entry() on the card against its "
                             f"plain version: {diffs}")


# a no-flag decompress in a subprocess; then the launch counters of its
# process (phase 16)
_ROUTED_CHILD = """\
import json, sys
from foldcomp_tpu_torch import cli
from foldcomp_tpu_torch.kernels import fused_decode as FD
rc = cli.main(sys.argv[1:])
print(json.dumps({"rc": rc, "launches": FD.launch_counts()}))
"""


def routing(card, uniq):
    """Phase 16: the routing constants on this card, with no FOLDCOMP_TPU_*
    setting. fast_batch_size() under the probe's real answer is its step
    for that rate (cli.FAST_BATCH on a healthy link); a no-flag
    `decompress <dir> <out> --db` of cli.FAST_DEFAULT_MIN + 1 .fcz files
    (a directory in, so run_decompress routes it, and one database out)
    in a subprocess takes the device route where the probe finds an ok link
    (its [Info] line, k1, k2 and k3 or k2_bb launched), 64 sampled outputs
    held to phase 5's bound; pack_decode_wire on the first batch of
    cli.FAST_BATCH entries of phase 5's draw, as the stream sorts it,
    takes classes only where the auto rule's lane count and savings say;
    EndgameGuard.cold_horizon() in a fresh process with no warmup file is
    hybrid.COLD_HORIZON_S."""
    from foldcomp_tpu_torch import bench, cli
    from foldcomp_tpu_torch.codec import batch as CB
    from foldcomp_tpu_torch.codec import batch_host as BH
    from foldcomp_tpu_torch.codec.decoder import decode as decode_exact
    from foldcomp_tpu_torch.codec.fcz import serialize
    from foldcomp_tpu_torch.kernels import build
    from foldcomp_tpu_torch.parallel import hybrid

    t_start = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FOLDCOMP_TPU_")
           and k != "FOLDCOMP_TORCH_DEVICE"}
    env["PYTHONPATH"] = str(REPO)
    build.seed_cache(env)
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("FOLDCOMP_TPU_")}
    try:
        link, mbs = cli._probe_info()
        bsz = cli.fast_batch_size()
    finally:
        os.environ.update(saved)
    step = (cli.FAST_BATCH if mbs >= 1000.0 else 512 if mbs >= 300.0
            else cli._SLOW_LINK_BATCH) if link == "ok" \
        else cli._SLOW_LINK_BATCH
    if bsz != step:
        raise AssertionError(f"fast_batch_size() {bsz} at {link} {mbs} "
                             f"MB/s, the table's step {step}")

    work = pathlib.Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=REPO))
    try:
        n = cli.FAST_DEFAULT_MIN + 1
        picks = bench.draw_lengths(n, seed=1)
        src, out = work / "fczs", work / "pdb_db"
        src.mkdir()
        blobs = {x: serialize(f) for x, f in uniq.items()}
        for i, x in enumerate(picks):
            (src / f"e{i}_L{x}.fcz").write_bytes(blobs[x])
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", _ROUTED_CHILD,
                            "decompress", str(src), str(out), "--db"],
                           cwd=str(REPO), env=env, capture_output=True,
                           text=True, timeout=600)
        wall = time.perf_counter() - t0
        try:
            rec = json.loads(r.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            rec = {"rc": None, "launches": {}}
        if r.returncode != 0 or rec["rc"] != 0:
            raise AssertionError(f"no-flag decompress rc {r.returncode}: "
                                 f"{r.stderr[-4000:]}")
        info = [ln for ln in r.stderr.splitlines() if ln.startswith("[Info]")]
        device = any("GPU detected (link ok)" in ln for ln in info)
        # the count, then 64 entries drawn as PdbGate draws them, read
        # alone (the whole output is ~2.7 GB)
        from foldcomp_tpu_torch.io.db import DatabaseReader
        reader = DatabaseReader(str(out))
        try:
            keys = [reader.get_key(p) for p in range(len(reader))]
            got = {k: (reader.name_of_key(k), bytes(reader.get_data(p)))
                   for p, k in sorted(random.Random(2).sample(
                       list(enumerate(keys)), min(64, len(keys))))}
        finally:
            reader.close()
        if len(keys) != n:
            raise AssertionError(f"no-flag decompress wrote {len(keys)} of "
                                 f"{n}")
        gate = bench.PdbGate({x: decode_exact(f) for x, f in uniq.items()})
        bad, worst = gate.check("no-flag decompress", got)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lc = rec["launches"]
    launched = lc.get("k1", 0) > 0 and (
        lc.get("k2_bb", 0) > 0 or (lc.get("k2", 0) > 0 and lc.get("k3", 0) > 0))
    if bad or device != (link == "ok") or device != launched:
        raise AssertionError(f"no-flag decompress of {n}: probe {link}, "
                             f"[Info] {info}, launches {lc}, {bad[:3]}")

    batch = sorted((uniq[x] for x in bench.draw_lengths(E2E_FILES, seed=1)),
                   key=BH.seg_sort_key)[:cli.FAST_BATCH]
    lanes = sum(f.n_anchor - 1 for f in batch)
    saved = os.environ.pop("FOLDCOMP_TPU_WCLASS", None)
    try:
        arrays, _ = CB.pack_decode_wire(batch, False)
    finally:
        if saved is not None:
            os.environ["FOLDCOMP_TPU_WCLASS"] = saved
    classed = "classes" in arrays
    if lanes < BH._WCLASS_MIN_LANES and classed:
        raise AssertionError(f"{lanes} lanes < {BH._WCLASS_MIN_LANES}: "
                             "the auto rule took classes")
    if lanes >= BH._WCLASS_MIN_LANES and classed != (
            BH.split_lanes_classes(*BH.pack_decode_batch_lanes(batch),
                                   min_save=BH._WCLASS_MIN_SAVE) is not None):
        raise AssertionError("the auto rule against its savings gate")

    with tempfile.TemporaryDirectory() as home:
        h = subprocess.run(
            [sys.executable, "-c", "from foldcomp_tpu_torch.parallel.hybrid "
             "import EndgameGuard as G; print(G.cold_horizon())"],
            cwd=str(REPO), env=dict(env, HOME=home), capture_output=True,
            text=True, timeout=120)
    horizon = float(h.stdout.strip().splitlines()[-1]) \
        if h.returncode == 0 and h.stdout.strip() else None
    emit("routing", gpu=card, probe={"link": link, "mbs": mbs},
         fast_batch_size=bsz, fast_batch=cli.FAST_BATCH,
         no_flag={"files": n, "fast_default_min": cli.FAST_DEFAULT_MIN,
                  "route": "device" if device else "native", "info": info,
                  "launches": lc, "wall_seconds": wall, "sampled": 64,
                  "worst_dev_over_ref_A": worst},
         pack={"entries": len(batch), "lanes": lanes,
               "min_lanes": BH._WCLASS_MIN_LANES,
               "min_save": BH._WCLASS_MIN_SAVE, "classes": classed},
         cold_horizon={"got": horizon, "default": hybrid.COLD_HORIZON_S},
         seconds=time.perf_counter() - t_start)
    if horizon != hybrid.COLD_HORIZON_S:
        raise AssertionError(f"cold_horizon() {horizon}, default "
                             f"{hybrid.COLD_HORIZON_S}: {h.stderr[-2000:]}")


_CACHE_CHILD = """\
import json, sys
import foldcomp_tpu_torch
from foldcomp_tpu_torch import cli
from foldcomp_tpu_torch.kernels import build
from foldcomp_tpu_torch.kernels import fused_decode as FD
rc = cli.main(sys.argv[1:])
print(json.dumps({"rc": rc, "launches": FD.launch_counts(),
                  "build_seconds": build.BUILD_SECONDS,
                  "library": build.library_path(),
                  "package": foldcomp_tpu_torch.__file__}))
"""


def tree_listing(root):
    """{path under root: (size, mtime_ns)} of every file under root."""
    return {str(q.relative_to(root)): (q.stat().st_size, q.stat().st_mtime_ns)
            for q in sorted(root.rglob("*")) if q.is_file()}


def file_digest(*paths):
    import hashlib
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as fh:
            while chunk := fh.read(1 << 24):
                h.update(chunk)
    return h.hexdigest()


def cache_phase(work, db, names, card, hold):
    """Phase 17: the port's user cache (kernels/build.py,
    backend.cache_dir), from a copy of the package in a scratch "site"
    directory (foldcomp_tpu_torch/ and native/, no kernels/build/; its
    libfcio.so pre-built there by native.get_lib(), the JAX package's
    rule), every step in fresh subprocesses that import that copy, with
    HOME and FOLDCOMP_TPU_TORCH_CACHE in scratch directories and no other
    FOLDCOMP_TPU_* setting. Each runs cli.main as `python -m
    foldcomp_tpu_torch` does, on phase 5's database, and prints its launch
    counts and build.BUILD_SECONDS. (2) `decompress --fast` on an empty
    cache: rc 0, k1, k2 and k3 launched, phase 5's hold, the library in
    <cache>/kernels/; (3) the same on the warm cache: no build, the same
    library file, the same output bytes; (4) four `warmup` commands
    started together on another empty cache, nvcc a wrapper that counts
    its runs: one process built, nvcc ran once a source and once to link;
    (5) that library overwritten with 4 KiB of garbage, then `decompress
    --fast`: one rebuild (nvcc's runs again), the same output bytes; then
    nvcc a stub that exits 1 and a garbage library at its name: exit 1,
    KernelBuildError's text, no output; (6) FOLDCOMP_TPU_TORCH_CACHE=0:
    the library builds in a temporary directory that is gone after the
    process, nothing under HOME, the same output bytes. After every step
    the site's package tree (names, sizes, mtimes) is as listed before
    the first."""
    from foldcomp_tpu_torch import cli
    from foldcomp_tpu_torch.backend import nvcc_path
    from foldcomp_tpu_torch.kernels import build

    t_start = time.perf_counter()
    work = work / "cache_phase"          # apart from phase 12's files
    work.mkdir()
    site = work / "site"
    skip = shutil.ignore_patterns("build", "__pycache__")
    shutil.copytree(REPO / "foldcomp_tpu_torch", site / "foldcomp_tpu_torch",
                    ignore=skip)
    shutil.copytree(REPO / "native", site / "native", ignore=skip)
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("FOLDCOMP_TPU_")
            and k != "FOLDCOMP_TORCH_DEVICE"}
    base.update(PYTHONPATH=str(site), PYTHONDONTWRITEBYTECODE="1")
    pkg = site / "foldcomp_tpu_torch"
    r = subprocess.run(
        [sys.executable, "-c", "import foldcomp_tpu_torch as p; "
         "from foldcomp_tpu_torch import native; "
         "assert native.get_lib() is not None; print(p.__file__)"],
        cwd=str(work), env=base, capture_output=True, text=True,
        timeout=300)
    if r.returncode != 0 or not r.stdout.strip().startswith(str(pkg)):
        raise AssertionError(f"site copy: {r.stdout[-500:]} "
                             f"{r.stderr[-2000:]}")
    listing = tree_listing(pkg)
    # the link probe's answer cached in TMPDIR, which the children share:
    # no step pays a cold probe
    saved = os.environ.pop("FOLDCOMP_TPU_LINK", None)
    try:
        probe = cli._probe_info()
    finally:
        if saved is not None:
            os.environ["FOLDCOMP_TPU_LINK"] = saved
    emit("cache", step="site", files=len(listing),
         libfcio="kernels/build/libfcio.so" in listing, probe=probe,
         gpu=card)

    def scratch(name):
        d = work / name
        d.mkdir()
        return d

    def child(args, env, expect_rc=0):
        """One fresh process through _CACHE_CHILD. -> (wall, its record,
        its stderr)."""
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", _CACHE_CHILD, *args],
                           cwd=str(work), env=env, capture_output=True,
                           text=True, timeout=600)
        wall = time.perf_counter() - t0
        try:
            rec = json.loads(r.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            rec = {"rc": None}
        if r.returncode != 0 or rec["rc"] != expect_rc or \
                not rec["package"].startswith(str(pkg)):
            raise AssertionError(f"{args[:2]} rc {r.returncode}/{rec['rc']}"
                                 f": {r.stderr[-4000:]}")
        if tree_listing(pkg) != listing:
            raise AssertionError(f"{args[:2]} changed the package tree")
        return wall, rec, r.stderr

    out = work / "pdb_db_cache"

    def outputs_digest():
        return file_digest(out, f"{out}.index", f"{out}.lookup")

    def decompress(env, expect_rc=0):
        for q in work.glob(out.name + "*"):
            q.unlink()
        return child(["decompress", "--fast", str(db), str(out), "--db"],
                     env, expect_rc)

    def launched(rec):
        lc = rec["launches"]
        if not all(lc.get(k, 0) > 0 for k in ("k1", "k2", "k3")):
            raise AssertionError(f"launches {lc}")
        return lc

    # -- 2. a cold cache
    cache = work / "cache"
    env = dict(base, HOME=str(scratch("home")),
               FOLDCOMP_TPU_TORCH_CACHE=str(cache))
    cold, rec, _ = decompress(env)
    lib = pathlib.Path(rec["library"])
    if rec["build_seconds"] is None or lib.parent != cache / "kernels" or \
            not lib.is_file():
        raise AssertionError(f"cold: {rec}")
    worst = hold(out, names)
    digest = outputs_digest()
    emit("cache", step="cold", wall_seconds=cold,
         build_seconds=rec["build_seconds"], launches=launched(rec),
         library=str(lib), library_bytes=lib.stat().st_size,
         package_unchanged=True, worst_dev_over_ref_A=worst, gpu=card)

    # -- 3. the same cache, warm
    inode = lib.stat().st_ino
    warm, rec, _ = decompress(env)
    if rec["build_seconds"] is not None or rec["library"] != str(lib) or \
            lib.stat().st_ino != inode or \
            outputs_digest() != digest:
        raise AssertionError(f"warm: {rec}")
    emit("cache", step="warm", wall_seconds=warm, build_seconds=None,
         launches=launched(rec), cold_less_warm_seconds=cold - warm,
         outputs_identical=True, gpu=card)

    # -- 4. four processes on a cold cache, nvcc counting its runs
    runs = work / "nvcc_runs"
    wrap = scratch("cuda_count") / "bin"
    wrap.mkdir()
    (wrap / "nvcc").write_text(f"#!/bin/sh\necho run >> {runs}\n"
                               f"exec {os.path.realpath(nvcc_path())} "
                               '"$@"\n')
    (wrap / "nvcc").chmod(0o755)
    cache4 = work / "cache4"
    env4 = dict(base, HOME=str(scratch("home4")), CUDA_HOME=str(wrap.parent),
                FOLDCOMP_TPU_TORCH_CACHE=str(cache4))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "foldcomp_tpu_torch", "warmup", str(db)],
        cwd=str(work), env=env4, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(4)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    contended = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs) or \
            tree_listing(pkg) != listing:
        raise AssertionError(f"warmup x4: {[e[-2000:] for _, e in outs]}")
    built = [o for o, _ in outs if "(built in " in o]
    n_nvcc = runs.read_text().count("run")
    libs4 = sorted((cache4 / "kernels").glob(build.PREFIX + "*.so"))
    if len(built) != 1 or n_nvcc != len(build.SOURCES) + 1 or \
            len(libs4) != 1:
        raise AssertionError(f"warmup x4: {len(built)} built, nvcc ran "
                             f"{n_nvcc} times, libraries {libs4}")
    build_s = float(built[0].split("(built in ")[1].split("s)")[0])
    emit("cache", step="contended", processes=4, how="warmup commands",
         built_by=len(built), nvcc_runs=n_nvcc, build_seconds=build_s,
         wall_seconds=contended,
         lines=[o.strip().splitlines() for o, _ in outs], gpu=card)

    # -- 5. a broken library: rebuilt once; a failing rebuild raises
    libs4[0].write_bytes(bytes(range(256)) * 16)
    broken, rec, _ = decompress(env4)
    n_re = runs.read_text().count("run") - n_nvcc
    if rec["build_seconds"] is None or n_re != len(build.SOURCES) + 1 or \
            outputs_digest() != digest:
        raise AssertionError(f"garbage library: {rec}, nvcc {n_re}")
    emit("cache", step="broken", wall_seconds=broken,
         build_seconds=rec["build_seconds"], nvcc_runs=n_re,
         launches=launched(rec), outputs_identical=True, gpu=card)
    stub = scratch("cuda_stub") / "bin"
    stub.mkdir()
    (stub / "nvcc").write_text("#!/bin/sh\necho stub nvcc: exit 1\n"
                               "exit 1\n")
    (stub / "nvcc").chmod(0o755)
    env5 = dict(env4, CUDA_HOME=str(stub.parent))
    r = subprocess.run(
        [sys.executable, "-c", "from foldcomp_tpu_torch.kernels import "
         "build; print(build.library_path())"], cwd=str(work), env=env5,
        capture_output=True, text=True, timeout=120)
    bad_lib = pathlib.Path(r.stdout.strip())
    bad_lib.parent.mkdir(parents=True, exist_ok=True)
    bad_lib.write_bytes(bytes(range(256)) * 16)
    _, rec, err = decompress(env5, expect_rc=1)
    error = [ln for ln in err.splitlines() if "KernelBuildError" in ln]
    left = sorted(q.name for q in work.glob(out.name + "*"))
    if not error or "did not load" not in err or \
            "stub nvcc: exit 1" not in err or left:
        raise AssertionError(f"failing rebuild: {err[-3000:]}, {left}")
    emit("cache", step="rebuild_fails", rc=rec["rc"], error=error[0][:300],
         outputs=left, gpu=card)

    # -- 6. the cache off
    home6 = scratch("home6")
    env6 = dict(base, HOME=str(home6), FOLDCOMP_TPU_TORCH_CACHE="0")
    off, rec, _ = decompress(env6)
    tmp_lib = pathlib.Path(rec["library"])
    under_home = sorted(str(q.relative_to(home6)) for q in home6.rglob("*"))
    kept = [q for q in under_home if "foldcomp_tpu_torch" in q
            or q.endswith("device_warmup.json") or build.PREFIX in q]
    if rec["build_seconds"] is None or tmp_lib.parent.exists() or kept or \
            outputs_digest() != digest:
        raise AssertionError(f"cache off: {rec}, under HOME {under_home}")
    for q in work.glob(out.name + "*"):
        q.unlink()
    emit("cache", step="off", wall_seconds=off,
         build_seconds=rec["build_seconds"], launches=launched(rec),
         temporary_library=str(tmp_lib), removed=True,
         under_home=under_home,
         outputs_identical=True, gpu=card,
         phase_seconds=time.perf_counter() - t_start)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of "
                                 "foldcomp_tpu_torch on one CUDA card.")
    ap.add_argument("--quick", action="store_true",
                    help="phases 1-4 and the kernel and device parts of "
                         "11 and 14 only; no kernel line, no last line")
    ap.add_argument("--encode", action="store_true",
                    help="phases 1, 7 and 9 only; no kernel line, no last "
                         "line")
    ap.add_argument("--db-jobs", action="store_true",
                    help="phases 1, 5 and 12 only; no kernel line, no last "
                         "line")
    ap.add_argument("--multi-device", action="store_true",
                    help="phases 1 and 13 only; no kernel line, no last "
                         "line")
    ap.add_argument("--bench", action="store_true",
                    help="phases 1 and 15 only; no kernel line, no last "
                         "line")
    ap.add_argument("--routing", action="store_true",
                    help="phases 1 and 16 only; no kernel line, no last "
                         "line")
    ap.add_argument("--cache", action="store_true",
                    help="phases 1, 5 and 17 only; no kernel line, no last "
                         "line")
    ap.add_argument("--ptxas", metavar="SRC",
                    help="also report ptxas resource use of this CUDA "
                         "source, compiled with the build's flags")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "foldcomp_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from foldcomp_tpu_torch import bench, cli, verify
    from foldcomp_tpu_torch.backend import cache_dir, describe
    from foldcomp_tpu_torch.codec.decoder import decode as decode_exact
    from foldcomp_tpu_torch.kernels import build
    from foldcomp_tpu_torch.kernels import fused_decode as FD
    from foldcomp_tpu_torch.kernels import fused_encode as FE

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. setup ----
    desc = describe()
    card = desc["nvidia_smi"]
    t0 = time.perf_counter()
    path = build.build()
    build.load()
    # k1's step as compiled: its float instructions give a sincosf's count
    # for every decode kernel's bound (decode_work)
    global SINCOS_OPS
    step = k1_step_sass(path)
    SINCOS_OPS = (step["float_instructions"] - K1_STEP_OTHER_OPS) / 6
    ptxas = ptxas_report(build.BUILD_LOG) \
        if build.BUILD_LOG is not None else "library built before"
    emit("setup", describe=desc, library=path, cache=cache_dir(),
         nvcc_seconds=build.BUILD_SECONDS,
         build_and_load_seconds=time.perf_counter() - t0,
         nvcc_flags=" ".join(build.NVCC_FLAGS), ptxas=ptxas,
         k1_step_sass={**step, "other_operations": K1_STEP_OTHER_OPS,
                       "sincosf_operations": SINCOS_OPS})
    # k3 reads k2's rows where k2 staged them: no kernel copies them
    if any("copy" in k for k in (ptxas if isinstance(ptxas, dict) else {})):
        raise AssertionError(f"a copy kernel in the build: {sorted(ptxas)}")
    if args.ptxas:
        emit("ptxas_of", source=args.ptxas, ptxas=ptxas_of(args.ptxas))

    if args.encode:
        encode_kernels(dev)
        encode_device(dev, card)
        return 0
    if args.multi_device:
        multi_device(card)
        return 0
    if args.bench:
        bench_phase(card)
        return 0
    if args.routing:
        routing(card, bench.mixed_corpus(BENCH_LENGTHS))
        return 0

    t0 = time.perf_counter()
    uniq = bench.mixed_corpus(BENCH_LENGTHS)
    emit("corpus", lengths=list(BENCH_LENGTHS),
         encode_seconds=time.perf_counter() - t0)

    err = {"prep": 0.0, "k1": 0.0, "k2": 0.0, "k2_bb": 0.0, "k3": 0.0}
    lean = args.db_jobs or args.cache       # phase 5, then 12 or 17
    if not lean:
        # ---- 2. kernels against plain ----
        decode_kernels(dev, uniq, err)
        emit("kernels_per_device", devices=per_device_check(),
             tol={"f32_A": TOL_A, "i16_units": TOL_I16, "k4": K4_TOL})
        torch.cuda.set_device(dev)

        # ---- 18. k0 on the card ----
        prep_tests(card)

        # ---- 3. absolute parity against the exact decoder ----
        par = verify.device_parity_check(device=dev)
        emit("parity", **par)
        if not par["parity_ok"]:
            raise AssertionError(f"parity failed: {par['failures']}")

        # ---- 4. device decode at the production batch ----
        times = device_decode(dev, card, uniq, err)
        torch.cuda.empty_cache()

        # ---- 11. the bb wire: kernels and device ----
        bb_kernels(dev, uniq, err)
        times["k2_bb"] = bb_device(dev, card, uniq, err)
        torch.cuda.empty_cache()

        # ---- 14. width classes: kernels and device ----
        class_kernels(dev, uniq, err)
        class_device(dev, card, uniq, err)
        torch.cuda.empty_cache()
        if args.quick:
            return 0

    # ---- 5. end to end through the CLI, in a subprocess ----
    work = pathlib.Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=REPO))
    try:
        picks = bench.draw_lengths(E2E_FILES, seed=1)
        db = work / "fcz_db"
        names = bench.write_fcz_db(db, uniq, picks)
        e2e_res = sum(uniq[n].n_residue for n in picks)
        out = work / "pdb_db"
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   FOLDCOMP_TPU_WCLASS="auto")
        env.pop("FOLDCOMP_TORCH_DEVICE", None)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "foldcomp_tpu_torch", "decompress",
             "--fast", str(db), str(out), "--db"], cwd=str(REPO), env=env,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"CLI rc {r.returncode}: {r.stderr[-4000:]}")
        pdb_gate = bench.PdbGate({n: decode_exact(f)
                                  for n, f in uniq.items()})

        def hold(out_db, names):
            """Every entry written; 64 sampled outputs held by the bench's
            PdbGate (the JAX reference's deviation from the exact decoder
            + the slack and the print's rounding). -> the worst excess."""
            got = bench.read_entries(out_db)
            if sorted(nm for nm, _ in got.values()) != sorted(names):
                raise AssertionError(f"{len(got)} outputs for {len(names)}")
            bad, worst = pdb_gate.check(out_db.name, got, sample=64)
            if bad:
                raise AssertionError("; ".join(bad[:5]))
            return worst

        worst = hold(out, names)
        emit("e2e", gpu=card, entries=len(picks), residues=e2e_res,
             wall_seconds=wall, residues_per_s=e2e_res / wall,
             command="python -m foldcomp_tpu_torch decompress --fast "
                     "<db> <out> --db",
             sampled=64, worst_dev_over_ref_A=worst)
        if not lean:
            # ---- 14. width classes through the CLI ----
            wclass_cli(db, out, names, card, wall)
        for p in work.glob(out.name + "*"):     # data file + index files
            p.unlink()
        if args.db_jobs:
            db_jobs(work, uniq, card, pdb_gate)
            return 0
        if args.cache:
            cache_phase(work, db, names, card, hold)
            return 0

        # ---- 6. the main path, launch counters around it ----
        # (FOLDCOMP_TPU_WCLASS as phase 5 had it, auto; the batches that
        # the rule splits launch k1 and k2 once and k3 once a class: the
        # decode calls are counted too, to know how many launches to
        # expect)
        out2 = work / "pdb_db_main"
        calls = {"single": 0, "classes": []}
        real = FD.decode_lanes

        def counted(*a, **kw):
            if len(a[0]) > 1:
                calls["classes"].append(len(a[0]))
            else:
                calls["single"] += 1
            return real(*a, **kw)

        saved = os.environ.get("FOLDCOMP_TPU_WCLASS")
        os.environ["FOLDCOMP_TPU_WCLASS"] = "auto"
        FD.decode_lanes = counted
        try:
            FD.reset_launch_counts()
            FE.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                rc = cli.main(["decompress", "--fast", str(db), str(out2),
                               "--db"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {**FD.launch_counts(), **FE.launch_counts()}
        finally:
            FD.decode_lanes = real
            if saved is None:
                os.environ.pop("FOLDCOMP_TPU_WCLASS")
            else:
                os.environ["FOLDCOMP_TPU_WCLASS"] = saved
        # k1 and k2 once a batch, k2 over every class, k3 once a class
        expect = {"k1": calls["single"] + len(calls["classes"]),
                  "k2_classes": calls["single"] + sum(calls["classes"])}
        expect["prep"] = expect["k2"] = expect["k1"]
        expect["prep_bb"] = 0           # the full wire: k0 in full mode
        expect["k3"] = expect["k2_classes"]
        expect["k3_staged"] = expect["k3"]  # every k3 on k2's staged rows
        # the batches the stream formed, replayed: which the auto rule
        # splits (its lane count and savings share)
        from foldcomp_tpu_torch import bench_routing
        from foldcomp_tpu_torch.codec import batch_host as BH
        replay = bench_routing.lane_batches([uniq[x] for x in picks],
                                            cli.fast_batch_size())
        split = sum(lanes >= BH._WCLASS_MIN_LANES
                    and saved >= BH._WCLASS_MIN_SAVE
                    for lanes, saved in replay)
        emit("main_path", rc=rc, launches=counts, wall_seconds=wall,
             residues_per_s=e2e_res / wall, gpu=card,
             batches={"single_class": calls["single"],
                      "classed": len(calls["classes"]),
                      "classes": calls["classes"],
                      "classed_by_the_rule": split,
                      "lanes": [lanes for lanes, _ in replay]},
             launches_expected=expect)
        if rc != 0 or len(calls["classes"]) != split or \
                not all(counts[k] == n for k, n in expect.items()):
            raise AssertionError(f"main path rc {rc}, launches {counts}, "
                                 f"decode calls {calls}")
        for p in work.glob(out2.name + "*"):
            p.unlink()

        # ---- 11. the bb wire through the CLI ----
        counts["k2_bb"] = bb_cli(work, db, names, card, hold)["k2_bb"]

        # ---- 12. the database jobs through the hybrid scheduler ----
        db_jobs(work, uniq, card, pdb_gate)

        # ---- 17. the port's user cache, from a copy of the package ----
        cache_phase(work, db, names, card, hold)
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir()

        # ---- 7-10. compress --fast ----
        err["k4"] = encode_kernels(dev)
        encode_parity(dev)
        times["k4"] = encode_device(dev, card)
        err["k4"] = max(err["k4"], times["k4"]["max_abs_err"])
        torch.cuda.empty_cache()
        counts["k4"] = e2e_compress(work, card, uniq)["k4"]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 13. the multi-device layers ----
    torch.cuda.empty_cache()
    multi_device(card)

    # ---- 15. the port's bench and its single-device entry ----
    torch.cuda.empty_cache()
    bench_phase(card)

    # ---- 16. the routing constants on this card ----
    routing(card, uniq)

    # no single PyTorch call computes any of these: library_ms is null
    print(json.dumps({"kernels": [
        {"name": NAMES[k], "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], "launches": counts[k],
         "max_abs_err": err[k], "ms": times[k]["ms"],
         "plain_ms": times[k]["plain_ms"],
         "bound_ms": times[k]["bound_ms"], "bound_by": times[k]["bound_by"],
         "library_ms": None} for k in NAMES]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
