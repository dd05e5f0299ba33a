#!/usr/bin/env python3
"""Smoke run of foldcomp_tpu_torch's `decompress --fast` on one CUDA card.

    python3 chip_smoke.py          (from the repository root)

Phases, one JSON line each; a failing phase raises and the exit code is
non-zero:

1. setup: the card, the toolchain, and the build of the CUDA kernels
   (kernels/csrc/fused_decode.cu, nvcc) from this checkout;
2. kernels: k1, k2 and k3 against their plain PyTorch versions on the
   card, on the same inputs: a mixed batch of 512 entries (refine_iters 1
   and 2) and a corpus with segments wider than 96 residues; offsets
   within 1 i16 unit (1 mA), f32 coordinates within 1e-3 A; then the
   whole device decode against the plain versions on every visible card
   (card 0 alone on a one-card machine), since each card holds its own copy of the kernels'
   constant tables;
3. parity: the port's decode against the exact host decoder, per protein
   no farther than the JAX reference (tests/data/torch_port_ref_dev.json)
   + 1e-3 A, or the 5 mA / RMSD gates where FOLDCOMP_REF_TEST has
   test.pdb (foldcomp_tpu_torch/verify.py);
4. device: decode of B=8192 entries of bench.py's 8 synthetic lengths
   (~4.1M residues) through the kernels and through the plain versions,
   timed with CUDA events, with each kernel's time beside its plain
   version's;
5. e2e: `python -m foldcomp_tpu_torch decompress --fast <db> <out> --db`
   on a 4096-entry FCZ database in a subprocess, timed; 64 sampled
   outputs held to the phase-3 bound;
6. main path: the same CLI entry point in this process with the kernel
   launch counters reset just before and read just after; each kernel
   must have launched.

Then the kernel summary, the card's `nvidia-smi` name and power limit,
and as the last line {"ok": true, "device": {...}}. Exits non-zero
without a CUDA device or outside a checkout of the repository.
"""
import contextlib
import json
import os
import pathlib
import random
import shutil
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
BENCH_LENGTHS = (120, 200, 280, 360, 480, 640, 840, 1080)
TOL_A = 1e-3
TOL_I16 = 1
# printed PDB coordinates carry 3 decimals: rounding adds <= 5e-4 A
PRINT_SLACK_A = 5e-4
SOURCE = "foldcomp_tpu_torch/kernels/csrc/fused_decode.cu"
REPLACES = {"k1": "foldcomp_tpu/kernels/pallas_decode.py:186",
            "k2": "foldcomp_tpu/kernels/pallas_decode.py:227",
            "k3": "foldcomp_tpu/kernels/pallas_decode.py:338"}
NAMES = {"k1": "k1_tails", "k2": "k2_backbone", "k3": "k3_sidechain"}


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


def per_device_check():
    """decode_seg_fused through the kernels against the plain versions on
    each visible CUDA device, the last device first, after device 0 has
    loaded the library: __constant__ tables are per device, and a device
    that decodes before its tables are set gets zeros. -> one dict per
    device with the maxima; raises past the tolerances."""
    import torch

    from foldcomp_tpu.codec.batch import pack_decode_batch_lanes
    from foldcomp_tpu_torch import verify
    from foldcomp_tpu_torch.codec.batch import arrays_to_torch
    from foldcomp_tpu_torch.kernels import build
    from foldcomp_tpu_torch.kernels import fused_decode as FD

    uniq = verify.synthetic_corpus(BENCH_LENGTHS[:3])
    arrays, _ = pack_decode_batch_lanes(
        [uniq[n] for n in BENCH_LENGTHS[:3] for _ in range(8)])
    keys = ("seg_records", "mins_lane", "cont_lane", "sc_codes_seg", "fwd9",
            "rev9", "is_first", "seg_m")
    nl_out = arrays["nl_out"]
    build.load(0)
    out = []
    for idx in reversed(range(torch.cuda.device_count())):
        dev = torch.device("cuda", idx)
        ta = arrays_to_torch(arrays, dev)
        ko, kc = FD.decode_seg_fused(*(ta[k] for k in keys), nl_out=nl_out)
        pr = FD.class_prep(*(ta[k] for k in keys[:6]), ta["seg_m"])
        lane = (pr["recs"], pr["blca"])
        rest = (pr["rev9"], pr["tat"], pr["mins6"], pr["cont6"])
        seeds = FD.refine_seeds(FD.tails_plain(*lane, pr["fwd9"], *rest),
                                pr["fwd9"], ta["is_first"])
        po, pc = FD.sidechain_plain(*FD.backbone_plain(*lane, seeds, *rest),
                                    pr["code"], pr["sct"], nl_out)
        own = torch.arange(ko.shape[1], device=dev)[None, :] \
            < ta["seg_m"][:nl_out, None]
        d_off = (ko.int() - po.int()).abs()[own].max().item()
        d_ca = (kc - pc).abs()[own].max().item()
        out.append({"device": idx, "name": torch.cuda.get_device_name(idx),
                    "off_units": d_off, "ca_A": d_ca})
        if not (d_off <= TOL_I16 and d_ca <= TOL_A):
            raise AssertionError(f"cuda:{idx} kernels vs plain: off {d_off} "
                                 f"units, ca {d_ca} A")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "foldcomp_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    import numpy as np

    from foldcomp_tpu.codec.batch import pack_decode_batch_lanes
    from foldcomp_tpu.codec.decoder import decode as decode_exact
    from foldcomp_tpu.codec.encoder import encode
    from foldcomp_tpu.codec.fcz import serialize
    from foldcomp_tpu.io.db import DatabaseReader, DatabaseWriter
    from foldcomp_tpu_torch import cli, verify
    from foldcomp_tpu_torch.backend import describe
    from foldcomp_tpu_torch.codec.batch import arrays_to_torch
    from foldcomp_tpu_torch.kernels import build
    from foldcomp_tpu_torch.kernels import fused_decode as FD
    from test_property_roundtrip import synthesize

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. setup ----
    desc = describe()
    card = desc["nvidia_smi"]
    t0 = time.perf_counter()
    path = build.build()
    build.load()
    emit("setup", describe=desc, library=os.path.relpath(path, REPO),
         nvcc_seconds=build.BUILD_SECONDS,
         build_and_load_seconds=time.perf_counter() - t0,
         nvcc_flags=" ".join(build.NVCC_FLAGS))

    t0 = time.perf_counter()
    uniq = verify.synthetic_corpus(BENCH_LENGTHS)
    emit("corpus", lengths=list(BENCH_LENGTHS),
         encode_seconds=time.perf_counter() - t0)

    def prep_of(fczs):
        arrays, metas = pack_decode_batch_lanes(fczs)
        ta = arrays_to_torch(arrays, dev)
        pr = FD.class_prep(ta["seg_records"], ta["mins_lane"],
                           ta["cont_lane"], ta["sc_codes_seg"], ta["fwd9"],
                           ta["rev9"], ta["seg_m"])
        return arrays, metas, ta, pr

    def lane_args(pr, seeds):
        return (pr["recs"], pr["blca"], seeds, pr["rev9"], pr["tat"],
                pr["mins6"], pr["cont6"])

    err = {"k1": 0.0, "k2": 0.0, "k3": 0.0}

    def compare(arrays, ta, pr, refine_iters):
        """Each kernel against its plain version on identical inputs;
        rows past a lane's own residues (pack padding) left out."""
        got = {}
        if refine_iters >= 2:
            tk = FD.tails(*lane_args(pr, pr["fwd9"]))
            tp = FD.tails_plain(*lane_args(pr, pr["fwd9"]))
            got["k1"] = (tk - tp).abs().max().item()
            seeds = FD.refine_seeds(tk, pr["fwd9"], ta["is_first"])
        else:
            seeds = pr["fwd9"]
        bk = FD.backbone(*lane_args(pr, seeds))
        bp = FD.backbone_plain(*lane_args(pr, seeds))
        own_rows = torch.arange(bk[0].shape[0], device=dev)[:, None] \
            < pr["tat"][None, :]
        got["k2"] = max((a - b).abs()[own_rows].max().item()
                        for a, b in zip(bk, bp))
        nl_out = arrays["nl_out"]
        ok_, ck = FD.sidechain(*bk, pr["code"], pr["sct"], nl_out)
        op, cp = FD.sidechain_plain(*bk, pr["code"], pr["sct"], nl_out)
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
        if not (d_off <= TOL_I16 and d_ca <= TOL_A):
            raise AssertionError(f"k3 vs plain: off {d_off} units, "
                                 f"ca {d_ca} A")
        for k in ("k1", "k2", "k3"):
            if k in got:
                err[k] = max(err[k], got[k])
        return got

    # ---- 2. kernels against plain ----
    rng = random.Random(0)
    mixed = [uniq[rng.choice(BENCH_LENGTHS)] for _ in range(512)]
    wide_u = [encode(synthesize(n, seed=i), anchor_threshold=200)
              for i, n in enumerate((120, 220))]
    wide = [wide_u[i % 2] for i in range(256)]
    for label, fczs in (("mixed512", mixed), ("wide", wide)):
        arrays, _, ta, pr = prep_of(fczs)
        if label == "wide" and not arrays["seg_records"].shape[1] > 96:
            raise AssertionError("wide corpus does not exceed SEG 96")
        for r in (1, 2):
            got = compare(arrays, ta, pr, r)
            torch.cuda.synchronize()
            emit("kernels", corpus=label, refine_iters=r,
                 seg=int(arrays["seg_records"].shape[1]),
                 lanes=int(arrays["seg_records"].shape[2]), max_abs=got,
                 tol={"f32_A": TOL_A, "i16_units": TOL_I16})
    emit("kernels_per_device", devices=per_device_check(),
         tol={"f32_A": TOL_A, "i16_units": TOL_I16})
    torch.cuda.set_device(dev)

    # ---- 3. absolute parity against the exact decoder ----
    par = verify.device_parity_check(device=dev)
    emit("parity", **par)
    if not par["parity_ok"]:
        raise AssertionError(f"parity failed: {par['failures']}")

    # ---- 4. device decode at the production batch ----
    rng = random.Random(0)
    big = [uniq[rng.choice(BENCH_LENGTHS)] for _ in range(8192)]
    n_res = sum(f.n_residue for f in big)
    t0 = time.perf_counter()
    arrays, _, ta, pr = prep_of(big)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    fused_args = (ta["seg_records"], ta["mins_lane"], ta["cont_lane"],
                  ta["sc_codes_seg"], ta["fwd9"], ta["rev9"],
                  ta["is_first"], ta["seg_m"])
    nl_out = arrays["nl_out"]

    def plain_decode():
        p = FD.class_prep(*fused_args[:6], ta["seg_m"])
        t = FD.tails_plain(*lane_args(p, p["fwd9"]))
        s = FD.refine_seeds(t, p["fwd9"], ta["is_first"])
        b = FD.backbone_plain(*lane_args(p, s))
        return FD.sidechain_plain(*b, p["code"], p["sct"], nl_out)

    def kernel_decode():
        return FD.decode_seg_fused(*fused_args, refine_iters=2,
                                   nl_out=nl_out)

    ms_plain_a = cuda_ms(torch, plain_decode, 2)
    ms_kern_a = cuda_ms(torch, kernel_decode, 10)
    ms_kern_b = cuda_ms(torch, kernel_decode, 10)
    ms_plain_b = cuda_ms(torch, plain_decode, 2)
    ko, kc = kernel_decode()
    po, pc = plain_decode()
    own_res = torch.arange(ko.shape[1], device=dev)[None, :] \
        < ta["seg_m"][:ko.shape[0], None]
    d_off = (ko.int() - po.int()).abs()[own_res].max().item()
    d_ca = (kc - pc).abs()[own_res].max().item()
    if not (d_off <= TOL_I16 and d_ca <= TOL_A):
        raise AssertionError(f"B=8192 kernel vs plain decode: off {d_off}, "
                             f"ca {d_ca}")
    del ko, kc, po, pc

    seeds = FD.refine_seeds(FD.tails(*lane_args(pr, pr["fwd9"])),
                            pr["fwd9"], ta["is_first"])
    bb = FD.backbone(*lane_args(pr, seeds))
    per_kernel = {
        "k1": (lambda: FD.tails(*lane_args(pr, pr["fwd9"])),
               lambda: FD.tails_plain(*lane_args(pr, pr["fwd9"]))),
        "k2": (lambda: FD.backbone(*lane_args(pr, seeds)),
               lambda: FD.backbone_plain(*lane_args(pr, seeds))),
        "k3": (lambda: FD.sidechain(*bb, pr["code"], pr["sct"], nl_out),
               lambda: FD.sidechain_plain(*bb, pr["code"], pr["sct"],
                                          nl_out)),
    }
    times = {}
    for k, (kern, plain) in per_kernel.items():
        p1 = cuda_ms(torch, plain, 2)
        k1 = cuda_ms(torch, kern, 10)
        k2 = cuda_ms(torch, kern, 10)
        p2 = cuda_ms(torch, plain, 2)
        times[k] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                    "runs_ms": [p1, k1, k2, p2]}
    del bb, seeds
    ms_kern = min(ms_kern_a, ms_kern_b)
    ms_plain = min(ms_plain_a, ms_plain_b)
    emit("device", gpu=card, entries=len(big), residues=n_res,
         seg=int(arrays["seg_records"].shape[1]),
         lanes=int(arrays["seg_records"].shape[2]), nl_out=nl_out,
         pack_and_h2d_seconds=pack_s,
         kernel_decode_ms=ms_kern, plain_decode_ms=ms_plain,
         kernel_decode_runs_ms=[ms_kern_a, ms_kern_b],
         plain_decode_runs_ms=[ms_plain_a, ms_plain_b],
         kernel_residues_per_s=n_res / (ms_kern * 1e-3),
         plain_residues_per_s=n_res / (ms_plain * 1e-3),
         kernel_vs_plain={"off_units": d_off, "ca_A": d_ca},
         per_kernel=times)
    del arrays, ta, pr, big
    torch.cuda.empty_cache()

    # ---- 5. end to end through the CLI, in a subprocess ----
    work = pathlib.Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=REPO))
    try:
        rng = random.Random(1)
        picks = [rng.choice(BENCH_LENGTHS) for _ in range(4096)]
        blobs = {n: serialize(f) for n, f in uniq.items()}
        db = work / "fcz_db"
        w = DatabaseWriter(str(db))
        for i, n in enumerate(picks):
            w.append(blobs[n], i, f"e{i}_L{n}")
        w.close()
        e2e_res = sum(uniq[n].n_residue for n in picks)
        out = work / "pdb_db"
        env = dict(os.environ, PYTHONPATH=str(REPO))
        env.pop("FOLDCOMP_TORCH_DEVICE", None)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "foldcomp_tpu_torch", "decompress",
             "--fast", str(db), str(out), "--db"], cwd=str(REPO), env=env,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"CLI rc {r.returncode}: {r.stderr[-4000:]}")
        ref = verify.load_ref_dev()
        exact = {n: np.asarray(decode_exact(f).coords)
                 for n, f in uniq.items()}
        reader = DatabaseReader(str(out))
        try:
            entries = list(reader.entries())
        finally:
            reader.close()
        if len(entries) != len(picks):
            raise AssertionError(f"{len(entries)} outputs for {len(picks)}")
        worst = 0.0
        for _, name, data in random.Random(2).sample(entries, 64):
            n = int(name.rsplit("_L", 1)[1])
            xyz = np.asarray(
                [[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])]
                 for ln in bytes(data).decode().splitlines()
                 if ln.startswith("ATOM")], np.float64)
            m = min(len(xyz), len(exact[n]))
            d = float(np.abs(xyz[:m] - exact[n][:m]).max())
            worst = max(worst, d - ref[n])
            if not d <= ref[n] + verify.REF_DEV_SLACK_A + PRINT_SLACK_A:
                raise AssertionError(f"e2e {name}: dev {d} A vs ref {ref[n]}")
        emit("e2e", gpu=card, entries=len(picks), residues=e2e_res,
             wall_seconds=wall, residues_per_s=e2e_res / wall,
             command="python -m foldcomp_tpu_torch decompress --fast "
                     "<db> <out> --db",
             sampled=64, worst_dev_over_ref_A=worst)
        for p in work.glob(out.name + "*"):     # data file + index files
            p.unlink()

        # ---- 6. the main path, launch counters around it ----
        out2 = work / "pdb_db_main"
        FD.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            rc = cli.main(["decompress", "--fast", str(db), str(out2),
                           "--db"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = FD.launch_counts()
        emit("main_path", rc=rc, launches=counts, wall_seconds=wall,
             residues_per_s=e2e_res / wall, gpu=card)
        if rc != 0 or not all(v > 0 for v in counts.values()):
            raise AssertionError(f"main path rc {rc}, launches {counts}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": [
        {"name": NAMES[k], "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": counts[k],
         "max_abs_err": err[k], "ms": times[k]["ms"],
         "plain_ms": times[k]["plain_ms"]} for k in ("k1", "k2", "k3")]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
