"""Scaling harness: residues/s per device across world sizes.

The port's counterpart of foldcomp_tpu/parallel/scaling.py. Per-protein
codec work has no cross-device communication, so scaling is gated on the
input pipeline; `measure_scaling` times the data-parallel roundtrip step
(parallel/pipeline.py, the production kernels on each rank's card) on a
mixed-length corpus at each world size, one process per rank
(parallel/dist.py spawn_ranks), and reports linearity against the
one-rank throughput.

`synthetic_batch`, `_mixed_variants`, `build_synthetic_db`,
`measure_multiprocess_scaling` and `measure_hybrid_additivity` are copies
of the JAX package's, kept line for line but for these changes: the
multiprocess workers (`_MP_WORKER`) join through init_distributed (a
gloo group over a file:// store in the work directory, CPU ranks) instead
of jax.distributed, check the rank and world size it returns, and import
foldcomp_tpu_torch; the hybrid runs start `python -m foldcomp_tpu_torch`;
both measurements take the source database (`src_db`; the default, the
reference's example_db, is found through FOLDCOMP_REF_TEST as verify.py
finds the fixtures: `reference_db`), and `measure_multiprocess_scaling`
can keep the merged database of its widest run (`merged_out`).

Run: python -m foldcomp_tpu_torch.parallel.scaling [--devices 1,2,4,8]
(the card of each rank; FOLDCOMP_TORCH_DEVICE=cpu runs the ranks on the
CPU).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def synthetic_batch(b: int, l: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    ca = np.cumsum(rng.normal(0, 1.5, (b, l, 3)), axis=1).astype(np.float32)
    atom14 = np.tile(ca[:, :, None, :], (1, 1, 14, 1))
    atom14 += rng.normal(0, 0.5, atom14.shape).astype(np.float32)
    res_code = rng.integers(0, 20, (b, l)).astype(np.int32)
    tf_ca = rng.uniform(0, 100, (b, l)).astype(np.float32)
    res_mask = np.ones((b, l), bool)
    return atom14, res_code, tf_ca, res_mask


# bench.py's mixed corpus: synthesize(n, seed=n) at these lengths
MIXED_LENGTHS = (120, 200, 280, 360, 480, 640, 840, 1080)


def mixed_protos(lengths=MIXED_LENGTHS):
    """[(atom14 [n, 14, 3], res_code [n], tf_ca [n])] of
    verify.synthesize(n, seed=n) for each length."""
    from ..codec.batch_host import fragment_to_tensors
    from ..verify import synthetic_structures

    return [fragment_to_tensors(a)[:3]
            for a in synthetic_structures(lengths).values()]


def mixed_batch(protos, b: int, start: int = 0):
    """Rows start .. start+b of the mixed corpus, entry i being
    protos[i % len(protos)], padded to the longest of protos (so that
    every slice of the corpus has one width): (atom14 f32 [b, L, 14, 3],
    res_code i32 [b, L], tf_ca f32 [b, L], res_mask bool [b, L])."""
    l = max(p[0].shape[0] for p in protos)
    k = len(protos)
    a14 = np.zeros((k, l, 14, 3), np.float32)
    rc = np.zeros((k, l), np.int32)
    tf = np.zeros((k, l), np.float32)
    mask = np.zeros((k, l), bool)
    for j, (a, r, t) in enumerate(protos):
        n = a.shape[0]
        a14[j, :n], rc[j, :n], tf[j, :n], mask[j, :n] = a, r, t, True
    pick = (start + np.arange(b)) % k
    return a14[pick], rc[pick], tf[pick], mask[pick]


def _scaling_rank(mesh, protos, b, threshold, iters):
    """One rank of measure_scaling: a warm-up step, then `iters` timed
    steps on its b entries, the ranks in step by barriers."""
    import torch
    import torch.distributed as tdist

    from .pipeline import make_roundtrip_step

    arrays = mixed_batch(protos, b, start=mesh.rank * b)
    step = make_roundtrip_step(mesh, threshold=threshold)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        if mesh.group is not None:
            tdist.barrier(group=mesh.group)

    step(*arrays)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(*arrays)
    sync()
    return dict(residues=int(arrays[3].sum()),
                seconds=(time.perf_counter() - t0) / iters)


def measure_scaling(device_counts, b_per_device: int = 64,
                    lengths=MIXED_LENGTHS, threshold: int = 25,
                    iters: int = 5, device=None):
    """Returns [(n_devices, residues_per_s, linearity)].

    One run per world size: n ranks (parallel/dist.py spawn_ranks), each
    timing make_roundtrip_step on its b_per_device entries of the mixed
    corpus; residues/s is every rank's real residues over the step time.
    device None: each rank on its own card (cuda:rank; a count above the
    host's cards is skipped, as the JAX harness skips a mesh larger than
    its devices), or the CPU where FOLDCOMP_TORCH_DEVICE=cpu asks for it;
    "cpu": every rank on the CPU."""
    import os

    import torch

    from ..backend import DEVICE_ENV, resolve_device
    from .dist import spawn_ranks

    cpu = (device or os.environ.get(DEVICE_ENV)) == "cpu"
    if not cpu:
        resolve_device("cuda")
    protos = mixed_protos(lengths)
    results = []
    base = None
    for n in device_counts:
        if not cpu and n > torch.cuda.device_count():
            continue
        ranks = spawn_ranks(_scaling_rank, n,
                            (protos, b_per_device, threshold, iters),
                            devices=["cpu"] * n if cpu else None)
        thr = sum(r["residues"] for r in ranks) / \
            max(r["seconds"] for r in ranks)
        if base is None:
            base = thr / n
        results.append((n, thr, thr / (n * base)))
    return results


def _mixed_variants(blobs, seed: int = 0):
    """Mixed-length FCZ variants from decoded source entries.

    AFDB-like length spread from ~40 to ~3x the longest source: for each
    decoded source structure emit the full chain, a 0.5 and a 0.3 N-terminal
    slice (cut on residue boundaries), and for every fourth entry a 3x tile
    (copies translated apart so geometry stays finite). Each variant is
    re-encoded ONCE; callers replicate the returned blobs."""
    import numpy as np

    from ..codec import fcz
    from ..codec.decoder import decode
    from ..codec.encoder import encode
    from ..io.structure import AtomArray

    rng = np.random.default_rng(seed)
    out = []
    for i, blob in enumerate(blobs):
        body = blob[:-1] if blob.endswith(b"\x00") else blob
        atoms = decode(fcz.parse(body))
        bounds = np.flatnonzero(np.diff(atoms.residue_index)) + 1
        bounds = np.concatenate([[0], bounds, [len(atoms)]])
        n_res = len(bounds) - 1
        variants = [atoms]
        for frac in (0.5, 0.3):
            k = max(2, int(n_res * frac))
            variants.append(atoms.slice(0, int(bounds[k])))
        if i % 4 == 0:  # a long tail: 3x tiled chain
            reps = []
            # offset reps by the residue-NUMBERING span, not the residue
            # count: sources with numbering gaps (span > n_res) would
            # otherwise overlap/reverse indices across reps and quietly
            # fall back, thinning the intended long tail
            span = (int(atoms.residue_index.max())
                    - int(atoms.residue_index.min()) + 2)
            for r in range(3):
                shift = np.asarray([80.0 * r, 0, 0], np.float32)
                reps.append(AtomArray(
                    list(atoms.atom_name), list(atoms.residue_name),
                    list(atoms.chain), atoms.atom_index.copy(),
                    atoms.residue_index + r * span,
                    atoms.coords + shift, atoms.occupancy.copy(),
                    atoms.temp_factor.copy(), atoms.title))
            tiled = AtomArray(
                sum((x.atom_name for x in reps), []),
                sum((x.residue_name for x in reps), []),
                sum((x.chain for x in reps), []),
                np.concatenate([x.atom_index for x in reps]),
                np.concatenate([x.residue_index for x in reps]),
                np.concatenate([x.coords for x in reps]),
                np.concatenate([x.occupancy for x in reps]),
                np.concatenate([x.temp_factor for x in reps]), atoms.title)
            variants.append(tiled)
        for v in variants:
            try:  # UNK/nonstandard residues can't re-encode (reference
                f = encode(v, title="")      # skips such entries too) —
            except Exception:                # keep the original blob
                out.append((blob, n_res))
                continue
            out.append((fcz.serialize(f) + b"\x00", f.n_residue))
    order = rng.permutation(len(out))
    return [out[j] for j in order]


def reference_db() -> str:
    """The reference's test database, example_db in the directory
    FOLDCOMP_REF_TEST names (the fixtures' directory, as verify.py reads
    it): the JAX package's default source of build_synthetic_db."""
    import os
    root = os.environ.get("FOLDCOMP_REF_TEST")
    if not root:
        raise FileNotFoundError("no source database: pass src_db, or set "
                                "FOLDCOMP_REF_TEST to the reference's test "
                                "directory")
    return os.path.join(root, "example_db")


def build_synthetic_db(path: str, n_entries: int, src_db: str = None,
                       mixed: bool = False, seed: int = 0):
    """Replicate a source FCZ database out to n_entries (fresh keys).

    mixed=True re-encodes sliced/tiled variants of the decoded sources
    first (lengths ~40-470 on example_db), giving the shard-imbalance
    profile of a real AFDB corpus instead of 24 near-identical lengths.
    Returns total residues across the db (for residues/s accounting).
    src_db None: reference_db()."""
    from ..codec import fcz
    from ..io.db import DatabaseReader, DatabaseWriter

    if src_db is None:
        src_db = reference_db()
    src = DatabaseReader(src_db, use_lookup=True)
    blobs = []
    for pos in range(len(src)):
        data = src.get_data(pos)
        blobs.append(bytes(data))
    src.close()
    if mixed:
        pool = _mixed_variants(blobs, seed=seed)
    else:
        pool = []
        for blob in blobs:
            body = blob[:-1] if blob.endswith(b"\x00") else blob
            pool.append((blob, fcz.parse(body).n_residue))
    w = DatabaseWriter(path)
    total_res = 0
    for i in range(n_entries):
        blob, n_res = pool[i % len(pool)]
        w.append(blob, i, f"entry{i}")
        total_res += n_res
    w.close()
    return total_res


_MP_WORKER = r'''
import os, sys, time
sys.path.insert(0, {repo!r})
if {cores!r} is not None:
    os.sched_setaffinity(0, {cores!r})
from foldcomp_tpu_torch.parallel.dist import (decompress_db_shard,
                                              init_distributed)
joined = init_distributed(init_method={coord!r}, num_processes={nproc},
                          process_id={pid}, device="cpu")
if joined != ({pid}, {nproc}):
    sys.exit(f"init_distributed gave {{joined}}")
t0 = time.perf_counter()
n = decompress_db_shard({db!r}, {out!r}, {shard_id}, {n_shards},
                        batch_size=64, fast={fast})
dt = time.perf_counter() - t0
print("SHARD", n, f"{{dt:.6f}}")
import torch.distributed
torch.distributed.destroy_process_group()
'''


def measure_multiprocess_scaling(proc_counts, n_entries: int = 2000,
                                 fast: bool = False, workdir: str = None,
                                 trials: int = 5, mixed: bool = True,
                                 pin: bool = True,
                                 src_db: str = None, merged_out: str = None):
    """End-to-end sharded decompress wall time across REAL process counts.

    Each measurement launches P python processes; every process joins the
    jax.distributed runtime (localhost coordinator), decompresses its
    entry range of a synthetic FCZ database (parse -> decode -> PDB format
    -> shard db write — the full host pipeline SURVEY.md §5 says gates
    scaling), and reports its shard wall. Throughput uses the slowest
    shard (the completion wall).

    Measurement hygiene (the r2 artifact showed ±40% swings and
    superlinear points — VERDICT r2 'what's missing' #3):
    - EQUAL WINDOWS: the db is sharded max(proc_counts) ways and a
      P-process run launches only shards 0..P-1, so every process does
      the SAME work at every count and every measurement exposes the
      same wall-clock window to shared-VM steal. (Fixed-total-work
      sharding made the 1-process wall 8x longer than the 8-process
      one; on a steal-heavy VM the long windows always caught noise and
      produced both superlinear and 0.3x artifacts.)
    - pin=True pins worker p of a P-process run to core p % ncores via
      sched_setaffinity, so P<=ncores runs are one-core-per-process and
      turbo/steal migration noise can't masquerade as scaling;
    - trials are INTERLEAVED across process counts (all counts measured
      once per sweep, `trials` sweeps) so page-cache warmth and slow VM
      phases hit every count equally, after one unmeasured warmup run;
    - the summary is the MEDIAN with IQR (peak_res_s kept as a
      secondary), not best-of.

    Returns {"per_count": {P: {"median_res_s", "iqr_res_s", "peak_res_s",
    "trials", "linearity", "per_core_eff"}}, "n_cores",
    "total_residues"}. linearity = median_P / (P * median_1);
    per_core_eff divides by the number of distinct CORES actually used
    (= min(P, ncores)), the honest denominator once P oversubscribes
    the host.

    The workers join one gloo process group of CPU ranks through
    init_distributed (a file:// store in the work directory, one per
    run). With merged_out set, the shards of every run at the largest
    process count (which covers the whole database) are merged and the
    merged database is copied to merged_out.
    """
    import itertools
    import os
    import shutil
    import statistics
    import subprocess
    import sys
    import tempfile

    # tmpfs by default: at 100k mixed entries each decompress writes a
    # multi-GB PDB shard set, and a ~130 MB/s VM disk would put a serial
    # write floor under every process count, masking the CPU scaling
    # being measured (same rationale as bench.py's /dev/shm e2e runs)
    own_workdir = workdir is None
    if own_workdir:
        base = "/dev/shm" if os.path.isdir("/dev/shm") else None
        workdir = tempfile.mkdtemp(prefix="fc_scale_", dir=base)
    db = os.path.join(workdir, "syn_db")
    total_res = build_synthetic_db(db, n_entries, src_db=src_db,
                                   mixed=mixed)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # pin to cores from the ACTUAL affinity mask — under a cgroup/CI mask
    # like {2,5,7}, core IDs are not contiguous 0..n-1 and pinning to
    # [pid % n] would land outside the allowed set and kill the worker
    avail_cores = sorted(os.sched_getaffinity(0))
    n_cores = len(avail_cores)

    n_shards = max(proc_counts)
    stores = itertools.count()

    def run_once(p_count):
        out = os.path.join(workdir, f"out_p{p_count}")
        coord = "file://" + os.path.join(workdir,
                                         f"store_{next(stores)}")
        env = dict(os.environ)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        procs = []
        for pid in range(p_count):
            cores = [avail_cores[pid % n_cores]] if pin else None
            code = _MP_WORKER.format(repo=repo, coord=coord, nproc=p_count,
                                     pid=pid, shard_id=pid,
                                     n_shards=n_shards, db=db, out=out,
                                     fast=fast, cores=cores)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env))
        walls = []
        for pr in procs:
            out_s, err_s = pr.communicate(timeout=900)
            if pr.returncode != 0:
                raise RuntimeError(f"worker failed: {err_s[-2000:]}")
            lines = [ln for ln in out_s.splitlines()
                     if ln.startswith("SHARD")]
            if not lines:
                raise RuntimeError(
                    "worker exited 0 without a SHARD line; stdout="
                    f"{out_s[-500:]!r} stderr={err_s[-2000:]!r}")
            walls.append(float(lines[0].split()[2]))
        if merged_out and p_count == n_shards:
            from .dist import merge_shard_dbs
            merge_shard_dbs(out, n_shards)
            for suffix in ("", ".index", ".lookup", ".dbtype"):
                shutil.copyfile(out + suffix, merged_out + suffix)
        # drop the output shards right away: on tmpfs they are RAM
        for f in os.listdir(workdir):
            if f.startswith(f"out_p{p_count}"):
                path = os.path.join(workdir, f)
                (shutil.rmtree if os.path.isdir(path)
                 else os.unlink)(path)
        # shards are equal entry counts of a shuffled mixed pool, so
        # residues split evenly to ~0.5%; the run covers p/n_shards of
        # the corpus
        return total_res * (p_count / n_shards) / max(walls)

    run_once(max(proc_counts))            # warmup: page cache, pyc, jit
    samples = {p: [] for p in proc_counts}
    for _ in range(trials):
        for p_count in proc_counts:      # interleaved sweeps
            samples[p_count].append(run_once(p_count))

    def iqr(xs):
        qs = statistics.quantiles(xs, n=4) if len(xs) >= 2 else [0, 0, 0]
        return qs[2] - qs[0]

    med = {p: statistics.median(xs) for p, xs in samples.items()}
    base = med[min(proc_counts)] / min(proc_counts)
    per_count = {}
    for p in proc_counts:
        per_count[p] = {
            "median_res_s": round(med[p], 1),
            "iqr_res_s": round(iqr(samples[p]), 1),
            "peak_res_s": round(max(samples[p]), 1),
            "trials": [round(x, 1) for x in samples[p]],
            "linearity": round(med[p] / (p * base), 3),
            "per_core_eff": round(med[p] / (min(p, n_cores) * base), 3),
        }
    if own_workdir:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"per_count": per_count, "n_cores": n_cores,
            "total_residues": total_res, "n_entries": n_entries,
            "mixed": mixed, "pinned": pin, "trials": trials}


def measure_hybrid_additivity(n_native: int = 4, n_entries: int = 4096,
                              trials: int = 3, workdir: str = None,
                              src_db: str = None):
    """Hybrid-vs-parts additivity on db->db decompress (VERDICT r3 #7).

    Three configurations over the SAME synthetic db, each in a FRESH
    subprocess (bench.py round 4: in-process runs hand the parent's jax
    runtime threads a share of the CPU the native workers should get):

    - cpu_only:     `decompress --exact -t N` (hybrid scheduler, native
                    workers only)
    - device_alone: `decompress --fast` (device-only pipeline)
    - hybrid:       `decompress -t N` with the link probe forced 'ok'
                    (N native workers + the in-process device stream)

    additivity = hybrid / (cpu_only + device_alone). On a host with
    n_cores <= N the hybrid's device-stream host threads (parse, pack,
    format) necessarily displace native-worker CPU, so rows where
    N + 1 > n_cores are labeled out_of_gate — additivity there reports
    the honest measured gap, not a failure. Trials are interleaved
    across configurations; medians published with IQR."""
    import os
    import shutil
    import statistics
    import subprocess
    import sys
    import tempfile

    own_workdir = workdir is None
    if own_workdir:
        base = "/dev/shm" if os.path.isdir("/dev/shm") else None
        workdir = tempfile.mkdtemp(prefix="fc_hyb_", dir=base)
    db = os.path.join(workdir, "syn_db")
    total_res = build_synthetic_db(db, n_entries, src_db=src_db,
                                   mixed=True)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    n_cores = len(os.sched_getaffinity(0))

    def run_cli(args, extra_env=None):
        import time
        env = dict(os.environ)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env.update(extra_env or {})
        out = os.path.join(workdir, "out_db")
        shutil.rmtree(out, ignore_errors=True)
        for f in os.listdir(workdir):
            if f.startswith("out_db"):
                try:
                    os.unlink(os.path.join(workdir, f))
                except OSError:
                    pass
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "foldcomp_tpu_torch", "decompress",
             *args, "-y", "-d", db, out], env=env, capture_output=True,
            cwd=repo)
        wall = time.time() - t0
        if r.returncode != 0:
            raise RuntimeError(r.stderr[-2000:])
        return total_res / wall

    configs = {
        "cpu_only": (["--exact", "-t", str(n_native)], {}),
        "device_alone": (["--fast"], {}),
        "hybrid": (["-t", str(n_native)], {"FOLDCOMP_TPU_LINK": "ok"}),
    }
    for name, (args, env) in configs.items():   # warmup (jit, page cache)
        run_cli(args, env)
    samples = {k: [] for k in configs}
    for _ in range(trials):
        for name, (args, env) in configs.items():
            samples[name].append(run_cli(args, env))

    def iqr(xs):
        qs = statistics.quantiles(xs, n=4) if len(xs) >= 2 else [0, 0, 0]
        return qs[2] - qs[0]

    med = {k: statistics.median(v) for k, v in samples.items()}
    if own_workdir:
        shutil.rmtree(workdir, ignore_errors=True)
    return {
        "mode": "hybrid_additivity_decompress",
        "n_native": n_native,
        "n_cores": n_cores,
        "n_entries": n_entries,
        "total_residues": total_res,
        "per_config": {k: {"median_res_s": round(med[k], 1),
                           "iqr_res_s": round(iqr(v), 1),
                           "trials": [round(x, 1) for x in v]}
                       for k, v in samples.items()},
        "additivity": round(med["hybrid"]
                            / (med["cpu_only"] + med["device_alone"]), 3),
        "hybrid_vs_cpu_only": round(med["hybrid"] / med["cpu_only"], 3),
        # the hybrid's device stream adds host threads beyond the N
        # native workers: with N+1 > n_cores the parts cannot add up
        "out_of_gate": bool(n_native + 1 > n_cores),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--devices", default="1,2,4,8")
    p.add_argument("--batch-per-device", type=int, default=64)
    p.add_argument("--length", type=int, default=None,
                   help="one length instead of the mixed corpus's")
    p.add_argument("--multiprocess", action="store_true",
                   help="real multi-process end-to-end sharded decompress")
    p.add_argument("--procs", default="1,2,4,8")
    p.add_argument("--entries", type=int, default=2000)
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--uniform", action="store_true",
                   help="replicate sources as-is instead of mixed lengths")
    p.add_argument("--no-pin", action="store_true")
    p.add_argument("--out", default=None, help="write JSON artifact here")
    p.add_argument("--fast", action="store_true")
    p.add_argument("--hybrid-additivity", action="store_true",
                   help="hybrid vs cpu-only + device-alone additivity")
    p.add_argument("--native", type=int, default=4)
    p.add_argument("--src-db", default=None,
                   help="source FCZ database of the synthetic database "
                        "(default: example_db in FOLDCOMP_REF_TEST)")
    args = p.parse_args(argv)
    if args.hybrid_additivity:
        summary = measure_hybrid_additivity(
            n_native=args.native, n_entries=args.entries,
            trials=args.trials, src_db=args.src_db)
        text = json.dumps(summary, indent=1)
        print(text)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(text + "\n")
        return
    if args.multiprocess:
        counts = [int(x) for x in args.procs.split(",")]
        summary = measure_multiprocess_scaling(
            counts, n_entries=args.entries, fast=args.fast,
            trials=args.trials, mixed=not args.uniform, pin=not args.no_pin,
            src_db=args.src_db)
        summary["mode"] = "multiprocess_decompress"
        text = json.dumps(summary, indent=1)
        print(text)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(text + "\n")
        return
    counts = [int(x) for x in args.devices.split(",")]
    lengths = MIXED_LENGTHS if args.length is None else (args.length,)
    results = measure_scaling(counts, b_per_device=args.batch_per_device,
                              lengths=lengths)
    for n, thr, lin in results:
        print(json.dumps({"devices": n, "residues_per_s": round(thr, 1),
                          "linearity": round(lin, 3)}))


if __name__ == "__main__":
    main()
