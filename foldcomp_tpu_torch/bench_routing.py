"""The routing sweeps of the port's bench, the counterpart of
tools/exp_bsweep.py and tools/exp_bucket.py:

    python3 -m foldcomp_tpu_torch.bench --routing [--sweeps ahbcde]
                                        [--quick] [--out-dir DIR]
    python3 -m foldcomp_tpu_torch.bench --routing --from LINES.jsonl ...

They measure, on the card, the numbers by which the port routes a job:
whether a no-flag batch `decompress` takes the device (cli.FAST_DEFAULT_MIN),
the device batch (cli.FAST_BATCH, fast_batch_size), when a full-wire batch
is split into width classes (batch_host._WCLASS_MIN_LANES and
_WCLASS_MIN_SAVE, use_wclass) and the hybrid guard's cold horizon
(parallel/hybrid.py EndgameGuard.cold_horizon). Every CLI mode runs in a
fresh subprocess, as a user runs it (ROUTING_CHILD: cli.main over one
argument list, the process's peak RSS and peak device memory after it), on
the bench's mixed corpus (bench.mixed_corpus: 8 lengths 120-1080, mean ~499
residues), with outputs on disk in the work directory (`--out-dir`, else
TMPDIR), each deleted after it is timed. A sweep's runs alternate inside
each round; every figure is a median with its spread (largest less
smallest) over the rounds. Each sweep prints one JSON line (its `sweep`
key names it) carrying the card's name and power limit from
backend.describe(); then `decide` prints the table of decisions:

- a, `fast_default`: a directory of N .fcz files, N in `n_files`:
  `decompress <dir> <out>` with `--exact` and `--fast` at -t 1 and -t T
  (T = min(8, CPUs)), `--fast` at -t 1 with the link probe's cache removed
  first (`fast_cold`) and present (`fast_warm`);
- h, `hybrid`, a's db lines: the db -> db job with no flag at N + 1
  entries (the hybrid scheduler above FAST_DEFAULT_MIN) beside `--exact -t
  T`, in pairs whose order alternates, `hybrid_rounds` of them;
- b, `batch`: FOLDCOMP_TPU_BATCH in `batches`, `decompress --fast` and
  `compress --fast` on bench.e2e's `e2e_entries`-entry databases: the wall,
  the peak RSS, the peak device memory, each batch's wait for the device
  and its D2H seconds;
- c, `wclass`: `decompress --fast` at each batch of b with
  FOLDCOMP_TPU_WCLASS 0, 1 and auto (b's own run): the wall, the split's
  seconds a batch, the padded slots a residue, and each batch's lanes
  beside the share of slots its classes save (`lane_batches`, from the
  stream's windows replayed on the host);
- d, `horizon`: `horizon_procs` fresh processes each run the no-flag db
  job at -t 1 on a database of `horizon_entries` entries, large enough
  that the native worker outlasts the guard's cold horizon and the device
  stream joins, with no warmup file; the guard's own time to its first
  completion is what `finalize` persists (`warmup_s`);
- e, `probe`: the wall of `probe_calls` fresh cli._run_probe calls.

The decisions (`decide`) follow the rules each constant's comment states.
`--from` prints them from JSON lines saved by earlier runs, with no card.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

from . import bench
from .backend import cache_dir

# ROUTING_CHILD's instruments (argument `instrument`), read from the
# program's own spans (tracing.enable for the whole run): each batch's
# wait for the device apart from its D2H copies (stream.device_wait,
# encode.device_wait), its D2H seconds (stream.d2h, encode.d2h), the
# width-class split's seconds (pack.split), and each decode pack's real
# lanes, residues, padded slots and whether it took classes (the
# attributes of stream.pack)
ROUTING_CHILD = """\
import contextlib, json, resource, sys, time
t_start = time.perf_counter()
args, instrument = json.loads(sys.argv[1])
from foldcomp_tpu_torch import tracing
if instrument:
    tracing.enable()
from foldcomp_tpu_torch import cli
with contextlib.redirect_stdout(sys.stderr):
    rc = cli.main(args)
inner = time.perf_counter() - t_start
peak = None
if "torch" in sys.modules:
    import torch
    if torch.cuda.is_initialized():
        peak = torch.cuda.max_memory_allocated()
stats = {}
if instrument:
    tracing.disable()
    session = tracing.last() or tracing.Session(0, [], {}, {}, {}, False)

    def secs(*names):
        return [sp.seconds for sp in session.named(*names)]
    stats = {"wait_s": secs("stream.device_wait", "encode.device_wait"),
             "d2h_s": secs("stream.d2h", "encode.d2h"),
             "split_s": secs("pack.split"),
             "packs": [[a["lanes"], a["residues"], a["slots"], a["classed"]]
                       for a in (sp.attrs for sp in
                                 session.named("stream.pack"))]}
print(json.dumps(dict(
    rc=rc, inner_s=inner, device_peak_bytes=peak,
    maxrss_bytes=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
    **stats)))
"""


@dataclasses.dataclass(frozen=True)
class RoutingSizes:
    """The sweeps' sizes: rounds of a, b and c; pairs of h;
    processes of d; calls of e."""
    n_files: tuple = (1024, 2048, 4096, 8192)
    batches: tuple = (512, 1024, 2048, 4096, 8192)
    e2e_entries: int = 4096
    rounds: int = 3
    hybrid_rounds: int = 9
    horizon_procs: int = 5
    horizon_entries: int = 16385  # native -t 1 outlasts a cold horizon
    probe_calls: int = 5
    threads: int = 8              # -t T, T = min(this, CPUs)


FULL = RoutingSizes()
QUICK = RoutingSizes(n_files=(6, 12), batches=(4, 8), e2e_entries=16,
                     rounds=1, hybrid_rounds=1, horizon_procs=1,
                     horizon_entries=13, probe_calls=1)
SWEEPS = {"a": "fast_default", "h": "hybrid", "b": "batch", "c": "wclass",
          "d": "horizon", "e": "probe"}

# the rules' constants (decide)
RSS_LIMIT_BYTES = 8e9          # FAST_BATCH: the peak RSS it must stay under
HYBRID_GE_NATIVE = 0.97        # the no-flag db job at FAST_DEFAULT_MIN + 1
FALLBACK_FAST_MIN = 8192       # FAST_DEFAULT_MIN where no N qualifies


def summary(walls):
    """{"walls", "median", "spread"} of a run's walls over the rounds."""
    return {"walls": walls, "median": statistics.median(walls),
            "spread": max(walls) - min(walls)}


class Runner:
    """CLI children in one work directory: HOME and TMPDIR of their own
    (no warmup file, the kernel library linked into the port's cache, the
    link probe's cache where `probe_cache` says), the product's defaults
    (bench._child_env)."""

    def __init__(self, dev, wd):
        self.wd = pathlib.Path(wd)
        self.env = bench._child_env(dev, self.wd)
        tmp = self.wd / "tmp"
        tmp.mkdir(exist_ok=True)
        self.env["TMPDIR"] = str(tmp)
        self.probe_cache = tmp / f"foldcomp_tpu_torch_probe_{os.getuid()}.json"
        self.warmup_file = pathlib.Path(cache_dir(self.env)) / \
            "device_warmup.json"

    def run(self, args, out, instrument=False, env=None):
        """ROUTING_CHILD over `args`, which write `out`; `out` (a
        directory, or a database and its index files) is removed first and
        after. -> the child's record with `wall_s` (the process's, from
        this side) and `device_entries` (the hybrid's closing lines)."""
        self.clean(out)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-c", ROUTING_CHILD,
             json.dumps([[str(a) for a in args], instrument])],
            env={**self.env, **(env or {})}, cwd=str(bench.REPO),
            capture_output=True, text=True, timeout=3600)
        wall = time.perf_counter() - t0
        try:
            rec = json.loads(r.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            rec = {"rc": None}
        if r.returncode != 0 or rec["rc"] != 0:
            raise RuntimeError(f"{args}: exit {r.returncode}, rc "
                               f"{rec['rc']}: {r.stderr[-3000:]}")
        rec.update(wall_s=wall, device_entries=bench._device_entries(
            r.stderr))
        rec["n_out"] = self.count(out)
        self.clean(out)
        # progress on stderr: a run cut short keeps the runs before it
        print(json.dumps({"run": [str(a) for a in args], "env": env,
                          **{k: v for k, v in rec.items() if k != "packs"}}),
              file=sys.stderr, flush=True)
        return rec

    @staticmethod
    def count(out):
        """The entries written: files of a directory, or a database's."""
        from .io.db import DatabaseReader
        out = pathlib.Path(out)
        if out.is_dir():
            return sum(1 for _ in out.iterdir())
        if not out.exists():
            return 0
        reader = DatabaseReader(str(out))
        try:
            return len(reader)
        finally:
            reader.close()

    @staticmethod
    def clean(out):
        out = pathlib.Path(out)
        if out.is_dir():
            shutil.rmtree(out)
        for p in out.parent.glob(out.name + "*"):
            if p.is_file():
                p.unlink()


def _held(rec, n, label):
    if rec["n_out"] != n:
        raise RuntimeError(f"{label}: {rec['n_out']} outputs of {n}")


def fcz_dir(path, uniq, picks):
    """A directory of one .fcz file an entry, e<i>_L<L>.fcz."""
    from .codec.fcz import serialize
    blobs = {n: serialize(f) for n, f in uniq.items()}
    path.mkdir()
    for i, n in enumerate(picks):
        (path / f"e{i}_L{n}.fcz").write_bytes(blobs[n])


def sweep_fast_default(run, uniq, rs, t):
    """Sweep a: the no-flag route's crossover."""
    wd = run.wd
    modes = {"exact_t1": ["--exact"], "fast_cold": ["--fast"],
             "fast_warm": ["--fast"], "exact_tT": ["--exact", "-t", t],
             "fast_tT": ["--fast", "-t", t]}
    walls = {m: {n: [] for n in rs.n_files} for m in modes}
    res = {}
    for n in rs.n_files:
        picks = bench.draw_lengths(n, seed=1)
        res[n] = sum(uniq[x].n_residue for x in picks)
        fcz_dir(wd / f"fcz_{n}", uniq, picks)
    out = wd / "out_dir"
    for _ in range(rs.rounds):
        for n in rs.n_files:
            for m, flags in modes.items():
                if m == "fast_cold" and run.probe_cache.exists():
                    run.probe_cache.unlink()
                rec = run.run(["decompress", *flags, wd / f"fcz_{n}", out],
                              out)
                _held(rec, n, f"{m} N={n}")
                walls[m][n].append(rec["wall_s"])
    return {"threads": int(t), "n_files": list(rs.n_files),
            "residues": res,
            "modes": {m: {n: dict(summary(w),
                                  res_s=res[n] / statistics.median(w))
                          for n, w in by_n.items()}
                      for m, by_n in walls.items()}}


def db_of(run, uniq, n):
    """The FCZ database of n entries of the corpus (draw_lengths seed 1)
    in the work directory, written once."""
    db = run.wd / f"db_{n}"
    if not db.exists():
        bench.write_fcz_db(db, uniq, bench.draw_lengths(n, seed=1))
    return db


def sweep_hybrid(run, uniq, rs, t):
    """Sweep a's db lines (letter h): the db -> db job with no flag at
    N + 1 entries beside `--exact -t T`, `hybrid_rounds` pairs, the order
    alternating, no warmup file at any run. -> {N + 1: walls, the paired
    ratios (--exact's wall over the no-flag job's), the device stream's
    entries}."""
    n_of = {}
    for n in rs.n_files:
        db, out = db_of(run, uniq, n + 1), run.wd / f"out_db_{n + 1}"
        h, e, ent = [], [], []
        for r in range(rs.hybrid_rounds):
            for mode in (("hybrid", "exact") if r % 2 == 0
                         else ("exact", "hybrid")):
                if run.warmup_file.exists():
                    run.warmup_file.unlink()
                flags = ["-t", t] if mode == "hybrid" else \
                    ["--exact", "-t", t]
                rec = run.run(["decompress", *flags, db, out, "--db"], out)
                _held(rec, n + 1, f"{mode} db N={n + 1}")
                (h if mode == "hybrid" else e).append(rec["wall_s"])
                if mode == "hybrid":
                    ent.append(sum(rec["device_entries"]))
        ratios = [x / y for x, y in zip(e, h)]
        n_of[n + 1] = {"hybrid": summary(h), "exact_tT": summary(e),
                       "device_entries": ent, "ratios": ratios,
                       "median_ratio": statistics.median(ratios)}
    return {"threads": int(t), "pairs": rs.hybrid_rounds, "n": n_of}


def lane_batches(fczs, batch):
    """Each batch decode_fcz_stream forms of `fczs` (in input order) at
    `batch` entries, bucket_window 4 (codec/batch.py decode_fcz_stream:
    windows of 4 batches sorted by seg_sort_key): [real lanes, the share of
    the padded slots its width classes save (split_lanes_classes with the
    savings gate off)]."""
    from .codec.batch_host import (pack_decode_batch_lanes, seg_sort_key,
                                   split_lanes_classes)
    out = []
    win = batch * 4
    for w0 in range(0, len(fczs), win):
        window = sorted(fczs[w0:w0 + win], key=seg_sort_key)
        for i in range(0, len(window), batch):
            b = window[i:i + batch]
            arrays, metas = pack_decode_batch_lanes(b)
            single = bench.padded_slots(arrays)
            split = split_lanes_classes(arrays, metas, min_save=-math.inf)
            classed = bench.padded_slots(split[0]) if split else single
            out.append([sum(f.n_anchor - 1 for f in b), 1 - classed / single])
    return out


def sweep_batch(run, uniq, rs, t, do_b, do_c):
    """Sweeps b and c on one pair of databases, in one loop: b's
    `decompress --fast` is c's auto run."""
    wd = run.wd
    picks = bench.draw_lengths(rs.e2e_entries, seed=1)
    n_res = sum(uniq[x].n_residue for x in picks)
    db, pdb_db = wd / "e2e_fcz", wd / "e2e_pdb"
    bench.write_fcz_db(db, uniq, picks)
    run.clean(pdb_db)
    r = subprocess.run([sys.executable, "-m", "foldcomp_tpu_torch",
                        "decompress", "--exact", "-t", t, str(db),
                        str(pdb_db), "--db"], env=run.env,
                       cwd=str(bench.REPO), capture_output=True, text=True,
                       timeout=3600)
    if r.returncode != 0:
        raise RuntimeError(f"exact decompress: {r.stderr[-3000:]}")
    out_d, out_c = wd / "b_pdb", wd / "b_fcz"
    kinds = (["decompress", "compress"] if do_b else []) + \
        (["wclass_0", "wclass_1"] if do_c else [])
    if do_c and not do_b:
        kinds.insert(0, "decompress")
    recs = {k: {b: [] for b in rs.batches} for k in kinds}
    for _ in range(rs.rounds):
        for b in rs.batches:
            for k in kinds:
                env = {"FOLDCOMP_TPU_BATCH": str(b)}
                if k.startswith("wclass_"):
                    env["FOLDCOMP_TPU_WCLASS"] = k[-1]
                if k == "compress":
                    rec = run.run(["compress", "--fast", pdb_db, out_c,
                                   "--db"], out_c, True, env)
                else:
                    rec = run.run(["decompress", "--fast", db, out_d,
                                   "--db"], out_d, True, env)
                _held(rec, rs.e2e_entries, f"{k} B={b}")
                recs[k][b].append(rec)

    def fold(rs_):
        return dict(summary([x["wall_s"] for x in rs_]),
                    maxrss_bytes=max(x["maxrss_bytes"] for x in rs_),
                    device_peak_bytes=max(x["device_peak_bytes"] or 0
                                          for x in rs_),
                    batches=len(rs_[0]["d2h_s"]),
                    wait_s=[x["wait_s"] for x in rs_],
                    d2h_s=[x["d2h_s"] for x in rs_],
                    d2h_s_median=statistics.median(
                        [d for x in rs_ for d in x["d2h_s"]]),
                    split_s=[x["split_s"] for x in rs_],
                    slots_per_res=sum(p[2] for p in rs_[0]["packs"]) / n_res
                    if rs_[0]["packs"] else None,
                    classed=[sum(p[3] for p in x["packs"]) for x in rs_])

    head = {"entries": rs.e2e_entries, "residues": n_res, "threads": int(t)}
    lines = []
    if do_b:
        lines.append(dict(head, sweep="batch", batches=list(rs.batches),
                          decompress={b: fold(recs["decompress"][b])
                                      for b in rs.batches},
                          compress={b: fold(recs["compress"][b])
                                    for b in rs.batches}))
    if do_c:
        fczs = [uniq[x] for x in picks]
        lines.append(dict(
            head, sweep="wclass", batches=list(rs.batches),
            modes={m: {b: fold(recs[k][b]) for b in rs.batches}
                   for m, k in (("0", "wclass_0"), ("1", "wclass_1"),
                                ("auto", "decompress"))},
            lane_batches={b: lane_batches(fczs, b) for b in rs.batches}))
    return lines


def sweep_horizon(run, uniq, rs):
    """Sweep d: the guard's time to its first completion in fresh
    processes, each with no warmup file, as `finalize` persists it."""
    n = rs.horizon_entries
    db, out = db_of(run, uniq, n), run.wd / "d_out"
    got, ent, walls = [], [], []
    for _ in range(rs.horizon_procs):
        if run.warmup_file.exists():
            run.warmup_file.unlink()
        rec = run.run(["decompress", "-t", "1", db, out, "--db"], out)
        _held(rec, n, "horizon")
        got.append(json.loads(run.warmup_file.read_text())["warmup_s"]
                   if run.warmup_file.exists() else None)
        ent.append(sum(rec["device_entries"]))
        walls.append(rec["wall_s"])
    seen = [x for x in got if x is not None]
    return {"entries": n, "warmup_s": got, "device_entries": ent,
            "walls": walls,
            "median": statistics.median(seen) if seen else None}


def sweep_probe(rs):
    """Sweep e: fresh cli._run_probe calls, each a subprocess."""
    from . import cli
    walls, answers = [], []
    for _ in range(rs.probe_calls):
        t0 = time.perf_counter()
        answers.append(list(cli._run_probe()))
        walls.append(time.perf_counter() - t0)
    return dict(summary(walls), answers=answers)


def _median(line, *path):
    x = line
    for p in path:
        x = x[str(p)] if isinstance(x, dict) and str(p) in x else x[p]
    return x["median"]


def decide(lines):
    """The table of decisions from the sweeps' lines (dicts; JSON keys
    are strings). -> rows {"constant", "where", "value", "rule",
    "figures"}; a constant whose sweep is missing says "not measured"."""
    by = {ln["sweep"]: ln for ln in lines}
    rows = []
    a = by.get("fast_default")
    fast_min = None
    if a:
        ns = sorted(int(n) for n in a["modes"]["fast_cold"])
        med = {m: {n: _median(a["modes"], m, n) for n in ns}
               for m in a["modes"]}
        wins = [n for n in ns if med["fast_cold"][n] < med["exact_t1"][n]]
        fast_min = wins[0] if wins else FALLBACK_FAST_MIN
        wins_t = [n for n in ns if med["fast_cold"][n] < med["exact_tT"][n]]
        hyb = by.get("hybrid", {}).get("n", {}).get(str(fast_min + 1))
        rows.append(dict(
            constant="FAST_DEFAULT_MIN", where="cli.py",
            value=fast_min,
            rule="smallest N with fast_cold < exact_t1"
                 + ("" if wins else f"; none up to {max(ns)}: "
                    f"{FALLBACK_FAST_MIN}"),
            figures={n: {m: med[m][n] for m in med} for n in ns},
            crossover_tT=wins_t[0] if wins_t else None,
            hybrid_at_min_plus_1=None if hyb is None else {
                "median_ratio": hyb["median_ratio"],
                "held": hyb["median_ratio"] >= HYBRID_GE_NATIVE,
                "device_entries": hyb["device_entries"]}))
        decided = [n for n in ns if med["fast_warm"][n] < med["exact_t1"][n]
                   <= med["fast_cold"][n]]
        rows.append(dict(
            constant="_PROBE_TTL_S, _PROBE_NONE_TTL_S", where="cli.py",
            value="kept",
            rule="kept: they measure staleness; where fast_warm < exact_t1 "
                 "<= fast_cold the probe decides the route, by cold - warm",
            figures={"probe_decides_at": decided,
                     "warm_margin_s": {n: med["exact_t1"][n]
                                       - med["fast_warm"][n]
                                       for n in decided},
                     "warm_spread_s": {n: a["modes"]["fast_warm"][str(n)]
                                       ["spread"] for n in decided},
                     "cold_less_warm_s": {n: med["fast_cold"][n]
                                          - med["fast_warm"][n]
                                          for n in ns}}))
    b = by.get("batch")
    fast_batch = None
    if b:
        bs = sorted(int(x) for x in b["decompress"])
        dec = {x: b["decompress"][str(x)] for x in bs}
        com = {x: b["compress"][str(x)] for x in bs}
        ref = com.get(2048)
        # a batch above the databases' entries is one batch of all of them:
        # the same run as B = entries, so no candidate of its own
        cands = sorted((x for x in bs if x <= b["entries"]
                        and dec[x]["maxrss_bytes"] < RSS_LIMIT_BYTES),
                       key=lambda x: dec[x]["median"])
        refused = {}
        for x in cands:
            slack = max(com[x]["spread"], ref["spread"]) if ref else 0.0
            if ref is None or com[x]["median"] <= ref["median"] + slack:
                fast_batch = x
                break
            refused[x] = "compress slower than at 2048 beyond the spread"
        rows.append(dict(
            constant="FAST_BATCH", where="cli.py", value=fast_batch,
            rule="best decompress --fast median with peak RSS < 8 GB and "
                 "compress --fast no slower than at 2048 beyond the spread",
            refused=refused,
            figures={x: {"decompress_s": dec[x]["median"],
                         "decompress_spread_s": dec[x]["spread"],
                         "compress_s": com[x]["median"],
                         "compress_spread_s": com[x]["spread"],
                         "maxrss_gb": dec[x]["maxrss_bytes"] / 1e9,
                         "device_peak_gb": dec[x]["device_peak_bytes"] / 1e9,
                         "d2h_s": dec[x]["d2h_s_median"]} for x in bs}))
    c = by.get("wclass")
    if c:
        bs = sorted(int(x) for x in c["modes"]["0"])
        m0 = {x: _median(c["modes"], "0", x) for x in bs}
        m1 = {x: _median(c["modes"], "1", x) for x in bs}
        lanes = {x: [lb[0] for lb in c["lane_batches"][str(x)]] for x in bs}
        at = fast_batch if fast_batch in bs else min(bs)
        sp = {x: max(c["modes"]["0"][str(x)]["spread"],
                     c["modes"]["1"][str(x)]["spread"]) for x in bs}
        # faster split: WCLASS=1's median below WCLASS=0's by more than
        # the larger of their spreads
        faster = [x for x in bs if m1[x] < m0[x] - sp[x]]
        slower = [x for x in bs if x not in faster]
        if faster:
            lo = max((n for x in slower for n in lanes[x]), default=0) + 1
            hi = min(n for x in faster for n in lanes[x])
            value = lo if lo <= hi else None
            rule = ("the least lane count above every batch of a batch size "
                    "where the split was not faster" if value else
                    "no lane count separates the faster batches")
        else:
            top = max(n for x in bs for n in lanes[x])
            value = -(-(top + 1) // 1024) * 1024
            rule = (f"no batch size was faster split: above the largest "
                    f"batch measured ({top} lanes; {max(lanes[at])} at "
                    f"B={at}), rounded up to 1024")
        rows.append(dict(
            constant="_WCLASS_MIN_LANES", where="codec/batch_host.py",
            value=value, rule=rule, faster_split=faster,
            figures={x: {"wclass_0_s": m0[x], "wclass_1_s": m1[x],
                         "auto_s": _median(c["modes"], "auto", x),
                         "lanes": lanes[x],
                         "saved": [lb[1] for lb in c["lane_batches"][str(x)]],
                         "split_s": c["modes"]["1"][str(x)]["split_s"],
                         "slots_per_res": {
                             m: c["modes"][m][str(x)]["slots_per_res"]
                             for m in ("0", "1", "auto")}}
                     for x in bs}))
    d = by.get("horizon")
    if d:
        rows.append(dict(
            constant="EndgameGuard.cold_horizon default",
            where="parallel/hybrid.py",
            value=None if d["median"] is None
            else math.ceil(d["median"] * 2) / 2,
            rule="the median of the guard's first completion, rounded up "
                 "to 0.5 s",
            figures={"warmup_s": d["warmup_s"],
                     "device_entries": d["device_entries"]}))
    e = by.get("probe")
    if e:
        rows.append(dict(constant="_run_probe wall", where="cli.py",
                         value=e["median"], rule="measured, decides nothing",
                         figures={"walls": e["walls"],
                                  "answers": e["answers"]}))
    return rows


def _emit(line, stream):
    print(json.dumps(line), file=stream, flush=True)


def run(device=None, sizes=FULL, sweeps="ahbcde", out_dir=None,
        stream=None) -> int:
    """Run the sweeps named in `sweeps` (letters of SWEEPS), print a JSON
    line each and then the decisions' line. Raises
    backend.DeviceUnavailable without the card asked for."""
    import tempfile

    import torch

    from .backend import describe, resolve_device
    stream = stream or sys.stdout
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        from .kernels import build
        build.load(dev)           # the children find the library built
    card = describe()["nvidia_smi"]
    head = {"device": str(dev), "card": card, "quick": sizes is QUICK,
            "sizes": dataclasses.asdict(sizes)}
    t = str(min(sizes.threads, os.cpu_count() or 1))
    uniq = bench.mixed_corpus()
    lines = []

    def emit(line):
        # through JSON, as `from_files` reads it: keys are strings
        lines.append(json.loads(json.dumps(line)))
        _emit(line, stream)

    with tempfile.TemporaryDirectory(dir=out_dir,
                                     prefix="foldcomp_routing_") as wd:
        runner = Runner(dev, wd)
        if "a" in sweeps:
            emit(dict(head, sweep="fast_default",
                      **sweep_fast_default(runner, uniq, sizes, t)))
        if "h" in sweeps:
            emit(dict(head, sweep="hybrid",
                      **sweep_hybrid(runner, uniq, sizes, t)))
        if "b" in sweeps or "c" in sweeps:
            for ln in sweep_batch(runner, uniq, sizes, t, "b" in sweeps,
                                  "c" in sweeps):
                emit(dict(head, **ln))
        if "d" in sweeps:
            emit(dict(head, sweep="horizon",
                      **sweep_horizon(runner, uniq, sizes)))
    if "e" in sweeps:
        emit(dict(head, sweep="probe", **sweep_probe(sizes)))
    _emit({"sweep": "decisions", "card": card, "rows": decide(lines)},
          stream)
    return 0


def from_files(paths, stream=None) -> int:
    """The decisions' line from sweep lines saved in `paths` (JSON lines;
    other lines are skipped); the newest line of a sweep wins."""
    lines = []
    for p in paths:
        for ln in pathlib.Path(p).read_text().splitlines():
            try:
                d = json.loads(ln)
            except ValueError:
                continue
            if isinstance(d, dict) and d.get("sweep") in SWEEPS.values():
                lines.append(d)
    cards = sorted({ln.get("card") for ln in lines if ln.get("card")})
    _emit({"sweep": "decisions", "card": cards, "rows": decide(lines)},
          stream or sys.stdout)
    return 0
