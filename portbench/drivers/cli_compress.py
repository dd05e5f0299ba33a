"""CLI compress: a database built from PDB files, as `compress --fast
--db` does for an AlphaFold DB proteome download.

The window runs cli.run_compress with the options `compress --fast --db`
sets, over an endless seeded sweep of the configuration's entries as
one-chain PDB text (made in set-up, in memory), until `seconds` have
passed; then the job drains and closes its database, which lies under
the run's temporary directory and is removed after the check. The probe,
the batch and the route are the product's, the probe in set-up. Every
entry of the database is held to the reference's encode of its PDB text.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

from ..reference import tasks
from ..reference.compare import read_db
from .common import EntryStream, probe_in_background, product_batch

INPUT_KIND = "pdb"


def sizes(cfg, traffic):
    return int(cfg["entries"]), int(cfg["unique_structures"])


def before_inputs(ctx):
    return probe_in_background(ctx)


def _entries(ctx, stream, deadline, n_max=None):
    """(file name, PDB bytes) until the deadline, or n_max."""
    n = 0
    while time.perf_counter() < deadline and (n_max is None or n < n_max):
        i, u = next(stream)
        n += 1
        yield f"e{i}_u{u}.pdb", ctx.blobs[u]


def _options():
    from foldcomp_tpu_torch import cli
    opts, _ = cli.parse_args(["compress", "--fast", "--db", "in", "out"])
    return opts


def setup(ctx):
    from foldcomp_tpu_torch import cli
    st = {"bsz": product_batch(ctx),
          "dir": tempfile.mkdtemp(prefix="portbench_compress_")}
    # warm-up: the same path over two batches of other entries
    warm = iter(EntryStream(ctx.mult, ctx.seed + 1))
    path = os.path.join(st["dir"], "warm")
    cli.run_compress(_options(), _entries(ctx, warm, float("inf"),
                                          2 * st["bsz"]),
                     path, False, ctx.device)
    for p in os.listdir(st["dir"]):
        os.remove(os.path.join(st["dir"], p))
    return st


def window(ctx, state, seconds):
    from foldcomp_tpu_torch import cli
    from foldcomp_tpu_torch.codec import batch_host
    stream = EntryStream(ctx.mult, ctx.seed)
    state["db"] = os.path.join(state["dir"], "db")
    saved = batch_host.encode_pdb_device
    if ctx.traced:
        batch_host.encode_pdb_device = ctx.spans.wrap("parse", saved)
    try:
        deadline = time.perf_counter() + seconds
        cli.run_compress(_options(), _entries(ctx, iter(stream), deadline),
                         state["db"], False, ctx.device)
        t_end = time.perf_counter()
    finally:
        batch_host.encode_pdb_device = saved
    state["units"] = stream.units
    residues = int(sum(ctx.lengths[u] for u in stream.units))
    return {"t_end": t_end, "residues": residues,
            "entries": len(stream.units),
            "counters": {"db_bytes": os.path.getsize(state["db"])}}


def release(ctx, state):
    pass


def check(ctx, state, ex, control=False):
    """Every entry handed to the job against the reference's compress of
    the same PDB text: entries whose FCZ bytes differ, and entries that
    are missing from the database or there twice."""
    try:
        got = read_db(state["db"])
        handed = state["units"]
        need = sorted(set(handed))
        pdbs = [ctx.blobs[u] for u in need]
        ref = dict(zip(need, ex.map(tasks.ref_compress, pdbs, [""] * len(
            need), [False] * len(need))))
        if control:
            ctrl = dict(zip(need, ex.map(tasks.ref_compress, pdbs, [""] * len(
                need), [True] * len(need))))
        differ = missing = 0
        for i, u in enumerate(handed):
            blob = ctrl[u][0] if control else got.get(f"e{i}_u{u}")
            if blob is None:
                missing += 1
            elif blob != ref[u][0]:
                differ += 1
        extra = len(got) - (len(handed) - missing)
    finally:
        shutil.rmtree(state["dir"], ignore_errors=True)
    return {
        "fcz_mismatch_entries": {"value": differ, "limit": 0, "op": "eq",
                                 "entries_failed": differ},
        "entries_missing": {"value": missing, "limit": 0, "op": "eq",
                            "entries_failed": missing},
        "entries_extra": {"value": extra, "limit": 0, "op": "eq"},
    }
