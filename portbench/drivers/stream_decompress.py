"""Stream decompress: a database expanded to PDB text, as
`decompress --fast` does for tools that read PDB.

The window runs codec/batch.decode_fcz_stream (what `decompress --fast`
runs, cli._run_decompress_fast) at the product's batch size
(cli.fast_batch_size, after the link probe in set-up) over FCZ entries
parsed as the CLI parses them, in a seeded endless sweep of the
database, until `seconds` have passed; then the stream drains. The PDB
text stays in memory: its length is counted, and a seeded sample of the
entries (one in `sample_every`, at most `sample_max`, and the first copy
of the longest structure) is kept for the check. Nothing is written.
"""
from __future__ import annotations

import time

from ..reference import tasks
from ..reference.compare import pdb_text_gap
from .common import (EntryStream, probe_in_background, product_batch,
                     sample_filter)

INPUT_KIND = "fcz"


def sizes(cfg, traffic):
    return int(cfg["entries"]), int(cfg["unique_structures"])


def before_inputs(ctx):
    return probe_in_background(ctx)


def _payloads(ctx, st, deadline, n_max=None):
    """(FczData as the CLI parses it) until the deadline, or n_max."""
    from foldcomp_tpu_torch.codec import fcz as port_fcz
    n = 0
    while time.perf_counter() < deadline and (n_max is None or n < n_max):
        i, u = next(st["stream"])
        n += 1
        f = port_fcz.parse(bytes(ctx.blobs[u]))
        f.entry_name = f"e{i}_u{u}"
        yield f


def setup(ctx):
    from foldcomp_tpu_torch.codec import batch
    st = {"bsz": product_batch(ctx)}
    st["longest"] = int(max(range(len(ctx.lengths)),
                            key=lambda u: ctx.lengths[u]))
    # warm-up: the same path over two batches of other entries
    warm = EntryStream(ctx.mult, ctx.seed + 1)
    n = 0
    for _f, _text in batch.decode_fcz_stream(
            _payloads(ctx, {"stream": iter(warm)}, float("inf"),
                      2 * st["bsz"]),
            batch_size=st["bsz"], device=ctx.device):
        n += 1
    ctx.log("warm-up decoded", n, "entries")
    return st


def window(ctx, state, seconds):
    from foldcomp_tpu_torch.codec import batch
    stream = EntryStream(ctx.mult, ctx.seed)
    state["stream"] = iter(stream)
    sampled = sample_filter(ctx.seed, int(ctx.traffic["sample_every"]))
    cap = int(ctx.traffic["sample_max"])
    kept, have_longest = [], False
    saved = batch._format_batch
    if ctx.traced:
        batch._format_batch = ctx.spans.wrap_gen("format", saved)
    residues = entries = text_bytes = 0
    try:
        deadline = time.perf_counter() + seconds
        for f, text in batch.decode_fcz_stream(
                _payloads(ctx, state, deadline),
                batch_size=state["bsz"], device=ctx.device):
            residues += f.n_residue
            entries += 1
            text_bytes += len(text)
            i, u = (int(x[1:]) for x in f.entry_name.split("_"))
            if (sampled(i) and len(kept) < cap) or \
                    (u == state["longest"] and not have_longest):
                kept.append((i, u, text))
                have_longest |= u == state["longest"]
        t_end = time.perf_counter()
    finally:
        batch._format_batch = saved
    state["kept"] = kept
    state["handed"] = len(stream.units)
    state["returned"] = entries
    return {"t_end": t_end, "residues": residues, "entries": entries,
            "counters": {"pdb_text_bytes": text_bytes,
                         "sampled": len(kept)}}


def release(ctx, state):
    state["stream"] = None


def check(ctx, state, ex, control=False):
    """The kept PDB texts against the reference's decode and writer of
    the same FCZ bytes: the largest coordinate gap, and the lines that
    differ outside the coordinates. The stream must also have given back
    every entry it was handed, once."""
    need = sorted({u for _, u, _ in state["kept"]})
    blobs = [ctx.blobs[u] for u in need]
    ref = dict(zip(need, ex.map(tasks.ref_pdb_text, blobs,
                                [False] * len(need))))
    if control:
        ctrl = dict(zip(need, ex.map(tasks.ref_pdb_text, blobs,
                                     [True] * len(need))))
    limit = ctx.limits["max_dev_A"]
    worst, lines, failed = 0.0, 0, 0
    for _i, u, text in state["kept"]:
        d, bad = pdb_text_gap(ctrl[u] if control else text, ref[u])
        worst = max(worst, d)
        lines += bad
        failed += d > limit or bad > 0
    missing = state["handed"] - state["returned"]
    return {
        "max_dev_A": {"value": worst, "limit": limit, "op": "le",
                      "entries_failed": failed},
        "field_mismatch_lines": {"value": lines, "limit": 0, "op": "eq"},
        "entries_sampled": {"value": len(state["kept"]),
                            "limit": ctx.limits["entries_sampled_min"],
                            "op": "ge"},
        "entries_missing": {"value": missing, "limit": 0, "op": "eq"},
    }
