"""Resident decode: a compressed database held on the card, decoded batch
after batch, as a consumer on the card (structure search, embedding,
training) sweeps it.

Set-up parses the configuration's entries as the CLI does
(codec/fcz.parse), packs them in seeded batches of `batch_entries` with
the product's pack and width-class rule (codec/batch.pack_decode_wire,
full wire) and puts them on the card (arrays_to_torch). The window runs
codec/batch._seg_decode_arrays (what the port's bench.device_decode_mixed
drives: k1-k3) batch after batch, a fresh seeded order of the batches
each pass; the outputs stay on the card and the window ends on a
synchronize after the last batch. The window's first and last output of
each batch are kept (the window runs until every batch has had two
calls), and a seeded sample of each, one copy of every structure the
batch holds, is held to the reference's decode: a fault that shows only
on a later call (a reused workspace, stale state, an output buffer
overwritten by the next launch) is judged as well as the first call.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import data, work
from ..reference import tasks
from ..reference.compare import slot_deviation

INPUT_KIND = "fcz"

# the decode calls each batch gets in set-up: the window's two kept
# outputs a batch and one in flight then reuse blocks the caching
# allocator already holds
WARM_CALLS = 3


def sizes(cfg, traffic):
    return int(cfg["entries"]), int(cfg["unique_structures"])


def padded_slots(arrays) -> int:
    """The residue slots a decode pack pads to: a copy of the port's
    bench.padded_slots (foldcomp_tpu_torch/bench.py:614-620 at commit
    5ba08cd7580a), frozen with the yardstick."""
    if "classes" in arrays:
        return sum(r.shape[1] * r.shape[2]
                   for r in arrays["classes"]["recs"])
    seg_w, nl = arrays["seg_records"].shape[1:]
    return seg_w * nl


def setup(ctx):
    from foldcomp_tpu_torch.codec import batch
    from foldcomp_tpu_torch.codec import fcz as port_fcz
    fczs = [port_fcz.parse(b) for b in ctx.blobs]
    order = data.entry_order(ctx.mult, ctx.seed)
    n = int(ctx.traffic["batch_entries"])
    groups = [order[i:i + n] for i in range(0, len(order), n)]

    def pack(g):
        return batch.pack_decode_wire([fczs[u] for u in g], bb_wire=False)

    with ThreadPoolExecutor(min(len(groups), 8)) as tp:
        packs = list(tp.map(pack, groups))
    t = time.perf_counter()
    work_u = [work.decode_work(b) for b in ctx.blobs]
    st = {"tas": [], "metas": [], "groups": groups, "res": [], "slots": [],
          "bytes": [], "ops": [], "classed": 0}
    for (arrays, metas), g in zip(packs, groups):
        st["slots"].append(padded_slots(arrays))
        st["classed"] += "classes" in arrays
        st["tas"].append(batch.arrays_to_torch(arrays, ctx.device))
        st["metas"].append(metas)
        st["res"].append(int(sum(work_u[u]["residues"] for u in g)))
        st["bytes"].append(int(sum(work_u[u]["bytes"] for u in g)))
        st["ops"].append(int(sum(work_u[u]["ops"] for u in g)))
    del packs
    held = [[batch._seg_decode_arrays(ta) for _ in range(WARM_CALLS - 1)]
            for ta in st["tas"]]
    for ta in st["tas"]:
        batch._seg_decode_arrays(ta)
    del held
    if ctx.device.type == "cuda":
        ctx.torch.cuda.synchronize(ctx.device)
    ctx.log("resident", len(groups), "batches,", st["classed"], "classed;",
            f"upload and warm-up {time.perf_counter() - t:.2f} s")
    return st


def window(ctx, state, seconds):
    from foldcomp_tpu_torch.codec import batch
    decode = batch._seg_decode_arrays
    tas = state["tas"]
    nb = len(tas)
    first, last = [None] * nb, [None] * nb
    rng = np.random.default_rng([int(ctx.seed) % (1 << 63), 31])
    done = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    over = False
    while not over:
        for b in rng.permutation(nb):
            out = decode(tas[b])
            if first[b] is None:
                first[b] = out
            else:
                last[b] = out
            done.append(int(b))
            if time.perf_counter() >= deadline and all(
                    k is not None for k in last):
                over = True
                break
    if ctx.device.type == "cuda":
        ctx.torch.cuda.synchronize(ctx.device)
    t_end = time.perf_counter()
    state["kept"] = {"first": first, "last": last}
    res = sum(state["res"][b] for b in done)
    return {
        "t_end": t_end, "residues": res,
        "entries": sum(len(state["groups"][b]) for b in done),
        "counters": {
            "batches": len(done), "residues": res,
            "padded_slots": sum(state["slots"][b] for b in done),
            "work_bytes": sum(state["bytes"][b] for b in done),
            "work_ops": sum(state["ops"][b] for b in done)},
    }


def release(ctx, state):
    state["tas"] = None
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()


def _host(out):
    """The kept device output as the host arrays the port's gather reads
    (codec/batch._outs_to_host's form, without its side effect)."""
    if isinstance(out[0], str):
        return (out[0],) + tuple(t.cpu().numpy() for t in out[1:])
    return tuple(t.cpu().numpy() for t in out)


def check(ctx, state, ex, control=False):
    """A seeded sample of every batch (`_sample`), as the port's gather
    (codec/batch_host._gather_a14) reads its coordinates from the
    window's first and last output of the batch, against the reference's
    decode of its FCZ bytes: the largest coordinate gap, and the atoms
    that are not finite. Each sampled entry counts once an output."""
    from foldcomp_tpu_torch.codec.batch_host import _gather_a14
    refs = list(ex.map(tasks.ref_slots, ctx.blobs, [False] * len(ctx.blobs)))
    worst, nonfinite, failed, unread, checked = 0.0, 0, 0, 0, 0
    limit = ctx.limits["max_dev_A"]
    picks = list(_sample(ctx, state))
    if control:
        ctrl = list(ex.map(tasks.ref_slots, ctx.blobs,
                           [True] * len(ctx.blobs)))
        dev_u = []
        for (a, cnt), (c, _) in zip(refs, ctrl):
            d, bad = slot_deviation(c, a, cnt)
            dev_u.append(float(d.max()))
            nonfinite += bad
        for _kept in ("first", "last"):
            for g, pick in zip(state["groups"], picks):
                for k in pick:
                    worst = max(worst, dev_u[g[k]])
                    failed += dev_u[g[k]] > limit
                checked += len(pick)
    else:
        for kept in ("first", "last"):
            for g, metas, out, pick in zip(state["groups"], state["metas"],
                                           state["kept"][kept], picks):
                if out is None:
                    unread += len(g)
                    continue
                host = _host(out)
                got = np.concatenate([_gather_a14(host, metas[k])
                                      for k in pick])
                ref = np.concatenate([refs[g[k]][0] for k in pick])
                cnt = np.concatenate([refs[g[k]][1] for k in pick])
                d, bad = slot_deviation(got, ref, cnt)
                nonfinite += bad
                ends = np.cumsum([len(refs[g[k]][1]) for k in pick])
                per = np.maximum.reduceat(d, np.concatenate([[0],
                                                             ends[:-1]]))
                worst = max(worst, float(per.max()))
                failed += int((per > limit).sum())
                checked += len(pick)
                del host
        state["kept"] = None
    return {
        "max_dev_A": {"value": worst, "limit": limit, "op": "le",
                      "entries_failed": failed},
        "nonfinite_atoms": {"value": nonfinite, "limit": 0, "op": "eq"},
        "entries_unread": {"value": unread, "limit": 0, "op": "eq"},
        "entries_checked": {"value": checked,
                            "limit": ctx.limits["entries_checked_min"],
                            "op": "ge"},
    }


def _sample(ctx, state):
    """A seeded sample of each batch: one copy of every structure the
    batch holds, so that every structure and length is judged in every
    batch."""
    rng = np.random.default_rng([int(ctx.seed) % (1 << 63), 53])
    for g in state["groups"]:
        first = {}
        for k in rng.permutation(len(g)):
            first.setdefault(int(g[k]), int(k))
        yield sorted(first.values())
