"""Resident backbone decode: a database shard held on the card in the
backbone-only wire's form, its backbone decoded batch after batch, as a
structure search on the card (Foldseek's 3Di, TM-align and LDDT read N, CA
and C alone) sweeps it.

Set-up parses the configuration's entries as the CLI does
(codec/fcz.parse), packs them in seeded batches of `batch_entries` with
the product's pack on the backbone-only wire
(codec/batch.pack_decode_wire, bb_wire=True) and puts each on the card
(arrays_to_torch). Each batch is then held `replicas` times in all: the
upload and device copies of every tensor of its dict, as a shard of a
database larger than the distinct entries the set-up packs is held.
`held_bytes` and `residues_held` count what that takes. Each distinct
batch is warmed WARM_CALLS times; its copies share its shapes.

The window runs codec/batch._seg_decode_arrays (k0, k1 and k2_backbone_bb
on the card) on every held batch, a fresh seeded order of all of them
each pass; the outputs stay on the card and the window ends on a
synchronize after the last one. Of each distinct batch two copies are
chosen: the window's first output of a seeded one and the last output of
another, the batch's copy that comes first in the second pass (so that at
a small size the window need not run far into it), are kept, and the
window runs until that other one has had two calls. The check holds a
seeded sample of each kept output, one copy of every structure the batch
holds, to the backbone reference's decode of its FCZ bytes
(portbench/backbone_ref.py), computed in this process after the
window.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import data, work_bb
from .resident_decode import padded_slots

INPUT_KIND = "fcz"

# the decode calls each distinct batch gets in set-up: the window's kept
# outputs and one in flight then reuse blocks the caching allocator holds
WARM_CALLS = 3

# the bb wire's offsets: int16 units of 0.1 mA from CA
BB_QUANTUM_A = np.float32(0.0001)


def sizes(cfg, traffic):
    return int(cfg["entries"]), int(cfg["unique_structures"])


def _copy(ta):
    """A device copy of every tensor of an arrays_to_torch dict; host
    values (nl_out, bb_wire, None) as they are."""
    return {k: v.clone() if hasattr(v, "clone") else v
            for k, v in ta.items()}


def _nbytes(ta) -> int:
    return sum(v.numel() * v.element_size() for v in ta.values()
               if hasattr(v, "element_size"))


def setup(ctx):
    from foldcomp_tpu_torch.codec import batch
    from foldcomp_tpu_torch.codec import fcz as port_fcz
    fczs = [port_fcz.parse(b) for b in ctx.blobs]
    order = data.entry_order(ctx.mult, ctx.seed)
    n = int(ctx.traffic["batch_entries"])
    reps = max(1, int(ctx.traffic["replicas"]))
    groups = [order[i:i + n] for i in range(0, len(order), n)]

    def pack(g):
        return batch.pack_decode_wire([fczs[u] for u in g], bb_wire=True)

    with ThreadPoolExecutor(min(len(groups), 8)) as tp:
        packs = list(tp.map(pack, groups))
    t = time.perf_counter()
    work_u = [work_bb.decode_bb_work(b) for b in ctx.blobs]
    st = {"metas": [], "groups": groups, "res": [], "slots": [],
          "bytes": [], "ops": [], "held": []}
    for d, ((arrays, metas), g) in enumerate(zip(packs, groups)):
        st["slots"].append(padded_slots(arrays))
        st["held"].append((d, batch.arrays_to_torch(arrays, ctx.device)))
        st["metas"].append(metas)
        st["res"].append(int(sum(work_u[u]["residues"] for u in g)))
        st["bytes"].append(int(sum(work_u[u]["bytes"] for u in g)))
        st["ops"].append(int(sum(work_u[u]["ops"] for u in g)))
    del packs
    nd = len(groups)
    for d in range(nd):
        for _ in range(reps - 1):
            st["held"].append((d, _copy(st["held"][d][1])))
    st["held_bytes"] = sum(_nbytes(ta) for _, ta in st["held"])
    st["residues_held"] = sum(st["res"][d] for d, _ in st["held"])
    held = [[batch._seg_decode_arrays(st["held"][d][1])
             for _ in range(WARM_CALLS - 1)] for d in range(nd)]
    for d in range(nd):
        batch._seg_decode_arrays(st["held"][d][1])
    del held
    if ctx.device.type == "cuda":
        ctx.torch.cuda.synchronize(ctx.device)
    ctx.log("resident backbone", nd, "batches held", reps, "times,",
            f"{st['held_bytes']} bytes for {st['residues_held']} residues;",
            f"upload, copies and warm-up {time.perf_counter() - t:.2f} s")
    return st


def window(ctx, state, seconds):
    from foldcomp_tpu_torch.codec import batch
    decode = batch._seg_decode_arrays
    held = state["held"]
    nd = len(state["groups"])
    rng = np.random.default_rng([int(ctx.seed) % (1 << 63), 31])
    passes = [rng.permutation(len(held)) for _ in range(2)]
    first_of, last_of = _kept_copies(ctx, held, passes[1])
    first, last = [None] * nd, [None] * nd
    calls = {}
    done = []
    deadline = time.perf_counter() + seconds
    over = False
    while not over:
        perm = passes.pop(0) if passes else rng.permutation(len(held))
        for h in perm:
            h = int(h)
            out = decode(held[h][1])
            calls[h] = calls.get(h, 0) + 1
            if h in first_of and first[first_of[h]] is None:
                first[first_of[h]] = out
            if h in last_of and calls[h] >= 2:
                last[last_of[h]] = out
            done.append(held[h][0])
            if time.perf_counter() >= deadline and all(
                    k is not None for k in last):
                over = True
                break
    if ctx.device.type == "cuda":
        ctx.torch.cuda.synchronize(ctx.device)
    t_end = time.perf_counter()
    state["kept"] = {"first": first, "last": last}
    res = sum(state["res"][d] for d in done)
    return {
        "t_end": t_end, "residues": res,
        "entries": sum(len(state["groups"][d]) for d in done),
        "counters": {
            "batches": len(done), "residues": res,
            "padded_slots": sum(state["slots"][d] for d in done),
            "work_bytes_bb": sum(state["bytes"][d] for d in done),
            "work_ops_bb": sum(state["ops"][d] for d in done),
            "held_bytes": state["held_bytes"],
            "residues_held": state["residues_held"]},
    }


def _kept_copies(ctx, held, second):
    """({held index: batch} whose first window output is kept, {held
    index: batch} whose last is): of each batch, the copy that comes first
    in the second pass's order `second` for the last, and a seeded other
    copy (the same one where the batch is held once) for the first."""
    rng = np.random.default_rng([int(ctx.seed) % (1 << 63), 67])
    last_of = {}
    for h in second:
        d = held[int(h)][0]
        if d not in last_of.values():
            last_of[int(h)] = d
    first_of = {}
    for h, d in last_of.items():
        mine = [i for i, (e, _) in enumerate(held) if e == d and i != h]
        first_of[int(rng.choice(mine)) if mine else h] = d
    return first_of, last_of


def release(ctx, state):
    state["held"] = None
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()


def _backbone(out, metas, pick):
    """The kept device output's N, CA and C of the sampled entries, as the
    port's gather dequantizes the bb wire (codec/batch_host._gather_a14:
    CA + offset x 1e-4 A) -> one [n, 3, 3] array an entry; None where the
    output is not the bb wire's ("bb", off, ca)."""
    if not (isinstance(out, tuple) and len(out) == 3 and out[0] == "bb"):
        return None
    off = out[1].cpu().numpy()
    ca = out[2].cpu().numpy()
    segw = off.shape[1]
    got = []
    for k in pick:
        m = metas[k]
        idx = m.lane_of * segw + m.rec_of
        o = off.reshape(-1, 6)[idx].astype(np.float32) * BB_QUANTUM_A
        c = ca.reshape(-1, 3)[idx]
        got.append(np.stack([c + o[:, :3], c, c + o[:, 3:]], axis=1))
    return got


def _gap(got, ref):
    """(largest |coordinate difference| in A over the atoms whose
    coordinates are finite, atoms that are not finite)."""
    ok = np.isfinite(got).all(-1)
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64)).max(-1)
    return float(d[ok].max()) if ok.any() else 0.0, int((~ok).sum())


def check(ctx, state, ex, control=False):
    """A seeded sample of every batch (`_sample`) of the window's first and
    last kept output, N, CA and C as the port's gather reads them, against
    the backbone reference's decode of its FCZ bytes in float32 (with
    control=True the reference in bfloat16 in the program's place): the
    largest coordinate gap over the finite atoms, and the atoms that are
    not finite. Each sampled entry counts once an output."""
    import torch

    from .. import backbone_ref
    limit = ctx.limits["max_dev_bb_A"]
    picks = list(_sample(ctx, state))
    need = sorted({int(state["groups"][d][k]) for d, pick in
                   enumerate(picks) for k in pick})
    refs = {u: backbone_ref.decode_backbone(ctx.blobs[u]).numpy()
            for u in need}
    worst, nonfinite, failed, unread, checked = 0.0, 0, 0, 0, 0
    if control:
        gap_u = {u: _gap(backbone_ref.decode_backbone(
            ctx.blobs[u], torch.bfloat16).float().numpy(), refs[u])
            for u in need}
    for kept in ("first", "last"):
        for d, (g, pick) in enumerate(zip(state["groups"], picks)):
            if control:
                gaps = [gap_u[int(g[k])] for k in pick]
            else:
                got = _backbone(state["kept"][kept][d], state["metas"][d],
                                pick)
                if got is None:
                    unread += len(g)
                    continue
                gaps = [_gap(x, refs[int(g[k])]) for x, k in zip(got, pick)]
            for dev, bad in gaps:
                worst = max(worst, dev)
                nonfinite += bad
                failed += dev > limit or bad > 0
            checked += len(pick)
    state["kept"] = None
    return {
        "max_dev_bb_A": {"value": worst, "limit": limit, "op": "le",
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
