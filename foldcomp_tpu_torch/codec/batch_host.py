"""Framework-free host stages of the batched codec: the decode pack and
stitch, the PDB assembly and formatting, the encode parse, compact wire and
sparse host finish.

The port's own copy of the host stages of `foldcomp_tpu/codec/batch.py`,
kept line for line so that both packages build the same arrays and write
the same bytes (tests/test_torch_standalone.py holds the two to the same
results):

- `_round_up` (:34) and `SegDecodeMeta` (:139);
- `_arange`, `_ragged_arange` and `LANE_PAD` (:299-320);
- `_pack_lanes_native` and `pack_decode_batch_lanes` (:323-551);
- `seg_sort_key` (:569), `_gather_a14` (:912, the ragged-lane full wire
  and the backbone-only wire), `_assemble_protein` (:968) and
  `_format_batch` (:1207);
- the width-class split `split_lanes_classes` (:607-731), `use_wclass`
  and its constants `_WCLASS_MIN_LANES`/`_WCLASS_MIN_SAVE` (:733-750);
- the host finish (:1237-1635, `finish_encode_device` :1442);
- `atoms_to_tensors_vec`, `fragment_to_tensors`, `_anchor_indices` and
  `encode_pdb_device` (:1637-1873);
- `_ScratchPool`/`_POOL` (:1876-1909) and `_compact_coord_batch` (:1912);
- `finish_encode`, the host half of `encode_finish` (:2124-2176).

Not carried: the grid packs `pack_decode_batch`/`pack_decode_batch_seg`
and the device probes `use_fused_decode`/`use_fused_encode`.
`_gather_a14` and `_format_batch` take the forms the port's decode emits,
as host arrays: the full wire's ragged-lane rows (off i16 [NL, SEG, 42],
ca f32 [NL, SEG, 3]); a width-classed batch's rows, the classes' rows one
after another as [rows, 1, 42] and [rows, 1, 3], which the metas of
`split_lanes_classes` index by flat row (lane_of = row, rec_of = 0); and
the backbone-only wire's ("bb", off i16 [NL, SEG, 6], ca f32 [NL, SEG,
3]), whose O and side chains the native codec places from the metas'
`sc_codes`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import tracing
from ..core.aatable import (ALT_PERM, ATOM_NAMES, MAX_ATOM,
                            N_ATOMS, N_SC_TORSION)
from ..core.codes import (NUM_AA, THREE_LETTER, three_letter_from_one)
from ..core.tables import MAX_CLASSES
from ..io.structure import AtomArray
from .fcz import FczData, unpack_records

F32 = np.float32
I32 = np.int32


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


@dataclass
class SegDecodeMeta:
    """Per-protein host-side state for the segment-space decode path.

    Carries everything needed to assemble/format the protein from the
    device's segment-space atom14 output — residue codes and temp factors
    are computed on host (they never need the device), and (lane_of,
    rec_of) index each residue's row in the [N, SEG, 14, 3] output (the
    'stitch' done as a host fancy-index)."""
    n_residue: int
    idx_residue: int
    idx_atom: int
    chain: str
    title: str
    first_residue: str
    last_residue: str
    has_oxt: bool
    oxt_coords: np.ndarray
    res_code: np.ndarray   # i32 [n]
    temp: np.ndarray       # f32 [n]
    lane_of: np.ndarray    # i64 [n]
    rec_of: np.ndarray     # i64 [n]
    res_base: int = 0      # row offset in the residue-space output [R]
    sc_codes: np.ndarray | None = None  # u8 stream, bb-only wire mode


_ARANGE = np.arange(0, dtype=np.int64)


def _arange(n):
    """Cached read-only arange view — on this VM a FRESH 2.8M-element
    arange faults pages at ~15-25 MB/s (1.5 s!), so the big index
    vectors reuse one growing buffer (PROFILE.md round 4)."""
    global _ARANGE
    if _ARANGE.size < n:
        _ARANGE = np.arange(max(n, 2 * _ARANGE.size), dtype=np.int64)
        _ARANGE.setflags(write=False)
    return _ARANGE[:n]


def _ragged_arange(counts):
    """[0..c0), [0..c1), ... concatenated."""
    total = int(counts.sum())
    out = _arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    return out


# lane quantum of the pack, the Pallas grid's (kernels/pallas_decode.py);
# the port's kernels take any lane count and carry it as pad lanes
LANE_PAD = 1024


def _pack_lanes_native(fczs, seg_bucket: int = 8):
    """One-pass C fill of the ragged-lane arrays (native/fccodec.c
    fcz_pack_lanes) from per-entry FczData field pointers, GIL-free.
    Byte-identical to the python pack (tests/test_pallas_fused.py);
    returns None when the native library is unavailable or any entry's
    field arrays are not plain contiguous numpy."""
    import ctypes

    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return NotImplemented   # python fallback
    n = len(fczs)

    def cptr(arrs, dtype):
        ptrs = (ctypes.c_void_p * n)()
        keep = []
        for i, a in enumerate(arrs):
            a = np.ascontiguousarray(a, dtype)
            keep.append(a)
            ptrs[i] = a.ctypes.data
        return ptrs, keep

    try:
        nres = np.array([f.n_residue for f in fczs], np.int32)
        na = np.array([f.n_anchor for f in fczs], np.int32)
        n_scs = np.array([len(f.sc_codes) for f in fczs], np.int32)
        tfmin = np.array([f.tf_min for f in fczs], F32)
        tfcont = np.array([f.tf_cont for f in fczs], F32)
        recs, k1 = cptr([f.records for f in fczs], np.uint8)
        scs, k2 = cptr([f.sc_codes for f in fczs], np.uint8)
        aidx, k3 = cptr([f.anchor_indices for f in fczs], np.int32)
        axyz, k4 = cptr([f.anchor_coords for f in fczs], F32)
        mins6, k5 = cptr([f.mins for f in fczs], F32)
        cont6, k6 = cptr([f.cont_fs for f in fczs], F32)
        tfc, k7 = cptr([f.tf_codes for f in fczs], np.uint8)
    except (ValueError, TypeError):
        return NotImplemented   # python fallback

    r_tot = int(nres.sum(dtype=np.int64))
    nl = int((na.astype(np.int64) - 1).sum())
    nlp = _round_up(nl, LANE_PAD)
    seg_max = int(lib.fcz_pack_seg_max(n, nres, na, aidx))
    seg_pad = _round_up(seg_max, seg_bucket)

    seg_records = np.empty((8, seg_pad, nlp), np.uint8)
    sc_seg = np.empty((seg_pad, 11, nlp), np.uint8)
    mins_lane = np.empty((nlp, 6), F32)
    cont_lane = np.empty((nlp, 6), F32)
    fwd9 = np.empty((9, nlp), F32)
    rev9 = np.empty((9, nlp), F32)
    is_first = np.empty(nlp, bool)
    seg_m = np.empty(nlp, I32)
    res_code = np.empty(r_tot, I32)
    temp = np.empty(r_tot, F32)
    lane_of = np.empty(r_tot, I32)
    rec_of = np.empty(r_tot, I32)

    got = lib.fcz_pack_lanes(
        n, nres, na, recs, scs, n_scs, aidx, axyz, mins6, cont6,
        tfmin, tfcont, tfc, nlp, seg_pad, r_tot,
        seg_records.reshape(-1), sc_seg.reshape(-1),
        mins_lane.reshape(-1), cont_lane.reshape(-1),
        fwd9.reshape(-1), rev9.reshape(-1),
        is_first.view(np.uint8), seg_m,
        res_code, temp, lane_of, rec_of)
    if got != nl:
        return NotImplemented   # python fallback

    metas = []
    base = 0
    for f in fczs:
        lo, hi = base, base + f.n_residue
        metas.append(SegDecodeMeta(
            n_residue=f.n_residue, idx_residue=f.idx_residue,
            idx_atom=f.idx_atom, chain=f.chain, title=f.title,
            first_residue=f.first_residue, last_residue=f.last_residue,
            has_oxt=f.has_oxt, oxt_coords=np.asarray(f.oxt_coords, F32),
            res_code=res_code[lo:hi], temp=temp[lo:hi],
            lane_of=lane_of[lo:hi], rec_of=rec_of[lo:hi], res_base=lo))
        base = hi
    arrays = dict(seg_records=seg_records, mins_lane=mins_lane,
                  cont_lane=cont_lane, sc_codes_seg=sc_seg,
                  fwd9=fwd9, rev9=rev9, is_first=is_first, seg_m=seg_m,
                  nl_out=_round_up(nl, 512))
    return arrays, metas


def pack_decode_batch_lanes(fczs, seg_bucket: int = 8,
                            native: bool = True):
    """List[FczData] -> RAGGED-lane device arrays for the fused decode.

    Unlike pack_decode_batch_seg's [B, S_max] lane grid, lanes here exist
    only for REAL segments (NL = sum(s_i), padded to the fused kernel's
    1024-lane quantum). Protein-level lane padding disappears — on mixed
    corpora the [b, s_pad] grid pads every short protein to the longest
    protein's segment count — and the decode output needs NO residue
    gather on device: the fused epilogue transposes to per-lane rows
    [NL, SEG, 42] and the host row-gathers each protein's residues
    ((lane_of, rec_of) fancy-index, one contiguous 84 B row per residue).

    Per-lane anchors replace the [B, S+1, 3, 3] anchor block: fwd9/rev9
    are the segment's own start/end anchor triples (9 components,
    atom-major), and `is_first` marks each protein's first segment so the
    refine reseed can shift tails by ONE lane (segment s's seed is
    segment s-1's blended tail, foldcomp.cpp:849-857) with a plain roll.

    When the native library is available the fill runs as ONE GIL-free
    C call (native/fccodec.c fcz_pack_lanes) writing the device layouts
    directly — the python pack's ~3.3 Mres/s/thread was the healthy-link
    e2e ceiling (VERDICT r3 #5).
    """
    if native:
        got = _pack_lanes_native(fczs, seg_bucket)
        if got is not NotImplemented:
            return got
    b = len(fczs)
    nres = np.array([f.n_residue for f in fczs], np.int64)
    rec_base = np.zeros(b + 1, np.int64)
    np.cumsum(nres, out=rec_base[1:])
    r_tot = int(rec_base[-1])

    na = np.array([f.n_anchor for f in fczs], np.int64)
    anchors_all = np.concatenate(
        [np.asarray(f.anchor_indices, np.int64) for f in fczs])
    acoords_all = np.concatenate(
        [np.asarray(f.anchor_coords, F32).reshape(-1, 9) for f in fczs])
    ab = np.cumsum(na)
    s_i = na - 1
    seg_ord = _ragged_arange(s_i)
    first_idx = np.repeat(ab - na, s_i) + seg_ord
    a0 = anchors_all[first_idx]
    a1 = anchors_all[first_idx + 1]
    nres_rep = np.repeat(nres, s_i)
    first = np.minimum(a0, nres_rep - 1)
    is_last = seg_ord == np.repeat(s_i - 1, s_i)
    counts_g = np.maximum(
        np.where(is_last, nres_rep - first,
                 np.minimum(a1 + 1, nres_rep - 1) - first), 1)

    nl = int(s_i.sum())
    nlp = _round_up(nl, LANE_PAD)
    seg_pad = _round_up(int(counts_g.max()), seg_bucket)
    ar = np.arange(seg_pad)
    records_all = np.concatenate(
        [np.asarray(f.records, np.uint8).reshape(-1, 8) for f in fczs])

    # global per-residue side-chain slot scatter (see pack_decode_batch_seg)
    res_code_all = unpack_records(records_all)[0].astype(np.int32)
    counts_sc = np.where(res_code_all < NUM_AA,
                         N_SC_TORSION[res_code_all], 0).astype(np.int64)
    totals = np.add.reduceat(counts_sc, rec_base[:-1]) if r_tot else \
        np.zeros(b, np.int64)
    sc_res_all = np.zeros((r_tot, 12), np.uint8)
    tot = int(counts_sc.sum())
    if tot:
        stream = np.concatenate(
            [np.asarray(f.sc_codes[:t], np.uint8)
             for f, t in zip(fczs, totals)])
        res_of = np.repeat(_arange(r_tot), counts_sc)
        ends = np.cumsum(counts_sc)
        within = _arange(tot) - np.repeat(ends - counts_sc, counts_sc)
        sc_res_all.reshape(-1)[res_of * 12 + within] = stream

    # dense ragged lanes: global record-row window per segment
    starts_g = first + np.repeat(rec_base[:-1], s_i)
    last_g = np.repeat(rec_base[1:] - 1, s_i)
    idx = np.minimum(starts_g[:, None] + ar[None, :], last_g[:, None])

    seg_records = np.zeros((nlp, seg_pad, 8), np.uint8)
    seg_records.view(np.uint64)[:nl, :, 0] = \
        records_all.view(np.uint64)[:, 0][idx]
    sc_seg12 = np.zeros((nlp, seg_pad, 12), np.uint8)
    sc_seg12.view(np.uint32)[:nl] = sc_res_all.view(np.uint32)[idx]
    sc_seg = sc_seg12[:, :, :11]
    seg_m = np.ones(nlp, I32)
    seg_m[:nl] = counts_g

    mins_lane = np.zeros((nlp, 6), F32)
    cont_lane = np.zeros((nlp, 6), F32)
    mins_lane[:nl] = np.repeat(np.stack([f.mins for f in fczs])
                               .astype(F32), s_i, axis=0)
    cont_lane[:nl] = np.repeat(np.stack([f.cont_fs for f in fczs])
                               .astype(F32), s_i, axis=0)

    fwd9 = np.zeros((9, nlp), F32)
    rev9 = np.zeros((9, nlp), F32)
    fwd9[:, :nl] = acoords_all[first_idx].T
    rev9[:, :nl] = acoords_all[first_idx + 1].T
    is_first = np.ones(nlp, bool)          # pad lanes keep their own seed
    is_first[:nl] = seg_ord == 0

    # stitch: residue r owned by the last segment starting <= r
    r_g = _arange(r_tot)
    lane_of_g = np.searchsorted(starts_g, r_g, side="right") - 1
    rec_of_g = np.clip(r_g - starts_g[lane_of_g], 0, seg_pad - 1)

    tf_all = np.concatenate(
        [np.asarray(f.tf_codes, np.uint8) for f in fczs]).astype(F32)
    temp_all = (tf_all
                * np.repeat(np.array([f.tf_cont for f in fczs], F32), nres)
                + np.repeat(np.array([f.tf_min for f in fczs], F32),
                            nres)).astype(F32)

    metas = []
    for i, f in enumerate(fczs):
        lo, hi = int(rec_base[i]), int(rec_base[i + 1])
        metas.append(SegDecodeMeta(
            n_residue=f.n_residue, idx_residue=f.idx_residue,
            idx_atom=f.idx_atom, chain=f.chain, title=f.title,
            first_residue=f.first_residue, last_residue=f.last_residue,
            has_oxt=f.has_oxt, oxt_coords=np.asarray(f.oxt_coords, F32),
            res_code=res_code_all[lo:hi], temp=temp_all[lo:hi],
            lane_of=lane_of_g[lo:hi], rec_of=rec_of_g[lo:hi],
            res_base=lo))

    arrays = dict(
        seg_records=np.ascontiguousarray(seg_records.transpose(2, 1, 0)),
        mins_lane=mins_lane, cont_lane=cont_lane,
        sc_codes_seg=np.ascontiguousarray(sc_seg.transpose(1, 2, 0)),
        fwd9=fwd9, rev9=rev9, is_first=is_first, seg_m=seg_m,
        nl_out=_round_up(nl, 512))   # static D2H lane-slice quantum
    return arrays, metas


def seg_sort_key(f):
    """Decode-batch sort key: (segment-width bucket, residue count).

    The reference's anchor spacing (_setAnchor, foldcomp.cpp:745-761)
    floors the interval, so the LAST segment absorbs the remainder and
    can be up to 2*interval-1 (47) records wide while every other
    segment is ~25 — and the batch window width is the max over all
    lanes. Sorting by length alone mixes 24-wide and 48-wide proteins
    in one batch, padding every lane to 48 (measured 2.0x lane-residue
    overhead on an AFDB-like corpus); grouping by width bucket first
    recovers ~23% mixed-corpus decode throughput (87 -> 107M res/s,
    bench_device_decode_mixed)."""
    a = np.asarray(f.anchor_indices)
    w = int((a[1:] - a[:-1]).max()) + 1 if len(a) > 1 else f.n_residue
    return ((w + 7) // 8 * 8, f.n_residue)


def split_lanes_classes(arrays, metas, seg_bucket: int = 8,
                        max_classes: int = MAX_CLASSES,
                        min_save: float = 0.15):
    """Width-classed re-layout of the ragged-lane arrays.

    The reference's floored anchor interval hands each protein ONE tail
    segment up to 2x wider than its others (_setAnchor,
    foldcomp.cpp:745-761); in a single rectangular lane array that tail
    drags every normal-width lane of the batch to the widest SEG
    (foldcomp_tpu measured 1.7x lane-residue padding on an AFDB-like
    corpus even with width-bucket batching). Here lanes are permuted into
    width CLASSES (each a contiguous range, its own SEG); the re-seed
    coupling becomes an explicit prev-lane index
    (kernels/fused_decode.decode_lanes), and the host
    stitch indices are rewritten to FLAT row numbers over the
    concatenated class outputs (lane_of = row, rec_of = 0, so
    _gather_a14's lane_of*segw+rec_of works verbatim with segw=1).
    Per-lane math is identical — coordinates are bit-equal to the
    single-class path.

    Returns (class_arrays, new_metas) or None when classing buys less
    than min_save of the padded lane-residues (single width class,
    near-uniform corpus, tiny batch)."""
    import dataclasses

    seg_m = np.asarray(arrays["seg_m"])
    real = [m for m in metas if m.n_residue]
    if not real:
        return None
    nl = max(int(np.max(m.lane_of)) for m in real) + 1
    w = seg_m[:nl]
    segpad = int(arrays["seg_records"].shape[1])
    bucket = seg_bucket
    while True:
        cw = np.minimum((w + bucket - 1) // bucket * bucket, segpad)
        widths = np.unique(cw)
        if len(widths) <= max_classes:
            break
        bucket *= 2
    if len(widths) < 2:
        return None
    padded_single = segpad * _round_up(nl, LANE_PAD)

    def _lane_pad(c):
        return _round_up(c, 512) if c <= 512 else _round_up(c, LANE_PAD)

    padded_cls = sum(
        int(v) * _lane_pad(int((cw == v).sum())) for v in widths)
    if padded_cls > (1.0 - min_save) * padded_single:
        return None

    recs = np.asarray(arrays["seg_records"])
    scs = np.asarray(arrays["sc_codes_seg"])
    mins = np.asarray(arrays["mins_lane"])
    cont = np.asarray(arrays["cont_lane"])
    fwd = np.asarray(arrays["fwd9"])
    rev = np.asarray(arrays["rev9"])
    isf = np.asarray(arrays["is_first"])

    cls_of = np.searchsorted(widths, cw)
    order = np.argsort(cls_of, kind="stable")
    newpos = np.empty(nl, np.int64)
    cls = dict(recs=[], mins=[], cont=[], sct=[], fwd=[], rev=[],
               isf=[], segm=[])
    bases, rowbase, nl_outs, segws = [], [], [], []
    base = rows = 0
    for ci, v in enumerate(widths):
        idx = order[cls_of[order] == ci]
        n_c = len(idx)
        # small classes pad to a 512-lane quantum (foldcomp_tpu's kernels
        # run them in half-width lane groups), so the per-class rounding
        # stops costing up to 1023 pad lanes each
        nlp_c = _round_up(n_c, 512) if n_c <= 512 \
            else _round_up(n_c, LANE_PAD)
        segw = int(v)
        r8 = np.zeros((8, segw, nlp_c), np.uint8)
        r8[:, :, :n_c] = recs[:, :segw][:, :, idx]
        sc = np.zeros((segw, 11, nlp_c), np.uint8)
        sc[:, :, :n_c] = scs[:segw][:, :, idx]
        mi = np.zeros((nlp_c, 6), F32)
        mi[:n_c] = mins[idx]
        co = np.zeros((nlp_c, 6), F32)
        co[:n_c] = cont[idx]
        f9 = np.zeros((9, nlp_c), F32)
        f9[:, :n_c] = fwd[:, idx]
        r9 = np.zeros((9, nlp_c), F32)
        r9[:, :n_c] = rev[:, idx]
        fi = np.ones(nlp_c, isf.dtype)
        fi[:n_c] = isf[idx]
        sm = np.ones(nlp_c, I32)
        sm[:n_c] = seg_m[idx]
        newpos[idx] = base + np.arange(n_c)
        nl_out_c = min(_round_up(n_c, 512), nlp_c)
        for k, a in (("recs", r8), ("mins", mi), ("cont", co),
                     ("sct", sc), ("fwd", f9), ("rev", r9),
                     ("isf", fi), ("segm", sm)):
            cls[k].append(a)
        bases.append(base)
        rowbase.append(rows)
        nl_outs.append(nl_out_c)
        segws.append(segw)
        base += nlp_c
        rows += nl_out_c * segw

    prev = np.arange(base, dtype=np.int32)
    orig = np.arange(nl)
    has_prev = (~isf[:nl].astype(bool)) & (orig > 0)
    prev[newpos[has_prev]] = newpos[orig[has_prev] - 1]

    base_a = np.asarray(bases)
    rowb_a = np.asarray(rowbase)
    segw_a = np.asarray(segws)
    new_metas = []
    for m in metas:
        li = np.asarray(m.lane_of)
        c = cls_of[li]
        row = rowb_a[c] + (newpos[li] - base_a[c]) * segw_a[c] \
            + np.asarray(m.rec_of)
        new_metas.append(dataclasses.replace(
            m, lane_of=row, rec_of=np.zeros_like(row)))
    class_arrays = dict(
        classes={k: tuple(v) for k, v in cls.items()},
        prev_idx=prev, nl_outs=tuple(int(x) for x in nl_outs))
    return class_arrays, new_metas


def padded_slots(arrays) -> int:
    """The residue slots a decode pack pads to: SEG x NL, summed over the
    width classes of a classed pack (bench.py:374-382)."""
    if "classes" in arrays:
        return sum(r.shape[1] * r.shape[2]
                   for r in arrays["classes"]["recs"])
    seg_w, nl = arrays["seg_records"].shape[1:]
    return seg_w * nl


def use_wclass() -> str:
    """Width-classed decode mode from FOLDCOMP_TPU_WCLASS: "1" always (at
    min_save 0.15), "0" never, "auto" (the default, any other value) for
    batches of at least _WCLASS_MIN_LANES real lanes whose classes save at
    least _WCLASS_MIN_SAVE of the padded lane rows. The modes and the
    rule's form are foldcomp_tpu/codec/batch.py:733-750's; the lane count
    is the port's own (below)."""
    import os
    v = os.environ.get("FOLDCOMP_TPU_WCLASS", "auto")
    return v if v in ("0", "1") else "auto"


# The auto rule splits only batches measured faster split. `bench
# --routing` sweep c (`decompress --fast` on bench.e2e's 4,096-entry
# database, WCLASS 0 and 1, medians of 3 rounds; NVIDIA H100 80GB HBM3,
# 700.00 W) found no batch size where the split was faster by more than
# the spread: 14.31 against 14.31 s at B=512 (batches of 3,588-19,808
# lanes), 15.10 against 15.58 at 1024 and 16.54 against 17.08 at 2048
# (spreads 3.5-10.2 s), and slower at 4096 and 8192 (one batch of 84,225
# lanes: 18.41 and 18.99 against 16.67 and 16.33 s; the split alone
# 0.84-1.41 s). So the lane count sits above the largest batch measured,
# 84,225 lanes, rounded up to 1,024: auto splits no batch the port forms
# at FAST_BATCH (512 entries), and FOLDCOMP_TPU_WCLASS=1 still takes
# classes. The JAX value, 4096, guarded against jit compile storms on its
# TPU (every class composition is its own program); the CUDA kernels take
# any shape. _WCLASS_MIN_SAVE stays the JAX package's 0.2.
_WCLASS_MIN_LANES = 84992
_WCLASS_MIN_SAVE = 0.2


def _gather_a14(outs_np, m):
    """Per-protein [n, 14, 3] atoms from the decode output, stitched by
    the host residue fancy-index (lane_of, rec_of): ragged-lane rows off
    i16 [NL, SEG, 42] and ca f32 [NL, SEG, 3], or the bb wire's
    ("bb", off i16 [NL, SEG, 6], ca f32 [NL, SEG, 3])."""
    if isinstance(outs_np, tuple) and isinstance(outs_np[0], str) \
            and outs_np[0] == "bb":
        # bb-only wire: N/C i16 offsets from the f32 CA at a 0.1 mA
        # quantum (finer than the full wire's — frame errors amplify
        # ~5x through the host side-chain placement); dequantize, then
        # O + side chains placed by the native C codec
        from ..native import place_sc_from_bb_native
        _, off, ca = outs_np
        segw = off.shape[1]
        idx = m.lane_of * segw + m.rec_of
        o = off.reshape(-1, 6)[idx].astype(F32) * np.float32(0.0001)
        c = ca.reshape(-1, 3)[idx]
        bb = np.empty((len(idx), 3, 3), np.float32)
        bb[:, 0] = c + o[:, :3]
        bb[:, 1] = c
        bb[:, 2] = c + o[:, 3:]
        out = place_sc_from_bb_native(bb, m.res_code, m.sc_codes,
                                      m.first_residue)
        if out is None:
            raise RuntimeError("bb wire requires the native library")
        return out
    off, ca = outs_np
    # one contiguous 84 B row per residue; [42] is (k, c)-major so the
    # reshape lands directly on [14, 3]
    segw = off.shape[1]
    idx = m.lane_of * segw + m.rec_of
    rows = off.reshape(-1, 42)[idx].astype(F32)
    crow = ca.reshape(-1, 3)[idx]
    return np.ascontiguousarray(
        crow[:, None, :]
        + rows.reshape(-1, MAX_ATOM, 3) * np.float32(0.001))


def _assemble_protein(a14, meta, use_alt_order: bool = False):
    """[n, 14, 3] atoms + SegDecodeMeta -> AtomArray."""
    n = meta.n_residue
    codes = meta.res_code
    names, rnames, chains, ridx, coords, temps = [], [], [], [], [], []
    first_three = three_letter_from_one(meta.first_residue)
    for r in range(n):
        code = int(codes[r])
        rname = first_three if r == 0 else (
            THREE_LETTER[code] if code < len(THREE_LETTER) else "UNK")
        if code < NUM_AA:
            cnt = int(N_ATOMS[code])
            order = list(range(cnt))
            if use_alt_order:
                order = [int(x) for x in ALT_PERM[code, :cnt]]
            names.extend(ATOM_NAMES[code][k] for k in order)
            coords.extend(a14[r, k] for k in order)
        else:
            cnt = 3
            names.extend(("N", "CA", "C"))
            coords.extend(a14[r, k] for k in range(3))
        rnames.extend([rname] * cnt)
        chains.extend([meta.chain] * cnt)
        ridx.extend([meta.idx_residue + r] * cnt)
        temps.extend([meta.temp[r]] * cnt)
    if meta.has_oxt:
        names.append("OXT")
        rnames.append(three_letter_from_one(meta.last_residue))
        chains.append(meta.chain)
        # reference quirk: OXT residue_index = header.nResidue
        # (foldcomp.cpp:962-965)
        ridx.append(n)
        coords.append(meta.oxt_coords)
        temps.append(meta.temp[n - 1])
    n_total = len(names)
    return AtomArray(
        names, rnames, chains,
        np.arange(meta.idx_atom, meta.idx_atom + n_total, dtype=I32),
        np.asarray(ridx, I32), np.asarray(coords, F32),
        np.ones(n_total, F32), np.asarray(temps, F32), meta.title)


def _format_batch(fczs, metas, outs_np, use_alt_order, pool=None,
                  batch=None):
    """Yields (payload, PDB text) per protein from the host decode output
    (either wire's, see _gather_a14), through the native formatter when
    the library is present. Each entry's format is a `stream.format` span
    (thread CPU, batch number `batch`) on the thread that formats it."""
    try:
        from ..native import format_atom14_native, get_lib
        have_native = get_lib() is not None
    except Exception:
        have_native = False
    if have_native:
        def fmt(m):
            with tracing.span("stream.format", batch, True) as sp:
                a14 = _gather_a14(outs_np, m)
                text = format_atom14_native(
                    a14, m.temp, m.res_code, m.n_residue, m.idx_residue,
                    m.idx_atom, m.chain, m.first_residue, m.last_residue,
                    m.has_oxt, m.oxt_coords, use_alt_order, m.title)
                if sp:
                    tracing.count("format_residues", m.n_residue)
                return text

        if pool is not None:
            # the native formatter releases the GIL: fan the batch out
            for f, text in zip(fczs, pool.map(fmt, metas, chunksize=8)):
                yield f, text
        else:
            for f, m in zip(fczs, metas):
                yield f, fmt(m)
    else:
        from ..io.pdb import format_pdb
        for f, m in zip(fczs, metas):
            with tracing.span("stream.format", batch, True) as sp:
                atoms = _assemble_protein(_gather_a14(outs_np, m), m,
                                          use_alt_order)
                text = format_pdb(atoms, m.title)
                if sp:
                    tracing.count("format_residues", m.n_residue)
            yield f, text


# ---------------------------------------------------------------------------
# Encode batching
# ---------------------------------------------------------------------------

# FixedAngleDiscretizer(255) factor, computed in f32 like discretizer.h:89
_SC_DISC_F = np.float32(np.float32(255.0) / np.float32(360.0))


def _host_cos(inner, denom2):
    """cos_t = (float)(inner / sqrt((double)(s1*s2))) — the reference's
    double-promoted division (torsion_angle.cpp:63, float3d.h:36-44)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return (inner.astype(np.float64)
                / np.sqrt(denom2.astype(np.float64))).astype(F32)


def _host_dihedral(inner, denom2, det):
    """Finish a dihedral from f32 parts with the reference's f64 acos and
    NaN guard (torsion_angle.cpp:64-96)."""
    cos_t = _host_cos(inner, denom2)
    with np.errstate(invalid="ignore"):
        ang = (np.arccos(cos_t.astype(np.float64))
               * (180.0 / np.pi)).astype(F32)
    nanm = np.isnan(ang)
    ang = np.where(nanm, np.where(cos_t < 0, F32(180.0), F32(0.0)), ang)
    return np.where(det < 0, -ang, ang).astype(F32)


def _host_bond(inner, denom2):
    """float3d::angle tail: f64 acos, NO NaN guard (NaN propagates)."""
    cos_t = _host_cos(inner, denom2)
    with np.errstate(invalid="ignore"):
        return (np.arccos(cos_t.astype(np.float64))
                * (180.0 / np.pi)).astype(F32)


def _host_quant_round(v, mask, nbin):
    """Reference Discretizer fit + rounding discretize over axis 0.

    v [K, B] f32; disc_f/cont_f in f32 (discretizer.cpp:36-41), the +0.5
    added in double before truncation (discretizer.cpp:49)."""
    vmin = np.where(mask, v, np.float32(np.inf)).min(axis=0).astype(F32)
    vmax = np.where(mask, v, np.float32(-np.inf)).max(axis=0).astype(F32)
    rng = (vmax - vmin).astype(F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        disc_f = (np.float32(nbin) / rng).astype(F32)
        cont_f = (rng / np.float32(nbin)).astype(F32)
        t = ((v - vmin[None, :]) * disc_f[None, :]).astype(F32) \
            .astype(np.float64) + 0.5
    # NaN: rng=0 constant-stream parity (discretizer.cpp UB cast -> 0 on
    # x86, see exact.Discretizer.discretize). inf: only on MASKED padded
    # positions (v outside [vmin, vmax] can't happen for real lanes);
    # zero them so the u32 cast is warning-clean — masked codes are never
    # read downstream (VERDICT r3 #8)
    t = np.where(~np.isfinite(t) | (t < 0), 0.0, t)
    return t.astype(np.uint32), vmin, cont_f


def _np_dihedral_parts(px, py, pz):
    """Backbone dihedral parts in numpy f32, one op per rounding step —
    bit-identical to the locally built C (no fma contraction; see
    encode_sc_q_core's docstring for why this cannot run under XLA).
    px/py/pz: [3L, B]; returns (inner, denom2, det) each [3L-3, B]."""
    d_x = px[1:] - px[:-1]
    d_y = py[1:] - py[:-1]
    d_z = pz[1:] - pz[:-1]
    d1x, d1y, d1z = d_x[:-2], d_y[:-2], d_z[:-2]
    d2x, d2y, d2z = d_x[1:-1], d_y[1:-1], d_z[1:-1]
    d3x, d3y, d3z = d_x[2:], d_y[2:], d_z[2:]
    u1x = d1y * d2z - d2y * d1z
    u1y = d1z * d2x - d2z * d1x
    u1z = d1x * d2y - d2x * d1y
    u2x = d2y * d3z - d3y * d2z
    u2y = d2z * d3x - d3z * d2x
    u2z = d2x * d3y - d3x * d2y
    inner = (u1x * u2x) + (u1y * u2y) + (u1z * u2z)
    s1 = u1x * u1x + u1y * u1y + u1z * u1z
    s2 = u2x * u2x + u2y * u2y + u2z * u2z
    pbx = u2y * d2z - d2y * u2z
    pby = u2z * d2x - d2z * u2x
    pbz = u2x * d2y - d2x * u2y
    det = (u1x * pbx) + (u1y * pby) + (u1z * pbz)
    return inner, s1 * s2, det


def _np_bond_parts(px, py, pz):
    """Bond-angle parts in numpy f32 (float3d.h:36-44 rounding order).
    px/py/pz: [3L, B]; returns (inner, s1*s2) each [3L-2, B]."""
    ax, ay, az = px[:-2], py[:-2], pz[:-2]
    bx, by, bz = px[1:-1], py[1:-1], pz[1:-1]
    cx, cy, cz = px[2:], py[2:], pz[2:]
    d1x, d1y, d1z = ax - bx, ay - by, az - bz
    d2x, d2y, d2z = cx - bx, cy - by, cz - bz
    inner = (d1x * d2x) + (d1y * d2y) + (d1z * d2z)
    s1 = d1x * d1x + d1y * d1y + d1z * d1z
    s2 = d2x * d2x + d2y * d2y + d2z * d2z
    return inner, s1 * s2


def _exact_sc_t(p0, p1, p2, p3):
    """Exact host recompute of flagged side-chain values: f32 dihedral
    parts with C op ordering + f64 acos tail, scaled to the 255-bin
    truncation domain. p0..p3: [M, 3] f32."""
    d1x, d1y, d1z = p1[:, 0] - p0[:, 0], p1[:, 1] - p0[:, 1], \
        p1[:, 2] - p0[:, 2]
    d2x, d2y, d2z = p2[:, 0] - p1[:, 0], p2[:, 1] - p1[:, 1], \
        p2[:, 2] - p1[:, 2]
    d3x, d3y, d3z = p3[:, 0] - p2[:, 0], p3[:, 1] - p2[:, 1], \
        p3[:, 2] - p2[:, 2]
    u1x = d1y * d2z - d2y * d1z
    u1y = d1z * d2x - d2z * d1x
    u1z = d1x * d2y - d2x * d1y
    u2x = d2y * d3z - d3y * d2z
    u2y = d2z * d3x - d3z * d2x
    u2z = d2x * d3y - d3x * d2y
    inner = (u1x * u2x) + (u1y * u2y) + (u1z * u2z)
    s1 = u1x * u1x + u1y * u1y + u1z * u1z
    s2 = u2x * u2x + u2y * u2y + u2z * u2z
    pbx = u2y * d2z - d2y * u2z
    pby = u2z * d2x - d2z * u2x
    pbz = u2x * d2y - d2x * u2y
    det = (u1x * pbx) + (u1y * pby) + (u1z * pbz)
    ang = _host_dihedral(inner, s1 * s2, det)
    return ((ang + np.float32(180.0)) * _SC_DISC_F).astype(F32)


# header stream order (foldcomp.cpp:508-519): bit s of the device flag /
# candidate bitmaps <-> stream s here. Dihedral streams use 4-atom windows
# starting at flat backbone row 3*i + off; bond streams 3-atom windows.
_STREAMS = (
    ("d", 2, 2 ** 12 - 1),   # phi_i   = tors[3i+2]
    ("d", 0, 2 ** 12 - 1),   # psi_i   = tors[3i]
    ("d", 1, 2 ** 11 - 1),   # omega_i = tors[3i+1]
    ("b", 3, 2 ** 8 - 1),    # n_ca_c_i = angs[3i+3]
    ("b", 1, 2 ** 8 - 1),    # ca_c_n_i = angs[3i+1]
    ("b", 2, 2 ** 8 - 1),    # c_n_ca_i = angs[3i+2]
)


def _exact_stream_values(bb, bs, ls, ss):
    """Exact (reference-bit) stream values for selected rows.

    bb f32 [B, L, 3, 3]; bs/ls/ss: selected (protein, residue, stream)
    triples. Gathers the 3- or 4-atom windows and finishes with the C op
    ordering + f64 acos — identical results to the full-stream numpy path
    (_np_dihedral_parts/_np_bond_parts + _host_dihedral/_host_bond)."""
    out = np.zeros(len(bs), F32)
    flat = bb.reshape(bb.shape[0], -1, 3)            # [B, 3L, 3]
    kinds = np.array([0 if _STREAMS[s][0] == "d" else 1
                      for s in range(6)])[ss]
    offs = np.array([_STREAMS[s][1] for s in range(6)])[ss]
    start = 3 * ls + offs
    for kind in (0, 1):
        m = kinds == kind
        if not m.any():
            continue
        sb, st = bs[m], start[m]
        p = [flat[sb, st + j] for j in range(4 if kind == 0 else 3)]
        if kind == 0:
            inner, denom2, det = _np_dihedral_parts_rows(*p)
            out[m] = _host_dihedral(inner, denom2, det)
        else:
            inner, denom2 = _np_bond_parts_rows(*p)
            out[m] = _host_bond(inner, denom2)
    return out


def _np_dihedral_parts_rows(p0, p1, p2, p3):
    """_np_dihedral_parts for gathered [M, 3] windows (same op order)."""
    d1 = (p1 - p0).T
    d2 = (p2 - p1).T
    d3 = (p3 - p2).T
    u1x = d1[1] * d2[2] - d2[1] * d1[2]
    u1y = d1[2] * d2[0] - d2[2] * d1[0]
    u1z = d1[0] * d2[1] - d2[0] * d1[1]
    u2x = d2[1] * d3[2] - d3[1] * d2[2]
    u2y = d2[2] * d3[0] - d3[2] * d2[0]
    u2z = d2[0] * d3[1] - d3[0] * d2[1]
    inner = (u1x * u2x) + (u1y * u2y) + (u1z * u2z)
    s1 = u1x * u1x + u1y * u1y + u1z * u1z
    s2 = u2x * u2x + u2y * u2y + u2z * u2z
    pbx = u2y * d2[2] - d2[1] * u2z
    pby = u2z * d2[0] - d2[2] * u2x
    pbz = u2x * d2[1] - d2[0] * u2y
    det = (u1x * pbx) + (u1y * pby) + (u1z * pbz)
    return inner, s1 * s2, det


def _np_bond_parts_rows(a, b, c):
    """_np_bond_parts for gathered [M, 3] windows (same op order)."""
    d1 = (a - b).T
    d2 = (c - b).T
    inner = (d1[0] * d2[0]) + (d1[1] * d2[1]) + (d1[2] * d2[2])
    s1 = d1[0] * d1[0] + d1[1] * d1[1] + d1[2] * d1[2]
    s2 = d2[0] * d2[0] + d2[1] * d2[1] + d2[2] * d2[2]
    return inner, s1 * s2


def _host_quant_one(v, vmin, disc_f):
    """Single-value reference discretize (discretizer.cpp:43-53)."""
    t = ((v - vmin) * disc_f).astype(F32).astype(np.float64) + 0.5
    t = np.where(np.isnan(t) | (t < 0), 0.0, t)
    return t.astype(np.uint32)


def finish_encode_device(parts, atom14, res_code, tf_ca, res_mask):
    """Sparse host finishing for the full-device parity encode.

    The device produced every record/sc/tf bin plus rescue metadata
    (kernels/encode.py encode_parity_core). Host work is O(B + flagged):

    1. exact quantizer extremes: recompute the device-flagged min/max
       candidate rows with reference-bit math, scatter-min/max into
       per-(protein, stream) vmin/vmax, derive disc_f/cont_f (the header
       floats must be exact, so they are ALWAYS host-derived);
    2. rescue flagged bins: exact value + exact params -> exact code,
       patched into the device records (unpack/patch/repack of only the
       affected rows);
    3. side-chain rescue + tempFactors exactly as finish_encode_host
       (tf inputs are exact f32s, so its min/max need no candidates).

    Proteins with n_res < 4 route through the full-host path — the
    degenerate-stream semantics (empty masks, inf ranges) are not worth
    replicating on device."""
    atom14 = np.asarray(atom14, F32)
    bb = atom14[:, :, :3]
    res_code = np.asarray(res_code)
    tf_ca = np.asarray(tf_ca, F32)
    res_mask = np.asarray(res_mask, bool)
    b, l = res_code.shape
    n_res = res_mask.sum(axis=1).astype(np.int64)

    small = n_res < 4
    records = np.asarray(parts["records"], np.uint8).copy()
    bb_flags = np.asarray(parts["bb_flags"])
    cand_bits = np.asarray(parts["cand_bits"])

    # 1. exact extremes from the candidate sets
    vmin = np.full((b, 6), np.inf, F32)
    vmax = np.full((b, 6), -np.inf, F32)
    cm = ((cand_bits[:, :, None] >> np.arange(6)) & 1) > 0     # [B, L, 6]
    cx = ((cand_bits[:, :, None] >> (np.arange(6) + 8)) & 1) > 0
    anym = cm | cx
    if anym.any():
        bs, ls, ss = np.nonzero(anym)
        vals = _exact_stream_values(bb, bs, ls, ss)
        sel_min = cm[bs, ls, ss]
        np.minimum.at(vmin, (bs[sel_min], ss[sel_min]), vals[sel_min])
        sel_max = cx[bs, ls, ss]
        np.maximum.at(vmax, (bs[sel_max], ss[sel_max]), vals[sel_max])
    nbins = np.array([s[2] for s in _STREAMS], F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        rng = (vmax - vmin).astype(F32)
        disc_f = (nbins[None, :] / rng).astype(F32)
        cont_f = (rng / nbins[None, :]).astype(F32)

    # 2. rescue flagged bins into the records
    fl = ((bb_flags[:, :, None] >> np.arange(6)) & 1) > 0      # [B, L, 6]
    # only rows the serializer emits matter (i < n_res - 1)
    fl &= (np.arange(l)[None, :, None] < (n_res[:, None, None] - 1))
    fl &= ~small[:, None, None]
    if fl.any():
        from .fcz import pack_records as _pack_np
        from .fcz import unpack_records as _unpack_np
        bs, ls, ss = np.nonzero(fl)
        vals = _exact_stream_values(bb, bs, ls, ss)
        q_new = _host_quant_one(vals, vmin[bs, ss], disc_f[bs, ss])
        rows = np.unique(bs * l + ls)
        rb, rl = rows // l, rows % l
        # unpack order == stream-index order shifted by the residue field
        fields = list(_unpack_np(records[rb, rl]))
        pos = np.searchsorted(rows, bs * l + ls)
        for s in range(6):
            m = ss == s
            if m.any():
                fields[1 + s][pos[m]] = q_new[m]
        records[rb, rl] = _pack_np(*fields)

    # 3. side-chain rescue + tempFactors (same as finish_encode_host)
    sc_q = _rescue_sc(parts, atom14, res_code, res_mask)
    tf_q, tf_min, tf_cont = _host_quant_round(tf_ca.T, res_mask.T,
                                              2 ** 8 - 1)
    tf_q = np.where(res_mask, tf_q.T, 0).astype(np.uint8)

    out = dict(records=records, sc_q=sc_q, tf_q=tf_q, mins=vmin,
               cont_fs=cont_f, tf_min=tf_min, tf_cont=tf_cont)

    if small.any():
        idx = np.nonzero(small)[0]
        sub = finish_encode_host(
            dict(sc_q=sc_q[idx], sc_flag_bits=np.zeros((len(idx), l),
                                                       np.uint16)),
            atom14[idx], res_code[idx], tf_ca[idx], res_mask[idx])
        out["records"][idx] = sub["records"]
        out["mins"][idx] = sub["mins"]
        out["cont_fs"][idx] = sub["cont_fs"]
    return out


def _rescue_sc(parts, atom14, res_code, res_mask):
    """Flagged side-chain code rescue (shared with finish_encode_host)."""
    q = np.asarray(parts["sc_q"], np.uint8).copy()   # [B, L, 11]
    fb = np.asarray(parts["sc_flag_bits"])           # u16 [B, L]
    flagged = ((fb[:, :, None] >> np.arange(11)) & 1) > 0
    counts = np.where(res_code < NUM_AA, N_SC_TORSION[res_code], 0)
    emitted = (np.arange(q.shape[2])[None, None, :]
               < counts[:, :, None]) & res_mask[:, :, None]
    flagged &= emitted
    if flagged.any():
        from ..core.aatable import PRED_IDX
        bs, ls, ks = np.nonzero(flagged)
        codes = np.clip(res_code[bs, ls], 0, 23)
        preds = np.asarray(PRED_IDX)[codes, ks + 3]
        p0 = atom14[bs, ls, preds[:, 0]]
        p1 = atom14[bs, ls, preds[:, 1]]
        p2 = atom14[bs, ls, preds[:, 2]]
        p3 = atom14[bs, ls, ks + 3]
        t_new = _exact_sc_t(p0, p1, p2, p3)
        t_new = np.where(np.isnan(t_new) | (t_new < 0),
                         np.float32(0.0), t_new)
        q[bs, ls, ks] = t_new.astype(np.uint32).astype(np.uint8)
    return q


def finish_encode_host(sc_parts, atom14, res_code, tf_ca, res_mask):
    """Host half of the bit-parity batched encode.

    Computes the 6 backbone streams entirely in numpy f32 + the
    reference's f64-promoted acos (bit-identical to the exact path), and
    finishes the device-computed side-chain parts the same way. Returns
    the same dict encode_batch_core produces:
    records/sc_q/tf_q/mins/cont_fs/tf_min/tf_cont.
    """
    from .fcz import pack_records as pack_records_np

    atom14 = np.asarray(atom14, F32)
    bb = atom14[:, :, :3]
    res_code = np.asarray(res_code)
    tf_ca = np.asarray(tf_ca, F32)
    res_mask = np.asarray(res_mask, bool)
    b, l = res_code.shape
    n_res = res_mask.sum(axis=1).astype(np.int64)

    flat = np.transpose(bb.reshape(b, 3 * l, 3), (1, 2, 0))  # [3L, 3, B]
    fx, fy, fz = flat[:, 0], flat[:, 1], flat[:, 2]
    t_inner, t_denom2, t_det = _np_dihedral_parts(fx, fy, fz)
    a_inner, a_denom2 = _np_bond_parts(fx, fy, fz)

    tors = _host_dihedral(t_inner, t_denom2, t_det)        # [3L-3, B]
    psi, omega, phi = tors[0::3], tors[1::3], tors[2::3]
    angs = _host_bond(a_inner, a_denom2)
    ca_c_n, c_n_ca, n_ca_c = angs[1::3], angs[2::3], angs[3::3]

    i = np.arange(l - 1, dtype=np.int64)[:, None]
    amask = i < (n_res[None, :] - 1)                       # [L-1, B]

    def q6(v, nbin):
        return _host_quant_round(v, amask[:v.shape[0]], nbin)

    phi_q, phi_min, phi_cf = q6(phi, 2 ** 12 - 1)
    psi_q, psi_min, psi_cf = q6(psi, 2 ** 12 - 1)
    om_q, om_min, om_cf = q6(omega, 2 ** 11 - 1)
    ncac_q, ncac_min, ncac_cf = q6(n_ca_c, 2 ** 8 - 1)
    cacn_q, cacn_min, cacn_cf = q6(ca_c_n, 2 ** 8 - 1)
    cnca_q, cnca_min, cnca_cf = q6(c_n_ca, 2 ** 8 - 1)

    amask_l = np.arange(l)[None, :] < (n_res[:, None] - 1)  # [B, L]

    def to_bl(q):
        out = np.zeros((b, l), np.uint32)
        out[:, :q.shape[0]] = q.T
        return np.where(amask_l, out, 0)

    residue = np.where(res_mask, res_code, 0).astype(np.uint32)
    records = pack_records_np(
        residue.reshape(-1), to_bl(phi_q).reshape(-1),
        to_bl(psi_q).reshape(-1), to_bl(om_q).reshape(-1),
        to_bl(ncac_q).reshape(-1), to_bl(cacn_q).reshape(-1),
        to_bl(cnca_q).reshape(-1)).reshape(b, l, 8)

    # Side chains: the device quantized them (fixed [-180,180] 255-bin
    # truncating quantizer, foldcomp.cpp:532-538) and flagged every value
    # within ulp-tolerance of a truncation boundary plus all NaN-guard
    # outputs (kernels/encode.py encode_sc_q_core). Unflagged bins cannot
    # differ from the exact path; flagged ones (~1e-3 of values) are
    # recomputed in _rescue_sc with the exact f32 parts + f64 acos.
    sc_q = _rescue_sc(sc_parts, atom14, res_code, res_mask)

    # tempFactors: per-protein rounding quantizer (foldcomp.cpp:543-550)
    tf_q, tf_min, tf_cont = _host_quant_round(tf_ca.T, res_mask.T,
                                              2 ** 8 - 1)
    tf_q = np.where(res_mask, tf_q.T, 0).astype(np.uint8)

    mins = np.stack([phi_min, psi_min, om_min, ncac_min, cacn_min,
                     cnca_min], axis=-1)
    cont_fs = np.stack([phi_cf, psi_cf, om_cf, ncac_cf, cacn_cf, cnca_cf],
                       axis=-1)
    return dict(records=records, sc_q=sc_q, tf_q=tf_q, mins=mins,
                cont_fs=cont_fs, tf_min=tf_min, tf_cont=tf_cont)


def _slot_lut():
    """uint64 key table: (code << 32) | name4-as-u32 -> atom14 slot."""
    from ..core.aatable import NAME_TO_SLOT

    keys, slots = [], []
    for code in range(NUM_AA):
        for name, slot in NAME_TO_SLOT[code].items():
            field = name.ljust(4) if len(name) == 4 else " " + name.ljust(3)
            k = (np.uint64(code) << np.uint64(32)) | np.uint64(
                int.from_bytes(field.encode(), "little"))
            keys.append(k)
            slots.append(slot)
    keys = np.asarray(keys, np.uint64)
    order = np.argsort(keys)
    return keys[order], np.asarray(slots, np.int32)[order]


_SLOT_KEYS = None
_SLOT_VALS = None


def atoms_to_tensors_vec(name4: np.ndarray, res3: np.ndarray,
                         residue_index: np.ndarray, coords: np.ndarray,
                         temp: np.ndarray):
    """Vectorized fragment -> dense per-residue tensors.

    name4: uint8 [N, 4] raw PDB name columns; res3: uint8 [N, 3];
    residue_index/coords/temp as parsed. Returns (atom14 [L,14,3],
    res_code [L], tf_ca [L], groups_start [L]). First-occurrence-wins slot
    assignment (findFirstAtomCoords parity) via reversed scatter.
    """
    global _SLOT_KEYS, _SLOT_VALS
    if _SLOT_KEYS is None:
        _SLOT_KEYS, _SLOT_VALS = _slot_lut()
    from ..core.codes import int_from_three_letter

    n = len(residue_index)
    # residue groups: boundaries where residue_index changes; the final
    # atom always joins the current group (splitAtomByResidue parity)
    change = np.empty(n, bool)
    change[0] = True
    if n > 1:
        change[1:] = residue_index[1:] != residue_index[:-1]
        change[n - 1] = False
        change[0] = True
    gstart = np.flatnonzero(change)
    n_res = len(gstart)
    group_of = np.cumsum(change) - 1          # [N] residue ordinal per atom

    # residue codes from the group-start residue names
    res_code = np.asarray(
        [int_from_three_letter(bytes(res3[i]).decode("latin1").strip())
         for i in gstart], np.int32)

    # atom slot lookup: key = (code << 32) | name4 bytes
    name_u32 = name4.view(np.uint32).reshape(-1).astype(np.uint64)
    code_per_atom = res_code[group_of].astype(np.uint64)
    keys = (code_per_atom << np.uint64(32)) | name_u32
    pos = np.searchsorted(_SLOT_KEYS, keys)
    pos = np.clip(pos, 0, len(_SLOT_KEYS) - 1)
    valid = _SLOT_KEYS[pos] == keys
    slot = np.where(valid, _SLOT_VALS[pos], -1)

    atom14 = np.zeros((n_res, 14, 3), F32)
    # reversed order => the FIRST occurrence ends up winning
    rev = np.arange(n - 1, -1, -1)
    vr = rev[valid[rev]]
    atom14[group_of[vr], slot[vr]] = coords[vr]

    tf_ca = np.zeros(n_res, F32)
    is_ca = valid & (slot == 1)
    cr = rev[is_ca[rev]]
    tf_ca[group_of[cr]] = temp[cr]
    return atom14, res_code, tf_ca, gstart


def fragment_to_tensors(atoms: AtomArray):
    """One continuous single-chain fragment -> dense per-residue tensors.

    Returns (atom14 [L,14,3] f32, res_code [L] i32, tf_ca [L] f32, meta dict).
    Missing atoms are zeroed (findFirstAtomCoords parity,
    sidechain.cpp:140-147); atoms land in reference-table slots.
    """
    from ..core.aatable import NAME_TO_SLOT
    from ..core.codes import int_from_three_letter, one_letter_from_three
    from .encoder import EncodeError, residue_name_vector, split_by_residue

    groups = split_by_residue(atoms)
    rnames = residue_name_vector(atoms)
    n = len(groups)
    if n < 2:
        raise EncodeError("fragment must contain at least 2 residues")
    atom14 = np.zeros((n, 14, 3), F32)
    res_code = np.zeros(n, I32)
    tf_ca = np.zeros(n, F32)
    for r, ((start, end), rname) in enumerate(zip(groups, rnames)):
        code = int_from_three_letter(rname)
        res_code[r] = code
        slot_of = NAME_TO_SLOT[code] if code < NUM_AA else \
            {"N": 0, "CA": 1, "C": 2}
        seen = set()
        for i in range(start, end):
            nm = atoms.atom_name[i]
            if nm in seen:
                continue
            seen.add(nm)
            if nm == "CA":
                tf_ca[r] = atoms.temp_factor[i]
            slot = slot_of.get(nm)
            if slot is not None:
                atom14[r, slot] = atoms.coords[i]
    meta = dict(
        n_atom=len(atoms),
        idx_residue=int(atoms.residue_index[0]),
        idx_atom=int(atoms.atom_index[0]),
        chain=atoms.chain[0][:1] if atoms.chain[0] else "\x00",
        first_residue=one_letter_from_three(atoms.residue_name[0]),
        last_residue=one_letter_from_three(atoms.residue_name[-1]),
        title=atoms.title,
        has_oxt=atoms.atom_name[-1] == "OXT",
        oxt_coords=(atoms.coords[-1].astype(F32)
                    if atoms.atom_name[-1] == "OXT" else np.zeros(3, F32)),
    )
    return atom14, res_code, tf_ca, meta


def _anchor_indices(n_res: int, threshold: int):
    """_setAnchor parity (foldcomp.cpp:745-761)."""
    n_inner = n_res // threshold
    n_all = n_inner + 2
    interval = n_res // (n_all - 1)
    return np.asarray([i * interval for i in range(n_all - 1)] + [n_res - 1],
                      I32)


def encode_pdb_device(data: bytes, anchor_threshold: int = 25,
                      title: str | None = None, fallback_title: str = ""):
    """PDB buffer -> fragments ready for the device encoder, all host work
    vectorized over raw parse arrays (no per-atom Python).

    Returns (frag_tensors, frag_meta) where frag_tensors is a list of
    (atom14, res_code, tf_ca) and frag_meta mirrors the native encoder's
    fragment dicts (chain/frag ordinals for output naming), or None when
    the native parser is unavailable.
    """
    from ..core.codes import one_letter_from_three
    from ..native import _parse_raw, get_lib

    lib = get_lib()
    if lib is None:
        return None
    raw = _parse_raw(lib, data)
    n = raw["n"]
    if n == 0:
        return [], []
    name4 = np.frombuffer(raw["name4"].raw[:n * 4], np.uint8) \
        .reshape(n, 4).copy()
    res3 = np.frombuffer(raw["res3"].raw[:n * 3], np.uint8) \
        .reshape(n, 3).copy()
    chain = np.frombuffer(raw["chain"].raw[:n], np.uint8).copy()
    ridx = raw["residue_index"][:n]
    aidx = raw["atom_index"][:n]
    coords = raw["coords"][:n]
    temp = raw["temp"][:n]
    if title is None:
        title = raw["title"] or fallback_title

    # removeAlternativePosition: drop consecutive duplicate atom names
    keep = np.ones(n, bool)
    if n > 1:
        keep[1:] = (name4[1:] != name4[:-1]).any(axis=1)
    sel = np.flatnonzero(keep)
    name4, res3, chain = name4[sel], res3[sel], chain[sel]
    ridx, aidx, coords, temp = ridx[sel], aidx[sel], coords[sel], temp[sel]
    n = len(sel)

    is_n_atom = (name4 == np.frombuffer(b" N  ", np.uint8)).all(axis=1)

    # chain fragmentation (identify_chains semantics: fragments may skip a
    # leading non-N run of a new chain)
    chains = []
    start = 0
    i = 1
    while i < n:
        if chain[i] != chain[i - 1]:
            if is_n_atom[i]:
                chains.append((start, i))
                start = i
            else:
                nxt = np.flatnonzero(is_n_atom[i:])
                if len(nxt):
                    chains.append((start, i))
                    start = i + int(nxt[0])
                    i = start
        i += 1
    chains.append((start, n))

    frag_tensors, frag_meta = [], []
    for c_ord, (c0, c1) in enumerate(chains):
        n_pos = np.flatnonzero(is_n_atom[c0:c1]) + c0
        if len(n_pos) == 0:
            frags = [(c0, c1)]
        else:
            gaps = np.flatnonzero(np.diff(ridx[n_pos]) > 1) + 1
            starts = [int(n_pos[0])] + [int(n_pos[g]) for g in gaps]
            frags = [(s, e) for s, e in
                     zip(starts, starts[1:] + [c1])]
        for f_ord, (f0, f1) in enumerate(frags):
            atom14, res_code, tf_ca, _ = atoms_to_tensors_vec(
                name4[f0:f1], res3[f0:f1], ridx[f0:f1], coords[f0:f1],
                temp[f0:f1])
            if len(res_code) < 2:
                frag_meta.append(dict(error="fragment must contain at "
                                      "least 2 residues", chain_ord=c_ord,
                                      frag_ord=f_ord,
                                      n_frags_in_chain=len(frags),
                                      n_chains=len(chains)))
                frag_tensors.append(None)
                continue
            first3 = bytes(res3[f0]).decode("latin1").strip()
            last3 = bytes(res3[f1 - 1]).decode("latin1").strip()
            frag_meta.append(dict(
                error=None,
                n_atom=f1 - f0,
                idx_residue=int(ridx[f0]), idx_atom=int(aidx[f0]),
                chain=chr(chain[f0]),
                first_residue=one_letter_from_three(first3),
                last_residue=one_letter_from_three(last3),
                title=title,
                has_oxt=bytes(name4[f1 - 1]) == b" OXT",
                oxt_coords=(coords[f1 - 1].astype(F32)
                            if bytes(name4[f1 - 1]) == b" OXT"
                            else np.zeros(3, F32)),
                chain_ord=c_ord, frag_ord=f_ord,
                n_frags_in_chain=len(frags), n_chains=len(chains)))
            frag_tensors.append((atom14, res_code, tf_ca))
    return frag_tensors, frag_meta


class _ScratchPool:
    """Recycled numpy buffers for the encode pack path.

    First-touch page faults on this VM cost ~40 ms per fresh 35 MB
    buffer; recycling keeps the pack at warm-memory speed. Buffers
    handed to the device copy stay owned by the submit handle and return
    to the pool in finish_encode, after the device copy has consumed
    them."""

    _MAX_PER_KEY = 2      # submit/finish pipelining needs at most 2
    _MAX_KEYS = 16        # distinct (shape, dtype) classes kept alive

    def __init__(self):
        self._free = {}

    def take(self, shape, dtype):
        lst = self._free.get((shape, np.dtype(dtype).str))
        return lst.pop() if lst else np.empty(shape, dtype)

    def give(self, *arrays):
        for a in arrays:
            if a is None:
                continue
            key = (a.shape, a.dtype.str)
            lst = self._free.setdefault(key, [])
            if len(lst) < self._MAX_PER_KEY:
                lst.append(a)
            if len(self._free) > self._MAX_KEYS:
                # many distinct batch shapes streamed through: drop the
                # lot rather than hold every shape class forever
                self._free = {key: lst}


_POOL = _ScratchPool()


def _compact_coord_batch(atom14):
    """f32 [B, L, 14, 3] -> (base i32, delta i16, present u16) or None.

    Millicoordinate form for the wire (see encode_sc_q_core_compact):
    valid only when every coordinate is the f32 of an integer number of
    milli-angstroms below 2^24 (3-decimal PDB/CIF coords always are) and
    every atom sits within int16 range of its residue's first present
    atom. The rounding runs in f32 (exact recovery holds to ~8000 A,
    the PDB format's own coordinate range) and is then VERIFIED by exact
    reconstruction against the correctly rounded division the device
    replays; returns None when any element fails, and the caller falls
    back to the f32 transfer. All large intermediates run in-place on
    pooled scratch; the returned delta buffer belongs to the submit
    handle and is recycled by encode_finish."""
    shape = atom14.shape
    s = _POOL.take(shape, np.float32)
    np.multiply(atom14, np.float32(1000.0), out=s)
    np.rint(s, out=s)
    smax, smin = s.max(), s.min()
    if not (smax < 2 ** 24 and smin > -(2 ** 24)):   # False on NaN too
        _POOL.give(s)
        return None
    xi = _POOL.take(shape, np.int32)
    np.copyto(xi, s, casting="unsafe")
    np.copyto(s, xi, casting="unsafe")               # s = f32(xi), exact
    np.divide(s, np.float32(1000.0), out=s)
    if not np.array_equal(s, atom14):
        _POOL.give(s, xi)
        return None
    present = xi.any(axis=3)                         # [B, L, 14]
    first = np.argmax(present, axis=2)               # 0 if none present
    base = np.ascontiguousarray(np.take_along_axis(
        xi, first[:, :, None, None].repeat(3, 3), axis=2)[:, :, 0])
    np.subtract(xi, base[:, :, None, :], out=xi)
    np.multiply(xi, present[..., None], out=xi)      # absent slots -> 0
    if not (-(2 ** 15) < xi.min() and xi.max() < 2 ** 15):
        _POOL.give(s, xi)
        return None
    delta = _POOL.take(shape, np.int16)
    np.copyto(delta, xi, casting="unsafe")
    bits = (present << np.arange(14)[None, None, :]).sum(
        axis=2).astype(np.uint16)
    _POOL.give(s, xi)
    return base, delta, bits


def finish_encode(handle):
    """Host half of the batched device encode's stage 2: the parts of the
    full device encode (backbone records too), already host arrays,
    through the sparse host finish, then the FczData assembly. Returns
    List[FczData | None] in the order of the submitted tensors."""
    results = [None] * handle["n"]
    live = handle["live"]
    if not live:
        return results
    frag_meta = handle["frag_meta"]
    anchor_threshold = handle["anchor_threshold"]
    atom14, res_code = handle["atom14"], handle["res_code"]
    parts = {k: np.asarray(v) for k, v in handle["parts"].items()}
    out = finish_encode_device(parts, atom14, res_code, handle["tf_ca"],
                               handle["res_mask"])
    # the device outputs are materialized, so the H2D transfer consumed
    # the pooled input buffers: recycle them for the next submit (pop so
    # a double-finish cannot hand the same buffer out twice)
    _POOL.give(handle.pop("atom14"), handle.pop("delta_buf", None),
               *handle.pop("wire_bufs", ()))
    # side-chain stream compaction for the whole batch in one masked
    # fancy-index: sc_q is [B, L, 11] row-major, so selecting slot j of
    # residue r where j < n_sc_torsion(residue r) preserves the per-entry
    # (residue, slot) stream order the serializer needs
    slot_idx = np.arange(out["sc_q"].shape[2])
    for k, (i, (a14, rc, tf)) in enumerate(live):
        meta = frag_meta[i]
        nres = a14.shape[0]
        anchors = _anchor_indices(nres, anchor_threshold)
        if len(anchors) > 255:
            # nAnchor is a uint8 header field; see encoder.encode
            continue
        counts = np.where(rc < NUM_AA, N_SC_TORSION[rc], 0)
        sc_stream = out["sc_q"][k, :nres][slot_idx[None, :] <
                                          counts[:, None]]
        results[i] = FczData(
            n_residue=nres, n_atom=meta["n_atom"],
            idx_residue=meta["idx_residue"], idx_atom=meta["idx_atom"],
            n_anchor=len(anchors), chain=meta["chain"],
            n_sc_torsion=len(sc_stream),
            first_residue=meta["first_residue"],
            last_residue=meta["last_residue"], title=meta["title"],
            mins=out["mins"][k], cont_fs=out["cont_fs"][k],
            anchor_indices=anchors,
            anchor_coords=a14[anchors, :3].astype(F32),
            has_oxt=meta["has_oxt"], oxt_coords=meta["oxt_coords"],
            records=out["records"][k, :nres],
            sc_codes=sc_stream.astype(np.uint8),
            tf_min=np.float32(out["tf_min"][k]),
            tf_cont=np.float32(out["tf_cont"][k]),
            tf_codes=out["tf_q"][k, :nres].astype(np.uint8))
    return results
