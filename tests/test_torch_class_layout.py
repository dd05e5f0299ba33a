"""The one class layout of a decode batch (foldcomp_tpu_torch/kernels/
fused_decode.py class_layout), which k0, k1 and k2 read: held here, pure
Python on the CPU, to the kernels' rules (csrc/fused_decode.cu k0_prep,
k1_tails, k2_backbone): every code slot, lane and sort taken once, in the
blocks of the classes' launch order (the widest SEG first); every view of
the workspaces aligned, inside them and disjoint; empty and one-lane
classes; the bb wire without code planes. The kernels run only
on the card (tests/test_torch_prep.py's card tests and chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from foldcomp_tpu_torch.core import tables as T
from foldcomp_tpu_torch.kernels import fused_decode as FD

K0_SLOTS = {"code": torch.int32, "tat": torch.int32, "mins6": torch.float32,
            "cont6": torch.float32, "order": torch.int32}


def _widest_first(nls, segs):
    """The classes that have lanes and rows, the widest SEG first, ties in
    class order."""
    return sorted((c for c in range(len(nls)) if nls[c] and segs[c]),
                  key=lambda c: -segs[c])


def _sizes(kernel, seed):
    """Class sizes and widths of each kernel's cases: one to MAX_CLASSES
    classes; k0 a class empty in odd seeds and a one-lane class in even
    ones, seed 0 over several sort blocks; k0_bb up to three sort blocks a
    class; k1 and k2 a class empty in odd seeds, NL not a multiple of the
    block sizes but in seed 0."""
    rng = np.random.default_rng({"k0": 0, "k0_bb": 100}.get(kernel, 0)
                                + seed)
    n_cls = int(rng.integers(1, T.MAX_CLASSES + 1))
    if kernel == "k0_bb":
        nls = [int(rng.integers(1, 3 * FD.K0_SORT_LANES))
               for _ in range(n_cls)]
        return nls, [int(rng.integers(1, 50)) for _ in range(n_cls)]
    nls = [int(rng.integers(1, 900 if kernel == "k2" else 700))
           for _ in range(n_cls)]
    if kernel == "k0":
        if seed == 0:
            nls = [3 * FD.K0_SORT_LANES + 5, FD.K0_SORT_LANES, 1,
                   2 * FD.K0_SORT_LANES - 1][:n_cls]
        segs = [int(rng.integers(1, 50)) for _ in range(n_cls)]
        if seed % 2 and n_cls > 1:
            nls[int(rng.integers(n_cls))] = 0
        if seed % 2 == 0:
            nls[int(rng.integers(n_cls))] = 1
        return nls, segs
    if seed == 0:
        nls = [1024, 512, 256, 128][:n_cls]
    if seed % 2 and n_cls > 1:
        nls[int(rng.integers(n_cls))] = 0
    return nls, [8 * int(rng.integers(1, 13)) for _ in range(n_cls)]


def _owner(starts, b):
    """The kernels' rule: the last class whose first block (or unit) is
    <= b."""
    return int(np.searchsorted(starts, b, side="right")) - 1


def _cover_k0(lay, nls, segs):
    """k0's rule over the layout: the sort blocks (K0_SORT_LANES lanes of
    a class each), then every unit of the grid, code slots (none in bb
    mode) or a lane. -> per class: times each code slot is written, each
    lane's outputs are written, each lane is sorted."""
    code = [np.zeros(s * n, int) for s, n in zip(segs, nls)]
    lanes = [np.zeros(n, int) for n in nls]
    sorted_ = [np.zeros(n, int) for n in nls]
    sort0 = [g.sort0 for g in lay.launch]
    for b in range(lay.sorts):
        g = lay.launch[_owner(sort0, b)]
        lo = (b - g.sort0) * FD.K0_SORT_LANES
        sorted_[g.c][lo:lo + FD.K0_SORT_LANES] += 1
    blocks = lay.sorts - (-lay.units // FD.K0_THREADS)
    stride = (blocks - lay.sorts) * FD.K0_THREADS
    first = np.arange(stride)     # (b - sorts) * K0_THREADS + t
    unit0 = np.array([g.unit0 for g in lay.launch])
    for step in range(0, max(lay.units, 1), max(stride, 1)):
        u = first + step
        u = u[u < lay.units]
        for i, g in enumerate(lay.launch):
            mine = u[np.searchsorted(unit0, u, side="right") - 1 == i] \
                - g.unit0
            quads = 0 if lay.bb else -(-g.seg * g.nl // FD.K0_CODE_UNIT)
            for j in mine[mine < quads]:
                code[g.c][j * FD.K0_CODE_UNIT:(j + 1) * FD.K0_CODE_UNIT] += 1
            np.add.at(lanes[g.c], mine[mine >= quads] - quads, 1)
    return code, lanes, sorted_


def _cover_k1(lay, nls):
    """k1's rule over the layout: block b to its class, thread t to lane
    order[(b - block0) * K1_THREADS + t] of it (each class's order a
    random permutation), written at column col0 + lane. -> ({(class,
    lane): times taken}, {column: times written})."""
    rng = np.random.default_rng(len(nls))
    orders = [rng.permutation(n) for n in nls]
    block0 = [g.block0 for g in lay.launch]
    taken, cols = {}, {}
    for b in range(lay.blocks):
        g = lay.launch[_owner(block0, b)]
        for t in range(FD.K1_THREADS):
            i = (b - g.block0) * FD.K1_THREADS + t
            if i < g.nl:
                lane = int(orders[g.c][i])
                taken[g.c, lane] = taken.get((g.c, lane), 0) + 1
                cols[g.col0 + lane] = cols.get(g.col0 + lane, 0) + 1
    return taken, cols


def _hold_k0_views(lay, nls, segs):
    """Each class's k0 outputs as the wrapper hands them to the kernel:
    their shapes and types, contiguous, 128-byte aligned, inside the
    workspace and disjoint; no code plane on the bb wire."""
    ws = torch.zeros(lay.k0_size, dtype=torch.int32)
    used = np.zeros(lay.k0_size, int)
    for c, slots in enumerate(lay.k0):
        seg, nl = segs[c], nls[c]
        (v,) = FD._views(ws, [slots])
        want = {"code": (seg, nl), "tat": (nl,), "mins6": (6, nl),
                "cont6": (6, nl), "order": (nl,)}
        if lay.bb:
            del want["code"]
        assert {k: (tuple(t.shape), t.dtype) for k, t in v.items()} == {
            k: (s, K0_SLOTS[k]) for k, s in want.items()}
        for t in v.values():
            at = t.storage_offset()
            assert t.is_contiguous() and at % 32 == 0
            assert at + t.numel() <= lay.k0_size
            used[at:at + t.numel()] += 1
    assert used.max(initial=0) <= 1


@pytest.mark.parametrize("kernel, seed", [("k0", s) for s in range(6)]
                         + [("k0_bb", s) for s in range(3)]
                         + [("k1", s) for s in range(6)]
                         + [("k2", s) for s in range(6)])
def test_layout_covers_every_lane_once(kernel, seed):
    """Each kernel's rule over the one layout of random class sizes and
    widths: k0 writes every code slot and every lane of every class once
    and sorts every lane once (on the bb wire no code slot, and the
    workspace smaller by the code planes alone); k1 takes each lane once
    and writes each column of [0, NL_total) once; k2_backbone walks each
    lane once, and each class's k2 outputs are sx, sy, sz and pos alone,
    disjoint and 128-byte aligned. The launch holds the classes with
    lanes, the widest first."""
    nls, segs = _sizes(kernel, seed)
    n_cls = len(nls)
    lay = FD.class_layout(nls, segs, "bb" if kernel == "k0_bb" else "full")
    assert [g.c for g in lay.launch] == _widest_first(nls, segs)
    assert all(g.nl == nls[g.c] and g.seg == segs[g.c] for g in lay.launch)
    if kernel in ("k0", "k0_bb"):
        code, lanes, sorted_ = _cover_k0(lay, nls, segs)
        for c in range(n_cls):
            assert (lanes[c] == 1).all() and (sorted_[c] == 1).all(), c
            if kernel == "k0":
                assert (code[c] == 1).all(), c
            else:
                assert not code[c].any(), c
        _hold_k0_views(lay, nls, segs)
        if kernel == "k0_bb":
            full = FD.class_layout(nls, segs)
            assert lay.sorts == full.sorts and lay.units == sum(nls)
            assert lay.k0_size == full.k0_size - sum(
                -(-s * n // 32) * 32 for s, n in zip(segs, nls))
    elif kernel == "k1":
        taken, cols = _cover_k1(lay, nls)
        assert taken == {(c, l): 1 for c in range(n_cls)
                         for l in range(nls[c])}
        assert cols == {j: 1 for j in range(sum(nls))}
    else:
        walked, _ = _cover_k1(lay, nls)
        assert walked == {(c, l): 1 for c in range(n_cls)
                          for l in range(nls[c])}
        assert lay.blocks == sum(-(-n // FD.K1_THREADS) for n in nls)
        spans = []
        for c, slots in enumerate(lay.k2):
            assert list(slots) == ["sx", "sy", "sz", "pos"]
            for name, (shape, at) in slots.items():
                assert shape == ((nls[c],) if name == "pos"
                                 else (3 * segs[c], nls[c]))
                assert at % 32 == 0
                spans.append((at, at + int(np.prod(shape))))
        spans.sort()
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert spans[-1][1] <= lay.k2_size


def _small_k0():
    lay = FD.class_layout([0, 0], [8, 16])
    assert (lay.launch, lay.k0_size, lay.sorts, lay.units) == ([], 0, 0, 0)
    u = FD.K0_CODE_UNIT
    # one lane: 1 sort block, 8 code slots, then the lane; 5 slots of 32
    lay = FD.class_layout([1], [8])
    assert lay.launch == [FD.ClassGeom(0, 8, 1, 0, 0, 0, 0)]
    assert (lay.k0_size, lay.sorts, lay.units) == (160, 1, -(-8 // u) + 1)
    assert lay.k0[0] == {
        "code": ((8, 1), 0), "tat": ((1,), 32), "mins6": ((6, 1), 64),
        "cont6": ((6, 1), 96), "order": ((1,), 128)}
    # an empty class between two: the classes follow one another
    lay = FD.class_layout([3, 0, 40], [24, 48, 16])
    part0 = FD.class_layout([3], [24]).k0_size
    u0 = -(-24 * 3 // u) + 3
    assert [(g.c, g.sort0, g.unit0) for g in lay.launch] == \
        [(0, 0, 0), (2, 1, u0)]
    assert lay.k0[2]["code"][1] == part0
    assert lay.sorts == 2 and lay.units == u0 + -(-16 * 40 // u) + 40
    assert lay.k0_size == part0 + FD.class_layout([40], [16]).k0_size
    # an empty class's outputs: empty views of the right shapes
    v = FD._views(torch.zeros(lay.k0_size, dtype=torch.int32), lay.k0)[1]
    assert {k: tuple(t.shape) for k, t in v.items()} == {
        "code": (48, 0), "tat": (0,), "mins6": (6, 0), "cont6": (6, 0),
        "order": (0,)}


def _small_k1():
    lay = FD.class_layout([0, 0], [8, 16])
    assert (lay.launch, lay.blocks) == ([], 0)
    lay = FD.class_layout([300], [48])
    assert [(g.c, g.col0, g.block0) for g in lay.launch] == [(0, 0, 0)]
    assert lay.blocks == 3
    # ties keep the class order; blocks follow one another
    lay = FD.class_layout([129, 1, 128], [24, 48, 24])
    assert [(g.c, g.col0, g.block0) for g in lay.launch] == \
        [(1, 129, 0), (0, 0, 1), (2, 130, 3)]
    assert lay.blocks == 4
    # the launchers' geometry: n, bb, then (seg, nl, col0, sort0, unit0,
    # block0) a class in launch order
    assert list(lay.geo)[:2] == [3, 0]
    assert list(lay.geo)[2:] == [v for g in lay.launch for v in g[1:]]


def _small_k2(nls, segs, want):
    lay = FD.class_layout(nls, segs)
    assert ([(g.c, g.block0) for g in lay.launch], lay.blocks) == want


SMALL = {
    "k0_empty_and_single": _small_k0,
    "k1_empty_and_single": _small_k1,
    "k2_empty": lambda: _small_k2([0, 0], [8, 16], ([], 0)),
    "k2_one": lambda: _small_k2([300], [48], ([(0, 0)], 3)),
    # ties keep the class order; a class of no rows takes no block
    "k2_ties_no_rows": lambda: _small_k2(
        [129, 1, 128, 64], [24, 48, 24, 0],
        ([(1, 0), (0, 1), (2, 3)], 4)),
}


@pytest.mark.parametrize("case", sorted(SMALL))
def test_layout_small(case):
    SMALL[case]()


@pytest.mark.parametrize("seed", range(4))
def test_layout_k2_views_disjoint_and_shaped(seed):
    """Every class's k2 planes and pos are views of one workspace: each of
    its class's shape, contiguous, 128-byte aligned, inside the workspace
    and disjoint from every other."""
    nls, segs = _sizes("k2", seed)
    lay = FD.class_layout(nls, segs)
    ws = torch.zeros((lay.k2_size,), dtype=torch.int32)
    spans = []
    for nl, seg, v in zip(nls, segs, FD._views(ws, lay.k2)):
        assert set(v) == {"sx", "sy", "sz", "pos"}
        for name, t in v.items():
            want = (nl,) if name == "pos" else (3 * seg, nl)
            assert tuple(t.shape) == want, name
            assert t.dtype == (torch.int32 if name == "pos"
                               else torch.float32)
            assert t.is_contiguous()
            assert t.untyped_storage().data_ptr() == \
                ws.untyped_storage().data_ptr()
            off = t.storage_offset()
            assert off % 32 == 0 and off + t.numel() <= lay.k2_size
            spans.append((off, off + t.numel()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    # what is written through one view is read back through it after
    # every other view has been written
    views = [t for v in FD._views(ws, lay.k2) for t in v.values()]
    for i, t in enumerate(views):
        t.fill_(i + 1)
    for i, t in enumerate(views):
        assert bool((t == i + 1).all())
    assert lay.k2_size == sum(-(-n // 32) * 32 for nl, seg in zip(nls, segs)
                              for n in [3 * seg * nl] * 3 + [nl])
