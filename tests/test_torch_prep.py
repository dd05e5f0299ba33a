"""k0, the decode's kernel inputs and lane order in one launch a batch
(foldcomp_tpu_torch/kernels/fused_decode.py prep, prep_class_table;
csrc/fused_decode.cu k0_prep).

On the CPU `prep` is class_prep and lane_order themselves, class by class:
held here on a classed, a single and a bb-wire pack, with its class table
(pure Python) held to the kernel's rule and the kernel's constants to the
tables they copy. The tests marked `card` need a CUDA card and skip
without one; on the card (this file imports no JAX; the suite's conftest
does, so skip it), from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_prep.py

They hold k0 to class_prep + lane_order bit for bit (ties in tat, a
one-lane class, an empty class, SEG over several of the sort's passes,
records that do not start 16-byte aligned), the decode's dispatch
(codec/batch._seg_decode_arrays) bit-equal to the same dispatch through
torch's glue on the rows each lane owns, free of any synchronize under
torch.cuda.set_sync_debug_mode("error"), and one prep launch a dispatch.
"""
import ctypes
import re
import types

import numpy as np
import pytest
import torch

from foldcomp_tpu_torch import verify
from foldcomp_tpu_torch.codec import batch as B
from foldcomp_tpu_torch.codec import batch_host as H
from foldcomp_tpu_torch.codec.encoder import encode
from foldcomp_tpu_torch.core import tables as T
from foldcomp_tpu_torch.kernels import build
from foldcomp_tpu_torch.kernels import fused_decode as FD

BENCH_LENGTHS = (120, 200, 280, 360, 480, 640, 840, 1080)
PACK_KEYS = ("seg_records", "mins_lane", "cont_lane", "sc_codes_seg",
             "fwd9", "rev9", "seg_m")
CLASS_KEYS = ("recs", "mins", "cont", "sct", "fwd", "rev", "segm")
FIELDS = ("recs", "code", "sct", "fwd9", "rev9", "tat", "mins6", "cont6")
# what k0 gives in bb mode: no code plane, no side-chain codes
BB_FIELDS = ("recs", "fwd9", "rev9", "tat", "mins6", "cont6")


@pytest.fixture(scope="module")
def fczs():
    """bench.py's 8 lengths, 64 entries each in a seeded order, and the
    test_wclass.py mixed corpus, whose proteins' lanes land in several
    classes."""
    uniq = verify.synthetic_corpus(BENCH_LENGTHS)
    rng = np.random.default_rng(3)
    mixed = [encode(verify.synthesize(n, seed=i))
             for i, n in enumerate((26, 60, 151, 240, 60))]
    return [uniq[BENCH_LENGTHS[int(i)]] for i in rng.integers(0, 8, 512)] \
        + mixed


@pytest.fixture(scope="module")
def packs(fczs):
    """The host arrays of each pack form: "single" (one class, full
    wire), "classed" (the width-class split, its savings gate off), "bb"
    (the bb wire), "wide" (anchors every 1000 residues: SEG 952, four of
    k0's sort passes)."""
    arrays, metas = H.pack_decode_batch_lanes(fczs)
    split = H.split_lanes_classes(dict(arrays), metas, min_save=-100.0)
    assert split is not None and len(split[0]["classes"]["recs"]) >= 3
    wide = [encode(verify.synthesize(n, seed=n), anchor_threshold=1000)
            for n in (700, 1300, 950, 1800, 610, 90, 1250, 2600)]
    out = {"single": B.pack_decode_wire(fczs, False, wclass="0")[0],
           "classed": split[0],
           "bb": B.pack_decode_wire(fczs, True)[0],
           "wide": B.pack_decode_wire(wide, False, wclass="0")[0]}
    assert out["wide"]["seg_records"].shape[1] > 2 * _k0_buckets()
    return out


def _k0_buckets():
    """k0's buckets a sort pass (K0_BUCKETS of the kernel's source)."""
    return int(_cu_define("K0_BUCKETS"))


def _cu_define(name):
    src = open(build.SOURCES[0]).read()
    return re.search(rf"#define {name} (.+?)(\s*//.*)?\n", src).group(1)


def _classes(ta):
    """arrays_to_torch's tensors -> prep's tuples, one a class (a bb
    pack's side-chain codes None: its dict holds none)."""
    if "classes" in ta:
        c = ta["classes"]
        return list(zip(*(c[k] for k in CLASS_KEYS)))
    return [tuple(ta[k] for k in PACK_KEYS)]


def _wire(ta):
    return "bb" if ta.get("bb_wire") else "full"


def _hold_prep(got, classes, wire="full"):
    """Each class's prep dict equal, field for field and in the order, to
    class_prep + lane_order of the class on the CPU; in bb mode without
    the code plane and the side-chain codes."""
    assert len(got) == len(classes)
    for g, c in zip(got, classes):
        want = FD.class_prep(*(None if t is None else t.cpu() for t in c),
                             wire=wire)
        order = FD.lane_order(want["tat"])
        if wire == "bb":
            assert "code" not in g and "sct" not in g
        for k in (BB_FIELDS if wire == "bb" else FIELDS):
            assert g[k].dtype == want[k].dtype, k
            assert torch.equal(g[k].cpu(), want[k]), k
        assert isinstance(g["order"], FD.LaneOrder)
        assert g["order"].perm.dtype == torch.int32
        assert torch.equal(g["order"].perm.cpu(), order.perm)


@pytest.mark.parametrize("form", ["classed", "single", "bb", "wide"])
def test_prep_cpu_is_class_prep_and_lane_order(form, packs):
    """On the CPU prep is the plain version: class_prep and lane_order of
    every class, every field and the permutation, and no launch."""
    ta = B.arrays_to_torch(packs[form], "cpu")
    classes = _classes(ta)
    FD.reset_launch_counts()
    got = FD.prep(classes, wire=_wire(ta))
    assert FD.launch_counts()["prep"] == 0
    _hold_prep(got, classes, _wire(ta))


def _kernel_cover(nls, segs, bb=False):
    """Run the kernel's rule over prep_class_table's table: the sort blocks
    (K0_SORT_LANES lanes of a class each), then every unit of the grid,
    code slots (none in bb mode) or a lane. -> (per class: times each code
    slot is written, times each lane's outputs are written, times each
    lane is sorted; entries, size)."""
    entries, size, sorts, units = FD.prep_class_table(nls, segs, bb)
    code = [np.zeros(s * n, int) for s, n in zip(segs, nls)]
    lanes = [np.zeros(n, int) for n in nls]
    sorted_ = [np.zeros(n, int) for n in nls]
    for b in range(sorts):
        c, _, s0, _ = [e for e in entries if e[2] <= b][-1]
        lo = (b - s0) * FD.K0_SORT_LANES
        sorted_[c][lo:lo + FD.K0_SORT_LANES] += 1
    blocks = sorts - (-units // FD.K0_THREADS)
    stride = (blocks - sorts) * FD.K0_THREADS
    first = np.arange(stride)     # (b - sorts) * K0_THREADS + t
    unit0 = np.array([e[3] for e in entries])
    for step in range(0, max(units, 1), max(stride, 1)):
        u = first + step
        u = u[u < units]
        for i, (c, _, _, u0) in enumerate(entries):
            mine = u[np.searchsorted(unit0, u, side="right") - 1 == i] - u0
            quads = 0 if bb else -(-segs[c] * nls[c] // FD.K0_CODE_UNIT)
            for j in mine[mine < quads]:
                code[c][j * FD.K0_CODE_UNIT:(j + 1) * FD.K0_CODE_UNIT] += 1
            np.add.at(lanes[c], mine[mine >= quads] - quads, 1)
    return code, lanes, sorted_, entries, size


@pytest.mark.parametrize("seed", range(6))
def test_prep_class_table_covers_every_lane_once(seed):
    """Random class sizes and widths (a class empty in odd seeds, a
    one-lane class in even ones): every code slot and every lane of every
    class written once, every lane sorted once, each class's outputs in
    slots of the workspace that are 128-byte aligned, inside it and
    disjoint."""
    rng = np.random.default_rng(seed)
    n_cls = int(rng.integers(1, FD.K1_MAX_CLASSES + 1))
    nls = [int(rng.integers(1, 700)) for _ in range(n_cls)]
    if seed == 0:       # classes over several sort blocks
        nls = [3 * FD.K0_SORT_LANES + 5, FD.K0_SORT_LANES, 1,
               2 * FD.K0_SORT_LANES - 1][:n_cls]
    segs = [int(rng.integers(1, 50)) for _ in range(n_cls)]
    if seed % 2 and n_cls > 1:
        nls[int(rng.integers(n_cls))] = 0
    if seed % 2 == 0:
        nls[int(rng.integers(n_cls))] = 1
    code, lanes, sorted_, entries, size = _kernel_cover(nls, segs)
    assert [e[0] for e in entries] == [c for c in range(n_cls) if nls[c]]
    for c in range(n_cls):
        assert (code[c] == 1).all() and (lanes[c] == 1).all() \
            and (sorted_[c] == 1).all(), c
    # the views the wrapper hands the kernels: their shapes and types,
    # 128-byte aligned, inside the workspace and disjoint
    ws = torch.zeros(size, dtype=torch.int32)
    used = np.zeros(size, int)
    for c, ws0, _, _ in entries:
        seg, nl = segs[c], nls[c]
        assert ws0 % 32 == 0 and FD._prep_slots(seg, nl)[1] % 32 == 0
        v = FD.prep_views(ws, ws.view(torch.float32), ws0, seg, nl)
        assert {k: (tuple(t.shape), t.dtype) for k, t in v.items()} == {
            "code": ((seg, nl), torch.int32), "tat": ((nl,), torch.int32),
            "mins6": ((6, nl), torch.float32),
            "cont6": ((6, nl), torch.float32),
            "order": ((nl,), torch.int32)}
        for t in v.values():
            at = (t.data_ptr() - ws.data_ptr()) // 4
            assert t.is_contiguous() and at % 32 == 0
            used[at:at + t.numel()] += 1
    assert used.max() <= 1


@pytest.mark.parametrize("seed", range(3))
def test_prep_class_table_bb_covers_every_lane_once(seed):
    """k0's bb mode: no code units and no code slot in the workspace;
    every lane of every class written and sorted once, each class's
    outputs 128-byte aligned and disjoint; the workspace smaller by the
    code planes alone."""
    rng = np.random.default_rng(100 + seed)
    n_cls = int(rng.integers(1, FD.K1_MAX_CLASSES + 1))
    nls = [int(rng.integers(1, 3 * FD.K0_SORT_LANES)) for _ in range(n_cls)]
    segs = [int(rng.integers(1, 50)) for _ in range(n_cls)]
    code, lanes, sorted_, entries, size = _kernel_cover(nls, segs, bb=True)
    for c in range(n_cls):
        assert not code[c].any()
        assert (lanes[c] == 1).all() and (sorted_[c] == 1).all(), c
    full = FD.prep_class_table(nls, segs)
    _, size_bb, sorts_bb, units_bb = FD.prep_class_table(nls, segs, True)
    assert sorts_bb == full[2] and units_bb == sum(nls)
    assert size_bb == full[1] - sum(
        -(-s * n // 32) * 32 for s, n in zip(segs, nls))
    ws = torch.zeros(size, dtype=torch.int32)
    used = np.zeros(size, int)
    for c, ws0, _, _ in entries:
        v = FD.prep_views(ws, ws.view(torch.float32), ws0, segs[c], nls[c],
                          bb=True)
        assert set(v) == {"tat", "mins6", "cont6", "order"}
        for t in v.values():
            at = (t.data_ptr() - ws.data_ptr()) // 4
            assert t.is_contiguous() and at % 32 == 0
            used[at:at + t.numel()] += 1
    assert used.max() <= 1


def test_prep_class_table_empty_and_single():
    assert FD.prep_class_table([0, 0], [8, 16]) == ([], 0, 0, 0)
    u = FD.K0_CODE_UNIT
    # one lane: 1 sort block, 8 code slots, then the lane; 5 slots of 32
    assert FD.prep_class_table([1], [8]) == ([(0, 0, 0, 0)], 160, 1,
                                             -(-8 // u) + 1)
    assert FD._prep_slots(8, 1)[0] == {
        "code": ((8, 1), 0), "tat": ((1,), 32), "mins6": ((6, 1), 64),
        "cont6": ((6, 1), 96), "order": ((1,), 128)}
    # an empty class between two: the classes follow one another
    entries, size, sorts, units = FD.prep_class_table([3, 0, 40],
                                                      [24, 48, 16])
    u0 = -(-24 * 3 // u) + 3
    assert entries == [(0, 0, 0, 0), (2, FD._prep_slots(24, 3)[1], 1, u0)]
    assert sorts == 2 and units == u0 + -(-16 * 40 // u) + 40 and \
        size == FD._prep_slots(24, 3)[1] + FD._prep_slots(16, 40)[1]
    # an empty class's outputs: empty views of the right shapes
    ws = torch.zeros(0, dtype=torch.int32)
    v = FD.prep_views(ws, ws.view(torch.float32), 0, 48, 0)
    assert {k: tuple(t.shape) for k, t in v.items()} == {
        "code": (48, 0), "tat": (0,), "mins6": (6, 0), "cont6": (6, 0),
        "order": (0,)}


def test_kernel_constants_match():
    """k0's constants in the CUDA source: the field columns are
    core/tables.py FIELD_COLS, and the launch's shape the wrapper's."""
    cols = _cu_define("K0_FIELD_COLS")
    assert [int(x) for x in cols.strip("{}").split(",")] == \
        list(T.FIELD_COLS)
    assert int(_cu_define("K0_THREADS")) == FD.K0_THREADS
    assert int(_cu_define("K0_SORT_LANES")) == FD.K0_SORT_LANES
    assert int(_cu_define("K0_CODE_UNIT")) == FD.K0_CODE_UNIT
    assert int(_cu_define("K0_MAX_CLASSES").split()[0]) == FD.K1_MAX_CLASSES
    assert _k0_buckets() * 32 % FD.K0_THREADS == 0


def test_bind_sets_the_decode_argtypes():
    """build._bind gives each launcher of fused_decode.cu one ctypes type
    a C parameter: c_void_p for a pointer or the stream, c_int for an
    int."""

    class Lib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    lib = build._bind(Lib())
    src = open(build.SOURCES[0]).read()
    kinds = {"int": ctypes.c_int, "cudaStream_t": ctypes.c_void_p}
    sigs = re.findall(r"\ncudaError_t (fd_\w+)\(([^)]*)\)", src)
    assert {n for n, _ in sigs} == {"fd_set_tables", "fd_prep", "fd_tails",
                                    "fd_backbone", "fd_backbone_bb",
                                    "fd_sidechain"}
    for name, params in sigs:
        want = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
                for p in params.split(",")]
        assert getattr(lib, name).argtypes == want, name
        assert getattr(lib, name).restype is ctypes.c_int, name


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _synthetic(rng, specs, dev, offset=0):
    """prep's class tuples of random inputs on dev: specs (SEG, NL, seg_m
    values) a class; seg_m drawn from the values (ties), the records in
    memory `offset` bytes past an allocation's start."""
    out = []
    for seg, nl, values in specs:
        recs = torch.from_numpy(rng.integers(0, 256, (8, seg, nl),
                                             dtype=np.uint8))
        buf = torch.empty(recs.numel() + offset, dtype=torch.uint8,
                          device=dev)[offset:]
        recs_d = buf.view(8, seg, nl).copy_(recs)
        f = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
             for s in ((nl, 6), (nl, 6), (9, nl), (9, nl))]
        sct = torch.from_numpy(rng.integers(0, 256, (seg, 11, nl),
                                            dtype=np.uint8)).to(dev)
        seg_m = torch.from_numpy(rng.choice(np.asarray(values, np.int32),
                                            nl)).to(dev)
        out.append((recs_d, f[0], f[1], sct, f[2], f[3], seg_m))
    return out


@pytest.mark.card
@pytest.mark.parametrize("case", ["ties", "one_lane_empty", "wide",
                                  "unaligned"])
def test_k0_matches_plain_bit_for_bit(case, cuda):
    """k0 against class_prep + lane_order on the CPU, every output bit for
    bit: four classes whose lanes share a few lengths (ties in tat); a
    one-lane class beside an empty one; SEG 777 with lengths over the whole
    range (four of the sort's passes); records 1 byte past an aligned
    start, SEG * NL not a multiple of the code unit."""
    rng = np.random.default_rng(len(case))
    specs = {
        "ties": [(48, 70000, (48, 47, 25, 24, 3, 1)),
                 (32, 9000, (32, 26, 25)), (24, 513, (24,)),
                 (16, 2048, range(1, 17))],
        "one_lane_empty": [(40, 1, (17,)), (24, 0, (1,)),
                           (24, 3000, (24, 23, 1))],
        "wide": [(777, 1500, range(1, 778))],
        "unaligned": [(13, 1001, (13, 12, 5)), (7, 33, (7, 1))]}[case]
    classes = _synthetic(rng, specs, cuda,
                         offset=1 if case == "unaligned" else 0)
    FD.reset_launch_counts()
    got = FD.prep(classes)
    torch.cuda.synchronize()
    assert FD.launch_counts()["prep"] == 1
    _hold_prep(got, classes)
    for g, c in zip(got, classes):
        # the records, codes and seeds are the caller's tensors
        for k, t in zip(("recs", "sct", "fwd9", "rev9"), (c[0], c[3], c[4],
                                                           c[5])):
            assert g[k].data_ptr() == t.data_ptr(), k


def _torch_glue(classes, wire="full"):
    """The kernels' inputs as the decode made them before k0: class_prep
    and lane_order of each class, by torch's operations on the card."""
    out = []
    for c in classes:
        pr = FD.class_prep(*c, wire=wire)
        pr["order"] = FD.lane_order(pr["tat"])
        out.append(pr)
    return out


def _owned(ta, outs):
    """The rows each lane owns of a dispatch's output, as (off, ca)
    masked: rows s < seg_m of lanes < nl_out (flat rows, class by class,
    for a classed pack)."""
    if "classes" in ta:
        c = ta["classes"]
        masks = []
        for i, (recs, segm) in enumerate(zip(c["recs"], c["segm"])):
            seg, nl = recs.shape[1:]
            nlo = min(ta["nl_outs"][i], nl) if i < len(ta["nl_outs"]) \
                else nl
            masks.append((torch.arange(seg, device=segm.device)[None, :]
                          < segm[:nlo, None]).reshape(-1))
        mask = torch.cat(masks)
        return tuple(t[:, 0][mask] for t in outs)
    off, ca = outs[-2:]
    seg_m = ta["seg_m"][:off.shape[0]]
    mask = torch.arange(off.shape[1], device=seg_m.device)[None, :] \
        < seg_m[:, None]
    return off[mask], ca[mask]


@pytest.mark.card
@pytest.mark.parametrize("form", ["classed", "single", "bb", "wide"])
def test_dispatch_bit_equal_to_torch_glue(form, packs, cuda, monkeypatch):
    """codec/batch._seg_decode_arrays with k0 against the same dispatch
    with torch's glue in its place: every row each lane owns bit for bit,
    in the same form."""
    ta = B.arrays_to_torch(packs[form], cuda)
    got = B._seg_decode_arrays(ta)
    with monkeypatch.context() as m:
        m.setattr(FD, "prep", _torch_glue)
        want = B._seg_decode_arrays(ta)
    assert len(got) == len(want) == (3 if form == "bb" else 2)
    if form == "bb":
        assert got[0] == want[0] == "bb"
    for g, w in zip(_owned(ta, got), _owned(ta, want)):
        assert g.numel() > 0 and g.dtype == w.dtype
        assert torch.equal(_bits(g), _bits(w))


def _bits(t):
    """A float tensor's bits, so that equality is bit for bit."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.card
@pytest.mark.parametrize("form", ["classed", "single", "bb"])
def test_dispatch_never_synchronizes(form, packs, cuda, monkeypatch):
    """_seg_decode_arrays under torch.cuda.set_sync_debug_mode("error"):
    nothing in the dispatch waits for the stream. The control: the same
    dispatch with torch's glue raises there (class_prep's column table
    is a blocking host-to-card copy)."""
    ta = B.arrays_to_torch(packs[form], cuda)
    B._seg_decode_arrays(ta)         # the library loaded, its tables set
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        B._seg_decode_arrays(ta)
        with monkeypatch.context() as m:
            m.setattr(FD, "prep", _torch_glue)
            with pytest.raises(RuntimeError):
                B._seg_decode_arrays(ta)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.card
@pytest.mark.parametrize("form", ["classed", "single", "bb"])
def test_one_prep_launch_a_dispatch(form, packs, cuda):
    ta = B.arrays_to_torch(packs[form], cuda)
    FD.reset_launch_counts()
    for _ in range(3):
        B._seg_decode_arrays(ta)
    torch.cuda.synchronize()
    counts = FD.launch_counts()
    assert counts["prep"] == 3 and counts["k1"] == 3, counts
    assert counts["prep_bb"] == (3 if form == "bb" else 0), counts
    assert counts["k2"] == (0 if form == "bb" else 3), counts
    assert counts["k3"] == (0 if form == "bb" else counts["k2_classes"]), \
        counts


@pytest.mark.card
@pytest.mark.parametrize("case", ["ties", "one_lane_empty", "wide",
                                  "unaligned", "bb_pack"])
def test_k0_bb_mode_bit_equal_to_full_mode(case, packs, cuda):
    """k0 in bb mode against k0 in full mode on the same inputs: tat,
    mins6, cont6 and the order bit for bit, no code plane written, the
    side-chain codes not taken (None), and the workspace smaller by the
    code planes; one launch each, one of them counted as prep_bb. The
    synthetic cases are those of test_k0_matches_plain_bit_for_bit;
    bb_pack is the bb pack of the fixture, as arrays_to_torch holds it."""
    if case == "bb_pack":
        full = _classes(B.arrays_to_torch(packs["single"], cuda))
        ta = B.arrays_to_torch(packs["bb"], cuda)
        assert ta["sc_codes_seg"] is None
        bb_in = _classes(ta)
    else:
        rng = np.random.default_rng(len(case))
        specs = {
            "ties": [(48, 70000, (48, 47, 25, 24, 3, 1)),
                     (32, 9000, (32, 26, 25)), (24, 513, (24,)),
                     (16, 2048, range(1, 17))],
            "one_lane_empty": [(40, 1, (17,)), (24, 0, (1,)),
                               (24, 3000, (24, 23, 1))],
            "wide": [(777, 1500, range(1, 778))],
            "unaligned": [(13, 1001, (13, 12, 5)), (7, 33, (7, 1))]}[case]
        full = _synthetic(rng, specs, cuda,
                          offset=1 if case == "unaligned" else 0)
        bb_in = [c[:3] + (None,) + c[4:] for c in full]
    FD.reset_launch_counts()
    want = FD.prep(full)
    got = FD.prep(bb_in, wire="bb")
    torch.cuda.synchronize()
    assert FD.launch_counts()["prep"] == 2
    assert FD.launch_counts()["prep_bb"] == 1
    _hold_prep(got, bb_in, "bb")
    for g, w in zip(got, want):
        assert "code" not in g and "sct" not in g
        for k in ("tat", "mins6", "cont6"):
            assert torch.equal(_bits(g[k]), _bits(w[k])), k
        assert torch.equal(g["order"].perm, w["order"].perm)
