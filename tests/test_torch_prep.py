"""k0, the decode's kernel inputs and lane order in one launch a batch
(foldcomp_tpu_torch/kernels/fused_decode.py prep; csrc/fused_decode.cu
k0_prep).

On the CPU `prep` is class_prep and lane_order themselves, class by class:
held here on a classed, a single and a bb-wire pack, and the kernel's
constants to the tables they copy (tests/test_torch_class_layout.py holds
the class layout to the kernel's rule). The tests marked `card` need a
CUDA card and skip without one; on the card (this file imports no JAX;
the suite's conftest does, so skip it), from the repository's root:

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


def test_kernel_constants_match():
    """The decode's constants in the CUDA source: k0's field columns are
    core/tables.py FIELD_COLS, the class cap is its MAX_CLASSES, and the
    launches' shapes are the class layout's."""
    cols = _cu_define("K0_FIELD_COLS")
    assert [int(x) for x in cols.strip("{}").split(",")] == \
        list(T.FIELD_COLS)
    assert int(_cu_define("K0_THREADS")) == FD.K0_THREADS
    assert int(_cu_define("K0_SORT_LANES")) == FD.K0_SORT_LANES
    assert int(_cu_define("K0_CODE_UNIT")) == FD.K0_CODE_UNIT
    assert int(_cu_define("MAX_CLASSES")) == T.MAX_CLASSES
    assert int(_cu_define("K1_THREADS")) == FD.K1_THREADS
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


def _torch_glue(lay, classes):
    """The kernels' inputs as the decode made them before k0, in the
    place of its k0 step (fused_decode._k0): class_prep and lane_order of
    each class, by torch's operations on the card."""
    out = []
    for c in classes:
        pr = FD.class_prep(*c, wire="bb" if lay.bb else "full")
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
        m.setattr(FD, "_k0", _torch_glue)
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
            m.setattr(FD, "_k0", _torch_glue)
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
    assert counts["k3_staged"] == counts["k3"], counts


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
