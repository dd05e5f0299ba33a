"""Width-classed lanes in the port (batch_host.split_lanes_classes,
fused_decode.decode_seg_fused_classes, the classed route of codec/batch.py)
against the JAX package, on CPU.

The split is a copy: the same arrays, prev_idx, nl_outs and flat-row
metas as foldcomp_tpu's. The classed decode runs the plain versions here
(the kernels run on the card, chip_smoke.py); it is held to JAX
`decode_seg_fused_classes` in Pallas interpret mode, per protein, within
1 i16 unit (1 mA) on the offsets and 1e-3 A on CA (the port's float order
is the JAX kernel's, but torch's and XLA's CPU libm differ by ulps, which a
rounding to mA can turn into one unit), and to the port's single-class
`decode_seg_fused` bit for bit: the split only permutes lanes and replaces
the seed roll by a gather through prev_idx, so the per-lane math is the
same (tests/test_wclass.py holds JAX to the same contract).
"""
import random

import numpy as np
import pytest
import torch

from test_property_roundtrip import synthesize

from foldcomp_tpu.codec import batch as tpu_batch
from foldcomp_tpu.codec.encoder import encode
from foldcomp_tpu.codec.fcz import serialize
from foldcomp_tpu.io.db import DatabaseReader, DatabaseWriter
from foldcomp_tpu_torch import cli
from foldcomp_tpu_torch.codec import batch as B
from foldcomp_tpu_torch.codec import batch_host as H
from foldcomp_tpu_torch.kernels import fused_decode as FD

# the port's classed decode against JAX's: offsets in i16 units (1 mA),
# CA in A
TOL_I16 = 1
TOL_CA_A = 1e-3
# JAX's _mixed_fczs (tests/test_wclass.py): a protein's consecutive lanes
# land in different classes
MIXED = (26, 60, 151, 240, 60)
# bench.py's 8 lengths: a 128-entry batch of them is split at min_save
# 0.15 (FOLDCOMP_TPU_WCLASS=1) into 4 classes
BENCH_LENGTHS = (120, 200, 280, 360, 480, 640, 840, 1080)


@pytest.fixture(scope="module")
def mixed():
    return [encode(synthesize(n, seed=i)) for i, n in enumerate(MIXED)]


@pytest.fixture(scope="module")
def bench128():
    uniq = {n: encode(synthesize(n, seed=i))
            for i, n in enumerate(BENCH_LENGTHS)}
    rng = random.Random(0)
    return [uniq[rng.choice(BENCH_LENGTHS)] for _ in range(128)]


def _uniform():
    return [encode(synthesize(60, seed=i)) for i in range(4)]


def _forced(fczs):
    arrays, metas = H.pack_decode_batch_lanes(fczs)
    split = H.split_lanes_classes(dict(arrays), metas, min_save=-100.0)
    assert split is not None and len(split[0]["classes"]["recs"]) >= 2
    return (arrays, metas), split


def _rows(host, m):
    """(off i16 [n, 42], ca f32 [n, 3]) of protein m from a host output."""
    off, ca = host
    segw = off.shape[1]
    idx = m.lane_of * segw + m.rec_of
    return off.reshape(-1, 42)[idx], ca.reshape(-1, 3)[idx]


def _port_classes(split, refine_iters, plain=False):
    ta = B.arrays_to_torch(split[0], "cpu")
    if not plain:
        return B._outs_to_host(B._seg_decode_arrays(ta, refine_iters))
    c = ta["classes"]
    outs = FD.decode_seg_fused_classes_plain(
        *(c[k] for k in B._CLASS_DTYPES), ta["prev_idx"],
        refine_iters=refine_iters, nl_outs=ta["nl_outs"])
    return (torch.cat([o.reshape(-1, 42) for o, _ in outs])[:, None].numpy(),
            torch.cat([a.reshape(-1, 3) for _, a in outs])[:, None].numpy())


@pytest.mark.parametrize("case", ["forced_mixed", "gate_015", "auto_gate",
                                  "uniform_declines"])
def test_split_matches_jax(case, mixed, bench128):
    """(a) The port's split_lanes_classes equals JAX's on the same pack:
    class arrays, prev_idx, nl_outs and metas, or None from both."""
    fczs, kw = {"forced_mixed": (mixed, {"min_save": -100.0}),
                "gate_015": (bench128, {"min_save": 0.15}),
                "auto_gate": (bench128, {"min_save": H._WCLASS_MIN_SAVE}),
                "uniform_declines": (_uniform(), {})}[case]
    arrays, metas = H.pack_decode_batch_lanes(fczs)
    got = H.split_lanes_classes(dict(arrays), metas, **kw)
    want = tpu_batch.split_lanes_classes(dict(arrays), metas, **kw)
    if case in ("auto_gate", "uniform_declines"):
        # 128 entries save 15-20% of the slots: auto's 20% declines
        assert got is None and want is None
        return
    assert got is not None and want is not None
    ga, wa = got[0], want[0]
    assert sorted(ga) == sorted(wa) == ["classes", "nl_outs", "prev_idx"]
    assert ga["nl_outs"] == wa["nl_outs"]
    assert ga["prev_idx"].dtype == wa["prev_idx"].dtype
    assert np.array_equal(ga["prev_idx"], wa["prev_idx"])
    assert sorted(ga["classes"]) == sorted(wa["classes"])
    for k, arrs in ga["classes"].items():
        assert len(arrs) == len(wa["classes"][k]) >= 2, k
        for a, b in zip(arrs, wa["classes"][k]):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
    for gm, wm in zip(got[1], want[1]):
        assert np.array_equal(gm.lane_of, wm.lane_of)
        assert np.array_equal(gm.rec_of, wm.rec_of)
        assert gm.n_residue == wm.n_residue and gm.res_base == wm.res_base


# the auto rule's constants as measured on the H100 (batch_host.py)
WCLASS_RECORDED = (84992, 0.2)


def test_use_wclass_modes(monkeypatch):
    """The modes are the JAX package's; the auto rule's lane count and
    savings share are the port's own, the values its comment records."""
    for v, want in (("0", "0"), ("1", "1"), ("auto", "auto"),
                    ("yes", "auto")):
        monkeypatch.setenv("FOLDCOMP_TPU_WCLASS", v)
        assert H.use_wclass() == want == tpu_batch.use_wclass()
    monkeypatch.delenv("FOLDCOMP_TPU_WCLASS")
    assert H.use_wclass() == "auto"
    assert (H._WCLASS_MIN_LANES, H._WCLASS_MIN_SAVE) == \
        (B._WCLASS_MIN_LANES, B._WCLASS_MIN_SAVE) == WCLASS_RECORDED


@pytest.mark.parametrize("below", [False, True],
                         ids=["at_min_lanes", "below_min_lanes"])
def test_auto_rule_lane_threshold(below, monkeypatch, mixed):
    """pack_decode_wire under auto splits a batch whose real lanes reach
    _WCLASS_MIN_LANES and not one a lane short of it, and the PDB text is
    the same bytes either way. The threshold is set to the batch's own
    lane count (or one more), and the savings share off, to keep the
    batch small."""
    monkeypatch.delenv("FOLDCOMP_TPU_WCLASS", raising=False)
    lanes = sum(f.n_anchor - 1 for f in mixed)
    monkeypatch.setattr(B, "_WCLASS_MIN_SAVE", -100.0)
    texts = {}
    for thr in (lanes + below, 10 ** 9):
        monkeypatch.setattr(B, "_WCLASS_MIN_LANES", thr)
        arrays, metas = B.pack_decode_wire(mixed, False)
        outs = B._outs_to_host(B._seg_decode_arrays(
            B.arrays_to_torch(arrays, "cpu")))
        texts[thr] = ("classes" in arrays,
                      [t for _, t in H._format_batch(mixed, metas, outs,
                                                     False)])
    assert texts[lanes + below][0] is not below
    assert texts[10 ** 9][0] is False
    assert texts[lanes + below][1] == texts[10 ** 9][1]


_JAX_CACHE = {}


def _jax_classes(split, refine_iters):
    from foldcomp_tpu.kernels.pallas_decode import decode_seg_fused_classes
    if refine_iters not in _JAX_CACHE:
        a = split[0]
        c = a["classes"]
        out = decode_seg_fused_classes(
            c["recs"], c["mins"], c["cont"], c["sct"], c["fwd"], c["rev"],
            c["isf"], c["segm"], a["prev_idx"], refine_iters=refine_iters,
            interpret=True, nl_outs=a["nl_outs"])
        _JAX_CACHE[refine_iters] = tpu_batch._outs_to_host(out)
    return _JAX_CACHE[refine_iters]


@pytest.mark.parametrize("plain", [False, True],
                         ids=["decode_seg_fused_classes", "plain"])
@pytest.mark.parametrize("refine_iters", [1, 2])
def test_classes_match_jax(refine_iters, plain, mixed):
    """(b) The port's classed decode (through the wrappers, which run the
    plain versions on the CPU, and decode_seg_fused_classes_plain) against
    JAX decode_seg_fused_classes in interpret mode, per protein."""
    _, split = _forced(mixed)
    want = _jax_classes(split, refine_iters)
    got = _port_classes(split, refine_iters, plain)
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    worst = [0, 0.0]
    for m in split[1]:
        go, gc = _rows(got, m)
        wo, wc = _rows(want, m)
        worst[0] = max(worst[0], int(np.abs(go.astype(np.int32)
                                            - wo.astype(np.int32)).max()))
        worst[1] = max(worst[1], float(np.abs(gc - wc).max()))
    assert worst[0] <= TOL_I16 and worst[1] <= TOL_CA_A, worst


@pytest.mark.parametrize("refine_iters", [2, 0])
def test_classes_bit_equal_to_single_class(refine_iters, mixed):
    """(c) The classed decode gathers, protein by protein, to the same
    bits as the port's single-class decode_seg_fused; its plain version to
    the same bits as the wrappers' route."""
    (arrays, metas), split = _forced(mixed)
    single = B._outs_to_host(B._seg_decode_arrays(
        B.arrays_to_torch(arrays, "cpu"), refine_iters))
    cls = _port_classes(split, refine_iters)
    cls_plain = _port_classes(split, refine_iters, plain=True)
    for m0, m1 in zip(metas, split[1]):
        want = H._gather_a14(single, m0)
        assert np.array_equal(H._gather_a14(cls, m1), want)
        assert np.array_equal(H._gather_a14(cls_plain, m1), want)
    for a, b in zip(cls, cls_plain):
        assert a.tobytes() == b.tobytes()


def test_backbone_prev_forms_match_the_roll(mixed):
    """(d) backbone_rolled_plain with prev None, and with an explicit prev
    of l-1 (lane 0 wrapping to NL-1), equals the roll by one lane, bit for
    bit, with lane 0 made a continuation so that the wrap is read."""
    arrays, _ = H.pack_decode_batch_lanes(mixed)
    ta = B.arrays_to_torch(arrays, "cpu")
    pr = FD.class_prep(*(ta[k] for k in ("seg_records", "mins_lane",
                                         "cont_lane", "sc_codes_seg",
                                         "fwd9", "rev9")), ta["seg_m"])
    lane = (pr["rev9"], pr["tat"], pr["mins6"], pr["cont6"])
    t9 = FD.tails_plain(pr["recs"], FD.n_ca_lengths(pr["recs"]), pr["fwd9"],
                        *lane)
    first = ta["is_first"].clone()
    first[0] = False
    nl = t9.shape[1]
    rolled = torch.roll(t9, 1, dims=1).reshape(3, 3, nl).transpose(0, 1) \
        .reshape(9, nl)
    seeds = torch.where(first[None], pr["fwd9"], rolled).contiguous()
    want = FD.backbone_plain(pr["recs"], FD.n_ca_lengths(pr["recs"]), seeds,
                             *lane)
    prev = ((torch.arange(nl) - 1) % nl).to(torch.int32)
    for p in (None, prev):
        got = FD.backbone_rolled_plain(pr["recs"], t9, pr["fwd9"], first,
                                       *lane, prev=p)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    # the wrapper on the CPU takes prev as well
    got = FD.backbone(pr["recs"], t9, pr["fwd9"], first, *lane, prev=prev)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_arrays_to_torch_checks_classes(mixed):
    _, split = _forced(mixed)
    ta = B.arrays_to_torch(split[0], "cpu")
    c = ta["classes"]
    assert [r.dtype for r in c["recs"]] == [torch.uint8] * len(c["recs"])
    assert ta["prev_idx"].dtype == torch.int32
    assert ta["nl_outs"] == split[0]["nl_outs"]
    bad = dict(split[0], prev_idx=split[0]["prev_idx"].copy())
    bad["prev_idx"][3] = len(bad["prev_idx"])
    with pytest.raises(ValueError):
        B.arrays_to_torch(bad, "cpu")
    segm = list(split[0]["classes"]["segm"])
    segm[0] = segm[0].copy()
    segm[0][0] = split[0]["classes"]["recs"][0].shape[1] + 1
    bad = dict(split[0], classes=dict(split[0]["classes"], segm=tuple(segm)))
    with pytest.raises(ValueError):
        B.arrays_to_torch(bad, "cpu")


def _count_classes(monkeypatch):
    calls = []
    real = FD.decode_seg_fused_classes

    def spy(*a, **kw):
        calls.append(len(a[0]))
        return real(*a, **kw)
    monkeypatch.setattr(FD, "decode_seg_fused_classes", spy)
    return calls


def test_wclass_env_routes_decode_fcz_batch(monkeypatch, bench128):
    """(e) decode_fcz_batch and decode_fcz_to_pdb_batch under
    FOLDCOMP_TPU_WCLASS=1 (the classed route, 4 classes) and =0: the same
    atoms and byte-identical PDB text; under =1 a uniform corpus is not
    split (the savings gate declines)."""
    calls = _count_classes(monkeypatch)
    monkeypatch.setenv("FOLDCOMP_TPU_WIRE", "full")
    out = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("FOLDCOMP_TPU_WCLASS", mode)
        n0 = len(calls)
        atoms = B.decode_fcz_batch(bench128, device="cpu")
        texts = B.decode_fcz_to_pdb_batch(bench128, device="cpu")
        out[mode] = (atoms, texts)
        assert len(calls) - n0 == (2 if mode == "1" else 0), calls
    assert calls and all(n == 4 for n in calls)
    for a, b in zip(out["1"][0], out["0"][0]):
        assert np.asarray(a.coords).tobytes() == np.asarray(b.coords).tobytes()
    assert out["1"][1] == out["0"][1]
    monkeypatch.setenv("FOLDCOMP_TPU_WCLASS", "1")
    uni = _uniform()
    arrays, _ = B.pack_decode_wire(uni, False)
    assert "classes" not in arrays
    assert H.split_lanes_classes(*H.pack_decode_batch_lanes(uni)) is None
    # the bb wire is never classed
    arrays, _ = B.pack_decode_wire(bench128, True)
    assert "classes" not in arrays and arrays["bb_wire"]


def test_cli_decompress_fast_wclass(monkeypatch, tmp_path, bench128):
    """(e) `decompress --fast <db> <out> --db` on the CPU-forced route:
    every entry byte-identical under FOLDCOMP_TPU_WCLASS=1 (which takes the
    classed route) and =0 (which does not)."""
    db = tmp_path / "in_db"
    w = DatabaseWriter(str(db))
    for i, f in enumerate(bench128):
        w.append(serialize(f), i, f"e{i}")
    w.close()
    calls = _count_classes(monkeypatch)
    monkeypatch.setenv("FOLDCOMP_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FOLDCOMP_TPU_WIRE", "full")
    monkeypatch.setenv("FOLDCOMP_TPU_BATCH", "128")
    got = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("FOLDCOMP_TPU_WCLASS", mode)
        n0 = len(calls)
        out = tmp_path / f"out_{mode}"
        assert cli.main(["decompress", "--fast", str(db), str(out),
                         "--db"]) == 0
        assert len(calls) - n0 == (1 if mode == "1" else 0), calls
        r = DatabaseReader(str(out))
        try:
            got[mode] = {name: bytes(d) for _, name, d in r.entries()}
        finally:
            r.close()
    assert len(got["1"]) == len(bench128)
    assert all(b"\nATOM" in v for v in got["1"].values())
    assert got["1"] == got["0"]
