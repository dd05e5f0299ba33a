"""k2 over every width class of a batch in one launch
(foldcomp_tpu_torch/kernels/fused_decode.py backbone_classes), on CPU.

One launch of k2_backbone takes a table of the classes, laid out with
k0's and k1's by the one class layout (class_layout, which
tests/test_torch_class_layout.py holds to the kernels' rules: k2's blocks
are k1's, the widest SEG first, K1_THREADS lanes a block; one allocation
holds every class's planes and pos, each lane's rows at its thread's
column, where k3 reads them). The CUDA kernels run only on the card
(chip_smoke.py phase 14 holds one launch bit-equal to a launch a class,
and to backbone_rolled_plain); on the CPU backbone_classes runs
backbone_rolled_plain class by class and launches nothing, each class's
rows in lane columns. The decode (decode_lanes) stays bit-equal to the single-class
decode (tests/test_torch_wclass.py
test_classes_bit_equal_to_single_class).
"""
import pytest
import torch

from test_property_roundtrip import synthesize

from foldcomp_tpu.codec.encoder import encode
from foldcomp_tpu_torch.codec import batch as B
from foldcomp_tpu_torch.codec import batch_host as H
from foldcomp_tpu_torch.core import tables as T
from foldcomp_tpu_torch.kernels import fused_decode as FD

# the test_wclass.py mixed corpus: a protein's lanes land in several
# classes
MIXED = (26, 60, 151, 240, 60)


@pytest.fixture(scope="module")
def classed():
    fczs = [encode(synthesize(n, seed=i)) for i, n in enumerate(MIXED)]
    arrays, metas = H.pack_decode_batch_lanes(fczs)
    split = H.split_lanes_classes(dict(arrays), metas, min_save=-100.0)
    assert split is not None and len(split[0]["classes"]["recs"]) >= 2
    return B.arrays_to_torch(split[0], "cpu")


def _k2_in(ta, refine_iters):
    """backbone_classes' classes and tails for a classed tensor dict, as
    decode_lanes makes them."""
    c = ta["classes"]
    prs, bases = [], [0]
    for i in range(len(c["recs"])):
        pr = FD.class_prep(c["recs"][i], c["mins"][i], c["cont"][i],
                           c["sct"][i], c["fwd"][i], c["rev"][i],
                           c["segm"][i])
        pr["order"] = FD.lane_order(pr["tat"])
        prs.append(pr)
        bases.append(bases[-1] + pr["recs"].shape[2])
    tails = None
    if refine_iters >= 2:
        tails = torch.cat([FD.tails_plain(p["recs"], FD.n_ca_lengths(
            p["recs"]), p["fwd9"], p["rev9"], p["tat"], p["mins6"],
            p["cont6"]) for p in prs], dim=1)
    k2_in = [(p["recs"], p["fwd9"], c["isf"][i], p["rev9"], p["tat"],
              p["mins6"], p["cont6"], p["order"],
              None if tails is None else
              ta["prev_idx"][bases[i]:bases[i + 1]])
             for i, p in enumerate(prs)]
    return k2_in, tails


@pytest.mark.parametrize("refine_iters", [1, 2])
def test_backbone_classes_cpu_is_plain_class_by_class(refine_iters,
                                                      classed):
    """On the CPU: no launch, and each class's rows bit for bit
    backbone_rolled_plain's of that class and the one-class call's."""
    k2_in, tails = _k2_in(classed, refine_iters)
    FD.reset_launch_counts()
    got = FD.backbone_classes(k2_in, tails)
    assert FD.launch_counts()["k2"] == 0
    assert FD.launch_counts()["k2_classes"] == 0
    assert len(got) == len(k2_in)
    for c, staged in zip(k2_in, got):
        want = FD.backbone_rolled_plain(c[0], tails, *c[1:7], c[8])
        one = FD.backbone(c[0], tails, *c[1:])
        assert staged.pos is None
        for g, w, o in zip(staged.rows(), want, one.rows()):
            assert g.shape == (3 * c[0].shape[1], c[0].shape[2])
            assert torch.equal(g, w) and torch.equal(g, o)


@pytest.mark.parametrize("refine_iters", [1, 2])
def test_classed_decode_calls_k2_once(refine_iters, classed, monkeypatch):
    """decode_lanes runs its k2 step (fused_decode._k2) once,
    with every class: class i's prev is its slice of prev_idx (the same
    memory), and the tails are every class's [9, NL_total]; at
    refine_iters 1 no tails and no prev. Then k3 reads each class's
    rows."""
    c = classed["classes"]
    calls = []
    real = FD._k2

    def spy(lay, classes, tails9):
        calls.append((classes, tails9))
        return real(lay, classes, tails9)

    monkeypatch.setattr(FD, "_k2", spy)
    FD.decode_lanes(
        *(c[k] for k in B._CLASS_DTYPES), classed["prev_idx"],
        refine_iters=refine_iters, nl_outs=classed["nl_outs"])
    assert len(calls) == 1
    classes, tails9 = calls[0]
    assert len(classes) == len(c["recs"])
    nl_total = classed["prev_idx"].shape[0]
    base = 0
    for i, k in enumerate(classes):
        nl = c["recs"][i].shape[2]
        assert torch.equal(k[0], c["recs"][i])
        assert k[2] is c["isf"][i]
        if refine_iters >= 2:
            want = classed["prev_idx"][base:base + nl]
            assert torch.equal(k[8], want)
            assert k[8].data_ptr() == want.data_ptr()
        else:
            assert k[8] is None
        base += nl
    assert base == nl_total
    if refine_iters >= 2:
        assert tuple(tails9.shape) == (9, nl_total)
    else:
        assert tails9 is None


def _bad_inputs(k2_in, tails, case):
    """k2_in and tails with one fault."""
    k2_in = [list(k) for k in k2_in]
    if case == "five_classes":
        k2_in = (k2_in * 3)[:T.MAX_CLASSES + 1]
    elif case == "tat_length":
        k2_in[0][4] = k2_in[0][4][:-1]
    elif case == "mins6_shape":
        k2_in[-1][5] = k2_in[-1][5][:5]
    elif case == "prev_length":
        k2_in[1][8] = k2_in[1][8][1:]
    elif case == "prev_none":
        k2_in[1][8] = None
    elif case == "recs_dtype":
        k2_in[0][0] = k2_in[0][0].to(torch.int32)
    elif case == "tails_rows":
        tails = tails[:8]
    return [tuple(k) for k in k2_in], tails


@pytest.mark.parametrize("case", ["five_classes", "tat_length",
                                  "mins6_shape", "prev_length", "prev_none",
                                  "recs_dtype", "tails_rows"])
def test_backbone_classes_refuses(case, classed):
    """More classes with lanes than one launch's table holds, a shape or
    dtype that does not match the class, or no prev beside others: raised
    before any launch, on the CPU as on a card."""
    k2_in, tails = _k2_in(classed, 2)
    bad, tails = _bad_inputs(k2_in, tails, case)
    FD.reset_launch_counts()
    with pytest.raises((ValueError, TypeError)):
        FD.backbone_classes(bad, tails)
    assert FD.launch_counts()["k2"] == 0
