"""k3 on k2's rows where k2 staged them (foldcomp_tpu_torch/kernels/
fused_decode.py Staged, sidechain), on CPU.

On a card k2_backbone leaves lane l's blended rows at its thread's column
pos[l], the columns in k0's lane order (column i holds lane order[i]), and
k3_sidechain reads them there, its groups 32 lanes in pack order: nothing
copies the rows to the lanes' columns. Held here: Staged's rows() gives
the lane rows back bit for bit from any such staging; sidechain on a
Staged equals sidechain_plain on the lane rows; and a Python model of
k3's group rule (fused_decode.cu k3_sidechain: rows below the group's
median in dense steps, the rest in sparse ones) over class_layout's
shapes writes every real row of every real lane once and no pad row. The
kernel itself runs only on the card (chip_smoke.py phases 2, 4 and 14).
"""
import numpy as np
import pytest
import torch

from foldcomp_tpu_torch.codec import batch as B
from foldcomp_tpu_torch.codec import batch_host as H
from foldcomp_tpu_torch.codec.encoder import encode
from foldcomp_tpu_torch.kernels import fused_decode as FD
from foldcomp_tpu_torch.verify import synthesize

# tests/test_torch_wclass.py's mixed corpus: a protein's lanes land in
# several classes
MIXED = (26, 60, 151, 240, 60)
K3_TL, K3_TS = 32, 4    # fused_decode.cu: a group's columns, a dense step


def _stage(rows, perm):
    """A Staged of lane rows [3*SEG, NL] x3 as k2 leaves them: column i
    holds lane perm[i], and pos is perm's inverse."""
    pos = torch.empty_like(perm)
    pos[perm.long()] = torch.arange(perm.numel(), dtype=perm.dtype)
    planes = [r.index_select(1, perm.long()).contiguous() for r in rows]
    return FD.Staged(*planes, pos)


@pytest.mark.parametrize("seed", range(3))
def test_rows_give_the_lane_rows(seed):
    """rows() of a staging of lane rows by a random order gives those rows
    back bit for bit; the staged planes are the rows permuted, not equal
    to them."""
    g = torch.Generator().manual_seed(seed)
    seg, nl = 8 * (seed + 1), 97 + 64 * seed
    rows = [torch.randn((3 * seg, nl), generator=g) for _ in range(3)]
    perm = torch.randperm(nl, generator=g).to(torch.int32)
    st = _stage(rows, perm)
    assert not torch.equal(st.x, rows[0])
    got = st.rows()
    for a, b in zip(got, rows):
        assert a.view(torch.int32).equal(b.view(torch.int32))
    assert FD.Staged(*rows).rows()[0] is rows[0]


@pytest.fixture(scope="module")
def classed():
    fczs = [encode(synthesize(n, seed=i)) for i, n in enumerate(MIXED)]
    arrays, metas = H.pack_decode_batch_lanes(fczs)
    split = H.split_lanes_classes(dict(arrays), metas, min_save=-100.0)
    assert split is not None and len(split[0]["classes"]["recs"]) >= 2
    return B.arrays_to_torch(split[0], "cpu")


def test_sidechain_on_staged_is_plain(classed):
    """Each class of a classed pack: sidechain on k2's Staged (on the CPU
    the lane rows themselves) and on a staging of the same rows in the
    class's lane order gives sidechain_plain's output on the lane rows,
    bit for bit; nothing launched."""
    c = classed["classes"]
    FD.reset_launch_counts()
    for i in range(len(c["recs"])):
        pr = FD.class_prep(c["recs"][i], c["mins"][i], c["cont"][i],
                           c["sct"][i], c["fwd"][i], c["rev"][i],
                           c["segm"][i])
        order = FD.lane_order(pr["tat"])
        st = FD.backbone(pr["recs"], None, pr["fwd9"], c["isf"][i],
                         pr["rev9"], pr["tat"], pr["mins6"], pr["cont6"],
                         order)
        rows = FD.backbone_rolled_plain(pr["recs"], None, pr["fwd9"],
                                        c["isf"][i], pr["rev9"], pr["tat"],
                                        pr["mins6"], pr["cont6"])
        nlo = classed["nl_outs"][i]
        want = FD.sidechain_plain(*rows, pr["code"], pr["sct"], nlo)
        for form in (st, _stage(rows, order.perm)):
            got = FD.sidechain(form, pr["code"], pr["sct"], nlo,
                               seg_m=c["segm"][i])
            for a, b in zip(got, want):
                assert a.shape == b.shape and torch.equal(a, b), i
    assert FD.launch_counts()["k3"] == FD.launch_counts()["k3_staged"] == 0


def _k3_writes(seg_m, seg, nl_out):
    """k3_sidechain's rule over one class: groups of K3_TL lanes l <
    nl_out in pack order; each lane's rows r = min(seg_m, SEG); m the
    rows of the lane of rank (n - 1) // 2 by (r, lane); dense steps write
    rows s < min(r, m), K3_TS at a time, sparse steps rows m <= s < r.
    -> {(lane, row): times written}."""
    writes = {}
    for c0 in range(0, nl_out, K3_TL):
        lanes = range(c0, min(c0 + K3_TL, nl_out))
        rows = [min(int(seg_m[l]), seg) for l in lanes]
        valid = sorted((r, t) for t, r in enumerate(rows))
        m = valid[(len(valid) - 1) // 2][0]
        for s0 in range(0, m, K3_TS):
            for l, r in zip(lanes, rows):
                for s in range(s0, s0 + K3_TS):
                    if s < min(r, m):
                        writes[l, s] = writes.get((l, s), 0) + 1
        for l, r in zip(lanes, rows):
            for s in range(m, r):
                writes[l, s] = writes.get((l, s), 0) + 1
    return writes


@pytest.mark.parametrize("seed", [7, 8])
def test_group_rule_writes_each_real_row_once(seed):
    """k3's groups over class_layout's classes of random sizes and widths,
    each lane's residue count random in 1 .. SEG (lanes of one protein in
    runs of one length, as the pack's are) and a pad tail of lanes past
    nl_out: each real row (lane l < nl_out, row s < seg_m[l]) written
    once, no other row."""
    rng = np.random.default_rng(seed)
    nls = [int(rng.integers(1, 700)) for _ in range(4)]
    segs = [8 * int(rng.integers(1, 13)) for _ in range(4)]
    lay = FD.class_layout(nls, segs)
    assert len(lay.launch) == 4
    for g in lay.launch:
        nl_out = int(rng.integers(max(g.nl // 2, 1), g.nl + 1))
        seg_m = np.ones(g.nl, np.int64)
        runs = rng.integers(1, 9, size=g.nl)
        lengths = rng.integers(1, g.seg + 1, size=g.nl)
        l = 0
        for n, s in zip(runs, lengths):
            seg_m[l:min(l + n, nl_out)] = s
            l += n
            if l >= nl_out:
                break
        got = _k3_writes(seg_m, g.seg, nl_out)
        assert got == {(l, s): 1 for l in range(nl_out)
                       for s in range(min(int(seg_m[l]), g.seg))}, g.c
