"""k2 over every width class of a batch in one launch
(foldcomp_tpu_torch/kernels/fused_decode.py backbone_classes,
k2_class_table, k2_slots, k2_views), on CPU.

One launch of k2_backbone and one of k2_copy_out take a table of the
classes: k2_backbone's blocks are k1's (k1_class_table: the widest SEG
first, K1_THREADS lanes a block), k2_copy_out's a range of
ceil(NL_c / K2_COPY_THREADS) * SEG_c blocks a class; one allocation holds
every class's output planes, scratch planes and pos. The tables and the
views are pure Python and are held here to the kernels' rules
(fused_decode.cu k2_backbone, k2_copy_out). The CUDA kernels run only on
the card (chip_smoke.py phase 14 holds one launch bit-equal to a launch
a class, and to backbone_rolled_plain); on the CPU backbone_classes runs
backbone_rolled_plain class by class and launches nothing.
decode_seg_fused_classes stays bit-equal to the single-class decode
(tests/test_torch_wclass.py test_classes_bit_equal_to_single_class).
"""
import numpy as np
import pytest
import torch

from test_property_roundtrip import synthesize

from foldcomp_tpu.codec.encoder import encode
from foldcomp_tpu_torch.codec import batch as B
from foldcomp_tpu_torch.codec import batch_host as H
from foldcomp_tpu_torch.kernels import fused_decode as FD

# the test_wclass.py mixed corpus: a protein's lanes land in several
# classes
MIXED = (26, 60, 151, 240, 60)


def _random_classes(seed):
    """Class sizes and widths: one to K1_MAX_CLASSES classes, one of them
    empty in odd cases, NL not a multiple of the block sizes but in case
    0."""
    rng = np.random.default_rng(seed)
    n_cls = int(rng.integers(1, FD.K1_MAX_CLASSES + 1))
    nls = [int(rng.integers(1, 900)) for _ in range(n_cls)]
    if seed == 0:
        nls = [1024, 512, 256, 128][:n_cls]
    if seed % 2 and n_cls > 1:
        nls[int(rng.integers(n_cls))] = 0
    segs = [8 * int(rng.integers(1, 13)) for _ in range(n_cls)]
    return nls, segs


def _kernel_cover(nls, segs):
    """Run the kernels' rules over k2_class_table: k2_backbone's block b
    to the last entry whose block0 <= b, thread t to lane order[(b -
    block0) * K1_THREADS + t] of that class (each class's order a random
    permutation); k2_copy_out's block b to the last entry whose copy0 <=
    b, thread t to residue (b - copy0) // xb of lane ((b - copy0) % xb) *
    K2_COPY_THREADS + t. -> ({(class, lane): walks}, {(class, residue,
    lane): copies}, entries, blocks, copies)."""
    rng = np.random.default_rng(len(nls))
    orders = [rng.permutation(n) for n in nls]
    entries, blocks, copies = FD.k2_class_table(nls, segs)
    walked, copied = {}, {}
    for b in range(blocks):
        c, b0, _ = [e for e in entries if e[1] <= b][-1]
        for t in range(FD.K1_THREADS):
            i = (b - b0) * FD.K1_THREADS + t
            if i < nls[c]:
                key = (c, int(orders[c][i]))
                walked[key] = walked.get(key, 0) + 1
    for b in range(copies):
        c, _, c0 = [e for e in entries if e[2] <= b][-1]
        xb = -(-nls[c] // FD.K2_COPY_THREADS)
        s, x = divmod(b - c0, xb)
        for t in range(FD.K2_COPY_THREADS):
            lane = x * FD.K2_COPY_THREADS + t
            if lane < nls[c]:
                key = (c, s, lane)
                copied[key] = copied.get(key, 0) + 1
    return walked, copied, entries, blocks, copies


@pytest.mark.parametrize("seed", range(6))
def test_k2_table_covers_every_lane_once(seed):
    """Each lane of each class walked once by k2_backbone, each of its
    residues copied once by k2_copy_out and no residue past its class's
    SEG; the widest class first, as k1_class_table orders and blocks
    them; no empty class in the table."""
    nls, segs = _random_classes(seed)
    walked, copied, entries, blocks, copies = _kernel_cover(nls, segs)
    n_cls = len(nls)
    assert walked == {(c, l): 1 for c in range(n_cls) for l in range(nls[c])}
    assert copied == {(c, s, l): 1 for c in range(n_cls)
                      for s in range(segs[c]) for l in range(nls[c])}
    k1, k1_blocks = FD.k1_class_table(nls, segs)
    assert [(c, b0) for c, b0, _ in entries] == [(c, b0) for c, _, b0 in k1]
    assert blocks == k1_blocks
    assert [c for c, _, _ in entries] == sorted(
        (c for c in range(n_cls) if nls[c]), key=lambda c: -segs[c])
    assert all(nls[c] for c, _, _ in entries)
    assert copies == sum(-(-n // FD.K2_COPY_THREADS) * s
                         for n, s in zip(nls, segs))


@pytest.mark.parametrize("nls, segs, want", [
    ([0, 0], [8, 16], ([], 0, 0)),
    ([300], [48], ([(0, 0, 0)], 3, 2 * 48)),
    # ties keep the class order; a class of no rows takes no block
    ([129, 1, 128, 64], [24, 48, 24, 0],
     ([(1, 0, 0), (0, 1, 48), (2, 3, 48 + 24)], 4, 48 + 24 + 24)),
])
def test_k2_table_small(nls, segs, want):
    assert FD.k2_class_table(nls, segs) == want


@pytest.mark.parametrize("seed", range(4))
def test_k2_views_disjoint_and_shaped(seed):
    """Every class's output planes, scratch planes and pos are views of
    one workspace: each of its class's shape, contiguous, 128-byte
    aligned, inside the workspace and disjoint from every other."""
    nls, segs = _random_classes(seed)
    slots, size = FD.k2_slots(nls, segs)
    ws = torch.zeros((size,), dtype=torch.float32)
    spans = []
    for nl, seg, sl in zip(nls, segs, slots):
        v = FD.k2_views(ws, sl)
        assert set(v) == {"ox", "oy", "oz", "sx", "sy", "sz", "pos"}
        for name, t in v.items():
            want = (nl,) if name == "pos" else (3 * seg, nl)
            assert tuple(t.shape) == want, name
            assert t.dtype == (torch.int32 if name == "pos"
                               else torch.float32)
            assert t.is_contiguous()
            assert t.untyped_storage().data_ptr() == \
                ws.untyped_storage().data_ptr()
            off = t.storage_offset()
            assert off % 32 == 0 and off + t.numel() <= size
            spans.append((off, off + t.numel()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    # what is written through one view is read back through it after
    # every other view has been written
    views = [t for sl in slots for t in FD.k2_views(ws, sl).values()]
    for i, t in enumerate(views):
        t.fill_(i + 1)
    for i, t in enumerate(views):
        assert bool((t == i + 1).all())
    assert size == sum(-(-n // 32) * 32 for nl, seg in zip(nls, segs)
                       for n in [3 * seg * nl] * 6 + [nl])


@pytest.fixture(scope="module")
def classed():
    fczs = [encode(synthesize(n, seed=i)) for i, n in enumerate(MIXED)]
    arrays, metas = H.pack_decode_batch_lanes(fczs)
    split = H.split_lanes_classes(dict(arrays), metas, min_save=-100.0)
    assert split is not None and len(split[0]["classes"]["recs"]) >= 2
    return B.arrays_to_torch(split[0], "cpu")


def _k2_in(ta, refine_iters):
    """backbone_classes' classes and tails for a classed tensor dict, as
    decode_seg_fused_classes makes them."""
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
    for c, rows in zip(k2_in, got):
        want = FD.backbone_rolled_plain(c[0], tails, *c[1:7], c[8])
        one = FD.backbone(c[0], tails, *c[1:])
        for g, w, o in zip(rows, want, one):
            assert g.shape == (3 * c[0].shape[1], c[0].shape[2])
            assert torch.equal(g, w) and torch.equal(g, o)


@pytest.mark.parametrize("refine_iters", [1, 2])
def test_classed_decode_calls_k2_once(refine_iters, classed, monkeypatch):
    """decode_seg_fused_classes calls backbone_classes once, with every
    class: class i's prev is its slice of prev_idx (the same memory), and
    the tails are every class's [9, NL_total]; at refine_iters 1 no tails
    and no prev. Then k3 reads each class's rows."""
    c = classed["classes"]
    calls = []
    real = FD.backbone_classes

    def spy(classes, tails9=None):
        calls.append((classes, tails9))
        return real(classes, tails9)

    monkeypatch.setattr(FD, "backbone_classes", spy)
    FD.decode_seg_fused_classes(
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
        k2_in = (k2_in * 3)[:FD.K1_MAX_CLASSES + 1]
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
