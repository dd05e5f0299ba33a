"""k1's and k2's lane inputs in foldcomp_tpu_torch/kernels/fused_decode.py:
the lane order both kernels walk, the N-CA lengths they derive from the
records, and the seed roll k2 does itself.

The kernels run only on the card (chip_smoke.py holds them against their
plain versions there); here the plain functions that define what they
compute are held against the JAX reference's and torch's own.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldcomp_tpu.kernels import pallas_decode as P
from foldcomp_tpu_torch import verify
from foldcomp_tpu_torch.codec.batch import arrays_to_torch
from foldcomp_tpu_torch.codec.batch_host import pack_decode_batch_lanes
from foldcomp_tpu_torch.codec.encoder import encode
from foldcomp_tpu_torch.core import tables as T
from foldcomp_tpu_torch.kernels import fused_decode as FD

BENCH_LENGTHS = (120, 200, 280, 360, 480, 640, 840, 1080)
WARP = 32
PACK_KEYS = ("seg_records", "mins_lane", "cont_lane", "sc_codes_seg",
             "fwd9", "rev9", "seg_m")


def _pack(fczs):
    arrays, _ = pack_decode_batch_lanes(fczs)
    return arrays, arrays_to_torch(arrays, "cpu")


@pytest.fixture(scope="module")
def mixed512():
    """chip_smoke's phase-2 batch: 512 entries of bench.py's 8 lengths."""
    uniq = verify.synthetic_corpus(BENCH_LENGTHS)
    rng = random.Random(0)
    return _pack([uniq[rng.choice(BENCH_LENGTHS)] for _ in range(512)])


@pytest.fixture(scope="module")
def small():
    """The test_wclass.py mixed corpus and a wide one (SEG > 96)."""
    return {name: _pack([encode(verify.synthesize(n, seed=i),
                                anchor_threshold=interval)
                         for i, n in enumerate(lengths)])
            for name, (lengths, interval) in {
                "mixed": ((26, 60, 151, 240, 60), 25),
                "wide": ((120, 220), 200)}.items()}


def _warp_row_steps(rows):
    """Row-steps of the warps over lanes with these row counts, in this
    order: each warp of 32 threads runs as long as its longest lane."""
    pad = (-rows.numel()) % WARP
    r = torch.cat([rows, rows.new_zeros(pad)]).view(-1, WARP)
    return int((r.max(dim=1).values * WARP).sum())


@pytest.mark.parametrize("corpus", ["mixed512", "mixed", "wide"])
def test_lane_order_is_a_stable_sort_by_tat(corpus, mixed512, small):
    _, ta = mixed512 if corpus == "mixed512" else small[corpus]
    tat = 3 * ta["seg_m"]
    order = FD.lane_order(tat).perm
    assert order.dtype == torch.int32
    o = order.long()
    assert torch.equal(torch.sort(o).values, torch.arange(tat.numel()))
    t = tat[o]
    assert bool((t[1:] <= t[:-1]).all())
    same = t[1:] == t[:-1]
    assert bool((o[1:][same] > o[:-1][same]).all())     # stable
    # the sorted order never costs the warps more than the pack order
    seg_m = ta["seg_m"].long()
    assert _warp_row_steps(seg_m[o]) <= _warp_row_steps(seg_m)


def test_lane_order_warps_walk_real_rows(mixed512):
    """On the mixed batch the warps' row-steps in lane order stay within
    1% of the real rows (the lanes' own residues, pad lanes included),
    where the pack order costs ~1.47x."""
    arrays, ta = mixed512
    seg_m = ta["seg_m"].long()
    real = int(seg_m.sum())
    sorted_steps = _warp_row_steps(seg_m[FD.lane_order(3 * ta["seg_m"])
                                         .perm.long()])
    assert sorted_steps / real <= 1.01
    assert _warp_row_steps(seg_m) / real > 1.3


def test_wrappers_take_only_a_lane_order(small):
    """The kernels index the lanes by the order, so the wrappers' checks
    take a LaneOrder of these lanes (lane_order's, or k0's from prep) and
    refuse a bare tensor, and off the CPU a missing order; the pack order
    is the identity."""
    _, ta = small["mixed"]
    prep = FD.class_prep(*(ta[k] for k in PACK_KEYS[:6]), ta["seg_m"])
    lane = (prep["rev9"], prep["tat"], prep["mins6"], prep["cont6"])
    nl = prep["tat"].numel()
    pack = FD.lane_order(prep["tat"], by_length=False)
    assert torch.equal(pack.perm, torch.arange(nl, dtype=torch.int32))
    seeds = {"fwd9": prep["fwd9"]}
    seg = prep["recs"].shape[1]
    assert FD._check_lane_inputs(prep["recs"], *lane, pack, seeds) \
        == (seg, nl)
    (k0,) = FD.prep([tuple(ta[k] for k in PACK_KEYS)])
    assert isinstance(k0["order"], FD.LaneOrder)
    assert FD._check_lane_inputs(prep["recs"], *lane, k0["order"], seeds) \
        == (seg, nl)
    with pytest.raises(TypeError):
        FD._check_lane_inputs(prep["recs"], *lane, pack.perm, seeds)
    with pytest.raises(ValueError):
        FD._check_lane_inputs(prep["recs"], *lane,
                              FD.LaneOrder(pack.perm[1:]), seeds)
    with pytest.raises(ValueError):
        FD._check_lane_inputs(prep["recs"], *lane, pack, {"tails9": None})
    with pytest.raises(TypeError):
        FD._check_lane_inputs(prep["recs"], *lane, pack, seeds,
                              is_first=ta["is_first"].to(torch.uint8))
    # no order: the CPU's plain versions read none; any other device's
    # kernels need one
    assert FD._check_lane_inputs(prep["recs"], *lane, None, seeds) \
        == (seg, nl)
    meta = [t.to("meta") for t in (prep["recs"], *lane, prep["fwd9"])]
    with pytest.raises(TypeError):
        FD._check_lane_inputs(*meta[:5], None, {"fwd9": meta[5]})


@pytest.mark.parametrize("corpus", ["mixed512", "mixed", "wide"])
def test_n_ca_lengths_match_class_prep_blca(corpus, mixed512, small):
    """The N-CA length k1 and k2 derive from the records is the JAX
    _class_prep's blca for every residue, prolines included."""
    arrays, ta = mixed512 if corpus == "mixed512" else small[corpus]
    recs = ta["seg_records"]
    code = recs[0].to(torch.int32) >> 3
    assert bool((code == T.PRO_CODE).any())
    pr = P._class_prep(*(arrays[k] for k in PACK_KEYS))
    want = np.asarray(pr["blca_p"]).reshape(recs.shape[1], -1)
    got = FD.n_ca_lengths(recs)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want[:, :recs.shape[2]])
    former = torch.where(code == T.PRO_CODE,
                         torch.tensor(float(T.PRO_N_TO_CA)),
                         torch.tensor(float(T.N_TO_CA)))
    assert torch.equal(got, former)


def test_seed_roll_wraps_at_lane_zero(small):
    """Lane 0, when it is not a protein's first segment, is seeded by lane
    NL-1's tail: torch.roll's wrap, which is jnp.roll's."""
    _, ta = small["mixed"]
    nl = ta["fwd9"].shape[1]
    rng = np.random.default_rng(5)
    tails9 = torch.from_numpy(rng.normal(size=(9, nl)).astype(np.float32))
    is_first = ta["is_first"].clone()
    is_first[0] = False
    seeds = FD.refine_seeds(tails9, ta["fwd9"], is_first)
    want = torch.roll(tails9, 1, dims=1)[:, 0].reshape(3, 3).t().reshape(9)
    assert torch.equal(seeds[:, 0], want)
    assert torch.equal(seeds[:, 0], tails9[:, nl - 1].reshape(3, 3).t()
                       .reshape(9))
    rolled = np.asarray(jnp.roll(tails9.numpy(), 1, axis=1))
    assert np.array_equal(torch.roll(tails9, 1, dims=1).numpy(), rolled)
    # k2's plain version takes the same seed
    prep = FD.class_prep(*(ta[k] for k in PACK_KEYS[:6]), ta["seg_m"])
    lane = (prep["rev9"], prep["tat"], prep["mins6"], prep["cont6"])
    got = FD.backbone_rolled_plain(prep["recs"], tails9, prep["fwd9"],
                                   is_first, *lane)
    staged = FD.backbone_plain(prep["recs"], FD.n_ca_lengths(prep["recs"]),
                               seeds, *lane)
    for g, s in zip(got, staged):
        assert torch.equal(g, s)
