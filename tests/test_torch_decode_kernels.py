"""Port kernels (foldcomp_tpu_torch/kernels/fused_decode.py) against the
stages of the JAX fused decode (foldcomp_tpu/kernels/pallas_decode.py).

Each plain PyTorch kernel version is fed the same inputs as its Pallas
kernel (run in interpret mode on CPU, as tests/test_pallas_fused.py runs
it): k1 the anchor seeds, k2 the JAX path's own refined seeds, k3 the JAX
path's own backbone rows, so each stage is held on its own. Tolerances:
f32 coordinates within 1e-3 A, i16 offsets within 1 unit (1 mA). torch's
and XLA's CPU sin/cos/rsqrt differ by ulps, and the differences grow
along the 3*SEG-step NeRF chains; the wire's rounding turns a 1e-5 A
difference into a 1-unit flip where a value sits at a half.

Rows past a lane's own residues (the pack's padding, r >= 3*seg_m) are
left out of the backbone comparison: the reference blends them with a
negative forward weight, and no host gather reads them.

The CUDA kernels run only on the card: chip_smoke.py holds them against
these plain versions there.
"""
from functools import partial

import jax
import numpy as np
import pytest
import torch

from test_property_roundtrip import synthesize

from foldcomp_tpu.codec.batch import pack_decode_batch_lanes
from foldcomp_tpu.codec.encoder import encode
from foldcomp_tpu.kernels import pallas_decode as P
from foldcomp_tpu_torch.backend import DeviceUnavailable, resolve_device
from foldcomp_tpu_torch.codec.batch import arrays_to_torch
from foldcomp_tpu_torch.core import tables as T
from foldcomp_tpu_torch.kernels import fused_decode as FD

TOL_A = 1e-3
TOL_I16 = 1

# the test_wclass.py mixed corpus, and wide segments (anchor interval 200,
# so SEG > 96: past the TPU kernel's VMEM-bound width)
CORPORA = {
    "mixed": ((26, 60, 151, 240, 60), 25),
    "wide": ((120, 220), 200),
}


@partial(jax.jit, static_argnames=("refine_iters",))
def _jax_stages(seg_records, mins_lane, cont_lane, sc_codes_seg, fwd9,
                rev9, is_first, seg_m, refine_iters):
    """decode_seg_fused's k1 tails, refined seeds and k2 rows, each kept
    (pallas_decode.py:446-488, 596-610, interpret mode). No reference
    helper returns k2's raw rows, so k2 is wired here as _run_backbone_sc
    wires it; test_stage_copy_matches_jax_decode_seg_fused holds these
    rows to the reference's own output bit for bit."""
    import jax.experimental.pallas as pl
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    pr = P._class_prep(seg_records, mins_lane, cont_lane, sc_codes_seg,
                       fwd9, rev9, seg_m)
    seg, np_, g = pr["seg"], pr["np"], pr["g"]
    t = 3 * seg
    out = {}
    if refine_iters >= 2:
        tails = P._run_tails(pr, True)
        rolled = jnp.roll(tails, 1, axis=1)
        seeds = jnp.stack([jnp.where(is_first, fwd9[a * 3 + c],
                                     rolled[c * 3 + a])
                           for a in range(3) for c in range(3)])
        out["tails"] = tails
    else:
        seeds = fwd9
    out["seeds"] = seeds
    bb_shape = jax.ShapeDtypeStruct((t, np_ // 128, 128), jnp.float32)
    bb = pl.pallas_call(
        P._make_backbone_kernel(seg), grid=(np_ // (128 * g),),
        in_specs=P._bb_in_specs(seg, g), out_specs=(P._spec(t, g),) * 3,
        out_shape=(bb_shape,) * 3,
        scratch_shapes=[pltpu.VMEM((t, g, 128), jnp.float32)
                        for _ in range(6)]
        + [pltpu.VMEM((6 * seg, g, 128), jnp.float32)],
        interpret=True,
    )(pr["recs_p"], pr["blca_p"], P._blocked(seeds, 9, np_), pr["rev9_p"],
      pr["tat_p"], pr["mins6_p"], pr["cont6_p"])
    out["bb"] = [b.reshape(t, np_) for b in bb]
    return out


@pytest.fixture(scope="module", params=sorted(CORPORA))
def corpus(request):
    lengths, interval = CORPORA[request.param]
    fczs = [encode(synthesize(n, seed=i), anchor_threshold=interval)
            for i, n in enumerate(lengths)]
    arrays, _ = pack_decode_batch_lanes(fczs)
    if request.param == "wide":
        assert arrays["seg_records"].shape[1] > 96
    ta = arrays_to_torch(arrays, "cpu")
    prep = FD.class_prep(ta["seg_records"], ta["mins_lane"],
                         ta["cont_lane"], ta["sc_codes_seg"], ta["fwd9"],
                         ta["rev9"], ta["seg_m"])
    keys = ("seg_records", "mins_lane", "cont_lane", "sc_codes_seg", "fwd9",
            "rev9", "is_first", "seg_m")
    jax_out = {r: {k: (np.array(v) if not isinstance(v, list)
                       else [np.array(x) for x in v])
                   for k, v in _jax_stages(*(arrays[k] for k in keys),
                                           refine_iters=r).items()}
               for r in (1, 2)}
    # k3's output: the reference's own decode_seg_fused, whose k3 runs on
    # the same k2 rows
    for r in (1, 2):
        jax_out[r]["off"], jax_out[r]["ca"] = (
            np.array(x) for x in P.decode_seg_fused(
                *(arrays[k] for k in keys), refine_iters=r, interpret=True))
    return dict(arrays=arrays, ta=ta, prep=prep, jax=jax_out)


def _lane_args(prep, seeds):
    """The per-stage plain versions' arguments, N-CA lengths derived from
    the records as the kernels derive them."""
    return (prep["recs"], FD.n_ca_lengths(prep["recs"]), seeds,
            prep["rev9"], prep["tat"], prep["mins6"], prep["cont6"])


@pytest.mark.parametrize("refine_iters", [1, 2])
def test_stage_copy_matches_jax_decode_seg_fused(corpus, refine_iters):
    """_jax_stages wires k2 by hand; its rows must be the ones the
    reference's own decode_seg_fused runs k3 on, bit for bit. k3 passes
    each residue's CA row (k2 row 3*s + 1) through unchanged, so a drift
    between the copy and the reference's call site fails here."""
    ref = corpus["jax"][refine_iters]
    seg = ref["ca"].shape[1]
    ca_rows = np.stack([b.reshape(seg, 3, -1)[:, 1] for b in ref["bb"]])
    assert np.array_equal(ca_rows.transpose(2, 1, 0), ref["ca"])


def test_k1_tails_plain_matches_jax(corpus):
    prep = corpus["prep"]
    got = FD.tails_plain(*_lane_args(prep, prep["fwd9"])).numpy()
    want = corpus["jax"][2]["tails"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL_A


def test_seed_roll_matches_jax(corpus):
    """Given the JAX tails, the port's roll + is_first select is exact."""
    ta = corpus["ta"]
    got = FD.refine_seeds(torch.from_numpy(corpus["jax"][2]["tails"]),
                          ta["fwd9"], ta["is_first"]).numpy()
    assert np.array_equal(got, corpus["jax"][2]["seeds"])


@pytest.mark.parametrize("refine_iters", [1, 2])
def test_k2_backbone_plain_matches_jax(corpus, refine_iters):
    prep = corpus["prep"]
    ref = corpus["jax"][refine_iters]
    got = FD.backbone_plain(*_lane_args(prep,
                                        torch.from_numpy(ref["seeds"])))
    rows = np.arange(got[0].shape[0])[:, None]
    own = rows < prep["tat"].numpy()[None, :]
    for g, w in zip(got, ref["bb"]):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w)[own].max() <= TOL_A


@pytest.mark.parametrize("refine_iters", [1, 2])
def test_k2_rolled_plain_matches_jax(corpus, refine_iters):
    """The function k2 now computes (the seed roll and the N-CA lengths
    inside), fed the JAX tails, fwd9 and is_first: within 1e-3 A of the
    JAX k2 rows on owned rows, and bit for bit backbone_plain on the JAX
    path's own seeds."""
    prep, ta = corpus["prep"], corpus["ta"]
    ref = corpus["jax"][refine_iters]
    tails9 = torch.from_numpy(ref["tails"]) if refine_iters >= 2 else None
    got = FD.backbone_rolled_plain(prep["recs"], tails9, prep["fwd9"],
                                   ta["is_first"], prep["rev9"], prep["tat"],
                                   prep["mins6"], prep["cont6"])
    staged = FD.backbone_plain(*_lane_args(prep,
                                           torch.from_numpy(ref["seeds"])))
    own = np.arange(got[0].shape[0])[:, None] < prep["tat"].numpy()[None, :]
    for g, s, w in zip(got, staged, ref["bb"]):
        assert torch.equal(g, s)
        assert np.abs(g.numpy() - w)[own].max() <= TOL_A


@pytest.mark.parametrize("refine_iters", [1, 2])
def test_k3_sidechain_plain_matches_jax(corpus, refine_iters):
    prep = corpus["prep"]
    ref = corpus["jax"][refine_iters]
    off, ca = FD.sidechain_plain(*(torch.from_numpy(b) for b in ref["bb"]),
                                 prep["code"], prep["sct"])
    assert off.dtype == torch.int16 and off.shape == ref["off"].shape
    assert ca.shape == ref["ca"].shape
    assert np.abs(off.numpy().astype(np.int32)
                  - ref["off"].astype(np.int32)).max() <= TOL_I16
    assert np.abs(ca.numpy() - ref["ca"]).max() <= TOL_A


@pytest.mark.parametrize("refine_iters", [1, 2])
def test_decode_seg_fused_matches_jax(corpus, refine_iters):
    """The whole device stage, on the port's own intermediates."""
    ta = corpus["ta"]
    nl_out = corpus["arrays"]["nl_out"]
    off, ca = FD.decode_seg_fused(
        ta["seg_records"], ta["mins_lane"], ta["cont_lane"],
        ta["sc_codes_seg"], ta["fwd9"], ta["rev9"], ta["is_first"],
        ta["seg_m"], refine_iters=refine_iters, nl_out=nl_out)
    ref = corpus["jax"][refine_iters]
    assert off.shape == (nl_out,) + ref["off"].shape[1:]
    seg_m = corpus["arrays"]["seg_m"][:nl_out]
    own = np.arange(off.shape[1])[None, :] < seg_m[:, None]
    d_off = np.abs(off.numpy().astype(np.int32)
                   - ref["off"][:nl_out].astype(np.int32))
    assert d_off[own].max() <= TOL_I16
    assert np.abs(ca.numpy() - ref["ca"][:nl_out])[own].max() <= TOL_A


def test_tables_match_where_chains():
    """The 32-code lookup tables give what the JAX where-chains give for
    every 5-bit code, 24-31 included."""
    import jax.numpy as jnp
    code = jnp.arange(32, dtype=jnp.int32)
    slots = [jnp.full(32, float(s), jnp.float32) for s in range(14)]
    for k in range(3, 14):
        for j in range(3):
            got, _, _ = P._sel_pred(code, slots, slots, slots,
                                    P._PRED[:, k, j])
            assert np.array_equal(np.asarray(got).astype(np.int32),
                                  T.PRED32[:, k, j]), (k, j)
        assert np.array_equal(np.asarray(P._chain_const(code,
                                                        P._BLEN[:, k])),
                              T.BLEN32[:, k]), k
        assert np.array_equal(np.asarray(P._chain_const(code,
                                                        P._BANG[:, k])),
                              T.BANG32[:, k]), k


def test_wrappers_run_plain_on_cpu_without_launching(corpus):
    prep = corpus["prep"]
    FD.reset_launch_counts()
    args = _lane_args(prep, prep["fwd9"])
    lane = (prep["rev9"], prep["tat"], prep["mins6"], prep["cont6"])
    tails9 = FD.tails(prep["recs"], prep["fwd9"], *lane)
    assert torch.equal(tails9, FD.tails_plain(*args))
    bb = FD.backbone(prep["recs"], tails9, prep["fwd9"],
                     corpus["ta"]["is_first"], *lane)
    seeds = FD.refine_seeds(tails9, prep["fwd9"], corpus["ta"]["is_first"])
    rows = bb.rows()
    for a, b in zip(rows, FD.backbone_plain(*_lane_args(prep, seeds))):
        assert torch.equal(a, b)
    for a, b in zip(FD.sidechain(bb, prep["code"], prep["sct"], 512),
                    FD.sidechain_plain(*rows, prep["code"], prep["sct"],
                                       512)):
        assert torch.equal(a, b)
    seg_m = (prep["tat"] // 3).to(torch.int32)
    for a, b in zip(FD.backbone_only(prep["recs"], tails9, prep["fwd9"],
                                     corpus["ta"]["is_first"], *lane, seg_m,
                                     512),
                    FD.bb_epilogue_plain(*rows, 512)):
        assert torch.equal(a, b)
    assert FD.launch_counts() == {"prep": 0, "prep_bb": 0, "k1": 0, "k2": 0,
                                 "k2_classes": 0, "k2_bb": 0, "k3": 0,
                                 "k3_staged": 0}


def test_wrappers_refuse_other_devices():
    meta = torch.empty((8, 8, 128), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        FD.tails(meta, *([None] * 6))


def test_device_resolution(monkeypatch):
    monkeypatch.delenv("FOLDCOMP_TORCH_DEVICE", raising=False)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("FOLDCOMP_TORCH_DEVICE", "cpu")
    assert resolve_device(None) == torch.device("cpu")
    if not torch.cuda.is_available():
        monkeypatch.delenv("FOLDCOMP_TORCH_DEVICE")
        with pytest.raises(DeviceUnavailable):
            resolve_device(None)
        with pytest.raises(DeviceUnavailable):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_arrays_to_torch_checks_segment_widths():
    fczs = [encode(synthesize(40, seed=3))]
    arrays, _ = pack_decode_batch_lanes(fczs)
    ta = arrays_to_torch(arrays, "cpu")
    assert ta["seg_records"].dtype == torch.uint8
    assert ta["is_first"].dtype == torch.bool
    assert ta["nl_out"] == arrays["nl_out"]
    bad = dict(arrays, seg_m=arrays["seg_m"].copy())
    bad["seg_m"][0] = arrays["seg_records"].shape[1] + 1
    with pytest.raises(ValueError):
        arrays_to_torch(bad, "cpu")
