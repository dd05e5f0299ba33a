"""The bb wire's call (fused_decode.backbone_only: on the card one kernel,
k2_backbone_bb) against the JAX package's `_run_backbone_only`, on CPU.

JAX's bb call is k2 (Pallas, interpret mode here) and its XLA epilogue;
the port's CPU route is bb_epilogue_plain(backbone_rolled_plain(...)), the
kernel's oracle. Both are fed the same seeds: at refine_iters 1 the
anchor seeds, at 2 the JAX path's own k1 tails (the port rolls them
inside, JAX before the call). Tolerances, as tests/test_torch_bb_wire.py:
offsets within 1 i16 unit (0.1 mA) and CA within 1e-3 A on the rows each
lane owns (torch's and XLA's CPU sin/cos differ by ulps, and a value at a
half of the quantum flips by one unit). The kernel's runs of 8 residues
and their stores are held bit-equal to the same oracle on the card by
chip_smoke.py phase 11.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_property_roundtrip import synthesize

from foldcomp_tpu.codec.batch import pack_decode_batch_lanes
from foldcomp_tpu.codec.encoder import encode
from foldcomp_tpu.kernels import pallas_decode as P
from foldcomp_tpu_torch.codec.batch import arrays_to_torch
from foldcomp_tpu_torch.kernels import fused_decode as FD

TOL_I16 = 1
TOL_CA_A = 1e-3
KEYS = ("seg_records", "mins_lane", "cont_lane", "sc_codes_seg", "fwd9",
        "rev9", "seg_m")


@pytest.fixture(scope="module")
def mixed():
    """The test_wclass.py corpus, its JAX class prep and k1 tails."""
    fczs = [encode(synthesize(n, seed=i))
            for i, n in enumerate((26, 60, 151, 240, 60))]
    arrays, _ = pack_decode_batch_lanes(fczs)
    pr = P._class_prep(*(arrays[k] for k in KEYS))
    tails = np.array(P._run_tails(pr, True))
    return arrays, pr, tails


def _jax_bb(arrays, pr, tails, refine_iters, nl_out):
    """_run_backbone_only (interpret) on the seeds decode_seg_fused gives
    it (pallas_decode.py:592-613)."""
    fwd9, is_first = arrays["fwd9"], arrays["is_first"]
    if refine_iters >= 2:
        rolled = jnp.roll(tails, 1, axis=1)
        seeds = jnp.stack([jnp.where(is_first, fwd9[a * 3 + c],
                                     rolled[c * 3 + a])
                           for a in range(3) for c in range(3)])
    else:
        seeds = jnp.asarray(fwd9)
    return [np.array(x) for x in P._run_backbone_only(
        pr, P._blocked(seeds, 9, pr["np"]), True, nl_out)]


def _port_args(arrays, tails, refine_iters):
    ta = arrays_to_torch(arrays, "cpu")
    prep = FD.class_prep(*(ta[k] for k in KEYS[:6]), ta["seg_m"])
    t9 = torch.from_numpy(tails) if refine_iters >= 2 else None
    return (prep["recs"], t9, prep["fwd9"], ta["is_first"], prep["rev9"],
            prep["tat"], prep["mins6"], prep["cont6"],
            ta["seg_m"].to(torch.int32).contiguous())


@pytest.mark.parametrize("refine_iters", [1, 2])
def test_backbone_only_matches_jax_run_backbone_only(mixed, refine_iters):
    arrays, pr, tails = mixed
    nl_out = int(arrays["nl_out"])
    want = _jax_bb(arrays, pr, tails, refine_iters, nl_out)
    FD.reset_launch_counts()
    got = [x.numpy() for x in FD.backbone_only(
        *_port_args(arrays, tails, refine_iters), nl_out)]
    assert FD.launch_counts() == {"prep": 0, "k1": 0, "k2": 0, "k2_bb": 0,
                                 "k3": 0}
    assert [(g.dtype, g.shape) for g in got] == \
        [(w.dtype, w.shape) for w in want]
    own = np.arange(got[0].shape[1])[None, :] \
        < arrays["seg_m"][:nl_out, None]
    d_off = np.abs(got[0].astype(np.int32) - want[0])[own].max()
    d_ca = np.abs(got[1] - want[1])[own].max()
    assert d_off <= TOL_I16, d_off
    assert d_ca <= TOL_CA_A, d_ca


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_backbone_only_refuses_a_wrong_seg_m(mixed, bad):
    arrays, _, tails = mixed
    args = list(_port_args(arrays, tails, 2))
    seg_m = args[-1]
    args[-1] = seg_m.long() if bad == "dtype" else seg_m[:-1]
    with pytest.raises((TypeError, ValueError), match="seg_m"):
        FD.backbone_only(*args)
