"""The backbone-only wire's resident form (codec/batch.arrays_to_torch of
a bb pack), k0's bb mode (kernels/fused_decode.prep(..., wire="bb")) and
their spans and counters, on the CPU, against the backbone reference of
the benchmark's backbone cell (portbench/backbone_ref.py, plain PyTorch)
and the frozen NumPy decoder beside it (portbench/reference/decoder.py).

Tolerances:
- the port's bb decode against backbone_ref, per atom of N, CA and C:
  TOL_PORT_A = 0.02 A. The port seeds each anchor segment from one
  refinement of the forward walks' tails (refine_iters 2), where
  Foldcomp's decoder walks the segments one after another from each
  blended tail: up to 5.0e-3 A on these corpora (measured), and the bb
  wire rounds N and C to its 0.1 mA quantum. backbone_ref in bfloat16
  lies 0.5 A or more from the float32 reference on every corpus, 25x the
  tolerance;
- backbone_ref against the frozen NumPy decoder: TOL_REF_A = 1e-3 A. Both
  follow Foldcomp's float32 rounding step for step, but the frozen copy
  takes glibc's cosf and sinf and backbone_ref cos and sin in float64
  rounded to float32: they differ by an ulp in ~1.3% of angles, and the
  NeRF walks carry that to at most 3.5e-4 A on these lengths (measured).
"""
import numpy as np
import pytest
import torch

from foldcomp_tpu_torch import tracing, verify
from foldcomp_tpu_torch.codec import batch as B
from foldcomp_tpu_torch.codec import batch_host as H
from foldcomp_tpu_torch.codec.encoder import encode
from foldcomp_tpu_torch.codec.fcz import serialize
from foldcomp_tpu_torch.kernels import fused_decode as FD
from foldcomp_tpu_torch.native import get_lib
from portbench import backbone_ref
from portbench.reference import tasks

TOL_PORT_A = 0.02
TOL_REF_A = 1e-3
PRO = 14
LENGTHS = (26, 60, 97, 151, 200, 240)
PACK_KEYS = ("seg_records", "mins_lane", "cont_lane", "sc_codes_seg",
             "fwd9", "rev9", "seg_m")

@pytest.fixture(scope="module", params=[0, 1, 2])
def corpus(request):
    """Seeded verify.synthesize proteins of 26 to 240 residues (all 20
    residue codes, prolines among them) -> (FCZ entries, bb pack, metas,
    full pack, the full pack split into width classes, its gate off)."""
    if get_lib() is None:
        pytest.skip("the bb wire needs the native library")
    seed = request.param
    fczs = [encode(verify.synthesize(n, seed=100 * seed + i))
            for i, n in enumerate(LENGTHS)]
    assert any((f.records[:, 0] >> 3 == PRO).any() for f in fczs)
    arrays, metas = B.pack_decode_wire(fczs, True)
    full, full_metas = B.pack_decode_wire(fczs, False, wclass="0")
    split = H.split_lanes_classes(dict(full), full_metas, min_save=-100.0)
    assert split is not None and len(split[0]["classes"]["recs"]) >= 2
    return fczs, arrays, metas, full, split[0]


def _port_backbone(outs, metas):
    """N, CA and C of each protein from a ("bb", off, ca) output, as the
    port's gather dequantizes them (CA + off x 1e-4 A)."""
    tag, off, ca = outs
    assert tag == "bb"
    off, ca = off.numpy(), ca.numpy()
    segw = off.shape[1]
    got = []
    for m in metas:
        idx = m.lane_of * segw + m.rec_of
        o = off.reshape(-1, 6)[idx].astype(np.float32) * np.float32(1e-4)
        c = ca.reshape(-1, 3)[idx]
        got.append(np.stack([c + o[:, :3], c, c + o[:, 3:]], axis=1))
    return got


def test_bb_decode_matches_backbone_ref(corpus):
    """_seg_decode_arrays on arrays_to_torch's bb form: every atom of N, CA
    and C within TOL_PORT_A of backbone_ref; backbone_ref in bfloat16 is
    past it on every protein."""
    fczs, arrays, metas, _, _ = corpus
    ta = B.arrays_to_torch(arrays, "cpu")
    got = _port_backbone(B._seg_decode_arrays(ta), metas)
    for f, g in zip(fczs, got):
        blob = serialize(f)
        ref = backbone_ref.decode_backbone(blob).numpy()
        assert g.shape == ref.shape == (f.n_residue, 3, 3)
        assert np.abs(g - ref).max() <= TOL_PORT_A, f.n_residue
        ctrl = backbone_ref.decode_backbone(blob, torch.bfloat16)
        assert ctrl.dtype == torch.bfloat16
        assert np.abs(ctrl.float().numpy() - ref).max() > TOL_PORT_A


def test_backbone_ref_matches_frozen_decoder(corpus):
    """backbone_ref's N, CA and C against the frozen NumPy decoder's first
    three atoms of every residue."""
    for f in corpus[0]:
        blob = serialize(f)
        a14, _ = tasks.ref_slots(blob)
        got = backbone_ref.decode_backbone(blob).numpy()
        assert got.dtype == np.float32
        assert np.abs(got - a14[:, :3]).max() <= TOL_REF_A, f.n_residue


def test_bb_decode_bit_identical_with_sc_codes_held(corpus):
    """The bb decode reads nothing of the side-chain codes: the same
    output, bit for bit, from the dict with them held."""
    _, arrays, _, _, _ = corpus
    ta = B.arrays_to_torch(arrays, "cpu")
    lean = B._seg_decode_arrays(ta)
    held = dict(ta, sc_codes_seg=torch.from_numpy(arrays["sc_codes_seg"]))
    fat = B._seg_decode_arrays(held)
    assert lean[0] == fat[0] == "bb"
    for a, b in zip(lean[1:], fat[1:]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_arrays_to_torch_forms(corpus):
    """The bb form holds no side-chain codes and ships its bytes less
    theirs; the full and the classed forms hold every key as before."""
    _, arrays, _, full, split = corpus
    bb = B.arrays_to_torch(arrays, "cpu")
    assert bb["sc_codes_seg"] is None and bb["bb_wire"] is True
    shipped = {k for k, v in bb.items() if torch.is_tensor(v)}
    assert shipped == set(B._ARRAY_DTYPES) - {"sc_codes_seg"}
    for k in shipped:
        assert torch.equal(bb[k], torch.from_numpy(arrays[k]).to(
            B._ARRAY_DTYPES[k])), k
    assert B._host_bytes(arrays) == \
        B._host_bytes(full) - arrays["sc_codes_seg"].nbytes
    ft = B.arrays_to_torch(full, "cpu")
    assert ft["bb_wire"] is False
    assert {k for k, v in ft.items() if torch.is_tensor(v)} == \
        set(B._ARRAY_DTYPES)
    assert torch.equal(ft["sc_codes_seg"],
                       torch.from_numpy(full["sc_codes_seg"]))
    ct = B.arrays_to_torch(split, "cpu")
    assert set(ct) == {"classes", "prev_idx", "nl_outs"}
    assert set(ct["classes"]) == set(B._CLASS_DTYPES)
    for k in B._CLASS_DTYPES:
        assert all(torch.equal(t, torch.from_numpy(np.asarray(a)).to(
            B._CLASS_DTYPES[k])) for t, a in zip(ct["classes"][k],
                                                 split["classes"][k])), k


def test_plain_prep_bb_mode_is_full_mode_less_the_code_plane(corpus):
    """prep(..., wire="bb") on the CPU: class_prep and lane_order with no
    code plane and no side-chain codes taken (None), tat, mins6, cont6
    and the order equal to the full mode's; no launch."""
    ta = B.arrays_to_torch(corpus[3], "cpu")
    cls = tuple(ta[k] for k in PACK_KEYS)
    FD.reset_launch_counts()
    (want,) = FD.prep([cls])
    (got,) = FD.prep([cls[:3] + (None,) + cls[4:]], wire="bb")
    assert FD.launch_counts() == {"prep": 0, "prep_bb": 0, "k1": 0,
                                  "k2": 0, "k2_classes": 0, "k2_bb": 0,
                                  "k3": 0, "k3_staged": 0}
    assert "code" in want and "sct" in want
    assert set(got) == set(want) - {"code", "sct"}
    for k in ("recs", "fwd9", "rev9", "tat", "mins6", "cont6"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["order"].perm, want["order"].perm)
    with pytest.raises(ValueError):
        FD.prep([cls], wire="half")
    with pytest.raises(ValueError):
        FD.decode_seg_fused(*(cls[:3] + (None,) + cls[4:6]),
                            ta["is_first"], ta["seg_m"], wire="full")


def test_dispatch_and_prep_spans_carry_the_wire(corpus):
    """decode.dispatch and decode.prep carry `wire`: "bb" for a bb pack,
    "full" for a single-class and a classed full-wire pack; the session's
    launch counts hold prep_bb."""
    _, arrays, _, full, split = corpus
    forms = {"bb": B.arrays_to_torch(arrays, "cpu"),
             "full": B.arrays_to_torch(full, "cpu"),
             "classed": B.arrays_to_torch(split, "cpu")}
    for name, ta in forms.items():
        tracing.enable()
        try:
            B._seg_decode_arrays(ta)
        finally:
            tracing.disable()
        s = tracing.last()
        (d,) = s.named("decode.dispatch")
        (p,) = s.named("decode.prep")
        want = "bb" if name == "bb" else "full"
        assert d.attrs["wire"] == want and p.attrs == {"wire": want}, name
        assert p.parent == d.id
        assert s.launches["prep_bb"] == 0
    assert "prep_bb" in FD.launch_counts()
