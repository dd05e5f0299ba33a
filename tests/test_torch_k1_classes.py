"""k1 over every width class of a batch in one launch
(foldcomp_tpu_torch/kernels/fused_decode.py tails_classes) against the
JAX package, on CPU.

The launch takes a table of the classes: each class a range of blocks,
the widest SEG first, and its columns of the shared [9, NL_total] tails
buffer, by the one class layout (class_layout, which
tests/test_torch_class_layout.py holds to the kernel's rule: every lane
of every class taken by exactly one thread and written at its own
column). The CUDA kernel runs only on the
card (chip_smoke.py phase 14 holds it bit-equal to tails_plain of each
class there); on the CPU tails_classes runs tails_plain class by class,
launches nothing, and is held to JAX `_run_tails` in Pallas interpret
mode, class by class, concatenated, within 1e-3 A (the tolerance of
test_torch_decode_kernels.py test_k1_tails_plain_matches_jax: torch's and
XLA's CPU sin/cos differ by ulps along the NeRF chain).
"""
import numpy as np
import pytest
import torch

from test_property_roundtrip import synthesize

from foldcomp_tpu.codec.encoder import encode
from foldcomp_tpu.kernels import pallas_decode as P
from foldcomp_tpu_torch.codec import batch as B
from foldcomp_tpu_torch.codec import batch_host as H
from foldcomp_tpu_torch.kernels import fused_decode as FD

TOL_A = 1e-3
# the test_wclass.py mixed corpus: a protein's lanes land in several
# classes
MIXED = (26, 60, 151, 240, 60)


@pytest.fixture(scope="module")
def classed():
    fczs = [encode(synthesize(n, seed=i)) for i, n in enumerate(MIXED)]
    arrays, metas = H.pack_decode_batch_lanes(fczs)
    split = H.split_lanes_classes(dict(arrays), metas, min_save=-100.0)
    assert split is not None and len(split[0]["classes"]["recs"]) >= 2
    return split[0]


def _jax_tails(a):
    """JAX _run_tails (interpret mode) of each class, its lanes' columns,
    concatenated: the tails the classed decode gathers its seeds
    from (pallas_decode.py:654-656)."""
    c = a["classes"]
    out = []
    for i in range(len(c["recs"])):
        nl = c["recs"][i].shape[2]
        pr = P._class_prep(c["recs"][i], c["mins"][i], c["cont"][i],
                           c["sct"][i], c["fwd"][i], c["rev"][i],
                           c["segm"][i],
                           g=P._G_BB if nl % P._LANE_PAD == 0 else 4)
        out.append(np.array(P._run_tails(pr, True))[:, :nl])
    return np.concatenate(out, axis=1)


def test_tails_classes_cpu_matches_jax(classed):
    """tails_classes on the CPU: the plain versions, no launch, each class
    at its columns, within TOL_A of JAX's tails class by class."""
    ta = B.arrays_to_torch(classed, "cpu")
    c = ta["classes"]
    prs = [FD.class_prep(c["recs"][i], c["mins"][i], c["cont"][i],
                         c["sct"][i], c["fwd"][i], c["rev"][i], c["segm"][i])
           for i in range(len(c["recs"]))]
    nl_total = sum(p["recs"].shape[2] for p in prs)
    FD.reset_launch_counts()
    got = FD.tails_classes(
        [(p["recs"], p["fwd9"], p["rev9"], p["tat"], p["mins6"], p["cont6"],
          None) for p in prs],
        torch.full((9, nl_total), float("nan")))
    assert FD.launch_counts()["k1"] == 0
    want = _jax_tails(classed)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL_A
    # and bit for bit the single-class wrapper, class by class
    base = 0
    for p in prs:
        nl = p["recs"].shape[2]
        one = FD.tails(p["recs"], p["fwd9"], p["rev9"], p["tat"], p["mins6"],
                       p["cont6"])
        assert torch.equal(got[:, base:base + nl], one)
        base += nl


def test_tails_classes_checks_out(classed):
    ta = B.arrays_to_torch(classed, "cpu")
    c = ta["classes"]
    p = FD.class_prep(c["recs"][0], c["mins"][0], c["cont"][0], c["sct"][0],
                      c["fwd"][0], c["rev"][0], c["segm"][0])
    cls = [(p["recs"], p["fwd9"], p["rev9"], p["tat"], p["mins6"],
            p["cont6"], None)]
    nl = p["recs"].shape[2]
    with pytest.raises(ValueError):
        FD.tails_classes(cls, torch.empty((9, nl + 1)))
    with pytest.raises(ValueError):
        FD.tails_classes(cls, torch.empty((9, nl), dtype=torch.float64))
    with pytest.raises(ValueError):
        FD.tails_classes(cls, torch.empty((9, nl), device="meta"))
