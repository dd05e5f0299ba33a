"""On-device output verification of the port's decode and encode paths.

Port of foldcomp_tpu/verify.py device_parity_check, at the same
thresholds. Decode (:81-164), against the byte-exact host decoder
(codec/decoder.decode):

- with the reference fixtures (FOLDCOMP_REF_TEST holding test.pdb and
  test_af.pdb): every protein within 5 mA of the exact decoder, and the
  all-atom RMSD of test.pdb against the original inside the reference
  gate 0.0826751 +- 1.5e-3 (build.sh:34-38);
- without them: the synthetic corpus of bench.py's 8 lengths (seed =
  length), where even the JAX reference sits up to tens of mA off the
  exact decoder; each protein must be no farther than the JAX fused
  path's committed deviation (tests/data/torch_port_ref_dev.json,
  computed in interpret mode on CPU) + 1e-3 A.

Encode (:218-248): the serialized FCZ bytes of the port's batched
encode must be identical to codec/encoder.encode's, through each route of
codec/batch.py encode_submit: the native plane-major wire, the numpy wire
(native_wire=False) and the f32 form, which frames off the
millimetre grid reach by themselves. The corpus is the fixtures, or the
synthetic proteins put on the millimetre grid for the two compact routes.

Both run through the production glue (codec/batch.py), so on a CUDA
device they go through the CUDA kernels. Each check that ran is named
under `checked`.
"""
from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

from foldcomp_tpu.core.aatable import N_ATOMS
from foldcomp_tpu.core.codes import NUM_AA
from foldcomp_tpu.verify import (_DEV_TOL_A, _RMSD_GOLD, _RMSD_TOL,
                                 _load_fragments)

REPO = pathlib.Path(__file__).resolve().parents[1]
REF_DEV_PATH = REPO / "tests" / "data" / "torch_port_ref_dev.json"
REF_DEV_SLACK_A = 1e-3


def protein_atoms(a14, res_code):
    """[n, 14, 3] slots -> the protein's atoms in table order (the atoms
    the assembly emits: N_ATOMS for standard codes, N/CA/C otherwise)."""
    codes = np.asarray(res_code)
    std = codes < NUM_AA
    cnt = np.where(std, N_ATOMS[np.where(std, codes, 0)], 3)
    return a14[np.arange(a14.shape[1])[None, :] < cnt[:, None]]


def max_deviation(a14, res_code, exact_coords) -> float:
    """Max |coordinate difference| (A) against the exact decoder's atoms
    (its trailing OXT is not in the slot array and is left out)."""
    got = protein_atoms(a14, res_code)
    n = min(len(got), len(exact_coords))
    return float(np.abs(got[:n] - exact_coords[:n]).max())


def synthetic_structures(lengths):
    """{length: AtomArray} of synthesize(length, seed=length)
    (tests/test_property_roundtrip.py), as bench.py builds its mixed
    corpus."""
    tests = str(REPO / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from test_property_roundtrip import synthesize
    return {n: synthesize(n, seed=n) for n in lengths}


def synthetic_corpus(lengths):
    """{length: FczData} of synthetic_structures, default anchor
    interval."""
    from foldcomp_tpu.codec.encoder import encode
    return {n: encode(a) for n, a in synthetic_structures(lengths).items()}


def on_milli_grid(atoms):
    """A copy of `atoms` with every coordinate rounded to a whole number
    of milli-angstroms, as every 3-decimal PDB or mmCIF coordinate is:
    the form the compact encode wire carries."""
    out = atoms.take(np.arange(len(atoms)))
    c = np.asarray(out.coords, np.float32)
    out.coords[:] = (np.rint(c * 1000.0).astype(np.int32)
                     .astype(np.float32) / np.float32(1000.0))
    return out


def encode_routes(frames, device):
    """{route: [(i, frame, FczData)]}: the port's batched encode through
    each encode_submit route, "native" (when the native library is
    present) and "numpy" on every frame put on the millimetre grid, "f32"
    on the frames off it, as they are. Raises if a batch took another
    route than the one asked for."""
    from foldcomp_tpu.codec.batch import fragment_to_tensors
    from foldcomp_tpu.native import get_lib

    from .codec.batch import encode_finish, encode_submit

    def run(idx, fr, want, native_wire):
        tensors = [fragment_to_tensors(a) for a in fr]
        h = encode_submit([t[:3] for t in tensors], [t[3] for t in tensors],
                          device=device, native_wire=native_wire)
        if h["wire"] != want:
            raise RuntimeError(f"encode took the {h['wire']} route, "
                               f"expected {want}")
        return list(zip(idx, fr, encode_finish(h)))

    grid = [on_milli_grid(a) for a in frames]
    every = list(range(len(frames)))
    out = {}
    if get_lib() is not None:
        out["native"] = run(every, grid, "native", True)
    out["numpy"] = run(every, grid, "numpy", False)
    off = [i for i in every
           if not np.array_equal(grid[i].coords, frames[i].coords)]
    if off:
        out["f32"] = run(off, [frames[i] for i in off], "f32", True)
    return out


def load_ref_dev() -> dict:
    """{length: JAX fused-path max deviation (A)} from the committed
    file."""
    with open(REF_DEV_PATH) as fh:
        d = json.load(fh)
    return {int(k): float(v) for k, v in d["max_dev_A"].items()}


def device_parity_check(device=None) -> dict:
    """Verify the port's decode output on `device` (default: the card).

    Returns a dict with parity_ok, the checked corpus and per-protein
    detail; parity_ok is True only if every protein holds its gate."""
    from foldcomp_tpu.codec.batch import _gather_a14
    from foldcomp_tpu.codec.decoder import decode as decode_exact
    from foldcomp_tpu.codec.encoder import encode as encode_exact
    from foldcomp_tpu.codec.fcz import serialize
    from foldcomp_tpu.core.exact import rmsd

    from .backend import resolve_device
    from .codec.batch import decode_fcz_host

    dev = resolve_device(device)
    out = {"device": str(dev), "failures": [], "checked": []}
    frags = _load_fragments()
    if frags:
        names = [n for n, _ in frags]
        structures = [f for _, f in frags]
        fczs = [encode_exact(f) for f in structures]
        gates = [_DEV_TOL_A] * len(fczs)
        out["corpus"] = "fixtures"
    else:
        ref = load_ref_dev()
        structures = list(synthetic_structures(sorted(ref)).values())
        names = [f"synthetic_{n}" for n in sorted(ref)]
        fczs = [encode_exact(a) for a in structures]
        gates = [ref[n] + REF_DEV_SLACK_A for n in sorted(ref)]
        out["corpus"] = "synthetic"
    # a repeat exercises lane reuse across proteins
    fczs_b = fczs + [fczs[0]]
    outs, metas = decode_fcz_host(fczs_b, device=dev)
    exact = [np.asarray(decode_exact(f).coords) for f in fczs]
    per = {}
    for i, m in enumerate(metas):
        j = i % len(fczs)
        a14 = _gather_a14(outs, m)
        d = max_deviation(a14, m.res_code, exact[j])
        per[names[j]] = max(per.get(names[j], 0.0), d)
        if not d <= gates[j]:
            out["failures"].append(
                f"{names[j]}: dev {d:.6f} A > gate {gates[j]:.6f} A")
        if i == 0 and names[0] == "test.pdb":
            got = protein_atoms(a14, m.res_code)
            orig = np.asarray(frags[0][1].coords)
            n = min(len(got), len(orig))
            r = float(rmsd(got[:n], orig[:n]))
            out["rmsd_test_pdb"] = r
            if not abs(r - _RMSD_GOLD) < _RMSD_TOL:
                out["failures"].append(f"test.pdb: rmsd {r:.6f}")
    out["max_dev_A"] = per
    out["gate_A"] = dict(zip(names, gates))
    out["checked"].append("decode")

    # encode: each route byte-identical to the exact encoder
    for route, got in encode_routes(structures, dev).items():
        label = "encode_" + route
        out["checked"].append(label)
        bad = [names[i] for i, a, g in got
               if g is None or serialize(g) != serialize(encode_exact(a))]
        if bad:
            out["failures"].append(f"{label}: byte mismatch on {bad}")
    out["parity_ok"] = not out["failures"]
    return out
