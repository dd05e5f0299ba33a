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

The gates, the fixture loader and the synthetic structures are the port's
own copies: `DEV_TOL_A`, `_RMSD_GOLD`, `_RMSD_TOL` and `_load_fragments`
(with `load_fragment`) of foldcomp_tpu/verify.py:31-50, and `synthesize` of
tests/test_property_roundtrip.py:21. The fixtures are read from the
directory FOLDCOMP_REF_TEST names, when it is set.
"""
from __future__ import annotations

import json
import os
import pathlib

import numpy as np

from .codec.decoder import place_atom
from .core.aatable import (AA_DATA, C_TO_N_DIST, CA_TO_C_DIST, N_ATOMS,
                           N_TO_CA_DIST, PRO_N_TO_CA_DIST)
from .core.codes import NUM_AA, THREE_LETTER
from .io.structure import AtomArray

REPO = pathlib.Path(__file__).resolve().parents[1]
REF_DEV_PATH = REPO / "tests" / "data" / "torch_port_ref_dev.json"
REF_DEV_SLACK_A = 1e-3

# build.sh:35-36 golden: all-atom RMSD of the test.pdb roundtrip
_RMSD_GOLD = 0.0826751
_RMSD_TOL = 1.5e-3
DEV_TOL_A = 5e-3        # vs exact decoder: compact wire quantum + ulps


def load_fragment(path) -> AtomArray:
    """The one fragment of a single-chain PDB file."""
    from .io.pdb import parse_pdb
    from .io.structure import (identify_chains,
                               identify_discontinuous_fragments,
                               remove_alternative_positions)
    atoms = remove_alternative_positions(
        parse_pdb(pathlib.Path(path).read_bytes()))
    (cs, ce), = identify_chains(atoms)
    (fs, fe), = identify_discontinuous_fragments(atoms, cs, ce)
    return atoms.slice(fs, fe)


def _load_fragments():
    """[(name, AtomArray)] of test.pdb and test_af.pdb's one fragment each,
    from FOLDCOMP_REF_TEST; empty when it is unset or holds neither."""
    root = os.environ.get("FOLDCOMP_REF_TEST")
    return [(name, load_fragment(pathlib.Path(root) / name))
            for name in (("test.pdb", "test_af.pdb") if root else ())
            if (pathlib.Path(root) / name).exists()]


def synthesize(n_res: int, seed: int) -> AtomArray:
    """Random single-chain all-atom protein with realistic geometry, built
    with the NeRF recurrence from seeded torsions and bond angles."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 20, n_res)   # all 20, proline included
    phi = rng.uniform(-160, -40, n_res)
    psi = rng.uniform(-60, 170, n_res)
    omega = rng.normal(179.0, 2.0, n_res)
    n_ca_c = rng.normal(111.0, 2.0, n_res)
    ca_c_n = rng.normal(116.5, 1.5, n_res)
    c_n_ca = rng.normal(121.5, 1.5, n_res)

    bb = [(0.0, 0.0, 0.0), (N_TO_CA_DIST, 0.0, 0.0)]
    # place first C with an arbitrary reasonable angle
    bb.append(place_atom((-1.0, 1.0, 0.0), bb[0], bb[1], CA_TO_C_DIST,
                         111.0, -60.0))
    for i in range(n_res - 1):
        a, b, c = bb[-3], bb[-2], bb[-1]
        # residue i+1's N-CA bond: proline is shorter (nerf.h:37-43)
        n_ca = PRO_N_TO_CA_DIST if codes[i + 1] == 14 else N_TO_CA_DIST
        n_xyz = place_atom(a, b, c, C_TO_N_DIST, ca_c_n[i], psi[i])
        ca_xyz = place_atom(b, c, n_xyz, n_ca, c_n_ca[i], omega[i])
        c_xyz = place_atom(c, n_xyz, ca_xyz, CA_TO_C_DIST, n_ca_c[i],
                           phi[i])
        bb.extend([n_xyz, ca_xyz, c_xyz])

    names, rnames, chains, ridx, coords, temps = [], [], [], [], [], []
    for r in range(n_res):
        three = THREE_LETTER[int(codes[r])]
        atoms_tbl, graph, lengths, angles, _ = AA_DATA[three]
        slot = {"N": bb[3 * r], "CA": bb[3 * r + 1], "C": bb[3 * r + 2]}
        for k, nm in enumerate(atoms_tbl):
            if k >= 3:
                p0, p1, p2 = graph[nm]
                slot[nm] = place_atom(
                    slot[p0], slot[p1], slot[p2],
                    lengths[f"{p2}_{nm}"], angles[f"{p1}_{p2}_{nm}"],
                    float(rng.uniform(-180, 180)))
            names.append(nm)
            rnames.append(three)
            chains.append("A")
            ridx.append(r + 1)
            coords.append(slot[nm])
            temps.append(float(rng.uniform(20, 95)))
    n_total = len(names)
    return AtomArray(names, rnames, chains,
                     np.arange(1, n_total + 1, dtype=np.int32),
                     np.asarray(ridx, np.int32),
                     np.asarray(coords, np.float32),
                     np.ones(n_total, np.float32),
                     np.asarray(temps, np.float32), "synthetic")


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
    """{length: AtomArray} of synthesize(length, seed=length), as bench.py
    builds its mixed corpus."""
    return {n: synthesize(n, seed=n) for n in lengths}


def synthetic_corpus(lengths):
    """{length: FczData} of synthetic_structures, default anchor
    interval."""
    from .codec.encoder import encode
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
    from .codec.batch import encode_finish, encode_submit
    from .codec.batch_host import fragment_to_tensors
    from .native import get_lib

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
    from .backend import resolve_device
    from .codec.batch import decode_fcz_host
    from .codec.batch_host import _gather_a14
    from .codec.decoder import decode as decode_exact
    from .codec.encoder import encode as encode_exact
    from .codec.fcz import serialize
    from .core.exact import rmsd

    dev = resolve_device(device)
    out = {"device": str(dev), "failures": [], "checked": []}
    frags = _load_fragments()
    if frags:
        names = [n for n, _ in frags]
        structures = [f for _, f in frags]
        fczs = [encode_exact(f) for f in structures]
        gates = [DEV_TOL_A] * len(fczs)
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
