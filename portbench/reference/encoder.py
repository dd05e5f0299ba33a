# Frozen copy of foldcomp_tpu_torch/codec/encoder.py:1-204 at commit 5ba08cd7580a
# (5ba08cd7580a295d1f8bab06ceee779a4da42958), imports made local to portbench/reference.
# Frozen so that the yardstick stays fixed while later changes edit the
# port: the benchmark judges the port against this copy, never against
# the port's own modules. It imports nothing of the port.
"""Exact (byte-compatible) FCZ encoder, host-side vectorized numpy.

Pipeline parity: Foldcomp::preprocess + compress (foldcomp.cpp:450-606).
The port's batched device encoder lives in foldcomp_tpu_torch.kernels; this
module is the reference-exact path used when byte-identical output matters.

The port's own copy of `foldcomp_tpu/codec/encoder.py:1`, kept line for line so
that both packages write the same bytes (tests/test_torch_standalone.py
holds the two to the same results).
"""
from __future__ import annotations

import numpy as np

from . import exact
from .aatable import AA_DATA
from .codes import (int_from_one_letter, one_letter_from_three)
from .structure import AtomArray
from .fcz import (DEFAULT_ANCHOR_THRESHOLD, FczData, NUM_BITS_BOND,
                  NUM_BITS_OMEGA, NUM_BITS_PHI_PSI, NUM_BITS_TEMP,
                  pack_records)

F32 = np.float32
BACKBONE = ("N", "CA", "C")


class EncodeError(ValueError):
    pass


def split_by_residue(atoms: AtomArray):
    """splitAtomByResidue parity (atom_coordinate.cpp:304-328).

    Groups consecutive atoms by residue_index; the final atom always joins the
    current group (reference quirk).
    """
    n = len(atoms)
    groups = []
    start = 0
    for i in range(1, n):
        if i == n - 1:
            break
        if atoms.residue_index[i] != atoms.residue_index[i - 1]:
            groups.append((start, i))
            start = i
    if n > 0:
        groups.append((start, n))
    return groups


def residue_name_vector(atoms: AtomArray):
    """getResidueNameVector parity (atom_coordinate.cpp:330-345)."""
    out = []
    for i in range(len(atoms)):
        if i == 0 or atoms.residue_index[i] != atoms.residue_index[i - 1]:
            out.append(atoms.residue_name[i])
    return out


def sidechain_torsions(atoms: AtomArray, groups, residue_names):
    """calculateSideChainTorsionAnglesPerResidue parity (sidechain.cpp:149-180).

    For each residue, the dihedral over the AA-specific previous-3-atom graph of
    every side-chain atom (table order: O, CB, CG, ...). Missing atoms
    contribute (0,0,0), exactly like findFirstAtomCoords (sidechain.cpp:140-147).
    Returns a flat f32 array in stream order.
    """
    flat = []
    for (start, end), rname in zip(groups, residue_names):
        if rname not in AA_DATA:
            raise EncodeError(f"unknown residue name: {rname}")
        atoms_tbl, graph, _, _, _ = AA_DATA[rname]
        # name -> first coords within the residue
        coord_of = {}
        for i in range(start, end):
            nm = atoms.atom_name[i]
            if nm not in coord_of:
                coord_of[nm] = atoms.coords[i]
        zero = np.zeros(3, F32)
        quads = []
        for atom in atoms_tbl[3:]:
            p0, p1, p2 = graph[atom]
            quads.append((coord_of.get(p0, zero), coord_of.get(p1, zero),
                          coord_of.get(p2, zero), coord_of.get(atom, zero)))
        if quads:
            q = np.asarray(quads, dtype=F32)  # [k, 4, 3]
            flat.append(exact.dihedral(q[:, 0], q[:, 1], q[:, 2], q[:, 3]))
    if not flat:
        return np.zeros(0, F32)
    return np.concatenate(flat).astype(F32)


def encode(atoms: AtomArray, anchor_threshold: int = DEFAULT_ANCHOR_THRESHOLD,
           title: str | None = None) -> FczData:
    """Compress one continuous single-chain fragment to FCZ fields."""
    n = len(atoms)
    if n == 0:
        raise EncodeError("empty fragment")

    bb_idx = [i for i in range(n) if atoms.atom_name[i] in BACKBONE]
    n_res = len(bb_idx) // 3
    if n_res < 2:
        raise EncodeError("fragment must contain at least 2 residues")
    flat_bb = atoms.coords[np.asarray(bb_idx[:3 * n_res], np.int64)].astype(F32)

    idx_residue = int(atoms.residue_index[0])
    idx_atom = int(atoms.atom_index[0])
    chain = atoms.chain[0][:1] if atoms.chain[0] else "\x00"
    first_res = one_letter_from_three(atoms.residue_name[0])
    last_res = one_letter_from_three(atoms.residue_name[-1])
    if title is None:
        title = atoms.title

    # Anchors (_setAnchor, foldcomp.cpp:745-761)
    if anchor_threshold < 1:
        raise EncodeError("anchor threshold must be >= 1")
    n_inner = n_res // anchor_threshold
    n_all = n_inner + 2
    if n_all > 255:
        # nAnchor is a uint8 header field; a silently wrapped count would
        # produce a self-inconsistent stream
        raise EncodeError(
            f"chain too long for anchor threshold {anchor_threshold}: "
            f"{n_all} anchors exceeds the format's 255-anchor limit")
    interval = n_res // (n_all - 1)
    anchor_indices = np.asarray(
        [i * interval for i in range(n_all - 1)] + [n_res - 1], np.int32)
    anchor_coords = np.zeros((n_all, 3, 3), F32)
    for ai, aidx in enumerate(anchor_indices):
        target = int(aidx) + idx_residue
        got = {}
        for i in range(n):
            if int(atoms.residue_index[i]) == target and \
                    atoms.atom_name[i] in BACKBONE and atoms.atom_name[i] not in got:
                got[atoms.atom_name[i]] = atoms.coords[i]
        for k, nm in enumerate(BACKBONE):
            if nm in got:
                anchor_coords[ai, k] = got[nm]

    has_oxt = atoms.atom_name[-1] == "OXT"
    oxt_coords = atoms.coords[-1].astype(F32) if has_oxt else np.zeros(3, F32)

    # Backbone torsions / bond angles (foldcomp.cpp:484-505)
    tors = exact.backbone_torsions(flat_bb)       # [3*n_res - 3]
    psi = tors[0::3]
    omega = tors[1::3]
    phi = tors[2::3]
    angs = exact.backbone_bond_angles(flat_bb)    # [3*n_res - 2]
    ca_c_n = angs[1::3]
    c_n_ca = angs[2::3]
    n_ca_c = angs[3::3]

    # Quantize backbone (foldcomp.cpp:508-519)
    phi_d = exact.Discretizer(phi, 2 ** NUM_BITS_PHI_PSI - 1)
    psi_d = exact.Discretizer(psi, 2 ** NUM_BITS_PHI_PSI - 1)
    omega_d = exact.Discretizer(omega, 2 ** NUM_BITS_OMEGA - 1)
    ncac_d = exact.Discretizer(n_ca_c, 2 ** NUM_BITS_BOND - 1)
    cacn_d = exact.Discretizer(ca_c_n, 2 ** NUM_BITS_BOND - 1)
    cnca_d = exact.Discretizer(c_n_ca, 2 ** NUM_BITS_BOND - 1)

    # Side chains: fixed [-180, 180] 255-bin truncating quantizer
    # (foldcomp.cpp:532-538)
    groups = split_by_residue(atoms)
    residue_names = residue_name_vector(atoms)
    sc_angles = sidechain_torsions(atoms, groups, residue_names)
    fixed = exact.FixedAngleDiscretizer(2 ** NUM_BITS_TEMP - 1)
    sc_codes = fixed.discretize_trunc(sc_angles).astype(np.uint8)

    # tempFactors: CA per residue (foldcomp.cpp:543-550)
    tf = np.asarray([atoms.temp_factor[i] for i in range(n)
                     if atoms.atom_name[i] == "CA"], F32)
    tf_d = exact.Discretizer(tf, 2 ** NUM_BITS_TEMP - 1)
    tf_codes = tf_d.discretize(tf).astype(np.uint8)

    # Residue codes from the N atom of each backbone residue (foldcomp.cpp:582-601)
    res_codes = np.asarray(
        [int_from_one_letter(one_letter_from_three(
            atoms.residue_name[bb_idx[i * 3]])) for i in range(n_res)], np.uint32)

    zeros = np.zeros(1, np.uint32)
    records = pack_records(
        res_codes,
        np.concatenate([phi_d.discretize(phi), zeros]),
        np.concatenate([psi_d.discretize(psi), zeros]),
        np.concatenate([omega_d.discretize(omega), zeros]),
        np.concatenate([ncac_d.discretize(n_ca_c), zeros]),
        np.concatenate([cacn_d.discretize(ca_c_n), zeros]),
        np.concatenate([cnca_d.discretize(c_n_ca), zeros]),
    )

    mins = np.asarray([phi_d.min, psi_d.min, omega_d.min,
                       ncac_d.min, cacn_d.min, cnca_d.min], F32)
    cont_fs = np.asarray([phi_d.cont_f, psi_d.cont_f, omega_d.cont_f,
                          ncac_d.cont_f, cacn_d.cont_f, cnca_d.cont_f], F32)

    return FczData(
        n_residue=n_res, n_atom=n, idx_residue=idx_residue, idx_atom=idx_atom,
        n_anchor=n_all, chain=chain, n_sc_torsion=len(sc_codes),
        first_residue=first_res, last_residue=last_res, title=title,
        mins=mins, cont_fs=cont_fs, anchor_indices=anchor_indices,
        anchor_coords=anchor_coords, has_oxt=has_oxt, oxt_coords=oxt_coords,
        records=records, sc_codes=sc_codes,
        tf_min=tf_d.min, tf_cont=tf_d.cont_f, tf_codes=tf_codes,
    )
