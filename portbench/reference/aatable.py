# Frozen copy of foldcomp_tpu_torch/core/aatable.py:1-287 at commit 5ba08cd7580a
# (5ba08cd7580a295d1f8bab06ceee779a4da42958), imports made local to portbench/reference.
# Frozen so that the yardstick stays fixed while later changes edit the
# port: the benchmark judges the port against this copy, never against
# the port's own modules. It imports nothing of the port.
"""Amino-acid geometry as dense arrays (TPU-friendly layout).

The reference keeps this chemistry as string-keyed maps (src/amino_acid.h:69-406):
per-AA atom order, a per-atom "previous 3 atoms" dependency graph, and ideal bond
lengths/angles (PeptideBuilder constants). Here the same chemistry is flattened
into dense [NUM_AA, MAX_ATOM] index/float tensors so side-chain torsion extraction
and reconstruction become gathers + masked scans instead of per-residue map walks.

Layouts
-------
atom14: every residue's atoms live in a fixed [MAX_ATOM=14] slot array in the
reference's table order (N, CA, C, O, CB, ...). Slot k >= 3 of amino acid `a` is
placed from the three predecessor slots PRED_IDX[a, k, 0:3] with ideal bond length
BOND_LEN[a, k], ideal bond angle BOND_ANG[a, k] and a stored torsion angle.
Side-chain torsion j of a residue corresponds to atom slot 3 + j.

The port's own copy of `foldcomp_tpu/core/aatable.py:1`, kept line for line so
that both packages write the same bytes (tests/test_torch_standalone.py
holds the two to the same results).
"""
from __future__ import annotations

import numpy as np

from .codes import NUM_AA, THREE_LETTER

MAX_ATOM = 14          # TRP has 14 heavy atoms
MAX_SC_TORSION = 11    # = MAX_ATOM - 3 (TRP)

# (atoms in table order,
#  {atom: (prev0, prev1, prev2)} dependency graph,
#  {<prev2>_<atom>: bond length}, {<prev1>_<prev2>_<atom>: bond angle},
#  alt atom order)
# Chemistry constants follow PeptideBuilder as used by the reference
# (amino_acid.h:71-404).
AA_DATA = {
    "ALA": (
        ["N", "CA", "C", "O", "CB"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA")},
        {"CA_CB": 1.52, "C_O": 1.23},
        {"CA_C_O": 120.31, "C_CA_CB": 110.852},
        ["N", "CA", "C", "CB", "O"],
    ),
    "ARG": (
        ["N", "CA", "C", "O", "CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG": ("N", "CA", "CB"),
         "CD": ("CA", "CB", "CG"), "NE": ("CB", "CG", "CD"), "CZ": ("CG", "CD", "NE"),
         "NH1": ("CD", "NE", "CZ"), "NH2": ("CD", "NE", "CZ")},
        {"CA_CB": 1.53, "C_O": 1.23, "CB_CG": 1.53, "CG_CD": 1.52, "CD_NE": 1.46,
         "NE_CZ": 1.32, "CZ_NH1": 1.31, "CZ_NH2": 1.31},
        {"CA_C_O": 119.745, "C_CA_CB": 110.579, "CA_CB_CG": 113.233,
         "CB_CG_CD": 110.787, "CG_CD_NE": 111.919, "CD_NE_CZ": 125.192,
         "NE_CZ_NH1": 120.077, "NE_CZ_NH2": 120.077},
        ["N", "CA", "C", "CB", "O", "CG", "CD", "NE", "NH1", "NH2", "CZ"],
    ),
    "ASN": (
        ["N", "CA", "C", "O", "CB", "CG", "OD1", "ND2"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG": ("N", "CA", "CB"),
         "OD1": ("CA", "CB", "CG"), "ND2": ("CA", "CB", "CG")},
        {"CA_CB": 1.52, "C_O": 1.23, "CB_CG": 1.52, "CG_OD1": 1.23, "CG_ND2": 1.325},
        {"CA_C_O": 120.313, "C_CA_CB": 110.852, "CA_CB_CG": 113.232,
         "CB_CG_OD1": 120.85, "CB_CG_ND2": 116.48},
        ["N", "CA", "C", "CB", "O", "CG", "ND2", "OD1"],
    ),
    "ASP": (
        ["N", "CA", "C", "O", "CB", "CG", "OD1", "OD2"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG": ("N", "CA", "CB"),
         "OD1": ("CA", "CB", "CG"), "OD2": ("CA", "CB", "CG")},
        {"CA_CB": 1.53, "C_O": 1.23, "CB_CG": 1.52, "CG_OD1": 1.248, "CG_OD2": 1.248},
        {"CA_C_O": 121.051, "C_CA_CB": 110.871, "CA_CB_CG": 113.232,
         "CB_CG_OD1": 118.344, "CB_CG_OD2": 118.344},
        ["N", "CA", "C", "CB", "O", "CG", "OD1", "OD2"],
    ),
    "CYS": (
        ["N", "CA", "C", "O", "CB", "SG"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "SG": ("N", "CA", "CB")},
        {"CA_CB": 1.53, "C_O": 1.23, "CB_SG": 1.8},
        {"CA_C_O": 120.063, "C_CA_CB": 111.078, "CA_CB_SG": 113.817},
        ["N", "CA", "C", "CB", "O", "SG"],
    ),
    "GLN": (
        ["N", "CA", "C", "O", "CB", "CG", "CD", "OE1", "NE2"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG": ("N", "CA", "CB"),
         "CD": ("CA", "CB", "CG"), "OE1": ("CB", "CG", "CD"), "NE2": ("CB", "CG", "CD")},
        {"CA_CB": 1.53, "C_O": 1.23, "CB_CG": 1.52, "CG_CD": 1.52,
         "CD_OE1": 1.23, "CD_NE2": 1.32},
        {"CA_C_O": 120.211, "C_CA_CB": 109.5, "CA_CB_CG": 113.292,
         "CB_CG_CD": 112.811, "CG_CD_OE1": 121.844, "CG_CD_NE2": 116.50},
        ["N", "CA", "C", "CB", "O", "CG", "CD", "NE2", "OE1"],
    ),
    "GLU": (
        ["N", "CA", "C", "O", "CB", "CG", "CD", "OE1", "OE2"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG": ("N", "CA", "CB"),
         "CD": ("CA", "CB", "CG"), "OE1": ("CB", "CG", "CD"), "OE2": ("CB", "CG", "CD")},
        {"CA_CB": 1.53, "C_O": 1.23, "CB_CG": 1.52, "CG_CD": 1.52,
         "CD_OE1": 1.25, "CD_OE2": 1.25},
        {"CA_C_O": 120.594, "C_CA_CB": 110.538, "CA_CB_CG": 113.82,
         "CB_CG_CD": 112.912, "CG_CD_OE1": 118.479, "CG_CD_OE2": 118.479},
        ["N", "CA", "C", "CB", "O", "CG", "CD", "OE1", "OE2"],
    ),
    "GLY": (
        ["N", "CA", "C", "O"],
        {"O": ("N", "CA", "C")},
        {"C_O": 1.23},
        {"CA_C_O": 120.522},
        ["N", "CA", "C", "O"],
    ),
    "HIS": (
        ["N", "CA", "C", "O", "CB", "CG", "ND1", "CD2", "CE1", "NE2"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG": ("N", "CA", "CB"),
         "ND1": ("CA", "CB", "CG"), "CD2": ("CA", "CB", "CG"),
         "CE1": ("CB", "CG", "ND1"), "NE2": ("CB", "CG", "CD2")},
        {"CA_CB": 1.53, "C_O": 1.23, "CB_CG": 1.5, "CG_ND1": 1.38,
         "CG_CD2": 1.36, "ND1_CE1": 1.33, "CD2_NE2": 1.38},
        {"CA_C_O": 120.548, "C_CA_CB": 111.329, "CA_CB_CG": 113.468,
         "CB_CG_CD2": 130.61, "CB_CG_ND1": 122.85, "CG_CD2_NE2": 107.439,
         "CG_ND1_CE1": 108.589},
        ["N", "CA", "C", "CB", "O", "CG", "CD2", "ND1", "CE1", "NE2"],
    ),
    "ILE": (
        ["N", "CA", "C", "O", "CB", "CG1", "CG2", "CD1"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG1": ("N", "CA", "CB"),
         "CG2": ("N", "CA", "CB"), "CD1": ("CA", "CB", "CG1")},
        {"CA_CB": 1.54, "C_O": 1.235, "CB_CG1": 1.53, "CB_CG2": 1.52, "CG1_CD1": 1.51},
        {"CA_C_O": 120.393, "C_CA_CB": 111.983, "CA_CB_CG1": 110.5,
         "CA_CB_CG2": 110.5, "CB_CG1_CD1": 113.97},
        ["N", "CA", "C", "CB", "O", "CG1", "CG2", "CD1"],
    ),
    "LEU": (
        ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG": ("N", "CA", "CB"),
         "CD1": ("CA", "CB", "CG"), "CD2": ("CA", "CB", "CG")},
        {"CA_CB": 1.53, "C_O": 1.235, "CB_CG": 1.53, "CG_CD1": 1.52, "CG_CD2": 1.52},
        {"CA_C_O": 120.211, "C_CA_CB": 110.418, "CA_CB_CG": 116.10,
         "CB_CG_CD1": 110.58, "CB_CG_CD2": 110.58},
        ["N", "CA", "C", "CB", "O", "CG", "CD1", "CD2"],
    ),
    "LYS": (
        ["N", "CA", "C", "O", "CB", "CG", "CD", "CE", "NZ"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG": ("N", "CA", "CB"),
         "CD": ("CA", "CB", "CG"), "CE": ("CB", "CG", "CD"), "NZ": ("CG", "CD", "CE")},
        {"C_O": 1.23, "CA_CB": 1.53, "CB_CG": 1.52, "CG_CD": 1.52,
         "CD_CE": 1.52, "CE_NZ": 1.49},
        {"CA_C_O": 120.54, "C_CA_CB": 109.5, "CA_CB_CG": 113.83,
         "CB_CG_CD": 111.79, "CG_CD_CE": 111.79, "CD_CE_NZ": 112.25},
        ["N", "CA", "C", "CB", "O", "CG", "CD", "CE", "NZ"],
    ),
    "MET": (
        ["N", "CA", "C", "O", "CB", "CG", "SD", "CE"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG": ("N", "CA", "CB"),
         "SD": ("CA", "CB", "CG"), "CE": ("CB", "CG", "SD")},
        {"CA_CB": 1.53, "C_O": 1.23, "CB_CG": 1.52, "CG_SD": 1.8, "SD_CE": 1.79},
        {"CA_C_O": 120.148, "C_CA_CB": 110.833, "CA_CB_CG": 113.68,
         "CB_CG_SD": 112.773, "CG_SD_CE": 100.61},
        ["N", "CA", "C", "CB", "O", "CG", "SD", "CE"],
    ),
    "PHE": (
        ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG": ("N", "CA", "CB"),
         "CD1": ("CA", "CB", "CG"), "CD2": ("CA", "CB", "CG"),
         "CE1": ("CB", "CG", "CD1"), "CE2": ("CB", "CG", "CD2"),
         "CZ": ("CG", "CD1", "CE1")},
        {"CA_CB": 1.53, "C_O": 1.23, "CB_CG": 1.51, "CG_CD1": 1.385,
         "CG_CD2": 1.385, "CD1_CE1": 1.385, "CD2_CE2": 1.385, "CE1_CZ": 1.385},
        {"CA_C_O": 120.283, "C_CA_CB": 110.846, "CA_CB_CG": 114.0,
         "CB_CG_CD1": 120.0, "CB_CG_CD2": 120.0, "CG_CD1_CE1": 120.0,
         "CG_CD2_CE2": 120.0, "CD1_CE1_CZ": 120.0},
        ["N", "CA", "C", "CB", "O", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"],
    ),
    "PRO": (
        ["N", "CA", "C", "O", "CB", "CG", "CD"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG": ("N", "CA", "CB"),
         "CD": ("CA", "CB", "CG")},
        {"CA_CB": 1.53, "C_O": 1.23, "CB_CG": 1.49, "CG_CD": 1.50},
        {"CA_C_O": 120.6, "C_CA_CB": 111.372, "CA_CB_CG": 104.21, "CB_CG_CD": 105.0},
        ["N", "CA", "C", "CB", "O", "CG", "CD"],
    ),
    "SER": (
        ["N", "CA", "C", "O", "CB", "OG"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "OG": ("N", "CA", "CB")},
        {"CA_CB": 1.53, "C_O": 1.23, "CB_OG": 1.417},
        {"CA_C_O": 120.475, "C_CA_CB": 110.248, "CA_CB_OG": 111.132},
        ["N", "CA", "C", "CB", "O", "OG"],
    ),
    "THR": (
        ["N", "CA", "C", "O", "CB", "OG1", "CG2"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "OG1": ("N", "CA", "CB"),
         "CG2": ("N", "CA", "CB")},
        {"CA_CB": 1.53, "C_O": 1.23, "CB_OG1": 1.43, "CB_CG2": 1.52},
        {"CA_C_O": 120.252, "C_CA_CB": 110.075, "CA_CB_OG1": 109.442,
         "CA_CB_CG2": 111.457},
        ["N", "CA", "C", "CB", "O", "CG2", "OG1"],
    ),
    "TRP": (
        ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "NE1", "CE2", "CE3",
         "CZ2", "CZ3", "CH2"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG": ("N", "CA", "CB"),
         "CD1": ("CA", "CB", "CG"), "CD2": ("CA", "CB", "CG"),
         "NE1": ("CB", "CG", "CD1"), "CE2": ("CB", "CG", "CD2"),
         "CE3": ("CB", "CG", "CD2"), "CZ2": ("CG", "CD2", "CE2"),
         "CZ3": ("CG", "CD2", "CE3"), "CH2": ("CD2", "CE2", "CZ2")},
        {"CA_CB": 1.53, "C_O": 1.23, "CB_CG": 1.50, "CG_CD1": 1.36, "CG_CD2": 1.44,
         "CD1_NE1": 1.38, "CD2_CE2": 1.41, "CD2_CE3": 1.40, "CE2_CZ2": 1.40,
         "CE3_CZ3": 1.384, "CZ2_CH2": 1.367},
        {"CA_C_O": 120.178, "C_CA_CB": 110.852, "CA_CB_CG": 114.10,
         "CB_CG_CD1": 126.712, "CB_CG_CD2": 126.712, "CG_CD1_NE1": 109.959,
         "CG_CD2_CE2": 107.842, "CG_CD2_CE3": 133.975, "CD2_CE2_CZ2": 120.0,
         "CD2_CE3_CZ3": 120.0, "CE2_CZ2_CH2": 120.0},
        ["N", "CA", "C", "CB", "O", "CG", "CD1", "CD2", "CE2", "CE3", "NE1",
         "CH2", "CZ2", "CZ3"],
    ),
    "TYR": (
        ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ", "OH"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG": ("N", "CA", "CB"),
         "CD1": ("CA", "CB", "CG"), "CD2": ("CA", "CB", "CG"),
         "CE1": ("CB", "CG", "CD1"), "CE2": ("CB", "CG", "CD2"),
         "CZ": ("CG", "CD1", "CE1"), "OH": ("CD1", "CE1", "CZ")},
        {"CA_CB": 1.53, "C_O": 1.235, "CB_CG": 1.51, "CG_CD1": 1.39, "CG_CD2": 1.39,
         "CD1_CE1": 1.38, "CD2_CE2": 1.38, "CE1_CZ": 1.378, "CZ_OH": 1.375},
        {"CA_C_O": 120.608, "C_CA_CB": 110.852, "CA_CB_CG": 113.744,
         "CB_CG_CD1": 120.937, "CB_CG_CD2": 120.937, "CG_CD1_CE1": 120.0,
         "CG_CD2_CE2": 120.0, "CD1_CE1_CZ": 120.0, "CE1_CZ_OH": 120.0},
        ["N", "CA", "C", "CB", "O", "CG", "CD1", "CD2", "CE1", "CE2", "OH", "CZ"],
    ),
    "VAL": (
        ["N", "CA", "C", "O", "CB", "CG1", "CG2"],
        {"O": ("N", "CA", "C"), "CB": ("O", "C", "CA"), "CG1": ("N", "CA", "CB"),
         "CG2": ("N", "CA", "CB")},
        {"CA_CB": 1.54, "C_O": 1.235, "CB_CG1": 1.52, "CB_CG2": 1.52},
        {"CA_C_O": 120.472, "C_CA_CB": 111.381, "CA_CB_CG1": 110.7, "CA_CB_CG2": 110.4},
        ["N", "CA", "C", "CB", "O", "CG1", "CG2"],
    ),
}

# Backbone NeRF constants (nerf.h:37-43, foldcomp.h:51-54).
N_TO_CA_DIST = 1.4581
CA_TO_C_DIST = 1.5281
C_TO_N_DIST = 1.3311
PRO_N_TO_CA_DIST = 1.353


def _build_dense():
    """Flatten AA_DATA into dense arrays indexed by the 5-bit residue code."""
    n = 24  # all codes; codes >= 20 (ASX/GLX/STP/UNK) have zero side-chain atoms
    atom_names = [[""] * MAX_ATOM for _ in range(n)]
    n_atoms = np.zeros(n, dtype=np.int32)
    pred_idx = np.zeros((n, MAX_ATOM, 3), dtype=np.int32)
    bond_len = np.zeros((n, MAX_ATOM), dtype=np.float32)
    bond_ang = np.zeros((n, MAX_ATOM), dtype=np.float32)
    alt_perm = np.tile(np.arange(MAX_ATOM, dtype=np.int32), (n, 1))
    name_to_slot = [dict() for _ in range(n)]

    for code in range(NUM_AA):
        three = THREE_LETTER[code]
        atoms, graph, lengths, angles, alt = AA_DATA[three]
        n_atoms[code] = len(atoms)
        slot = {a: i for i, a in enumerate(atoms)}
        name_to_slot[code] = slot
        for i, a in enumerate(atoms):
            atom_names[code][i] = a
        for k in range(3, len(atoms)):
            curr = atoms[k]
            p0, p1, p2 = graph[curr]
            pred_idx[code, k] = (slot[p0], slot[p1], slot[p2])
            bond_len[code, k] = np.float32(lengths[f"{p2}_{curr}"])
            bond_ang[code, k] = np.float32(angles[f"{p1}_{p2}_{curr}"])
        # alt_perm[code, j] = table slot of the atom that goes to alt position j
        for j, a in enumerate(alt):
            alt_perm[code, j] = slot[a]

    return atom_names, n_atoms, pred_idx, bond_len, bond_ang, alt_perm, name_to_slot


(ATOM_NAMES, N_ATOMS, PRED_IDX, BOND_LEN, BOND_ANG, ALT_PERM,
 NAME_TO_SLOT) = _build_dense()

# Side-chain torsion count per residue code = n_atoms - 3 (foldcomp.cpp:1761-1807).
N_SC_TORSION = np.maximum(N_ATOMS - 3, 0).astype(np.int32)


def sc_torsion_count(three: str) -> int:
    """getSideChainTorsionNum parity (foldcomp.cpp:1761). Unknown residues -> 0."""
    from .codes import int_from_three_letter
    code = int_from_three_letter(three)
    if code < NUM_AA and THREE_LETTER[code] == three:
        return int(N_SC_TORSION[code])
    return 0
