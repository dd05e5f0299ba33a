# Adapted from foldcomp_tpu_torch/verify.py:80-130 (synthesize) at commit
# 5ba08cd7580a (5ba08cd7580a295d1f8bab06ceee779a4da42958), imports made
# local to portbench/reference, and frozen here so that the inputs the
# benchmark makes from a seed stay the same while later changes edit the
# port. It imports nothing of the port. One change: the original draws
# every side-chain torsion uniformly, O's and CB's too, which puts CB on
# the N-CA line in about one residue in 600 (N-CA-CB near 0 degrees, 59%
# of residues under 100); the next atom's frame is then degenerate and any
# two float32 decoders place it Angstroms apart. Here O lies in the peptide
# plane (N-CA-C-O = psi + 180), CB is tetrahedral (N-C-CA-CB = 122.71, as
# in AlphaFold's idealized L residues), and the chi angles sit in the
# rotamer wells -60, 180 and 60 degrees with a 12-degree spread.
"""Seeded synthetic single-chain proteins with realistic geometry."""
from __future__ import annotations

import numpy as np

from .aatable import (AA_DATA, C_TO_N_DIST, CA_TO_C_DIST, N_TO_CA_DIST,
                      PRO_N_TO_CA_DIST)
from .codes import THREE_LETTER
from .decoder import place_atom
from .structure import AtomArray

CB_TORSION = 122.71          # N-C-CA-CB of an idealized L residue
CHI_WELLS = (-60.0, 180.0, 60.0)
CHI_SPREAD = 12.0


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
            if nm == "CB":
                slot[nm] = place_atom(slot["N"], slot["C"], slot["CA"],
                                      lengths["CA_CB"], angles["C_CA_CB"],
                                      CB_TORSION)
            elif k >= 3:
                p0, p1, p2 = graph[nm]
                tor = psi[r] + 180.0 if nm == "O" else float(
                    rng.choice(CHI_WELLS) + rng.normal(0.0, CHI_SPREAD))
                slot[nm] = place_atom(
                    slot[p0], slot[p1], slot[p2],
                    lengths[f"{p2}_{nm}"], angles[f"{p1}_{p2}_{nm}"], tor)
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
