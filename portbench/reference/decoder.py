# Frozen copy of foldcomp_tpu_torch/codec/decoder.py:1-323 at commit 5ba08cd7580a
# (5ba08cd7580a295d1f8bab06ceee779a4da42958), imports made local to portbench/reference.
# Frozen so that the yardstick stays fixed while later changes edit the
# port: the benchmark judges the port against this copy, never against
# the port's own modules. It imports nothing of the port.
"""Exact FCZ decoder (host, reference-bit-compatible float semantics).

Pipeline parity: Foldcomp::read + decompress (foldcomp.cpp:904-1036, 779-902):
continuize quantized angle streams, per-anchor-segment forward NeRF
reconstruction, reverse reconstruction seeded with the stored anchor coords,
position-weighted blend, then per-residue side-chain NeRF placement from the
amino-acid geometry tables.

This is the sequential host path used for correctness gates and small inputs;
the port's batched device path is foldcomp_tpu_torch.kernels.fused_decode.

The port's own copy of `foldcomp_tpu/codec/decoder.py:1`, kept line for line so
that both packages write the same bytes (tests/test_torch_standalone.py
holds the two to the same results).
"""
from __future__ import annotations

import math

import numpy as np

from . import exact
from .aatable import (AA_DATA, C_TO_N_DIST, CA_TO_C_DIST,
                            N_TO_CA_DIST, PRO_N_TO_CA_DIST, N_SC_TORSION)
from .codes import (one_letter_from_int, three_letter_from_int,
                          three_letter_from_one)
from .structure import AtomArray
from .fcz import FczData, NUM_BITS_TEMP, unpack_records

F32 = np.float32
_PI = math.pi


def _f32(x: float) -> float:
    return float(F32(x))


# The reference calls C cosf/sinf (nerf.cpp:68-70). Bind the exact libm
# symbols so single-precision transcendentals match bit-for-bit; fall back to
# double cos/sin rounded to f32 (equal on correctly-rounded libms).
try:
    import ctypes
    import ctypes.util

    _libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for _fn in (_libm.cosf, _libm.sinf):
        _fn.restype = ctypes.c_float
        _fn.argtypes = [ctypes.c_float]

    def _cosf(x: float) -> float:
        return _libm.cosf(x)

    def _sinf(x: float) -> float:
        return _libm.sinf(x)
except Exception:  # pragma: no cover - non-glibc fallback
    def _cosf(x: float) -> float:
        return _f32(math.cos(_f32(x)))

    def _sinf(x: float) -> float:
        return _f32(math.sin(_f32(x)))


def place_atom(a, b, c, bond_length, bond_angle_deg, torsion_deg):
    """Nerf::place_atom (nerf.cpp:39-104) with exact float32 semantics.

    Scalar Python floats carrying f32-rounded values; the degree->radian
    conversions promote to double exactly like `angle * M_PI / 180.0`, and
    norms run in double via pow() like float3d.h:32-34.
    """
    abx = _f32(b[0] - a[0]); aby = _f32(b[1] - a[1]); abz = _f32(b[2] - a[2])
    bcx = _f32(c[0] - b[0]); bcy = _f32(c[1] - b[1]); bcz = _f32(c[2] - b[2])
    bc_norm = _f32(math.sqrt(bcx * bcx + bcy * bcy + bcz * bcz))
    bcnx = _f32(bcx / bc_norm); bcny = _f32(bcy / bc_norm); bcnz = _f32(bcz / bc_norm)

    ba = _f32(bond_angle_deg * _PI / 180.0)
    ta = _f32(torsion_deg * _PI / 180.0)

    cos_ba = _cosf(ba); sin_ba = _sinf(ba)
    cos_ta = _cosf(ta); sin_ta = _sinf(ta)
    dx = _f32(_f32(-1.0 * bond_length) * cos_ba)
    dy = _f32(_f32(bond_length * cos_ta) * sin_ba)
    dz = _f32(_f32(bond_length * sin_ta) * sin_ba)

    # crossProduct rounds each product to f32 before subtracting (float3d.h:19-24)
    nx = _f32(_f32(aby * bcnz) - _f32(bcny * abz))
    ny = _f32(_f32(abz * bcnx) - _f32(bcnz * abx))
    nz = _f32(_f32(abx * bcny) - _f32(bcnx * aby))
    n_norm = _f32(math.sqrt(nx * nx + ny * ny + nz * nz))
    nx = _f32(nx / n_norm); ny = _f32(ny / n_norm); nz = _f32(nz / n_norm)

    nbcx = _f32(_f32(ny * bcnz) - _f32(bcny * nz))
    nbcy = _f32(_f32(nz * bcnx) - _f32(bcnz * nx))
    nbcz = _f32(_f32(nx * bcny) - _f32(bcnx * ny))

    ox = _f32(_f32(_f32(bcnx * dx) + _f32(nbcx * dy)) + _f32(nx * dz))
    oy = _f32(_f32(_f32(bcny * dx) + _f32(nbcy * dy)) + _f32(ny * dz))
    oz = _f32(_f32(_f32(bcnz * dx) + _f32(nbcz * dy)) + _f32(nz * dz))
    return (_f32(ox + c[0]), _f32(oy + c[1]), _f32(oz + c[2]))


def _bond_angle_scalar(a, b, c):
    """float3d angle() on scalar triples (f32 vector math, f64 acos)."""
    d1x = _f32(a[0] - b[0]); d1y = _f32(a[1] - b[1]); d1z = _f32(a[2] - b[2])
    d2x = _f32(c[0] - b[0]); d2y = _f32(c[1] - b[1]); d2z = _f32(c[2] - b[2])
    inner = _f32(_f32(_f32(d1x * d2x) + _f32(d1y * d2y)) + _f32(d1z * d2z))
    s1 = _f32(_f32(_f32(d1x * d1x) + _f32(d1y * d1y)) + _f32(d1z * d1z))
    s2 = _f32(_f32(_f32(d2x * d2x) + _f32(d2y * d2y)) + _f32(d2z * d2z))
    cos_t = _f32(inner / math.sqrt(_f32(s1 * s2)))
    try:
        return _f32(math.acos(cos_t) * 180.0 / _PI)
    except ValueError:
        return float("nan")


# float32 values of the backbone bond-length macros (foldcomp.h:51-54)
_C_TO_N = _f32(C_TO_N_DIST)
_N_TO_CA = _f32(N_TO_CA_DIST)
_PRO_N_TO_CA = _f32(PRO_N_TO_CA_DIST)
_CA_TO_C = _f32(CA_TO_C_DIST)
_REV_BOND = {("N", "CA"): _N_TO_CA, ("CA", "C"): _CA_TO_C, ("C", "N"): _C_TO_N}


def _forward_segment(prev3, records, res_letters):
    """reconstructBackboneAtoms core (foldcomp.cpp:167-246).

    prev3: list of 3 (x,y,z); records: list of per-record continuized angle
    dicts; returns coords list [3 + 3*(len(records)-1)] and their atom names.
    """
    coords = list(prev3)
    total = len(records)
    for i in range(total - 1):
        r = records[i]
        a, b, c = coords[3 * i], coords[3 * i + 1], coords[3 * i + 2]
        n_xyz = place_atom(a, b, c, _C_TO_N, r["ca_c_n"], r["psi"])
        ca_len = _N_TO_CA if res_letters[i] != "P" else _PRO_N_TO_CA
        ca_xyz = place_atom(b, c, n_xyz, ca_len, r["c_n_ca"], r["omega"])
        c_xyz = place_atom(c, n_xyz, ca_xyz, _CA_TO_C, r["n_ca_c"], r["phi"])
        coords.extend([n_xyz, ca_xyz, c_xyz])
    return coords


def _reverse_blend(coords, anchor3, torsions):
    """reconstructBackboneReverse (foldcomp.cpp:248-273) + weightedAverage.

    coords: forward-reconstructed segment [(x,y,z)] whose atom-name pattern is
    (N, CA, C)*; anchor3: stored next-anchor N/CA/C coords; torsions: the
    continuized (psi, omega, phi) stream slice for the segment.
    """
    t = len(coords)
    names = ["N", "CA", "C"] * (t // 3)
    bond_angles = [_bond_angle_scalar(coords[i - 1], coords[i], coords[i + 1])
                   for i in range(1, t - 1)]

    rev = list(reversed(coords))
    rev[0], rev[1], rev[2] = tuple(anchor3[2]), tuple(anchor3[1]), tuple(anchor3[0])
    rev_names = list(reversed(names))
    rev_tors = list(reversed(torsions))
    rev_angles = list(reversed(bond_angles))

    out = [rev[0], rev[1], rev[2]]
    for i in range(t - 3):
        curr_name = rev_names[i + 3]
        prev2_name = rev_names[i + 2]
        bl = _REV_BOND[(curr_name, prev2_name)]
        xyz = place_atom(out[i], out[i + 1], out[i + 2], bl,
                         rev_angles[i + 1], rev_tors[i])
        out.append(xyz)
    out.reverse()

    # weightedAverage (atom_coordinate.cpp:145-163)
    blended = []
    ft = _f32(float(t))
    for i in range(t):
        w_f = _f32(float(t - i))
        w_r = _f32(float(i))
        blended.append(tuple(
            _f32(_f32(_f32(coords[i][k] * w_f) + _f32(out[i][k] * w_r)) / ft)
            for k in range(3)))
    return blended


def decode(f: FczData, use_alt_order: bool = False) -> AtomArray:
    """Full decompression of one FCZ record to an AtomArray."""
    res_code, phi_q, psi_q, omega_q, ncac_q, cacn_q, cnca_q = \
        unpack_records(f.records)
    n_res = f.n_residue

    def cont(q, idx):
        d = exact.Discretizer.from_params(f.mins[idx], f.cont_fs[idx])
        return d.continuize(q)

    phi = cont(phi_q, 0)
    psi = cont(psi_q, 1)
    omega = cont(omega_q, 2)
    n_ca_c = cont(ncac_q, 3)
    ca_c_n = cont(cacn_q, 4)
    c_n_ca = cont(cnca_q, 5)

    # interleaved torsion stream: psi, omega, phi for i < n_res-1
    # (foldcomp.cpp:789-793)
    torsion_stream = np.stack([psi[:-1], omega[:-1], phi[:-1]],
                              axis=1).reshape(-1)

    res_letters = [one_letter_from_int(int(c)) for c in res_code]
    res_three = [three_letter_from_int(int(c)) for c in res_code]

    records = [dict(psi=float(psi[i]), omega=float(omega[i]), phi=float(phi[i]),
                    n_ca_c=float(n_ca_c[i]), ca_c_n=float(ca_c_n[i]),
                    c_n_ca=float(c_n_ca[i])) for i in range(n_res)]

    # Segment loop (foldcomp.cpp:812-858)
    anchors = [int(a) for a in f.anchor_indices]
    n_all = f.n_anchor
    prev3 = [tuple(map(float, f.anchor_coords[0][k])) for k in range(3)]
    bb_coords = []
    max_rec = n_res - 1
    max_tor = len(torsion_stream) - 1
    for s in range(n_all - 1):
        first = min(anchors[s], max_rec)
        last = min(anchors[s + 1] + 1, max_rec)
        seg_records = records[first:last]
        seg_letters = res_letters[first:last]
        if s == n_all - 2:
            seg_records = seg_records + [records[-1]]
            seg_letters = seg_letters + [res_letters[-1]]
        fwd = _forward_segment(prev3, seg_records, seg_letters)

        t_first = min(anchors[s] * 3, max_tor)
        t_last = min(anchors[s + 1] * 3, max_tor)
        seg_tors = [float(x) for x in torsion_stream[t_first:t_last]]
        if s == n_all - 2:
            seg_tors.append(float(torsion_stream[-1]))

        anchor3 = f.anchor_coords[s + 1]
        blended = _reverse_blend(fwd, [tuple(map(float, anchor3[k]))
                                       for k in range(3)], seg_tors)
        if s != n_all - 2:
            bb_coords.extend(blended[:-3])
        else:
            bb_coords.extend(blended)
        prev3 = blended[-3:]

    # Side chains (foldcomp.cpp:861-879); torsions continuized with the fixed
    # [-180,180] 255-bin quantizer (foldcomp.cpp:350-369)
    fixed = exact.FixedAngleDiscretizer(2 ** NUM_BITS_TEMP - 1)
    sc_all = fixed.continuize(f.sc_codes)
    sc_per_res = []
    pos = 0
    for i in range(n_res):
        cnt = int(N_SC_TORSION[res_code[i]]) if res_code[i] < 20 else 0
        sc_per_res.append([float(x) for x in sc_all[pos:pos + cnt]])
        pos += cnt

    # first residue name comes from the header (foldcomp.cpp:862)
    first_three = three_letter_from_one(f.first_residue)

    atom_name, residue_name, chain_ids = [], [], []
    residue_index, coords_out = [], []
    chain = f.chain
    for i in range(n_res):
        rname = first_three if i == 0 else res_three[i]
        code = res_code[i] if res_code[i] < 20 else None
        n_xyz, ca_xyz, c_xyz = bb_coords[3 * i], bb_coords[3 * i + 1], \
            bb_coords[3 * i + 2]
        if code is None or rname not in AA_DATA:
            names = ["N", "CA", "C"]
            coords = [n_xyz, ca_xyz, c_xyz]
        else:
            atoms_tbl, graph, lengths, angles, _alt = AA_DATA[rname]
            slot_coords = {"N": n_xyz, "CA": ca_xyz, "C": c_xyz}
            names = list(atoms_tbl)
            coords = [n_xyz, ca_xyz, c_xyz]
            tor = sc_per_res[i]
            for k in range(3, len(atoms_tbl)):
                curr = atoms_tbl[k]
                p0, p1, p2 = graph[curr]
                bl = _f32(lengths[f"{p2}_{curr}"])
                bang = _f32(angles[f"{p1}_{p2}_{curr}"])
                xyz = place_atom(slot_coords[p0], slot_coords[p1],
                                 slot_coords[p2], bl, bang, tor[k - 3])
                slot_coords[curr] = xyz
                coords.append(xyz)
            if use_alt_order:
                alt = _alt
                order = [names.index(a) for a in alt]
                names = [names[j] for j in order]
                coords = [coords[j] for j in order]
        atom_name.extend(names)
        residue_name.extend([rname] * len(names))
        chain_ids.extend([chain] * len(names))
        residue_index.extend([f.idx_residue + i] * len(names))
        coords_out.extend(coords)

    # tempFactors (foldcomp.cpp:884-891)
    tf_disc = exact.Discretizer.from_params(f.tf_min, f.tf_cont)
    tf = tf_disc.continuize(f.tf_codes)
    temp = np.zeros(len(atom_name), F32)
    start = 0
    for i in range(n_res):
        end = start
        while end < len(residue_index) and residue_index[end] == f.idx_residue + i:
            end += 1
        temp[start:end] = tf[i]
        start = end

    if f.has_oxt:
        atom_name.append("OXT")
        last_three = three_letter_from_one(f.last_residue)
        residue_name.append(last_three)
        chain_ids.append(chain)
        # reference builds OXT with residue_index = header.nResidue
        # (foldcomp.cpp:962-965), not idxResidue + nResidue - 1
        residue_index.append(f.n_residue)
        coords_out.append(tuple(map(float, f.oxt_coords)))
        temp = np.append(temp, tf[-1]).astype(F32)

    n_total = len(atom_name)
    atom_index = np.arange(f.idx_atom, f.idx_atom + n_total, dtype=np.int32)
    return AtomArray(
        atom_name, residue_name, chain_ids,
        atom_index, np.asarray(residue_index, np.int32),
        np.asarray(coords_out, F32), np.ones(n_total, F32), temp, f.title,
    )
