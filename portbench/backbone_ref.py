"""Foldcomp's float32 decode of a protein's backbone (N, CA and C of every
residue) from an FCZ entry's bytes, in plain PyTorch on the CPU: the
reference of the backbone-only cells.

The steps are those of Foldcomp's decompress (foldcomp.cpp:779-858) and
of the frozen NumPy decoder beside it (reference/decoder.py): the angle
streams continuized from their quantizers; per anchor segment a forward
NeRF walk seeded by the previous segment's blended tail (the stored
first anchor for the first segment), a reverse walk seeded by the next
stored anchor, and the position-weighted blend of the two
(weightedAverage). No side chains, no batching over proteins, no kernels,
nothing of the port: the FCZ bytes are read by the frozen parse
(reference/fcz.py), every coordinate is computed here with torch
operations in `dtype`.

Departures from Foldcomp's decoder, none of which moves a float32 value
by more than an ulp or two of a step:
- NeRF (nerf.cpp:39-104) rounds each product and sum of its vectors to
  float32 as Foldcomp does, but takes the norms as torch.linalg's
  float64 vector norm, and the cross products from torch.linalg.cross;
- cosf and sinf are taken in float64 and rounded to `dtype` (glibc's
  float32 functions are correctly rounded but for rare cases);
- each step's (bond length, angle, torsion) vector is computed for a
  whole segment at once, the walks alone go step by step.

`dtype=torch.bfloat16` is the control: every value that Foldcomp rounds
to float32 is rounded to bfloat16 instead (the float64 parts, as in
Foldcomp, stay float64), the nearest precision below the float32 that
Foldcomp's codec states.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference import fcz
from .reference.aatable import (C_TO_N_DIST, CA_TO_C_DIST, N_TO_CA_DIST,
                                PRO_N_TO_CA_DIST)
from .reference.codes import ONE_LETTER

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PRO = ONE_LETTER.index("P")
F64 = torch.float64


def _rad_cs(deg, dt):
    """cos and sin of angles in degrees as Foldcomp takes them: radians
    f32(angle * M_PI / 180.0) in double, then cosf and sinf."""
    rad = (deg.to(F64) * math.pi / 180.0).to(dt).to(F64)
    return torch.cos(rad).to(dt), torch.sin(rad).to(dt)


def _frames(bl, ang, tor, dt):
    """[k, 3] NeRF offsets in the local frame (nerf.cpp:74-80): (-bl cos
    angle, bl cos torsion sin angle, bl sin torsion sin angle), each
    product rounded to dt."""
    cb, sb = _rad_cs(ang, dt)
    ct, st = _rad_cs(tor, dt)
    return torch.stack([-bl * cb, (bl * ct) * sb, (bl * st) * sb], dim=1)


def _norm(v, dt):
    return torch.linalg.vector_norm(v, dtype=F64).to(dt)


def _place(a, b, c, d):
    """Nerf::place_atom on [3] points with its local offset d (Python
    floats)."""
    dt = c.dtype
    bc = c - b
    bcn = bc / _norm(bc, dt)
    n = torch.linalg.cross(b - a, bcn)
    n = n / _norm(n, dt)
    nbc = torch.linalg.cross(n, bcn)
    return ((bcn * d[0] + nbc * d[1]) + n * d[2]) + c


def _bond_angles(x, dt):
    """float3d angle() at each inner atom of the walk x [t, 3]: [t-2]
    degrees (dot products in dt, the division, acos and the conversion
    in double)."""
    d1 = x[:-2] - x[1:-1]
    d2 = x[2:] - x[1:-1]

    def dot(u, v):
        return (u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1]) + u[:, 2] * v[:, 2]

    cos_t = (dot(d1, d2).to(F64) / torch.sqrt((dot(d1, d1) * dot(d2, d2))
                                              .to(F64))).to(dt)
    return (torch.acos(cos_t.to(F64)) * 180.0 / math.pi).to(dt)


def _walk(seed3, d):
    """The NeRF chain from three atoms, one atom a row of d [k, 3]: [3 +
    k, 3]."""
    out = list(seed3)
    for row in d.tolist():
        out.append(_place(out[-3], out[-2], out[-1], row))
    return torch.stack(out)


def decode_backbone(blob: bytes, dtype=torch.float32) -> torch.Tensor:
    """[n_residue, 3 (N, CA, C), 3] backbone of an FCZ entry, in dtype."""
    dt = dtype
    f = fcz.parse(blob)
    code, *qs = (torch.from_numpy(np.asarray(q, np.int64))
                 for q in fcz.unpack_records(f.records))
    mins = torch.from_numpy(np.asarray(f.mins, np.float32)).to(dt)
    cont = torch.from_numpy(np.asarray(f.cont_fs, np.float32)).to(dt)
    # phi, psi, omega, n_ca_c, ca_c_n, c_n_ca: f32(code) * cont_f + min
    phi, psi, omega, ncac, cacn, cnca = (
        q.to(dt) * cont[k] + mins[k] for k, q in enumerate(
            (qs[0], qs[1], qs[2], qs[3], qs[4], qs[5])))
    n = f.n_residue
    tors = torch.stack([psi[:-1], omega[:-1], phi[:-1]], 1).reshape(-1)

    def blen(x, k=None):
        return torch.full((n if k is None else k,), x, dtype=torch.float32) \
            .to(dt)
    ca_len = torch.where(code == PRO, blen(PRO_N_TO_CA_DIST),
                         blen(N_TO_CA_DIST))
    # each residue's three forward placements (N, CA, C: foldcomp.cpp:
    # 205-225), residue-major
    fwd_d = torch.stack([
        _frames(blen(C_TO_N_DIST), cacn, psi, dt),
        _frames(ca_len, cnca, omega, dt),
        _frames(blen(CA_TO_C_DIST), ncac, phi, dt)], 1).reshape(-1, 3)
    rev_bl = torch.tensor([C_TO_N_DIST, CA_TO_C_DIST, N_TO_CA_DIST],
                          dtype=torch.float32).to(dt)
    anchors = [int(a) for a in f.anchor_indices]
    acoords = torch.from_numpy(np.asarray(f.anchor_coords, np.float32)) \
        .to(dt)
    prev3 = list(acoords[0])
    out = []
    max_rec, max_tor = n - 1, len(tors) - 1
    for s in range(f.n_anchor - 1):
        last_seg = s == f.n_anchor - 2
        first = min(anchors[s], max_rec)
        last = min(anchors[s + 1] + 1, max_rec)
        rows = list(range(first, last)) + ([n - 1] if last_seg else [])
        # forward: records[i] places residue i+1's atoms, for every
        # record of the segment but its last
        d = fwd_d.reshape(n, 3, 3)[rows[:-1]].reshape(-1, 3)
        x = _walk(prev3, d)
        t = x.shape[0]
        t_first = min(anchors[s] * 3, max_tor)
        t_last = min(anchors[s + 1] * 3, max_tor)
        seg_tors = tors[t_first:t_last]
        if last_seg:
            seg_tors = torch.cat([seg_tors, tors[-1:]])
        # reverse (foldcomp.cpp:248-273): from the next anchor's C, CA, N
        # back along the segment; step i places the atom before
        # x[t-1-i-2], with the forward walk's bond angle at x[t-3-i]
        ang = _bond_angles(x, dt)
        k = t - 3
        i = torch.arange(k)
        dr = _frames(rev_bl[i % 3], ang[t - 4 - i],
                     seg_tors.flip(0)[:k], dt)
        a3 = acoords[s + 1]
        r = _walk([a3[2], a3[1], a3[0]], dr).flip(0)
        # weightedAverage (atom_coordinate.cpp:145-163)
        w_f = torch.arange(t, 0, -1, dtype=torch.float32).to(dt)[:, None]
        w_r = torch.arange(t, dtype=torch.float32).to(dt)[:, None]
        blend = (x * w_f + r * w_r) / torch.tensor(float(t)).to(dt)
        out.append(blend if last_seg else blend[:-3])
        prev3 = list(blend[-3:])
    return torch.cat(out).reshape(n, 3, 3)
