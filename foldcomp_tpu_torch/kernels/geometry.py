"""Plain PyTorch versions of the decode's geometry helpers.

Component form (one tensor per coordinate component, any common shape),
operation for operation the JAX functions they mirror, so that the CPU
path and the CUDA kernels (csrc/fused_decode.cu, same order) agree with
the reference to float32 rounding:

  place_atom_c    <- foldcomp_tpu/kernels/geometry.py:78-112
  bond_angle_cs   <- foldcomp_tpu/kernels/pallas_decode.py:72-87
  place_atom_cs   <- foldcomp_tpu/kernels/pallas_decode.py:93-117

and of the feature windows of the sequence-parallel encode
(parallel/seqpar.py), which the JAX package computes in XLA:

  bond_angle_parts_c, bond_angle_c  <- foldcomp_tpu/kernels/geometry.py:115-139
  dihedral_parts_c, dihedral_c      <- foldcomp_tpu/kernels/geometry.py:142-181

Their square roots go through kernels/encode.sqrt_rn, correctly rounded on
the CPU too, as XLA's are.

Scalar arguments are Python floats: torch casts them to float32, the
tensors' type, exactly (every constant is a float32 value).
"""
from __future__ import annotations

import torch

from ..core.tables import DEG, RADK
from .encode import sqrt_rn

_RADK = float(RADK)
_DEG = float(DEG)
_EPS = 1e-30


def place_atom_cs(ax, ay, az, bx, by, bz, cx, cy, cz,
                  bond_length, cos_ba, sin_ba, torsion_deg):
    """NeRF placement of the atom after c, with the bond angle given as
    (cos, sin)."""
    abx, aby, abz = bx - ax, by - ay, bz - az
    bcx, bcy, bcz = cx - bx, cy - by, cz - bz
    inv_bc = torch.rsqrt(torch.clamp_min(bcx * bcx + bcy * bcy + bcz * bcz,
                                         _EPS))
    bcnx, bcny, bcnz = bcx * inv_bc, bcy * inv_bc, bcz * inv_bc
    ta = torsion_deg * _RADK
    dx = -bond_length * cos_ba
    dy = bond_length * torch.cos(ta) * sin_ba
    dz = bond_length * torch.sin(ta) * sin_ba
    nx = aby * bcnz - bcny * abz
    ny = abz * bcnx - bcnz * abx
    nz = abx * bcny - bcnx * aby
    inv_n = torch.rsqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, _EPS))
    nx, ny, nz = nx * inv_n, ny * inv_n, nz * inv_n
    mx = ny * bcnz - bcny * nz
    my = nz * bcnx - bcnz * nx
    mz = nx * bcny - bcnx * ny
    ox = bcnx * dx + mx * dy + nx * dz + cx
    oy = bcny * dx + my * dy + ny * dz + cy
    oz = bcnz * dx + mz * dy + nz * dz + cz
    return ox, oy, oz


def place_atom_c(ax, ay, az, bx, by, bz, cx, cy, cz,
                 bond_length, bond_angle_deg, torsion_deg):
    """NeRF placement with the bond angle in degrees."""
    ba = bond_angle_deg * _RADK
    return place_atom_cs(ax, ay, az, bx, by, bz, cx, cy, cz,
                         bond_length, torch.cos(ba), torch.sin(ba),
                         torsion_deg)


def bond_angle_cs(ax, ay, az, bx, by, bz, cx, cy, cz):
    """(cos, sin) of the 3-point angle at b: sqrt then divide, clip, and
    no acos (the reverse sweep only needs cos/sin of the angle)."""
    d1x, d1y, d1z = ax - bx, ay - by, az - bz
    d2x, d2y, d2z = cx - bx, cy - by, cz - bz
    inner = d1x * d2x + d1y * d2y + d1z * d2z
    s1 = d1x * d1x + d1y * d1y + d1z * d1z
    s2 = d2x * d2x + d2y * d2y + d2z * d2z
    cos_t = inner / torch.sqrt(torch.clamp_min(s1 * s2, _EPS))
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return cos_t, sin_t


def bond_angle_parts_c(ax, ay, az, bx, by, bz, cx, cy, cz):
    """3-point angle at b split into its float32 parts (inner, s1 * s2)."""
    d1x, d1y, d1z = ax - bx, ay - by, az - bz
    d2x, d2y, d2z = cx - bx, cy - by, cz - bz
    inner = d1x * d2x + d1y * d2y + d1z * d2z
    s1 = d1x * d1x + d1y * d1y + d1z * d1z
    s2 = d2x * d2x + d2y * d2y + d2z * d2z
    return inner, s1 * s2


def bond_angle_c(ax, ay, az, bx, by, bz, cx, cy, cz):
    """3-point angle at b in degrees: sqrt then divide, clip, acos."""
    inner, denom2 = bond_angle_parts_c(ax, ay, az, bx, by, bz, cx, cy, cz)
    cos_t = inner / sqrt_rn(torch.clamp_min(denom2, _EPS))
    return torch.arccos(torch.clamp(cos_t, -1.0, 1.0)) * _DEG


def dihedral_parts_c(p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z,
                     p3x, p3y, p3z):
    """Dihedral split into its float32 parts (inner, denom2, det): the
    cross products, dot products, squared norms and sign determinant of
    getTorsionFromXYZ (torsion_angle.cpp:46-96)."""
    d1x, d1y, d1z = p1x - p0x, p1y - p0y, p1z - p0z
    d2x, d2y, d2z = p2x - p1x, p2y - p1y, p2z - p1z
    d3x, d3y, d3z = p3x - p2x, p3y - p2y, p3z - p2z
    u1x = d1y * d2z - d2y * d1z
    u1y = d1z * d2x - d2z * d1x
    u1z = d1x * d2y - d2x * d1y
    u2x = d2y * d3z - d3y * d2z
    u2y = d2z * d3x - d3z * d2x
    u2z = d2x * d3y - d3x * d2y
    inner = u1x * u2x + u1y * u2y + u1z * u2z
    denom2 = (u1x * u1x + u1y * u1y + u1z * u1z) * \
        (u2x * u2x + u2y * u2y + u2z * u2z)
    pbx = u2y * d2z - d2y * u2z
    pby = u2z * d2x - d2z * u2x
    pbz = u2x * d2y - d2x * u2y
    det = u1x * pbx + u1y * pby + u1z * pbz
    return inner, denom2, det


def dihedral_c(p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z,
               p3x, p3y, p3z):
    """Dihedral in degrees (getTorsionFromXYZ parity): a degenerate frame
    or a cosine outside [-1, 1] gives 180 or 0 by the cosine's sign."""
    inner, denom2, det = dihedral_parts_c(p0x, p0y, p0z, p1x, p1y, p1z,
                                          p2x, p2y, p2z, p3x, p3y, p3z)
    bad = denom2 <= 0.0
    cos_t = inner / sqrt_rn(torch.where(bad, torch.ones_like(denom2),
                                        denom2))
    ang = torch.arccos(torch.clamp(cos_t, -1.0, 1.0)) * _DEG
    nan_like = bad | (torch.abs(cos_t) > 1.0)
    ang = torch.where(nan_like, torch.where(cos_t < 0, 180.0, 0.0)
                      .to(ang.dtype), ang)
    return torch.where(det < 0, -ang, ang)
