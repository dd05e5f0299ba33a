"""Plain PyTorch versions of the decode's geometry helpers.

Component form (one tensor per coordinate component, any common shape),
operation for operation the JAX functions they mirror, so that the CPU
path and the CUDA kernels (csrc/fused_decode.cu, same order) agree with
the reference to float32 rounding:

  place_atom_c    <- foldcomp_tpu/kernels/geometry.py:78-112
  bond_angle_cs   <- foldcomp_tpu/kernels/pallas_decode.py:72-87
  place_atom_cs   <- foldcomp_tpu/kernels/pallas_decode.py:93-117

Scalar arguments are Python floats: torch casts them to float32, the
tensors' type, exactly (every constant is a float32 value).
"""
from __future__ import annotations

import torch

from ..core.tables import RADK

_RADK = float(RADK)
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
