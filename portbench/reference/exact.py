# Frozen copy of foldcomp_tpu_torch/core/exact.py:1-198 at commit 5ba08cd7580a
# (5ba08cd7580a295d1f8bab06ceee779a4da42958), imports made local to portbench/reference.
# Frozen so that the yardstick stays fixed while later changes edit the
# port: the benchmark judges the port against this copy, never against
# the port's own modules. It imports nothing of the port.
"""Precision-exact (bit-compatible) host geometry & quantization kernels.

The reference's C++ computes mostly in float32 but lets specific sub-expressions
promote to double (C library acos/sqrt on float args, literal 0.5/180.0/M_PI).
Byte-identical FCZ output requires reproducing those promotions exactly, because
the per-protein float32 min/max land verbatim in the file header and every
quantization bin depends on them.

This module is vectorized numpy that mirrors the following reference semantics:

* dihedral:   f32 vector ops; final acos * 180/pi in f64, rounded to f32
              (torsion_angle.cpp:46-96)
* bond angle: f32 vector ops; acos * 180/pi in f64 -> f32 (float3d.h:55-65)
* cosine:     f32 dot/norm products; f64 division by sqrt(f64(f32 product))
              (float3d.h:36-43)
* Discretizer: f32 min/max/factors; vector discretize adds 0.5 in f64 then
              truncates (discretizer.cpp:43-53); scalar discretize truncates the
              raw f32 product (discretizer.cpp:55-57)
* continuize: pure f32 (discretizer.cpp:59-72)

These kernels run on host (numpy); the port's f32 device twins live in
foldcomp_tpu_torch.kernels.geometry.

The port's own copy of `foldcomp_tpu/core/exact.py:1`, kept line for line so
that both packages write the same bytes (tests/test_torch_standalone.py
holds the two to the same results).
"""
from __future__ import annotations

import numpy as np

F32 = np.float32
F64 = np.float64


def _cross_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float3d crossProduct (float3d.h:19-24), pure f32."""
    x = a[..., 1] * b[..., 2] - b[..., 1] * a[..., 2]
    y = a[..., 2] * b[..., 0] - b[..., 2] * a[..., 0]
    z = a[..., 0] * b[..., 1] - b[..., 0] * a[..., 1]
    return np.stack([x, y, z], axis=-1)


def _dot3_seq_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(ax*bx + ay*by) + az*bz with f32 rounding at every step (left-to-right)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cosine_theta(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """getCosineTheta (float3d.h:36-43): f64 division, result rounded to f32."""
    inner = _dot3_seq_f32(v1, v2)
    v1s = _dot3_seq_f32(v1, v1)
    v2s = _dot3_seq_f32(v2, v2)
    denom = np.sqrt((v1s * v2s).astype(F64))
    with np.errstate(invalid="ignore", divide="ignore"):
        return (inner.astype(F64) / denom).astype(F32)


def dihedral(p0, p1, p2, p3) -> np.ndarray:
    """getTorsionFromXYZ core (torsion_angle.cpp:46-96), degrees, f32.

    NaN from acos (|cos|>1 or degenerate) maps to 180 if cos<0 else 0 before the
    sign flip, exactly like the reference guard (torsion_angle.cpp:74-79).
    """
    p0, p1, p2, p3 = (np.asarray(p, dtype=F32) for p in (p0, p1, p2, p3))
    d1 = p1 - p0
    d2 = p2 - p1
    d3 = p3 - p2
    u1 = _cross_f32(d1, d2)
    u2 = _cross_f32(d2, d3)
    cos_t = cosine_theta(u1, u2)
    with np.errstate(invalid="ignore"):
        ang64 = np.arccos(cos_t.astype(F64)) * 180.0 / np.pi
    nan = np.isnan(ang64)
    ang = ang64.astype(F32)
    ang = np.where(nan, np.where(cos_t < 0, F32(180.0), F32(0.0)), ang)
    plane_beta = _cross_f32(u2, d2)
    det = _dot3_seq_f32(u1, plane_beta)
    return np.where(det < 0, -ang, ang)


def bond_angle(a, b, c) -> np.ndarray:
    """float3d angle(a,b,c) (float3d.h:55-65): 3-point angle at b, degrees, f32."""
    a, b, c = (np.asarray(p, dtype=F32) for p in (a, b, c))
    d1 = a - b
    d2 = c - b
    cos_t = cosine_theta(d1, d2)
    with np.errstate(invalid="ignore"):
        return (np.arccos(cos_t.astype(F64)) * 180.0 / np.pi).astype(F32)


def norm3(v: np.ndarray) -> np.ndarray:
    """float3d norm (float3d.h:32-34): pow() promotes to f64, sqrt f64 -> f32."""
    v64 = np.asarray(v, dtype=F32).astype(F64)
    return np.sqrt(v64[..., 0] ** 2 + v64[..., 1] ** 2 + v64[..., 2] ** 2).astype(F32)


def distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float3d distance (float3d.h:45-53): f32 diffs, f64 squares/sqrt -> f32."""
    d = (np.asarray(a, dtype=F32) - np.asarray(b, dtype=F32)).astype(F64)
    return np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2).astype(F32)


def backbone_torsions(flat_bb: np.ndarray) -> np.ndarray:
    """All consecutive-4-tuple dihedrals of the flattened backbone [3L,3].

    Equals getTorsionFromXYZ(backbone, 1) (foldcomp.cpp:484): output[i] is the
    dihedral of atoms i..i+3; the (psi, omega, phi) split is output[0::3],
    [1::3], [2::3].
    """
    flat_bb = np.asarray(flat_bb, dtype=F32)
    return dihedral(flat_bb[:-3], flat_bb[1:-2], flat_bb[2:-1], flat_bb[3:])


def backbone_bond_angles(flat_bb: np.ndarray) -> np.ndarray:
    """Nerf::getBondAngles (nerf.cpp:495-508): angle at every interior atom."""
    flat_bb = np.asarray(flat_bb, dtype=F32)
    return bond_angle(flat_bb[:-2], flat_bb[1:-1], flat_bb[2:])


class Discretizer:
    """Linear min/max quantizer with the reference's exact float semantics.

    discretizer.cpp:22-33 (factors), 43-53 (rounding vector discretize),
    55-57 (truncating scalar discretize), 59-72 (continuize).
    """

    __slots__ = ("min", "max", "n_bin", "disc_f", "cont_f")

    def __init__(self, values=None, n_bin: int = 0, *, min_=None, cont_f=None):
        self.n_bin = np.uint32(n_bin)
        if values is not None and len(values) > 0:
            v = np.asarray(values, dtype=F32)
            self.min = F32(v.min())
            self.max = F32(v.max())
            rng = self.max - self.min  # f32
            with np.errstate(divide="ignore", invalid="ignore"):
                self.disc_f = F32(F32(n_bin) / rng)
                self.cont_f = F32(rng / F32(n_bin))
        else:
            self.min = F32(0.0) if min_ is None else F32(min_)
            self.max = F32(0.0)
            self.disc_f = F32(0.0)
            self.cont_f = F32(0.0) if cont_f is None else F32(cont_f)

    @classmethod
    def from_params(cls, min_, cont_f, n_bin=0):
        return cls(min_=min_, cont_f=cont_f, n_bin=n_bin)

    def discretize(self, values) -> np.ndarray:
        """Vector path: uint32(f64(f32((v - min) * disc_f)) + 0.5), truncated."""
        v = np.asarray(values, dtype=F32)
        # NaN here is REFERENCE PARITY, not a bug: a constant stream has
        # rng=0 -> disc_f=inf (discretizer.cpp:36-41), and (v-min)=0 gives
        # 0*inf=NaN, which the C++ UB-for-NaN u32 cast lands on 0 via x86
        # cvttsd2si; errstate keeps the suite warning-clean so a NEW NaN
        # source can't hide in expected noise (VERDICT r3 #8)
        with np.errstate(invalid="ignore"):
            t = (v - self.min) * self.disc_f  # f32
        t64 = t.astype(F64) + 0.5
        t64 = np.where(np.isnan(t64), 0.0, t64)
        return np.floor(t64).astype(np.int64).astype(np.uint32)

    def discretize_trunc(self, values) -> np.ndarray:
        """Scalar path (used for side chains): truncate the raw f32 product."""
        v = np.asarray(values, dtype=F32)
        with np.errstate(invalid="ignore"):  # same rng=0 parity as above
            t = (v - self.min) * self.disc_f  # f32
        t = np.where(np.isnan(t), F32(0.0), t)
        return t.astype(np.int64).astype(np.uint32)

    def continuize(self, codes) -> np.ndarray:
        """f32((f32)code * cont_f + min) (discretizer.cpp:59-72)."""
        c = np.asarray(codes).astype(F32)
        return c * self.cont_f + self.min


class FixedAngleDiscretizer(Discretizer):
    """min=-180, max=180 (discretizer.h:89-106)."""

    def __init__(self, n_bin: int):
        super().__init__(min_=-180.0, cont_f=0.0, n_bin=n_bin)
        self.max = F32(180.0)
        self.disc_f = F32(F32(n_bin) / (self.max - self.min))
        self.cont_f = F32((self.max - self.min) / F32(n_bin))


def rmsd(coords1: np.ndarray, coords2: np.ndarray) -> float:
    """AtomCoordinate RMSD (atom_coordinate.cpp:424-434) float semantics."""
    a = np.asarray(coords1, dtype=F32).astype(F64)
    b = np.asarray(coords2, dtype=F32).astype(F64)
    # C++ accumulates f64 pow() terms into a float accumulator, term by term.
    d2 = (a - b) ** 2
    acc = F32(0.0)
    for term in d2.reshape(-1):
        acc = F32(acc + term)
    n = F32(len(a))
    return float(F32(np.sqrt(F64(F32(acc / n)))))
