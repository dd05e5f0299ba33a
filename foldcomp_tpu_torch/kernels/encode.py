"""Float numerics of the device encode, operation for operation.

Counterparts of foldcomp_tpu/kernels/encode.py (`_div1000_cr`, `_two_prod`,
`_cos_f64_emul`, `_ang_err_deg`, `_sc_quant_tail`) and of the lanes-layout
tails of foldcomp_tpu/kernels/pallas_encode.py (`_stream_q_flags_lanes`,
`_tors_tail`, `_bond_tail`), on float32 tensors. The plain k4
(fused_encode.merged_plain) and the epilogue (fused_encode.parity_tail)
share them; the CUDA kernel (csrc/fused_encode.cu, k4 with the epilogue)
repeats the same operations in the same order.

Every expression keeps the JAX operand order. torch runs each elementwise
op as its own kernel, so nothing is contracted into an FMA, and a Python
float operand is rounded to float32 before the op, as the np.float32
constants are on the JAX side. torch.round rounds half to even as
jnp.round does; `.to(torch.int32)` truncates as astype(int32) does.
Square roots go through sqrt_rn: torch's CPU sqrt is not correctly
rounded, and the cosines depend on an IEEE one.

parts_eps is the one constant tables.PARTS_EPS on every device (the JAX
package picks 0 on a TPU, where its parts are bit-equal to the C order),
so the `eps == 0` branches of the JAX tails have no counterpart.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import tables as T

F32 = torch.float32
I32 = torch.int32

_EPS = float(np.float32(T.PARTS_EPS))
_DEG = float(T.DEG)
_BIGERR = float(T.BIGERR)
_BIGF = float(T.BIGF_LANES)
_SC_DISC_F = float(T.SC_DISC_F)
# _sc_quant_tail's deg and its tolerance factor, folded in float32 in the
# JAX order (_SC_DISC_F * deg) * 1e-6
_SC_DEG = float(np.float32(57.29577951308232))
_SC_TOL_F = float(T.SC_DISC_F * np.float32(_SC_DEG) * np.float32(1e-6))


def sqrt_rn(x):
    """Correctly rounded float32 sqrt, as IEEE sqrtf and XLA's sqrt are.

    torch.sqrt is on CUDA. On the CPU its float32 sqrt is off by one ulp
    on ~0.6% of inputs, and by more on some first calls of a thread, so
    there the float64 sqrt rounded to float32, within one ulp, is moved by
    one ulp where the exact square of a half-way point says so: a half-way
    point has 25 significant bits, so float64 holds its square exactly."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    xd = x.double()
    s = torch.sqrt(xd).float()
    up = torch.nextafter(s, torch.full_like(s, float("inf")))
    dn = torch.nextafter(s, torch.zeros_like(s))
    mid_up = (s.double() + up.double()) * 0.5
    mid_dn = (s.double() + dn.double()) * 0.5
    s = torch.where(mid_up * mid_up < xd, up, s)
    return torch.where(mid_dn * mid_dn > xd, dn, s)


def div1000_cr(xi):
    """Correctly rounded float32 xi / 1000 for int |xi| < 2**24 from exact
    mul/add only (encode.py `_div1000_cr`): a Dekker 12+12 split makes the
    residual exact, and two refinements reach the rounded quotient."""
    xf = xi.to(F32)
    c = float(np.float32(0.001))

    def refine(q):
        s = q * 4097.0
        hi = s - (s - q)
        lo = q - hi
        r = (xf - hi * 1000.0) - lo * 1000.0
        return q + r * c

    return refine(refine(xf * c))


def two_prod(a, b):
    """Dekker product: a*b = p + e exactly in float32, without an FMA."""
    p = a * b
    s = a * 4097.0
    ah = s - (s - a)
    al = a - ah
    t = b * 4097.0
    bh = t - (t - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def cos_f64_emul(inner, denom2):
    """float32 round of (double)inner / sqrt((double)denom2) in double-f32,
    and the rows whose quotient lies within ~2**-44 of a float32 rounding
    boundary (ties). denom2 must be > 0."""
    s = sqrt_rn(denom2)
    p, pe = two_prod(s, s)
    r = (denom2 - p) - pe
    e = r / (s + s)
    q0 = inner / s
    qp, qpe = two_prod(q0, s)
    rr = ((inner - qp) - qpe) - q0 * e
    corr = rr / s
    c = q0 + corr
    resid = (q0 - c) + corr
    ulp = torch.abs(c) * 2.0 ** -23 + float(np.float32(1e-38))
    tie = torch.abs(resid) > float(np.float32(0.499)) * ulp
    return c, tie


def ang_err_deg(delta, amp, ang):
    """Angle error bound (degrees) for a +-delta cosine perturbation:
    min(first order, Hoelder-1/2) plus the acos slack."""
    base = torch.abs(ang) * float(np.float32(5e-7)) + float(np.float32(2e-5))
    return _DEG * torch.minimum(delta * amp, sqrt_rn(2.0 * delta)) + base


def sc_quant_tail(cos_t, det_neg, bad):
    """Side-chain cosine -> (255-bin truncating code u8, rescue flag u8)."""
    ang = torch.arccos(torch.clamp(cos_t, -1.0, 1.0)) * _SC_DEG
    nan_like = bad | (torch.abs(cos_t) > 1.0)
    ang = torch.where(nan_like,
                      torch.where(cos_t < 0, 180.0, 0.0).to(F32), ang)
    ang = torch.where(det_neg, -ang, ang)
    t = (ang + 180.0) * _SC_DISC_F
    t = torch.where(torch.isnan(t) | (t < 0), 0.0, t)
    q = torch.clamp(t.to(I32), 0, 255).to(torch.uint8)
    amp = torch.rsqrt(torch.clamp_min(1.0 - cos_t * cos_t,
                                      float(np.float32(1e-12))))
    tol = _SC_TOL_F * (1.0 + amp) + float(np.float32(2e-4))
    dist = torch.abs(t - torch.round(t))
    flag = ((dist < tol) | nan_like).to(torch.uint8)
    return q, flag


def stream_q_flags_lanes(ang, err, amask, nbin):
    """Per-stream quantization, rescue flags and min/max candidates with
    residues on the last axis. ang/err/amask [B, L]; nbin a float32 value.
    Returns (q i32, flag, cand_min, cand_max)."""
    nbin = float(nbin)
    lo = torch.where(amask, ang - err, _BIGF)
    hi = torch.where(amask, ang + err, _BIGF)
    c_min = torch.amin(hi, dim=-1, keepdim=True)
    cand_min = amask & (lo <= c_min)
    lo2 = torch.where(amask, ang - err, -_BIGF)
    hi2 = torch.where(amask, ang + err, -_BIGF)
    c_max = torch.amax(lo2, dim=-1, keepdim=True)
    cand_max = amask & (hi2 >= c_max)

    vmin = torch.amin(torch.where(amask, ang, _BIGF), dim=-1, keepdim=True)
    vmax = torch.amax(torch.where(amask, ang, -_BIGF), dim=-1, keepdim=True)
    disc_f = nbin / (vmax - vmin)
    t = (ang - vmin) * disc_f
    # floor(t + 0.5) as int32 with XLA's saturating conversion (a float
    # cast out of int32 range is undefined in C); NaN and negative t give
    # 0, and every non-finite t is flagged below
    qf = torch.floor(t + 0.5)
    qf = torch.where(torch.isnan(t) | (t < 0), 0.0, qf)
    q = torch.where(qf >= 2.0 ** 31, 2 ** 31 - 1,
                    torch.clamp_max(qf, 2.0 ** 31 - 128).to(I32))

    zero = torch.zeros((), dtype=F32, device=ang.device)
    err_min = torch.amax(torch.where(cand_min, err, zero), dim=-1,
                         keepdim=True)
    err_max = torch.amax(torch.where(cand_max, err, zero), dim=-1,
                         keepdim=True)
    tol = disc_f * (err + err_min) \
        + (torch.abs(t) / nbin) * (disc_f * (err_min + err_max)) \
        + torch.abs(t) * float(np.float32(5e-7)) + float(np.float32(1e-4))
    half = t + 0.5
    dist = torch.abs(half - torch.round(half))
    flag = (dist <= tol) | ~torch.isfinite(t) | ~torch.isfinite(tol)
    return q, flag & amask, cand_min, cand_max


def _cos_tail(c, rel):
    """(angle in degrees, acos amplification, cos noise delta) of a cosine
    plane: the shared head of tors_tail and bond_tail."""
    cos_c = torch.clamp(c, -1.0, 1.0)
    ang = torch.arccos(cos_c) * _DEG
    amp = torch.rsqrt(torch.clamp_min(1.0 - cos_c * cos_c,
                                      float(np.float32(1e-12))))
    delta = _EPS * (rel + torch.abs(cos_c))
    return ang, amp, delta


def tors_tail(tc, tb, rel):
    """Torsion cosine plane -> (angle, err) [B, L] (pallas_encode
    `_tors_tail`): tb bits 1 tie, 2 guard, 4 det < 0, 32 det in noise."""
    tie = (tb & 1) > 0
    bad = (tb & 2) > 0
    detneg = (tb & 4) > 0
    ang, amp, delta = _cos_tail(tc, rel)
    nan_like = torch.abs(tc) > 1.0
    ang = torch.where(nan_like, torch.where(tc < 0, 180.0, 0.0).to(F32),
                      ang)
    ang = torch.where(detneg, -ang, ang)
    big = tie | bad | ((tb & 32) > 0) | (torch.abs(tc) >= 1.0 - delta)
    err = torch.where(big, _BIGERR, ang_err_deg(delta, amp, ang))
    return ang, err


def bond_tail(bc, tb, rel):
    """Bond cosine plane -> (angle, err) [B, L] (pallas_encode
    `_bond_tail`): tb bits 8 tie, 16 guard; no NaN guard."""
    b_tie = (tb & 8) > 0
    b_bad = (tb & 16) > 0
    ang, amp, delta = _cos_tail(bc, rel)
    big = b_tie | b_bad | (torch.abs(bc) >= 1.0 - delta)
    err = torch.where(big, _BIGERR, ang_err_deg(delta, amp, ang))
    return ang, err
