"""Fused encode: the k4 kernel with the encode epilogue, and its plain
version.

Counterpart of foldcomp_tpu/kernels/pallas_encode.py: the same inputs (the
plane-major compact wire of native fcz_pack_encode_wire, or f32 atom14)
and the output contract of `_fused_parity_jit`: records u8 [B, L, 8],
bb_flags u8 [B, L], cand_bits u16 [B, L], sc_q u8 [B, L, 11],
sc_flag_bits u16 [B, L]. Residues lie on the last axis throughout.

- `merged_plain` is k4 (`_make_merged_kernel`) in plain PyTorch, operation
  for operation, and `parity_tail` the XLA epilogue of `_fused_parity_jit`
  (pallas_encode.py:370-432) in torch ops; `fused_plain` chains them. They
  are the CPU path and the CUDA kernel's oracle;
- `fused` is the wrapper: the plain version for CPU tensors, for CUDA
  tensors one checked launch of csrc/fused_encode.cu (k4_fused_encode,
  the whole function: cosines, acos, per-protein min/max, quantization,
  flags, record packing) or an error. There is no fallback from a CUDA
  tensor to the plain version;
- K4_LAUNCHES is raised by one where the kernel is launched and nowhere
  else;
- `acos` runs the kernel's one libm function alone (k4_acos), which
  chip_smoke.py holds against torch.arccos on every float in [-1, 1].

The kernel takes either loader: the compact wire (`encode_parity_fused_
planar`) or f32 atom14 (`encode_parity_f32`, for batches off the
millimetre grid, which the JAX package sends to its XLA core
`encode_parity_core`). It reads residues r < n_res only and gives a
padding slot the function's values at all-zero coordinates, which is what
every pack puts there. There is no length bound (the JAX path's
MAX_L_FUSED is a VMEM budget) and no protein block.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import tables as T
from ..core.tables import NBIN_BOND, NBIN_OMEGA, NBIN_PHI_PSI
from . import encode as E
from .bitpack import pack_records
from .encode import (bond_tail, cos_f64_emul, div1000_cr, sc_quant_tail,
                     sqrt_rn, stream_q_flags_lanes, tors_tail)
from .fused_decode import _check, _cuda_lib, _launch, _ptrs

F32 = torch.float32
I32 = torch.int32
MAX_ATOM = 14

K4_LAUNCHES = 0

_PRED_ON: dict = {}      # CUDA device -> the u8 [24, 14, 3] table on it


def reset_launch_counts() -> None:
    global K4_LAUNCHES
    K4_LAUNCHES = 0


def launch_counts() -> dict:
    return {"k4": K4_LAUNCHES}


# ---------------------------------------------------------------------------
# plain k4

def _roll1(v):
    """v[..., r] -> v[..., r+1]; the last residue wraps onto the first
    (pallas_encode._roll1), a row the epilogue masks."""
    return torch.roll(v, -1, dims=-1)


def _coords_from_wire(baseT, deltaT, present):
    """Compact wire -> [14][3] float32 [B, L] planes: base + delta where
    the slot is present, else 0, then the correctly rounded /1000."""
    pres = present.to(I32)
    xyz = []
    for k in range(MAX_ATOM):
        bit = (pres >> k) & 1
        xyz.append([div1000_cr(torch.where(
            bit == 1, deltaT[k * 3 + c].to(I32) + baseT[c].to(I32), 0))
            for c in range(3)])
    return xyz


def _dihedral_parts(d1, d2, d3):
    """Cross products, inner, denom2, sign determinant and the absolute
    sums of inner and det, in the XLA core's order."""
    d1x, d1y, d1z = d1
    d2x, d2y, d2z = d2
    d3x, d3y, d3z = d3
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
    abs_inner = (torch.abs(u1x * u2x) + torch.abs(u1y * u2y)
                 + torch.abs(u1z * u2z))
    abs_det = (torch.abs(u1x * pbx) + torch.abs(u1y * pby)
               + torch.abs(u1z * pbz))
    return inner, denom2, det, abs_inner, abs_det


def _rel(abs_sum, denom2):
    return abs_sum * torch.rsqrt(torch.clamp_min(denom2, 1e-30))


def _dihedral_cos(d1, d2, d3):
    """(cos, bits, rel) of a dihedral plane (pallas_encode._dihedral_cos):
    NaN-guard sentinels +-2; bits 1 tie, 2 guard, 4 det < 0, 32 det
    within noise."""
    inner, denom2, det, abs_inner, abs_det = _dihedral_parts(d1, d2, d3)
    bad = denom2 <= 0.0
    cos_t, tie = cos_f64_emul(inner, torch.where(bad, 1.0, denom2))
    guard_neg = bad & (denom2 == 0.0) & (inner < 0)
    cos_t = torch.where(bad, torch.where(guard_neg, -2.0, 2.0).to(F32),
                        cos_t)
    bits = (tie.to(I32) | (bad.to(I32) << 1) | ((det < 0).to(I32) << 2)
            | ((torch.abs(det) <= T.PARTS_EPS * abs_det).to(I32) << 5))
    return cos_t, bits, _rel(abs_inner, denom2)


def _bond_cos(e1, e2):
    """(cos, bits, rel) of a bond-angle plane (pallas_encode._bond_cos):
    no NaN guard; bits 8 tie, 16 guard."""
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    b_inner = e1x * e2x + e1y * e2y + e1z * e2z
    b_denom2 = (e1x * e1x + e1y * e1y + e1z * e1z) * \
        (e2x * e2x + e2y * e2y + e2z * e2z)
    b_bad = b_denom2 <= 0.0
    b_cos, b_tie = cos_f64_emul(b_inner, torch.where(b_bad, 1.0, b_denom2))
    bits = (b_tie.to(I32) << 3) | (b_bad.to(I32) << 4)
    abs_b = (torch.abs(e1x * e2x) + torch.abs(e1y * e2y)
             + torch.abs(e1z * e2z))
    return b_cos, bits, _rel(abs_b, b_denom2)


def merged_plain(res_code, wire=None, atom14=None):
    """k4 in plain PyTorch. res_code i32 [B, L]; exactly one of
    wire = (baseT i32 [3, B, L], deltaT i16 [42, B, L], present u16 [B, L])
    or atom14 f32 [B, L, 14, 3].

    Returns (tcos f32 [3, B, L], bcos f32 [3, B, L], tbits i32 [3, B, L],
    scc f32 [11, B, L], scb i32 [B, L], relt f32 [3, B, L],
    relb f32 [3, B, L]). Plane p at residue r is the torsion or bond window
    starting at backbone atom 3r+p."""
    if (wire is None) == (atom14 is None):
        raise ValueError("pass exactly one of wire and atom14")
    if wire is not None:
        xyz = _coords_from_wire(*wire)
    else:
        xyz = [[atom14[:, :, k, c] for c in range(3)]
               for k in range(MAX_ATOM)]
    xs, ys, zs = ([xyz[k][c] for k in range(MAX_ATOM)] for c in range(3))

    # backbone differences d[a] = x[a+1] - x[a], each computed once
    dN = (xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0])        # N -> CA
    dCA = (xs[2] - xs[1], ys[2] - ys[1], zs[2] - zs[1])       # CA -> C
    dC = (_roll1(xs[0]) - xs[2], _roll1(ys[0]) - ys[2],
          _roll1(zs[0]) - zs[2])                              # C -> N'
    rdN = tuple(_roll1(v) for v in dN)
    rdCA = tuple(_roll1(v) for v in dCA)
    planes_t = ((dN, dCA, dC), (dCA, dC, rdN), (dC, rdN, rdCA))
    planes_b = ((dN, dCA), (dCA, dC), (dC, rdN))
    tcos, bcos, tbits, relt, relb = [], [], [], [], []
    for p in range(3):
        cos_t, bits_t, rel_t = _dihedral_cos(*planes_t[p])
        cos_b, bits_b, rel_b = _bond_cos(tuple(-v for v in planes_b[p][0]),
                                         planes_b[p][1])
        tcos.append(cos_t)
        bcos.append(cos_b)
        tbits.append(bits_t | bits_b)
        relt.append(rel_t)
        relb.append(rel_b)

    # side chains: slots 3..13 over the predecessor table
    code = torch.clamp(res_code.long(), 0, T.PRED24.shape[0] - 1)
    pred = torch.as_tensor(T.PRED24, device=res_code.device).long()
    planes = [torch.stack(v) for v in (xs, ys, zs)]           # [14, B, L]
    scc = []
    scb = torch.zeros(res_code.shape, dtype=I32, device=res_code.device)
    for k in range(3, MAX_ATOM):
        p0, p1, p2 = ([P.gather(0, pred[code, k, j][None])[0]
                       for P in planes] for j in range(3))
        d1 = tuple(b - a for a, b in zip(p0, p1))
        d2 = tuple(b - a for a, b in zip(p1, p2))
        d3 = (xs[k] - p2[0], ys[k] - p2[1], zs[k] - p2[2])
        inner, denom2, det, _, _ = _dihedral_parts(d1, d2, d3)
        bad = denom2 <= 0.0
        scc.append(inner / sqrt_rn(torch.where(bad, 1.0, denom2)))
        j = k - 3
        scb = scb | (bad.to(I32) << j) | ((det < 0).to(I32) << (11 + j))
    return (torch.stack(tcos), torch.stack(bcos), torch.stack(tbits),
            torch.stack(scc), scb, torch.stack(relt), torch.stack(relb))


# ---------------------------------------------------------------------------
# epilogue, plain


def _to_bits(planes, shift=0):
    acc = torch.zeros_like(planes[0], dtype=I32)
    for s, p in enumerate(planes):
        acc = acc | (p.to(I32) << (s + shift))
    return acc


def parity_tail(parts, res_code, n_res):
    """The lanes-layout epilogue of _fused_parity_jit: acos, error
    budgets, per-protein min/max candidates, quantization, rescue flags
    and record packing. parts: merged_plain's 7 planes; res_code i32
    [B, L]; n_res i32 [B]."""
    tcos, bcos, tbits, scc, scb, relt, relb = parts
    l = res_code.shape[1]
    t_ang, t_err = zip(*(tors_tail(tcos[p], tbits[p], relt[p])
                         for p in range(3)))
    b_ang, b_err = zip(*(bond_tail(bcos[p], tbits[p], relb[p])
                         for p in range(3)))

    iota = torch.arange(l, dtype=I32, device=res_code.device)[None, :]
    amask = iota < (n_res[:, None] - 1)
    # stream s at residue i: phi = torsion plane 2, psi = 0, omega = 1;
    # n_ca_c = bond plane 0 at i+1, ca_c_n = plane 1, c_n_ca = plane 2
    streams = [
        (t_ang[2], t_err[2], NBIN_PHI_PSI),
        (t_ang[0], t_err[0], NBIN_PHI_PSI),
        (t_ang[1], t_err[1], NBIN_OMEGA),
        (_roll1(b_ang[0]), _roll1(b_err[0]), NBIN_BOND),
        (b_ang[1], b_err[1], NBIN_BOND),
        (b_ang[2], b_err[2], NBIN_BOND),
    ]
    qs, flags, cmins, cmaxs = [], [], [], []
    for ang_s, err_s, nbin in streams:
        q, fl, cmn, cmx = stream_q_flags_lanes(ang_s, err_s, amask, nbin)
        qs.append(torch.where(amask, q, 0))
        flags.append(fl)
        cmins.append(cmn)
        cmaxs.append(cmx)

    res_mask = iota < n_res[:, None]
    records = pack_records(torch.where(res_mask, res_code, 0), *qs)
    bb_flags = _to_bits(flags).to(torch.uint8)
    cand_bits = (_to_bits(cmins) | _to_bits(cmaxs, 8)).to(torch.uint16)

    sc_qs, sc_flags = [], []
    for j in range(11):
        q, fl = sc_quant_tail(scc[j], ((scb >> (11 + j)) & 1) > 0,
                              ((scb >> j) & 1) > 0)
        sc_qs.append(q)
        sc_flags.append(fl)
    return dict(records=records, bb_flags=bb_flags, cand_bits=cand_bits,
                sc_q=torch.stack(sc_qs, dim=-1),
                sc_flag_bits=_to_bits(sc_flags).to(torch.uint16))


def fused_plain(res_code, n_res, wire=None, atom14=None):
    """The fused kernel's function in plain PyTorch:
    parity_tail(merged_plain(...)). Same arguments and results as fused."""
    return parity_tail(merged_plain(res_code, wire, atom14), res_code,
                       n_res)


# ---------------------------------------------------------------------------
# the kernel's wrapper

# The epilogue's float constants in the kernel's order (TailK in
# csrc/fused_encode.cu), as torch rounds the Python scalars of the plain
# version to float32; 1/nbin in float32, as torch divides a CUDA tensor by
# a Python float.
_NBINS = (NBIN_PHI_PSI, NBIN_PHI_PSI, NBIN_OMEGA, NBIN_BOND, NBIN_BOND,
          NBIN_BOND)
_TAIL_CONSTS = np.array(
    [E._EPS, E._DEG, E._BIGERR, E._BIGF, 5e-7, 2e-5, 1e-12, 1e-4,
     E._SC_DEG, E._SC_DISC_F, E._SC_TOL_F, 2e-4, *_NBINS]
    + [np.float32(1.0) / np.float32(n) for n in _NBINS], np.float32)
# the staging of one slot: (angle, error) of six streams
_STAGE = 12


def _pred_table(dev):
    """The u8 [24, 14, 3] predecessor table on CUDA device `dev`, made
    once per device: the kernel copies it into shared memory."""
    tab = _PRED_ON.get(dev)
    if tab is None:
        tab = _PRED_ON.setdefault(dev, torch.as_tensor(
            T.PRED24, dtype=torch.uint8, device=dev).contiguous())
    return tab


def fused(res_code, n_res, wire=None, atom14=None):
    """The fused encode. res_code i32 [B, L]; n_res i32 [B] (each <= L);
    exactly one of wire = (baseT i32 [3, B, L], deltaT i16 [42, B, L],
    present u16 [B, L]) or atom14 f32 [B, L, 14, 3].

    The plain version for CPU tensors, one launch of the CUDA kernel for
    CUDA tensors (ValueError for any other device). Returns dict(records,
    bb_flags, cand_bits, sc_q, sc_flag_bits) as parity_tail does."""
    global K4_LAUNCHES
    if (wire is None) == (atom14 is None):
        raise ValueError("pass exactly one of wire and atom14")
    if res_code.device.type == "cpu":
        return fused_plain(res_code, n_res, wire, atom14)
    lib = _cuda_lib(res_code)
    if res_code.dim() != 2:
        raise ValueError(f"res_code: shape {tuple(res_code.shape)}, "
                         "expected [B, L]")
    b, l = res_code.shape
    dev = res_code.device
    _check("res_code", res_code, I32, (b, l), dev)
    _check("n_res", n_res, I32, (b,), dev)
    if wire is not None:
        baseT, deltaT, present = wire
        _check("baseT", baseT, I32, (3, b, l), dev)
        _check("deltaT", deltaT, torch.int16, (42, b, l), dev)
        _check("present", present, torch.uint16, (b, l), dev)
        ins = _ptrs(baseT, deltaT, present, None)
    else:
        _check("atom14", atom14, F32, (b, l, MAX_ATOM, 3), dev)
        ins = _ptrs(None, None, None, atom14)
    u8, u16 = torch.uint8, torch.uint16
    outs = dict(records=torch.empty((b, l, 8), dtype=u8, device=dev),
                bb_flags=torch.empty((b, l), dtype=u8, device=dev),
                cand_bits=torch.empty((b, l), dtype=u16, device=dev),
                sc_q=torch.empty((b, l, 11), dtype=u8, device=dev),
                sc_flag_bits=torch.empty((b, l), dtype=u16, device=dev))
    if b and l:
        # each slot's angle and error of six streams; freed on return,
        # when the launch is queued: its memory is reused only by work
        # ordered after it on the stream
        scratch = torch.empty((b, _STAGE, l), dtype=F32, device=dev)
        _launch(lib.fe_encode, "k4 fused encode", dev, *ins,
                *_ptrs(res_code, n_res, _pred_table(dev)),
                _TAIL_CONSTS.ctypes.data, len(_TAIL_CONSTS),
                *_ptrs(scratch, *outs.values()), b, l)
        K4_LAUNCHES += 1
    return outs


def acos(x):
    """The fused kernel's acos (one __device__ function) over a float32
    tensor: torch.arccos for a CPU tensor, the kernel k4_acos for a CUDA
    one. chip_smoke.py holds it against torch.arccos on the card."""
    if x.device.type == "cpu":
        return torch.arccos(x)
    lib = _cuda_lib(x)
    _check("x", x, F32, tuple(x.shape), x.device)
    y = torch.empty_like(x)
    if x.numel():
        _launch(lib.fe_acos, "k4 acos", x.device, *_ptrs(x, y), x.numel())
    return y


# ---------------------------------------------------------------------------
# entry points

def encode_parity_fused_planar(baseT, deltaT, present, res_code, n_res,
                               n_out: int | None = None):
    """Parity encode from the plane-major compact wire (baseT i32
    [3, B, L], deltaT i16 [42, B, L], present u16 [B, L]; res_code i32
    [B, L], n_res i32 [B]) through the fused kernel. The tensors' device
    picks the path. Outputs are sliced to the first n_out proteins when
    given."""
    out = fused(res_code, n_res, wire=(baseT, deltaT, present))
    if n_out is None or n_out == res_code.shape[0]:
        return out
    return {k: v[:n_out] for k, v in out.items()}


def encode_parity_f32(atom14, res_code, n_res):
    """Parity encode from f32 atom14 [B, L, 14, 3] (batches off the
    millimetre grid) through the fused kernel's f32 loader."""
    return fused(res_code, n_res, atom14=atom14)
