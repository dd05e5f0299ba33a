"""Fused ragged-lane decode: k0 the kernel inputs, k1 tails, k2 backbone
(the seed roll inside), k3 side chains, or on the bb wire k2 with its
24-byte epilogue.

Counterpart of foldcomp_tpu/kernels/pallas_decode.py `decode_seg_fused`
(wire "full" and "bb") and `decode_seg_fused_classes` (width classes),
both `decode_lanes` here: the same inputs (the arrays of codec/batch.py
pack_decode_batch_lanes, or of batch_host.split_lanes_classes) and the
same output contracts. Each kernel has

- a plain PyTorch version (`*_plain`), operation for operation the Pallas
  kernel's math (the bb epilogue: the XLA epilogue's): the CPU path and
  the CUDA kernel's oracle;
- a wrapper (`prep`, `tails` and `tails_classes`, `backbone` and
  `backbone_classes`, `backbone_only`, `sidechain`) that runs the plain
  version for CPU tensors, and for CUDA tensors checks its inputs and
  launches the hand-written kernel of csrc/fused_decode.cu, or raises.
  There is no fallback from a CUDA tensor to the plain version;
- a launch counter, raised by one where the wrapper launches its kernel
  and nowhere else: PREP_LAUNCHES k0_prep (PREP_BB_LAUNCHES those of its
  launches in bb mode, counted in PREP_LAUNCHES too) and K1_LAUNCHES
  k1_tails and K2_LAUNCHES k2_backbone, the full wire (each one launch
  over every width class of a batch; K2_CLASSES adds up the classes of
  k2's launches), K2BB_LAUNCHES k2_backbone_bb (the bb wire's one
  kernel), K3_LAUNCHES k3_sidechain (K3_STAGED those of its launches that
  read k2's rows where k2 staged them, counted in K3_LAUNCHES too).

k2 hands k3 its rows as k2_backbone left them (`Staged`): each lane's
rows at its thread's column, in k0's lane order; k3 reads them there, and
nothing copies them to the lanes' columns.

One pipeline, `decode_lanes`, decodes a batch of one or more width
classes on either wire (`decode_seg_fused` is a call of it with one
class): it lays the classes out once (`class_layout`), which
k0, k1 and k2 all read, checks its inputs once, at k0, and launches the
kernels on the views k0's workspace holds, each step a span (tracing):
`decode.prep` (attribute `wire`, "full" or "bb"), `decode.k1`,
`decode.k2` (attribute `classes`), `decode.k3`.

Layouts are lane-minor ([rows, NL]) as in the pack. Nothing here needs
autograd or randomness.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import tracing
from ..core import tables as T
from .geometry import bond_angle_cs, place_atom_c, place_atom_cs

F32 = torch.float32

PREP_LAUNCHES = 0
PREP_BB_LAUNCHES = 0    # k0 in bb mode: also counted in PREP
K1_LAUNCHES = 0
K2_LAUNCHES = 0
K2_CLASSES = 0          # the classes k2's launches took, one or more each
K2BB_LAUNCHES = 0       # the bb call, one kernel: not counted in K2
K3_LAUNCHES = 0
K3_STAGED = 0           # k3 on k2's staged rows: also counted in K3

_C_TO_N = float(T.C_TO_N)
_CA_TO_C = float(T.CA_TO_C)
_N_TO_CA = float(T.N_TO_CA)
_SC_CONT = float(T.SC_CONT)
_SC_MIN = float(T.SC_MIN)


def reset_launch_counts() -> None:
    global PREP_LAUNCHES, PREP_BB_LAUNCHES, K1_LAUNCHES, K2_LAUNCHES, \
        K2_CLASSES, K2BB_LAUNCHES, K3_LAUNCHES, K3_STAGED
    PREP_LAUNCHES = PREP_BB_LAUNCHES = K1_LAUNCHES = K2_LAUNCHES = \
        K2_CLASSES = K2BB_LAUNCHES = K3_LAUNCHES = K3_STAGED = 0


def launch_counts() -> dict:
    return {"prep": PREP_LAUNCHES, "prep_bb": PREP_BB_LAUNCHES,
            "k1": K1_LAUNCHES, "k2": K2_LAUNCHES, "k2_classes": K2_CLASSES,
            "k2_bb": K2BB_LAUNCHES, "k3": K3_LAUNCHES,
            "k3_staged": K3_STAGED}


# ---------------------------------------------------------------------------
# _class_prep (pallas_decode.py:405-437)

def class_prep(seg_records, mins_lane, cont_lane, sc_codes_seg, fwd9, rev9,
               seg_m, wire: str = "full") -> dict:
    """Kernel inputs from the pack's arrays: the residue-code plane
    (byte0 >> 3) that k3 reads, the quantizer rows in kernel field order,
    and tat = 3 * seg_m. Records and side-chain codes stay packed u8; the
    kernels unpack them, and k1 and k2 derive the N-CA length from the
    records themselves (n_ca_lengths is its plain version). wire "bb":
    no k3 runs, so neither the code plane nor the side-chain codes
    (sc_codes_seg may be None) are among the keys. With lane_order, the
    plain version of k0 (`prep`)."""
    dev = seg_records.device
    cols = torch.as_tensor(T.FIELD_COLS, device=dev)
    out = dict(
        recs=seg_records.contiguous(),
        fwd9=fwd9.contiguous(), rev9=rev9.contiguous(),
        tat=(3 * seg_m).to(torch.int32).contiguous(),
        mins6=mins_lane.t()[cols].contiguous(),
        cont6=cont_lane.t()[cols].contiguous())
    if wire != "bb":
        out.update(code=(seg_records[0].to(torch.int32) >> 3).contiguous(),
                   sct=sc_codes_seg.contiguous())
    return out


def n_ca_lengths(recs):
    """[SEG, NL] f32 N-CA bond length of each record row: proline's is
    shorter (residue code byte0 >> 3 == PRO_CODE). _class_prep's blca."""
    pro = (recs[0].to(torch.int32) >> 3) == T.PRO_CODE
    return torch.where(pro, torch.tensor(float(T.PRO_N_TO_CA), dtype=F32,
                                         device=recs.device),
                       torch.tensor(float(T.N_TO_CA), dtype=F32,
                                    device=recs.device))


class LaneOrder:
    """The order k1 and k2 walk a batch's lanes in: perm, i32 [NL], a
    permutation of range(NL). The kernels index the lanes by it, so only
    lane_order and prep (k0, lane_order's order) make one, and the
    wrappers take no other order."""
    __slots__ = ("perm",)

    def __init__(self, perm):
        self.perm = perm


class Staged:
    """One class's backbone rows as k2 leaves them for k3: planes x, y, z
    [3*SEG, NL] f32 holding lane l's rows at column pos[l] (pos i32 [NL];
    None: at column l). On a CUDA device k2 writes the planes at its
    threads' columns, in k0's lane order, and pos is k2's; on the CPU the
    planes are the plain version's lane rows and pos is None. rows()
    gives the rows in lane columns, for the checks; no pipeline path
    calls it."""
    __slots__ = ("x", "y", "z", "pos")

    def __init__(self, x, y, z, pos=None):
        self.x, self.y, self.z = x, y, z
        self.pos = pos

    def rows(self):
        """The blended rows [3*SEG, NL] x3 with lane l at column l."""
        planes = (self.x, self.y, self.z)
        if self.pos is None:
            return planes
        p = self.pos.long()
        return tuple(t.index_select(1, p) for t in planes)


def lane_order(tat, by_length: bool = True) -> LaneOrder:
    """The lanes by tat, longest first, stable (the lanes of one length in
    pack order), so that a warp's lanes have one length; by_length False
    gives the pack order itself."""
    if not by_length:
        return LaneOrder(torch.arange(tat.numel(), dtype=torch.int32,
                                      device=tat.device))
    return LaneOrder(torch.argsort(tat, descending=True, stable=True)
                     .to(torch.int32))


# ---------------------------------------------------------------------------
# plain versions

def _unpack_ang6(recs, mins6, cont6):
    """[8, SEG, NL] u8 byte planes -> [6, SEG, NL] f32 angles in field
    order (psi, omega, phi, n_ca_c, ca_c_n, c_n_ca), q * cont + min
    (_unpack_ang6_into, pallas_decode.py:127-151)."""
    b = recs.to(torch.int32)
    qs = ((b[2] << 4) | (b[3] >> 4),
          ((b[0] & 0x7) << 8) | b[1],
          ((b[3] & 0xF) << 8) | b[4],
          b[7], b[5], b[6])
    return torch.stack([q.to(F32) * cont6[f] + mins6[f]
                        for f, q in enumerate(qs)])


def _forward_rows(ang6, blca, seed):
    """Forward NeRF rows [3*SEG, NL] x3 from a [9, NL] seed
    (_fwd_scan_into, pallas_decode.py:154-183)."""
    seg = ang6.shape[1]
    ax, ay, az, bx, by, bz, cx, cy, cz = seed.unbind(0)
    xs, ys, zs = [ax, bx, cx], [ay, by, cy], [az, bz, cz]
    for k in range(seg - 1):
        psi, omega, phi, ncac, cacn, cnca = ang6[:, k]
        nx, ny, nz = place_atom_c(ax, ay, az, bx, by, bz, cx, cy, cz,
                                  _C_TO_N, cacn, psi)
        kx, ky, kz = place_atom_c(bx, by, bz, cx, cy, cz, nx, ny, nz,
                                  blca[k], cnca, omega)
        qx, qy, qz = place_atom_c(cx, cy, cz, nx, ny, nz, kx, ky, kz,
                                  _CA_TO_C, ncac, phi)
        xs += [nx, kx, qx]
        ys += [ny, ky, qy]
        zs += [nz, kz, qz]
        ax, ay, az, bx, by, bz, cx, cy, cz = (nx, ny, nz, kx, ky, kz,
                                              qx, qy, qz)
    return torch.stack(xs), torch.stack(ys), torch.stack(zs)


def tails_plain(recs, blca, seed, ranc, tat, mins6, cont6):
    """k1: forward scan + blended tail, [9, NL] rows comp*3 + kk
    (_make_tails_kernel, pallas_decode.py:186-224)."""
    rows = _forward_rows(_unpack_ang6(recs, mins6, cont6), blca, seed)
    t = rows[0].shape[0]
    tf = torch.clamp_min(tat.to(F32), 1.0)
    out = [None] * 9
    for kk in range(3):
        r = tat.to(torch.int64) - 3 + kk
        hit = (r >= 0) & (r < t)
        idx = r.clamp(0, t - 1)[None]
        w_r = (tat - 3 + kk).to(F32)
        w_f = tf - w_r
        for comp in range(3):
            acc = torch.where(hit, rows[comp].gather(0, idx)[0], 0.0)
            out[comp * 3 + kk] = (acc * w_f + ranc[kk * 3 + comp] * w_r) / tf
    return torch.stack(out)


def backbone_plain(recs, blca, seed, ranc, tat, mins6, cont6):
    """k2: forward scan from the seeds, reverse C->N sweep seeded by the
    stored anchors, positional blend -> rows [3*SEG, NL] x3
    (_make_backbone_kernel, pallas_decode.py:227-296)."""
    ang6 = _unpack_ang6(recs, mins6, cont6)
    fx, fy, fz = _forward_rows(ang6, blca, seed)
    t = fx.shape[0]
    zero = torch.zeros_like(fx[0])
    v1 = v2 = v3 = (zero, zero, zero)
    bls = (_C_TO_N, _CA_TO_C, _N_TO_CA)
    rev = [None] * t
    for i in range(t):
        r = t - 1 - i
        rc = min(r, t - 3)
        cos_a, sin_a = bond_angle_cs(fx[rc], fy[rc], fz[rc],
                                     fx[rc + 1], fy[rc + 1], fz[rc + 1],
                                     fx[rc + 2], fy[rc + 2], fz[rc + 2])
        p = place_atom_cs(*v3, *v2, *v1, bls[i % 3], cos_a, sin_a,
                          ang6[r % 3, r // 3])
        is_c, is_ca, is_n = r == tat - 1, r == tat - 2, r == tat - 3
        active = r <= tat - 4
        w = tuple(
            torch.where(active, p[c],
                        torch.where(is_c, ranc[6 + c],
                                    torch.where(is_ca, ranc[3 + c],
                                                torch.where(is_n, ranc[c],
                                                            zero))))
            for c in range(3))
        rev[r] = w
        v1, v2, v3 = w, v1, v2
    tatf = tat.to(F32)
    tf = torch.clamp_min(tatf, 1.0)
    w_r = torch.arange(t, dtype=F32, device=fx.device)[:, None]
    w_f = tatf[None] - w_r
    return tuple((f * w_f + torch.stack([w[c] for w in rev]) * w_r) / tf
                 for c, f in enumerate((fx, fy, fz)))


def refine_seeds(tails9, fwd9, is_first, prev=None):
    """Seed roll (pallas_decode.py:596-610): lane s is seeded with lane
    s-1's blended tail unless it is its protein's first segment. Ragged
    lanes are protein-contiguous, so the shift is a roll by one lane.
    With prev (i32 [NL], width classes, pallas_decode.py:654-670) lane s
    takes column prev[s] of tails9, the tails of every class [9, NL_total].
    tails9 rows are comp*3 + atom; seeds rows atom*3 + comp."""
    nl = fwd9.shape[1]
    src = torch.roll(tails9, 1, dims=1) if prev is None \
        else tails9[:, prev.long()]
    rolled = src.reshape(3, 3, nl).transpose(0, 1).reshape(9, nl)
    return torch.where(is_first[None], fwd9, rolled).contiguous()


def backbone_rolled_plain(recs, tails9, fwd9, is_first, ranc, tat, mins6,
                          cont6, prev=None):
    """The function k2 computes: the seed roll (refine_seeds, by prev where
    given; tails9 None means refine_iters 1, seeded by fwd9), the N-CA
    lengths of the records, then backbone_plain."""
    seeds = fwd9 if tails9 is None \
        else refine_seeds(tails9, fwd9, is_first, prev)
    return backbone_plain(recs, n_ca_lengths(recs), seeds, ranc, tat, mins6,
                          cont6)


def bb_epilogue_plain(bx, by, bz, nl_out=None):
    """The bb wire's epilogue (_run_backbone_only, pallas_decode.py:561-570)
    on backbone rows [3*SEG, NL] x3: off i16 [NL_out, SEG, 6], N and C as
    0.1 mA offsets from CA (round(d * 10000) clipped to +-32767), and ca
    f32 [NL_out, SEG, 3]."""
    t, nl = bx.shape
    seg = t // 3
    nlo = nl if nl_out is None else min(int(nl_out), nl)
    bb = torch.stack([b[:, :nlo].reshape(seg, 3, nlo) for b in (bx, by, bz)],
                     dim=2)                               # [SEG, atom, c, L]
    bb_t = bb.permute(3, 0, 1, 2)                         # [L, SEG, atom, c]
    ca = bb_t[:, :, 1]
    off = torch.cat([bb_t[:, :, 0], bb_t[:, :, 2]], dim=2) \
        - torch.cat([ca, ca], dim=2)
    off = torch.clamp(torch.round(off * 10000.0), -32767.0, 32767.0) \
        .to(torch.int16)
    return off.contiguous(), ca.contiguous()


def sidechain_plain(bx, by, bz, code, sct, nl_out=None):
    """k3: side chains + compact wire (_make_sidechain_kernel,
    pallas_decode.py:338-393) with the 32-code table lookup of
    core/tables.py in place of the where-chains, written in the final
    layout: off i16 [NL_out, SEG, 42] ((k, c)-major mA offsets from CA)
    and ca f32 [NL_out, SEG, 3]."""
    t, nl = bx.shape
    seg = t // 3
    nlo = nl if nl_out is None else min(int(nl_out), nl)
    dev = bx.device
    pred = torch.as_tensor(T.PRED32, device=dev).long()
    blen = torch.as_tensor(T.BLEN32, device=dev)
    bang = torch.as_tensor(T.BANG32, device=dev)
    cd = code[:, :nlo].long()
    planes = []
    for b in (bx, by, bz):
        p = torch.empty((14, seg, nlo), dtype=F32, device=dev)
        p[:3] = b[:, :nlo].reshape(seg, 3, nlo).transpose(0, 1)
        planes.append(p)
    X, Y, Z = planes
    for k in range(3, 14):
        pk = pred[cd, k]                                    # [SEG, NLo, 3]
        sel = [[P.gather(0, pk[..., j][None])[0] for P in planes]
               for j in range(3)]
        tor = sct[:, k - 3, :nlo].to(torch.int32).to(F32) * _SC_CONT \
            + _SC_MIN
        ox, oy, oz = place_atom_c(*sel[0], *sel[1], *sel[2],
                                  blen[cd, k], bang[cd, k], tor)
        X[k], Y[k], Z[k] = ox, oy, oz
    off = torch.stack([X - X[1], Y - Y[1], Z - Z[1]])      # [3, 14, SEG, L]
    off = torch.clamp(torch.round(off * 1000.0), -32767.0, 32767.0) \
        .to(torch.int16)
    off = off.permute(3, 2, 1, 0).reshape(nlo, seg, 42).contiguous()
    ca = torch.stack([X[1], Y[1], Z[1]]).permute(2, 1, 0).contiguous()
    return off, ca




# ---------------------------------------------------------------------------
# the class layout

# k0's launch (fused_decode.cu k0_prep): K0_THREADS threads a block; a
# block sorts K0_SORT_LANES lanes of a class, then a thread takes a unit:
# K0_CODE_UNIT slots of a class's code plane, or one of its lanes
K0_THREADS = 512
K0_SORT_LANES = 8192
K0_CODE_UNIT = 4
# k1's and k2_backbone's blocks: K1_THREADS lanes
K1_THREADS = 128
_SLOT_ALIGN = 32        # elements: each slot starts 128-byte aligned
# a class's k2 outputs, in their workspace's and fd_backbone's order
_K2_SLOTS = ("sx", "sy", "sz", "pos")
_F32_SLOTS = frozenset(("mins6", "cont6", "sx", "sy", "sz"))


class ClassGeom(NamedTuple):
    """One class's place in the launches of k0, k1 and k2."""
    c: int          # the class's index in the batch
    seg: int
    nl: int
    col0: int       # its first column of the [9, NL_total] tails
    sort0: int      # its first sort block of k0
    unit0: int      # its first unit of k0
    block0: int     # its first block of k1 and of k2_backbone


class ClassLayout(NamedTuple):
    """A batch's width classes laid out once for k0, k1, k2 and the flat
    output (class_layout)."""
    launch: list    # ClassGeom of the classes with lanes and rows
    bb: bool        # k0's bb mode: no code plane
    k0: list        # a class: {name: (shape, element)} in k0's workspace
    k0_size: int    # i32 elements of k0's workspace
    k2: list        # a class: {name: (shape, element)} in k2's workspace
    k2_size: int
    rows: list      # a class: (first row, lanes) of the flat output
    n_rows: int
    nl_total: int
    sorts: int      # k0's sort blocks
    units: int      # k0's units
    blocks: int     # k1's and k2_backbone's blocks
    geo: object     # the launchers' geometry: ctypes int array


def _slots(at, shapes):
    """Slots one after another from element `at`, each 128-byte aligned
    -> ({name: (shape, element)}, the next free element)."""
    out = {}
    for name, shape in shapes:
        out[name] = (shape, at)
        at += -(-math.prod(shape) // _SLOT_ALIGN) * _SLOT_ALIGN
    return out, at


def class_layout(nls, segs, wire: str = "full", nl_outs=()) -> ClassLayout:
    """Everything the launches of k0, k1 and k2 need for width classes of
    nls[c] lanes and SEG segs[c], laid out once a batch.

    `launch`: the classes that have lanes and rows (at most
    T.MAX_CLASSES), the widest SEG first (ties in class order), each
    class's ranges where the last one's end: ceil(nl / K0_SORT_LANES) sort
    blocks and ceil(seg * nl / K0_CODE_UNIT) code units (none on the bb
    wire) then nl lane units of k0; ceil(nl / K1_THREADS) blocks of k1 and
    k2_backbone. A block (or unit) belongs to the last class whose range
    starts at or before it (fused_decode.cu read_classes and the
    kernels).

    Every class, in class order: its columns of the tails (the classes'
    lanes one after another), its k0 outputs in k0's workspace (code
    [SEG, NL], not on the bb wire, tat [NL], mins6 and cont6 [6, NL],
    order [NL]), its k2 outputs in k2's (sx, sy, sz [3*SEG, NL], pos
    [NL]), and its rows of the flat output: nl_outs[c] lanes (at most nls[c];
    every lane where nl_outs has no entry or None) of SEG rows, the
    classes' rows one after another."""
    if wire not in ("full", "bb"):
        raise ValueError(f"wire {wire!r}: expected 'full' or 'bb'")
    bb = wire == "bb"
    nls, segs = [int(n) for n in nls], [int(s) for s in segs]
    k0, k2, rows, cols = [], [], [], []
    k0_at = k2_at = row = col = 0
    for c, (nl, seg) in enumerate(zip(nls, segs)):
        cols.append(col)
        col += nl
        s, k0_at = _slots(k0_at, [      # the bb wire: no code plane
            ("code", (seg, nl)), ("tat", (nl,)), ("mins6", (6, nl)),
            ("cont6", (6, nl)), ("order", (nl,))][bb:])
        k0.append(s)
        s, k2_at = _slots(k2_at, [(k, (nl,) if k == "pos" else (3 * seg, nl))
                                  for k in _K2_SLOTS])
        k2.append(s)
        nlo = nl if c >= len(nl_outs) or nl_outs[c] is None \
            else min(int(nl_outs[c]), nl)
        rows.append((row, nlo))
        row += nlo * seg
    launch = []
    sorts = units = blocks = 0
    for c in sorted((c for c in range(len(nls)) if nls[c] and segs[c]),
                    key=lambda c: -segs[c]):
        nl, seg = nls[c], segs[c]
        launch.append(ClassGeom(c, seg, nl, cols[c], sorts, units, blocks))
        sorts += -(-nl // K0_SORT_LANES)
        units += (0 if bb else -(-seg * nl // K0_CODE_UNIT)) + nl
        blocks += -(-nl // K1_THREADS)
    if len(launch) > T.MAX_CLASSES:
        raise ValueError(f"{len(launch)} width classes with lanes: a launch "
                         f"takes at most {T.MAX_CLASSES}")
    geo = [len(launch), int(bb)] + [v for g in launch for v in g[1:]]
    return ClassLayout(launch, bb, k0, k0_at, k2, k2_at, rows, row, col,
                       sorts, units, blocks,
                       (ctypes.c_int * len(geo))(*geo))


def _views(ws, classes, names=None):
    """Each class's slots (class_layout's k0 or k2) as views of the i32
    workspace ws, the f32 ones through the same memory as f32 -> one
    {name: tensor} a class; names: those slots alone."""
    wsf = ws.view(F32)
    return [{k: (wsf if k in _F32_SLOTS else ws).as_strided(
                 shape, (shape[-1], 1)[-len(shape):], at)
             for k, (shape, at) in slots.items()
             if names is None or k in names}
            for slots in classes]


# ---------------------------------------------------------------------------
# kernel wrappers

def _cuda_lib(t):
    """The CUDA library, with its tables set on the tensor's CUDA device;
    ValueError for any other device type."""
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    from .build import load
    return load(t.device)


def _check(name, t, dtype, shape, device):
    if t is None:
        raise ValueError(f"{name}: None, expected {dtype} {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _shapes(recs_t):
    """The classes' lane counts and SEGs from their records, [8, SEG,
    NL] each -> (nls, segs)."""
    for recs in recs_t:
        if recs.dim() != 3 or recs.shape[0] != 8:
            raise ValueError(f"recs: shape {tuple(recs.shape)}, expected "
                             "[8, SEG, NL]")
    return [r.shape[2] for r in recs_t], [r.shape[1] for r in recs_t]


def _check_lane_inputs(recs, ranc, tat, mins6, cont6, order, seeds,
                       is_first=None):
    """Check the lane inputs of k1 and k2: seeds, {name: [9, NL] f32};
    is_first, [NL] bool, where the kernel reads it; order, a LaneOrder
    (None will do on the CPU, whose plain versions take none). -> (SEG,
    NL)."""
    (nl,), (seg,) = _shapes([recs])
    dev = recs.device
    _check("recs", recs, torch.uint8, (8, seg, nl), dev)
    for name, t in seeds.items():
        _check(name, t, F32, (9, nl), dev)
    if is_first is not None:
        _check("is_first", is_first, torch.bool, (nl,), dev)
    _check("ranc", ranc, F32, (9, nl), dev)
    _check("tat", tat, torch.int32, (nl,), dev)
    _check("mins6", mins6, F32, (6, nl), dev)
    _check("cont6", cont6, F32, (6, nl), dev)
    if order is None and dev.type == "cpu":
        return seg, nl
    if not isinstance(order, LaneOrder):
        raise TypeError(f"order: {type(order).__name__}, expected a "
                        "LaneOrder from lane_order or prep")
    _check("order", order.perm, torch.int32, (nl,), dev)
    return seg, nl


def _ptrs(*ts):
    return [None if t is None else t.data_ptr() for t in ts]


def _pvec(ptrs):
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _launch(fn, name, dev, *args):
    """Launch on dev's current stream with dev made current (the launchers
    run on the current device); raise on a non-zero cudaError."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _check_out(name, t, dtype, shape, device):
    """An output the caller gives: rows may have a stride of their own (a
    class's columns of a wider buffer), elements within a row may not."""
    if t.device != device or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or \
            (t.numel() and t.stride(-1) != 1):
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"strides {t.stride()}, expected {dtype} "
                         f"{tuple(shape)} on {device}, unit stride in a row")


def _dense(t, dtype=None):
    """t where it is contiguous and of dtype (None: its own), else a
    contiguous copy in dtype: no operation on the hot path's tensors."""
    if t.is_contiguous() and (dtype is None or t.dtype == dtype):
        return t
    return t.to(dtype or t.dtype).contiguous()


def _k0(lay, classes):
    """k0 over the classes of lay: prep's tuples, checked here on either
    device (the decode's one check of them) -> prep's dicts."""
    global PREP_LAUNCHES, PREP_BB_LAUNCHES
    dev = classes[0][0].device
    ins = []
    for (recs, mins, cont, sct, fwd9, rev9, seg_m), nl, seg in zip(
            classes, *_shapes([c[0] for c in classes])):
        ins.append((_dense(recs), _dense(mins), _dense(cont),
                    None if lay.bb or sct is None else _dense(sct),
                    _dense(fwd9), _dense(rev9), _dense(seg_m, torch.int32)))
        for name, t, dtype, shape in zip(
                ("recs", "mins_lane", "cont_lane", "sc_codes_seg", "fwd9",
                 "rev9", "seg_m"), ins[-1],
                (torch.uint8, F32, F32, torch.uint8, F32, F32, torch.int32),
                ((8, seg, nl), (nl, 6), (nl, 6), (seg, 11, nl), (9, nl),
                 (9, nl), (nl,))):
            if name != "sc_codes_seg" or not lay.bb:
                _check(name, t, dtype, shape, dev)
    wire = "bb" if lay.bb else "full"
    if dev.type == "cpu":
        out = [class_prep(*c, wire=wire) for c in ins]
        for pr in out:
            pr["order"] = lane_order(pr["tat"])
        return out
    lib = _cuda_lib(classes[0][0])
    ws = torch.empty((lay.k0_size,), dtype=torch.int32, device=dev)
    out = []
    for (recs, _, _, sct, fwd9, rev9, _), v in zip(ins, _views(ws, lay.k0)):
        d = dict(recs=recs, fwd9=fwd9, rev9=rev9, tat=v["tat"],
                 mins6=v["mins6"], cont6=v["cont6"],
                 order=LaneOrder(v["order"]))
        if not lay.bb:
            d.update(code=v["code"], sct=sct)
        out.append(d)
    if lay.launch:
        ptrs = []
        for g in lay.launch:
            recs, mins, cont, _, _, _, seg_m = ins[g.c]
            d = out[g.c]
            ptrs += _ptrs(recs, mins, cont, seg_m, d.get("code"), d["tat"],
                          d["mins6"], d["cont6"], d["order"].perm)
        _launch(lib.fd_prep, "k0 prep", dev, _pvec(ptrs), lay.geo)
        PREP_LAUNCHES += 1
        PREP_BB_LAUNCHES += lay.bb
    return out


def prep(classes, wire: str = "full"):
    """k0: class_prep and lane_order of every width class of a batch in
    one launch. classes: one tuple (seg_records, mins_lane, cont_lane,
    sc_codes_seg, fwd9, rev9, seg_m) a class, as class_prep takes them ->
    one dict a class, class_prep's keys and "order" (a LaneOrder, lane
    order's). wire "bb" is k0's bb mode: no code plane is written and the
    side-chain codes are not taken (None will do), as class_prep leaves
    them out on that wire.

    On the CPU class_prep and lane_order themselves (the plain version).
    On a CUDA device one workspace holds every class's code (not in bb
    mode), tat, mins6, cont6 and order (class_layout), the dicts hold
    views of it, and k0 writes them; the records, side-chain codes and
    seeds are the caller's tensors (made contiguous), as class_prep leaves
    them. Nothing is copied from the host and nothing waits for the
    stream. Counted as one launch of prep (and of prep_bb in bb mode)."""
    return _k0(class_layout(*_shapes([c[0] for c in classes]), wire),
               classes)


def _k1(lay, classes, out):
    """k1 over the classes of lay (tails_classes' tuples, as checked
    there) into out. -> out."""
    global K1_LAUNCHES
    if out.device.type == "cpu":
        base = 0
        for recs, seed, ranc, tat, mins6, cont6, _ in classes:
            nl = recs.shape[-1]
            out[:, base:base + nl] = tails_plain(recs, n_ca_lengths(recs),
                                                 seed, ranc, tat, mins6,
                                                 cont6)
            base += nl
        return out
    lib = _cuda_lib(out)
    if lay.launch:
        ptrs = []
        for g in lay.launch:
            recs, seed, ranc, tat, mins6, cont6, order = classes[g.c]
            ptrs += _ptrs(recs, seed, ranc, tat, mins6, cont6, order.perm)
        _launch(lib.fd_tails, "k1 tails", out.device, _pvec(ptrs), lay.geo,
                out.data_ptr(), out.stride(0))
        K1_LAUNCHES += 1
    return out


def tails_classes(classes, out):
    """k1 over width classes in one launch: classes, one tuple (recs, seed,
    ranc, tat, mins6, cont6, order) a class, as `tails` takes them; out,
    the tails of every class, a [9, NL_total] f32 tensor (rows may be rows
    of a wider buffer) whose columns are the classes' lanes one class
    after another. Each class's tails are those `tails` gives for it
    alone. -> out."""
    nls, segs = _shapes([c[0] for c in classes])
    dev = out.device
    _check_out("out", out, F32, (9, sum(nls)), dev)
    for c in classes:
        if c[0].device != dev:
            raise ValueError(f"recs: on {c[0].device}, out on {dev}")
    if dev.type != "cpu":
        for recs, seed, ranc, tat, mins6, cont6, order in classes:
            _check_lane_inputs(recs, ranc, tat, mins6, cont6, order,
                               {"seed": seed})
    return _k1(class_layout(nls, segs), classes, out)


def tails(recs, seed, ranc, tat, mins6, cont6, order=None, out=None):
    """k1 -> [9, NL] blended tails of the forward scan from `seed` ([9,
    NL] rows atom*3 + comp). The N-CA lengths come from the records (the
    plain version on the CPU takes n_ca_lengths). order: the LaneOrder of
    these lanes the threads walk them in (lane_order's or prep's; it
    changes no value), which a CUDA device needs and the CPU does not
    read. out: where to write them, a [9, NL] f32 view whose rows may be
    rows of a wider buffer; None allocates. One launch of tails_classes
    with one class."""
    if out is None:
        out = torch.empty((9, recs.shape[-1]), dtype=F32, device=recs.device)
    return tails_classes([(recs, seed, ranc, tat, mins6, cont6, order)], out)


def _check_k2(recs, fwd9, is_first, ranc, tat, mins6, cont6, order, prev,
              tails9):
    """Check k2's lane inputs, one class (tails9 None: refine_iters 1, k2
    reads fwd9 alone; prev given: tails9 is [9, NL_total] and prev i32
    [NL]) -> (SEG, NL)."""
    if tails9 is None:
        return _check_lane_inputs(recs, ranc, tat, mins6, cont6, order,
                                  {"fwd9": fwd9})
    if prev is None:
        return _check_lane_inputs(recs, ranc, tat, mins6, cont6, order,
                                  {"tails9": tails9, "fwd9": fwd9}, is_first)
    seg, nl = _check_lane_inputs(recs, ranc, tat, mins6, cont6, order,
                                 {"fwd9": fwd9}, is_first)
    _check("tails9", tails9, F32, (9, tails9.shape[-1]), recs.device)
    _check("prev", prev, torch.int32, (nl,), recs.device)
    return seg, nl


def _k2(lay, classes, tails9):
    """k2 over the classes of lay (backbone_classes' tuples, as checked
    there) -> one Staged a class."""
    global K2_LAUNCHES, K2_CLASSES
    if classes[0][0].device.type == "cpu":
        return [Staged(*backbone_rolled_plain(recs, tails9, fwd9, is_first,
                                              ranc, tat, mins6, cont6, prev))
                for recs, fwd9, is_first, ranc, tat, mins6, cont6, _, prev
                in classes]
    dev = classes[0][0].device
    lib = _cuda_lib(classes[0][0])
    ws = torch.empty((lay.k2_size,), dtype=torch.int32, device=dev)
    outs = [Staged(v["sx"], v["sy"], v["sz"], v["pos"])
            for v in _views(ws, lay.k2)]
    if lay.launch:
        ptrs = []
        for g in lay.launch:
            recs, fwd9, is_first, ranc, tat, mins6, cont6, order, prev = \
                classes[g.c]
            # the outputs by address: 4-byte elements
            ptrs += _ptrs(recs, fwd9, is_first, ranc, tat, mins6, cont6,
                          order.perm, prev) + [
                ws.data_ptr() + 4 * lay.k2[g.c][k][1] for k in _K2_SLOTS]
        _launch(lib.fd_backbone, "k2 backbone", dev, _pvec(ptrs), lay.geo,
                *_ptrs(tails9), 0 if tails9 is None else tails9.shape[1])
        K2_LAUNCHES += 1
        K2_CLASSES += len(lay.launch)
    return outs


def backbone_classes(classes, tails9=None):
    """k2 over width classes in one launch -> one Staged a class: its
    blended backbone rows [3*SEG_c, NL_c] (Staged.rows()), those
    `backbone` gives for it alone.

    classes: one tuple (recs, fwd9, is_first, ranc, tat, mins6, cont6,
    order, prev) a class, as `backbone` takes them. tails9 None: every
    lane starts from its own fwd9 (refine_iters 1). Otherwise the tails of
    every class, [9, NL_total], and lane l of a class starts from column
    prev[l] (the class's slice of prev_idx) unless is_first[l]; prev None
    only with one class, as `backbone` has it.

    The inputs are checked on either device. On the CPU
    backbone_rolled_plain class by class, nothing launched, each class's
    rows in lane columns. On a CUDA device one allocation holds every
    class's planes and pos (class_layout; each Staged holds views of it),
    and k2_backbone runs once over every class with lanes and rows (at
    most T.MAX_CLASSES), in class_layout's order, each lane's rows at its
    thread's column. Counted as one launch of k2, and its classes in
    k2_classes."""
    dev = classes[0][0].device
    if tails9 is not None and len(classes) > 1 and \
            any(c[8] is None for c in classes):
        raise ValueError("prev: None with several width classes, whose "
                         "lanes take their seeds by prev")
    for c in classes:
        if c[0].device != dev:
            raise ValueError(f"recs: on {c[0].device}, expected {dev}")
        _check_k2(*c, tails9)
    return _k2(class_layout(*_shapes([c[0] for c in classes])), classes,
               tails9)


def backbone(recs, tails9, fwd9, is_first, ranc, tat, mins6, cont6,
             order=None, prev=None):
    """k2 -> a Staged of the blended backbone rows [3*SEG, NL] x3.

    Seeds: lane l starts from lane l-1's k1 tail (tails9 [9, NL], rows
    comp*3 + atom; lane -1 is lane NL-1) unless is_first[l], and from its
    own fwd9 when tails9 is None (refine_iters 1). With prev (i32 [NL],
    width classes) tails9 is the tails of every class, [9, NL_total], and
    lane l starts from column prev[l]; the caller checks 0 <= prev <
    NL_total (codec/batch.py arrays_to_torch does, on the host), since the
    kernel reads there unchecked. The N-CA lengths come
    from the records. On a CUDA device the kernels compute and write rows
    r < tat[l] only: rows >= tat (pack padding) of a CUDA result are
    unspecified. The plain version on the CPU computes every row. order:
    as for `tails`. The CUDA path is one launch of k2_backbone, each
    lane's rows at its thread's column, counted as one launch of k2:
    backbone_classes with one class."""
    return backbone_classes([(recs, fwd9, is_first, ranc, tat, mins6, cont6,
                              order, prev)], tails9)[0]


def _k2_bb(k, tails9, seg_m, nl_out):
    """k2 and the bb wire's epilogue on one class (backbone_classes' tuple
    k, prev None, as checked by backbone_only)."""
    global K2BB_LAUNCHES
    recs, fwd9, is_first, ranc, tat, mins6, cont6, order, _ = k
    if recs.device.type == "cpu":
        return bb_epilogue_plain(*backbone_rolled_plain(
            recs, tails9, fwd9, is_first, ranc, tat, mins6, cont6), nl_out)
    lib = _cuda_lib(recs)
    dev = recs.device
    _, seg, nl = recs.shape
    nlo = nl if nl_out is None else min(int(nl_out), nl)
    off = torch.empty((nlo, seg, 6), dtype=torch.int16, device=dev)
    ca = torch.empty((nlo, seg, 3), dtype=F32, device=dev)
    if nlo and seg:
        # the forward rows' scratch, freed on return when the kernel is
        # queued: its memory is reused only by work ordered after it on
        # the stream
        scratch = [torch.empty((3 * seg, nl), dtype=F32, device=dev)
                   for _ in range(3)]
        _launch(lib.fd_backbone_bb, "k2 backbone bb", dev,
                *_ptrs(recs, tails9, None, fwd9, is_first, ranc, tat, mins6,
                       cont6, order.perm, seg_m, off, ca, *scratch),
                nl if tails9 is None else tails9.shape[1], seg, nl, nlo)
        K2BB_LAUNCHES += 1
    return off, ca


def backbone_only(recs, tails9, fwd9, is_first, ranc, tat, mins6, cont6,
                  seg_m, nl_out=None, order=None):
    """k2 and the bb wire's epilogue -> (off i16 [NL_out, SEG, 6], ca f32
    [NL_out, SEG, 3]): N and C as 0.1 mA offsets from CA, 24 B a residue
    (_run_backbone_only, pallas_decode.py:529-571).

    Inputs and seeds as for `backbone`; seg_m (i32 [NL]) the lanes'
    residue counts. On a CUDA device one kernel, k2_backbone_bb, walks the
    lanes and writes rows s < seg_m[l] of lanes l < nl_out; the other rows
    of a CUDA result are unspecified. Counted as one launch of k2_bb (not
    of k2). The plain version on the CPU computes every row."""
    _check("seg_m", seg_m, torch.int32, (recs.shape[-1],), recs.device)
    k = (recs, fwd9, is_first, ranc, tat, mins6, cont6, order, None)
    if recs.device.type != "cpu":
        _cuda_lib(recs)
        _check_k2(*k, tails9)
    return _k2_bb(k, tails9, seg_m, nl_out)


def _k3(bb, code, sct, seg_m, out):
    """k3 on the Staged bb into out, (off, ca) of sidechain's shapes
    (inputs as checked by sidechain). -> out."""
    global K3_LAUNCHES, K3_STAGED
    off, ca = out
    nlo, seg = off.shape[:2]
    if bb.x.device.type == "cpu":
        got = sidechain_plain(*bb.rows(), code, sct, nlo)
        return off.copy_(got[0]), ca.copy_(got[1])
    if nlo and seg:
        _launch(_cuda_lib(bb.x).fd_sidechain, "k3 sidechain", bb.x.device,
                *_ptrs(bb.x, bb.y, bb.z, bb.pos, code, sct, seg_m, off, ca),
                seg, bb.x.shape[1], nlo)
        K3_LAUNCHES += 1
        K3_STAGED += 1
    return out


def sidechain(bb, code, sct, nl_out=None, seg_m=None, out=None):
    """k3 on the backbone rows of a Staged (backbone's) -> (off i16
    [NL_out, SEG, 42], ca f32 [NL_out, SEG, 3]).

    On a CUDA device k3 takes the lanes in pack order, 32 to a group, and
    reads lane l's rows at column bb.pos[l], where k2 left them (bb.pos,
    which a CUDA device needs). seg_m (i32 [NL], the
    lanes' residue counts, which a CUDA device
    needs) names the real rows: the kernel computes and writes rows s <
    seg_m[l] only, and the other rows of a CUDA result are unspecified
    (the host stitch reads none of them). The plain version on the CPU
    computes every row of bb.rows() and reads no seg_m. out: contiguous
    (off, ca) of those shapes to write into (a width class's rows of one
    flat buffer); None allocates."""
    t, nl = bb.x.shape
    if t % 3:
        raise ValueError(f"backbone rows {t}: not a multiple of 3")
    seg = t // 3
    nlo = nl if nl_out is None else min(int(nl_out), nl)
    dev = bb.x.device
    if out is None:
        out = (torch.empty((nlo, seg, 42), dtype=torch.int16, device=dev),
               torch.empty((nlo, seg, 3), dtype=F32, device=dev))
    for name, o, dt, w in (("off", out[0], torch.int16, 42),
                           ("ca", out[1], F32, 3)):
        _check(f"out {name}", o, dt, (nlo, seg, w), dev)
    if dev.type != "cpu":
        _cuda_lib(bb.x)
        for name, p in (("bb.x", bb.x), ("bb.y", bb.y), ("bb.z", bb.z)):
            _check(name, p, F32, (t, nl), dev)
        _check("bb.pos", bb.pos, torch.int32, (nl,), dev)
        _check("code", code, torch.int32, (seg, nl), dev)
        _check("sct", sct, torch.uint8, (seg, 11, nl), dev)
        _check("seg_m", seg_m, torch.int32, (nl,), dev)
    return _k3(bb, code, sct, seg_m, out)


# ---------------------------------------------------------------------------
# the pipeline

# the pack's keys (pack_decode_batch_lanes) in decode_seg_fused's argument
# order
DECODE_ARGS = ("seg_records", "mins_lane", "cont_lane", "sc_codes_seg",
               "fwd9", "rev9", "is_first", "seg_m")


def decode_lanes(recs_t, mins_t, cont_t, sct_t, fwd_t, rev_t, isf_t, segm_t,
                 prev_idx=None, refine_iters: int = 2, nl_outs=(),
                 wire: str = "full"):
    """The fused ragged-lane decode of a batch of one or more width
    classes (pallas_decode.py decode_seg_fused and, :619-678,
    decode_seg_fused_classes): the arrays of pack_decode_batch_lanes (one
    class) or of batch_host.split_lanes_classes, one tuple entry a class,
    each class at its own SEG.

    class_layout lays the classes out once; k0 (`prep`) makes every
    class's kernel inputs and lane order in one launch, checking the
    inputs; k1 runs once over every class into one [9, NL_total] tails
    buffer, class c at its columns; k2 once over every class seeds lane l
    of class c from column prev_idx[base_c + l] of that buffer unless
    isf_t[c][l] (a protein's lanes may lie in different classes; prev_idx
    None, one class alone: from lane l-1, lane 0 from NL-1), or from its
    own fwd9 when refine_iters < 2; then k3 once a class, on k2's rows
    where k2 left them (Staged: no copy to the lanes' columns). Per-lane
    math is the same whatever the classes, so a lane's rows are bit-equal
    across forms. Each step is a span: `decode.prep` (attribute `wire`),
    `decode.k1`, `decode.k2` (attribute `classes`), `decode.k3` a class.

    wire "full" returns a tuple of per-class (off i16 [nl_out_c, SEG_c,
    42], ca f32 [nl_out_c, SEG_c, 3]): row [42] is the residue's [14, 3]
    milli-angstrom offsets from its CA. Each is a view of one flat pair
    (off [rows, 42], ca [rows, 3]; the classes' rows one after another,
    class_layout), so one copy takes the batch to the host. nl_outs[c]
    (None or no entry: every lane) cuts class c's lanes. wire "bb" takes
    one class, skips the side chains (sct_t's entry is not read, None
    will do) and returns a one-tuple of backbone_only's (off i16 [nl_out,
    SEG, 6], ca f32 [nl_out, SEG, 3]): N and C as 0.1 mA offsets from CA;
    k0 runs in bb mode and k2_backbone_bb in place of k2 and k3. Rows s >=
    seg_m[l] are pack padding; on a CUDA device they are left unspecified.
    The tensors' device picks the path: CUDA kernels on a CUDA device,
    the plain versions on the CPU."""
    n = len(recs_t)
    if wire == "bb" and n != 1:
        raise ValueError(f"the bb wire takes one class, not {n}")
    if prev_idx is None and n > 1:
        raise ValueError("prev_idx: None with several width classes, whose "
                         "lanes take their seeds by it")
    nls, segs = _shapes(recs_t)
    lay = class_layout(nls, segs, wire, nl_outs)
    dev = recs_t[0].device
    segm = [_dense(s, torch.int32) for s in segm_t]
    for f, nl in zip(isf_t, nls):
        _check("is_first", f, torch.bool, (nl,), dev)
    if prev_idx is not None:
        _check("prev_idx", prev_idx, torch.int32, (lay.nl_total,), dev)
    with tracing.span("decode.prep") as sp:
        if sp:
            sp.set(wire=wire)
        prs = _k0(lay, list(zip(recs_t, mins_t, cont_t, sct_t, fwd_t, rev_t,
                                segm)))
    tails9 = None
    if refine_iters >= 2:
        tails9 = torch.empty((9, lay.nl_total), dtype=F32, device=dev)
        with tracing.span("decode.k1"):
            _k1(lay, [(p["recs"], p["fwd9"], p["rev9"], p["tat"],
                       p["mins6"], p["cont6"], p["order"]) for p in prs],
                tails9)
    k2_in, base = [], 0
    for p, f, nl in zip(prs, isf_t, nls):
        k2_in.append((p["recs"], p["fwd9"], f, p["rev9"], p["tat"],
                      p["mins6"], p["cont6"], p["order"],
                      None if tails9 is None or prev_idx is None
                      else prev_idx[base:base + nl]))
        base += nl
    with tracing.span("decode.k2") as sp:
        if sp:
            sp.set(classes=n)
        if lay.bb:
            return (_k2_bb(k2_in[0], tails9, segm[0], lay.rows[0][1]),)
        bbs = _k2(lay, k2_in, tails9)
    off = torch.empty((lay.n_rows, 42), dtype=torch.int16, device=dev)
    ca = torch.empty((lay.n_rows, 3), dtype=F32, device=dev)
    views = []
    for p, bb, s, (row0, nlo), seg in zip(prs, bbs, segm, lay.rows, segs):
        views.append(tuple(t.as_strided((nlo, seg, w), (seg * w, w, 1),
                                        row0 * w)
                           for t, w in ((off, 42), (ca, 3))))
        with tracing.span("decode.k3"):
            _k3(bb, p["code"], p["sct"], s, views[-1])
    return tuple(views)


def decode_seg_fused(seg_records, mins_lane, cont_lane, sc_codes_seg,
                     fwd9, rev9, is_first, seg_m, refine_iters: int = 2,
                     nl_out: int | None = None, wire: str = "full"):
    """Fused ragged-lane decode of pack_decode_batch_lanes tensors
    (pallas_decode.py decode_seg_fused): decode_lanes of one class. wire
    "full" returns (off i16 [NL, SEG, 42], ca f32 [NL, SEG, 3]), sliced
    to nl_out lanes; wire "bb" backbone_only's (off i16 [NL, SEG, 6], ca
    f32 [NL, SEG, 3]), sc_codes_seg not read (None will do)."""
    return decode_lanes(*((t,) for t in (
        seg_records, mins_lane, cont_lane, sc_codes_seg, fwd9, rev9,
        is_first, seg_m)), None, refine_iters, (nl_out,), wire)[0]


def decode_seg_fused_classes_plain(recs_t, mins_t, cont_t, sct_t, fwd_t,
                                   rev_t, isf_t, segm_t, prev_idx,
                                   refine_iters: int = 2, nl_outs=()):
    """decode_lanes of width classes through the plain versions alone
    (the kernels' oracle on the card): every class's tails, the seeds gathered
    through prev_idx, backbone and side chains. -> the tuple of per-class
    (off, ca), each its own tensor."""
    prs = [class_prep(recs_t[i], mins_t[i], cont_t[i], sct_t[i], fwd_t[i],
                      rev_t[i], segm_t[i]) for i in range(len(recs_t))]
    tails_g = None
    if refine_iters >= 2:
        tails_g = torch.cat([
            tails_plain(p["recs"], n_ca_lengths(p["recs"]), p["fwd9"],
                        p["rev9"], p["tat"], p["mins6"], p["cont6"])
            for p in prs], dim=1)
    outs, base = [], 0
    for i, p in enumerate(prs):
        nl = p["recs"].shape[2]
        bb = backbone_rolled_plain(p["recs"], tails_g, p["fwd9"], isf_t[i],
                                   p["rev9"], p["tat"], p["mins6"],
                                   p["cont6"], prev_idx[base:base + nl])
        outs.append(sidechain_plain(*bb, p["code"], p["sct"],
                                    nl_outs[i] if i < len(nl_outs) else None))
        base += nl
    return tuple(outs)
