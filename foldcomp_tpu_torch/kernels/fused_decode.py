"""Fused ragged-lane decode: k0 the kernel inputs, k1 tails, k2 backbone
(the seed roll inside), k3 side chains, or on the bb wire k2 with its
24-byte epilogue.

Counterpart of foldcomp_tpu/kernels/pallas_decode.py `decode_seg_fused`
(wire "full" and "bb") and `decode_seg_fused_classes` (width classes):
the same inputs (the arrays of codec/batch.py pack_decode_batch_lanes, or
of batch_host.split_lanes_classes) and the same output contracts. Each
kernel has

- a plain PyTorch version (`*_plain`), operation for operation the Pallas
  kernel's math (the bb epilogue: the XLA epilogue's): the CPU path and
  the CUDA kernel's oracle;
- a wrapper (`prep`, `tails` and `tails_classes`, `backbone`,
  `backbone_only`, `sidechain`) that runs the plain version for CPU
  tensors, and for CUDA tensors checks its inputs and launches the
  hand-written kernel of csrc/fused_decode.cu, or raises. There is no
  fallback from a CUDA tensor to the plain version;
- a launch counter, raised by one where the wrapper launches its kernel
  and nowhere else: PREP_LAUNCHES k0_prep and K1_LAUNCHES k1_tails (each
  one launch over every width class of a batch), K2_LAUNCHES k2_backbone
  (with its copy-out, the full wire), K2BB_LAUNCHES k2_backbone_bb (the
  bb wire's one kernel), K3_LAUNCHES k3_sidechain.

The pipelines (`decode_seg_fused`, `decode_seg_fused_classes`) make each
wrapper call a span (tracing): `decode.prep`, `decode.k1`, `decode.k2`,
`decode.k3`.

Layouts are lane-minor ([rows, NL]) as in the pack. Nothing here needs
autograd or randomness.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import tracing
from ..core import tables as T
from .geometry import bond_angle_cs, place_atom_c, place_atom_cs

F32 = torch.float32

PREP_LAUNCHES = 0
K1_LAUNCHES = 0
K2_LAUNCHES = 0
K2BB_LAUNCHES = 0       # the bb call, one kernel: not counted in K2
K3_LAUNCHES = 0

_C_TO_N = float(T.C_TO_N)
_CA_TO_C = float(T.CA_TO_C)
_N_TO_CA = float(T.N_TO_CA)
_SC_CONT = float(T.SC_CONT)
_SC_MIN = float(T.SC_MIN)


def reset_launch_counts() -> None:
    global PREP_LAUNCHES, K1_LAUNCHES, K2_LAUNCHES, K2BB_LAUNCHES, \
        K3_LAUNCHES
    PREP_LAUNCHES = K1_LAUNCHES = K2_LAUNCHES = K2BB_LAUNCHES = \
        K3_LAUNCHES = 0


def launch_counts() -> dict:
    return {"prep": PREP_LAUNCHES, "k1": K1_LAUNCHES, "k2": K2_LAUNCHES,
            "k2_bb": K2BB_LAUNCHES, "k3": K3_LAUNCHES}


# ---------------------------------------------------------------------------
# _class_prep (pallas_decode.py:405-437)

def class_prep(seg_records, mins_lane, cont_lane, sc_codes_seg, fwd9, rev9,
               seg_m) -> dict:
    """Kernel inputs from the pack's arrays: the residue-code plane
    (byte0 >> 3) that k3 reads, the quantizer rows in kernel field order,
    and tat = 3 * seg_m. Records and side-chain codes stay packed u8; the
    kernels unpack them, and k1 and k2 derive the N-CA length from the
    records themselves (n_ca_lengths is its plain version). With
    lane_order, the plain version of k0 (`prep`)."""
    dev = seg_records.device
    cols = torch.as_tensor(T.FIELD_COLS, device=dev)
    return dict(
        recs=seg_records.contiguous(),
        code=(seg_records[0].to(torch.int32) >> 3).contiguous(),
        sct=sc_codes_seg.contiguous(),
        fwd9=fwd9.contiguous(), rev9=rev9.contiguous(),
        tat=(3 * seg_m).to(torch.int32).contiguous(),
        mins6=mins_lane.t()[cols].contiguous(),
        cont6=cont_lane.t()[cols].contiguous())


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


def _check_lane_inputs(recs, ranc, tat, mins6, cont6, order, seeds,
                       is_first=None):
    """Check the lane inputs of k1 and k2: seeds, {name: [9, NL] f32};
    is_first, [NL] bool, where the kernel reads it; order, a LaneOrder.
    -> (SEG, NL)."""
    if recs.dim() != 3 or recs.shape[0] != 8:
        raise ValueError(f"recs: shape {tuple(recs.shape)}, expected "
                         "[8, SEG, NL]")
    _, seg, nl = recs.shape
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
    if not isinstance(order, LaneOrder):
        raise TypeError(f"order: {type(order).__name__}, expected a "
                        "LaneOrder from lane_order")
    _check("order", order.perm, torch.int32, (nl,), dev)
    return seg, nl


def _ptrs(*ts):
    return [None if t is None else t.data_ptr() for t in ts]


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


# k1's launch (fused_decode.cu k1_tails): K1_THREADS lanes a block, at most
# K1_MAX_CLASSES width classes in one launch's table
K1_THREADS = 128
K1_MAX_CLASSES = 4

# k0's launch (fused_decode.cu k0_prep): K0_THREADS threads a block; a
# block sorts K0_SORT_LANES lanes of a class, then a thread takes a unit:
# K0_CODE_UNIT slots of a class's code plane, or one of its lanes
K0_THREADS = 512
K0_SORT_LANES = 8192
K0_CODE_UNIT = 4
_SLOT_ALIGN = 32        # elements: each k0 output starts 128-byte aligned


def _prep_slots(seg, nl):
    """Each k0 output's shape and offset in one class's part of the
    workspace (i32 or f32 elements), {name: (shape, element)}: code [SEG,
    NL], tat [NL], mins6 and cont6 [6, NL], order [NL]; and the part's
    elements."""
    slots, at = {}, 0
    for name, shape in (("code", (seg, nl)), ("tat", (nl,)),
                        ("mins6", (6, nl)), ("cont6", (6, nl)),
                        ("order", (nl,))):
        slots[name] = (shape, at)
        at += -(-math.prod(shape) // _SLOT_ALIGN) * _SLOT_ALIGN
    return slots, at


def prep_views(ws, wsf, ws0, seg, nl):
    """One class's k0 outputs as views of the workspace (ws, i32, and wsf,
    the same memory as f32, both from its start), the class's part from
    element ws0: {name: tensor} (_prep_slots; mins6 and cont6 f32)."""
    v = {}
    for name, (shape, off) in _prep_slots(seg, nl)[0].items():
        t = wsf if name in ("mins6", "cont6") else ws
        v[name] = t.as_strided(shape, (nl, 1)[-len(shape):], ws0 + off)
    return v


def _dense(t, dtype=None):
    """t where it is contiguous and of dtype (None: its own), else a
    contiguous copy in dtype: no operation on the hot path's tensors."""
    if t.is_contiguous() and (dtype is None or t.dtype == dtype):
        return t
    return t.to(dtype or t.dtype).contiguous()


def prep_class_table(nls, segs):
    """The table of one k0 launch over width classes of nls[c] lanes and
    SEG segs[c] -> (entries, size, sorts, units): entries (c, ws0, sort0,
    unit0) for the classes that have lanes, in class order: ws0 the
    class's first element of the workspace (its outputs at _prep_slots'
    offsets after it), sort0 its first sort block, unit0 its first unit,
    each right after the last class's (ceil(nls[c] / K0_SORT_LANES) sort
    blocks a class; ceil(segs[c] * nls[c] / K0_CODE_UNIT) code units,
    then nls[c] lane units); size the workspace's elements; sorts the sort
    blocks; units the units. The kernel's rule: block b < sorts orders
    lanes [q * K0_SORT_LANES, (q + 1) * K0_SORT_LANES) of the last entry
    whose sort0 <= b, q = b - sort0; thread t of block b >= sorts takes
    unit u = (b - sorts) * K0_THREADS + t and every grid-stride step after
    it, for the last entry whose unit0 <= u: unit j = u - unit0 is code
    slots [K0_CODE_UNIT * j, K0_CODE_UNIT * (j + 1)) where j < the class's
    code units, else lane j - its code units."""
    entries, size, sorts, units = [], 0, 0, 0
    for c, (nl, seg) in enumerate(zip(nls, segs)):
        nl, seg = int(nl), int(seg)
        if nl <= 0:
            continue
        entries.append((c, size, sorts, units))
        size += _prep_slots(seg, nl)[1]
        sorts += -(-nl // K0_SORT_LANES)
        units += -(-seg * nl // K0_CODE_UNIT) + nl
    return entries, size, sorts, units


def prep(classes):
    """k0: class_prep and lane_order of every width class of a batch in
    one launch. classes: one tuple (seg_records, mins_lane, cont_lane,
    sc_codes_seg, fwd9, rev9, seg_m) a class, as class_prep takes them ->
    one dict a class, class_prep's keys and "order" (a LaneOrder, lane
    order's).

    On the CPU class_prep and lane_order themselves (the plain version).
    On a CUDA device one workspace holds every class's code, tat, mins6,
    cont6 and order (_prep_slots), the dicts hold views of it, and k0
    writes them; the records, side-chain codes and seeds are the caller's
    tensors (made contiguous), as class_prep leaves them. Nothing is
    copied from the host and nothing waits for the stream. Counted as one
    launch of prep."""
    global PREP_LAUNCHES
    dev = classes[0][0].device
    for c in classes:
        if c[0].device != dev:
            raise ValueError(f"recs: on {c[0].device}, expected {dev}")
    if dev.type == "cpu":
        out = []
        for c in classes:
            pr = class_prep(*c)
            pr["order"] = lane_order(pr["tat"])
            out.append(pr)
        return out
    lib = _cuda_lib(classes[0][0])
    ins, segs, nls = [], [], []
    for recs, mins, cont, sct, fwd9, rev9, seg_m in classes:
        recs, mins, cont = _dense(recs), _dense(mins), _dense(cont)
        if recs.dim() != 3 or recs.shape[0] != 8:
            raise ValueError(f"recs: shape {tuple(recs.shape)}, expected "
                             "[8, SEG, NL]")
        _, seg, nl = recs.shape
        seg_m = _dense(seg_m, torch.int32)
        _check("recs", recs, torch.uint8, (8, seg, nl), dev)
        _check("mins_lane", mins, F32, (nl, 6), dev)
        _check("cont_lane", cont, F32, (nl, 6), dev)
        _check("seg_m", seg_m, torch.int32, (nl,), dev)
        ins.append((recs, mins, cont, seg_m, _dense(sct), _dense(fwd9),
                    _dense(rev9)))
        segs.append(seg)
        nls.append(nl)
    entries, size, _, _ = prep_class_table(nls, segs)
    if len(entries) > K1_MAX_CLASSES:
        raise ValueError(f"{len(entries)} width classes with lanes: k0 takes "
                         f"at most {K1_MAX_CLASSES} in a launch")
    ws = torch.empty((size,), dtype=torch.int32, device=dev)
    wsf = ws.view(F32)
    bases = dict((e[0], e[1]) for e in entries)
    out, flat_p = [], []
    for c, (recs, mins, cont, seg_m, sct, fwd9, rev9) in enumerate(ins):
        v = prep_views(ws, wsf, bases.get(c, 0), segs[c], nls[c])
        out.append(dict(recs=recs, code=v["code"], sct=sct, fwd9=fwd9,
                        rev9=rev9, tat=v["tat"], mins6=v["mins6"],
                        cont6=v["cont6"], order=LaneOrder(v["order"])))
        if c in bases:
            flat_p += _ptrs(recs, mins, cont, seg_m, v["code"], v["tat"],
                            v["mins6"], v["cont6"], v["order"])
    if entries:
        flat_i = [v for c, _, s0, u0 in entries
                  for v in (segs[c], nls[c], s0, u0)]
        _launch(lib.fd_prep, "k0 prep", dev, len(entries),
                (ctypes.c_void_p * len(flat_p))(*flat_p),
                (ctypes.c_int * len(flat_i))(*flat_i))
        PREP_LAUNCHES += 1
    return out


def k1_class_table(nls, segs):
    """The class table of one k1 launch over width classes of nls[c] lanes
    and SEG segs[c] (class c's columns of the shared tails buffer follow
    the classes before it) -> (entries, blocks): entries (c, col0, block0)
    for the classes that have lanes, the widest SEG first (ties in class
    order), block0 the entry's first block, each entry's blocks
    ceil(nls[c] / K1_THREADS) right after the last's; blocks the grid.
    Block b belongs to the last entry whose block0 <= b, its thread t to
    that class's lane order[(b - block0) * K1_THREADS + t] where that is <
    nls[c], written at column col0 + lane (the kernel's rule)."""
    cols = [0]
    for n in nls:
        cols.append(cols[-1] + int(n))
    entries, blocks = [], 0
    for c in sorted((c for c in range(len(nls)) if nls[c] > 0),
                    key=lambda c: -int(segs[c])):
        entries.append((c, cols[c], blocks))
        blocks += -(-int(nls[c]) // K1_THREADS)
    return entries, blocks


def tails_classes(classes, out):
    """k1 over width classes in one launch: classes, one tuple (recs, seed,
    ranc, tat, mins6, cont6, order) a class, as `tails` takes them (order
    None: lane_order(tat)); out, the tails of every class, a [9, NL_total]
    f32 tensor (rows may be rows of a wider buffer) whose columns are the
    classes' lanes one class after another. Each class's tails are those
    `tails` gives for it alone. -> out."""
    global K1_LAUNCHES
    nls = [c[0].shape[-1] for c in classes]
    dev = out.device
    _check_out("out", out, F32, (9, sum(nls)), dev)
    for c in classes:
        if c[0].device != dev:
            raise ValueError(f"recs: on {c[0].device}, out on {dev}")
    if dev.type == "cpu":
        base = 0
        for (recs, seed, ranc, tat, mins6, cont6, _), nl in zip(classes, nls):
            out[:, base:base + nl] = tails_plain(recs, n_ca_lengths(recs),
                                                 seed, ranc, tat, mins6,
                                                 cont6)
            base += nl
        return out
    lib = _cuda_lib(out)
    segs, ptrs = [], []
    for recs, seed, ranc, tat, mins6, cont6, order in classes:
        if order is None:
            order = lane_order(tat)
        seg, _ = _check_lane_inputs(recs, ranc, tat, mins6, cont6, order,
                                    {"seed": seed})
        segs.append(seg)
        ptrs.append(_ptrs(recs, seed, ranc, tat, mins6, cont6, order.perm))
    entries, _ = k1_class_table(nls, segs)
    if len(entries) > K1_MAX_CLASSES:
        raise ValueError(f"{len(entries)} width classes with lanes: k1 takes "
                         f"at most {K1_MAX_CLASSES} in a launch")
    if entries:
        flat_p = [p for c, _, _ in entries for p in ptrs[c]]
        flat_i = [v for c, col0, b0 in entries
                  for v in (segs[c], nls[c], col0, b0)]
        _launch(lib.fd_tails, "k1 tails", dev, len(entries),
                (ctypes.c_void_p * len(flat_p))(*flat_p),
                (ctypes.c_int * len(flat_i))(*flat_i), out.data_ptr(),
                out.stride(0))
        K1_LAUNCHES += 1
    return out


def tails(recs, seed, ranc, tat, mins6, cont6, order=None, out=None):
    """k1 -> [9, NL] blended tails of the forward scan from `seed` ([9,
    NL] rows atom*3 + comp). The N-CA lengths come from the records (the
    plain version on the CPU takes n_ca_lengths). order (a LaneOrder of
    these lanes): the order the threads walk the lanes in, lane_order(tat)
    when None; it changes no value. out: where to write them, a [9, NL]
    f32 view whose rows may be rows of a wider buffer; None allocates. One
    launch of tails_classes with one class."""
    if out is None:
        out = torch.empty((9, recs.shape[-1]), dtype=F32, device=recs.device)
    return tails_classes([(recs, seed, ranc, tat, mins6, cont6, order)], out)


def _k2_inputs(recs, tails9, fwd9, is_first, ranc, tat, mins6, cont6,
               order, prev=None):
    """Check k2's lane inputs (tails9 None: refine_iters 1, k2 reads fwd9
    alone; prev given: tails9 is [9, NL_total] and prev i32 [NL]) ->
    (library, order, SEG, NL); order None is lane_order(tat)."""
    lib = _cuda_lib(recs)
    if order is None:
        order = lane_order(tat)
    if tails9 is None:
        seg, nl = _check_lane_inputs(recs, ranc, tat, mins6, cont6, order,
                                     {"fwd9": fwd9})
    elif prev is None:
        seg, nl = _check_lane_inputs(recs, ranc, tat, mins6, cont6, order,
                                     {"tails9": tails9, "fwd9": fwd9},
                                     is_first)
    else:
        seg, nl = _check_lane_inputs(recs, ranc, tat, mins6, cont6, order,
                                     {"fwd9": fwd9}, is_first)
        _check("tails9", tails9, F32, (9, tails9.shape[-1]), recs.device)
        _check("prev", prev, torch.int32, (nl,), recs.device)
    return lib, order, seg, nl


def _launch_k2(fn, name, lane_args, order, outs, seg, nl, *sizes,
               prev=None, pos=True):
    """Launch a k2 launcher (fd_backbone, fd_backbone_bb) with outs (the
    launcher's tensors between order and the scratch) and [3*SEG, NL] f32
    scratch planes for the walk's rows, with each lane's scratch column
    (pos, fd_backbone only) after them. The scratch is freed on return,
    when the kernels are queued: its memory is reused only by work ordered
    after them on the stream."""
    recs, tails9, fwd9, is_first, ranc, tat, mins6, cont6 = lane_args
    dev = recs.device
    scratch = [torch.empty((3 * seg, nl), dtype=F32, device=dev)
               for _ in range(3)]
    if pos:
        scratch.append(torch.empty((nl,), dtype=torch.int32, device=dev))
    tails_ld = nl if tails9 is None else tails9.shape[1]
    _launch(fn, name, dev,
            *_ptrs(recs, tails9, prev, fwd9, is_first, ranc, tat, mins6,
                   cont6, order.perm, *outs, *scratch), tails_ld, seg,
            nl, *sizes)


def backbone(recs, tails9, fwd9, is_first, ranc, tat, mins6, cont6,
             order=None, prev=None):
    """k2 -> blended backbone rows [3*SEG, NL] x3.

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
    as for `tails`. The CUDA path is two launches, k2_backbone into
    scratch planes at each thread's column and k2_copy_out to the lanes'
    columns, counted as one launch of k2."""
    global K2_LAUNCHES
    if recs.device.type == "cpu":
        return backbone_rolled_plain(recs, tails9, fwd9, is_first, ranc,
                                     tat, mins6, cont6, prev)
    lane_args = (recs, tails9, fwd9, is_first, ranc, tat, mins6, cont6)
    lib, order, seg, nl = _k2_inputs(*lane_args, order, prev)
    outs = tuple(torch.empty((3 * seg, nl), dtype=F32, device=recs.device)
                 for _ in range(3))
    if nl and seg:
        _launch_k2(lib.fd_backbone, "k2 backbone", lane_args, order, outs,
                   seg, nl, prev=prev)
        K2_LAUNCHES += 1
    return outs


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
    global K2BB_LAUNCHES
    _check("seg_m", seg_m, torch.int32, (recs.shape[-1],), recs.device)
    if recs.device.type == "cpu":
        return bb_epilogue_plain(*backbone_rolled_plain(
            recs, tails9, fwd9, is_first, ranc, tat, mins6, cont6), nl_out)
    lane_args = (recs, tails9, fwd9, is_first, ranc, tat, mins6, cont6)
    lib, order, seg, nl = _k2_inputs(*lane_args, order)
    dev = recs.device
    nlo = nl if nl_out is None else min(int(nl_out), nl)
    off = torch.empty((nlo, seg, 6), dtype=torch.int16, device=dev)
    ca = torch.empty((nlo, seg, 3), dtype=F32, device=dev)
    if nlo and seg:
        _launch_k2(lib.fd_backbone_bb, "k2 backbone bb", lane_args, order,
                   (seg_m, off, ca), seg, nl, nlo, pos=False)
        K2BB_LAUNCHES += 1
    return off, ca


def sidechain(bx, by, bz, code, sct, nl_out=None, seg_m=None, out=None):
    """k3 -> (off i16 [NL_out, SEG, 42], ca f32 [NL_out, SEG, 3]).

    seg_m (i32 [NL], the lanes' residue counts) names the real rows: the
    kernel computes and writes rows s < seg_m[l] only, and the other rows
    of a CUDA result are unspecified (the host stitch reads none of them).
    None means every row is real. The plain version on the CPU computes
    every row. out: contiguous (off, ca) of those shapes to write into (a
    width class's rows of one flat buffer); None allocates."""
    global K3_LAUNCHES
    t, nl = bx.shape
    if t % 3:
        raise ValueError(f"backbone rows {t}: not a multiple of 3")
    seg = t // 3
    nlo = nl if nl_out is None else min(int(nl_out), nl)
    if out is not None:
        for name, o, dt, w in (("off", out[0], torch.int16, 42),
                               ("ca", out[1], F32, 3)):
            _check(f"out {name}", o, dt, (nlo, seg, w), bx.device)
    if bx.device.type == "cpu":
        got = sidechain_plain(bx, by, bz, code, sct, nl_out)
        if out is None:
            return got
        return out[0].copy_(got[0]), out[1].copy_(got[1])
    lib = _cuda_lib(bx)
    dev = bx.device
    for name, p in (("bx", bx), ("by", by), ("bz", bz)):
        _check(name, p, F32, (t, nl), dev)
    _check("code", code, torch.int32, (seg, nl), dev)
    _check("sct", sct, torch.uint8, (seg, 11, nl), dev)
    if seg_m is None:
        seg_m = torch.full((nl,), seg, dtype=torch.int32, device=dev)
    _check("seg_m", seg_m, torch.int32, (nl,), dev)
    off, ca = out if out is not None else (
        torch.empty((nlo, seg, 42), dtype=torch.int16, device=dev),
        torch.empty((nlo, seg, 3), dtype=F32, device=dev))
    if nlo and seg:
        _launch(lib.fd_sidechain, "k3 sidechain", dev,
                *_ptrs(bx, by, bz, code, sct, seg_m, off, ca), seg, nl, nlo)
        K3_LAUNCHES += 1
    return off, ca


# ---------------------------------------------------------------------------
# the pipeline

# the pack's keys (pack_decode_batch_lanes) in decode_seg_fused's argument
# order
DECODE_ARGS = ("seg_records", "mins_lane", "cont_lane", "sc_codes_seg",
               "fwd9", "rev9", "is_first", "seg_m")


def decode_seg_fused(seg_records, mins_lane, cont_lane, sc_codes_seg,
                     fwd9, rev9, is_first, seg_m, refine_iters: int = 2,
                     nl_out: int | None = None, wire: str = "full"):
    """Fused ragged-lane decode of pack_decode_batch_lanes tensors.

    wire "full" returns per-lane compact rows (off i16 [NL, SEG, 42], ca
    f32 [NL, SEG, 3]), sliced to nl_out lanes: row [42] is the residue's
    [14, 3] milli-angstrom offsets from its CA. wire "bb" skips the side
    chains and returns backbone_only's (off i16 [NL, SEG, 6], ca f32
    [NL, SEG, 3]): N and C as 0.1 mA offsets from CA. Rows s >= seg_m[l]
    are pack padding; on a CUDA device they are left unspecified. The
    tensors' device picks the path: CUDA kernels on a CUDA device, the
    plain versions on the CPU. k0 (`prep`) makes the kernels' inputs and
    the lane order, which k1 and k2 walk the lanes in; k2 takes k1's
    tails, fwd9 and is_first and rolls the seeds itself."""
    if wire not in ("full", "bb"):
        raise ValueError(f"wire {wire!r}: expected 'full' or 'bb'")
    with tracing.span("decode.prep"):
        (pr,) = prep([(seg_records, mins_lane, cont_lane, sc_codes_seg,
                       fwd9, rev9, seg_m)])
    order = pr["order"]
    rest = (pr["rev9"], pr["tat"], pr["mins6"], pr["cont6"])
    tails9 = None
    if refine_iters >= 2:
        with tracing.span("decode.k1"):
            tails9 = tails(pr["recs"], pr["fwd9"], *rest, order=order)
    seg_m = _dense(seg_m, torch.int32)
    if wire == "bb":
        with tracing.span("decode.k2"):
            return backbone_only(pr["recs"], tails9, pr["fwd9"], is_first,
                                 *rest, seg_m, nl_out, order=order)
    with tracing.span("decode.k2"):
        bx, by, bz = backbone(pr["recs"], tails9, pr["fwd9"], is_first,
                              *rest, order=order)
    with tracing.span("decode.k3"):
        return sidechain(bx, by, bz, pr["code"], pr["sct"], nl_out,
                         seg_m=seg_m)


def class_rows(recs_t, nl_outs=()):
    """Output rows of each width class, nl_out_c * SEG_c (nl_out_c the
    class's lane count where nl_outs has no entry), in the order the
    classes' rows follow one another in the flat output."""
    return [min(int(nl_outs[i]), r.shape[2]) * r.shape[1]
            if i < len(nl_outs) else r.shape[2] * r.shape[1]
            for i, r in enumerate(recs_t)]


def _class_views(flat, recs_t, nl_outs, width):
    """Each class's [nl_out_c, SEG_c, width] rows of the flat [rows,
    width] buffer, at the class's row base."""
    views, base = [], flat.storage_offset()
    for i, n in enumerate(class_rows(recs_t, nl_outs)):
        seg = recs_t[i].shape[1]
        views.append(flat.as_strided((n // seg, seg, width),
                                     (seg * width, width, 1), base))
        base += n * width
    return views


def decode_seg_fused_classes(recs_t, mins_t, cont_t, sct_t, fwd_t, rev_t,
                             isf_t, segm_t, prev_idx, refine_iters: int = 2,
                             nl_outs=(), out=None):
    """Width-classed fused decode (pallas_decode.py:619-678
    decode_seg_fused_classes): the arrays of batch_host.split_lanes_classes,
    one tuple entry per class, each class at its own SEG.

    k0 makes every class's kernel inputs and lane order in one launch
    (prep); k1 runs once over every class (tails_classes) into one [9,
    NL_total] tails buffer, class c at its columns; then k2 per class
    seeds lane l from column prev_idx[base_c + l] of that buffer unless
    isf_t[c][l] (a protein's lanes may lie in different classes), or from
    its own fwd9 when refine_iters < 2; then k2's copy-out and k3 per
    class. Per-lane math is that of decode_seg_fused, so the rows are
    bit-equal lane for lane.

    Returns JAX's tuple of per-class (off i16 [nl_out_c, SEG_c, 42], ca f32
    [nl_out_c, SEG_c, 3]); each is a view of one flat pair (off [rows, 42],
    ca [rows, 3]; the classes' rows one after another, class_rows), so one
    copy takes the batch to the host. out: that flat pair to write into;
    None allocates it. On a CUDA device rows past a lane's seg_m are left
    unspecified; on the CPU the wrappers run the plain versions."""
    dev = recs_t[0].device
    rows = sum(class_rows(recs_t, nl_outs))
    if out is None:
        out = (torch.empty((rows, 42), dtype=torch.int16, device=dev),
               torch.empty((rows, 3), dtype=F32, device=dev))
    _check("out off", out[0], torch.int16, (rows, 42), dev)
    _check("out ca", out[1], F32, (rows, 3), dev)
    views = list(zip(_class_views(out[0], recs_t, nl_outs, 42),
                     _class_views(out[1], recs_t, nl_outs, 3)))
    with tracing.span("decode.prep"):
        prs = prep(list(zip(recs_t, mins_t, cont_t, sct_t, fwd_t, rev_t,
                            segm_t)))
    bases = [0]
    for p in prs:
        bases.append(bases[-1] + p["recs"].shape[2])
    tails_g = None
    if refine_iters >= 2:
        k1_in = [(p["recs"], p["fwd9"], p["rev9"], p["tat"], p["mins6"],
                  p["cont6"], p["order"]) for p in prs]
        tails_g = torch.empty((9, bases[-1]), dtype=F32, device=dev)
        with tracing.span("decode.k1"):
            tails_classes(k1_in, tails_g)
    for i, p in enumerate(prs):
        prev = None if tails_g is None else \
            prev_idx[bases[i]:bases[i + 1]]
        with tracing.span("decode.k2"):
            bb = backbone(p["recs"], tails_g, p["fwd9"], isf_t[i],
                          p["rev9"], p["tat"], p["mins6"], p["cont6"],
                          order=p["order"], prev=prev)
        seg_m = _dense(segm_t[i], torch.int32)
        with tracing.span("decode.k3"):
            sidechain(*bb, p["code"], p["sct"],
                      nl_outs[i] if i < len(nl_outs) else None,
                      seg_m=seg_m, out=views[i])
    return tuple(views)


def decode_seg_fused_classes_plain(recs_t, mins_t, cont_t, sct_t, fwd_t,
                                   rev_t, isf_t, segm_t, prev_idx,
                                   refine_iters: int = 2, nl_outs=()):
    """decode_seg_fused_classes through the plain versions alone (the
    kernels' oracle on the card): every class's tails, the seeds gathered
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
