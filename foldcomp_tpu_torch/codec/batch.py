"""The port's device glue: decode (ragged-lane pack -> device decode ->
PDB text) and encode (fragment tensors -> compact wire -> device encode ->
FczData).

The host stages are the port's own copies in codec/batch_host.py: the
ragged-lane pack (`pack_decode_batch_lanes`, native fcz_pack_lanes), the
row gather `_gather_a14`, the protein assembly and the native PDB
formatter (`_format_batch`, `format_atom14_native`); on the encode side the
fragment tensors (`fragment_to_tensors`), the numpy compact wire
(`_compact_coord_batch`), its scratch pool, and the sparse host finish with
the FczData assembly (`finish_encode` -> `finish_encode_device`). Only the
device stages and what touches their tensors are here, mirroring
foldcomp_tpu/codec/batch.py (`use_bb_wire`, the ragged-lane half of
`pack_decode_batch_auto`, `_seg_decode_arrays`, `_outs_to_host`,
`decode_fcz_batch`, `decode_fcz_to_pdb_batch`, `decode_fcz_stream`,
`_pack_encode_wire_native`, `encode_submit`, `encode_finish`,
`encode_tensor_batch`, `encode_fragment_batch`).

Every entry point takes `device` (see backend.resolve_device). The decode
pack runs with no segment-width cap: the CUDA backbone kernel takes any
SEG, so there is no grid-core fallback to route wide segments to. Each
decode call chooses its wire once (`use_bb_wire`): the full wire ships
96 B a residue slot (k1, k2, k3), the backbone-only wire 24 B (k1, then
k2 with its epilogue in one kernel, k2_backbone_bb), and the host then
places O and the side chains with the native codec. A full-wire batch is
split into width classes (`split_lanes_classes`) where `use_wclass` and
the savings gate say so, as in foldcomp_tpu: then k1 runs once over every
class, k2 and k3 once per class, their rows land in one flat buffer, and
one copy brings it to the host. The encode
takes any length and needs no protein block: every batch goes through k4,
by its compact or its f32 loader.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import tracing
from ..backend import resolve_device
from ..kernels import fused_decode, fused_encode
from ..native import get_lib
from .batch_host import (_POOL, _WCLASS_MIN_LANES, _WCLASS_MIN_SAVE,
                         _assemble_protein, _compact_coord_batch,
                         _format_batch, _gather_a14, _round_up,
                         finish_encode, fragment_to_tensors,
                         pack_decode_batch_lanes, padded_slots,
                         seg_sort_key, split_lanes_classes, use_wclass)

# pack keys -> tensor dtype on the device
_ARRAY_DTYPES = {
    "seg_records": torch.uint8, "mins_lane": torch.float32,
    "cont_lane": torch.float32, "sc_codes_seg": torch.uint8,
    "fwd9": torch.float32, "rev9": torch.float32, "is_first": torch.bool,
    "seg_m": torch.int32}
# the width classes' keys (split_lanes_classes) -> dtype, in the order of
# decode_seg_fused_classes' arguments
_CLASS_DTYPES = {
    "recs": torch.uint8, "mins": torch.float32, "cont": torch.float32,
    "sct": torch.uint8, "fwd": torch.float32, "rev": torch.float32,
    "isf": torch.bool, "segm": torch.int32}

# Set once a device decode or encode batch has completed in this process
# (foldcomp_tpu/codec/batch.py:31): the hybrid scheduler's guard
# (parallel/hybrid.py EndgameGuard) then expects the next completion one
# batch away, not after a cold start.
DEVICE_WARMED = False


# below ~this D2H rate the full-atom wire (96 B/res) bounds the e2e wall
# and the host side-chain pass is cheaper than the saved transfer; above
# it the full wire is effectively free (foldcomp_tpu/codec/batch.py:752-756,
# the JAX package's band). Kept, and blocked: an H100 host probes
# 1,063-2,323 MB/s, so re-deriving the band needs a slow link to measure
# both wires on (ROADMAP queue 1 item 7).
_BB_WIRE_MAX_MBS = 200.0
_BB_WIRE_MIN_MBS = 5.0


def use_bb_wire() -> bool:
    """The backbone-only D2H wire (foldcomp_tpu/codec/batch.py:759-786):
    the device ships N and C as i16 0.1 mA offsets from an f32 CA, 24 B a
    residue against 96 for the full wire, and the host places O and the
    side chains with the native C codec (fcz_place_sc_from_bb, the
    reference float op order).

    FOLDCOMP_TPU_WIRE=bb forces it and =full (or any other value) pins the
    full wire; unset, the link probe (cli._probe_info) decides: the bb
    wire for a D2H rate in [_BB_WIRE_MIN_MBS, _BB_WIRE_MAX_MBS) MB/s.
    Needs the native library: without it the answer is False."""
    env = os.environ.get("FOLDCOMP_TPU_WIRE")
    if env == "bb":
        return get_lib() is not None
    if env:
        return False
    from ..cli import _probe_info
    result, mbs = _probe_info()
    return result in ("ok", "slow") \
        and _BB_WIRE_MIN_MBS <= mbs < _BB_WIRE_MAX_MBS \
        and get_lib() is not None


def pack_decode_wire(fczs, bb_wire: bool, wclass: str | None = None):
    """pack_decode_batch_lanes, then as foldcomp_tpu/codec/batch.py
    pack_decode_batch_auto (:802-820): for the bb wire each meta's
    side-chain code stream and the arrays marked `bb_wire` (never width
    classes); for the full wire the width-class split where the mode
    (wclass, else use_wclass(): "0", "1" or "auto") and the savings gate
    allow it, which returns split_lanes_classes' dict and flat-row metas."""
    arrays, metas = pack_decode_batch_lanes(fczs)
    if bb_wire:
        metas = [dataclasses.replace(m, sc_codes=np.asarray(f.sc_codes,
                                                            np.uint8))
                 for m, f in zip(metas, fczs)]
        return dict(arrays, bb_wire=True), metas
    mode = use_wclass() if wclass is None else wclass
    if mode != "0":
        nl_est = sum(f.n_anchor - 1 for f in fczs)
        if mode == "1" or nl_est >= _WCLASS_MIN_LANES:
            with tracing.span("pack.split"):
                split = split_lanes_classes(
                    arrays, metas,
                    min_save=(0.15 if mode == "1" else _WCLASS_MIN_SAVE))
            if split is not None:
                return split
    return arrays, metas


def _classes_to_torch(arrays, dev) -> dict:
    """arrays_to_torch of a width-classed dict: {"classes": {key: one
    tensor a class}, "prev_idx": i32 [NL_total] tensor, "nl_outs": host
    ints}. Checks 1 <= seg_m <= SEG_c in every class, one lane count a
    class across its arrays, and 0 <= prev_idx < NL_total."""
    c = arrays["classes"]
    n_cls = len(c["recs"])
    lanes = []
    for i in range(n_cls):
        seg, nl = c["recs"][i].shape[1], c["recs"][i].shape[2]
        sm = np.asarray(c["segm"][i])
        if sm.shape != (nl,) or (sm.size and (sm.min() < 1
                                              or sm.max() > seg)):
            raise ValueError(f"class {i}: seg_m outside [1, {seg}] or not "
                             f"{nl} lanes")
        lanes.append(nl)
    prev = np.asarray(arrays["prev_idx"])
    if prev.shape != (sum(lanes),) or (prev.size and (
            prev.min() < 0 or prev.max() >= prev.size)):
        raise ValueError(f"prev_idx: not {sum(lanes)} lanes in "
                         f"[0, {sum(lanes)})")
    classes = {k: tuple(torch.from_numpy(np.ascontiguousarray(a))
                        .to(device=dev, dtype=dt) for a in c[k])
               for k, dt in _CLASS_DTYPES.items()}
    return {"classes": classes,
            "prev_idx": torch.from_numpy(prev.astype(np.int32)).to(dev),
            "nl_outs": tuple(int(n) for n in arrays["nl_outs"])}


def arrays_to_torch(arrays, device) -> dict:
    """The pack's numpy dict (the same one the JAX path takes) -> tensors
    on `device`; `nl_out` stays a host int and `bb_wire` a host bool; a
    width-classed dict keeps its form (_classes_to_torch). Checks on the
    host what the kernels take for granted: 1 <= seg_m <= SEG for every
    lane."""
    dev = resolve_device(device)
    if "classes" in arrays:
        return _classes_to_torch(arrays, dev)
    seg = arrays["seg_records"].shape[1]
    seg_m = arrays["seg_m"]
    if seg_m.size and (seg_m.min() < 1 or seg_m.max() > seg):
        raise ValueError(f"seg_m outside [1, {seg}]")
    out = {k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
           .to(device=dev, dtype=dt)
           for k, dt in _ARRAY_DTYPES.items()}
    nl = arrays.get("nl_out")
    out["nl_out"] = int(nl) if nl is not None else None
    out["bb_wire"] = bool(arrays.get("bb_wire"))
    return out


def _seg_decode_arrays(arrays, refine_iters=2):
    """Device decode of a ragged-lane tensor dict -> (off, ca) tensors, or
    ("bb", off, ca) for a bb-wire pack. A width-classed dict goes through
    decode_seg_fused_classes into one flat buffer, returned as (off [rows,
    1, 42], ca [rows, 1, 3]): the form the flat-row metas index with SEG
    1, which one copy per tensor takes to the host. The call is one
    `decode.dispatch` span (attributes `classes`, `lanes`), whose
    children are k0's launch (decode.prep, the kernels' inputs of every
    class in one workspace) and the kernels' calls (decode.k1, k2, k3):
    the rest of it, and prep, is the host's glue. Nothing in it copies
    from the host or waits for the stream, so the host queues batch after
    batch ahead of the card."""
    with tracing.span("decode.dispatch") as sp:
        if "classes" in arrays:
            c = arrays["classes"]
            if sp:
                sp.set(classes=len(c["recs"]),
                       lanes=sum(r.shape[2] for r in c["recs"]))
            nl_outs = arrays["nl_outs"]
            rows = sum(fused_decode.class_rows(c["recs"], nl_outs))
            dev = c["recs"][0].device
            off = torch.empty((rows, 42), dtype=torch.int16, device=dev)
            ca = torch.empty((rows, 3), dtype=torch.float32, device=dev)
            fused_decode.decode_seg_fused_classes(
                *(c[k] for k in _CLASS_DTYPES), arrays["prev_idx"],
                refine_iters=refine_iters, nl_outs=nl_outs, out=(off, ca))
            return off[:, None], ca[:, None]
        if sp:
            sp.set(classes=1, lanes=arrays["seg_records"].shape[2])
        wire = "bb" if arrays.get("bb_wire") else "full"
        out = fused_decode.decode_seg_fused(
            arrays["seg_records"], arrays["mins_lane"], arrays["cont_lane"],
            arrays["sc_codes_seg"], arrays["fwd9"], arrays["rev9"],
            arrays["is_first"], arrays["seg_m"], refine_iters=refine_iters,
            nl_out=arrays["nl_out"], wire=wire)
        return ("bb",) + out if wire == "bb" else out


def _host_bytes(arrays) -> int:
    """Bytes of the host arrays arrays_to_torch ships for a pack."""
    if "classes" in arrays:
        c = arrays["classes"]
        return sum(np.asarray(a).nbytes for k in _CLASS_DTYPES
                   for a in c[k]) + 4 * np.asarray(arrays["prev_idx"]).size
    return sum(np.asarray(arrays[k]).nbytes for k in _ARRAY_DTYPES)


def _done_event(dev):
    """A CUDA event recorded after the work queued so far on dev's
    current stream; None off CUDA."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def _outs_to_host(outs):
    """Device decode output -> numpy arrays for the shared host stitch, in
    the same form: (off, ca) or ("bb", off, ca). The copy waits for the
    device, so the batch has completed when this returns."""
    global DEVICE_WARMED
    if isinstance(outs[0], str):
        res = (outs[0],) + tuple(t.cpu().numpy() for t in outs[1:])
    else:
        off, ca = outs
        res = off.cpu().numpy(), ca.cpu().numpy()
    DEVICE_WARMED = True
    return res


def decode_fcz_host(fczs, refine_iters: int = 2, device=None):
    """List[FczData] -> (host decode output, per-protein metas), on the
    wire use_bb_wire chooses."""
    arrays, metas = pack_decode_wire(fczs, use_bb_wire())
    dev_arrays = arrays_to_torch(arrays, device)
    return _outs_to_host(_seg_decode_arrays(dev_arrays, refine_iters)), metas


def decode_fcz_batch(fczs, refine_iters: int = 2,
                     use_alt_order: bool = False, device=None):
    """List[FczData] -> List[AtomArray] through the device decode."""
    outs, metas = decode_fcz_host(fczs, refine_iters, device)
    return [_assemble_protein(_gather_a14(outs, m), m, use_alt_order)
            for m in metas]


def decode_fcz_to_pdb_batch(fczs, refine_iters: int = 2,
                            use_alt_order: bool = False, device=None):
    """List[FczData] -> one PDB text per protein through the device
    decode and the shared formatter."""
    outs, metas = decode_fcz_host(fczs, refine_iters, device)
    return [text for _, text in _format_batch(fczs, metas, outs,
                                              use_alt_order)]


def decode_fcz_stream(payload_iter, batch_size: int = 2048,
                      refine_iters: int = 2, use_alt_order: bool = False,
                      device=None, prefetch: int = 2,
                      bucket_window: int = 4):
    """Pipelined streaming decode: yields (payload, pdb_text) in input
    order.

    The three stages of foldcomp_tpu's decode_fcz_stream, overlapped the
    same way: host pack on a worker pool, device decode (kernel launches
    return at once), and formatting of the previous batch on the main
    thread while a transfer thread copies the current batch's rows to the
    host. At most `prefetch` packed batches wait for the device. Payloads
    are sorted by seg_sort_key inside windows of `bucket_window` batches
    (0: arrival order, windows of one batch), and results come out of a
    reorder buffer bounded by one window; a window is emitted only once it
    is full or the payloads end, so a caller that paces its payloads by
    completed entries (parallel/hybrid.py) passes prefetch=1,
    bucket_window=1. Everything runs on the default CUDA stream. A short
    tail batch stays short: the kernels take any lane count, so there is
    no per-shape compile to avoid by padding. The wire (use_bb_wire) is
    chosen once, before the first batch.

    Spans (tracing), each carrying the batch's number: `stream.pack` on
    the pool worker (thread CPU; attributes lanes, residues, slots,
    classed), `stream.wait_pack` and `stream.wait_d2h` where the consuming
    thread waits, `stream.launch` (`stream.h2d` and `decode.dispatch`),
    then on the transfer thread `stream.device_wait` (an event recorded
    after the launches, while recording) and `stream.d2h`, and
    `stream.format` an entry (batch_host._format_batch); counters
    h2d_bytes, d2h_bytes, format_residues."""
    dev = resolve_device(device)
    bb_wire = use_bb_wire()
    n_workers = max(2, (os.cpu_count() or 4) - 1)
    pool = ThreadPoolExecutor(n_workers)
    xfer = ThreadPoolExecutor(1)
    q_packed = queue.Queue(maxsize=prefetch)
    window_len = batch_size * max(bucket_window, 1)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q_packed.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def pack(bi, batch):
        with tracing.span("stream.pack", bi, True) as sp:
            packed = pack_decode_wire(batch, bb_wire)
            if sp:
                sp.set(lanes=sum(f.n_anchor - 1 for f in batch),
                       residues=sum(f.n_residue for f in batch),
                       slots=padded_slots(packed[0]),
                       classed="classes" in packed[0])
            return packed

    def to_host(outs, bi, done):
        with tracing.span("stream.device_wait", bi):
            if done is not None:
                done.synchronize()
        with tracing.span("stream.d2h", bi) as sp:
            res = _outs_to_host(outs)
            if sp:
                tracing.count("d2h_bytes", sum(
                    a.nbytes for a in res if not isinstance(a, str)))
        return res

    n_batches = 0

    def emit_window(window, base):
        nonlocal n_batches
        order = range(len(window)) if bucket_window == 0 else \
            sorted(range(len(window)), key=lambda i: seg_sort_key(window[i]))
        for i0 in range(0, len(window), batch_size):
            sel = order[i0:i0 + batch_size]
            batch = [window[j] for j in sel]
            bi = n_batches
            n_batches += 1
            if not put(([base + j for j in sel], batch, bi,
                        pool.submit(pack, bi, batch))):
                return

    def producer():
        try:
            window, base = [], 0
            for f in payload_iter:
                if stop.is_set():
                    return
                window.append(f)
                if len(window) >= window_len:
                    emit_window(window, base)
                    base += len(window)
                    window = []
            if window:
                emit_window(window, base)
        except Exception as e:  # noqa: BLE001 — re-raised by the consumer
            put(e)
            return
        put(None)

    producer_thread = threading.Thread(target=producer, daemon=True)
    producer_thread.start()

    resbuf = {}
    next_out = 0

    def drain(pend):
        nonlocal next_out
        idxs, fczs, metas, fut, bi = pend
        with tracing.span("stream.wait_d2h", bi):
            outs = fut.result()
        for gi, item in zip(idxs, _format_batch(fczs, metas, outs,
                                                use_alt_order, pool=pool,
                                                batch=bi)):
            resbuf[gi] = item
        while next_out in resbuf:
            yield resbuf.pop(next_out)
            next_out += 1

    try:
        pending = None
        while True:
            with tracing.span("stream.wait_pack") as sp:
                item = q_packed.get()
                if type(item) is tuple:
                    idxs, fczs, bi, packed = item
                    if sp:
                        sp.batch = bi
                    arrays, metas = packed.result()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            with tracing.span("stream.launch", bi) as sp:
                with tracing.span("stream.h2d") as h2d:
                    dev_arrays = arrays_to_torch(arrays, dev)
                    if h2d:
                        tracing.count("h2d_bytes", _host_bytes(arrays))
                outs = _seg_decode_arrays(dev_arrays, refine_iters)
                done = _done_event(dev) if sp else None
            fut = xfer.submit(to_host, outs, bi, done)
            if pending is not None:
                yield from drain(pending)
            pending = (idxs, fczs, metas, fut, bi)
        if pending is not None:
            yield from drain(pending)
        if resbuf:
            raise RuntimeError("reorder buffer not drained")
    finally:
        stop.set()
        producer_thread.join(timeout=10)
        pool.shutdown(wait=True, cancel_futures=True)
        xfer.shutdown(wait=True)


# ---------------------------------------------------------------------------
# encode

def _pack_encode_wire(live, atom14, native: bool = True):
    """One-pass native fill of the padded atom14 batch and the plane-major
    compact wire (native/fccodec.c fcz_pack_encode_wire): baseT i32
    [3, B, L], deltaT i16 [42, B, L], present u16 [B, L], in pooled
    buffers. The JAX package pads the proteins to its kernel's sublane
    block; k4 needs none, so B is the live batch.

    Returns the three arrays, "f32" when the batch is off the compact form
    (atom14 is still filled), or None when `native` is False or the native
    library is missing (the caller fills atom14 itself)."""
    if not native:
        return None
    lib = get_lib()
    if lib is None:
        return None
    b, l = atom14.shape[0], atom14.shape[1]
    ptrs = (ctypes.c_void_p * b)()
    ms = np.empty(b, np.int32)
    keep = []
    for k, (_, (a14, _rc, _tf)) in enumerate(live):
        a = np.ascontiguousarray(a14, np.float32)
        keep.append(a)
        ptrs[k] = a.ctypes.data
        ms[k] = a.shape[0]
    baseT = _POOL.take((3, b, l), np.int32)
    deltaT = _POOL.take((42, b, l), np.int16)
    present = _POOL.take((b, l), np.uint16)
    # the C pass releases the GIL: split big batches over a few threads
    nt = min(4, os.cpu_count() or 1) if b >= 256 else 1
    bounds = [(b * t // nt, b * (t + 1) // nt) for t in range(nt)]

    def run(t):
        k0, k1 = bounds[t]
        sub = (ctypes.c_void_p * (k1 - k0))(*ptrs[k0:k1])
        return lib.fcz_pack_encode_wire_range(
            k0, k1 - k0, sub, ms[k0:k1], b, l, atom14, baseT, deltaT,
            present, -1)
    if nt == 1:
        gots = [run(0)]
    else:
        with ThreadPoolExecutor(nt) as ex:
            gots = list(ex.map(run, range(nt)))
    if all(g == 1 for g in gots):
        return baseT, deltaT, present
    _POOL.give(baseT, deltaT, present)
    return "f32" if all(g >= 0 for g in gots) else None


def _h2d(a, dev):
    if tracing.recording():
        tracing.count("h2d_bytes", a.nbytes)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def longest_first(live):
    """(index, fragment tensors) pairs ordered longest first, stably. The
    fused encode kernel runs one block per batch row in launch order, so
    the long proteins start first and the short ones fill the tail."""
    return sorted(live, key=lambda it: -it[1][0].shape[0])


def encode_submit(frag_tensors, frag_meta, anchor_threshold: int = 25,
                  l_bucket: int = 32, device=None,
                  native_wire: bool = True):
    """Stage 1 of the batched device encode: pad, pack, ship, launch.

    Pads the live fragments into one batch, longest first, and builds the
    compact wire: natively and plane-major, or (native_wire=False, or no
    native library) with the numpy pass and a plane-major permute on the
    device. A batch
    off the millimetre grid ships f32 atom14 instead. Launches the fused
    encode kernel (k4 with its epilogue) without waiting for it and
    returns a handle for encode_finish, so the caller can pack the next
    batch while this one runs. handle["wire"] names the route:
    "native", "numpy" or "f32"."""
    dev = resolve_device(device)
    live = longest_first([(i, t) for i, t in enumerate(frag_tensors)
                          if t is not None])
    if not live:
        return dict(n=len(frag_tensors), live=[])
    b = len(live)
    l_pad = _round_up(max(t[0].shape[0] for _, t in live), l_bucket)
    atom14 = _POOL.take((b, l_pad, 14, 3), np.float32)
    res_code = np.zeros((b, l_pad), np.int32)
    tf_ca = np.zeros((b, l_pad), np.float32)
    res_mask = np.zeros((b, l_pad), bool)
    n_res = np.zeros(b, np.int32)
    for k, (_, (a14, rc, tf)) in enumerate(live):
        m = a14.shape[0]
        res_code[k, :m] = rc
        tf_ca[k, :m] = tf
        res_mask[k, :m] = True
        n_res[k] = m
    wire = _pack_encode_wire(live, atom14, native_wire)
    compact, delta_buf, wire_bufs = None, None, ()
    if wire is None:
        atom14.fill(0)
        for k, (_, (a14, _rc, _tf)) in enumerate(live):
            atom14[k, :a14.shape[0]] = a14
        compact = _compact_coord_batch(atom14)
    code_t, nres_t = _h2d(res_code, dev), _h2d(n_res, dev)
    if isinstance(wire, tuple):
        route = "native"
        planar = tuple(_h2d(a, dev) for a in wire)
        wire_bufs = wire
    elif compact is not None:
        # the numpy wire is [B, L, ...]: make it plane-major on the device
        route = "numpy"
        base, delta, present = compact
        planar = (_h2d(base, dev).permute(2, 0, 1).contiguous(),
                  _h2d(delta, dev).reshape(b, l_pad, 42).permute(2, 0, 1)
                  .contiguous(),
                  _h2d(present, dev))
        delta_buf = delta
    else:
        route = "f32"
        planar = None
    if planar is not None:
        parts = fused_encode.encode_parity_fused_planar(*planar, code_t,
                                                        nres_t)
    else:
        parts = fused_encode.encode_parity_f32(_h2d(atom14, dev), code_t,
                                               nres_t)
    # the H2D copies are done when .to() returns (pageable host memory),
    # so encode_finish may recycle the pooled buffers
    return dict(n=len(frag_tensors), live=live, frag_meta=list(frag_meta),
                anchor_threshold=anchor_threshold, atom14=atom14,
                res_code=res_code, tf_ca=tf_ca, res_mask=res_mask,
                parts=parts, delta_buf=delta_buf,
                wire_bufs=wire_bufs, wire=route,
                done=_done_event(dev) if tracing.recording() else None)


def encode_finish(handle):
    """Stage 2: copy the parts to the host (this waits for the device),
    then the host finish (batch_host.finish_encode): exact quantizer
    extremes, rescue of the flagged values, temperature factors and the
    FczData assembly. Returns List[FczData | None] in the order of the
    submitted tensors. Spans (tracing), with the batch number
    handle["batch"] where the caller set one: `encode.device_wait` (the
    event encode_submit recorded while recording), `encode.d2h` (counter
    d2h_bytes) and `encode.finish` (thread CPU)."""
    global DEVICE_WARMED
    bi = handle.get("batch")
    if handle["live"]:
        with tracing.span("encode.device_wait", bi):
            done = handle.pop("done", None)
            if done is not None:
                done.synchronize()
        with tracing.span("encode.d2h", bi) as sp:
            handle["parts"] = {k: v.cpu().numpy()
                               for k, v in handle["parts"].items()}
            if sp:
                tracing.count("d2h_bytes", sum(
                    v.nbytes for v in handle["parts"].values()))
        DEVICE_WARMED = True
    with tracing.span("encode.finish", bi, True):
        return finish_encode(handle)


def encode_tensor_batch(frag_tensors, frag_meta, anchor_threshold: int = 25,
                        l_bucket: int = 32, device=None,
                        native_wire: bool = True):
    """Device-encode prepared fragment tensors -> List[FczData | None],
    byte-identical to the exact encoder. Synchronous form of
    encode_submit + encode_finish."""
    return encode_finish(encode_submit(frag_tensors, frag_meta,
                                       anchor_threshold, l_bucket, device,
                                       native_wire))


def encode_fragment_batch(fragments, anchor_threshold: int = 25,
                          l_bucket: int = 32, device=None,
                          native_wire: bool = True):
    """Batched device encode of AtomArray fragments -> List[FczData].
    Entries whose anchor count exceeds the uint8 header field come back
    as None (the exact encoder raises on those too)."""
    tensors = [fragment_to_tensors(a) for a in fragments]
    return encode_tensor_batch([(a14, rc, tf) for a14, rc, tf, _ in tensors],
                               [m for _, _, _, m in tensors],
                               anchor_threshold, l_bucket, device,
                               native_wire)
