"""The port's decode glue: ragged-lane pack -> device decode -> PDB text.

The host stages are foldcomp_tpu's own and shared, not copied: the
ragged-lane pack (`pack_decode_batch_lanes`, native fcz_pack_lanes), the
row gather `_gather_a14`, the protein assembly and the native PDB
formatter (`_format_batch`, `format_atom14_native`). Only the device stage
and what touches its tensors are here, mirroring foldcomp_tpu/codec/batch.py
(`_seg_decode_arrays`, `_outs_to_host`, `decode_fcz_batch`,
`decode_fcz_to_pdb_batch`, `decode_fcz_stream`).

Every entry point takes `device` (see backend.resolve_device). The pack
runs with no segment-width cap: the CUDA backbone kernel takes any SEG,
so there is no grid-core fallback to route wide segments to. Width
classes and the backbone-only wire are not on this path.
"""
from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from foldcomp_tpu.codec.batch import (_assemble_protein, _format_batch,
                                      _gather_a14, pack_decode_batch_lanes,
                                      seg_sort_key)

from ..backend import resolve_device
from ..kernels import fused_decode

# pack keys -> tensor dtype on the device
_ARRAY_DTYPES = {
    "seg_records": torch.uint8, "mins_lane": torch.float32,
    "cont_lane": torch.float32, "sc_codes_seg": torch.uint8,
    "fwd9": torch.float32, "rev9": torch.float32, "is_first": torch.bool,
    "seg_m": torch.int32}

_PREFETCH = 2        # packed batches queued ahead of the device
_SORT_WINDOW = 4     # batches per seg_sort_key window


def arrays_to_torch(arrays, device) -> dict:
    """The pack's numpy dict (the same one the JAX path takes) -> tensors
    on `device`; `nl_out` stays a host int. Checks on the host what the
    kernels take for granted: 1 <= seg_m <= SEG for every lane."""
    dev = resolve_device(device)
    if "classes" in arrays or arrays.get("bb_wire"):
        raise ValueError("width-classed and bb-wire packs are not ported; "
                         "pack with pack_decode_batch_lanes")
    seg = arrays["seg_records"].shape[1]
    seg_m = arrays["seg_m"]
    if seg_m.size and (seg_m.min() < 1 or seg_m.max() > seg):
        raise ValueError(f"seg_m outside [1, {seg}]")
    out = {k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
           .to(device=dev, dtype=dt)
           for k, dt in _ARRAY_DTYPES.items()}
    nl = arrays.get("nl_out")
    out["nl_out"] = int(nl) if nl is not None else None
    return out


def _seg_decode_arrays(arrays, refine_iters=2):
    """Device decode of a ragged-lane tensor dict -> (off, ca) tensors."""
    return fused_decode.decode_seg_fused(
        arrays["seg_records"], arrays["mins_lane"], arrays["cont_lane"],
        arrays["sc_codes_seg"], arrays["fwd9"], arrays["rev9"],
        arrays["is_first"], arrays["seg_m"], refine_iters=refine_iters,
        nl_out=arrays["nl_out"])


def _outs_to_host(outs):
    """(off, ca) tensors -> numpy arrays for the shared host stitch."""
    off, ca = outs
    return off.cpu().numpy(), ca.cpu().numpy()


def decode_fcz_host(fczs, refine_iters: int = 2, device=None):
    """List[FczData] -> (host (off, ca) rows, per-protein metas)."""
    arrays, metas = pack_decode_batch_lanes(fczs)
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
                      device=None):
    """Pipelined streaming decode: yields (payload, pdb_text) in input
    order.

    The three stages of foldcomp_tpu's decode_fcz_stream, overlapped the
    same way: host pack on a worker pool, device decode (kernel launches
    return at once), and formatting of the previous batch on the main
    thread while a transfer thread copies the current batch's rows to the
    host. Payloads are sorted by seg_sort_key inside windows of
    _SORT_WINDOW batches, and results come out of a reorder buffer bounded
    by one window. Everything runs on the default
    CUDA stream. A short tail batch stays short: the kernels take any
    lane count, so there is no per-shape compile to avoid by padding."""
    dev = resolve_device(device)
    n_workers = max(2, (os.cpu_count() or 4) - 1)
    pool = ThreadPoolExecutor(n_workers)
    xfer = ThreadPoolExecutor(1)
    q_packed = queue.Queue(maxsize=_PREFETCH)
    window_len = batch_size * _SORT_WINDOW
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q_packed.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def emit_window(window, base):
        order = sorted(range(len(window)),
                       key=lambda i: seg_sort_key(window[i]))
        for i0 in range(0, len(window), batch_size):
            sel = order[i0:i0 + batch_size]
            batch = [window[j] for j in sel]
            if not put(([base + j for j in sel], batch,
                        pool.submit(pack_decode_batch_lanes, batch))):
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
        idxs, fczs, metas, fut = pend
        for gi, item in zip(idxs, _format_batch(fczs, metas, fut.result(),
                                                use_alt_order, pool=pool)):
            resbuf[gi] = item
        while next_out in resbuf:
            yield resbuf.pop(next_out)
            next_out += 1

    try:
        pending = None
        while True:
            item = q_packed.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            idxs, fczs, packed = item
            arrays, metas = packed.result()
            outs = _seg_decode_arrays(arrays_to_torch(arrays, dev),
                                      refine_iters)
            fut = xfer.submit(_outs_to_host, outs)
            if pending is not None:
                yield from drain(pending)
            pending = (idxs, fczs, metas, fut)
        if pending is not None:
            yield from drain(pending)
        if resbuf:
            raise RuntimeError("reorder buffer not drained")
    finally:
        stop.set()
        producer_thread.join(timeout=10)
        pool.shutdown(wait=True, cancel_futures=True)
        xfer.shutdown(wait=True)
