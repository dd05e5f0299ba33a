"""Heterogeneous (CPU + CUDA card) work-stealing over a database.

The reference's only parallelism is a homogeneous OpenMP fan-out over
threads (input_processor.h:200-300). On a host with an accelerator the
right shape is heterogeneous: the card decodes large batches through the
hand-written kernels while the CPU cores run the byte-exact native codec,
both pulling from ONE shared work list. Chunks of database entries are
claimed through a tiny flock'd two-pointer file: CPU workers take from the
front, the device stream takes from the back, so the CPU/device split
adapts to whatever the hardware actually delivers.

No entry is processed twice, nothing is guessed statically, and the merge
step is the same shard-db merge the multi-host layout uses
(parallel/dist.py merge_shard_dbs). If the device stream dies mid-run, its
claimed-but-unfinished chunks are reprocessed with the native codec, so
the output is always complete.

The port's own copy of `foldcomp_tpu/parallel/hybrid.py:1`, kept line for
line in its host parts (ChunkController, EndgameGuard, the native workers
and the mop-up). What differs:

- the device streams run the port's pipeline on an explicit `device`
  (None: the CUDA card): `_device_decompress` on codec/batch.py
  decode_fcz_stream (k1, k2, k3, or k1 and k2_backbone_bb on the bb wire),
  `_device_compress` on encode_submit/encode_finish (the fused encode
  kernel), whose flushes are not padded: the kernel takes any batch;
- a device-stream failure is reported as an error: the mop-up still
  finishes the claimed chunks, so the database is whole, but
  run_hybrid_db returns 1;
- the guard keeps its time-to-first-completion in this package's own
  cache, <backend.cache_dir()>/device_warmup.json
  (~/.cache/foldcomp_tpu_torch/ by default; FOLDCOMP_TPU_TORCH_CACHE=0
  keeps none);
- worker processes import this module by its own name, and torch is
  imported only inside the device functions, so native workers never
  load it or create a CUDA context;
- each device stream asks the guard for its first chunk before it
  imports torch (a second or more of start-up on its own): a job the CPU
  workers finish within the device's expected warm-up never loads it, and
  the guard's time to the first completion includes the import.
"""
from __future__ import annotations

import fcntl
import os
import struct
import subprocess
import sys

from ..backend import cache_dir
from ..io.db import DatabaseReader, DatabaseWriter
from .dist import merge_shard_dbs, shard_db_path


class ChunkController:
    """Two-pointer chunk allocator shared between processes via flock.

    The control file holds two little-endian int64s (lo, hi): the front
    pointer (next chunk for CPU workers, ascending) and the back pointer
    (one past the next chunk for the device stream, descending). A claim
    is an atomic read-modify-write under an exclusive flock; the file is
    16 bytes and claims happen once per chunk (~hundreds per job), so
    lock traffic is negligible."""

    _FMT = "<qq"

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def create(cls, path: str, n_chunks: int) -> "ChunkController":
        with open(path, "wb") as fh:
            fh.write(struct.pack(cls._FMT, 0, n_chunks))
        return cls(path)

    def _claim(self, front: bool):
        # buffering=0: the pointer update must REACH THE FILE before the
        # flock drops. A buffered file flushes at close, AFTER the
        # finally-unlock, so another claimer could read stale pointers
        # and double-claim a chunk (observed with thread workers; the
        # same window existed for processes).
        with open(self.path, "r+b", buffering=0) as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                lo, hi = struct.unpack(self._FMT, fh.read(16))
                if lo >= hi:
                    return None
                if front:
                    got, lo = lo, lo + 1
                else:
                    hi = hi - 1
                    got = hi
                fh.seek(0)
                fh.write(struct.pack(self._FMT, lo, hi))
                return got
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)

    def take_front(self):
        """Claim the next front chunk (CPU side), or None when drained."""
        return self._claim(True)

    def take_back(self):
        """Claim the next back chunk (device side), or None when drained."""
        return self._claim(False)

    def peek(self):
        """(lo, hi) without claiming — lock-free read (int64 pair writes
        are atomic enough for rate estimation; claims still lock)."""
        with open(self.path, "rb") as fh:
            return struct.unpack(self._FMT, fh.read(16))


# The guard's cold horizon with no warmup file and no setting (see
# EndgameGuard.cold_horizon): the median of the guard's own time to its
# first completion in fresh processes with no warmup file, rounded up to
# 0.5 s. `bench --routing` sweep d, the no-flag db job at -t 1 on 16,385
# entries of the mixed corpus (NVIDIA H100 80GB HBM3, 700.00 W): 8.43,
# 9.10, 12.33 and 12.44 s in the four processes the device stream joined
# (the fifth, its guard at 5.0 s, kept the device out), median 10.71 s.
# The JAX value, 5.0 s (foldcomp_tpu/parallel/hybrid.py:176-180), was a
# default for its TPU's first program; a fresh process here pays the
# ~6.5 s torch import before its first batch.
COLD_HORIZON_S = 11.0


class EndgameGuard:
    """Paces the device stream's chunk claims.

    Two failure modes on a degraded host<->device link, both observed:
    (a) the CPU workers drain the list in T seconds, then everyone waits
    for the device to grind through its claimed backlog — wall becomes
    native_wall + device_tail; (b) the device claims chunks while its
    first program is still COMPILING (cold runs pay minutes on a
    remote-compile service) and ends up owning work it cannot deliver.

    The guard therefore paces claims by what the device has actually
    COMPLETED (entries written), not by claim cadence:

    - backlog cap: claimed-but-unfinished entries never exceed one batch
      until the first completion, then ~four batches (wait, then retry);
    - cold horizon: before the first completion the device's effective
      rate is UNKNOWN and its warm-up (compile/trace/program upload) can
      exceed a small job's whole native wall. The guard waits a short
      grace for the CPU workers to establish a rate, then claims cold
      only while the CPUs' remaining time exceeds the device's expected
      warm-up — a PERSISTED measurement of time-to-first-completion from
      previous runs on this host (default COLD_HORIZON_S,
      override/force with FOLDCOMP_TPU_WARMUP_EST);
    - endgame: claim another chunk only if the device can drain its
      current backlog PLUS that chunk before the CPU workers run out of
      other work. (Round 4: the previous rule compared one chunk's time
      against the remaining native time and ignored the backlog, so on a
      starved link the already-claimed tail could extend the wall well
      past native-only — observed 10x on a 2.3 s job.)
    """

    CLAIM, WAIT, STOP = "claim", "wait", "stop"
    GRACE_S = 0.25

    def __init__(self, ctrl: ChunkController, chunk_entries: int,
                 batch_size: int, completed_fn):
        import time
        self.ctrl = ctrl
        self.chunk_entries = chunk_entries
        self.batch_size = batch_size
        self.completed_fn = completed_fn
        self._time = time.perf_counter
        self.t0 = self._time()
        self.lo0 = ctrl.peek()[0]
        self.claimed_entries = 0
        self._in_process_warm = self._device_warmed()
        self.warmup_est = self.cold_horizon()
        self._first_done_dt = None

    @staticmethod
    def _device_warmed() -> bool:
        # codec/batch.py imports torch: a process that has not loaded it
        # has completed no device batch
        _batch = sys.modules.get(__package__.rsplit(".", 1)[0]
                                 + ".codec.batch")
        return bool(getattr(_batch, "DEVICE_WARMED", False))

    @staticmethod
    def _warmup_path():
        """The estimate's file in this package's cache (the JAX package's
        holds a TPU's number); None with the cache off: nothing is read
        or written (foldcomp_tpu/parallel/hybrid.py:149-157)."""
        root = cache_dir()
        return None if root is None else os.path.join(root,
                                                      "device_warmup.json")

    @classmethod
    def cold_horizon(cls) -> float:
        """The time to the device stream's first completion that a guard
        made now takes (its `warmup_est`), in seconds."""
        import json
        env = os.environ.get("FOLDCOMP_TPU_WARMUP_EST")
        if env is not None:
            try:
                return max(float(env), 0.0)
            except ValueError:
                pass
        if cls._device_warmed():
            # pipeline already compiled + dispatched in this process:
            # first completion is one dispatch away, not a cold start
            return 0.5
        path = cls._warmup_path()
        if path is None:
            return COLD_HORIZON_S
        try:
            with open(path) as fh:
                return max(float(json.load(fh)["warmup_s"]), 0.0)
        except Exception:  # noqa: BLE001 — no cache yet / unreadable
            return COLD_HORIZON_S

    def finalize(self):
        """Persist the measured time-to-first-completion so the NEXT
        run's cold horizon reflects this host/link, not the default.
        -> the file written, or None."""
        import json
        path = self._warmup_path()
        if path is None or self._first_done_dt is None or \
                getattr(self, "_in_process_warm", False) or \
                os.environ.get("FOLDCOMP_TPU_WARMUP_EST") is not None:
            return None
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump({"warmup_s": round(self._first_done_dt, 3)}, fh)
            os.replace(tmp, path)
        except OSError:
            return None
        return path

    def note_claim(self, n_entries: int):
        self.claimed_entries += n_entries

    def next_action(self) -> str:
        lo, hi = self.ctrl.peek()
        if hi - lo <= 0:
            return self.STOP
        completed = self.completed_fn()
        dt = self._time() - self.t0
        if completed and self._first_done_dt is None:
            self._first_done_dt = dt
        # Backlog caps sized above the stream's maximum in-flight depth
        # (one batch queued + one dispatched + one awaiting drain), so a
        # WAIT can always be released by the consumer making progress —
        # never a producer<->consumer deadlock. Cold (nothing completed,
        # first program may be compiling): claim at most ~2 batches ahead.
        cap = (2 if not completed else 4) * self.batch_size \
            + self.chunk_entries
        if self.claimed_entries - completed >= cap:
            return self.WAIT
        if dt <= 0:
            return self.WAIT
        native_rate = (lo - self.lo0) / dt          # chunks/s, all CPUs
        device_rate = completed / dt                # entries/s
        eager = self.warmup_est == 0    # FOLDCOMP_TPU_WARMUP_EST=0: tests/
        # benches that must exercise the device path claim unconditionally
        if native_rate <= 0:
            # CPUs have claimed nothing yet: give them a grace beat to
            # establish a rate (protects tiny jobs from a cold grab);
            # past the grace there are no effective CPU workers — run.
            return self.CLAIM if eager or dt >= self.GRACE_S \
                or device_rate > 0 else self.WAIT
        remaining_s = (hi - lo) / native_rate
        if device_rate <= 0:
            # nothing delivered yet (warming up): claim only while the
            # CPUs alone would outlast the device's expected warm-up
            return self.CLAIM if eager \
                or remaining_s > max(self.warmup_est, 1.0) else self.STOP
        backlog = max(self.claimed_entries - completed, 0)
        drain_s = (backlog + self.chunk_entries) / device_rate
        return self.CLAIM if remaining_s > drain_s else self.STOP

    def take_back(self):
        """Guarded claim: returns a chunk index or None (stop)."""
        import time
        while True:
            act = self.next_action()
            if act == self.WAIT:
                time.sleep(0.02)
                continue
            if act == self.STOP:
                return None
            c = self.ctrl.take_back()
            if c is not None:
                self.note_claim(self.chunk_entries)
            return c


def _chunk_positions(chunk: int, chunk_entries: int, n: int):
    return range(chunk * chunk_entries, min((chunk + 1) * chunk_entries, n))


def _entry(reader, pos):
    key = reader.get_key(pos)
    data = reader.get_data(pos)
    if data.endswith(b"\x00"):
        data = data[:-1]
    return key, reader.name_of_key(key) or str(key), bytes(data)


def _range_names(reader, start, stop):
    return b"\x00".join(
        (reader.name_of_key(reader.get_key(p))
         or str(reader.get_key(p))).encode()
        for p in range(start, stop)) + b"\x00"


def _decode_range_native(lib, reader, writer, start, stop):
    """One GIL-free C call decoding db entries [start, stop) into the
    writer (fcz_db_decode_range); Python only resolves .lookup names."""
    r = lib.fcz_db_decode_range(reader._h, writer._h, start, stop,
                                _range_names(reader, start, stop), 0)
    if r < 0:
        raise MemoryError("fcz_db_decode_range failed")
    return r


def _encode_range_native(lib, reader, writer, start, stop, threshold):
    """One GIL-free C call compressing db entries [start, stop) into the
    writer (fcz_db_encode_range: parse + split-encode + append)."""
    r = lib.fcz_db_encode_range(reader._h, writer._h, start, stop,
                                _range_names(reader, start, stop),
                                threshold)
    if r < 0:
        raise MemoryError("fcz_db_encode_range failed")
    return r


def native_decompress_worker(db_path: str, out_path: str, worker_id: int,
                             ctrl_path: str, chunk_entries: int) -> int:
    """CPU worker: byte-exact native decode of front chunks into a shard db.

    Fast path: the WHOLE chunk loop (reader mmap -> decode -> format ->
    shard writer) runs in one GIL-free C call per chunk
    (native/fccodec.c fcz_db_decode_range); Python only resolves the
    .lookup names. Falls back to the per-entry loop without the native
    library."""
    from ..codec import fcz
    from ..codec.decoder import decode
    from ..io.pdb import format_pdb
    try:
        from ..native import decode_fcz_pdb_native, get_lib
        lib = get_lib()
    except Exception:
        lib = None

    reader = DatabaseReader(db_path, use_lookup=True)
    ctrl = ChunkController(ctrl_path)
    n = len(reader)

    writer = DatabaseWriter(shard_db_path(out_path, worker_id))
    if lib is not None and getattr(reader, "_h", None) and \
            getattr(writer, "_h", None):
        n_written = 0
        try:
            while (c := ctrl.take_front()) is not None:
                pr = _chunk_positions(c, chunk_entries, n)
                r = _decode_range_native(lib, reader, writer, pr.start,
                                         pr.stop)
                n_written += r
        finally:
            writer.close()
            reader.close()
        return n_written

    n_written = 0
    try:
        while (c := ctrl.take_front()) is not None:
            for pos in _chunk_positions(c, chunk_entries, n):
                key, name, data = _entry(reader, pos)
                if lib is not None:
                    try:
                        payload = decode_fcz_pdb_native(data, as_bytes=True)
                    except ValueError:
                        continue
                else:
                    try:
                        f = fcz.parse(data)
                        payload = format_pdb(decode(f), f.title).encode()
                    except Exception:
                        continue
                writer.append(payload + b"\x00", key, name)
                n_written += 1
    finally:
        writer.close()
        reader.close()
    return n_written


def native_compress_worker(db_path: str, out_path: str, worker_id: int,
                           ctrl_path: str, chunk_entries: int,
                           anchor_threshold: int = 25) -> int:
    """CPU worker: byte-exact native encode of front chunks into a shard db.

    Fast path: whole chunks run in one GIL-free C call
    (fcz_db_encode_range: parse + split-encode + shard append)."""
    from ..native import encode_pdb_native, get_lib
    lib = get_lib()

    reader = DatabaseReader(db_path, use_lookup=True)
    writer = DatabaseWriter(shard_db_path(out_path, worker_id))
    ctrl = ChunkController(ctrl_path)
    n_written = 0
    try:
        n = len(reader)
        if lib is not None and getattr(reader, "_h", None) and \
                getattr(writer, "_h", None):
            while (c := ctrl.take_front()) is not None:
                pr = _chunk_positions(c, chunk_entries, n)
                n_written += _encode_range_native(
                    lib, reader, writer, pr.start, pr.stop,
                    anchor_threshold)
            return n_written
        while (c := ctrl.take_front()) is not None:
            for pos in _chunk_positions(c, chunk_entries, n):
                key, name, data = _entry(reader, pos)
                try:
                    frags = encode_pdb_native(data, anchor_threshold, None,
                                              split=True, fallback_title=name)
                except Exception:
                    continue
                for f in frags or []:
                    if not f["error"]:
                        writer.append(f["blob"], key, name)
                        n_written += 1
    finally:
        writer.close()
        reader.close()
    return n_written


def _claim(guard, claimed):
    """The guard's next chunk for the device stream, recorded in `claimed`
    as it is taken, so that the mop-up finishes it whatever fails next."""
    c = guard.take_back()
    if c is not None:
        claimed.append(c)
    return c


def _device_decompress(reader, writer, ctrl, chunk_entries, batch_size,
                       use_alt_order, claimed, done, device=None):
    """Device stream: pull back chunks, decode them through the port's
    pipeline on `device`, append in completion order (the merge re-sorts
    by key)."""
    from ..codec import fcz

    n = len(reader)
    guard = EndgameGuard(ctrl, chunk_entries, batch_size,
                         completed_fn=lambda: len(done))
    first = _claim(guard, claimed)
    if first is None:
        return
    from ..codec.batch import decode_fcz_stream

    def payloads():
        c = first
        while c is not None:
            for pos in _chunk_positions(c, chunk_entries, n):
                key, name, data = _entry(reader, pos)
                try:
                    f = fcz.parse(data)
                except fcz.FczFormatError:
                    done.add(pos)
                    continue
                f.entry_key = key
                f.entry_name = name
                f.entry_pos = pos
                yield f
            c = _claim(guard, claimed)

    # bucket_window=1 / prefetch=1: bound the claimed-but-unprocessed
    # backlog (the guard can only stop FUTURE claims; a deep prefetch
    # window would still leave a long tail on a degraded link). A window
    # of more batches than the guard's cap lets claim would never fill:
    # no batch would complete, and the guard would wait for the CPUs.
    for f, text in decode_fcz_stream(payloads(), batch_size=batch_size,
                                     use_alt_order=use_alt_order,
                                     device=device, prefetch=1,
                                     bucket_window=1):
        writer.append(text.encode() + b"\x00", f.entry_key, f.entry_name)
        done.add(f.entry_pos)
    guard.next_action()   # record first-completion time if not yet seen
    guard.finalize()


def _device_compress(reader, writer, ctrl, chunk_entries, batch_size,
                     anchor_threshold, claimed, done, device=None):
    """Device stream: batched device encode (bit-parity records) of back
    chunks on `device`; one flush per `batch_size` fragments."""
    import collections

    from ..codec import fcz as fcz_mod
    from ..codec.batch_host import encode_pdb_device

    n = len(reader)
    guard = EndgameGuard(ctrl, chunk_entries, batch_size,
                         completed_fn=lambda: len(done))
    c = _claim(guard, claimed)
    if c is None:
        return
    from ..codec.batch import encode_finish, encode_submit
    pend_t, pend_m, pend_e = [], [], []
    inflight = collections.deque()   # (entries, submit handle)

    def _finish_oldest():
        entries, handle = inflight.popleft()
        for f, (key, name, pos) in zip(encode_finish(handle), entries):
            if f is not None:
                writer.append(fcz_mod.serialize(f), key, name)
            done.add(pos)

    def flush_full(drain: bool = False):
        """Device-encode in groups of at most batch_size fragments, sliced
        at ENTRY boundaries (all fragments of a database entry stay in one
        flush, so `done` is all-or-nothing per entry). The kernel takes
        any batch, so a flush cut short by an entry boundary is not padded
        (the JAX package pads to one compiled shape; the bytes written are
        the same). One batch stays in flight (encode_submit handle) so
        the next group's parse/pack overlaps the device round trip; the
        one-batch lag in `done` only makes the endgame guard slightly
        more conservative."""
        while len(pend_t) >= batch_size:
            cut = batch_size
            while cut > 0 and pend_e[cut - 1][2] == \
                    (pend_e[cut][2] if cut < len(pend_e) else None):
                cut -= 1
            if cut == 0:            # one entry wider than a batch (never
                cut = len(pend_t)   # in practice: fragments/entry is tiny)
                if cut > batch_size:
                    break
            inflight.append((list(pend_e[:cut]),
                             encode_submit(pend_t[:cut], pend_m[:cut],
                                           anchor_threshold,
                                           device=device)))
            del pend_t[:cut]
            del pend_m[:cut]
            del pend_e[:cut]
            while len(inflight) > 1:
                _finish_oldest()
        while inflight and (drain or len(inflight) > 1):
            _finish_oldest()

    while c is not None:
        for pos in _chunk_positions(c, chunk_entries, n):
            key, name, data = _entry(reader, pos)
            prepped = encode_pdb_device(data, anchor_threshold,
                                        fallback_title=name)
            if prepped is None:
                raise RuntimeError("native parser unavailable")
            got = False
            for t, m in zip(*prepped):
                if t is None or m.get("error"):
                    continue
                pend_t.append(t)
                pend_m.append(m)
                pend_e.append((key, name, pos))
                got = True
            if not got:
                done.add(pos)
        flush_full()
        c = _claim(guard, claimed)
    flush_full(drain=True)
    # the ragged tail (< batch_size fragments) is NOT device-encoded:
    # flushes are entry-atomic, so tail entries are simply absent from
    # `done` and fall through to the native mop-up (which re-encodes
    # them byte-exactly at CPU speed, cheaper than waiting out one more
    # device batch on a degraded link).


def run_hybrid_db(mode: str, db_path: str, out_path: str, n_native: int,
                  chunk_entries: int = 64, batch_size: int = 128,
                  anchor_threshold: int = 25, use_alt_order: bool = False,
                  use_device: bool = True, device=None) -> int:
    """db -> db (de)compress across `n_native` CPU workers plus the
    in-process device stream on `device` (None: the CUDA card), merged
    into one database.

    Returns 0 on success, 1 when a native worker or the device stream
    failed; after a device-stream failure the database is still whole.
    When the GIL-free C chunk loops are available
    (fcz_db_{decode,encode}_range: the reader/writer handles engage),
    the native workers are plain THREADS: each chunk runs as one C call
    that drops the GIL, so threads scale like processes without the
    ~0.3 s/worker python spawn+import. Otherwise they are separate
    processes (the per-entry Python loop convoys on the GIL), started
    with subprocess.Popen: no fork of a process that may hold a CUDA
    context, and they never import torch."""
    probe = DatabaseReader(db_path, use_lookup=True)
    n = len(probe)
    try:
        from ..native import get_lib
        _lib = get_lib()
    except Exception:
        _lib = None
    use_threads = _lib is not None and getattr(probe, "_h", None) is not None
    probe.close()
    # the parent is a full CPU worker when there is no device stream (it
    # goes straight to the mop-up steal loop), so spawn one fewer worker:
    # -t N means N compute lanes, and oversubscribing cores just adds
    # context-switching
    n_workers = n_native if use_device else max(n_native - 1, 0)
    n_chunks = -(-n // chunk_entries)
    ctrl_path = out_path + ".hybrid_ctrl"
    ctrl = ChunkController.create(ctrl_path, n_chunks)

    worker_fn = ("native_decompress_worker" if mode == "decompress"
                 else "native_compress_worker")
    extra = () if mode == "decompress" else (anchor_threshold,)
    procs = []
    threads = []
    thread_rc = []
    if use_threads:
        import threading

        def tmain(wid):
            try:
                globals()[worker_fn](db_path, out_path, wid, ctrl_path,
                                     chunk_entries, *extra)
            except Exception as e:  # noqa: BLE001
                print(f"[Error] hybrid worker {wid}: {e}", file=sys.stderr)
                thread_rc.append(1)

        threads = [threading.Thread(target=tmain, args=(wid,), daemon=True)
                   for wid in range(n_workers)]
        for t in threads:
            t.start()
    else:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        extra_s = "" if mode == "decompress" else f", {anchor_threshold}"
        for wid in range(n_workers):
            # this module by its own name: the workers import nothing of
            # another package
            code = (f"import sys; sys.path.insert(0, {repo!r})\n"
                    f"from {__name__} import {worker_fn}\n"
                    f"{worker_fn}({db_path!r}, {out_path!r}, {wid}, "
                    f"{ctrl_path!r}, {chunk_entries}{extra_s})\n")
            procs.append(subprocess.Popen([sys.executable, "-c", code]))

    # Device stream in THIS process (shard id n_native). A failure (no
    # card, a kernel that does not build or launch) is an error: the
    # native codec finishes the chunks the stream had claimed, so the
    # database is complete, and the job returns 1.
    device_failed = False
    claimed: list[int] = []
    done: set[int] = set()
    reader = DatabaseReader(db_path, use_lookup=True)
    writer = DatabaseWriter(shard_db_path(out_path, n_workers))
    try:
        if use_device:
            try:
                if mode == "decompress":
                    _device_decompress(reader, writer, ctrl, chunk_entries,
                                       batch_size, use_alt_order, claimed,
                                       done, device)
                else:
                    _device_compress(reader, writer, ctrl, chunk_entries,
                                     batch_size, anchor_threshold, claimed,
                                     done, device)
            except Exception as e:  # noqa: BLE001 — reported, rc 1
                print(f"[Error] device stream failed ({e!r}); finishing "
                      "its chunks on CPU", file=sys.stderr)
                device_failed = True
        # native mop-up in-parent: chunks the device claimed but did not
        # finish, plus (use_device=False / post-failure) the whole back half
        _native_mop_up(mode, reader, writer, ctrl, chunk_entries, claimed,
                       done, anchor_threshold)
    finally:
        writer.close()
        reader.close()
    rc = 0
    for t in threads:
        t.join()
    rc |= 1 if thread_rc else 0
    for p in procs:
        rc |= p.wait()
    try:
        os.remove(ctrl_path)
    except OSError:
        pass
    if rc:
        print("[Error] hybrid native worker failed", file=sys.stderr)
        return 1
    merge_shard_dbs(out_path, n_workers + 1)
    if use_device:
        # the device share of the job: entries the stream finished
        # (written, or skipped as unparseable)
        print(f"[Info] hybrid: the device stream finished {len(done)} of "
              f"{n} entries", file=sys.stderr)
    return 1 if device_failed else 0


def _native_mop_up(mode, reader, writer, ctrl, chunk_entries, claimed, done,
                   anchor_threshold):
    """Finish leftovers natively in the parent, then keep stealing chunks
    ONE AT A TIME, processing each before claiming the next — bulk
    draining the controller here would starve the worker processes and
    serialize the remaining work onto this single process."""
    n = len(reader)
    proc_range = None

    if mode == "decompress":
        from ..native import decode_fcz_pdb_native, get_lib
        lib = get_lib()
        if lib is not None and getattr(reader, "_h", None) and \
                getattr(writer, "_h", None):
            # whole mop-up chunks run GIL-free in C; stragglers from the
            # device's claimed chunks go one by one through the same call
            def proc(pos):
                _decode_range_native(lib, reader, writer, pos, pos + 1)

            def proc_range(start, stop):
                _decode_range_native(lib, reader, writer, start, stop)
        elif lib is not None:
            def proc(pos):
                key, name, data = _entry(reader, pos)
                try:
                    payload = decode_fcz_pdb_native(data, as_bytes=True)
                except ValueError:
                    return
                writer.append(payload + b"\x00", key, name)
        else:
            from ..codec import fcz
            from ..codec.decoder import decode
            from ..io.pdb import format_pdb

            def proc(pos):
                key, name, data = _entry(reader, pos)
                try:
                    f = fcz.parse(data)
                    text = format_pdb(decode(f), f.title)
                except Exception:
                    return
                writer.append(text.encode() + b"\x00", key, name)
    else:
        from ..native import encode_pdb_native, get_lib
        lib = get_lib()
        if lib is not None and getattr(reader, "_h", None) and \
                getattr(writer, "_h", None):
            def proc(pos):
                _encode_range_native(lib, reader, writer, pos, pos + 1,
                                     anchor_threshold)

            def proc_range(start, stop):
                _encode_range_native(lib, reader, writer, start, stop,
                                     anchor_threshold)
        else:
            def proc(pos):
                key, name, data = _entry(reader, pos)
                try:
                    frags = encode_pdb_native(data, anchor_threshold, None,
                                              split=True,
                                              fallback_title=name)
                except Exception:
                    return
                for f in frags or []:
                    if not f["error"]:
                        writer.append(f["blob"], key, name)

    for c in claimed:
        for pos in _chunk_positions(c, chunk_entries, n):
            if pos not in done:
                proc(pos)
    while (c := ctrl.take_back()) is not None:
        pr = _chunk_positions(c, chunk_entries, n)
        if proc_range is not None:
            proc_range(pr.start, pr.stop)
        else:
            for pos in pr:
                proc(pos)
