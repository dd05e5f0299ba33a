"""Multi-host data-parallel database processing, and the ranks of the
multi-device layers.

Replacement for the reference's single-node OpenMP fan-out
(input_processor.h:69-346): database entries are sharded by contiguous
index ranges, each shard streams through the codec and writes a
shard-local MMseqs2-style database, and the shards are merged into one
database by rebasing index offsets (host-side, no collectives needed: the
per-protein codec requires no cross-device communication).

The port's own copy of `foldcomp_tpu/parallel/dist.py:1`, kept line for
line but for two things: the `fast=True` branches run the port's device
decode and encode on an explicit `device` (None: the CUDA card, see
backend.resolve_device), and `init_distributed` joins a torch.distributed
process group instead of the JAX runtime: one process per card (the
torchrun model), NCCL between CUDA ranks and gloo between CPU ranks, the
backend chosen from the rank's device. `local_device` gives a rank its
card, and `spawn_ranks` starts one process per rank on this host, joined
over a file:// store (pipeline.py, seqpar.py, scaling.py and dryrun.py
run their ranks through it).

The module imports torch only inside the functions that join or start
ranks and in the `fast=True` branches, so that the native CPU workers
that import it never load torch.
"""
from __future__ import annotations

import os
import shutil

from ..io.db import DatabaseReader, DatabaseWriter


def shard_range(n: int, shard: int, n_shards: int):
    """Contiguous [start, end) range of entries owned by `shard`."""
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} out of range of {n_shards}")
    base = n // n_shards
    rem = n % n_shards
    start = shard * base + min(shard, rem)
    end = start + base + (1 if shard < rem else 0)
    return start, end


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, *,
                     init_method: str | None = None, device=None,
                     timeout: float = 60.0):
    """torch.distributed.init_process_group wrapper; returns (rank,
    world_size).

    The rank and world size come from the arguments, else from torchrun's
    RANK and WORLD_SIZE; the rendezvous from `init_method` (a file:// store
    in the tests), else tcp://`coordinator_address`, else torchrun's
    MASTER_ADDR/MASTER_PORT (env://). With none of these set it returns
    (0, 1) without creating a process group, as the JAX package's does.

    The rank's device is `device`, else local_device(); the backend is
    `backend`, else "nccl" for a CUDA device and "gloo" for the CPU. It is
    never chosen by trying one and then the other. A CUDA rank's device is
    made current before the group is created. Every collective of the
    group fails after `timeout` seconds instead of waiting for a rank that
    is gone."""
    env = os.environ
    if coordinator_address is None and init_method is None and \
            num_processes is None and "MASTER_ADDR" not in env and \
            "WORLD_SIZE" not in env:
        return 0, 1
    import datetime

    import torch
    import torch.distributed as tdist

    from ..backend import resolve_device
    if tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else env.get("RANK", 0))
    if init_method is None:
        init_method = (f"tcp://{coordinator_address}" if coordinator_address
                       else "env://")
    dev = local_device(int(env.get("LOCAL_RANK", rank))) if device is None \
        else resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=world, rank=rank,
                             timeout=datetime.timedelta(seconds=timeout))
    return tdist.get_rank(), tdist.get_world_size()


def local_device(local_rank: int | None = None):
    """This rank's device: cuda:`local_rank` (default: torchrun's
    LOCAL_RANK, else 0) through backend.resolve_device, or the CPU where
    FOLDCOMP_TORCH_DEVICE=cpu asks for it. Without that card it raises
    DeviceUnavailable."""
    import torch

    from ..backend import DEVICE_ENV, DeviceUnavailable, resolve_device
    if os.environ.get(DEVICE_ENV) == "cpu":
        return resolve_device("cpu")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    dev = resolve_device(f"cuda:{local_rank}")
    if dev.index >= torch.cuda.device_count():
        raise DeviceUnavailable(f"{dev}: this host has "
                                f"{torch.cuda.device_count()} CUDA devices")
    return dev


def shard_db_path(out_path: str, shard: int) -> str:
    return f"{out_path}.{shard}"


def decompress_db_shard(db_path: str, out_path: str, shard: int,
                        n_shards: int, batch_size: int = 128,
                        fast: bool = True, device=None) -> int:
    """Decompress this shard's entry range into a shard-local database.

    Returns the number of entries written. The shard database keeps the
    original entry keys so the merged index is order-independent. With
    fast=True the entries go through the device decode on `device`.
    """
    from ..codec import fcz

    have_native = False
    lib = None
    if not fast:
        try:
            from ..native import decode_fcz_pdb_native, get_lib
            lib = get_lib()
            have_native = lib is not None
        except Exception:
            have_native = False

    reader = DatabaseReader(db_path, use_lookup=True)
    writer = DatabaseWriter(shard_db_path(out_path, shard))
    n_written = 0
    try:
        start, end = shard_range(len(reader), shard, n_shards)
        if have_native and getattr(reader, "_h", None) and \
                getattr(writer, "_h", None):
            # whole shard range in GIL-free C chunk calls (hybrid.py
            # _decode_range_native); chunked so name resolution stays
            # amortized and progress is interruptible
            from .hybrid import _decode_range_native
            for c0 in range(start, end, 4096):
                n_written += _decode_range_native(
                    lib, reader, writer, c0, min(c0 + 4096, end))
            return n_written
        pending = []

        def flush():
            nonlocal n_written
            if not pending:
                return
            if fast:
                from ..codec.batch import decode_fcz_to_pdb_batch
                texts = decode_fcz_to_pdb_batch([f for _, _, f in pending],
                                                device=device)
            else:
                from ..codec.decoder import decode
                from ..io.pdb import format_pdb
                texts = [format_pdb(decode(f), f.title)
                         for _, _, f in pending]
            for (key, name, _), text in zip(pending, texts):
                writer.append(text.encode() + b"\x00", key, name)
                n_written += 1
            pending.clear()

        for pos in range(start, end):
            key = reader.get_key(pos)
            data = reader.get_data(pos)
            if data.endswith(b"\x00"):
                data = data[:-1]
            name = reader.name_of_key(key) or str(key)
            if have_native:
                # exact native decoder (byte-identical to the reference
                # binary, GIL-releasing C)
                try:
                    payload = decode_fcz_pdb_native(bytes(data),
                                                    as_bytes=True)
                except ValueError:
                    continue
                writer.append(payload + b"\x00", key, name)
                n_written += 1
                continue
            try:
                f = fcz.parse(data)
            except fcz.FczFormatError:
                continue
            pending.append((key, name, f))
            if len(pending) >= batch_size:
                flush()
        flush()
    finally:
        writer.close()
        reader.close()
    return n_written


def extract_db_shard(db_path: str, out_path: str, shard: int, n_shards: int,
                     ext_mode: int = 0, digits: int = 1,
                     use_title: bool = False, merged: bool = False) -> int:
    """Extract pLDDT/sequence from this shard's entry range.

    merged=False writes a shard-local database (keys preserved);
    merged=True writes the FASTA-like/TSV text to `out_path.<shard>` —
    shards are contiguous entry ranges, so concatenating the shard files
    in order reproduces the single-thread output byte-for-byte (the
    reference's omp merged extract is arrival-order nondeterministic;
    main.cpp:778-859).
    """
    from ..codec import fcz
    from ..codec.extract import (extract_plddt, extract_sequence,
                                 write_fasta_like, write_tsv)
    try:
        from ..native import get_lib
        lib = get_lib()
    except Exception:
        lib = None

    reader = DatabaseReader(db_path, use_lookup=True)
    writer = None
    out_fh = None
    if merged:
        out_fh = open(f"{out_path}.{shard}", "w")
    else:
        writer = DatabaseWriter(shard_db_path(out_path, shard))
    n_written = 0
    try:
        start, end = shard_range(len(reader), shard, n_shards)
        wh = getattr(writer, "_h", None) if writer is not None else None
        if lib is not None and getattr(reader, "_h", None) and \
                (merged or wh):
            # whole shard range in GIL-free C chunk calls; Python only
            # resolves the .lookup names
            from .hybrid import _range_names
            if merged:
                out_fh.flush()
            for c0 in range(start, end, 4096):
                c1 = min(c0 + 4096, end)
                r = lib.fcz_db_extract_range(
                    reader._h, wh, out_fh.fileno() if merged else -1,
                    c0, c1, _range_names(reader, c0, c1), ext_mode,
                    digits, 1 if use_title else 0)
                if r < 0:
                    raise MemoryError("fcz_db_extract_range failed")
                n_written += r
            return n_written
        for pos in range(start, end):
            key = reader.get_key(pos)
            data = reader.get_data(pos)
            if data.endswith(b"\x00"):
                data = data[:-1]
            name = reader.name_of_key(key) or str(key)
            try:
                f = fcz.parse(bytes(data))
            except fcz.FczFormatError:
                continue
            title = f.title if use_title else name
            if ext_mode == 0:
                payload = extract_plddt(f, digits)
            else:
                payload = extract_sequence(f)
            if ext_mode == 0 and digits > 1:
                text = write_tsv(title, f.n_residue, payload)
            else:
                text = write_fasta_like(title, payload)
            if merged:
                out_fh.write(text)
            else:
                writer.append(text.encode() + b"\x00", key, name)
            n_written += 1
    finally:
        if writer is not None:
            writer.close()
        if out_fh is not None:
            out_fh.close()
        reader.close()
    return n_written


def merge_shard_files(out_path: str, n_shards: int, cleanup: bool = True):
    """Concatenate `out_path.<shard>` text files into out_path in shard
    order (= global entry order for contiguous shard ranges)."""
    with open(out_path, "wb") as out:
        for s in range(n_shards):
            spath = f"{out_path}.{s}"
            with open(spath, "rb") as fh:
                shutil.copyfileobj(fh, out)
            if cleanup:
                os.remove(spath)


def merge_shard_dbs(out_path: str, n_shards: int, cleanup: bool = True):
    """Concatenate shard databases into one, rebasing index offsets.

    Mirrors what MMseqs2's mergeDbs does; the merged index is written
    sorted by key (database_writer.cpp close parity).
    """
    entries = []  # (key, offset, length, name)
    offset_base = 0
    with open(out_path, "wb") as out_data:
        for s in range(n_shards):
            spath = shard_db_path(out_path, s)
            with open(spath, "rb") as fh:
                # zero-copy concatenation: os.sendfile moves the shard in
                # kernel space (~10x shutil.copyfileobj on large shards)
                try:
                    remaining = os.path.getsize(spath)
                    out_data.flush()
                    while remaining > 0:
                        sent = os.sendfile(out_data.fileno(), fh.fileno(),
                                           None, remaining)
                        if sent == 0:
                            break
                        remaining -= sent
                    if remaining:
                        shutil.copyfileobj(fh, out_data)
                except OSError:
                    fh.seek(0)
                    shutil.copyfileobj(fh, out_data)
            sreader = DatabaseReader(spath, use_lookup=True)
            for pos in range(len(sreader)):
                key = sreader.get_key(pos)
                entries.append((key, offset_base + sreader.get_offset(pos),
                                sreader.get_length(pos),
                                sreader.name_of_key(key) or str(key)))
            size = os.path.getsize(spath)
            sreader.close()
            offset_base += size
    entries.sort(key=lambda e: e[0])
    with open(out_path + ".index", "w") as idx, \
            open(out_path + ".lookup", "w") as lkp:
        for key, off, ln, name in entries:
            idx.write(f"{key}\t{off}\t{ln}\n")
            lkp.write(f"{key}\t{name}\t0\n")
    with open(out_path + ".dbtype", "wb") as fh:
        fh.write((12).to_bytes(4, "little"))
    if cleanup:
        for s in range(n_shards):
            spath = shard_db_path(out_path, s)
            for suffix in ("", ".index", ".lookup", ".dbtype"):
                p = spath + suffix
                if os.path.exists(p):
                    os.remove(p)
    return len(entries)


def compress_db_shard(db_path: str, out_path: str, shard: int,
                      n_shards: int, anchor_threshold: int = 25,
                      fast: bool = True, batch_entries: int = 64,
                      device=None) -> int:
    """Compress this shard's range of a PDB-payload database to FCZ.

    fast=True (default) runs the batched device encoder on `device`: host
    prep is the vectorized raw-array pipeline
    (codec/batch_host.py encode_pdb_device), fragments from
    `batch_entries` database entries are encoded in one device batch
    (codec/batch.py encode_submit, the fused encode kernel), and the FCZ
    bytes are serialized host-side. fast=False keeps the per-entry native
    exact encoder (byte-identical to the reference binary). The device
    path needs the native parser; without it the native route runs.
    """
    reader = DatabaseReader(db_path, use_lookup=True)
    writer = DatabaseWriter(shard_db_path(out_path, shard))
    n_written = 0

    device_ready = False
    if fast:
        # no catch-all here: a device path that cannot start raises
        from ..codec.batch import encode_finish, encode_submit
        from ..codec.batch_host import encode_pdb_device
        from ..codec import fcz as fcz_mod
        device_ready = _get_lib_or_none() is not None

    try:
        start, end = shard_range(len(reader), shard, n_shards)
        if device_ready:
            import collections
            pend_tensors, pend_meta, pend_entry = [], [], []
            inflight = collections.deque()   # (entries, submit handle)

            def _finish_oldest():
                nonlocal n_written
                entries, handle = inflight.popleft()
                for f, (key, name) in zip(encode_finish(handle), entries):
                    if f is not None:
                        writer.append(fcz_mod.serialize(f), key, name)
                        n_written += 1

            def flush(drain: bool = False):
                # one batch in flight: the next batch's parse/pack
                # overlaps this one's device round trip + host finish
                if pend_tensors:
                    inflight.append((list(pend_entry), encode_submit(
                        pend_tensors, pend_meta, anchor_threshold,
                        device=device)))
                    pend_tensors.clear()
                    pend_meta.clear()
                    pend_entry.clear()
                while len(inflight) > (0 if drain else 1):
                    _finish_oldest()

            for pos in range(start, end):
                key = reader.get_key(pos)
                data = reader.get_data(pos)
                if data.endswith(b"\x00"):
                    data = data[:-1]
                name = reader.name_of_key(key) or str(key)
                prepped = encode_pdb_device(data, anchor_threshold,
                                            fallback_title=name)
                if prepped is None:
                    continue
                tensors, metas = prepped
                for t, m in zip(tensors, metas):
                    if t is None or m.get("error"):
                        continue
                    pend_tensors.append(t)
                    pend_meta.append(m)
                    pend_entry.append((key, name))
                if len(pend_entry) >= batch_entries:
                    flush()
            flush(drain=True)
        elif (_enc_lib := _get_lib_or_none()) is not None and \
                getattr(reader, "_h", None) and \
                getattr(writer, "_h", None):
            # whole range in GIL-free C chunk calls (hybrid.py)
            from .hybrid import _encode_range_native
            for c0 in range(start, end, 4096):
                n_written += _encode_range_native(
                    _enc_lib, reader, writer, c0, min(c0 + 4096, end),
                    anchor_threshold)
            return n_written
        else:
            from ..native import encode_pdb_native
            for pos in range(start, end):
                key = reader.get_key(pos)
                data = reader.get_data(pos)
                if data.endswith(b"\x00"):
                    data = data[:-1]
                name = reader.name_of_key(key) or str(key)
                frags = encode_pdb_native(data, anchor_threshold, None,
                                          split=True, fallback_title=name)
                for f in frags or []:
                    if not f["error"]:
                        writer.append(f["blob"], key, name)
                        n_written += 1
    finally:
        writer.close()
        reader.close()
    return n_written


def _get_lib_or_none():
    try:
        from ..native import get_lib
        return get_lib()
    except Exception:
        return None


def _rank_entry(results, rank, world, init_method, backend, device,
                pg_timeout, fn, args):
    """One spawned rank: join, build the mesh, run fn(mesh, *args), put
    (rank, True, result) or (rank, False, traceback) on `results`."""
    import traceback

    import torch.distributed as tdist
    try:
        init_distributed(init_method=init_method, num_processes=world,
                         process_id=rank, backend=backend, device=device,
                         timeout=pg_timeout)
        from .pipeline import make_mesh
        results.put((rank, True, fn(make_mesh(device=device), *args)))
    except Exception:  # noqa: BLE001 — the parent raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def spawn_ranks(fn, world_size: int, args=(), *, devices=None,
                backend: str | None = None, timeout: float = 600.0,
                pg_timeout: float = 60.0):
    """Run fn(mesh, *args) in `world_size` spawned processes on this host,
    one rank each, joined by init_distributed over a file:// store in a
    fresh temporary directory (no TCP port to collide on). Returns the
    ranks' results in rank order.

    fn is a module-level function (the spawned processes import it by
    name); args and results are pickled. devices: one device per rank
    (default cuda:rank); backend as init_distributed chooses it unless
    given. A rank that raises, exits without a result, or is not done
    after `timeout` seconds fails the call with RuntimeError, and the
    other ranks are killed; each collective gives up after `pg_timeout`."""
    import multiprocessing
    import queue
    import tempfile
    import time

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    devices = [f"cuda:{r}" for r in range(world_size)] if devices is None \
        else [str(d) for d in devices]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    done, errors = {}, []
    with tempfile.TemporaryDirectory(prefix="foldcomp_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_entry, daemon=True,
                             args=(results, r, world_size, init, backend,
                                   devices[r], pg_timeout, fn, tuple(args)))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(done) + len(errors) < world_size and not errors:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        errors.append(f"not done after {timeout} s")
                    gone = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in done]
                    if gone:
                        # a last message may still be in the pipe
                        try:
                            rank, ok, val = results.get(timeout=5.0)
                        except queue.Empty:
                            errors.append(f"ranks {gone} exited without "
                                          "a result")
                            continue
                    else:
                        continue
                if ok:
                    done[rank] = val
                else:
                    errors.append(f"rank {rank}:\n{val}")
        finally:
            for p in procs:
                p.join(timeout=0 if errors else 30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
    if errors:
        raise RuntimeError(f"{world_size}-rank run failed: "
                           + "\n".join(errors))
    return [done[r] for r in range(world_size)]
