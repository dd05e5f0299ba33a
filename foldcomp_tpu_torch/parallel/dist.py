"""Multi-host data-parallel database processing.

Replacement for the reference's single-node OpenMP fan-out
(input_processor.h:69-346): database entries are sharded by contiguous
index ranges, each shard streams through the codec and writes a
shard-local MMseqs2-style database, and the shards are merged into one
database by rebasing index offsets (host-side, no collectives needed: the
per-protein codec requires no cross-device communication).

The port's own copy of `foldcomp_tpu/parallel/dist.py:1`, kept line for
line but for two things: the `fast=True` branches run the port's device
decode and encode on an explicit `device` (None: the CUDA card, see
backend.resolve_device), and the JAX package's `init_distributed`
(jax.distributed) is not carried; multi-device bring-up is not ported yet.
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
