"""Command line of the port: `python -m foldcomp_tpu_torch`.

`compress --fast` and `decompress --fast` run here, through the port's
device encode and decode (codec/batch.py encode_submit/encode_finish and
decode_fcz_stream). Every other mode and route is passed unchanged to
foldcomp_tpu.cli.main: the exact native paths load no JAX, and the JAX
device routes still to port (warmup, the hybrid scheduler) stay there.

The flags, input processors, output sinks, naming rules and banners are
foldcomp_tpu's own (parse_args, make_processor, OutputSink); this module
mirrors main's flow for the two fast modes (foldcomp_tpu/cli.py:1262-1452)
and _run_compress_fast / _run_decompress_fast (:467-606, :675-716).
"""
from __future__ import annotations

import collections
import gzip
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from foldcomp_tpu import cli as tpu_cli
from foldcomp_tpu.cli import (OutputSink, _compress_write, _decompress_write,
                              base_name, get_file_parts, iter_file_list,
                              make_processor, parse_args,
                              parse_structure_buffer)
from foldcomp_tpu.codec import fcz
from foldcomp_tpu.codec.batch import encode_pdb_device
from foldcomp_tpu.codec.encoder import EncodeError, encode
from foldcomp_tpu.codec.extract import (SUCCESS, VALIDITY_MESSAGES,
                                        check_validity)
from foldcomp_tpu.io.db import is_database
from foldcomp_tpu.io.structure import (identify_chains,
                                       identify_discontinuous_fragments,
                                       remove_alternative_positions)

# device batch size: the JAX package's healthy-link value
# (foldcomp_tpu/cli.py:842-843); FOLDCOMP_TPU_BATCH overrides as there
FAST_BATCH = 2048

_SUFFIX = {"compress": "fcz", "decompress": "pdb"}
_VERB = {"compress": "Compressing", "decompress": "Decompressing"}


def fast_batch_size() -> int:
    env = os.environ.get("FOLDCOMP_TPU_BATCH")
    if env:
        try:
            return max(int(env), 1)
        except ValueError:
            pass
    return FAST_BATCH


def _run_compress_fast(opts, entries, sink, sink_kind, output: str,
                       device) -> int:
    """Batched device encode. PDB entries go through the vectorized
    native parse (encode_pdb_device), in batches of fast_batch_size()
    with one batch in flight; CIF and other entries through the fragment
    path, with a per-fragment exact retry when a fragment poisons its
    batch. FOLDCOMP_TPU_PLANAR_WIRE=0 selects the numpy compact wire, as
    in the JAX package."""
    from .codec.batch import (encode_finish, encode_fragment_batch,
                              encode_submit)

    bsz = fast_batch_size()
    native_wire = os.environ.get("FOLDCOMP_TPU_PLANAR_WIRE", "1") != "0"
    pending_t = []                    # (fname, parts, tensors, meta)
    inflight = collections.deque()    # (entries, finish future)
    # one finisher thread: batch k's device wait and host finish overlap
    # batch k+1's parse and pack on this thread; one worker keeps the
    # output order
    fin_pool = ThreadPoolExecutor(max_workers=1)

    def finish_oldest():
        batch, fut = inflight.popleft()
        for (fname, parts, _, _), f in zip(batch, fut.result()):
            if f is not None:
                _compress_write(sink, sink_kind, output, fname,
                                fcz.serialize(f), parts)

    def flush_tensors(drain: bool = False):
        if pending_t:
            handle = encode_submit([t for _, _, t, _ in pending_t],
                                   [m for _, _, _, m in pending_t],
                                   anchor_threshold=opts.anchor_threshold,
                                   device=device, native_wire=native_wire)
            inflight.append((list(pending_t),
                             fin_pool.submit(encode_finish, handle)))
            pending_t.clear()
        while len(inflight) > (0 if drain else 1):
            finish_oldest()

    def try_device_path(name, buf):
        """True if the entry went through the native PDB parse."""
        base = base_name(name)
        parts = get_file_parts(base)
        if base.lower().endswith((".cif", ".cif.gz")):
            return False
        raw = gzip.decompress(buf) if buf[:2] == b"\x1f\x8b" else buf
        if raw.lstrip()[:5] == b"data_":
            return False
        fallback = get_file_parts(output)[0] if sink_kind == "file" \
            else parts[0]
        try:
            res = encode_pdb_device(raw, opts.anchor_threshold, title=None,
                                    fallback_title=fallback)
        except Exception:  # noqa: BLE001 — the fragment path reports it
            return False
        if res is None:
            return False
        for t, m in zip(*res):
            if m["error"]:
                print(f"[Error] {base}: {m['error']}", file=sys.stderr)
                continue
            if opts.skip_discontinuous and m["n_frags_in_chain"] > 1:
                continue
            fname = parts[0]
            if m["n_chains"] > 1:
                fname += m["chain"]
            if m["n_frags_in_chain"] > 1:
                fname += f"_{m['frag_ord']}"
            pending_t.append((fname, parts, t, m))
        if len(pending_t) >= bsz:
            flush_tensors()
        return True

    pending = []                      # (fname, parts, fragment)

    def flush():
        if not pending:
            return
        try:
            fczs = encode_fragment_batch(
                [frag for _, _, frag in pending],
                anchor_threshold=opts.anchor_threshold, device=device,
                native_wire=native_wire)
        except EncodeError:
            # a bad fragment poisons the batch: encode each exactly so
            # that only the broken entries are skipped
            fczs = []
            for fname, _, frag in pending:
                try:
                    fczs.append(encode(
                        frag, anchor_threshold=opts.anchor_threshold,
                        title=frag.title))
                except EncodeError as e:
                    print(f"[Error] {fname}: {e}", file=sys.stderr)
                    fczs.append(None)
        for (fname, parts, _), f in zip(pending, fczs):
            if f is not None:
                _compress_write(sink, sink_kind, output, fname,
                                fcz.serialize(f), parts)
        pending.clear()

    try:
        for name, buf in entries:
            if try_device_path(name, bytes(buf)):
                continue
            base = base_name(name)
            parts = get_file_parts(base)
            try:
                atoms = parse_structure_buffer(buf, base)
            except Exception as e:  # noqa: BLE001 — reported, entry skipped
                print(f"[Error] {base}: {e}", file=sys.stderr)
                continue
            if len(atoms) == 0:
                print(f"[Error] No atoms found in the input file: {base}",
                      file=sys.stderr)
                continue
            fallback = get_file_parts(output)[0] \
                if sink_kind == "file" else parts[0]
            title = fallback if atoms.title == base else atoms.title
            atoms = remove_alternative_positions(atoms)
            chains = identify_chains(atoms)
            for cs, ce in chains:
                frags = identify_discontinuous_fragments(atoms, cs, ce)
                if opts.skip_discontinuous and len(frags) > 1:
                    print(f"Skipping discontinuous chain: {base}",
                          file=sys.stderr)
                    continue
                for fi, (fs, fe) in enumerate(frags):
                    frag = atoms.slice(fs, fe)
                    frag.title = title
                    fname = parts[0]
                    if len(chains) > 1:
                        fname += atoms.chain[cs]
                    if len(frags) > 1:
                        fname += f"_{fi}"
                    pending.append((fname, parts, frag))
                    if len(pending) >= bsz:
                        flush()
        flush_tensors(drain=True)
        flush()
    finally:
        fin_pool.shutdown(wait=True)
        sink.close()
    return 0


def _run_decompress_fast(opts, entries, sink, sink_kind, output: str,
                         device) -> int:
    """Pipelined device decode; outputs written in input order."""
    from .codec.batch import decode_fcz_stream

    def payloads():
        for name, buf in entries:
            try:
                f = fcz.parse(bytes(buf))
            except fcz.FczFormatError:
                print("[Error] File is not a valid fcz file",
                      file=sys.stderr)
                continue
            if opts.check_before:
                err = check_validity(f)
                if err != SUCCESS:
                    print(VALIDITY_MESSAGES[err] + f.title, file=sys.stderr)
                    continue
            f.entry_name = name
            yield f

    t_last = time.perf_counter()
    n_done = 0
    bsz = fast_batch_size()
    try:
        for f, text in decode_fcz_stream(payloads(), batch_size=bsz,
                                         use_alt_order=opts.alt,
                                         device=device):
            _decompress_write(sink, sink_kind, output, f.entry_name, text)
            n_done += 1
            if opts.measure_time and n_done % bsz == 0:
                now = time.perf_counter()
                print(f"batch[{n_done - bsz}:{n_done}]\t"
                      f"{now - t_last:.6f}")
                t_last = now
    finally:
        sink.close()
    return 0


_RUNNERS = {"compress": _run_compress_fast,
            "decompress": _run_decompress_fast}


def _run_fast(mode, opts, pos) -> int:
    """main's flow for `compress --fast` and `decompress --fast`
    (foldcomp_tpu/cli.py:1298-1452): the input check, the device, the file
    list, output naming and banners, then one sink per input source."""
    from .backend import DeviceUnavailable, resolve_device

    inp = pos[1].rstrip("/") if pos[1] != "/" else pos[1]
    output = pos[2].rstrip("/") if len(pos) > 2 else None
    if not inp.startswith("gcs://") and not os.path.exists(inp) \
            and not is_database(inp):
        print(f"[Error] {inp} does not exist.", file=sys.stderr)
        return 1
    try:
        device = resolve_device(None)
    except DeviceUnavailable as e:
        print(f"[Error] --fast: {e}", file=sys.stderr)
        return 1

    inputs = [inp]
    single_files = []
    if opts.file_input:
        inputs = []
        with open(inp) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                if line.endswith((".pdb", ".pdb.gz", ".cif", ".cif.gz",
                                  ".fcz")):
                    single_files.append(line)
                else:
                    inputs.append(line)
    if output and output.endswith(".tar"):
        opts.save_as_tar = True
    single = (not opts.file_input and os.path.isfile(inp)
              and not inp.endswith((".tar", ".tar.gz", ".tgz"))
              and not is_database(inp))
    suffix = _SUFFIX[mode]
    if output is None:
        if opts.db_output:
            output = inp + "_db"
        elif opts.save_as_tar:
            output = inp + "." + suffix + ".tar"
        elif single:
            output = get_file_parts(inp)[0] + "." + suffix
        else:
            output = inp + "_" + suffix

    if single:
        print(f"{_VERB[mode]} {inp} to {output}")
    else:
        print(f"{_VERB[mode]} files in {inp} using {opts.threads} threads")
        if opts.db_output:
            print(f"Output database: {output}")
        elif opts.save_as_tar:
            print(f"Output tar file: {output}")
        else:
            print(f"Output directory: {output}")

    sources = [make_processor(i, opts.recursive, opts.id_file, opts.id_mode,
                              opts.use_cache) for i in inputs]
    if single_files:
        sources.append(iter_file_list(single_files))
    sink_kind = ("db" if opts.db_output else
                 "tar" if opts.save_as_tar else
                 "file" if single else "dir")
    rc = 0
    for entries in sources:
        sink = OutputSink(sink_kind, output, opts.overwrite)
        rc |= _RUNNERS[mode](opts, entries, sink, sink_kind, output, device)
    return rc


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv:
        opts, pos = parse_args(argv)
        if opts.fast and len(pos) >= 2 and pos[0] in _RUNNERS:
            return _run_fast(pos[0], opts, pos)
    return tpu_cli.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
