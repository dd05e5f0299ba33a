"""Command line of the port: `python -m foldcomp_tpu_torch`.

`decompress --fast` runs here, through the port's device decode
(codec/batch.py decode_fcz_stream). Every other mode and route is passed
unchanged to foldcomp_tpu.cli.main: the exact native paths load no JAX,
and the JAX device routes (compress --fast, warmup, the hybrid scheduler)
are not ported yet.

The flags, input processors, output sinks, naming rules and banners are
foldcomp_tpu's own (parse_args, make_processor, OutputSink); this module
mirrors main's decompress flow (foldcomp_tpu/cli.py:1262-1452) and
run_decompress / _run_decompress_fast (:861-887, :675-716).
"""
from __future__ import annotations

import os
import sys
import time

from foldcomp_tpu import cli as tpu_cli
from foldcomp_tpu.cli import (OutputSink, _decompress_write, get_file_parts,
                              iter_file_list, make_processor, parse_args)
from foldcomp_tpu.codec import fcz
from foldcomp_tpu.codec.extract import (SUCCESS, VALIDITY_MESSAGES,
                                        check_validity)
from foldcomp_tpu.io.db import is_database

# device batch size: the JAX package's healthy-link value
# (foldcomp_tpu/cli.py:842-843); FOLDCOMP_TPU_BATCH overrides as there
FAST_BATCH = 2048


def fast_batch_size() -> int:
    env = os.environ.get("FOLDCOMP_TPU_BATCH")
    if env:
        try:
            return max(int(env), 1)
        except ValueError:
            pass
    return FAST_BATCH


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


def _decompress_fast(opts, pos) -> int:
    """main's flow for `decompress --fast` (foldcomp_tpu/cli.py:1294-1452
    with mode == "decompress")."""
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
    if output is None:
        if opts.db_output:
            output = inp + "_db"
        elif opts.save_as_tar:
            output = inp + ".pdb.tar"
        elif single:
            output = get_file_parts(inp)[0] + ".pdb"
        else:
            output = inp + "_pdb"

    if single:
        print(f"Decompressing {inp} to {output}")
    else:
        print(f"Decompressing files in {inp} using {opts.threads} threads")
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
    rc = 0
    for entries in sources:
        sink_kind = ("db" if opts.db_output else
                     "tar" if opts.save_as_tar else
                     "file" if single else "dir")
        sink = OutputSink(sink_kind, output, opts.overwrite)
        rc |= _run_decompress_fast(opts, entries, sink, sink_kind, output,
                                   device)
    return rc


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv:
        opts, pos = parse_args(argv)
        if opts.fast and len(pos) >= 2 and pos[0] == "decompress":
            return _decompress_fast(opts, pos)
    return tpu_cli.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
