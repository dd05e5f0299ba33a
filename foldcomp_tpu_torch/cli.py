"""Command line of the port: `python -m foldcomp_tpu_torch`.

The port's own copy of foldcomp_tpu/cli.py's host parts, kept line for line
so that every exact route writes the same bytes as `python -m foldcomp_tpu`
(tests/test_torch_standalone.py holds the two to the same databases):

- :76-465, the names, the input iterators and `make_processor`,
  `OutputSink`, `Options`/`parse_args`/`USAGE`, `compress_entry` and
  `_compress_write`;
- `run_compress` (:609) and `_decompress_write` (:662);
- `run_decompress`, `run_extract` and `run_check` (:861-1010);
- `run_rmsd` and `run_subdb` (:1211-1259);
- `main`'s flow (:1262-1452);
- the link probe `_probe_info` (:719-818), measured with torch, which
  here only chooses the decode wire (codec/batch.py use_bb_wire).

So compress, decompress, extract, check, rmsd and subdb run here over
files, directories, tars and databases. `compress --fast` and
`decompress --fast` run through the port's device encode and decode
(codec/batch.py encode_submit/encode_finish and decode_fcz_stream),
mirroring _run_compress_fast / _run_decompress_fast (:467-606, :675-716).

Not carried, because they bind the JAX package's device code: the db->db
hybrid and sharded scheduler (:1377-1421), the sharded db extract
(:1426-1432), the probe's other consumers (the auto-`--fast` of
run_decompress, :871-885, and the batch size of fast_batch_size, :825)
and `warmup` (:1279). Where foldcomp_tpu would take the scheduler or the
sharded extract, this CLI takes the in-process route of the same mode,
which writes the same bytes, and says so in one [Info] line on stderr;
batch decompress stays exact unless `--fast` is given; `warmup` exits 1.
"""
from __future__ import annotations

import collections
import gzip
import io
import os
import sys
import tarfile
import time
from concurrent.futures import ThreadPoolExecutor
from threading import Lock

from .codec import fcz
from .codec.decoder import decode
from .codec.encoder import EncodeError, encode
from .codec.extract import (SUCCESS, VALIDITY_MESSAGES, check_validity,
                            extract_plddt, extract_sequence, write_fasta_like,
                            write_tsv)
from .core import exact
from .io.db import DatabaseReader, DatabaseWriter, is_database
from .io.pdb import format_pdb, parse_pdb
from .io.cif import parse_cif
from .io.structure import (AtomArray, identify_chains,
                           identify_discontinuous_fragments,
                           remove_alternative_positions)

VERSION = "0.1.0"

USAGE = """\
Usage: foldcomp_tpu_torch compress <pdb|cif> [<fcz>]
       foldcomp_tpu_torch compress [-t number] <dir|tar(.gz)> [<dir|tar|db>]
       foldcomp_tpu_torch decompress <fcz|tar> [<pdb>]
       foldcomp_tpu_torch decompress [-t number] <dir|tar(.gz)|db> [<dir|tar>]
       foldcomp_tpu_torch extract [--plddt|--amino-acid] <fcz> [<fasta>]
       foldcomp_tpu_torch extract [--plddt|--amino-acid] [-t number] <dir|tar(.gz)|db> [<fasta_out>]
       foldcomp_tpu_torch check <fcz>
       foldcomp_tpu_torch check [-t number] <dir|tar(.gz)|db>
       foldcomp_tpu_torch rmsd <pdb|cif> <pdb|cif>
       foldcomp_tpu_torch subdb <id_list> <db_in> <db_out>   (extension: mmseqs createsubdb equivalent)
       foldcomp_tpu_torch warmup <fcz|pdb|dir|db>            (not ported yet: exits 1)
 -h, --help               print this help message
 -v, --version            print version
 -t, --threads            threads for (de)compression of folders/tar files [default=1]
 -r, --recursive          recursively look for files in directory [default=0]
 -f, --file               input is a list of files [default=0]
 -a, --alt                use alternative atom order [default=false]
 -b, --break              interval size to save absolute atom coordinates [default=25]
 -z, --tar                save as tar file [default=false]
 -d, --db                 save as database [default=false]
 -y, --overwrite          overwrite existing files [default=false]
 -l, --id-list            a file of id list to be processed (only for database input)
 -m, --id-mode            id mode for database input. 0: database keys, 1: names (.lookup) [default=1]
 --skip-discontinuous     skip PDB with with discontinuous residues (only batch compression)
 --check                  check FCZ before and skip entries with error (only for batch decompression)
 --plddt                  extract pLDDT score (only for extraction mode)
 -p, --plddt-digits       extract pLDDT score with specified number of digits (only for extraction mode)
 --fasta, --amino-acid    extract amino acid sequence (only for extraction mode)
 --no-merge               do not merge output files (only for extraction mode)
 --use-title              use TITLE as the output file name (only for extraction mode)
 --time                   measure time for compression/decompression
 --use-cache              use cached index for database input [default=false]
 --fast                   use the batched CUDA codec instead of the exact path
 --exact                  force the exact native codec (the default here)
"""


def base_name(path: str) -> str:
    return path.rstrip("/").split("/")[-1]


def get_file_parts(path: str):
    """getFileParts parity (utility.cpp:118-127)."""
    base_pos = max(path.rfind("/"), path.rfind("\\"))
    base_pos = 0 if base_pos < 0 else base_pos + 1
    ext_start = path[base_pos:].rfind(".")
    if ext_start < 0:
        return path, ""
    return path[:base_pos + ext_start], path[base_pos + ext_start + 1:]


def is_compressible(parts) -> bool:
    name, ext = parts
    if ext in ("pdb", "cif"):
        return True
    if ext == "gz":
        return get_file_parts(name)[1] in ("pdb", "cif")
    return False


def parse_structure_buffer(buf: bytes, name: str) -> AtomArray:
    """Dispatch PDB vs mmCIF like gemmi's format-from-extension, with gz."""
    if buf[:2] == b"\x1f\x8b":
        buf = gzip.decompress(buf)
    lowered = name.lower()
    if lowered.endswith(".cif") or lowered.endswith(".cif.gz") or \
            buf.lstrip()[:5] == b"data_":
        return parse_cif(buf, default_title=name)
    return parse_pdb(buf, default_title=name)


# ---------------------------------------------------------------------------
# Input processors (input_processor.h:69-346 equivalents)

def iter_directory(path: str, recursive: bool = False):
    if recursive:
        for root, _dirs, files in os.walk(path):
            for fn in sorted(files):
                full = os.path.join(root, fn)
                with open(full, "rb") as fh:
                    yield full, fh.read()
    else:
        for fn in sorted(os.listdir(path)):
            full = os.path.join(path, fn)
            if os.path.isfile(full):
                with open(full, "rb") as fh:
                    yield full, fh.read()


def iter_tar(path: str):
    with tarfile.open(path, "r:*") as tf:
        for member in tf:
            if not member.isfile():
                continue
            fh = tf.extractfile(member)
            if fh is None:
                continue
            yield member.name, fh.read()


def iter_database(path: str, id_file: str | None = None, id_mode: int = 1,
                  use_cache: bool = False):
    reader = DatabaseReader(path, use_lookup=True, use_cache=use_cache)
    try:
        if id_file:
            with open(id_file) as fh:
                wanted = [ln.strip() for ln in fh if ln.strip()]
            for ident in wanted:
                if id_mode == 1:
                    key = reader.lookup_key(ident)
                    if key == 0xFFFFFFFF:
                        print(f"[Error] {ident} not found in database",
                              file=sys.stderr)
                        continue
                    name = ident
                else:
                    key = int(ident)
                    name = reader.name_of_key(key) or str(key)
                pos = reader.position_of_key(key)
                if pos < 0:
                    print(f"[Error] {ident} not found in database",
                          file=sys.stderr)
                    continue
                yield name, reader.get_data(pos)
        else:
            for key, name, data in reader.entries():
                yield (name or str(key)), data
    finally:
        reader.close()


def iter_file_list(paths):
    for p in paths:
        with open(p, "rb") as fh:
            yield p, fh.read()


def iter_gcs(uri: str, client=None):
    """GcsProcessor equivalent (input_processor.h:302-346): stream objects
    under gcs://bucket/prefix as (name, bytes). Requires the optional
    google-cloud-storage package unless a client is injected."""
    rest = uri[len("gcs://"):]
    bucket_name, _, prefix = rest.partition("/")
    if client is None:
        try:
            from google.cloud import storage  # type: ignore
        except ImportError as e:
            raise SystemExit(
                "[Error] gcs:// input requires the google-cloud-storage "
                "package") from e
        client = storage.Client.create_anonymous_client()
    bucket = client.bucket(bucket_name)
    for blob in client.list_blobs(bucket, prefix=prefix):
        name = blob.name
        if name.endswith("/"):
            continue
        yield name, blob.download_as_bytes()


def make_processor(inp: str, recursive: bool, id_file: str | None,
                   id_mode: int, use_cache: bool = False):
    if inp.startswith("gcs://"):
        return iter_gcs(inp)
    if inp.endswith((".tar", ".tar.gz", ".tgz")):
        return iter_tar(inp)
    if is_database(inp):
        return iter_database(inp, id_file, id_mode, use_cache)
    if os.path.isdir(inp):
        return iter_directory(inp, recursive)
    return iter_file_list([inp])


# ---------------------------------------------------------------------------
# Output sinks

class OutputSink:
    """Serialized writers for file/dir/tar/db outputs (omp critical regions
    in main.cpp:510-530 / 656-687)."""

    def __init__(self, kind: str, output: str, overwrite: bool):
        self.kind = kind
        self.output = output
        self.overwrite = overwrite
        self.lock = Lock()
        self.key = 0
        self._tar = None
        self._db = None
        self._merged = None
        if kind == "tar":
            self._tar = tarfile.open(output, "w")
        elif kind == "db":
            self._db = DatabaseWriter(output)
        elif kind == "dir":
            os.makedirs(output, exist_ok=True)
        elif kind == "merged":
            self._merged = open(output, "w")

    def write(self, name: str, data: bytes) -> bool:
        if self.kind == "db":
            with self.lock:
                self._db.append(data, self.key, name)
                self.key += 1
        elif self.kind == "tar":
            with self.lock:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                self._tar.addfile(info, io.BytesIO(data))
        elif self.kind == "merged":
            with self.lock:
                self._merged.write(data.decode("utf-8", "replace"))
        else:
            path = name if self.kind == "file" else os.path.join(
                self.output, name)
            if os.path.exists(path) and not self.overwrite:
                print(f"[Error] Output file already exists: {base_name(path)}",
                      file=sys.stderr)
                return False
            with open(path, "wb") as fh:
                fh.write(data)
        return True

    def close(self):
        if self._tar is not None:
            self._tar.close()
        if self._db is not None:
            self._db.close()
        if self._merged is not None:
            self._merged.close()


# ---------------------------------------------------------------------------

class Options:
    threads = 1
    recursive = False
    file_input = False
    alt = False
    anchor_threshold = fcz.DEFAULT_ANCHOR_THRESHOLD
    save_as_tar = False
    db_output = False
    overwrite = False
    id_file = None
    id_mode = 1
    ext_mode = 0
    ext_plddt_digits = 1
    ext_merge = True
    ext_use_title = False
    measure_time = False
    skip_discontinuous = False
    check_before = False
    use_cache = False
    fast = False
    exact = False


def parse_args(argv):
    opts = Options()
    pos = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(USAGE, end="")
            raise SystemExit(0)
        elif a in ("-v", "--version"):
            print(f"foldcomp_tpu_torch {VERSION}")
            raise SystemExit(0)
        elif a in ("-t", "--threads"):
            i += 1
            opts.threads = int(argv[i])
        elif a in ("-r", "--recursive"):
            opts.recursive = True
        elif a in ("-f", "--file"):
            opts.file_input = True
        elif a in ("-a", "--alt"):
            opts.alt = True
        elif a in ("-b", "--break"):
            i += 1
            opts.anchor_threshold = int(argv[i])
            if opts.anchor_threshold < 1:
                print("[Error] Anchor threshold must be >= 1",
                      file=sys.stderr)
                raise SystemExit(1)
        elif a in ("-z", "--tar"):
            opts.save_as_tar = True
        elif a in ("-d", "--db"):
            opts.db_output = True
        elif a in ("-y", "--overwrite"):
            opts.overwrite = True
        elif a in ("-l", "--id-list"):
            i += 1
            opts.id_file = argv[i]
        elif a in ("-m", "--id-mode"):
            i += 1
            opts.id_mode = int(argv[i])
            if opts.id_mode not in (0, 1):
                print("[Error] Invalid id mode. Please use 0 or 1.",
                      file=sys.stderr)
                raise SystemExit(1)
        elif a == "--plddt":
            opts.ext_mode = 0
        elif a in ("--fasta", "--amino-acid"):
            opts.ext_mode = 1
        elif a in ("-p", "--plddt-digits"):
            i += 1
            opts.ext_plddt_digits = int(argv[i])
        elif a == "--no-merge":
            opts.ext_merge = False
        elif a == "--use-title":
            opts.ext_use_title = True
        elif a == "--time":
            opts.measure_time = True
        elif a == "--skip-discontinuous":
            opts.skip_discontinuous = True
        elif a == "--check":
            opts.check_before = True
        elif a == "--use-cache":
            opts.use_cache = True
        elif a == "--fast":
            opts.fast = True
        elif a == "--exact":
            opts.exact = True
        elif a.startswith("-"):
            print(USAGE, end="")
            raise SystemExit(1)
        else:
            pos.append(a)
        i += 1
    return opts, pos


def compress_entry(name: str, buf: bytes, opts: Options,
                   out_base: str | None = None):
    """Per-entry compression (main.cpp:438-536): returns [(name, fcz_bytes)]."""
    base = base_name(name)
    parts = get_file_parts(base)
    fallback = out_base if out_base is not None else parts[0]

    # Native exact path for plain/gz PDB buffers (native/fccodec.c)
    lowered = base.lower()
    is_cif = lowered.endswith(".cif") or lowered.endswith(".cif.gz")
    if not is_cif:
        raw = gzip.decompress(buf) if buf[:2] == b"\x1f\x8b" else buf
        if raw.lstrip()[:5] != b"data_":
            try:
                from .native import encode_pdb_native
                frags = encode_pdb_native(raw, opts.anchor_threshold,
                                          title=None, split=True,
                                          fallback_title=fallback)
            except Exception:
                frags = None
            if frags is not None:
                if not frags:
                    print("[Error] No atoms found in the input file: "
                          f"{base}", file=sys.stderr)
                    return None
                results = []
                skipped_chain = set()
                for f in frags:
                    if opts.skip_discontinuous and \
                            f["n_frags_in_chain"] > 1:
                        if f["chain_ord"] not in skipped_chain:
                            print(f"Skipping discontinuous chain: {base}",
                                  file=sys.stderr)
                            skipped_chain.add(f["chain_ord"])
                        continue
                    if f["error"]:
                        print(f"[Error] {base}: {f['error']}",
                              file=sys.stderr)
                        continue
                    fname = parts[0]
                    if f["n_chains"] > 1:
                        fname += f["chain"]
                    if f["n_frags_in_chain"] > 1:
                        fname += f"_{f['frag_ord']}"
                    results.append((fname, f["blob"], parts))
                return results

    atoms = parse_structure_buffer(buf, base)
    if len(atoms) == 0:
        print(f"[Error] No atoms found in the input file: {base}",
              file=sys.stderr)
        return None
    # title fallback uses the OUTPUT base name when the parsed title is just
    # the input file name (main.cpp:464-465)
    title = fallback if atoms.title == base else atoms.title
    atoms = remove_alternative_positions(atoms)
    chains = identify_chains(atoms)
    results = []
    for ci, (cs, ce) in enumerate(chains):
        frags = identify_discontinuous_fragments(atoms, cs, ce)
        if opts.skip_discontinuous and len(frags) > 1:
            print(f"Skipping discontinuous chain: {base}", file=sys.stderr)
            continue
        for fi, (fs, fe) in enumerate(frags):
            frag = atoms.slice(fs, fe)
            try:
                f = encode(frag, anchor_threshold=opts.anchor_threshold,
                           title=title)
            except EncodeError as e:
                print(f"[Error] {base}: {e}", file=sys.stderr)
                continue
            fname = parts[0]
            if len(chains) > 1:
                fname += atoms.chain[cs]
            if len(frags) > 1:
                fname += f"_{fi}"
            results.append((fname, fcz.serialize(f), parts))
    return results


def _compress_write(sink, sink_kind, output, fname, blob, parts):
    if sink_kind == "db":
        # db entries are keyed by the base output name without
        # chain/fragment suffixes (main.cpp:449-450,516)
        sink.write(parts[0], blob)
    elif sink_kind == "tar":
        out_name = fname + (".fcz" if is_compressible(parts)
                            else "." + parts[1])
        sink.write(base_name(out_name), blob)
    elif sink_kind == "file":
        sink.write(output, blob)
    else:
        out_name = fname + (".fcz" if is_compressible(parts)
                            else "." + parts[1])
        sink.write(base_name(out_name), blob)


# the routes of foldcomp_tpu's CLI that bind its JAX device code
NOT_PORTED = ("the db scheduler, the sharded workers and warmup are not "
              "ported to foldcomp_tpu_torch yet")

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


# The link probe (foldcomp_tpu/cli.py:719-818), measured with torch. A
# decode ships ~96 compact bytes per residue device->host on the full wire;
# the probe calls a link below _FAST_MIN_LINK_MBS "slow". Here it drives
# only the decode wire (codec/batch.py use_bb_wire); the JAX CLI's other
# consumers of it, fast_batch_size (:825-846), batch decompress's
# auto-`--fast` (:871-885) and the hybrid scheduler, are not carried.
_FAST_MIN_LINK_MBS = 100.0

_PROBE_CODE = """\
import sys, time
try:
    import torch
    present = torch.cuda.is_available()
except Exception:
    present = False
if not present:
    print("none")
    sys.exit(0)
try:
    x = torch.zeros(8 << 20, dtype=torch.uint8)
    dev = x.to("cuda")
    torch.cuda.synchronize()         # H2D not timed: warm the path
    t0 = time.perf_counter()
    dev.cpu()                        # D2H to pageable memory, as decode ships
    dt = time.perf_counter() - t0
    mbs = (x.numel() / dt) / 1e6
    print(("ok" if mbs >= %f else "slow") + " " + repr(mbs))
except Exception:
    # the card is up but the 8 MB D2H itself failed: a degraded link
    print("slow 0")
"""

_PROBE_TTL_S = 600.0
_PROBE_NONE_TTL_S = 120.0


def _run_probe() -> tuple:
    """('ok'|'slow'|'none', D2H MB/s) of the CUDA card, measured now in a
    subprocess, so this process holds no CUDA context for it: 'none' when
    torch finds no card."""
    import subprocess
    mbs = 0.0
    try:
        r = subprocess.run(
            [sys.executable, "-c", _PROBE_CODE % _FAST_MIN_LINK_MBS],
            capture_output=True, text=True, timeout=180)
        toks = (r.stdout.strip().splitlines()[-1] if r.stdout
                else "none").split()
        result = toks[0]
        if len(toks) > 1:
            try:
                mbs = float(toks[1])
            except ValueError:
                pass
        if result not in ("ok", "slow", "none"):
            result = "none"
    except Exception:  # noqa: BLE001
        result = "none"
    return result, mbs


def _probe_info() -> tuple:
    """('ok'|'slow'|'none', link MB/s): _run_probe's answer, cached on
    disk for _PROBE_TTL_S (_PROBE_NONE_TTL_S for 'none') in this
    package's own file under the temporary directory.
    FOLDCOMP_TPU_LINK=ok|slow|none overrides everything, with 0 MB/s."""
    import json
    import tempfile

    forced = os.environ.get("FOLDCOMP_TPU_LINK")
    if forced in ("ok", "slow", "none"):
        return forced, 0.0
    cache = os.path.join(tempfile.gettempdir(),
                         f"foldcomp_tpu_torch_probe_{os.getuid()}.json")
    try:
        with open(cache) as fh:
            d = json.load(fh)
        ttl = _PROBE_TTL_S if d["result"] in ("ok", "slow") \
            else _PROBE_NONE_TTL_S
        if time.time() - d["ts"] < ttl and \
                d["result"] in ("ok", "slow", "none"):
            return d["result"], float(d.get("mbs", 0.0))
    except Exception:  # noqa: BLE001
        pass
    result, mbs = _run_probe()
    try:
        with open(cache, "w") as fh:
            json.dump(dict(ts=time.time(), result=result, mbs=mbs), fh)
    except Exception:  # noqa: BLE001
        pass
    return result, mbs


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
    from .codec.batch_host import encode_pdb_device

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


def run_compress(opts: Options, entries, output: str, single: bool,
                 device=None):
    """`device` is the resolved device of `--fast` (main resolves it
    before any output is opened)."""
    sink_kind = ("db" if opts.db_output else
                 "tar" if opts.save_as_tar else
                 "file" if single else "dir")
    sink = OutputSink(sink_kind, output, opts.overwrite)
    if opts.fast:
        return _run_compress_fast(opts, entries, sink, sink_kind, output,
                                  device)
    ok = True

    def handle(item):
        name, buf = item
        t0 = time.perf_counter()
        out_base = get_file_parts(output)[0] \
            if sink_kind == "file" else None
        results = compress_entry(name, buf, opts, out_base=out_base)
        if results is None:
            return False
        for fname, blob, parts in results:
            if sink_kind == "db":
                # db entries are keyed by the base output name without
                # chain/fragment suffixes (main.cpp:449-450,516)
                sink.write(parts[0], blob)
            elif sink_kind == "tar":
                out_name = fname + (".fcz" if is_compressible(parts)
                                    else "." + parts[1])
                sink.write(base_name(out_name), blob)
            elif sink_kind == "file":
                sink.write(output, blob)
            else:
                out_name = fname + (".fcz" if is_compressible(parts)
                                    else "." + parts[1])
                sink.write(base_name(out_name), blob)
        if opts.measure_time:
            print(f"{name}\t{time.perf_counter() - t0:.6f}")
        return True

    if opts.threads > 1:
        with ThreadPoolExecutor(opts.threads) as ex:
            for r in ex.map(handle, entries):
                ok = ok and r
    else:
        for item in entries:
            ok = handle(item) and ok
    sink.close()
    return 0


def _decompress_write(sink, sink_kind, output, name, text):
    base = base_name(name)
    parts = get_file_parts(base)
    if sink_kind == "db":
        sink.write(parts[0], text.encode() + b"\x00")
    elif sink_kind == "tar":
        sink.write(parts[0] + ".pdb", text.encode())
    elif sink_kind == "file":
        sink.write(output, text.encode())
    else:
        sink.write(parts[0] + ".pdb", text.encode())


def run_decompress(opts: Options, entries, output: str, single: bool,
                   device=None):
    """The exact native decode, or with `--fast` the device decode on
    `device`. The JAX package's auto-`--fast` link probe for large batch
    jobs is not carried: batch decompress stays exact unless `--fast` is
    given."""
    sink_kind = ("db" if opts.db_output else
                 "tar" if opts.save_as_tar else
                 "file" if single else "dir")
    sink = OutputSink(sink_kind, output, opts.overwrite)
    if opts.fast:
        return _run_decompress_fast(opts, entries, sink, sink_kind, output,
                                    device)

    try:
        from .native import decode_fcz_pdb_native, get_lib
        have_native = get_lib() is not None
    except Exception:
        have_native = False

    def handle(item):
        name, buf = item
        t0 = time.perf_counter()
        buf = bytes(buf)
        if opts.check_before:
            try:
                f = fcz.parse(buf)
            except fcz.FczFormatError:
                print("[Error] File is not a valid fcz file", file=sys.stderr)
                return False
            err = check_validity(f)
            if err != SUCCESS:
                print(VALIDITY_MESSAGES[err] + f.title, file=sys.stderr)
                return True
        if have_native:
            try:
                payload = decode_fcz_pdb_native(buf, use_alt=opts.alt,
                                                as_bytes=True)
            except ValueError:
                print("[Error] File is not a valid fcz file", file=sys.stderr)
                return False
        else:
            try:
                f = fcz.parse(buf)
            except fcz.FczFormatError:
                print("[Error] File is not a valid fcz file", file=sys.stderr)
                return False
            atoms = decode(f, use_alt_order=opts.alt)
            payload = format_pdb(atoms, f.title).encode()
        base = base_name(name)
        parts = get_file_parts(base)
        if sink_kind == "db":
            sink.write(parts[0], payload + b"\x00")
        elif sink_kind == "tar":
            sink.write(parts[0] + ".pdb", payload)
        elif sink_kind == "file":
            sink.write(output, payload)
        else:
            sink.write(parts[0] + ".pdb", payload)
        if opts.measure_time:
            print(f"{name}\t{time.perf_counter() - t0:.6f}")
        return True

    if opts.threads > 1:
        with ThreadPoolExecutor(opts.threads) as ex:
            list(ex.map(handle, entries))
    else:
        for item in entries:
            handle(item)
    sink.close()
    return 0


def run_extract(opts: Options, entries, output: str, single: bool,
                suffix: str):
    merged = (not opts.save_as_tar and not opts.db_output and not single
              and opts.ext_merge)
    sink_kind = ("db" if opts.db_output else
                 "tar" if opts.save_as_tar else
                 "merged" if merged else
                 "file" if single else "dir")
    sink = OutputSink(sink_kind, output, opts.overwrite)

    def handle(item):
        name, buf = item
        try:
            f = fcz.parse(bytes(buf))
        except fcz.FczFormatError:
            print("[Error] File is not a valid fcz file", file=sys.stderr)
            return False
        title = f.title if opts.ext_use_title else name
        if opts.ext_mode == 0:
            data = extract_plddt(f, opts.ext_plddt_digits)
        else:
            data = extract_sequence(f)
        if opts.ext_mode == 0 and opts.ext_plddt_digits > 1:
            text = write_tsv(title, f.n_residue, data)
        else:
            text = write_fasta_like(title, data)
        base = base_name(name)
        parts = get_file_parts(base)
        if sink_kind == "db":
            sink.write(parts[0], text.encode() + b"\x00")
        elif sink_kind == "tar":
            sink.write(parts[0] + "." + suffix, text.encode())
        elif sink_kind == "merged":
            sink.write("", text.encode())
        elif sink_kind == "file":
            sink.write(output, text.encode())
        else:
            sink.write(parts[0] + "." + suffix, text.encode())
        return True

    if opts.threads > 1:
        with ThreadPoolExecutor(opts.threads) as ex:
            list(ex.map(handle, entries))
    else:
        for item in entries:
            handle(item)
    sink.close()
    return 0


def run_check(opts: Options, entries):
    for name, buf in entries:
        try:
            # non-strict: truncated entries surface as the reference's
            # E_*_COUNT_MISMATCH codes instead of a parse error
            f = fcz.parse(bytes(buf), strict=False)
        except fcz.FczFormatError:
            print("[Error] File is not a valid fcz file", file=sys.stderr)
            continue
        err = check_validity(f)
        if err != SUCCESS:
            print(VALIDITY_MESSAGES[err] + name, file=sys.stderr)
    return 0


def run_rmsd(path1: str, path2: str):
    def load(p):
        with open(p, "rb") as fh:
            return parse_structure_buffer(fh.read(), base_name(p))
    a1 = load(path1)
    a2 = load(path2)
    if len(a1) == 0 or len(a2) == 0:
        print("[Error] No atoms found in the input file", file=sys.stderr)
        return 1
    if len(a1) != len(a2):
        print("[Error] The number of atoms in the two files are different.",
              file=sys.stderr)
        return 1
    bb1 = [i for i in range(len(a1)) if a1.atom_name[i] in ("N", "CA", "C")]
    bb2 = [i for i in range(len(a2)) if a2.atom_name[i] in ("N", "CA", "C")]
    r_bb = exact.rmsd(a1.coords[bb1], a2.coords[bb2])
    r_all = exact.rmsd(a1.coords, a2.coords)
    print(f"{path1}\t{path2}\t{len(bb1) // 3}\t{len(a1)}\t{r_bb:g}\t{r_all:g}")
    return 0


def run_subdb(id_file: str, db_in: str, db_out: str,
              id_mode: int = 1) -> int:
    """Subset a database by id list (mmseqs createsubdb equivalent)."""
    reader = DatabaseReader(db_in, use_lookup=True)
    writer = DatabaseWriter(db_out)
    n = 0
    try:
        with open(id_file) as fh:
            wanted = [ln.strip() for ln in fh if ln.strip()]
        for ident in wanted:
            if id_mode == 1:
                key = reader.lookup_key(ident)
                name = ident
            else:
                key = int(ident)
                name = reader.name_of_key(key) or str(key)
            pos = reader.position_of_key(key) if key != 0xFFFFFFFF else -1
            if pos < 0:
                print(f"[Error] {ident} not found in database",
                      file=sys.stderr)
                continue
            writer.append(reader.get_data(pos), key, name)
            n += 1
    finally:
        writer.close()
        reader.close()
    print(f"Wrote {n} entries to {db_out}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(USAGE, end="")
        return 0
    opts, pos = parse_args(argv)
    if len(pos) < 2:
        print("[Error] Not enough arguments.", file=sys.stderr)
        print(USAGE, end="")
        return 1
    mode = pos[0]
    inp = pos[1].rstrip("/") if pos[1] != "/" else pos[1]
    output = pos[2].rstrip("/") if len(pos) > 2 else None

    if mode == "rmsd":
        return run_rmsd(pos[1], pos[2])

    if mode == "warmup":
        print(f"[Error] warmup: {NOT_PORTED}", file=sys.stderr)
        return 1

    if mode == "subdb":
        # extension: subset a database by id list (the reference points users
        # at `mmseqs createsubdb --subdb-mode 0 --id-mode 1`)
        if len(pos) < 4:
            print("[Error] subdb needs <id_list> <db_in> <db_out>",
                  file=sys.stderr)
            return 1
        return run_subdb(pos[1], pos[2], pos[3], opts.id_mode)

    if mode not in ("compress", "decompress", "extract", "check"):
        print(USAGE, end="")
        return 1

    if not inp.startswith("gcs://") and not os.path.exists(inp) \
            and not is_database(inp):
        print(f"[Error] {inp} does not exist.", file=sys.stderr)
        return 1

    device = None
    if opts.fast and mode in ("compress", "decompress"):
        # resolved before any output is opened: no card, no output
        from .backend import DeviceUnavailable, resolve_device
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

    suffix = {"compress": "fcz", "decompress": "pdb"}.get(mode, "")
    if mode == "extract":
        if opts.ext_mode == 0:
            suffix = "plddt" if opts.ext_plddt_digits == 1 else "plddt.tsv"
        else:
            suffix = "fasta"

    if output is None:
        if opts.db_output:
            output = inp + "_db"
        elif opts.save_as_tar:
            output = inp + "." + suffix + ".tar"
        elif single:
            output = get_file_parts(inp)[0] + "." + suffix
        else:
            output = inp + "_" + suffix

    # mode banners (main.cpp:392-404, 871-875 parity)
    verb = {"compress": "Compressing", "decompress": "Decompressing",
            "extract": "Extracting", "check": "Checking"}[mode]
    if single and mode in ("compress", "decompress", "extract"):
        print(f"{verb} {inp} to {output}")
    elif single:
        print(f"{verb} {inp}")
    else:
        print(f"{verb} files in {inp} using {opts.threads} threads")
        if mode != "check":
            if opts.db_output:
                print(f"Output database: {output}")
            elif opts.save_as_tar:
                print(f"Output tar file: {output}")
            elif mode == "extract" and opts.ext_merge:
                # merged extraction writes one file (main.cpp:727-733)
                print(f"Output: {output.rstrip('/')}")
            else:
                print(f"Output directory: {output}")

    # foldcomp_tpu sends batch db -> db compress/decompress to its hybrid
    # and sharded scheduler (foldcomp_tpu/cli.py:1377-1421) and db extract
    # to its sharded workers (:1426-1432); neither is ported yet. The
    # in-process route below writes the same bytes.
    if (mode in ("compress", "decompress")
            and not single and not opts.fast and not single_files
            and len(inputs) == 1 and is_database(inputs[0])
            and opts.db_output and opts.id_file is None
            and not opts.alt and not opts.check_before
            and not opts.measure_time) or \
            (mode == "extract" and opts.threads >= 1 and not single
             and not single_files and len(inputs) == 1
             and is_database(inputs[0]) and opts.id_file is None
             and not opts.measure_time and not opts.save_as_tar
             and (opts.db_output or opts.ext_merge)):
        print(f"[Info] {NOT_PORTED}: the db {mode} runs in this process",
              file=sys.stderr)

    rc = 0
    entry_sources = []
    for item in inputs:
        entry_sources.append(
            make_processor(item, opts.recursive, opts.id_file, opts.id_mode,
                           opts.use_cache))
    if single_files:
        entry_sources.append(iter_file_list(single_files))

    for entries in entry_sources:
        if mode == "compress":
            rc |= run_compress(opts, entries, output, single, device)
        elif mode == "decompress":
            rc |= run_decompress(opts, entries, output, single, device)
        elif mode == "extract":
            rc |= run_extract(opts, entries, output, single, suffix)
        elif mode == "check":
            rc |= run_check(opts, entries)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
