"""Command line of the port: `python -m foldcomp_tpu_torch`.

The port's own copy of foldcomp_tpu/cli.py's host parts, kept line for line
so that every exact route writes the same bytes as `python -m foldcomp_tpu`
(tests/test_torch_standalone.py holds the two to the same databases):

- :76-465, the names, the input iterators and `make_processor`,
  `OutputSink`, `Options`/`parse_args`/`USAGE`, `compress_entry` and
  `_compress_write`;
- `run_compress` (:609) and `_decompress_write` (:662);
- the link probe `_probe_info` (:719-818), measured with torch, and its
  consumers: `fast_batch_size` (:825-846), `_accelerator_present` and
  `_device_link_ok` (:849-860), the auto-`--fast` of `run_decompress`
  (:868-885) and the decode wire (codec/batch.py use_bb_wire);
- `run_decompress`, `run_extract` and `run_check` (:861-1010);
- `_hybrid_applicable` and `run_sharded_extract` (:1013-1107);
- `run_rmsd` and `run_subdb` (:1211-1259);
- `main`'s flow (:1262-1452), with its database routing (:1365-1432):
  batch db -> db compress and decompress go to the hybrid CPU + CUDA
  scheduler (parallel/hybrid.py) on a host with a card, and to native CPU
  workers on one without; db extract to sharded workers.

So compress, decompress, extract, check, rmsd, subdb and warmup run here
over files, directories, tars and databases. `compress --fast` and
`decompress --fast` run through the port's device encode and decode
(codec/batch.py encode_submit/encode_finish and decode_fcz_stream),
mirroring _run_compress_fast / _run_decompress_fast (:467-606, :675-716).
`warmup` (:1110-1208) has another job here: the port has no compile
cache, so it builds and loads the CUDA kernel library and runs one batch
of each device path (run_warmup). The routing constants are the port's
own: FAST_DEFAULT_MIN and FAST_BATCH were measured on an H100 by
`python3 -m foldcomp_tpu_torch.bench --routing` (bench_routing.py), and
each comment gives the figures and the JAX value it replaced; the probe's
TTLs, _FAST_MIN_LINK_MBS and the steps for slower links are kept, each
comment says why.
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
       foldcomp_tpu_torch warmup <fcz|pdb|dir|db>            (extension: build the CUDA kernels and run one batch of each device path)
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
 --exact                  force the exact native codec (disables the GPU
                          batch default for batch decompression and the
                          device stream of db -> db jobs)
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


# Device batch sizes by the link probe's D2H rate, in the JAX package's
# steps (foldcomp_tpu/cli.py:825-846): FAST_BATCH from 1000 MB/s, 512 from
# 300 MB/s, else _SLOW_LINK_BATCH. FOLDCOMP_TPU_BATCH overrides.
# FAST_BATCH is the batch with the best `decompress --fast` wall whose
# peak RSS stays under 8 GB, where `compress --fast` is no slower than at
# 2048 (`bench --routing` sweep b: bench.e2e's 4,096-entry databases,
# medians of 3 rounds; NVIDIA H100 80GB HBM3, 700.00 W): decompress 15.91,
# 16.73, 18.20, 17.42 and 16.90 s at B = 512, 1024, 2048, 4096 and 8192
# (8192 is one batch of all 4,096), 14.31, 15.58, 17.08, 16.67 and 16.33 s
# without width classes; compress 22.69, 22.53, 27.93, 28.37 and 28.62 s;
# peak RSS 7.74 GB at every batch (compress 7.74-7.95 GB), peak device
# memory 0.17 GB at 512 and 0.47 GB at 2048. The host stages set the wall,
# and smaller batches overlap them better. The JAX value, 2048, came from
# its TPU's fused decode, whose rate rose through B=4096 on that chip.
# The 512 and _SLOW_LINK_BATCH steps serve links an H100 host does not
# produce (it probes 1,063-2,323 MB/s): kept as the JAX package's, and
# blocked on a slow link to measure (ROADMAP queue 1 item 7).
FAST_BATCH = 512
_SLOW_LINK_BATCH = 128
# A no-flag batch decompress of more than FAST_DEFAULT_MIN entries takes
# the device route when the probe finds a card on an "ok" link
# (run_decompress), and a no-flag db -> db job of more goes to the hybrid
# scheduler (_hybrid_applicable). The rule: the smallest N at which the
# device route, with the probe's cache cold, beats `--exact -t 1` (the
# default -t), else the largest N measured. `bench --routing` sweep a, a
# directory of N .fcz files of the mixed corpus, medians of 3 rounds
# (NVIDIA H100 80GB HBM3, 700.00 W): `--exact -t 1` 5.17, 8.04, 14.59 and
# 30.19 s at N = 1024, 2048, 4096 and 8192 against `--fast` cold 21.35,
# 22.85, 33.06 and 45.86 s (warm 12.10, 16.30, 26.35, 29.30): no N
# qualifies, so the no-flag route stays native up to the largest size
# measured. `--exact -t 8` (3.55 s at 2048) beats both at every N; a rule
# that reads -t is a new rule and not the JAX package's (ROADMAP). The
# JAX value, 1024 (foldcomp_tpu/cli.py:657-659), amortized a JAX import
# and first compile on its TPU; here a fresh device process pays the
# ~6.5 s torch import and a cold probe another ~8.7 s.
FAST_DEFAULT_MIN = 8192


# The link probe (foldcomp_tpu/cli.py:719-818), measured with torch. A
# decode ships ~96 compact bytes per residue device->host on the full wire;
# the probe calls a link below _FAST_MIN_LINK_MBS "slow". It chooses the
# decode wire (codec/batch.py use_bb_wire), the device batch size
# (fast_batch_size), whether a large batch decompress goes to the device
# (run_decompress) and whether a db -> db job runs a device stream (main).
# _FAST_MIN_LINK_MBS is the JAX package's (foldcomp_tpu/cli.py:723), kept
# and blocked: an H100 host probes 1,063-2,323 MB/s, so a slow link to
# measure on is needed to re-derive it (ROADMAP queue 1 item 7).
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

# How long the probe's answer is trusted: the JAX package's TTLs
# (foldcomp_tpu/cli.py:760-761), kept, since they measure how fast a
# link's state goes stale, not the card's speed. On an NVIDIA H100 80GB
# HBM3 (700.00 W) a probe costs 7.55-9.74 s, median 8.73 s (`bench
# --routing` sweep e), paid inside the wall of the job that finds the
# cache stale: `--fast` on 1,024-8,192 files ran 6.55-16.56 s slower with
# the cache cold (sweep a). Only at 8,192 files does that decide the
# route's race with `--exact -t 1`, and by medians inside the spreads
# (warm 29.30 s, spread 18.74, against 30.19 s).
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


def _probe_device() -> str:
    return _probe_info()[0]


def fast_batch_size() -> int:
    """Device dispatch size from the measured link rate: big batches on a
    healthy link, small ones on a starved link so that the hybrid
    scheduler's claimed backlog stays drainable (parallel/hybrid.py
    EndgameGuard). FOLDCOMP_TPU_BATCH overrides."""
    env = os.environ.get("FOLDCOMP_TPU_BATCH")
    if env:
        try:
            return max(int(env), 1)
        except ValueError:
            pass
    result, mbs = _probe_info()
    if result != "ok":
        return _SLOW_LINK_BATCH
    if mbs >= 1000.0:
        return FAST_BATCH
    if mbs >= 300.0:
        return 512
    return _SLOW_LINK_BATCH


def _accelerator_present() -> bool:
    """True when torch finds a CUDA card, probed in a subprocess (see
    _probe_info), or FOLDCOMP_TPU_LINK says ok or slow."""
    return _probe_device() != "none"


def _device_link_ok() -> bool:
    """True when the host<->device link can feed the batched path faster
    than the native CPU path (see _probe_info)."""
    return _probe_device() == "ok"


def _resolve_or_report(what: str):
    """The device the device paths run on (backend.resolve_device), its
    kernel library loaded when it is a CUDA card; or None after an [Error]
    line when that card is not there (FOLDCOMP_TPU_LINK can claim a card
    that torch does not find) or the library cannot be built. Callers
    resolve before any output is opened: no device, no output."""
    from .backend import DeviceUnavailable, resolve_device
    try:
        dev = resolve_device(None)
        if dev.type == "cuda":
            from .kernels import build
            build.load(dev)
        return dev
    except DeviceUnavailable as e:
        print(f"[Error] {what}: {e}", file=sys.stderr)
    except RuntimeError as e:   # KernelBuildError, a CUDA error
        print(f"[Error] {what}: {type(e).__name__}: {e}", file=sys.stderr)
    return None


def _device_name(dev) -> str:
    if dev.type != "cuda":
        return str(dev)
    import torch
    return f"{dev} ({torch.cuda.get_device_name(dev)})"


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
    if bsz != FAST_BATCH:
        print(f"[Info] device batch size {bsz} (link probe)",
              file=sys.stderr)
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
    `device`. A batch job of more than FAST_DEFAULT_MIN entries takes the
    device decode by itself when the link probe finds a card with an "ok"
    link (foldcomp_tpu/cli.py:868-885): its coordinates hold the same
    gates as `--fast`'s; `--exact` keeps the native path at any size."""
    if not opts.fast and not opts.exact and not single:
        import itertools
        head = list(itertools.islice(entries, FAST_DEFAULT_MIN + 1))
        entries = itertools.chain(head, entries)
        if len(head) > FAST_DEFAULT_MIN and _accelerator_present():
            if _device_link_ok():
                device = _resolve_or_report("batch decompress")
                if device is None:
                    return 1
                print("[Info] GPU detected (link ok): using batched "
                      f"decode on {_device_name(device)} (pass --exact for "
                      "the byte-exact native path)", file=sys.stderr)
                opts.fast = True
            else:
                print("[Info] GPU present but host<->device link is too "
                      "slow for coordinate streaming; using the native "
                      "path (pass --fast to force the device pipeline)",
                      file=sys.stderr)
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


def _hybrid_applicable(db_path: str) -> bool:
    """Hybrid CPU+device scheduling pays off when the job is big enough
    to amortize the torch import and the first launches and a CUDA card
    is there. A big job on a host without one says so: it runs on the
    native CPU workers only."""
    try:
        r = DatabaseReader(db_path)
        n = len(r)
        r.close()
    except Exception:  # noqa: BLE001 — not a readable db: no hybrid
        return False
    if n <= FAST_DEFAULT_MIN:
        return False
    if _accelerator_present():
        return True
    print("[Info] no CUDA device: the db job runs on native CPU workers "
          "only", file=sys.stderr)
    return False


def run_sharded_extract(inp: str, output: str, opts: Options,
                        merged: bool) -> int:
    """db extract across opts.threads workers (the reference fans extract
    out with OpenMP, main.cpp:778-859; the in-process thread pool scales
    NEGATIVELY here: GIL convoy on per-entry Python).

    db output: shard databases merged by key. Merged text output: shard
    files concatenated in shard order, which IS global entry order for
    contiguous ranges, so byte-identical to the single-thread output.

    Workers are threads when the GIL-free C extract loop
    (fcz_db_extract_range) engages (one C call per shard chunk, no
    spawn/import cost), else worker processes (the per-entry Python
    fallback convoys on the GIL), which import this package's
    parallel/dist.py and no torch."""
    import subprocess

    from .parallel.dist import (extract_db_shard, merge_shard_dbs,
                                merge_shard_files)

    n = opts.threads
    use_threads = False
    try:
        from .native import get_lib
        if get_lib() is not None:
            probe = DatabaseReader(inp, use_lookup=True)
            use_threads = getattr(probe, "_h", None) is not None
            probe.close()
    except Exception:  # noqa: BLE001 — the process route reads it again
        use_threads = False

    rc = 0
    if use_threads:
        import threading
        errs = []

        def shard_main(pid):
            try:
                extract_db_shard(inp, output, pid, n,
                                 ext_mode=opts.ext_mode,
                                 digits=opts.ext_plddt_digits,
                                 use_title=opts.ext_use_title,
                                 merged=merged)
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(e)

        if n == 1:
            shard_main(0)
        else:
            ts = [threading.Thread(target=shard_main, args=(pid,))
                  for pid in range(n)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        rc = 1 if errs else 0
    else:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        procs = []
        for pid in range(n):
            code = (f"import sys; sys.path.insert(0, {repo!r})\n"
                    f"from {__package__}.parallel.dist import "
                    f"extract_db_shard\n"
                    f"extract_db_shard({inp!r}, {output!r}, {pid}, {n}, "
                    f"ext_mode={opts.ext_mode}, "
                    f"digits={opts.ext_plddt_digits}, "
                    f"use_title={opts.ext_use_title}, merged={merged})\n")
            procs.append(subprocess.Popen([sys.executable, "-c", code]))
        for p in procs:
            rc |= p.wait()
    if rc:
        print("[Error] sharded worker failed", file=sys.stderr)
        return 1
    if merged:
        merge_shard_files(output, n)
    else:
        merge_shard_dbs(output, n)
    return 0


def run_warmup(inp: str) -> int:
    """Make the device paths ready before the first real job.

    `foldcomp_tpu_torch warmup <fcz-db|fcz-dir|fcz|pdb|cif>`. The JAX
    package's warmup (foldcomp_tpu/cli.py:1110-1208) fills its compile
    cache; the port's counterpart of that cache is the kernel library,
    built by nvcc into the port's cache, <backend.cache_dir()>/kernels/,
    and named by a hash of the sources, flags and toolkit
    (kernels/build.py). So this builds the library, loads its
    tables on every visible card, then runs one decode batch of
    fast_batch_size() entries through the stages decode_fcz_stream runs
    (pack, device decode, the native formatter) and one encode batch of
    the decoded texts through those of `compress --fast` (the native
    parse, encode_submit, encode_finish), outputs discarded, on the device
    the other entry points take (FOLDCOMP_TORCH_DEVICE=cpu runs the plain
    versions and builds nothing). The time to the decoded batch seeds the
    hybrid scheduler's cold horizon (parallel/hybrid.py EndgameGuard), in
    the same cache's device_warmup.json (none with
    FOLDCOMP_TPU_TORCH_CACHE=0). That time counts from before torch is
    imported, as the scheduler's device stream counts it. It prints where
    it wrote each file."""
    bsz = fast_batch_size()
    t0 = time.perf_counter()
    dev = _resolve_or_report("warmup")
    if dev is None:
        return 1
    from .codec.batch import (decode_fcz_to_pdb_batch, encode_finish,
                              encode_fragment_batch, encode_submit)
    from .codec.batch_host import encode_pdb_device

    built = ""
    if dev.type == "cuda":
        import torch

        from .kernels import build
        built = f"; kernel library {build.build()}"
        if build.BUILD_SECONDS is not None:
            built += f" (built in {build.BUILD_SECONDS:.1f}s)"
        for idx in range(torch.cuda.device_count()):
            build.load(idx)

    blobs = []
    if is_database(inp):
        r = DatabaseReader(inp, use_lookup=True)
        for p in range(min(len(r), bsz)):
            blobs.append(bytes(r.get_data(p)))
        r.close()
    elif os.path.isdir(inp):
        for name in sorted(os.listdir(inp))[:bsz]:
            path = os.path.join(inp, name)
            if os.path.isfile(path):
                with open(path, "rb") as fh:
                    blobs.append(fh.read())
    else:
        with open(inp, "rb") as fh:
            blobs.append(fh.read())

    fczs = []
    frags = []
    for blob in blobs:
        body = blob[:-1] if blob.endswith(b"\x00") else blob
        try:
            fczs.append(fcz.parse(body))
            continue
        except fcz.FczFormatError:
            pass
        try:
            atoms = parse_structure_buffer(body, "warmup")
            atoms = remove_alternative_positions(atoms)
            for cs, ce in identify_chains(atoms):
                for fs, fe in identify_discontinuous_fragments(atoms, cs,
                                                               ce):
                    frags.append(atoms.slice(fs, fe))
        except Exception:  # noqa: BLE001 — unparseable sample entry
            continue
    if not fczs and frags:
        fczs = [f for f in encode_fragment_batch(frags[:bsz], device=dev)
                if f is not None]
    if not fczs:
        print("[Error] no usable warmup sample in input", file=sys.stderr)
        return 1

    # one full decode batch: the first window the stream would dispatch
    batch = sorted((fczs * ((bsz - 1) // len(fczs) + 1))[:bsz],
                   key=lambda f: f.n_residue)
    texts = decode_fcz_to_pdb_batch(batch, device=dev)
    t_dec = time.perf_counter()

    # one full encode batch of those texts, parsed as compress --fast
    # parses them; the fragment path where the native parser is missing
    tensors, metas = [], []
    for text in texts:
        got = encode_pdb_device(text.encode(), 25)
        if got is None:
            break
        for t, m in zip(*got):
            if not m["error"]:
                tensors.append(t)
                metas.append(m)
    if tensors:
        encode_finish(encode_submit(tensors, metas, device=dev))
    else:
        encode_fragment_batch([parse_pdb(t.encode()) for t in texts],
                              device=dev)
    t_enc = time.perf_counter()
    print(f"Warmed {_device_name(dev)} codec on {len(batch)}-entry "
          f"batches: decode {t_dec - t0:.1f}s, encode {t_enc - t_dec:.1f}s"
          f"{built}")
    # Seed the hybrid scheduler's cold horizon: time-to-first-decode here
    # bounds the device stream's time-to-first-completion, so a host whose
    # jobs are all too small for the device to ever join (and self-measure)
    # still gets an estimate from one explicit `warmup` call.
    from .parallel.hybrid import EndgameGuard
    guard = EndgameGuard.__new__(EndgameGuard)
    guard._first_done_dt = t_dec - t0
    written = guard.finalize()
    print(f"Warmup estimate {written}" if written else
          "Warmup estimate not written (FOLDCOMP_TPU_TORCH_CACHE=0, "
          "FOLDCOMP_TPU_WARMUP_EST set, or the cache not writable)")
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
        if not os.path.exists(pos[1]) and not is_database(pos[1]):
            print(f"[Error] {pos[1]} does not exist.", file=sys.stderr)
            return 1
        return run_warmup(pos[1])

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
        device = _resolve_or_report("--fast")
        if device is None:
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

    # Batch db -> db paths (foldcomp_tpu/cli.py:1350-1432).
    #
    # Default on a host with a CUDA card: HYBRID work stealing, with
    # opts.threads native CPU workers pulling entry chunks from the front
    # of the list while the in-process device stream pulls from the back
    # (parallel/hybrid.py), so the CPU/device split adapts to the hardware.
    # --exact disables the device stream; --fast forces the device-only
    # pipeline below.
    #
    # Without a card (or for small jobs, where the torch import and the
    # first launches dominate): the same scheduler with native workers
    # only, or at -t 1 one in-process shard through the GIL-free C chunk
    # loops (parallel/dist.py).
    if (mode in ("compress", "decompress")
            and not single and not opts.fast and not single_files
            and len(inputs) == 1 and is_database(inputs[0])
            and opts.db_output and opts.id_file is None
            and not opts.alt and not opts.check_before
            and not opts.measure_time):
        from .parallel.hybrid import run_hybrid_db
        if not opts.exact and _hybrid_applicable(inputs[0]):
            # On a slow host<->device link the device stream's host-side
            # cost (parse/pack/format threads) displaces more native
            # throughput than its transfer-bound share adds: the parent
            # then joins as one more native worker instead. The stream
            # imports torch and resolves its device (backend.py) itself,
            # after the native workers have started, as the JAX package's
            # stream imports JAX; a device it cannot use fails the stream,
            # and run_hybrid_db then finishes the job natively and
            # returns 1.
            use_device = _device_link_ok()
            stream = ("device stream on "
                      + (os.environ.get("FOLDCOMP_TORCH_DEVICE") or "cuda")
                      if use_device else
                      "CPU-only parent: host<->device link too slow")
            print(f"[Info] hybrid CPU+GPU scheduling ({opts.threads} "
                  f"native workers + {stream})", file=sys.stderr)
            return run_hybrid_db(mode, inputs[0], output, opts.threads,
                                 anchor_threshold=opts.anchor_threshold,
                                 batch_size=(fast_batch_size()
                                             if use_device else FAST_BATCH),
                                 use_device=use_device)
        if opts.threads > 1:
            # native workers only: dynamic chunk claims absorb per-entry
            # skew that static contiguous ranges cannot, and the parent
            # steals chunks too instead of idling
            return run_hybrid_db(mode, inputs[0], output, opts.threads,
                                 anchor_threshold=opts.anchor_threshold,
                                 batch_size=FAST_BATCH, use_device=False)
        # -t 1: one in-process shard, still the GIL-free C chunk loops
        # (fcz_db_{decode,encode}_range) when the native handles engage
        from .parallel.dist import (compress_db_shard, decompress_db_shard,
                                    merge_shard_dbs)
        if mode == "decompress":
            decompress_db_shard(inputs[0], output, 0, 1, fast=False)
        else:
            compress_db_shard(inputs[0], output, 0, 1,
                              anchor_threshold=opts.anchor_threshold,
                              fast=False)
        merge_shard_dbs(output, 1)
        return 0

    # Sharded db extract (extract is pure host work: no device stream to
    # schedule). threads >= 1: even the single-thread db case routes
    # through the GIL-free C chunk loop.
    if (mode == "extract" and opts.threads >= 1 and not single
            and not single_files and len(inputs) == 1
            and is_database(inputs[0]) and opts.id_file is None
            and not opts.measure_time and not opts.save_as_tar
            and (opts.db_output or opts.ext_merge)):
        return run_sharded_extract(inputs[0], output, opts,
                                   merged=not opts.db_output)

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
