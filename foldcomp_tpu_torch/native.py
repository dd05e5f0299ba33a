"""ctypes bindings for the native IO runtime (native/fcio.c).

The port's own copy of `foldcomp_tpu/native.py:1`. The C sources are not
copied: the repository's `native/fcio.c` and `native/fccodec.c` stay the
one byte-exact codec of both packages. The port compiles them on demand
with the system C compiler into its own git-ignored directory,
foldcomp_tpu_torch/kernels/build/libfcio.so, so the two packages never
build into the same file. The build writes a temporary name and renames it
into place, so processes that build at once do not load a half-written
library. Every caller has a pure-Python fallback, so a missing toolchain
degrades performance, not functionality. Set FOLDCOMP_TPU_NO_NATIVE=1 to
disable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_HERE), "native")
_SO_PATH = os.path.join(_HERE, "kernels", "build", "libfcio.so")
_SRCS = [os.path.join(_NATIVE_DIR, "fcio.c"),
         os.path.join(_NATIVE_DIR, "fccodec.c")]


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    cc = os.environ.get("CC", "cc")
    cmd = [cc, "-O3", "-fPIC", "-shared", "-o", tmp, *_SRCS, "-lm"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if res.returncode != 0:
        print(f"[Warning] native build failed:\n{res.stderr[:2000]}",
              file=sys.stderr)
        return False
    os.replace(tmp, _SO_PATH)
    return True


def _bind(lib):
    c = ctypes
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.fcio_format_pdb.restype = c.c_int64
    lib.fcio_format_pdb.argtypes = [
        c.c_int32, i32p, i32p, c.c_char_p, c.c_char_p, c.c_char_p, f32p,
        f32p, c.c_char_p, c.c_int32, c.c_char_p]
    lib.fcio_format_atom14.restype = c.c_int64
    lib.fcio_format_atom14.argtypes = [
        f32p, f32p, i32p, c.c_int32, c.c_int32, c.c_int32, c.c_char,
        c.c_char, c.c_char, c.c_int32, f32p, c.c_int32, c.c_char_p,
        c.c_int32, c.c_char_p]
    lib.fcio_count_atoms.restype = c.c_int64
    lib.fcio_count_atoms.argtypes = [c.c_char_p, c.c_int64]
    lib.fcio_parse_pdb.restype = c.c_int64
    lib.fcio_parse_pdb.argtypes = [
        c.c_char_p, c.c_int64, i32p, i32p, c.c_char_p, c.c_char_p,
        c.c_char_p, f32p, f32p, f32p, c.c_char_p,
        c.POINTER(c.c_int32), c.c_int32]
    lib.fcdb_reader_open.restype = c.c_void_p
    lib.fcdb_reader_open.argtypes = [c.c_char_p, c.c_char_p, c.c_int]
    lib.fcdb_reader_size.restype = c.c_int64
    lib.fcdb_reader_size.argtypes = [c.c_void_p]
    lib.fcdb_reader_get.restype = c.c_int64
    lib.fcdb_reader_get.argtypes = [c.c_void_p, c.c_int64,
                                    c.POINTER(c.c_char_p),
                                    c.POINTER(c.c_int64)]
    lib.fcdb_reader_key.restype = c.c_uint32
    lib.fcdb_reader_key.argtypes = [c.c_void_p, c.c_int64]
    lib.fcdb_reader_offset.restype = c.c_int64
    lib.fcdb_reader_offset.argtypes = [c.c_void_p, c.c_int64]
    lib.fcdb_reader_length.restype = c.c_int64
    lib.fcdb_reader_length.argtypes = [c.c_void_p, c.c_int64]
    lib.fcdb_reader_id.restype = c.c_int64
    lib.fcdb_reader_id.argtypes = [c.c_void_p, c.c_uint32]
    lib.fcdb_reader_close.restype = None
    lib.fcdb_reader_close.argtypes = [c.c_void_p]
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    _i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.fcdb_reader_dump.restype = None
    lib.fcdb_reader_dump.argtypes = [c.c_void_p, u32p, _i64p, _i64p]
    lib.fcdb_writer_open.restype = c.c_void_p
    lib.fcdb_writer_open.argtypes = [c.c_char_p]
    lib.fcdb_writer_append.restype = c.c_int64
    lib.fcdb_writer_append.argtypes = [c.c_void_p, c.c_char_p, c.c_int64,
                                       c.c_uint32, c.c_char_p]
    lib.fcdb_writer_close.restype = c.c_int64
    lib.fcdb_writer_close.argtypes = [c.c_void_p]
    lib.fcz_decode_pdb.restype = c.c_int64
    lib.fcz_decode_pdb.argtypes = [c.c_char_p, c.c_int64, c.c_int,
                                   c.c_char_p]
    lib.fcz_decode_pdb_cap.restype = c.c_int64
    lib.fcz_decode_pdb_cap.argtypes = [c.c_char_p, c.c_int64]
    lib.fcz_db_decode_range.restype = c.c_int64
    lib.fcz_db_decode_range.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                        c.c_int64, c.c_char_p, c.c_int]
    lib.fcz_db_encode_range.restype = c.c_int64
    lib.fcz_db_encode_range.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                        c.c_int64, c.c_char_p, c.c_int]
    lib.fcz_db_extract_range.restype = c.c_int64
    lib.fcz_db_extract_range.argtypes = [c.c_void_p, c.c_void_p, c.c_int,
                                         c.c_int64, c.c_int64, c.c_char_p,
                                         c.c_int, c.c_int, c.c_int]
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    vpp = c.POINTER(c.c_void_p)
    lib.fcz_pack_seg_max.restype = c.c_int64
    lib.fcz_pack_seg_max.argtypes = [c.c_int64, i32p, i32p,
                                     c.POINTER(c.c_void_p)]
    lib.fcz_pack_lanes.restype = c.c_int64
    lib.fcz_pack_lanes.argtypes = [
        c.c_int64, i32p, i32p, vpp, vpp, i32p, vpp, vpp, vpp, vpp,
        f32p, f32p, vpp,
        c.c_int64, c.c_int64, c.c_int64,
        u8p, u8p, f32p, f32p, f32p, f32p, u8p, i32p,
        i32p, f32p, i32p, i32p]
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.fcz_pack_encode_wire.restype = c.c_int64
    lib.fcz_pack_encode_wire.argtypes = [
        c.c_int64, vpp, i32p, c.c_int64, c.c_int64,
        f32p, i32p, i16p, u16p]
    lib.fcz_pack_encode_wire_range.restype = c.c_int64
    lib.fcz_pack_encode_wire_range.argtypes = [
        c.c_int64, c.c_int64, vpp, i32p, c.c_int64, c.c_int64,
        f32p, i32p, i16p, u16p, c.c_int64]
    lib.fcz_place_sc_from_bb.restype = c.c_int64
    lib.fcz_place_sc_from_bb.argtypes = [
        c.c_int64, f32p, i32p, u8p, c.c_int64, c.c_char, f32p]
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.fcz_encode_atoms.restype = c.c_int64
    lib.fcz_encode_atoms.argtypes = [
        c.c_char_p, c.c_char_p, c.c_char_p, i32p, i32p, f32p, f32p,
        c.c_int64, c.c_int, c.c_char_p, c.c_int32, c.c_int,
        c.c_char_p, c.c_int64, i64p, i64p, c.c_char_p, i32p, c.c_int32]
    return lib


def get_lib():
    """The loaded native library, or None when unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("FOLDCOMP_TPU_NO_NATIVE"):
            return None
        try:
            stale = not os.path.exists(_SO_PATH) or any(
                os.path.exists(s) and
                os.path.getmtime(s) > os.path.getmtime(_SO_PATH)
                for s in _SRCS)
            if stale:
                if not _build():
                    return None
            _LIB = _bind(ctypes.CDLL(_SO_PATH))
        except OSError as e:
            print(f"[Warning] native library unavailable: {e}",
                  file=sys.stderr)
            _LIB = None
    return _LIB


# ---------------------------------------------------------------------------
# High-level wrappers
# ---------------------------------------------------------------------------

def format_pdb_native(atoms, title: str = "") -> str | None:
    """Native writeAtomCoordinatesToPDB; None if the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(atoms)
    names = np.asarray(atoms.atom_name, dtype="U4")
    len4 = np.char.str_len(names) == 4
    fields = np.where(len4, names,
                      np.char.add(" ", np.char.ljust(names, 3)))
    name4 = np.char.ljust(fields, 4).astype("S4").tobytes()
    res3 = np.char.rjust(np.asarray(atoms.residue_name, dtype="U3"), 3) \
        .astype("S3").tobytes()
    chain = np.asarray([c[:1] or " " for c in atoms.chain],
                       dtype="S1").tobytes()
    coords = np.ascontiguousarray(atoms.coords, np.float32)
    temp = np.ascontiguousarray(atoms.temp_factor, np.float32)
    aidx = np.ascontiguousarray(atoms.atom_index, np.int32)
    ridx = np.ascontiguousarray(atoms.residue_index, np.int32)
    tbytes = title.encode("latin1", "replace")
    cap = len(tbytes) + 16 + (len(tbytes) // 70 + 2) * 12 + n * 120 + 64
    out = ctypes.create_string_buffer(cap)
    written = lib.fcio_format_pdb(
        n, aidx, ridx, name4, res3, chain, coords, temp, tbytes,
        len(tbytes), out)
    return out.raw[:written].decode("latin1")


def format_atom14_native(atom14, temp, codes, n_res, idx_residue, idx_atom,
                         chain, first_res, last_res, has_oxt, oxt_xyz,
                         use_alt, title) -> str | None:
    """Native atom14 -> PDB text; None if the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    atom14 = np.ascontiguousarray(atom14, np.float32)
    temp = np.ascontiguousarray(temp, np.float32)
    codes = np.ascontiguousarray(codes, np.int32)
    oxt = np.ascontiguousarray(oxt_xyz, np.float32)
    tbytes = title.encode("latin1", "replace")
    cap = len(tbytes) + 16 + (len(tbytes) // 70 + 2) * 12 \
        + (n_res * 14 + 2) * 120 + 64
    out = ctypes.create_string_buffer(cap)
    written = lib.fcio_format_atom14(
        atom14, temp, codes, n_res, idx_residue, idx_atom,
        (chain[:1] or " ").encode("latin1"),
        (first_res[:1] or "X").encode("latin1"),
        (last_res[:1] or "X").encode("latin1"),
        1 if has_oxt else 0, oxt, 1 if use_alt else 0, tbytes,
        len(tbytes), out)
    return out.raw[:written].decode("latin1")


def _parse_raw(lib, data: bytes):
    """Parse a PDB buffer into raw ctypes/numpy buffers (no Python lists)."""
    n = lib.fcio_count_atoms(data, len(data))
    bufs = dict(
        atom_index=np.empty(max(n, 1), np.int32),
        residue_index=np.empty(max(n, 1), np.int32),
        name4=ctypes.create_string_buffer(int(n) * 4 + 4),
        res3=ctypes.create_string_buffer(int(n) * 3 + 4),
        chain=ctypes.create_string_buffer(int(n) + 4),
        coords=np.empty((max(n, 1), 3), np.float32),
        occ=np.empty(max(n, 1), np.float32),
        temp=np.empty(max(n, 1), np.float32),
    )
    title_buf = ctypes.create_string_buffer(8192)
    title_len = ctypes.c_int32(0)
    got = lib.fcio_parse_pdb(
        data, len(data), bufs["atom_index"], bufs["residue_index"],
        bufs["name4"], bufs["res3"], bufs["chain"], bufs["coords"],
        bufs["occ"], bufs["temp"], title_buf, ctypes.byref(title_len), 8192)
    bufs["n"] = int(got)
    bufs["title"] = title_buf.raw[:title_len.value].decode("latin1")
    return bufs


def peek_title_native(data: bytes) -> str | None:
    """Parsed structure title without building Python atom lists."""
    lib = get_lib()
    if lib is None:
        return None
    return _parse_raw(lib, data)["title"]


def encode_pdb_native(data: bytes, threshold: int, title: str | None,
                      split: bool, max_frags: int = 4096,
                      fallback_title: str = ""):
    """Native exact compress of a PDB buffer.

    Returns a list of fragment dicts (blob, chain, chain_ord, frag_ord,
    n_frags_in_chain, n_chains, error) in reference CLI order, or None when
    the native library is unavailable. `split=False` is the Python-binding
    mode (all atoms, one fragment). With title=None the stored title is the
    parsed structure title, or `fallback_title` when absent — resolved from
    the same single parse (main.cpp:464-465 rule).
    """
    lib = get_lib()
    if lib is None:
        return None
    b = _parse_raw(lib, data)
    n = b["n"]
    if n == 0:
        return []
    if title is None:
        title = b["title"] or fallback_title
    tbytes = title.encode("latin1", "replace")
    cap = 16 * n + (len(tbytes) + 4096) * 8 + (1 << 16)
    out = ctypes.create_string_buffer(cap)
    frag_off = np.zeros(max_frags, np.int64)
    frag_len = np.zeros(max_frags, np.int64)
    frag_chain = ctypes.create_string_buffer(max_frags + 1)
    frag_meta = np.zeros(max_frags * 4, np.int32)
    nf = lib.fcz_encode_atoms(
        b["name4"], b["res3"], b["chain"], b["atom_index"],
        b["residue_index"], b["coords"], b["temp"], n, threshold, tbytes,
        len(tbytes), 1 if split else 0, out, cap, frag_off, frag_len,
        frag_chain, frag_meta, max_frags)
    if nf < 0:
        raise RuntimeError("fcz_encode_atoms overflow")
    frags = []
    raw = out.raw
    for i in range(int(nf)):
        ln = int(frag_len[i])
        frags.append(dict(
            blob=raw[int(frag_off[i]):int(frag_off[i]) + ln] if ln > 0
            else b"",
            error=(None if ln > 0 else
                   "fragment must contain at least 2 residues" if ln == -1
                   else "unknown residue name"),
            chain=frag_chain.raw[i:i + 1].decode("latin1"),
            chain_ord=int(frag_meta[4 * i]),
            frag_ord=int(frag_meta[4 * i + 1]),
            n_frags_in_chain=int(frag_meta[4 * i + 2]),
            n_chains=int(frag_meta[4 * i + 3])))
    return frags


def decode_fcz_pdb_native(blob: bytes, use_alt: bool = False,
                          as_bytes: bool = False):
    """Native exact FCZ decode -> PDB text; None if library missing.

    Raises ValueError on a malformed stream (same conditions as
    codec/fcz.py parse + decoder.decode). With as_bytes=True the raw
    buffer is returned without a str round-trip (the CLI write path).
    """
    lib = get_lib()
    if lib is None:
        return None
    cap = lib.fcz_decode_pdb_cap(blob, len(blob))
    if cap < 0:
        raise ValueError("not a valid fcz stream (bad magic)")
    out = ctypes.create_string_buffer(int(cap))
    written = lib.fcz_decode_pdb(blob, len(blob), 1 if use_alt else 0, out)
    if written < 0:
        raise ValueError(f"fcz decode failed (error {written})")
    raw = out.raw[:written]
    return raw if as_bytes else raw.decode("latin1")


def parse_pdb_native(data: bytes):
    """Native ATOM-line parse -> dict of arrays; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = lib.fcio_count_atoms(data, len(data))
    atom_index = np.empty(n, np.int32)
    residue_index = np.empty(n, np.int32)
    name4 = ctypes.create_string_buffer(int(n) * 4 + 1)
    res3 = ctypes.create_string_buffer(int(n) * 3 + 1)
    chain = ctypes.create_string_buffer(int(n) + 1)
    coords = np.empty((n, 3), np.float32)
    occ = np.empty(n, np.float32)
    temp = np.empty(n, np.float32)
    title_buf = ctypes.create_string_buffer(8192)
    title_len = ctypes.c_int32(0)
    got = lib.fcio_parse_pdb(data, len(data), atom_index, residue_index,
                             name4, res3, chain, coords, occ, temp,
                             title_buf, ctypes.byref(title_len), 8192)
    assert got == n
    names = np.char.strip(np.frombuffer(
        name4.raw[:n * 4], dtype="S4").astype("U4"))
    resnames = np.char.strip(np.frombuffer(
        res3.raw[:n * 3], dtype="S3").astype("U3"))
    chains = np.frombuffer(chain.raw[:n], dtype="S1").astype("U1")
    return dict(
        atom_name=names.tolist(), residue_name=resnames.tolist(),
        chain=chains.tolist(), atom_index=atom_index,
        residue_index=residue_index, coords=coords, occupancy=occ,
        temp_factor=temp,
        title=title_buf.raw[:title_len.value].decode("latin1"))


def place_sc_from_bb_native(bb, codes, sc_codes, first_res: str):
    """O + side-chain placement from an external backbone (the bb-only
    decode wire): [n, 3, 3] N/CA/C rows -> [n, 14, 3] atom slots via
    native/fccodec.c fcz_place_sc_from_bb (reference float op order).
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    bbc = np.ascontiguousarray(bb, np.float32)
    n = bbc.shape[0]
    codes_c = np.ascontiguousarray(codes, np.int32)
    sc = np.ascontiguousarray(sc_codes, np.uint8)
    out = np.empty((n, 14, 3), np.float32)
    ch = (first_res[:1] or "?").encode("latin1")
    got = lib.fcz_place_sc_from_bb(n, bbc, codes_c, sc, len(sc), ch, out)
    if got < 0:
        return None
    return out
