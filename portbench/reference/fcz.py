# Frozen copy of foldcomp_tpu_torch/codec/fcz.py:1-235 at commit 5ba08cd7580a
# (5ba08cd7580a295d1f8bab06ceee779a4da42958), imports made local to portbench/reference.
# Frozen so that the yardstick stays fixed while later changes edit the
# port: the benchmark judges the port against this copy, never against
# the port's own modules. It imports nothing of the port.
"""FCZ on-disk format: byte-exact reader/writer.

Layout parity with Foldcomp::writeStream / Foldcomp::read
(foldcomp.cpp:1038-1109 / 904-1036):

    0     "FCMP"
    4     CompressedFileHeader (72 B, foldcomp.h:118-136); the two 2-byte
          struct paddings (file offsets 14-15 and 22-23) are written as zeros
          here and must be masked when comparing against files written by
          builds that leak stack bytes into them.
    76    int32 anchorIndices[nAnchor]
    ..    title bytes (lenTitle)
    ..    float32 anchor N/CA/C coords [nAnchor, 3, 3]
    ..    u8 hasOXT; float32 OXT xyz
    ..    u8 records[nResidue, 8]   (bit layout foldcomp.cpp:33-52)
    ..    u8 sideChain[nSideChainTorsion]
    ..    float32 tempFactor min, cont_f; u8 tempFactors[nResidue]

The port's own copy of `foldcomp_tpu/codec/fcz.py:1`, kept line for line so
that both packages write the same bytes (tests/test_torch_standalone.py
holds the two to the same results).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

MAGIC = b"FCMP"
HEADER_FMT = "<HHHHBc2sIcc2sI6f6f"
HEADER_SIZE = struct.calcsize(HEADER_FMT)
assert HEADER_SIZE == 72

NUM_BITS_PHI_PSI = 12
NUM_BITS_OMEGA = 11
NUM_BITS_BOND = 8
NUM_BITS_RESIDUE = 5
NUM_BITS_TEMP = 8
DEFAULT_ANCHOR_THRESHOLD = 25


@dataclass
class FczData:
    """In-memory form of one compressed chain fragment."""
    n_residue: int
    n_atom: int
    idx_residue: int
    idx_atom: int
    n_anchor: int
    chain: str
    n_sc_torsion: int
    first_residue: str
    last_residue: str
    title: str
    mins: np.ndarray        # float32 [6]: phi, psi, omega, n_ca_c, ca_c_n, c_n_ca
    cont_fs: np.ndarray     # float32 [6]
    anchor_indices: np.ndarray   # int32 [n_anchor]
    anchor_coords: np.ndarray    # float32 [n_anchor, 3, 3] (N, CA, C)
    has_oxt: bool
    oxt_coords: np.ndarray       # float32 [3]
    records: np.ndarray          # uint8 [n_residue, 8]
    sc_codes: np.ndarray         # uint8 [n_sc_torsion]
    tf_min: np.float32
    tf_cont: np.float32
    tf_codes: np.ndarray         # uint8 [n_residue]


def pack_records(residue, phi, psi, omega, n_ca_c, ca_c_n, c_n_ca) -> np.ndarray:
    """Pack discretized per-residue fields into 8-byte records.

    Bit layout of convertBackboneChainToBytes (foldcomp.cpp:33-52). Inputs are
    uint32 arrays; values are masked to their bitfield widths exactly like the
    C++ bitfield assignment wraps them.
    """
    residue = np.asarray(residue, np.uint32) & 0x1F
    omega = np.asarray(omega, np.uint32) & 0x7FF
    psi = np.asarray(psi, np.uint32) & 0xFFF
    phi = np.asarray(phi, np.uint32) & 0xFFF
    n_ca_c = np.asarray(n_ca_c, np.uint32) & 0xFF
    ca_c_n = np.asarray(ca_c_n, np.uint32) & 0xFF
    c_n_ca = np.asarray(c_n_ca, np.uint32) & 0xFF
    rec = np.empty((len(residue), 8), dtype=np.uint8)
    rec[:, 0] = (residue << 3) | (omega >> 8)
    rec[:, 1] = omega & 0xFF
    rec[:, 2] = psi >> 4
    rec[:, 3] = ((psi & 0xF) << 4) | (phi >> 8)
    rec[:, 4] = phi & 0xFF
    rec[:, 5] = ca_c_n
    rec[:, 6] = c_n_ca
    rec[:, 7] = n_ca_c
    return rec


def unpack_records(rec: np.ndarray):
    """Inverse of pack_records (convertBytesToBackboneChain, foldcomp.cpp:60-77)."""
    rec = np.asarray(rec, np.uint32)
    residue = rec[:, 0] >> 3
    omega = ((rec[:, 0] & 0x7) << 8) | rec[:, 1]
    psi = (rec[:, 2] << 4) | (rec[:, 3] >> 4)
    phi = ((rec[:, 3] & 0xF) << 8) | rec[:, 4]
    ca_c_n = rec[:, 5]
    c_n_ca = rec[:, 6]
    n_ca_c = rec[:, 7]
    return residue, phi, psi, omega, n_ca_c, ca_c_n, c_n_ca


def serialize(f: FczData) -> bytes:
    header = struct.pack(
        HEADER_FMT,
        f.n_residue & 0xFFFF, f.n_atom & 0xFFFF,
        f.idx_residue & 0xFFFF, f.idx_atom & 0xFFFF,
        f.n_anchor & 0xFF, f.chain[:1].encode("latin1") or b"\x00",
        b"\x00\x00",
        f.n_sc_torsion & 0xFFFFFFFF,
        f.first_residue[:1].encode("latin1") or b"\x00",
        f.last_residue[:1].encode("latin1") or b"\x00",
        b"\x00\x00",
        len(f.title.encode("latin1", "replace")),
        *np.asarray(f.mins, np.float32).tolist(),
        *np.asarray(f.cont_fs, np.float32).tolist(),
    )
    parts = [MAGIC, header,
             np.asarray(f.anchor_indices, "<i4").tobytes(),
             f.title.encode("latin1", "replace"),
             np.asarray(f.anchor_coords, "<f4").tobytes(),
             b"\x01" if f.has_oxt else b"\x00",
             np.asarray(f.oxt_coords, "<f4").tobytes(),
             np.asarray(f.records, np.uint8).tobytes(),
             np.asarray(f.sc_codes, np.uint8).tobytes(),
             struct.pack("<ff", f.tf_min, f.tf_cont),
             np.asarray(f.tf_codes, np.uint8).tobytes()]
    return b"".join(parts)


class FczFormatError(ValueError):
    pass


def parse(data: bytes, strict: bool = True) -> FczData:
    """Parse one FCZ payload.

    strict=True (decode paths): any truncation raises FczFormatError so a
    bad DB entry is skipped, never silently mis-decoded.
    strict=False (the `check` path): the variable-length tail arrays are
    clipped to the bytes actually present, so check_validity can compare
    header counts against the real stream contents and report the
    reference's E_*_COUNT_MISMATCH codes (foldcomp.h:59-67) on truncated
    entries. (The reference's read() fills vectors to header counts from
    unspecified buffer contents on short reads — foldcomp.cpp:975-1025 —
    so its own count checks cannot fire; clipping gives the error codes
    their intended meaning.)
    """
    if len(data) < 4 + HEADER_SIZE or data[:4] != MAGIC:
        raise FczFormatError("not a valid fcz stream (bad magic)")
    (n_res, n_atom, idx_res, idx_atom, n_anchor, chain, _pad1, n_sc,
     first_res, last_res, _pad2, len_title, *floats) = struct.unpack(
        HEADER_FMT, data[4:4 + HEADER_SIZE])
    mins = np.asarray(floats[:6], np.float32)
    cont_fs = np.asarray(floats[6:], np.float32)
    off = 4 + HEADER_SIZE

    def take(count, itemsize, dtype):
        """Read `count` items; returns (array, new_off). Clips in
        non-strict mode, raises in strict mode when short."""
        nonlocal off
        avail = max(0, len(data) - off) // itemsize
        n = count if avail >= count else avail
        if n < count and strict:
            raise FczFormatError(
                f"truncated fcz stream ({len(data)} bytes, "
                f"needed {off + count * itemsize})")
        if n == 0:
            arr = np.zeros(0, dtype)
        else:
            arr = np.frombuffer(data, dtype, count=n, offset=off).copy()
        off += count * itemsize
        return arr

    def pad_to(arr, count, itemsize):
        """Zero-fill a clipped fixed-geometry array (non-strict only)."""
        if len(arr) < count:
            arr = np.concatenate(
                [arr, np.zeros(count - len(arr), arr.dtype)])
        return arr

    anchor_indices = pad_to(take(n_anchor, 4, "<i4"), n_anchor, 4)
    title = data[off:off + len_title].decode("latin1")
    if len(title) < len_title and strict:
        raise FczFormatError("truncated fcz stream (title)")
    off += len_title
    anchor_coords = pad_to(take(9 * n_anchor, 4, "<f4"),
                           9 * n_anchor, 4).reshape(n_anchor, 3, 3)
    has_oxt = bool(data[off]) if off < len(data) else False
    if off >= len(data) and strict:
        raise FczFormatError("truncated fcz stream (oxt flag)")
    off += 1
    oxt = pad_to(take(3, 4, "<f4"), 3, 4)
    # variable tail arrays: clipped (not padded) so check_validity sees
    # the actual stream counts
    records = take(8 * n_res, 1, np.uint8)
    records = records[:(len(records) // 8) * 8].reshape(-1, 8)
    sc_codes = take(n_sc, 1, np.uint8)
    if off + 8 <= len(data):
        tf_min, tf_cont = struct.unpack_from("<ff", data, off)
    elif strict:
        raise FczFormatError("truncated fcz stream (tempFactor discretizer)")
    else:
        tf_min, tf_cont = 0.0, 0.0
    off += 8
    tf_codes = take(n_res, 1, np.uint8)
    return FczData(
        n_residue=n_res, n_atom=n_atom, idx_residue=idx_res, idx_atom=idx_atom,
        n_anchor=n_anchor, chain=chain.decode("latin1"), n_sc_torsion=n_sc,
        first_residue=first_res.decode("latin1"),
        last_residue=last_res.decode("latin1"), title=title, mins=mins,
        cont_fs=cont_fs, anchor_indices=anchor_indices,
        anchor_coords=anchor_coords, has_oxt=has_oxt, oxt_coords=oxt,
        records=records, sc_codes=sc_codes, tf_min=np.float32(tf_min),
        tf_cont=np.float32(tf_cont), tf_codes=tf_codes,
    )


PADDING_OFFSETS = (14, 15, 22, 23)


def equal_with_padding_mask(a: bytes, b: bytes) -> bool:
    """Byte equality ignoring the 4 header struct-padding bytes."""
    if len(a) != len(b):
        return False
    aa = bytearray(a)
    bb = bytearray(b)
    for o in PADDING_OFFSETS:
        aa[o] = bb[o] = 0
    return bytes(aa) == bytes(bb)
