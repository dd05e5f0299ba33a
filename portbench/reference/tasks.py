"""The reference's work, one structure at a time, for worker processes.

Plain NumPy over the frozen copies beside this file: it imports nothing
of the port. `make_input` builds what the benchmark hands to both sides;
the `ref_*` functions work out, from those inputs alone, what the port's
output has to be; `control=True` runs the same arithmetic in bfloat16,
the nearest precision below the float32 that Foldcomp's codec states
(each value is rounded to bfloat16 where the float32 code rounds to
float32), for the check's control.
"""
from __future__ import annotations

import contextlib
import struct

import numpy as np

from . import decoder, encoder, fcz, pdb, structure, synth
from .aatable import N_ATOMS

MAX_ATOM = 14


_F32 = struct.Struct("<f")
_U32 = struct.Struct("<I")


def _bf16(x):
    """x rounded to float32, then to the nearest bfloat16 (ties to even),
    as a float."""
    b = _U32.unpack(_F32.pack(x))[0]
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return _F32.unpack(_U32.pack(b))[0]


def _bf16_array(a):
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def _fallback(fn, last):
    """fn in bfloat16, or in float32 where bfloat16 leaves it no
    direction to divide by, or `last(*args)` where its bfloat16 inputs
    leave it none in float32 either."""
    def wrapped(*args):
        try:
            return fn(*args)
        except ZeroDivisionError:
            decoder._f32 = _F32_ROUND
            try:
                return fn(*args)
            except ZeroDivisionError:
                return last(*args)
            finally:
                decoder._f32 = _bf16
    return wrapped


def _bond_from_c(a, b, c, bond_length, *_):
    """An atom with no frame: a bond length from its parent along x."""
    return (c[0] + bond_length, c[1], c[2])


_F32_ROUND = decoder._f32


@contextlib.contextmanager
def _decoder_precision(control):
    """The frozen decoder rounds every scalar result through `_f32`; the
    control rounds it to bfloat16 instead. Where the atoms of a frame
    round onto one line (past 128 A a bfloat16 step is 1 A), the frame has
    no direction in bfloat16: that placement or angle is made in float32
    on the bfloat16 atoms, or, where they have none either, the atom goes
    a bond length from its parent and the angle is 180 degrees."""
    if not control:
        yield
        return
    saved = decoder.place_atom, decoder._bond_angle_scalar
    decoder._f32 = _bf16
    decoder.place_atom = _fallback(saved[0], _bond_from_c)
    decoder._bond_angle_scalar = _fallback(saved[1], lambda *a: 180.0)
    try:
        yield
    finally:
        decoder._f32 = _F32_ROUND
        decoder.place_atom, decoder._bond_angle_scalar = saved


def unit_seed(seed: int, u: int) -> list:
    """The seed of structure u of a run: numpy's SeedSequence entropy, so
    any whole --seed, however large, works."""
    return [int(seed) % (1 << 63), int(u)]


def make_input(length: int, seed: int, u: int, kind: str) -> bytes:
    """Structure u of a run's pool: synthesize(length) from (seed, u),
    titled "u<u>", as FCZ bytes (the exact encoder's) or as PDB text."""
    atoms = synth.synthesize(int(length), unit_seed(seed, u))
    title = f"u{u}"
    if kind == "fcz":
        return fcz.serialize(encoder.encode(atoms, title=title))
    if kind == "pdb":
        return pdb.format_pdb(atoms, title).encode()
    raise ValueError(kind)


def ref_slots(blob: bytes, control: bool = False):
    """The decoded protein of FCZ bytes as the port's slot layout: (a14
    f32 [n, 14, 3], atoms a residue i32 [n]); slots past a residue's atoms
    are 0 and are not compared. OXT is not a slot."""
    f = fcz.parse(blob)
    with _decoder_precision(control):
        atoms = decoder.decode(f)
    n = f.n_residue
    codes = fcz.unpack_records(f.records)[0].astype(np.int64)
    cnt = np.where(codes < 20, N_ATOMS[np.minimum(codes, 19)], 3) \
        .astype(np.int32)
    xyz = atoms.coords[:int(cnt.sum())]
    a14 = np.zeros((n, MAX_ATOM, 3), np.float32)
    mask = np.arange(MAX_ATOM)[None, :] < cnt[:, None]
    a14[mask] = xyz
    return a14, cnt


def ref_pdb_text(blob: bytes, control: bool = False) -> str:
    """The PDB text `decompress` writes for FCZ bytes."""
    f = fcz.parse(blob)
    with _decoder_precision(control):
        atoms = decoder.decode(f)
    return pdb.format_pdb(atoms, f.title)


def ref_compress(pdb_bytes: bytes, fallback: str = "",
                 control: bool = False) -> list:
    """The FCZ bytes `compress` writes for a PDB text, one a chain
    fragment (cli.compress_entry's pure-Python route): the title from the
    TITLE records, else `fallback`."""
    atoms = pdb.parse_pdb(pdb_bytes)
    title = atoms.title or fallback
    atoms = structure.remove_alternative_positions(atoms)
    if control:
        atoms.coords = _bf16_array(atoms.coords)
    out = []
    for cs, ce in structure.identify_chains(atoms):
        for fs, fe in structure.identify_discontinuous_fragments(
                atoms, cs, ce):
            frag = atoms.slice(fs, fe)
            out.append(fcz.serialize(encoder.encode(frag, title=title)))
    return out
