# Frozen copy of foldcomp_tpu_torch/io/pdb.py:1-210 at commit 5ba08cd7580a
# (5ba08cd7580a295d1f8bab06ceee779a4da42958), imports made local to
# portbench/reference, and the native parser and formatter calls taken
# out (pure Python only).
# Frozen so that the yardstick stays fixed while later changes edit the
# port: the benchmark judges the port against this copy, never against
# the port's own modules. It imports nothing of the port.
"""PDB text parsing and fixed-column writing.

Parser parity: gemmi's PDB reader subset used by the reference
(structure_reader.cpp:31-61): ATOM/HETATM records -> name/residue/chain/serial/
seqid/xyz/b_iso, and TITLE records concatenated from column 11, right-trimmed.

Writer parity: writeAtomCoordinatesToPDB (atom_coordinate.cpp:220-291) including
the custom fast_ftoa<T,P> float formatting (atom_coordinate.cpp:186-218).

The port's own copy of `foldcomp_tpu/io/pdb.py:1`, kept line for line so
that both packages write the same bytes (tests/test_torch_standalone.py
holds the two to the same results).
"""
from __future__ import annotations

import numpy as np

from .structure import AtomArray

F32 = np.float32


def parse_pdb(text, default_title: str = "") -> AtomArray:
    """Parse ATOM/HETATM lines of a PDB file into an AtomArray.

    The copy keeps only the original's pure-Python path (the original
    prefers the port's native parser, which it calls semantics-identical).
    """
    if isinstance(text, str):
        raw = text.encode("utf-8", "replace")
    else:
        raw = bytes(text)
    text = raw.decode("utf-8", "replace")
    atom_name, residue_name, chain = [], [], []
    atom_index, residue_index = [], []
    xs, ys, zs, occ, bf = [], [], [], [], []
    title_parts = []
    entry_id = ""
    for line in text.splitlines():
        rec = line[:6]
        if rec == "ATOM  " or rec == "HETATM":
            if len(line) < 54:
                continue
            atom_name.append(line[12:16].strip())
            residue_name.append(line[17:20].strip())
            chain.append(line[21])
            try:
                atom_index.append(int(line[6:11]))
            except ValueError:
                atom_index.append(0)
            try:
                residue_index.append(int(line[22:26]))
            except ValueError:
                residue_index.append(0)
            xs.append(float(line[30:38]))
            ys.append(float(line[38:46]))
            zs.append(float(line[46:54]))
            try:
                occ.append(float(line[54:60]))
            except (ValueError, IndexError):
                occ.append(1.0)
            try:
                bf.append(float(line[60:66]))
            except (ValueError, IndexError):
                bf.append(0.0)
        elif rec == "ENDMDL" and atom_name:
            # first model only: the reference concatenates every model
            # and crashes downstream (structure_reader.cpp:47-60);
            # first-model-only is the pinned deterministic behavior
            break
        elif rec == "TITLE " and len(line) > 10:
            title_parts.append(line[10:].rstrip())
        elif rec == "HEADER":
            # gemmi fills _entry.id from the HEADER idCode (cols 63-66); the
            # reference prefers it over _struct.title (structure_reader.cpp:37-45)
            entry_id = line[62:66].strip()
    if entry_id:
        title = entry_id
    elif title_parts:
        title = "".join(title_parts)
    else:
        title = default_title
    coords = np.stack([np.asarray(xs, np.float64), np.asarray(ys, np.float64),
                       np.asarray(zs, np.float64)], axis=-1).astype(F32) \
        if xs else np.zeros((0, 3), F32)
    return AtomArray(
        atom_name, residue_name, chain,
        np.asarray(atom_index, np.int32), np.asarray(residue_index, np.int32),
        coords, np.asarray(occ, F32), np.asarray(bf, F32), title,
    )


def _fast_ftoa(n: float, t: int, p: int) -> str:
    """fast_ftoa<T,P> replica (atom_coordinate.cpp:186-218).

    Adds +-(0.5f/T), truncates integer and fractional parts toward zero,
    zero-pads the fraction to P digits.
    """
    n = F32(n)
    half = F32(F32(0.5) / F32(t))
    rounded = F32(n + (-half if n < 0 else half))
    integer = int(rounded)  # trunc toward zero
    decimal = int(F32((rounded - F32(integer)) * F32(t)))
    sign = ""
    if n < 0:
        integer = abs(integer)
        decimal = abs(decimal)
        sign = "-"
    ds = str(decimal)
    return f"{sign}{integer}.{'0' * max(0, p - len(ds))}{ds}"


def format_pdb(atoms: AtomArray, title: str = "") -> str:
    """writeAtomCoordinatesToPDB replica (atom_coordinate.cpp:220-291).

    The copy keeps only the original's pure-Python path (the original
    prefers the port's native formatter, which it calls byte-identical).
    """
    out = []
    if title:
        out.append(f"TITLE     {title[:70]}\n")
        rest = title[70:]
        cont = 2
        while rest:
            out.append(f"TITLE  {cont:3d}{rest[:70]}\n")
            rest = rest[70:]
            cont += 1

    n = len(atoms)
    # vectorized fast_ftoa for coordinates (T=1000, P=3)
    c = atoms.coords.astype(F32)
    half = F32(0.0005)
    rounded = c + np.where(c < 0, -half, half).astype(F32)
    integer = rounded.astype(np.int64)  # trunc toward zero
    frac = ((rounded - integer.astype(F32)) * F32(1000.0)).astype(np.int64)
    neg = c < 0
    # tempFactor (T=100, P=2)
    b = atoms.temp_factor.astype(F32)
    bhalf = F32(0.005)
    brounded = b + np.where(b < 0, -bhalf, bhalf).astype(F32)
    bint = brounded.astype(np.int64)
    bfrac = ((brounded - bint.astype(F32)) * F32(100.0)).astype(np.int64)
    bneg = b < 0

    for i in range(n):
        name = atoms.atom_name[i]
        if len(name) == 4:
            namefield = f"{name:<4s}"
        else:
            namefield = f" {name:<3s}"
        coord_strs = []
        for k in range(3):
            sign = "-" if neg[i, k] else ""
            iv = abs(int(integer[i, k]))
            dv = abs(int(frac[i, k]))
            ds = str(dv)
            coord_strs.append(f"{sign}{iv}.{'0' * max(0, 3 - len(ds))}{ds}")
        sign = "-" if bneg[i] else ""
        iv = abs(int(bint[i]))
        dv = abs(int(bfrac[i]))
        ds = str(dv)
        bstr = f"{sign}{iv}.{'0' * max(0, 2 - len(ds))}{ds}"
        out.append(
            "ATOM  "
            f"{int(atoms.atom_index[i]):5d}"
            " "
            f"{namefield}"
            " "
            f"{atoms.residue_name[i]:>3s}"
            " "
            f"{atoms.chain[i]}"
            f"{int(atoms.residue_index[i]):4d}"
            "    "
            f"{coord_strs[0]:>8s}{coord_strs[1]:>8s}{coord_strs[2]:>8s}"
            "  1.00"
            f"{bstr:>6s}"
            "          "
            f"{name[0]:>2s}"
            "  \n"
        )
        if i == n - 1:
            out.append(
                "TER   "
                f"{int(atoms.atom_index[i]) + 1:5d}"
                "      "
                f"{atoms.residue_name[i]:>3s}"
                " "
                f"{atoms.chain[i]}"
                f"{int(atoms.residue_index[i]):4d}"
                "\n"
            )
    return "".join(out)
