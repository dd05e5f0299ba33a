"""How the port's outputs are held to the reference's: plain NumPy and
text, no import of the port."""
from __future__ import annotations

import os

import numpy as np

COORDS = slice(30, 54)


def slot_deviation(got, ref, cnt):
    """Per residue, the largest |coordinate difference| (A) over the atoms
    the residue has (the first cnt[i] of its 14 slots), and the count of
    those atoms whose coordinates are not finite. got, ref: [n, 14, 3]."""
    mask = np.arange(got.shape[1])[None, :] < np.asarray(cnt)[:, None]
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64)).max(-1)
    bad = ~np.isfinite(got).all(-1) & mask
    d = np.where(mask, d, 0.0)
    d[bad] = np.inf
    return d.max(-1), int(bad.sum())


def pdb_text_gap(got: str, ref: str):
    """(largest |coordinate difference| A, lines that differ outside the
    coordinate columns) of a PDB text against the reference's: ATOM and
    HETATM lines are compared column for column but for x, y and z, which
    are compared as numbers; every other line as text."""
    a, b = got.splitlines(), ref.splitlines()
    bad = abs(len(a) - len(b))
    worst = 0.0
    xyz_a, xyz_b = [], []
    for la, lb in zip(a, b):
        if la[:6] in ("ATOM  ", "HETATM") and lb[:6] == la[:6]:
            if la[:30] != lb[:30] or la[54:] != lb[54:]:
                bad += 1
                continue
            xyz_a.append(la[COORDS])
            xyz_b.append(lb[COORDS])
        elif la != lb:
            bad += 1
    if xyz_a:
        try:
            ca = np.array([[s[0:8], s[8:16], s[16:24]] for s in xyz_a],
                          np.float64)
            cb = np.array([[s[0:8], s[8:16], s[16:24]] for s in xyz_b],
                          np.float64)
            worst = float(np.abs(ca - cb).max())
        except ValueError:
            worst = float("inf")
    return worst, bad


def read_db(path: str) -> dict:
    """{name: payload bytes} of a Foldcomp database (<db>, <db>.index
    "key offset length", <db>.lookup "key name 0"); an entry without a
    name is listed under its key."""
    names = {}
    if os.path.exists(path + ".lookup"):
        with open(path + ".lookup") as fh:
            for line in fh:
                p = line.rstrip("\n").split("\t")
                if len(p) >= 2:
                    names[int(p[0])] = p[1]
    out = {}
    with open(path, "rb") as data, open(path + ".index") as idx:
        blob = data.read()
        for line in idx:
            p = line.rstrip("\n").split("\t")
            if len(p) < 3:
                continue
            key, off, n = int(p[0]), int(p[1]), int(p[2])
            out[names.get(key, str(key))] = blob[off:off + n]
    return out
