# Frozen copy of foldcomp_tpu_torch/io/structure.py:1-117 at commit 5ba08cd7580a
# (5ba08cd7580a295d1f8bab06ceee779a4da42958), imports made local to portbench/reference.
# Frozen so that the yardstick stays fixed while later changes edit the
# port: the benchmark judges the port against this copy, never against
# the port's own modules. It imports nothing of the port.
"""Struct-of-arrays structure model (replaces reference AtomCoordinate vectors).

The reference passes std::vector<AtomCoordinate> everywhere
(src/atom_coordinate.h:23-55). Here a parsed structure is one AtomArray of
column arrays, which converts directly to device-friendly tensors.

The port's own copy of `foldcomp_tpu/io/structure.py:1`, kept line for line so
that both packages write the same bytes (tests/test_torch_standalone.py
holds the two to the same results).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class AtomArray:
    atom_name: list  # list[str], stripped atom names
    residue_name: list  # list[str], 3-letter residue names
    chain: list  # list[str], chain ids
    atom_index: np.ndarray  # int32 [N]
    residue_index: np.ndarray  # int32 [N]
    coords: np.ndarray  # float32 [N, 3]
    occupancy: np.ndarray  # float32 [N]
    temp_factor: np.ndarray  # float32 [N]
    title: str = ""

    def __len__(self) -> int:
        return len(self.atom_name)

    def slice(self, start: int, end: int) -> "AtomArray":
        return AtomArray(
            self.atom_name[start:end], self.residue_name[start:end],
            self.chain[start:end], self.atom_index[start:end],
            self.residue_index[start:end], self.coords[start:end],
            self.occupancy[start:end], self.temp_factor[start:end], self.title,
        )

    def take(self, idx) -> "AtomArray":
        idx = np.asarray(idx)
        return AtomArray(
            [self.atom_name[i] for i in idx], [self.residue_name[i] for i in idx],
            [self.chain[i] for i in idx], self.atom_index[idx],
            self.residue_index[idx], self.coords[idx],
            self.occupancy[idx], self.temp_factor[idx], self.title,
        )

    @staticmethod
    def empty(title: str = "") -> "AtomArray":
        return AtomArray([], [], [], np.zeros(0, np.int32), np.zeros(0, np.int32),
                         np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
                         np.zeros(0, np.float32), title)


def remove_alternative_positions(atoms: AtomArray) -> AtomArray:
    """Drop consecutive duplicate atom names (atom_coordinate.cpp:362-370)."""
    if len(atoms) == 0:
        return atoms
    keep = [0]
    prev = atoms.atom_name[0]
    for i in range(1, len(atoms)):
        if atoms.atom_name[i] == prev:
            continue
        keep.append(i)
        prev = atoms.atom_name[i]
    if len(keep) == len(atoms):
        return atoms
    return atoms.take(np.asarray(keep, dtype=np.int64))


def identify_chains(atoms: AtomArray):
    """Chain fragmentation (atom_coordinate.cpp:469-498): [start, end) pairs.

    On a chain switch the new fragment must start at an "N" atom; a leading
    non-N run of the new chain is folded into the previous fragment, exactly
    like the reference.
    """
    out = []
    n = len(atoms)
    start = 0
    i = 1
    while i < n:
        if atoms.chain[i] != atoms.chain[i - 1]:
            if atoms.atom_name[i] == "N":
                out.append((start, i))
                start = i
            else:
                j = i
                while j < n and atoms.atom_name[j] != "N":
                    j += 1
                if j < n:
                    out.append((start, i))
                    start = j
                    i = start
                # if no N found, fall through: fragment extends to the end
        i += 1
    out.append((start, n))
    return out


def identify_discontinuous_fragments(atoms: AtomArray, chain_start: int,
                                     chain_end: int):
    """Residue-index discontinuity split (atom_coordinate.cpp:506-530)."""
    n_idx = [(i, int(atoms.residue_index[i]))
             for i in range(chain_start, chain_end) if atoms.atom_name[i] == "N"]
    if not n_idx:
        return [(chain_start, chain_end)]
    out = []
    start = n_idx[0][0]
    for k in range(1, len(n_idx)):
        if n_idx[k][1] - n_idx[k - 1][1] > 1:
            out.append((start, n_idx[k][0]))
            start = n_idx[k][0]
    out.append((start, chain_end))
    return out
