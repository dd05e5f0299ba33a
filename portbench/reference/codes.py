# Frozen copy of foldcomp_tpu_torch/core/codes.py:1-72 at commit 5ba08cd7580a
# (5ba08cd7580a295d1f8bab06ceee779a4da42958), imports made local to portbench/reference.
# Frozen so that the yardstick stays fixed while later changes edit the
# port: the benchmark judges the port against this copy, never against
# the port's own modules. It imports nothing of the port.
"""Residue-code conversions (1-letter <-> 5-bit int <-> 3-letter).

Parity with reference foldcomp: src/utility.h:133-206 (AA_*_INT/STR/CHAR constants),
src/utility.cpp:178-470 (conversion functions). The 5-bit integer code is what the
FCZ format stores per residue (src/foldcomp.h:73).

The port's own copy of `foldcomp_tpu/core/codes.py:1`, kept line for line so
that both packages write the same bytes (tests/test_torch_standalone.py
holds the two to the same results).
"""
from __future__ import annotations

import numpy as np

# Index-aligned tables: code i -> one-letter char / three-letter string.
ONE_LETTER = [
    "A", "R", "N", "D", "C", "Q", "E", "G", "H", "I",
    "L", "K", "M", "F", "P", "S", "T", "W", "Y", "V",
    "B", "Z", "*", "X",
]
THREE_LETTER = [
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    "ASX", "GLX", "STP", "UNK",
]

UNK_INT = 23
NUM_AA = 20  # valid amino acids with geometry tables

_ONE_TO_INT = {c: i for i, c in enumerate(ONE_LETTER)}
_THREE_TO_ONE = {t: c for t, c in zip(THREE_LETTER, ONE_LETTER)}
_ONE_TO_THREE = {c: t for t, c in zip(THREE_LETTER, ONE_LETTER)}


def one_letter_from_three(three: str) -> str:
    """3-letter -> 1-letter; unknown names map to 'X' (utility.cpp:178-229)."""
    return _THREE_TO_ONE.get(three, "X")


def three_letter_from_one(one: str) -> str:
    return _ONE_TO_THREE.get(one, "UNK")


def int_from_one_letter(one: str) -> int:
    """1-letter -> 5-bit code; unknown -> 23/UNK (utility.cpp:379+)."""
    return _ONE_TO_INT.get(one, UNK_INT)


def one_letter_from_int(code: int) -> str:
    if 0 <= code < len(ONE_LETTER):
        return ONE_LETTER[code]
    return "X"


def three_letter_from_int(code: int) -> str:
    if 0 <= code < len(THREE_LETTER):
        return THREE_LETTER[code]
    return "UNK"


def int_from_three_letter(three: str) -> int:
    return int_from_one_letter(one_letter_from_three(three))


# Vectorized lookup tables (for batched kernels).
# ascii byte of one-letter code -> 5-bit int (unknown -> 23)
ASCII_TO_INT = np.full(128, UNK_INT, dtype=np.int32)
for _i, _c in enumerate(ONE_LETTER):
    ASCII_TO_INT[ord(_c)] = _i

INT_TO_ASCII = np.array([ord(c) for c in ONE_LETTER] + [ord("X")] * (32 - len(ONE_LETTER)),
                        dtype=np.int32)
