"""pLDDT / sequence extraction and FCZ validity checking.

Parity: Foldcomp::extract (foldcomp.cpp:1260-1336), writeFASTALike/writeTSV
(foldcomp.cpp:1223-1237), checkValidity (foldcomp.cpp:1492-1532).

The port's own copy of `foldcomp_tpu/codec/extract.py:1`, kept line for line so
that both packages write the same bytes (tests/test_torch_standalone.py
holds the two to the same results).
"""
from __future__ import annotations

import numpy as np

from ..core import exact
from ..core.codes import one_letter_from_int
from .fcz import FczData, NUM_BITS_TEMP, unpack_records

F32 = np.float32

# ValidityError codes (foldcomp.h:59-67)
SUCCESS = 0
E_BACKBONE_COUNT_MISMATCH = 1
E_SIDECHAIN_COUNT_MISMATCH = 2
E_TEMP_FACTOR_COUNT_MISMATCH = 3
E_EMPTY_BACKBONE_ANGLE = 4
E_EMPTY_SIDECHAIN_ANGLE = 5
E_EMPTY_TEMP_FACTOR = 6

VALIDITY_MESSAGES = {
    E_BACKBONE_COUNT_MISMATCH:
        "[Error] Number of backbone angles does not match header: ",
    E_SIDECHAIN_COUNT_MISMATCH:
        "[Error] Number of sidechain angles does not match header: ",
    E_TEMP_FACTOR_COUNT_MISMATCH:
        "[Error] Number of temperature factors does not match header: ",
    E_EMPTY_BACKBONE_ANGLE: "[Error] All backbone angles are empty: ",
    E_EMPTY_SIDECHAIN_ANGLE: "[Error] All sidechain angles are empty: ",
    E_EMPTY_TEMP_FACTOR: "[Error] All temperature factors are empty: ",
}


def check_validity(f: FczData) -> int:
    """Reference checkValidity (foldcomp.cpp:1492-1532). The count checks
    have teeth when `f` comes from fcz.parse(strict=False), which clips the
    tail arrays to the bytes actually present in the stream — a truncated
    entry then reports the matching E_*_COUNT_MISMATCH code. The empty
    checks use std::all_of semantics (an empty range counts as empty)."""
    if f.n_residue != len(f.records):
        return E_BACKBONE_COUNT_MISMATCH
    if f.n_sc_torsion != len(f.sc_codes):
        return E_SIDECHAIN_COUNT_MISMATCH
    if f.n_residue != len(f.tf_codes):
        return E_TEMP_FACTOR_COUNT_MISMATCH
    _res, phi, psi, omega, *_ = unpack_records(f.records)
    if bool(np.all((phi == 0) & (psi == 0) & (omega == 0))):
        return E_EMPTY_BACKBONE_ANGLE
    if bool(np.all(f.sc_codes == 0)):
        return E_EMPTY_SIDECHAIN_ANGLE
    if bool(np.all(f.tf_codes == 0)):
        return E_EMPTY_TEMP_FACTOR
    return SUCCESS


def extract_plddt(f: FczData, digits: int = 1) -> str:
    """tempFactor extraction with the reference's digit formatting
    (foldcomp.cpp:1262-1326): truncating per-digit conversion, auto
    0-1 vs 0-100 scale detection."""
    digits = max(1, min(4, digits))
    d = exact.Discretizer.from_params(f.tf_min, f.tf_cont)
    tf = d.continuize(f.tf_codes)
    maxval = float(F32(f.tf_cont * F32(2 ** NUM_BITS_TEMP - 1) + f.tf_min))
    zero_to_one = maxval <= 1.0 and digits <= 2
    out = []
    n = len(tf)
    for i in range(n):
        v = float(tf[i])
        if zero_to_one:
            c = min(max(v, 0.0), 1.0)
            c = float(F32(c))
            digit1 = chr(int(F32(c * 10.0)) % 10 + ord("0"))
            digit2 = chr(int(F32(c * 100.0)) % 10 + ord("0"))
        else:
            c = min(max(v, 0.0), 100.0)
            c = float(F32(c))
            digit1 = chr(int(F32(c / F32(10.0))) + ord("0"))
            digit2 = chr(int(c) % 10 + ord("0"))
        out.append(digit1)
        if digits > 1:
            out.append(digit2)
        if digits >= 3:
            digit3 = chr(int(F32(c * 10.0)) % 10 + ord("0"))
            out.append(".")
            out.append(digit3)
        if digits == 4:
            digit4 = chr(int(F32(c * 100.0)) % 10 + ord("0"))
            out.append(digit4)
        if digits > 1 and i != n - 1:
            out.append(",")
    return "".join(out)


def extract_sequence(f: FczData) -> str:
    res_codes = unpack_records(f.records)[0]
    return "".join(one_letter_from_int(int(c)) for c in res_codes)


def write_fasta_like(title: str, data: str) -> str:
    return f">{title}\n{data}\n"


def write_tsv(title: str, n_residue: int, data: str) -> str:
    return f"{title}\t{n_residue}\t{data}\n"
