"""Constants and chemistry tables of the fused decode and encode.

Every number here is derived from the numpy arrays and constants of the
port's core/aatable.py (its copy of foldcomp_tpu/core/aatable.py), so the
port, its CUDA kernels (which receive these arrays at load time,
kernels/build.py) and the JAX reference read the same values.

The JAX side-chain kernel selects per-residue values with where-chains
grouped by value (pallas_decode._chain_const / _sel_pred): a TPU lane has
no per-lane gather. The port looks them up in a table over all 32 5-bit
residue codes instead. Rows 0-23 are aatable's rows; rows 24-31 hold each
column's largest-group value, which is what the where-chains return for a
code outside 0-23. So every code the record's 5-bit field can carry gives
the JAX answer, and no code reads out of bounds.
"""
from __future__ import annotations

import numpy as np

from .aatable import (BOND_ANG, BOND_LEN, C_TO_N_DIST, CA_TO_C_DIST,
                      N_TO_CA_DIST, PRED_IDX, PRO_N_TO_CA_DIST)

# backbone bond lengths (foldcomp_tpu/kernels/nerf.py:48-51)
C_TO_N = np.float32(C_TO_N_DIST)
N_TO_CA = np.float32(N_TO_CA_DIST)
PRO_N_TO_CA = np.float32(PRO_N_TO_CA_DIST)
CA_TO_C = np.float32(CA_TO_C_DIST)
PRO_CODE = 14

# degrees -> radians, as float32 (geometry.py _RAD, pallas_decode._RADK)
RADK = np.float32(np.pi / 180.0)
# side-chain torsion dequant code*(360/255) - 180 (pallas_decode.py:61-63)
SC_CONT = np.float32(360.0 / 255.0)
SC_MIN = np.float32(-180.0)

# decode field order (psi, omega, phi, n_ca_c, ca_c_n, c_n_ca) from the
# header's column order (phi, psi, omega, ...) (pallas_decode.py:402)
FIELD_COLS = np.asarray([1, 2, 0, 3, 4, 5])

# width classes a batch's lanes are split into at most
# (codec/batch_host.py split_lanes_classes), all of which one launch of
# k0, k1 or k2 takes (kernels/csrc/fused_decode.cu MAX_CLASSES)
MAX_CLASSES = 4

N_CODES = 32          # every value of the record's 5-bit residue code
N_TABLE = 24          # aatable rows


def _where_chain_default(col):
    """The value a where-chain grouped by value returns for a code in no
    group: the largest group's, first-seen on ties (the stable sort by
    group size in _chain_const / _sel_pred)."""
    groups: dict = {}
    for c in range(col.shape[0]):
        groups.setdefault(col[c].item(), []).append(c)
    return max(groups.items(), key=lambda kv: len(kv[1]))[0]


def _extend_codes(table):
    """[24, ...] table -> [32, ...], rows 24-31 the column defaults."""
    flat = table.reshape(N_TABLE, -1)
    out = np.empty((N_CODES, flat.shape[1]), table.dtype)
    out[:N_TABLE] = flat
    for j in range(flat.shape[1]):
        out[N_TABLE:, j] = _where_chain_default(flat[:, j])
    return out.reshape((N_CODES,) + table.shape[1:])


PRED32 = _extend_codes(np.asarray(PRED_IDX, np.int32))     # [32, 14, 3]
BLEN32 = _extend_codes(np.asarray(BOND_LEN, np.float32))   # [32, 14]
BANG32 = _extend_codes(np.asarray(BOND_ANG, np.float32))   # [32, 14]

# scalar constants of the CUDA kernels, in the order of the K_* indices of
# kernels/csrc/fused_decode.cu (PRO_CODE goes to the kernels as an int)
KERNEL_CONSTS = np.asarray([C_TO_N, CA_TO_C, N_TO_CA, RADK, SC_CONT,
                            SC_MIN, PRO_N_TO_CA], np.float32)

# ---------------------------------------------------------------------------
# encode constants, retyped from foldcomp_tpu/kernels/encode.py and
# pallas_encode.py (both import JAX at their top); a CPU test holds each
# one equal to the JAX module's value

# quantizer bins of the backbone streams (encode.py:35-37)
NBIN_PHI_PSI = np.float32(2 ** 12 - 1)
NBIN_OMEGA = np.float32(2 ** 11 - 1)
NBIN_BOND = np.float32(2 ** 8 - 1)
# FixedAngleDiscretizer(255) factor of the side-chain torsions (encode.py:41)
SC_DISC_F = np.float32(255.0 / 360.0)
# err of a row the device cannot trust (encode.py:205), radians -> degrees
# (encode.py:207)
BIGERR = np.float32(1e4)
DEG = np.float32(180.0 / np.pi)
# masked-row sentinel of the lanes-layout epilogue (pallas_encode.py:69; the
# XLA core's encode.py:206 uses 1e30, which changes no unmasked output)
BIGF_LANES = np.float32(3.4e38)
# relative parts-noise budget: the JAX CPU value (encode.py:217), used on
# every device by the port, so relt/relb and tbits bit 32 always exist
PARTS_EPS = float(64 * 2.0 ** -24)
# PRED_IDX as the encode kernel reads it: codes clipped to 0..23
PRED24 = np.ascontiguousarray(PRED_IDX, np.int32)             # [24, 14, 3]
