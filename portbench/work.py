"""The work a decode must do, counted from its inputs, and the card's
peaks: the yardstick of `decode_roofline_pct`.

The count is what Foldcomp's decode of these FCZ entries needs, whatever
implements it: per protein and anchor segment ("lane") a forward and a
reverse NeRF pass over the segment's backbone, their blend, the side
chains, each input byte read once and each output byte written once. It
is taken from the FCZ bytes alone (the frozen parse), never from the
port's pack, its padded slots or its launch shapes. Its terms are those
of chip_smoke.py decode_work (k2's forward and reverse step, k2's lane
inputs and blend, k3's placements and offsets), at commit 5ba08cd7580a,
with two changes that make it a bound for any implementation: k1's seeding
scan and the rows k2 hands k3 are left out (a single pass needs neither),
and the side chains count the atoms each residue has, not 11 slots.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np

from .reference import fcz
from .reference.aatable import N_ATOMS

# float operations of one sincosf: the instructions of its compiled fast
# path (chip_smoke.py k1_step_sass on an NVIDIA H100 80GB HBM3, PR 13)
SINCOS_OPS = 23
# a forward step: 3 NeRF placements of 69 with 2 sincosf each, and 6
# dequantized fields of 2; a reverse step: 3 placements of 68 with one
# sincosf, 3 bond angles of 31 and 3 torsions of 2 (chip_smoke.py:238-269)
FWD_STEP_OPS = 3 * 69 + 6 * 2 + 6 * SINCOS_OPS
REV_STEP_OPS = 3 * (68 + SINCOS_OPS + 31 + 2)
STEP_BYTES = 8            # the residue's record
BLEND_OPS_ROW = 3 * 12    # 9 backbone floats blended, 4 operations each
SC_PLACE_OPS = 66         # one side-chain atom placed by NeRF
OFFSET_OPS_RES = 42 * 5   # 42 int16 offsets from CA, 5 operations each
OUT_BYTES_RES = 42 * 2 + 3 * 4
LANE_BYTES = 125          # seed, is_first, next anchor, tat, 12 floats

PEAKS = json.loads((pathlib.Path(__file__).parent / "peaks.json")
                   .read_text())


def segments(n_residue: int, anchors) -> np.ndarray:
    """The residues of each anchor segment's lane, as the decode walks
    them: segment s from min(a_s, n-1) to min(a_{s+1} + 1, n - 1), the last
    to the protein's end (foldcomp.cpp:812-858)."""
    a = np.asarray(anchors, np.int64)
    n = int(n_residue)
    first = np.minimum(a[:-1], n - 1)
    last = np.minimum(a[1:] + 1, n - 1)
    last[-1] = n
    return np.maximum(last - first, 1)


def decode_work(blob: bytes) -> dict:
    """{"residues", "lanes", "rows", "steps", "bytes", "ops"} of the
    decode of one FCZ entry."""
    f = fcz.parse(blob)
    seg = segments(f.n_residue, f.anchor_indices)
    codes = fcz.unpack_records(f.records)[0].astype(np.int64)
    std = codes < 20
    placed = int((N_ATOMS[np.minimum(codes, 19)][std] - 3).sum())
    n, lanes, rows = int(f.n_residue), len(seg), int(seg.sum())
    steps = rows - lanes
    n_sc = len(f.sc_codes)
    return {
        "residues": n, "lanes": lanes, "rows": rows, "steps": steps,
        "bytes": STEP_BYTES * steps + n_sc + OUT_BYTES_RES * n
        + LANE_BYTES * lanes,
        "ops": (FWD_STEP_OPS + REV_STEP_OPS) * steps + BLEND_OPS_ROW * rows
        + SC_PLACE_OPS * placed + OFFSET_OPS_RES * n,
    }


def bound_s(n_bytes: float, n_ops: float, device_name: str):
    """(seconds, "bytes" or "operations"): the least time the card could
    take, at its published peaks; None for a card the table lacks."""
    p = PEAKS.get(device_name)
    if p is None:
        return None
    t_b = n_bytes / p["hbm_bytes_s"]
    t_f = n_ops / p["f32_flops_s"]
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")
