"""The work a backbone-only decode must do, counted from its inputs: the
yardstick of `decode_bb_roofline_pct`.

As work.decode_work counts the full decode, whatever implements it, from
the FCZ bytes alone (the frozen parse): per anchor segment ("lane") a
forward and a reverse NeRF pass over the segment's backbone and the blend
of the 9 backbone floats of each row, each input byte read once (8 B a
step's record, 125 B of lane inputs) and each output byte written once:
the backbone-only wire's 24 B a residue (N and C as six int16 offsets
from a float32 CA). No side chain is placed and no offset of one is
written, so work.decode_work's side-chain and offset terms are left out.
"""
from __future__ import annotations

import numpy as np

from .reference import fcz
from .work import (BLEND_OPS_ROW, FWD_STEP_OPS, LANE_BYTES, REV_STEP_OPS,
                   STEP_BYTES, bound_s, segments)

OUT_BYTES_RES = 6 * 2 + 3 * 4

__all__ = ["OUT_BYTES_RES", "bound_s", "decode_bb_work"]


def decode_bb_work(blob: bytes) -> dict:
    """{"residues", "lanes", "rows", "steps", "bytes", "ops"} of the
    backbone-only decode of one FCZ entry."""
    f = fcz.parse(blob)
    seg = segments(f.n_residue, f.anchor_indices)
    n, lanes, rows = int(f.n_residue), len(seg), int(np.sum(seg))
    steps = rows - lanes
    return {
        "residues": n, "lanes": lanes, "rows": rows, "steps": steps,
        "bytes": STEP_BYTES * steps + LANE_BYTES * lanes
        + OUT_BYTES_RES * n,
        "ops": (FWD_STEP_OPS + REV_STEP_OPS) * steps + BLEND_OPS_ROW * rows,
    }
