"""The tiny size the CPU tests run cells at, and one run of a cell there."""
from __future__ import annotations

import time

TINY = {"config": {"entries": 24, "unique_structures": 6,
                   "lengths": {"mean": 60, "median": 50, "max": 160,
                               "grid": 200}},
        "traffic": {"batch_entries": 8, "sample_every": 4,
                    "sample_max": 64},
        "limits": {"entries_checked_min": 6, "entries_sampled_min": 4}}


def run_tiny(workload, seed=12345678901, seconds=0.6, trace=False,
             control=False, root=None, overrides=None):
    """One run of a cell at the tiny size on the CPU; -> the result."""
    from portbench import harness
    over = harness.merged(TINY, overrides)
    rc, res = harness.run_cell(workload, seed, seconds, trace,
                               time.perf_counter(), device="cpu",
                               require_chip=False, root=root,
                               overrides=over, workers=0, control=control)
    assert rc == 0, rc
    return res
