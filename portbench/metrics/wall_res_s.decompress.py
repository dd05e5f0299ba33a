"""Residues a second on the host's clock, counted to the last completed
entry (the traced run's: the profiler's cost is in it). Recorded beside
the host's CPU cost, which gates."""


def read(run):
    return run.residues / run.window_s if run.window_s else None
