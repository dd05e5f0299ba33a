"""Residues decoded a second: the residues of every batch the window
enqueued over the time from the window's start to the synchronize after
the last one (host clock)."""


def read(run):
    return run.residues / run.window_s if run.window_s else None
