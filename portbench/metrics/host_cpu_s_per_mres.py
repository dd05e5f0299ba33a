"""Host CPU seconds a million residues: getrusage user + system seconds
of the process and its waited-for children over the window, from its
start to the last completed entry, over the residues of every completed
entry (host clock)."""


def read(run):
    if run.cpu_s is None or not run.residues:
        return None
    return run.cpu_s / (run.residues / 1e6)
