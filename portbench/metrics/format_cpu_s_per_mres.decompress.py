"""Thread CPU seconds of the formatter a million residues: the port's
stream.format spans (one an entry, on the pool worker that formats it,
codec/batch_host._format_batch) over its format_residues counter."""
from portbench import program_spans as ps


def read(run):
    return ps.cpu_s_per_mres(run, "stream.format", "format_residues")
