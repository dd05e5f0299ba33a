"""Thread CPU seconds of the PDB parse a million residues: the port's
compress.parse spans (each encode_pdb_device call of
cli._run_compress_fast) over its parse_residues counter."""
from portbench import program_spans as ps


def read(run):
    return ps.cpu_s_per_mres(run, "compress.parse", "parse_residues")
