"""The share of the window the CLI's thread spent inside the port's PDB
parse, codec/batch_host.encode_pdb_device (the benchmark's span around
each call of the module-level function, traced run only)."""


def read(run):
    s = run.spans.get("parse")
    return 100.0 * s / run.window_s if s is not None and run.window_s \
        else None
