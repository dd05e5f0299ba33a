"""Bytes the program holds on the card for a residue of the resident
database: the summed nbytes of every tensor in the dicts of
codec/batch.arrays_to_torch for every held batch, over the residues those
batches hold (the counters `held_bytes` and `residues_held` of the
traffic's driver, counted in set-up, so that the window's length does not
move it)."""


def read(run):
    c = run.counters
    if not c.get("held_bytes") or not c.get("residues_held"):
        return None
    return c["held_bytes"] / c["residues_held"]
