"""Residue slots the program's packs pad to, a real residue, over the
window's batches: counted from the arrays of the port's
pack_decode_wire (width classes included), as the port's
bench.padded_slots counts them."""


def read(run):
    c = run.counters
    if "padded_slots" not in c or not c.get("residues"):
        return None
    return c["padded_slots"] / c["residues"]
