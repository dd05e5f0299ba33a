"""The host's glue a batch, in microseconds: the port's decode.dispatch
spans less their decode.k1, decode.k2 and decode.k3 children (the
kernels' wrapper calls), over the dispatches of the traced window. What
is left is class_prep, lane_order, the allocations and the views."""
from portbench import program_spans as ps


def read(run):
    s = ps.session(run)
    d = ps.spans(s, "decode.dispatch")
    if not d:
        return None
    ids = {x.id for x in d}
    kids = [x for x in ps.spans(s, "decode.k1", "decode.k2", "decode.k3")
            if x.parent in ids]
    glue = ps.wall_ns(d) - ps.wall_ns(kids)
    return glue / len(d) / 1e3 if glue > 0 else None
