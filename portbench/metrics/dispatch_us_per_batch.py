"""Wall microseconds of the port's decode.dispatch span a batch in the
traced window: codec/batch._seg_decode_arrays, the host's whole dispatch
of one batch (class_prep, lane_order, the allocations, the views and the
kernels' calls and launches)."""
from portbench import program_spans as ps


def read(run):
    d = ps.spans(ps.session(run), "decode.dispatch")
    return ps.wall_ns(d) / len(d) / 1e3 if d else None
