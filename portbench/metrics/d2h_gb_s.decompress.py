"""The stream's device-to-host rate, GB/s: the port's d2h_bytes counter
over the seconds of its stream.d2h spans (the .cpu() copies of
codec/batch._outs_to_host on the transfer thread, after the device wait
spanned apart as stream.device_wait)."""
from portbench import program_spans as ps


def read(run):
    s = ps.session(run)
    w = ps.wall_ns(ps.spans(s, "stream.d2h"))
    b = s.counters.get("d2h_bytes") if s is not None else None
    return b / w if w and b else None
