"""Percent of the window the stream's consuming thread waited: the port's
stream.wait_pack (on the packed queue and the pack's future) and
stream.wait_d2h (on the transfer's future) spans of
codec/batch.decode_fcz_stream."""
from portbench import program_spans as ps


def read(run):
    return ps.window_share(run, "stream.wait_pack", "stream.wait_d2h")
