"""Percent of the window the CLI's thread waited on the finisher: the
port's compress.wait_finish spans (fut.result() of cli._run_compress_fast's
finish_oldest, while the finisher thread waits for the device, copies and
finishes the batch)."""
from portbench import program_spans as ps


def read(run):
    return ps.window_share(run, "compress.wait_finish")
