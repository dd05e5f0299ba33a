"""The compress cell's peak resident set, set-up and window (getrusage
ru_maxrss), in GB of 1e9 bytes, read when the window closes. Its own
metric: the peak hangs on the batches in flight and spreads wider than
the decompress cell's."""


def read(run):
    return run.rss_peak_bytes / 1e9 if run.rss_peak_bytes else None
