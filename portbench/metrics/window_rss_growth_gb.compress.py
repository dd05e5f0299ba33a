"""The compress cell's window_rss_growth_gb, beside its own peak: the
peak resident set (getrusage ru_maxrss) when the window closes less
VmRSS when it opens, in GB of 1e9 bytes; 0 where the peak came before
the window."""


def read(run):
    if run.rss_peak_bytes is None or run.rss_start_bytes is None:
        return None
    return max(0, run.rss_peak_bytes - run.rss_start_bytes) / 1e9
