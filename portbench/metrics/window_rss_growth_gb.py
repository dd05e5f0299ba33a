"""What the job's own buffers add to the process's resident set: its
peak (getrusage ru_maxrss) when the window closes less its resident set
(VmRSS) when the window opens, in GB of 1e9 bytes; 0 where the peak came
before the window."""


def read(run):
    if run.rss_peak_bytes is None or run.rss_start_bytes is None:
        return None
    return max(0, run.rss_peak_bytes - run.rss_start_bytes) / 1e9
