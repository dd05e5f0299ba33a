"""The share of the traced window in which no kernel and no copy ran on
the card (profiler, intervals merged), in the host-paced cells."""


def read(run):
    t = run.trace
    if t is None or not t.get("window_s") or not t.get("events"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
