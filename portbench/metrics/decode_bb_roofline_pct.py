"""The backbone-only decode's share of its roofline: the least time the
card could take for the backbone decode work of every batch in the traced
window (counted from the FCZ inputs, portbench/work_bb.py, at the card's
published peaks) over the time any kernel ran on the card in that window
(profiler). The window runs nothing but the decode, so every kernel in it
is the decode's; none is left out by its name."""
from portbench import work_bb


def read(run):
    t = run.trace
    c = run.counters
    if t is None or not t.get("kernel_busy_s") or "work_bytes_bb" not in c:
        return None
    b = work_bb.bound_s(c["work_bytes_bb"], c["work_ops_bb"],
                        run.device_name)
    if b is None:
        return None
    return 100.0 * b[0] / t["kernel_busy_s"]
