"""The port's own spans and counters, as the per-layer metrics of a
traced run read them: the session that foldcomp_tpu_torch.tracing
recorded while the window's profiler ran (the port records exactly while
a torch profiler session is active). The readers use the session's
`spans` (name, id, parent, start_ns, end_ns, cpu_ns) and `counters`.

`session(run)` is None where the port has no recorder, where nothing was
recorded, and where the session is longer than the window (stale, or
mixed with another stretch of recording), so that a reader finds nothing
rather than a wrong number.
"""
from __future__ import annotations


def session(run):
    try:
        from foldcomp_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.last()
    if s is None or not s.spans or not run.window_s:
        return None
    first = min(x.start_ns for x in s.spans)
    last = max(x.end_ns for x in s.spans)
    if (last - first) * 1e-9 > run.window_s:
        return None
    return s


def spans(s, *names) -> list:
    """The spans of these names, [] where there is no session."""
    if s is None:
        return []
    return [x for x in s.spans if x.name in names]


def wall_ns(sp) -> int:
    return sum(x.end_ns - x.start_ns for x in sp)


def cpu_ns(sp) -> int | None:
    """Thread CPU of the spans that carry it; None where none does."""
    c = [x.cpu_ns for x in sp if x.cpu_ns is not None]
    return sum(c) if c else None


def window_share(run, *names) -> float | None:
    """Percent of the window spent in the spans of these names."""
    sp = spans(session(run), *names)
    w = wall_ns(sp)
    return 100.0 * w * 1e-9 / run.window_s if w else None


def cpu_s_per_mres(run, name, counter) -> float | None:
    """Thread CPU seconds of the spans `name` over the counter `counter`
    of residues, a million residues."""
    s = session(run)
    c = cpu_ns(spans(s, name))
    res = s.counters.get(counter) if s is not None else None
    if not c or not res:
        return None
    return c * 1e-9 / (res / 1e6)
