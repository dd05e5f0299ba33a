"""The traced run's device timeline: torch.profiler over the window.

Only CUDA activity is recorded (no shapes, no stacks, no timeline kept):
the events are reduced in memory to the device's busy time, the kernels'
busy time, the sums by operation and the longest idle gaps, and then
dropped. The method, an untimed session first (it loads CUPTI) and the
device intervals merged, is the port's bench.busy_share
(foldcomp_tpu_torch/bench.py:857-904 at commit 5ba08cd7580a), kept here
so that later changes to the port leave the yardstick as it is. The benchmark's own host spans (`Spans`) label the gaps; they
are taken on time.time_ns(), the clock the profiler's trace start is
given in.
"""
from __future__ import annotations

import contextlib
import time

COPY_PREFIXES = ("Memcpy", "Memset")


class Spans:
    """Host spans the benchmark records around calls into the port, by
    name: total seconds and the intervals (time.time_ns())."""

    def __init__(self):
        self.total = {}
        self.intervals = []

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            self.total[name] = self.total.get(name, 0.0) + (t1 - t0) * 1e-9
            self.intervals.append((name, t0, t1))

    def wrap(self, name, fn):
        def wrapped(*a, **k):
            with self.span(name):
                return fn(*a, **k)
        return wrapped

    def wrap_gen(self, name, fn):
        """A generator function whose own running time (not its
        consumer's) is spanned, one interval a resumption."""
        def wrapped(*a, **k):
            it = fn(*a, **k)
            while True:
                with self.span(name):
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                yield item
        return wrapped


def _union(iv):
    total, end = 0, None
    merged = []
    for a, b in sorted(iv):
        if end is None or a > end:
            merged.append([a, b])
            end = b
        elif b > end:
            merged[-1][1] = b
            end = b
    for a, b in merged:
        total += b - a
    return total, merged


class DeviceTrace:
    """torch.profiler around the window. `warm()` belongs in set-up: the
    first session loads CUPTI, which takes seconds."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA])

    def warm(self, device):
        with self._profile():
            self.torch.ones(1, device=device).add_(1)
            self.torch.cuda.synchronize(device)

    def start(self):
        self.prof = self._profile()
        self.prof.__enter__()

    def stop(self):
        self.prof.__exit__(None, None, None)

    def summary(self, t0_ns: int, t1_ns: int, spans: Spans) -> dict:
        """busy_s (kernels and copies), kernel_busy_s, window_s, the ten
        operations with the most device time and the ten longest idle
        gaps, each named by the host span that covers its middle."""
        res = self.prof.profiler.kineto_results
        base = res.trace_start_ns() if hasattr(res, "trace_start_ns") \
            else res.trace_start_us() * 1000
        dev_type = self.torch.autograd.DeviceType.CUDA
        every, kernels, by_name = [], [], {}
        outside = 0
        for e in self.prof.events():
            if e.device_type != dev_type:
                continue
            a = base + int(e.time_range.start * 1000)
            b = base + int(e.time_range.end * 1000)
            if b <= t0_ns or a >= t1_ns:
                outside += 1
                continue
            a, b = max(a, t0_ns), min(b, t1_ns)
            every.append((a, b))
            if not e.name.startswith(COPY_PREFIXES):
                kernels.append((a, b))
            name = e.name.split("(")[0][:160]
            by_name[name] = by_name.get(name, 0) + (b - a)
        busy, merged = _union(every)
        kernel_busy, _ = _union(kernels)
        gaps = []
        prev = t0_ns
        for a, b in merged + [[t1_ns, t1_ns]]:
            if a > prev:
                gaps.append((a - prev, prev, a))
            prev = max(prev, b)
        gaps.sort(reverse=True)

        def label(a, b):
            mid = (a + b) // 2
            for name, s0, s1 in spans.intervals:
                if s0 <= mid < s1:
                    return name
            return "host"

        self.prof = None
        return {
            "busy_s": busy * 1e-9, "kernel_busy_s": kernel_busy * 1e-9,
            "window_s": (t1_ns - t0_ns) * 1e-9, "events": len(every),
            "events_outside": outside,
            "device_ops": [[n, v * 1e-9] for n, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[label(a, b), d * 1e-9] for d, a, b in gaps[:10]],
        }
