"""The port's spans and counters, on the clock of the device trace.

Recording is on while a torch profiler session is active
(`torch.autograd.profiler._is_profiler_enabled`, which
`torch.profiler.profile` sets for its window) and between `enable()` and
`disable()`. Off, `span()` returns one shared no-op context manager and
`count()` returns at once: no clock is read and nothing is allocated.

A span records its name, its own id, the id of the enclosing span on the
same thread (0 at the top), the thread (`threading.get_native_id()`, the
id the profiler gives threads), the batch's sequence number (passed
explicitly where work crosses threads; a span given none takes its
parent's), start and end, optional small attributes (`sp.set(...)`), and
the thread's CPU nanoseconds where the call site asks (`cpu=True`). Spans
are timed on `time.perf_counter_ns()` and reported in the epoch of
`time.time_ns()`, the clock torch.profiler gives its trace start in
(`kineto_results.trace_start_ns()`); one pair of readings, taken when a
session starts, maps the one onto the other. Each thread appends to a
buffer of its own, so the hot path takes no lock.

Counters are sums by name, kept at the same boundaries (`h2d_bytes`,
`d2h_bytes`, `parse_residues`, `format_residues`). The kernels' launch
counters stay where they are (`kernels/fused_decode.launch_counts`,
`kernels/fused_encode.launch_counts`); a session reports their deltas.
While a session records, a `gc.callbacks` hook records `python.gc`
spans.

Sessions: a session begins at the first record made after recording
turned on, and ends when port code next reaches a span with recording
off. `last()` returns the most recent session (open or closed), None
before any. `write_chrome(path)` writes it as trace-event JSON in the
timestamps torch.profiler's `export_chrome_trace` writes, so that both
files load together; `cli.main` calls it at exit when
FOLDCOMP_TPU_TORCH_TRACE names a file.

This module imports nothing of torch: torch-free worker processes import
the modules that hold spans.
"""
from __future__ import annotations

import gc
import itertools
import json
import os
import sys
import threading
import time
from typing import NamedTuple

_pc = time.perf_counter_ns
_tt = time.thread_time_ns

_on = False          # enable() .. disable()
_prof = None         # torch.autograd.profiler, once torch is loaded
_live = None         # the session records go to, or None
_last = None         # the most recent session
_lock = threading.Lock()
_tls = threading.local()
_ids = itertools.count(1)

_KERNEL_MODULES = tuple(__name__.rpartition(".")[0] + ".kernels." + m
                        for m in ("fused_decode", "fused_encode"))

# libkineto's ChromeTraceBaseTime: timestamps of a chrome trace are
# microseconds after the start of the current 7,889,238-second interval
# of the epoch, whose nanoseconds the file gives as baseTimeNanoseconds
_CHROME_BASE_S = 7889238


class Span(NamedTuple):
    """One finished span; times in the epoch of time.time_ns()."""
    name: str
    id: int
    parent: int
    thread: int
    batch: int | None
    start_ns: int
    end_ns: int
    cpu_ns: int | None
    attrs: dict | None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Session:
    """The spans, counters and launch counts of one stretch of
    recording."""

    def __init__(self, t0_ns, spans, counters, launches, threads, open_):
        self.t0_ns = t0_ns
        self.spans = spans            # [Span], by start
        self.counters = counters      # {name: sum}
        self.launches = launches      # kernel launches in the session
        self.threads = threads        # {thread id: thread name}
        self.open = open_

    def named(self, *names) -> list:
        return [s for s in self.spans if s.name in names]


class _Off:
    """The shared span of the off path: enters and exits, is false."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


_OFF = _Off()


class _Recorder:
    """A session while it records: the clock pair, the threads' buffers,
    the launch counts at its start."""

    def __init__(self):
        a = _pc()
        t = time.time_ns()
        b = _pc()
        self.pc0 = (a + b) // 2
        self.t0_ns = t
        self.bufs = []
        self.launches0 = _launch_counts()
        self.launches1 = None


class _Buf:
    __slots__ = ("rec", "tid", "name", "spans", "stack", "counters")

    def __init__(self, rec):
        self.rec = rec
        self.tid = threading.get_native_id()
        self.name = threading.current_thread().name
        self.spans = []
        self.stack = []
        self.counters = {}


class _Span:
    __slots__ = ("name", "batch", "cpu", "id", "parent", "t0", "c0", "attrs",
                 "buf")

    def __init__(self, name, batch, cpu):
        self.name = name
        self.batch = batch
        self.cpu = cpu
        self.attrs = None

    def __bool__(self):
        return True

    def set(self, **attrs):
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self):
        buf = _buffer()
        stack = buf.stack
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.batch is None:
                self.batch = top.batch
        else:
            self.parent = 0
        self.id = next(_ids)
        self.buf = buf
        stack.append(self)
        self.c0 = _tt() if self.cpu else 0
        self.t0 = _pc()
        return self

    def __exit__(self, *exc):
        t1 = _pc()
        cpu = _tt() - self.c0 if self.cpu else None
        buf = self.buf
        if buf.stack and buf.stack[-1] is self:
            buf.stack.pop()
        buf.spans.append((self.name, self.id, self.parent, self.batch,
                          self.t0, t1, cpu, self.attrs))
        return False


def _launch_counts() -> dict:
    out = {}
    for m in _KERNEL_MODULES:
        mod = sys.modules.get(m)
        if mod is not None:
            out.update(mod.launch_counts())
    return out


def _start() -> _Recorder:
    global _live, _last
    with _lock:
        if _live is None:
            _live = _last = _Recorder()
            gc.callbacks.append(_gc_hook)
        return _live


def _close() -> None:
    global _live
    with _lock:
        rec = _live
        if rec is None:
            return
        _live = None
        rec.launches1 = _launch_counts()
        try:
            gc.callbacks.remove(_gc_hook)
        except ValueError:
            pass


def _buffer() -> _Buf:
    """This thread's buffer in the live session, which the first record
    starts."""
    rec = _live
    if rec is None:
        rec = _start()
    buf = getattr(_tls, "buf", None)
    if buf is None or buf.rec is not rec:
        buf = _tls.buf = _Buf(rec)
        with _lock:
            rec.bufs.append(buf)
    return buf


def recording() -> bool:
    """True while spans and counts are recorded."""
    global _prof
    if _on:
        return True
    p = _prof
    if p is None:
        p = _prof = sys.modules.get("torch.autograd.profiler")
        if p is None:
            return False
    return p._is_profiler_enabled


def span(name: str, batch: int | None = None, cpu: bool = False):
    """A context manager that records a span while recording is on; the
    shared no-op (false) otherwise, which also ends an open session."""
    if _on or (_prof is not None and _prof._is_profiler_enabled):
        return _Span(name, batch, cpu)
    if _prof is None and recording():
        return _Span(name, batch, cpu)
    if _live is not None:
        _close()
    return _OFF


def count(name: str, n) -> None:
    """Add n to the counter `name` while recording is on."""
    if recording():
        c = _buffer().counters
        c[name] = c.get(name, 0) + n


def _gc_hook(phase, info):
    """gc.callbacks: a python.gc span a collection, on the thread that
    ran it, inside its innermost open span."""
    if _live is None or not recording():
        return
    if phase == "start":
        _tls.gc0 = _pc()
        return
    t0 = getattr(_tls, "gc0", None)
    if t0 is None:
        return
    _tls.gc0 = None
    t1 = _pc()
    buf = _buffer()
    top = buf.stack[-1] if buf.stack else None
    buf.spans.append(("python.gc", next(_ids), top.id if top else 0,
                      top.batch if top else None, t0, t1, None,
                      {"generation": info.get("generation"),
                       "collected": info.get("collected")}))


def enable() -> None:
    """Record from here until disable(), in a new session."""
    global _on
    _close()
    _on = True


def disable() -> None:
    global _on
    _on = False


def last() -> Session | None:
    """The most recent session, None if nothing was ever recorded. An
    open session is read as it stands; its launch counts run to now."""
    rec = _last
    if rec is None:
        return None
    with _lock:
        bufs = list(rec.bufs)
        launches1 = rec.launches1
        open_ = rec is _live
    if launches1 is None:
        launches1 = _launch_counts()
    off = rec.t0_ns - rec.pc0
    spans, counters, threads = [], {}, {}
    for b in bufs:
        threads[b.tid] = b.name
        for k, v in list(b.counters.items()):
            counters[k] = counters.get(k, 0) + v
        for (name, sid, parent, batch, t0, t1, cpu, attrs) in list(b.spans):
            spans.append(Span(name, sid, parent, b.tid, batch, t0 + off,
                              t1 + off, cpu, attrs))
    spans.sort(key=lambda s: (s.start_ns, s.id))
    launches = {k: v - rec.launches0.get(k, 0)
                for k, v in launches1.items()}
    return Session(rec.t0_ns, spans, counters, launches, threads, open_)


def write_chrome(path: str, session: Session | None = None) -> None:
    """Write `session` (default: last(); an empty trace where nothing was
    recorded) to `path` as trace-event JSON in the timestamps of
    torch.profiler's export_chrome_trace: microseconds after
    baseTimeNanoseconds, libkineto's base."""
    s = session if session is not None else last()
    if s is None:
        s = Session(time.time_ns(), [], {}, {}, {}, False)
    base = s.t0_ns // 10**9 // _CHROME_BASE_S * _CHROME_BASE_S * 10**9
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
               "args": {"name": name}} for tid, name in s.threads.items()]
    for sp in s.spans:
        args = {"id": sp.id, "parent": sp.parent}
        if sp.batch is not None:
            args["batch"] = sp.batch
        if sp.cpu_ns is not None:
            args["cpu_us"] = sp.cpu_ns / 1000
        args.update(sp.attrs or {})
        events.append({"ph": "X", "cat": "foldcomp_tpu_torch",
                       "name": sp.name, "pid": pid, "tid": sp.thread,
                       "ts": (sp.start_ns - base) / 1000,
                       "dur": (sp.end_ns - sp.start_ns) / 1000,
                       "args": args})
    with open(path, "w") as fh:
        json.dump({"schemaVersion": 1, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": base, "traceEvents": events,
                   "otherData": {"counters": s.counters,
                                 "launches": s.launches}}, fh)
