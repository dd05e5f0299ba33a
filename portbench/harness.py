"""One run of one cell: set-up, the measured window, the check, the
metrics, the result line.

The flow is the same for every cell; what differs lives in the files the
cell names (manifest.py). The traffic's driver (portbench/drivers/) does
the cell's own part through four functions:

- `setup(ctx)`: builds the program's state from the inputs and warms up
  every shape the window will use;
- `window(ctx, state, seconds)`: drives the port until `seconds` have
  passed and the last piece of work has completed; returns
  {"residues", "entries", "t_end", "counters"};
- `release(ctx, state)`: frees the program's inputs, keeps its outputs;
- `check(ctx, state, ex, control=False)`: the numbers that decide
  `correct`, each {"value", "limit", "op"} with op "le", "ge" or "eq",
  worked out by the reference (ex: its worker processes); with
  control=True the reference in bfloat16 stands in the program's place.
"""
from __future__ import annotations

import importlib
import json
import os
import resource
import sys
import time
from types import SimpleNamespace

from . import data, manifest
from .trace import DeviceTrace, Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "foldcomp_tpu")


class Readings:
    """What one run measured and counted: the metric readers' input."""

    def __init__(self):
        self.setup_s = None
        self.window_s = None
        self.residues = 0
        self.entries = 0
        self.cpu_s = None
        self.rss_peak_bytes = None
        self.rss_start_bytes = None
        self.device_name = None
        self.trace = None          # DeviceTrace.summary() in traced runs
        self.spans = {}            # host span seconds by name
        self.counters = {}         # the driver's counts


class SerialExecutor:
    """ProcessPoolExecutor's submit/map/shutdown, run in this process
    (tests at tiny sizes)."""

    class _Done:
        def __init__(self, v):
            self._v = v

        def result(self):
            return self._v

    def submit(self, fn, *a, **k):
        return self._Done(fn(*a, **k))

    def map(self, fn, *its):
        return [fn(*a) for a in zip(*its)]

    def shutdown(self, wait=True, cancel_futures=False):
        pass


def log(*parts):
    print("portbench:", *parts, file=sys.stderr, flush=True)


def cpu_seconds() -> float:
    """User + system seconds of this process and its waited-for children."""
    s = resource.getrusage(resource.RUSAGE_SELF)
    c = resource.getrusage(resource.RUSAGE_CHILDREN)
    return s.ru_utime + s.ru_stime + c.ru_utime + c.ru_stime


def rss_peak_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def rss_now_bytes() -> int | None:
    """VmRSS of this process (/proc/self/status), None where there is
    none."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port may not load,
    compared as whole names (foldcomp_tpu_torch is not foldcomp_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def smi() -> str | None:
    """nvidia-smi's clocks, power, limit and temperature of the cards."""
    import subprocess
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return r.stdout.strip() if r.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        return None


def merged(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_proc0: float, device=None, require_chip: bool = True,
             root=None, overrides=None, workers=None, control=False):
    """One run of `workload`. Returns (exit code, result dict or None).
    `device`, `require_chip=False`, `overrides` ({"config": ...,
    "traffic": ..., "limits": ...}) and `workers=0` (the reference in
    this process) are for the tests at tiny sizes on the CPU; `root` is
    the checkout whose BENCHMARK.json and data files are read;
    `control=True` reports the control's numbers in the check's
    place."""
    m = manifest.load(None if root is None else
                      os.path.join(root, "BENCHMARK.json"))
    c = manifest.cell(m, workload, root)
    cfg = merged(c["config"], (overrides or {}).get("config"))
    traffic = merged(c["traffic"], (overrides or {}).get("traffic"))
    chips = c["workload"]["chips"]
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    n_entries, n_unique = driver.sizes(cfg, traffic)
    lengths, mult = data.pool_plan(cfg, n_entries, n_unique)
    ex = data.process_pool(workers) if workers != 0 else SerialExecutor()
    futs = data.submit_pool(ex, lengths, seed, driver.INPUT_KIND)
    stages = {}
    ctx = SimpleNamespace(config=cfg, traffic=traffic, seed=seed,
                          lengths=lengths, mult=mult, spans=Spans(),
                          limits=merged(c["limits"],
                                        (overrides or {}).get("limits")),
                          traced=trace, log=log, stages=stages)
    # what set-up runs beside the inputs and the torch import (the probe)
    pre = driver.before_inputs(ctx) if hasattr(driver, "before_inputs") \
        else None

    def stage(name, t):
        stages[name] = round(time.perf_counter() - t, 4)
        return time.perf_counter()

    t = time.perf_counter()
    import torch
    t = stage("torch_import_s", t)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if require_chip and have < chips:
        log(f"{have} CUDA devices; the cell needs {chips}: no result")
        ex.shutdown(wait=True, cancel_futures=True)
        if pre is not None:
            pre.join()
        return 3, None
    from foldcomp_tpu_torch import backend
    from foldcomp_tpu_torch.backend import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        from foldcomp_tpu_torch.kernels import build
        build.load(dev)
        dev_name = torch.cuda.get_device_name(dev)
    else:
        dev_name = "cpu"
    t = stage("port_load_s", t)
    log("toolchain", json.dumps(backend.describe()))
    ctx.device, ctx.torch = dev, torch
    ctx.blobs = [f.result() for f in futs]
    ex.shutdown(wait=True)
    t = stage("inputs_s", t)
    if pre is not None:
        pre.join()
        t = stage("probe_wait_s", t)
    state = driver.setup(ctx)
    t = stage("driver_setup_s", t)
    tracer = None
    if trace and dev.type == "cuda":
        tracer = DeviceTrace(torch)
        tracer.warm(dev)
        t = stage("profiler_warm_s", t)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    log("setup", json.dumps(stages), "sizes", json.dumps({
        "entries": n_entries, "unique": n_unique,
        "residues_held": int((lengths * mult).sum()),
        "lengths_min_median_max": [int(lengths.min()),
                                   int(sorted(lengths)[len(lengths) // 2]),
                                   int(lengths.max())]}))
    smi_before = smi() if dev.type == "cuda" else None
    r = Readings()
    r.device_name = dev_name
    t_win = time.perf_counter()
    r.setup_s = t_win - t_proc0
    r.rss_start_bytes = rss_now_bytes()
    if tracer is not None:
        tracer.start()
    t0_ns = time.time_ns()
    t0 = time.perf_counter()
    cpu0 = cpu_seconds()
    out = driver.window(ctx, state, seconds)
    t1 = out.get("t_end") or time.perf_counter()
    cpu1 = cpu_seconds()
    t1_ns = t0_ns + int((t1 - t0) * 1e9)
    if tracer is not None:
        tracer.stop()
    r.window_s = t1 - t0
    r.cpu_s = cpu1 - cpu0
    r.rss_peak_bytes = rss_peak_bytes()
    r.residues = out["residues"]
    r.entries = out["entries"]
    r.counters = out.get("counters", {})
    r.spans = dict(ctx.spans.total)
    mem_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    log("window", json.dumps({
        "window_s": r.window_s, "residues": r.residues,
        "entries": r.entries, "cpu_s": r.cpu_s,
        "rss_peak_bytes": r.rss_peak_bytes, "spans": r.spans,
        "counters": r.counters, "memory_peak_bytes": mem_peak}))
    log("nvidia-smi before", smi_before, "after",
        smi() if dev.type == "cuda" else None)
    if tracer is not None:
        t_tr = time.perf_counter()
        r.trace = tracer.summary(t0_ns, t1_ns, ctx.spans)
        log("trace", json.dumps({k: v for k, v in r.trace.items()
                                 if k not in ("device_ops", "idle_gaps")}),
            f"read in {time.perf_counter() - t_tr:.2f} s")
    bad = forbidden_modules()
    if bad:
        log("the run loaded", ", ".join(bad), "- no result")
        return 4, None
    driver.release(ctx, state)
    t_chk = time.perf_counter()
    ex = data.process_pool(workers) if workers != 0 else SerialExecutor()
    try:
        checks = driver.check(ctx, state, ex, control=control)
    finally:
        ex.shutdown(wait=True)
    log(f"check took {time.perf_counter() - t_chk:.2f} s")
    failed = [n for n, v in checks.items() if not passes(v)]
    metrics = {}
    names = c["per_layer"] if trace else c["end_to_end"]
    for name in names:
        v = manifest.reader(name, root)(r)
        if v is not None:
            metrics[name] = {"value": v, "unit": c["units"][name]}
    result = {
        "correct": not failed,
        "attempted": int(out.get("attempted", r.entries)),
        "failed": int(out.get("failed", 0)) + sum(
            int(v.get("entries_failed", 0)) for v in checks.values()),
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": dev_name, "count": chips if dev.type == "cuda"
                   else 0, "memory_peak_bytes": int(mem_peak)},
    }
    if r.trace is not None:
        result["device"].update(busy_s=r.trace["busy_s"],
                                window_s=r.trace["window_s"])
        result["breakdown"] = {"device_ops": r.trace["device_ops"],
                               "idle_gaps": r.trace["idle_gaps"]}
    result["checks"] = {n: {"value": v["value"], "limit": v["limit"]}
                        for n, v in checks.items()}
    for n, v in checks.items():
        print(f"check {n} {v['value']!r} {v['op']} {v['limit']!r} "
              f"{'ok' if passes(v) else 'FAILED'}", file=sys.stderr)
    return 0, result


def passes(v: dict) -> bool:
    x, lim = v["value"], v["limit"]
    if x is None:
        return False
    return {"eq": x == lim, "le": x <= lim, "ge": x >= lim}[v["op"]]

