"""BENCHMARK.json: loading, validation, and what one cell needs.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that BENCHMARK.json gives:

- a configuration: the `file` of its entry (portbench/configs/<name>.json);
- a traffic mix: portbench/traffic/<traffic>.json, whose "driver" names
  the general driver portbench/drivers/<driver>.py that reads it;
- a metric, end-to-end or per-layer: portbench/metrics/<name>.py, a
  reader with `read(run) -> float | None`;
- a cell's limits for `correct`: portbench/limits/<workload>.json.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[1]

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_tok")


def load(path=None) -> dict:
    return json.loads(pathlib.Path(path or ROOT / "BENCHMARK.json")
                      .read_text())


def _line(s, what, errors):
    if not isinstance(s, str) or not 1 <= len(s) <= 200 or "\n" in s \
            or "\t" in s:
        errors.append(f"{what}: 1 to 200 characters on one line, no tab")


def validate(m: dict, root=None) -> list[str]:
    """The contract's static rules that a file alone can break; [] when
    the manifest keeps them."""
    root = pathlib.Path(root or ROOT)
    errors = []
    if set(m) != TOP_KEYS:
        errors.append(f"top-level keys {sorted(m)}")
        return errors
    cmd, paths = m["command"], m["paths"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        errors.append("command: a list of 1 to 32 strings")
    for w in cmd:
        _line(w, "command word", errors)
        if isinstance(w, str) and (w.startswith("/") or ".." in w):
            errors.append(f"command word {w!r} leaves the repo")
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        errors.append("paths: 1 to 16 directories")
    for p in paths:
        if not PATH_RE.match(p) or p.startswith("/") or ".." in p:
            errors.append(f"path {p!r}")
    rs = m["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        errors.append("run_seconds: a whole number from 1 to 51")
    names = []
    configs = {c.get("name"): c for c in m["configs"]}
    if not 1 <= len(m["configs"]) <= 24:
        errors.append("configs: 1 to 24")
    for c in m["configs"]:
        if set(c) != CONFIG_KEYS:
            errors.append(f"config {c.get('name')}: keys {sorted(c)}")
            continue
        names.append(("config", c["name"]))
        for k in ("source", "why"):
            _line(c[k], f"config {c['name']} {k}", errors)
        f = c["file"]
        if not any(f.startswith(p.rstrip("/") + "/") for p in paths):
            errors.append(f"config {c['name']}: file outside paths")
        if len(c["reduced"]) > 16:
            errors.append(f"config {c['name']}: more than 16 reduced keys")
        for k in c["reduced"]:
            if not NAME_RE.match(k):
                errors.append(f"config {c['name']}: reduced key {k!r}")
            low = k.lower()
            if low.endswith(("_dim", "_rank", "_size")) or \
                    any(wd in low for wd in WIDTH_WORDS):
                errors.append(f"config {c['name']}: {k!r} is a width")
    if len({c["file"] for c in m["configs"]}) != len(m["configs"]):
        errors.append("two configurations share a file")
    if not 1 <= len(m["workloads"]) <= 24:
        errors.append("workloads: 1 to 24")
    pairs = set()
    four = 0
    for w in m["workloads"]:
        if set(w) != WORKLOAD_KEYS:
            errors.append(f"workload {w.get('name')}: keys {sorted(w)}")
            continue
        names.append(("workload", w["name"]))
        _line(w["why"], f"workload {w['name']} why", errors)
        if w["config"] not in configs:
            errors.append(f"workload {w['name']}: no config {w['config']}")
        for k in ("config", "traffic"):
            if not NAME_RE.match(w[k]):
                errors.append(f"workload {w['name']}: {k} {w[k]!r}")
        if w["chips"] not in (1, 4):
            errors.append(f"workload {w['name']}: chips 1 or 4")
        four += w["chips"] == 4
        if (w["config"], w["traffic"]) in pairs:
            errors.append(f"workload {w['name']}: pair used twice")
        pairs.add((w["config"], w["traffic"]))
        if not (root / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file():
            errors.append(f"workload {w['name']}: no traffic file")
        if not (root / "portbench" / "limits"
                / f"{w['name']}.json").is_file():
            errors.append(f"workload {w['name']}: no limits file")
    if four > max(1, len(m["workloads"]) // 4):
        errors.append("too many four-chip cells")
    used = {w["config"] for w in m["workloads"]}
    for c in configs:
        if c not in used:
            errors.append(f"config {c} is used by no cell")
    wl = {w["name"] for w in m["workloads"]}
    e2e = {e["name"]: e for e in m["end_to_end"]}
    if not 1 <= len(m["end_to_end"]) <= 16:
        errors.append("end_to_end: 1 to 16")
    if "setup_s" not in e2e:
        errors.append("end_to_end: no setup_s")
    if not 1 <= len(m["per_layer"]) <= 128:
        errors.append("per_layer: 1 to 128")
    for kind, keys, items in (("end_to_end", E2E_KEYS, m["end_to_end"]),
                              ("per_layer", LAYER_KEYS, m["per_layer"])):
        for e in items:
            extra = set(e) - keys - {"workloads"}
            if extra or keys - set(e):
                errors.append(f"{kind} {e.get('name')}: keys {sorted(e)}")
                continue
            names.append(("metric", e["name"]))
            if not UNIT_RE.match(e["unit"]):
                errors.append(f"{kind} {e['name']}: unit {e['unit']!r}")
            if e["better"] not in ("lower", "higher"):
                errors.append(f"{kind} {e['name']}: better")
            ok = E2E_SOURCES if kind == "end_to_end" else SOURCES
            if e["source"] not in ok:
                errors.append(f"{kind} {e['name']}: source {e['source']}")
            for c in e.get("workloads", []):
                if c not in wl:
                    errors.append(f"{kind} {e['name']}: no workload {c}")
            if not (root / "portbench" / "metrics"
                    / f"{e['name']}.py").is_file():
                errors.append(f"{kind} {e['name']}: no reader file")
            if kind == "end_to_end":
                b = e["bound"]
                if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
                    errors.append(f"{e['name']}: bound {b}")
            else:
                _line(e["layer"], f"per_layer {e['name']} layer", errors)
                if e["moves"] not in e2e:
                    errors.append(f"per_layer {e['name']}: moves "
                                  f"{e['moves']}, not an end-to-end metric")
                    continue
                for c in cells_of(e, wl):
                    if c not in cells_of(e2e[e["moves"]], wl):
                        errors.append(f"per_layer {e['name']}: cell {c} "
                                      f"does not report {e['moves']}")
    for kind, n in names:
        if not isinstance(n, str) or not NAME_RE.match(n):
            errors.append(f"{kind} name {n!r}")
    for kind in ("config", "workload", "metric"):
        ns = [n for k, n in names if k == kind]
        if len(ns) != len(set(ns)):
            errors.append(f"two {kind}s share a name")
    for w in wl:
        ends = [e["name"] for e in m["end_to_end"]
                if w in cells_of(e, wl)]
        if "setup_s" not in ends or len(ends) < 2:
            errors.append(f"workload {w}: setup_s and one more end-to-end "
                          "metric")
        if not [e for e in m["per_layer"] if w in cells_of(e, wl)]:
            errors.append(f"workload {w}: no per-layer metric")
    if len(json.dumps(m)) > 64 * 1024:
        errors.append("larger than 64 KiB")
    return errors


def cells_of(metric: dict, all_cells) -> set:
    """The cells that report a metric: its `workloads`, else every cell."""
    return set(metric["workloads"]) if "workloads" in metric \
        else set(all_cells)


def cell(m: dict, workload: str, root=None) -> dict:
    """What one run of `workload` needs: the workload entry, its
    configuration (the file's JSON), its traffic (the file's JSON), its
    limits, and the names of its end-to-end and per-layer metrics, the
    files read under `root` (the checkout)."""
    root = pathlib.Path(root or ROOT)
    pkg = root / "portbench"
    wl = {w["name"]: w for w in m["workloads"]}
    if workload not in wl:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = wl[workload]
    conf = next(c for c in m["configs"] if c["name"] == w["config"])
    return {
        "workload": w,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((pkg / "traffic" / f"{w['traffic']}.json")
                              .read_text()),
        "limits": json.loads((pkg / "limits" / f"{workload}.json")
                             .read_text()),
        "end_to_end": [e["name"] for e in m["end_to_end"]
                       if workload in cells_of(e, wl)],
        "per_layer": [e["name"] for e in m["per_layer"]
                      if workload in cells_of(e, wl)],
        "units": {e["name"]: e["unit"]
                  for e in m["end_to_end"] + m["per_layer"]},
    }


def reader(name: str, root=None):
    """The `read` function of portbench/metrics/<name>.py under `root`
    (loaded by path: a metric's name may hold dots)."""
    path = pathlib.Path(root or ROOT) / "portbench" / "metrics" / \
        f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
