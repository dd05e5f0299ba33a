"""BENCHMARK.json against the contract's static rules, and a cell and a
metric added as data alone."""
from __future__ import annotations

import copy
import json
import shutil

import pytest

from portbench import manifest

from .tiny import run_tiny


def test_benchmark_json_is_valid():
    assert manifest.validate(manifest.load()) == []


@pytest.mark.parametrize("breakage", [
    ("name", lambda m: m["workloads"][0].update(name="a cell")),
    ("name", lambda m: m["per_layer"][0].update(name="x/y")),
    ("unit", lambda m: m["end_to_end"][0].update(unit="res per s")),
    ("unit", lambda m: m["end_to_end"][0].update(unit="r" * 17)),
    ("moves", lambda m: m["per_layer"][0].update(moves="no_such")),
    ("moves", lambda m: m["per_layer"][3].update(moves="decode_res_s")),
    ("bound", lambda m: m["end_to_end"][0].update(bound=0.3)),
    ("extra key", lambda m: m["end_to_end"][0].update(why="x")),
    ("width", lambda m: m["configs"][0]["reduced"].append("hidden_size")),
    ("setup_s", lambda m: m["end_to_end"].pop()),
])
def test_validation_catches(breakage):
    _, change = breakage
    m = copy.deepcopy(manifest.load())
    change(m)
    assert manifest.validate(m)


def test_names_and_units_are_plain():
    m = manifest.load()
    for e in m["end_to_end"] + m["per_layer"]:
        assert manifest.UNIT_RE.match(e["unit"])
        assert manifest.NAME_RE.match(e["name"])
    for w in m["workloads"]:
        for k in ("name", "config", "traffic"):
            assert manifest.NAME_RE.match(w[k])


def test_every_moves_is_reported_where_its_metric_is():
    m = manifest.load()
    wl = [w["name"] for w in m["workloads"]]
    e2e = {e["name"]: e for e in m["end_to_end"]}
    for e in m["per_layer"]:
        assert manifest.cells_of(e, wl) <= manifest.cells_of(
            e2e[e["moves"]], wl)


def test_a_cell_and_a_metric_added_as_data(tmp_path):
    """A new traffic mix (sorted batches of the resident decode), its
    cell, its limits and a new per-layer metric, added as files and
    entries only, run through the unchanged harness."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = manifest.load()
    (root / "portbench" / "traffic" / "decode_small_batches.json").write_text(
        json.dumps({"driver": "resident_decode", "batch_entries": 4}))
    (root / "portbench" / "limits" / "swissprot.decode_small.json"
     ).write_text(json.dumps({"max_dev_A": 0.1}))
    (root / "portbench" / "metrics" / "batches_a_second.py").write_text(
        "def read(run):\n"
        "    return run.counters['batches'] / run.window_s\n")
    m["workloads"].append({
        "name": "swissprot.decode_small", "config": "afdb_swissprot_v4",
        "traffic": "decode_small_batches", "chips": 1,
        "why": "small batches: the launch floor"})
    for e in m["end_to_end"]:
        if e["name"] == "decode_res_s":
            e["workloads"].append("swissprot.decode_small")
    m["per_layer"].append({
        "name": "batches_a_second", "unit": "1/s", "better": "higher",
        "source": "program_counter", "layer": "kernels",
        "moves": "decode_res_s", "workloads": ["swissprot.decode_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    assert manifest.validate(m, root) == []
    res = run_tiny("swissprot.decode_small", root=str(root), trace=True,
                   seconds=0.3)
    assert res["correct"]
    assert res["metrics"]["batches_a_second"]["value"] > 0
