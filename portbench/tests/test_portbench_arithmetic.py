"""Rates and CPU cost counted to the last completion, and the roofline's
work count taken from the inputs alone."""
from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import data, harness, manifest, work

from .tiny import TINY, run_tiny


def _readings(**kw):
    r = harness.Readings()
    r.__dict__.update(kw)
    return r


def test_rate_and_cpu_cost_are_all_work_over_all_time():
    r = _readings(residues=3_000_000, window_s=12.5, cpu_s=45.0,
                  rss_peak_bytes=7_250_000_000, setup_s=21.0)
    assert manifest.reader("decode_res_s")(r) == 3_000_000 / 12.5
    assert manifest.reader("host_cpu_s_per_mres")(r) == 45.0 / 3.0
    assert manifest.reader("host_rss_peak_gb")(r) == 7.25
    assert manifest.reader("host_rss_peak_gb.compress")(r) == 7.25
    assert manifest.reader("wall_res_s.compress")(r) == 3_000_000 / 12.5


@pytest.mark.parametrize("workload,module,feed,rate", [
    ("human.compress_fast", "cli_compress", "_entries",
     "wall_res_s.compress"),
    ("swissprot.decompress_fast", "stream_decompress", "_payloads",
     "wall_res_s.decompress")])
def test_window_that_ends_mid_batch_counts_every_entry(
        monkeypatch, workload, module, feed, rate):
    """A window whose input stops inside a batch (150 entries, batches of
    128): every entry handed to the job completes and counts, the partial
    batch with the rest, and the rate is their residues over the time to
    the last completion."""
    import importlib
    mod = importlib.import_module(f"portbench.drivers.{module}")
    real = getattr(mod, feed)

    def capped(ctx, stream, deadline, n_max=None):
        return real(ctx, stream, float("inf"), 150 if n_max is None
                    else n_max)
    monkeypatch.setattr(mod, feed, capped)
    res = run_tiny(workload, seconds=1000.0, trace=True,
                   overrides={"traffic": {"sample_every": 1,
                                          "sample_max": 100000}})
    assert res["correct"], res["checks"]
    assert res["attempted"] == 150
    assert res["checks"]["entries_missing"]["value"] == 0
    assert res["metrics"][rate]["value"] > 0


def test_resident_rate_counts_every_enqueued_batch(monkeypatch):
    from portbench.drivers import resident_decode
    seen = {}
    real = resident_decode.window

    def spy(ctx, state, seconds):
        out = real(ctx, state, seconds)
        seen["out"] = out
        seen["res"] = state["res"]
        return out
    monkeypatch.setattr(resident_decode, "window", spy)
    res = run_tiny("swissprot.decode_resident", seconds=0.3, trace=True)
    out = seen["out"]
    assert out["counters"]["residues"] == out["residues"]
    assert out["counters"]["batches"] >= len(seen["res"])
    assert res["metrics"]["padded_slots_per_res"]["value"] > 1.0


def _fczs(seed=5):
    from portbench.reference.tasks import make_input
    lengths, _ = data.pool_plan(harness.merged(
        json.loads((manifest.ROOT / "portbench/configs/afdb_human_v4.json")
                   .read_text()), TINY["config"]), 24, 6)
    return [make_input(int(n), seed, u, "fcz")
            for u, n in enumerate(lengths)]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("wclass", ["0", "1"])
def test_work_count_from_inputs_matches_every_route(native, wclass):
    """The roofline's residue rows and lanes, counted from the FCZ bytes,
    are the real lanes and rows of the port's pack on every route: the
    native and the plain pack, one class or width classes."""
    from foldcomp_tpu_torch.codec import batch, batch_host
    from foldcomp_tpu_torch.codec import fcz as port_fcz
    blobs = _fczs()
    fczs = [port_fcz.parse(b) for b in blobs]
    arrays, metas = batch_host.pack_decode_batch_lanes(fczs, native=native)
    ws = [work.decode_work(b) for b in blobs]
    lanes = sum(w["lanes"] for w in ws)
    rows = sum(w["rows"] for w in ws)
    assert int(np.asarray(arrays["seg_m"])[:lanes].sum()) == rows
    assert sum(w["residues"] for w in ws) == sum(m.n_residue for m in metas)
    split, _ = batch.pack_decode_wire(fczs, bb_wire=False, wclass=wclass)
    if "classes" in split:
        assert sum(int(np.asarray(s).sum()) for s in
                   split["classes"]["segm"]) >= rows


def test_bound_is_at_the_published_peaks():
    name = "NVIDIA H100 80GB HBM3"
    t, kind = work.bound_s(3.35e12, 1.0, name)
    assert kind == "bytes" and t == pytest.approx(1.0)
    t, kind = work.bound_s(1.0, 67e12, name)
    assert kind == "operations" and t == pytest.approx(1.0)
    assert work.bound_s(1.0, 1.0, "some other card") is None


def test_lengths_are_the_same_for_every_seed():
    cfg = json.loads((manifest.ROOT / "portbench/configs/"
                      "afdb_swissprot_v4.json").read_text())
    lengths, mult = data.pool_plan(cfg, cfg["entries"],
                                   cfg["unique_structures"])
    assert mult.sum() == cfg["entries"]
    a = data.entry_order(mult, 1)
    b = data.entry_order(mult, 2 ** 31 + 11)
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert int((lengths * mult).sum()) == 23529984


def test_each_run_has_a_fresh_temporary_directory():
    """What the program keeps in the temporary directory (the link
    probe's answer) is never found by the next run."""
    import os
    import tempfile

    from portbench import run
    given = tempfile.gettempdir()
    with open(os.path.join(given, "kept_by_an_earlier_run.json"), "w"):
        pass
    path = run.fresh_tempdir()
    assert os.path.dirname(path) == given and os.listdir(path) == []
    assert tempfile.gettempdir() == path == os.environ["TMPDIR"]
