"""The backbone-only resident cell (esm30.backbone_resident) at the tiny
size on the CPU: the faults its check has to catch, its control, what its
traced run reports, and the manifest with it. The fault runs hold each
batch 3 times, not the traffic's 56, so that a run decodes ~10 batches a
pass, not ~170; the cell's own tiny runs are test_portbench_cells'."""
from __future__ import annotations

import pytest

from portbench import manifest
from portbench.drivers import resident_backbone

from .tiny import run_tiny

CELL = "esm30.backbone_resident"
FEW = {"traffic": {"replicas": 3}}


def _bb_fault(kind):
    """A broken _seg_decode_arrays on the bb wire: "unchanged" hands back
    output that was never written; "half" leaves the second half of the
    lanes out; "altered" moves every CA by 5 A (past what an int16 bb
    offset of 0.1 mA units can carry, so N and C move with it)."""
    import torch

    from foldcomp_tpu_torch.codec import batch
    real = batch._seg_decode_arrays

    def broken(arrays, refine_iters=2):
        tag, off, ca = real(arrays, refine_iters)
        if kind == "unchanged":
            return tag, torch.zeros_like(off), torch.zeros_like(ca)
        if kind == "half":               # lanes first, then pad lanes
            n = int((arrays["seg_m"] > 1).sum())
            off[n // 2:n] = 0
            ca[n // 2:n] = 0
        else:
            ca[..., 0] += 5.0
        return tag, off, ca
    return broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_backbone_fault_is_caught(monkeypatch, kind):
    from foldcomp_tpu_torch.codec import batch
    monkeypatch.setattr(batch, "_seg_decode_arrays", _bb_fault(kind))
    res = run_tiny(CELL, seed=4242, seconds=0.3, overrides=FEW)
    assert not res["correct"], res["checks"]
    assert res["checks"]["max_dev_bb_A"]["value"] > 0.5, res["checks"]


def test_backbone_later_call_fault_is_caught(monkeypatch):
    """A _seg_decode_arrays right on every call in set-up and on each held
    batch's first call in the window, and wrong (the "altered" fault) on
    every later one: a fault a check of first outputs alone misses."""
    from foldcomp_tpu_torch.codec import batch
    real = batch._seg_decode_arrays
    real_window = resident_backbone.window
    seen = {"window": False}
    calls = {}

    def window(ctx, state, seconds):
        seen["window"] = True
        return real_window(ctx, state, seconds)

    def broken(arrays, refine_iters=2):
        out = real(arrays, refine_iters)
        if seen["window"]:
            n = calls[id(arrays)] = calls.get(id(arrays), 0) + 1
            if n > 1:
                out[2][..., 0] += 5.0
        return out
    monkeypatch.setattr(resident_backbone, "window", window)
    monkeypatch.setattr(batch, "_seg_decode_arrays", broken)
    res = run_tiny(CELL, seed=4444, seconds=0.3, overrides=FEW)
    assert not res["correct"], res["checks"]
    assert res["checks"]["max_dev_bb_A"]["value"] > 4.0, res["checks"]
    assert res["checks"]["entries_unread"]["value"] == 0


def test_backbone_control_is_not_correct():
    res = run_tiny(CELL, seed=98765432109, seconds=0.3, control=True,
                   overrides=FEW)
    assert not res["correct"], res["checks"]
    assert res["checks"]["max_dev_bb_A"]["value"] > \
        res["checks"]["max_dev_bb_A"]["limit"]


def test_backbone_traced_run_reports_counter_metrics(monkeypatch):
    """On the CPU there is no device trace and no span session: the
    counter metrics are reported, the trace's and spans' left out. The
    held bytes are those of arrays_to_torch's dicts: a bb dict that held
    the side-chain codes, as it did before they were dropped from it,
    reads more."""
    res = run_tiny(CELL, trace=True, seconds=0.3, overrides=FEW)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"padded_slots_per_res",
                                   "held_bytes_per_res"}, res["metrics"]
    lean = res["metrics"]["held_bytes_per_res"]["value"]
    import torch

    from foldcomp_tpu_torch.codec import batch
    real = batch.arrays_to_torch

    def with_sc(arrays, device):
        out = real(arrays, device)
        out["sc_codes_seg"] = torch.from_numpy(arrays["sc_codes_seg"])
        return out
    monkeypatch.setattr(batch, "arrays_to_torch", with_sc)
    res = run_tiny(CELL, trace=True, seconds=0.3, overrides=FEW)
    assert res["correct"], res["checks"]
    assert res["metrics"]["held_bytes_per_res"]["value"] > lean > 0


def test_manifest_with_the_backbone_cell_is_valid():
    m = manifest.load()
    assert manifest.validate(m) == []
    c = manifest.cell(m, CELL)
    assert c["traffic"]["driver"] == "resident_backbone"
    assert c["end_to_end"] == ["decode_res_s", "setup_s"]
    assert "decode_roofline_pct" not in c["per_layer"]
    assert {"decode_bb_roofline_pct", "held_bytes_per_res"} <= \
        set(c["per_layer"])
    assert set(c["limits"]) == {"max_dev_bb_A", "entries_checked_min"}
    assert c["limits"]["max_dev_bb_A"] < 0.5
    assert all(w["chips"] == 1 for w in m["workloads"])
