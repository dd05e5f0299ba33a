"""Each traffic mix at a tiny size through the harness on the CPU, its
control, and the faults the check has to catch."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import manifest

from .tiny import run_tiny

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(workload):
    res = run_tiny(workload)
    c = manifest.cell(manifest.load(), workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == set(c["end_to_end"])
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference in bfloat16 in the program's place fails a number."""
    res = run_tiny(workload, seed=99, seconds=0.3, control=True)
    assert not res["correct"], res["checks"]


def _zeros_like_outputs(outs):
    import torch
    if isinstance(outs[0], str):
        return (outs[0],) + tuple(torch.zeros_like(t) for t in outs[1:])
    return tuple(torch.zeros_like(t) for t in outs)


def _decode_fault(kind):
    """A broken _seg_decode_arrays: "unchanged" skips the work and hands
    back output that was never written; "half" decodes, then leaves the
    second half of the rows out; "altered" moves one atom of each row by
    5 A, past every cell's limit."""
    from foldcomp_tpu_torch.codec import batch
    real = batch._seg_decode_arrays

    def broken(arrays, refine_iters=2):
        outs = real(arrays, refine_iters)
        if kind == "unchanged":
            return _zeros_like_outputs(outs)
        off = outs[-2]
        if kind == "half":
            if "classes" in arrays:      # flat rows, every one real
                off[off.shape[0] // 2:] = 0
            else:                        # lanes first, then pad lanes
                n_real = int((arrays["seg_m"] > 1).sum())
                off[n_real // 2:n_real] = 0
        else:
            off.reshape(-1, off.shape[-1])[:, 5] += 5000   # 5 A, one atom
        return outs
    return broken


DECODE_CELLS = ["swissprot.decode_resident", "human.decode_resident",
                "swissprot.decompress_fast"]


@pytest.mark.parametrize("workload", DECODE_CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_decode_fault_is_caught(monkeypatch, workload, kind):
    from foldcomp_tpu_torch.codec import batch
    monkeypatch.setattr(batch, "_seg_decode_arrays", _decode_fault(kind))
    res = run_tiny(workload, seed=4242, seconds=0.3)
    assert not res["correct"], res["checks"]


def _later_fault():
    """A _seg_decode_arrays right on each batch's calls in set-up and on
    its first call in the window, and wrong on every later call (the
    "altered" fault): a fault a check of the first output alone misses."""
    from foldcomp_tpu_torch.codec import batch
    from portbench.drivers.resident_decode import WARM_CALLS
    real = batch._seg_decode_arrays
    calls = {}

    def broken(arrays, refine_iters=2):
        outs = real(arrays, refine_iters)
        n = calls[id(arrays)] = calls.get(id(arrays), 0) + 1
        if n > WARM_CALLS + 1:
            off = outs[-2]
            off.reshape(-1, off.shape[-1])[:, 5] += 5000
        return outs
    return broken


@pytest.mark.parametrize("workload", [c for c in DECODE_CELLS
                                      if c.endswith(".decode_resident")])
def test_later_call_fault_is_caught(monkeypatch, workload):
    from foldcomp_tpu_torch.codec import batch
    monkeypatch.setattr(batch, "_seg_decode_arrays", _later_fault())
    res = run_tiny(workload, seed=4444, seconds=0.3)
    assert not res["correct"], res["checks"]
    assert res["checks"]["max_dev_A"]["value"] > 4.0, res["checks"]


def _encode_fault(kind):
    """A broken encode_finish: "unchanged" returns the device's parts
    untouched as zeros; "half" leaves the second half of the batch out;
    "altered" changes one record byte of each entry."""
    from foldcomp_tpu_torch.codec import batch
    real = batch.encode_finish

    def broken(handle):
        if kind == "unchanged" and handle["live"]:
            handle["parts"] = {k: v.zero_() for k, v in
                               handle["parts"].items()}
        out = real(handle)
        if kind == "half":
            out = out[:len(out) // 2] + [None] * (len(out) - len(out) // 2)
        elif kind == "altered":
            for f in out:
                if f is not None:
                    f.records = np.array(f.records, copy=True)
                    f.records.reshape(-1)[0] ^= 1
        return out
    return broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_encode_fault_is_caught(monkeypatch, kind):
    from foldcomp_tpu_torch.codec import batch
    monkeypatch.setattr(batch, "encode_finish", _encode_fault(kind))
    res = run_tiny("human.compress_fast", seed=4343, seconds=0.3)
    assert not res["correct"], res["checks"]


def test_traced_run_reports_per_layer_metrics():
    """On the CPU there is no device trace: the span and counter metrics
    are reported, the trace's are left out, never read as 0."""
    for wl, want in (("swissprot.decode_resident",
                      {"padded_slots_per_res"}),
                     ("swissprot.decompress_fast",
                      {"wall_res_s.decompress", "format_share.decompress",
                       "host_cpu_s_per_mres", "window_rss_growth_gb"}),
                     ("human.compress_fast",
                      {"wall_res_s.compress", "parse_share.compress",
                       "host_cpu_s_per_mres",
                       "window_rss_growth_gb.compress"})):
        res = run_tiny(wl, trace=True, seconds=0.4)
        assert res["correct"]
        assert set(res["metrics"]) == want, res["metrics"]
        assert all(v["value"] > 0 for k, v in res["metrics"].items()
                   if not k.startswith("window_rss_growth_gb"))
