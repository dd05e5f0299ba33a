"""The port's routing sweeps (foldcomp_tpu_torch/bench_routing.py) on the
CPU: the decisions each rule takes from a sweep's lines, the replay of
the decode stream's batches that sweep c reports lanes from, and one CLI
child's record. The sweeps' figures come from the card only."""
import json

import pytest
import torch

from test_property_roundtrip import synthesize

from foldcomp_tpu_torch import bench_routing as R
from foldcomp_tpu_torch.codec import batch as B
from foldcomp_tpu_torch.codec.encoder import encode
from foldcomp_tpu_torch.codec.fcz import serialize


def _s(*walls):
    return R.summary(list(walls))


def _fast_default(exact_t1, fast_cold, fast_warm, ratio=1.0):
    ns = (1024, 2048, 4096, 8192)
    modes = {"exact_t1": exact_t1, "fast_cold": fast_cold,
             "fast_warm": fast_warm, "exact_tT": [0.5] * 4,
             "fast_tT": fast_warm}
    return [{"sweep": "fast_default", "n_files": list(ns),
             "modes": {m: {str(n): _s(w) for n, w in zip(ns, ws)}
                       for m, ws in modes.items()}},
            {"sweep": "hybrid", "n": {str(n + 1): {"median_ratio": ratio,
                                                   "device_entries": [0]}
                                      for n in ns}}]


def _decide(*lines):
    return {r["constant"]: r for r in R.decide(json.loads(json.dumps(
        list(lines))))}


@pytest.mark.parametrize("case", ["crossover", "none", "probe_decides"])
def test_fast_default_rule(case):
    """FAST_DEFAULT_MIN is the smallest N at which --fast with a cold
    probe beats --exact -t 1, else 8192; the TTLs stay unless the probe
    alone decides an N; the no-flag db job at the value + 1 is held at
    0.97 of --exact -t T."""
    exact = [2.0, 4.0, 8.0, 16.0]
    cold = {"crossover": [14.0, 15.0, 7.0, 12.0],
            "none": [14.0, 15.0, 18.0, 25.0],
            "probe_decides": [14.0, 15.0, 18.0, 25.0]}[case]
    warm = [c - (11.0 if case == "probe_decides" else 6.0) for c in cold]
    rows = _decide(*_fast_default(exact, cold, warm, ratio=0.96))
    got = rows["FAST_DEFAULT_MIN"]
    assert got["value"] == {"crossover": 4096, "none": 8192,
                            "probe_decides": 8192}[case]
    assert got["hybrid_at_min_plus_1"]["held"] is False
    ttl = rows["_PROBE_TTL_S, _PROBE_NONE_TTL_S"]
    assert ttl["value"] == "kept"
    assert ttl["figures"]["probe_decides_at"] == \
        ([4096, 8192] if case == "probe_decides" else [])


def _batch(dec, com, rss, entries=4096):
    bs = (512, 1024, 2048, 4096, 8192)

    def fold(w, r):
        return dict(_s(*w), maxrss_bytes=r, device_peak_bytes=1e8,
                    d2h_s_median=0.05)
    return {"sweep": "batch", "entries": entries, "batches": list(bs),
            "decompress": {str(b): fold(w, r)
                           for b, w, r in zip(bs, dec, rss)},
            "compress": {str(b): fold(w, 6e9) for b, w in zip(bs, com)}}


@pytest.mark.parametrize("case", ["best", "rss", "compress_slower",
                                  "entries_8192"])
def test_fast_batch_rule(case):
    """FAST_BATCH: the best decompress --fast median under 8 GB of peak
    RSS whose compress --fast is no slower than at 2048 beyond the
    spread; a batch above the databases' entries is no candidate."""
    dec = [[10.0, 10.4], [9.0, 9.2], [9.5, 9.6], [9.8, 10.0], [8.0, 8.1]]
    com = [[30.0, 30.5], [30.0, 30.6], [30.0, 30.4], [29.0, 29.5],
           [29.0, 29.5]]
    rss = [6e9] * 5
    if case == "rss":
        rss[1] = 9e9
    if case == "compress_slower":
        com[1] = [40.0, 40.1]
    want = {"best": 1024, "rss": 2048, "compress_slower": 2048,
            "entries_8192": 8192}[case]
    line = _batch(dec, com, rss, 8192 if case == "entries_8192" else 4096)
    assert _decide(line)["FAST_BATCH"]["value"] == want


def _wclass(w0, w1, lanes):
    bs = (512, 1024, 2048, 4096, 8192)

    def fold(w):
        return dict(_s(*w), split_s=[[]], slots_per_res=1.5)
    return {"sweep": "wclass", "batches": list(bs),
            "modes": {m: {str(b): fold(w) for b, w in zip(bs, ws)}
                      for m, ws in (("0", w0), ("1", w1), ("auto", w0))},
            "lane_batches": {str(b): [[n, 0.2] for n in ls]
                             for b, ls in zip(bs, lanes)}}


def test_wclass_rule():
    """_WCLASS_MIN_LANES: no batch size faster split (WCLASS=1 below 0 by
    more than the spread) puts it above the largest batch measured
    (rounded up to 1024); where the larger batches are faster split, the
    least lane count above every batch of the others."""
    lanes = [[10_000] * 8, [20_000] * 4, [41_000, 40_000], [81_000],
             [81_000]]
    w0 = [[10.0]] * 5
    slow = _wclass(w0, [[11.0]] * 5, lanes)
    batch = _batch([[9.0], [9.0], [8.0], [9.0], [9.0]], [[30.0]] * 5,
                   [6e9] * 5)
    row = _decide(slow, batch)["_WCLASS_MIN_LANES"]
    assert row["value"] == 81_920 and row["faster_split"] == []
    noisy = _wclass([[10.0, 12.0]] * 5, [[9.5, 11.0]] * 5, lanes)
    assert _decide(noisy, batch)["_WCLASS_MIN_LANES"]["faster_split"] == []
    fast = _wclass(w0, [[11.0], [11.0], [11.0], [9.0], [9.0]], lanes)
    row = _decide(fast, batch)["_WCLASS_MIN_LANES"]
    assert row["value"] == 41_001 and row["faster_split"] == [4096, 8192]


def test_horizon_rule():
    """The cold horizon: the median of the guard's first completions,
    rounded up to 0.5 s."""
    line = {"sweep": "horizon", "warmup_s": [7.1, 7.3, None, 6.9, 7.2],
            "device_entries": [2048] * 5, "median": 7.15}
    assert _decide(line)["EndgameGuard.cold_horizon default"]["value"] \
        == 7.5


@pytest.fixture(scope="module")
def small():
    return [encode(synthesize(n, seed=i))
            for i, n in enumerate((26, 60, 151, 240, 60, 90, 120))]


def test_lane_batches_replay_the_stream(small, monkeypatch):
    """lane_batches forms the batches decode_fcz_stream forms: the same
    lanes, batch for batch, as the stream's own packs."""
    seen = []
    real = B.pack_decode_wire

    def spy(fczs, bb_wire, wclass=None):
        seen.append(sum(f.n_anchor - 1 for f in fczs))
        return real(fczs, bb_wire, wclass)
    monkeypatch.setattr(B, "pack_decode_wire", spy)
    monkeypatch.setenv("FOLDCOMP_TPU_WIRE", "full")
    for batch in (1, 2, 3):
        seen.clear()
        list(B.decode_fcz_stream(iter(small), batch_size=batch,
                                 device="cpu"))
        got = R.lane_batches(small, batch)
        assert sorted(seen) == sorted(n for n, _ in got)
        assert len(seen) == len(got)
        assert all(s <= 1.0 for _, s in got)


def test_runner_records_a_cli_child(small, tmp_path):
    """Runner.run: one `decompress --exact` child, its record (rc, the
    peak RSS, no device memory), the outputs counted and removed."""
    src = tmp_path / "fczs"
    src.mkdir()
    for i, f in enumerate(small[:3]):
        (src / f"e{i}.fcz").write_bytes(serialize(f))
    (tmp_path / "wd").mkdir()
    run = R.Runner(torch.device("cpu"), tmp_path / "wd")
    out = tmp_path / "wd" / "out"
    rec = run.run(["decompress", "--exact", src, out], out)
    assert rec["rc"] == 0 and rec["n_out"] == 3 and not out.exists()
    assert rec["maxrss_bytes"] > 0 and rec["device_peak_bytes"] is None
    assert rec["wall_s"] >= rec["inner_s"] > 0


def test_runner_instruments_a_decompress_fast_child(small, tmp_path):
    """Runner.run(instrument=True): a `decompress --fast` child reads its
    batches' device waits, D2H seconds and packs from the program's own
    spans (tracing), one of each a batch, the packs' lanes and residues
    those of the entries."""
    src = tmp_path / "fczs"
    src.mkdir()
    for i, f in enumerate(small):
        (src / f"e{i}.fcz").write_bytes(serialize(f))
    (tmp_path / "wd").mkdir()
    run = R.Runner(torch.device("cpu"), tmp_path / "wd")
    out = tmp_path / "wd" / "out"
    rec = run.run(["decompress", "--fast", src, out], out, True,
                  {"FOLDCOMP_TPU_BATCH": "3", "FOLDCOMP_TPU_WIRE": "full"})
    assert rec["rc"] == 0 and rec["n_out"] == len(small)
    n_batches = -(-len(small) // 3)
    assert len(rec["wait_s"]) == len(rec["d2h_s"]) == len(rec["packs"]) \
        == n_batches
    assert all(x >= 0 for x in rec["wait_s"] + rec["d2h_s"])
    assert sum(p[0] for p in rec["packs"]) == \
        sum(f.n_anchor - 1 for f in small)
    assert sum(p[1] for p in rec["packs"]) == sum(f.n_residue for f in small)
    assert all(p[2] >= p[1] and p[3] is False for p in rec["packs"])
    assert rec["split_s"] == []
