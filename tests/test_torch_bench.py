"""The port's bench (foldcomp_tpu_torch/bench.py) on the CPU, with the plain
versions (`--device cpu`), at a tiny size.

(a) A run prints one JSON line whose keys are bench.KEYS in order, every
rate finite and positive, no gate failed; its CLI children start from the
product's defaults whatever the caller's HOME, cache and FOLDCOMP_TPU_*
hold.
(b) With the decode deviation check forced to fail, the decode rates print
as null, gates_failed names the gates and the exit code is 1. (c) Against the repository's bench.py and
the JAX package: the mixed corpus is the same FCZ bytes, the drawn entries
the same sequence, and the padding ratios of the mixed decode those of
bench.py's `prep` (bench.py:367-389), recomputed here through
foldcomp_tpu.codec.batch.pack_decode_batch_auto on the same entries
(`prep` is nested, so it cannot be called). Besides: the paired child, and
the PDB gate the bench and chip_smoke.py share.
"""
import importlib.util
import json
import math
import pathlib
import random

import pytest

from test_property_roundtrip import synthesize

from foldcomp_tpu.codec import batch as tpu_batch
from foldcomp_tpu.codec import fcz as tpu_fcz
from foldcomp_tpu_torch import bench
from foldcomp_tpu_torch.codec import fcz as port_fcz
from foldcomp_tpu_torch.parallel.hybrid import COLD_HORIZON_S

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = bench.Sizes(reps=1, bandwidth_mib=1, decode_batches=(16,),
                   decode_iters=2, host_entries=16, warm_start_primes=0,
                   warm_start_batch=8, encode_batch=8, encode_iters=2,
                   resident_batch=8, resident_iters=2, mixed_entries=16,
                   mixed_batch=8, mixed_iters=1, mixed_pairs=1,
                   e2e_entries=16, e2e_pairs=0, e2e_threads=2)
# printed only on a card, or only with paired runs (e2e_pairs > 0)
NULL_ON_CPU = {"e2e_fast_decompress_device_busy_share",
               "e2e_fast_decompress_copy_busy_share",
               "e2e_fast_decompress_inprocess_wall_s",
               "e2e_fast_decompress_profiled_wall_s",
               "hybrid_vs_native_paired_decompress",
               "hybrid_vs_native_paired_compress", "hybrid_ge_native"}
DECODE_RATES = ("value", "decode_sync_res_s", "decode_sustained_med_res_s",
                "decode_kernel_res_s", "decode_bsweep_res_s",
                "decode_mixed_device_res_s", "decode_mixed_fused_res_s",
                "decode_mixed_wclass_res_s")


def _bench_main(monkeypatch, capsys, tmp_path):
    """bench.main(["--quick", "--device", "cpu", ...]) with --quick at
    TINY, torch on one thread here and in the children: the plain
    versions' many small operations crawl when OpenMP threads contend for
    cores the other test workers hold. -> (exit code, the stdout lines)."""
    import torch
    monkeypatch.setattr(bench, "QUICK", TINY)
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    # what a caller's earlier runs leave: the CLI children must not see it
    warmup = home / ".cache" / "foldcomp_tpu_torch" / "device_warmup.json"
    warmup.parent.mkdir(parents=True)
    warmup.write_text(json.dumps({"warmup_s": 9.0}))
    # and a cache the caller moved, with its own estimate
    moved = tmp_path / "callers_cache"
    moved.mkdir()
    (moved / "device_warmup.json").write_text(json.dumps({"warmup_s": 8.0}))
    monkeypatch.setenv("FOLDCOMP_TPU_TORCH_CACHE", str(moved))
    monkeypatch.setenv("FOLDCOMP_TPU_WARMUP_EST", "7")
    monkeypatch.setenv("FOLDCOMP_TPU_WCLASS", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = bench.main(["--quick", "--device", "cpu", "--out-dir",
                         str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    return rc, capsys.readouterr().out.strip().splitlines()


def _rates(line):
    """(key, value) of every rate and ratio of the line."""
    for k, v in line.items():
        if k == "decode_bsweep_res_s":
            yield from ((f"{k}[{b}]", x) for b, x in v.items())
        elif k == "value" or k.endswith(("_res_s", "_gb_s", "_vs_exact",
                                         "_pad", "_pad_overhead")) \
                or k.startswith(("hybrid_vs_native", "pct_roofline")):
            yield k, v


def test_tiny_run_prints_every_key(monkeypatch, capsys, tmp_path):
    """(a)"""
    rc, lines = _bench_main(monkeypatch, capsys, tmp_path)
    assert rc == 0 and len(lines) == 1, lines
    line = json.loads(lines[0])
    assert list(line) == list(bench.KEYS)
    assert line["gates_failed"] == [] and line["device_parity_ok"] is True
    assert line["device"] == "cpu" and line["quick"] is True
    assert line["sizes"]["e2e_entries"] == 16 and line["e2e_threads"] == 2
    assert line["e2e_workdir"] == "out_dir"
    rates = dict(_rates(line))
    assert len(rates) > 30
    for k, v in rates.items():
        if k in NULL_ON_CPU:
            assert v is None, k
        else:
            assert isinstance(v, float) and math.isfinite(v) and v > 0, (k, v)
    for k in NULL_ON_CPU:
        assert line[k] is None, k
    split = line["warm_start_split"]
    assert split["cuda_context_s"] is None and split["kernel_load_s"] is None
    assert split["torch_import_s"] > 0 and split["first_decode_s"] > 0
    assert line["e2e_hybrid_device_entries"] == {
        "decompress": [], "compress": [], "of": 16}
    # the guard's default: neither the caller's file nor its setting
    h = COLD_HORIZON_S
    assert line["e2e_hybrid_warmup_est_s"] == {"decompress": [h, h],
                                               "compress": [h, h]}


def test_failed_decode_gate_nulls_its_rates(monkeypatch, capsys, tmp_path):
    """(b) The decode deviation check forced to fail; the parity check
    (which has its own, and which (a) runs), the e2e and the warm start
    replaced by stand-ins, which this gate does not reach."""
    e2e_keys = list(bench.KEYS[bench.KEYS.index("e2e_entries"):
                               bench.KEYS.index("gates_failed")])
    monkeypatch.setattr(bench, "max_deviation", lambda *a: math.inf)
    monkeypatch.setattr(bench.verify, "device_parity_check", lambda dev: {
        "failures": [], "parity_ok": True, "checked": ["decode"],
        "corpus": "synthetic"})
    monkeypatch.setattr(bench, "e2e", lambda *a: (
        dict.fromkeys(e2e_keys, 1.0), {}))
    monkeypatch.setattr(bench, "warm_start", lambda *a: (1.0, {}))
    rc, lines = _bench_main(monkeypatch, capsys, tmp_path)
    assert rc == 1 and len(lines) == 1
    line = json.loads(lines[0])
    assert line["device_parity_ok"] is True
    failed = [g.split(":")[0] for g in line["gates_failed"]]
    assert failed == ["decode_uniform", "decode_mixed_device",
                      "decode_mixed_fused", "decode_mixed_wclass"]
    for k in DECODE_RATES:
        assert line[k] is None, k
    for k in ("encode_device_res_s", "encode_pipelined_res_s",
              "host_pack_res_s", "decode_mixed_pad_overhead"):
        assert line[k] > 0, k


def test_paired_ratio_runs_both_routes(tmp_path):
    """The paired child (bench.py:532-606) on a 16-entry database: the
    no-flag route and --exact alternate; the ratio is finite. (On the CPU
    both run the native workers: the ratio is noise around 1, which is why
    the tiny run leaves the pairs out.)"""
    import torch
    uniq = bench.mixed_corpus()
    db = tmp_path / "fcz_db"
    bench.write_fcz_db(db, uniq, bench.draw_lengths(16, seed=1))
    env = bench._child_env(torch.device("cpu"), tmp_path)
    assert env["HOME"] == str(tmp_path / "home")
    assert "FOLDCOMP_TPU_TORCH_CACHE" not in env
    r, horizons = bench.paired_ratio(env, "decompress", str(db),
                                     str(tmp_path / "o"), "2", 1)
    assert math.isfinite(r) and r > 0 and \
        horizons == [COLD_HORIZON_S] * 2
    assert len(bench.read_entries(tmp_path / "o")) == 16


def test_pdb_gate_holds_exact_and_flags_drift():
    """bench.PdbGate, which holds the bench's e2e outputs and chip_smoke.py
    phases 5 and 12: the exact decoder's PDB text passes, sampled or not;
    a coordinate 0.1 A off, or a payload two atoms short, is named; an
    output whose names differ from the exact route's fails as a whole."""
    from foldcomp_tpu_torch.codec.decoder import decode
    from foldcomp_tpu_torch.io.pdb import format_pdb
    uniq = bench.mixed_corpus((120, 200))
    exact = {n: decode(f) for n, f in uniq.items()}
    texts = {n: format_pdb(a, f"s{n}").encode() for n, a in exact.items()}
    picks = bench.draw_lengths(8, seed=1, lengths=(120, 200))
    got = {i: (f"e{i}_L{n}", texts[n]) for i, n in enumerate(picks)}
    gate = bench.PdbGate(exact)
    # the print's rounding (<= 5e-4 A) is within the JAX deviation
    assert gate.check("ok", got) == ([], 0.0)
    assert gate.check("sampled", got, sample=4) == ([], 0.0)
    lines = texts[120].split(b"\n")
    i = next(k for k, ln in enumerate(lines) if ln.startswith(b"ATOM"))
    x = float(lines[i][30:38]) + 0.1
    lines[i] = lines[i][:30] + f"{x:8.3f}".encode() + lines[i][38:]
    atoms = [k for k, ln in enumerate(lines) if ln.startswith(b"ATOM")]
    short = b"\n".join(ln for k, ln in enumerate(texts[120].split(b"\n"))
                       if k not in atoms[-2:])
    key = next(k for k, (nm, _) in got.items() if nm.endswith("_L120"))
    bad = dict(got)
    bad[key] = (got[key][0], b"\n".join(lines))
    fails, worst = gate.check("drift", bad, want=got)
    assert fails == [f"drift {got[key][0]}: dev {worst:.6f} A over the "
                     "JAX reference's"] and worst > 0.09
    bad[key] = (got[key][0], short)
    assert gate.check("short", bad, want=got)[1] == math.inf
    renamed = dict(got)
    renamed[key] = ("other", got[key][1])
    assert len(gate.check("names", renamed, want=got)[0]) == 1


@pytest.fixture(scope="module")
def repo_bench():
    """The repository's bench.py as a module."""
    spec = importlib.util.spec_from_file_location("repo_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mixed_corpus_and_pads_match_bench_py(repo_bench, monkeypatch):
    """(c)"""
    uniq = bench.mixed_corpus()
    want_u = {L: repo_bench.encode_mixed(synthesize(L, seed=L), f"s{L}")
              for L in bench.LENGTHS}
    for L in bench.LENGTHS:
        assert port_fcz.serialize(uniq[L]) == tpu_fcz.serialize(want_u[L]), L
    # bench.py:362-364 on 64 entries
    rng = random.Random(0)
    want = sorted((want_u[rng.choice(list(bench.LENGTHS))]
                   for _ in range(64)), key=tpu_batch.seg_sort_key)
    got = bench.mixed_entries(uniq, 64)
    assert [port_fcz.serialize(f) for f in got] == \
        [tpu_fcz.serialize(f) for f in want]

    # bench.py:367-389 `prep` on bench.py:424-429's width groups, through
    # the JAX package's pack with its ragged lanes (the fused path's)
    monkeypatch.setattr(tpu_batch, "use_fused_decode", lambda: True)
    monkeypatch.setenv("FOLDCOMP_TPU_WIRE", "full")
    by_w = {}
    for f in want:
        by_w.setdefault(tpu_batch.seg_sort_key(f)[0], []).append(f)
    n_res = sum(f.n_residue for f in want)
    pads = {}
    for wclass in ("0", "1"):
        monkeypatch.setenv("FOLDCOMP_TPU_WCLASS", wclass)
        pad_res = 0
        for w in sorted(by_w):
            arrays, _ = tpu_batch.pack_decode_batch_auto(by_w[w])
            if "classes" in arrays:
                pad_res += sum(r.shape[1] * r.shape[2]
                               for r in arrays["classes"]["recs"])
            else:
                assert "fwd9" in arrays
                seg_w, nl = arrays["seg_records"].shape[1:]
                pad_res += seg_w * nl
        pads[wclass] = pad_res / n_res
    groups = bench.width_groups(got)
    assert bench.mixed_packs(groups, "0")[1] == pads["0"]
    assert bench.mixed_packs(groups, "1")[1] == pads["1"]
