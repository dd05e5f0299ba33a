"""The port's scaling harness on the CPU (parallel/scaling.py): the
synthetic database, the multiprocess decompress whose workers join one
gloo group through init_distributed, and measure_scaling's world sizes of
the roundtrip step on CPU ranks. The source database is 16 entries of
verify.synthesize, encoded by the port's exact encoder. No test gates on
a rate: on the CPU they only show that each run completes, joins and
writes what it should."""
import numpy as np
import pytest

from foldcomp_tpu_torch.codec import fcz
from foldcomp_tpu_torch.codec.encoder import encode
from foldcomp_tpu_torch.io.db import DatabaseReader, DatabaseWriter
from foldcomp_tpu_torch.parallel.dist import decompress_db_shard
from foldcomp_tpu_torch.parallel.scaling import (build_synthetic_db,
                                                 measure_multiprocess_scaling,
                                                 measure_scaling)
from foldcomp_tpu_torch.verify import synthesize

SRC_LENGTHS = tuple(30 + 7 * i for i in range(16))


@pytest.fixture(scope="module")
def src_db(tmp_path_factory):
    path = tmp_path_factory.mktemp("src") / "src_db"
    w = DatabaseWriter(str(path))
    for i, n in enumerate(SRC_LENGTHS):
        w.append(fcz.serialize(encode(synthesize(n, i))) + b"\x00", i,
                 f"s{i}")
    w.close()
    return str(path)


def _entries(path):
    r = DatabaseReader(str(path), use_lookup=True)
    try:
        return [(r.get_key(p), r.name_of_key(r.get_key(p)),
                 bytes(r.get_data(p))) for p in range(len(r))]
    finally:
        r.close()


@pytest.mark.parametrize("mixed", [False, True])
def test_build_synthetic_db(tmp_path, src_db, mixed):
    total = build_synthetic_db(str(tmp_path / "db"), 40, src_db=src_db,
                               mixed=mixed)
    got = _entries(tmp_path / "db")
    assert [k for k, _, _ in got] == list(range(40))
    assert [nm for _, nm, _ in got] == [f"entry{i}" for i in range(40)]
    n_res = [fcz.parse(d[:-1]).n_residue for _, _, d in got]
    assert sum(n_res) == total
    if mixed:
        # re-encoded slices and 3x tiles of the sources
        assert len(set(n_res)) > 16 and max(n_res) > max(SRC_LENGTHS)
    else:
        assert n_res == [SRC_LENGTHS[i % 16] for i in range(40)]


def test_measure_multiprocess_scaling(tmp_path, src_db):
    """One and two worker processes, joined through init_distributed
    (each checks the rank and size it got), decompress their shards by
    the native path; the two-process run's merged database equals the
    one-shard decompress byte for byte."""
    merged = str(tmp_path / "merged")
    out = measure_multiprocess_scaling([1, 2], n_entries=64, trials=1,
                                       pin=False, workdir=str(tmp_path),
                                       src_db=src_db, merged_out=merged)
    assert sorted(out["per_count"]) == [1, 2]
    assert out["n_entries"] == 64 and out["total_residues"] > 0
    for row in out["per_count"].values():
        assert len(row["trials"]) == 1 and row["median_res_s"] > 0
    db = tmp_path / "syn_db"
    assert decompress_db_shard(str(db), str(tmp_path / "one"), 0, 1,
                               fast=False) == 64
    assert len(_entries(merged)) == 64
    for suffix in ("", ".index", ".lookup"):
        assert (tmp_path / ("merged" + suffix)).read_bytes() == \
            (tmp_path / ("one.0" + suffix)).read_bytes(), suffix


def test_measure_scaling_cpu():
    rows = measure_scaling([1, 2], b_per_device=2, lengths=(26, 60),
                           iters=1, device="cpu")
    assert [n for n, _, _ in rows] == [1, 2]
    assert all(np.isfinite(thr) and thr > 0 for _, thr, _ in rows)
    assert rows[0][2] == 1.0
