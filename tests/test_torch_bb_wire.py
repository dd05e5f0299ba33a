"""The port's backbone-only decode wire (wire="bb") against the JAX
reference, on CPU.

The bb wire runs k1 and k2 on the device and ships N and C as i16
offsets from an f32 CA at a 0.1 mA quantum (24 B a residue); the host
places O and the side chains with the native codec. Here the port runs its
plain PyTorch versions (device="cpu"), the reference JAX `decode_seg_fused`
in Pallas interpret mode, as tests/test_bb_wire.py runs it.

Tolerances:
- offsets within 1 i16 unit (0.1 mA) of the reference's on the rows each
  lane owns: torch's and XLA's CPU sin/cos differ by ulps, and a value at
  a half of the quantum flips by one unit (measured largest: 1 unit);
- CA within 1e-3 A, the f32 tolerance of the full-wire slice
  (tests/test_torch_decode_kernels.py);
- the epilogue alone, on the reference's own k2 rows: bit-equal;
- per protein, backbone slots within 1.2e-3 A of the port's full wire
  (its 1 mA grid) and side chains no farther from the exact decoder than
  the full wire's + 1e-3 A, as tests/test_bb_wire.py holds the JAX wire.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_property_roundtrip import synthesize
from test_torch_decode_kernels import _jax_stages
from test_torch_decode_slice import _split_pdb

from foldcomp_tpu.codec.batch import pack_decode_batch_lanes
from foldcomp_tpu.codec.decoder import decode as decode_exact
from foldcomp_tpu.codec.encoder import encode
from foldcomp_tpu.codec.fcz import serialize
from foldcomp_tpu.io.db import DatabaseReader, DatabaseWriter
from foldcomp_tpu.kernels.pallas_decode import decode_seg_fused as jax_decode
from foldcomp_tpu_torch import cli, verify
from foldcomp_tpu_torch.codec import batch as B
from foldcomp_tpu_torch.codec.batch_host import _gather_a14
from foldcomp_tpu_torch.kernels import fused_decode as FD
from foldcomp_tpu_torch.native import get_lib

REPO = pathlib.Path(__file__).resolve().parents[1]
KEYS = ("seg_records", "mins_lane", "cont_lane", "sc_codes_seg", "fwd9",
        "rev9", "is_first", "seg_m")
TOL_I16 = 1
TOL_CA_A = 1e-3
TOL_BB_SLOT_A = 1.2e-3
TOL_SC_A = 1e-3
# a printed coordinate is rounded to 3 decimals: up to 5e-4 A each side
PRINT_SLACK_A = 1e-3


@pytest.fixture(scope="module")
def mixed():
    """The test_wclass.py corpus: several anchor-tail widths + a repeat."""
    fczs = [encode(synthesize(n, seed=i))
            for i, n in enumerate((26, 60, 151, 240, 60))]
    arrays, metas = pack_decode_batch_lanes(fczs)
    return fczs, arrays, metas


def _owned(arrays, off):
    return np.arange(off.shape[1])[None, :] \
        < arrays["seg_m"][:off.shape[0], None]


@pytest.mark.parametrize("refine_iters", [1, 2])
def test_bb_wire_matches_jax_reference(mixed, refine_iters):
    _, arrays, _ = mixed
    nl_out = int(arrays["nl_out"])
    want = [np.array(x) for x in jax_decode(
        *(arrays[k] for k in KEYS), refine_iters=refine_iters,
        interpret=True, nl_out=nl_out, wire="bb")]
    ta = B.arrays_to_torch(arrays, "cpu")
    got = [x.numpy() for x in FD.decode_seg_fused(
        *(ta[k] for k in KEYS), refine_iters=refine_iters, nl_out=nl_out,
        wire="bb")]
    assert [(g.dtype, g.shape) for g in got] == \
        [(w.dtype, w.shape) for w in want]
    assert got[0].shape[2] == 6 and got[1].shape[2] == 3
    own = _owned(arrays, got[0])
    d_off = np.abs(got[0].astype(np.int32) - want[0])[own].max()
    d_ca = np.abs(got[1] - want[1])[own].max()
    assert d_off <= TOL_I16, d_off
    assert d_ca <= TOL_CA_A, d_ca


def test_bb_epilogue_bit_equal_on_reference_rows(mixed):
    """bb_epilogue_plain on the JAX path's own k2 rows gives the JAX bb
    wire bit for bit, every row: the epilogue's arithmetic on its own."""
    _, arrays, _ = mixed
    nl_out = int(arrays["nl_out"])
    rows = _jax_stages(*(arrays[k] for k in KEYS), refine_iters=2)["bb"]
    nl = arrays["seg_records"].shape[2]
    off, ca = FD.bb_epilogue_plain(
        *(torch.from_numpy(np.array(r)[:, :nl]) for r in rows), nl_out)
    want = [np.array(x) for x in jax_decode(
        *(arrays[k] for k in KEYS), refine_iters=2, interpret=True,
        nl_out=nl_out, wire="bb")]
    assert off.numpy().tobytes() == want[0].tobytes()
    assert ca.numpy().tobytes() == want[1].tobytes()


def _port_a14(fczs, monkeypatch, wire):
    monkeypatch.setenv("FOLDCOMP_TPU_WIRE", wire)
    outs, metas = B.decode_fcz_host(fczs, device="cpu")
    assert isinstance(outs[0], str) == (wire == "bb")
    return [_gather_a14(outs, m) for m in metas], metas


def test_bb_wire_matches_full_path(mixed, monkeypatch):
    if get_lib() is None:
        pytest.skip("native library unavailable")
    fczs, _, _ = mixed
    full, _ = _port_a14(fczs, monkeypatch, "full")
    bb, metas = _port_a14(fczs, monkeypatch, "bb")
    assert all(m.sc_codes is not None for m in metas)
    for i, (a, b, f, m) in enumerate(zip(full, bb, fczs, metas)):
        assert a.shape == b.shape, i
        assert np.abs(a[:, :3] - b[:, :3]).max() <= TOL_BB_SLOT_A, i
        exact = np.asarray(decode_exact(f).coords)
        dev_full = verify.max_deviation(a, m.res_code, exact)
        dev_bb = verify.max_deviation(b, m.res_code, exact)
        assert dev_bb <= dev_full + TOL_SC_A, (i, dev_full, dev_bb)


def test_bb_wire_needs_the_native_library(mixed, monkeypatch):
    """Without the native library use_bb_wire answers False even when
    pinned, and a bb pack that reaches the stitch raises."""
    fczs, arrays, _ = mixed
    monkeypatch.setenv("FOLDCOMP_TPU_WIRE", "bb")
    monkeypatch.setattr(B, "get_lib", lambda: None)
    assert B.use_bb_wire() is False
    packed, metas = B.pack_decode_wire(fczs[:1], bb_wire=True)
    assert packed["bb_wire"] and metas[0].sc_codes is not None
    outs = B._outs_to_host(B._seg_decode_arrays(
        B.arrays_to_torch(packed, "cpu")))
    assert outs[0] == "bb" and outs[1].shape[2] == 6
    import foldcomp_tpu_torch.native as N
    monkeypatch.setattr(N, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native library"):
        _gather_a14(outs, metas[0])


def test_use_bb_wire_env_and_probe(monkeypatch):
    # env pins
    monkeypatch.setenv("FOLDCOMP_TPU_WIRE", "full")
    assert B.use_bb_wire() is False
    monkeypatch.setenv("FOLDCOMP_TPU_WIRE", "bb")
    assert B.use_bb_wire() is (get_lib() is not None)
    # auto: the probe drives the decision
    monkeypatch.delenv("FOLDCOMP_TPU_WIRE", raising=False)
    for result, mbs, want in (("slow", 9.9, True), ("ok", 150.0, True),
                              ("ok", 800.0, False), ("slow", 0.0, False),
                              ("slow", 4.9, False), ("ok", 200.0, False),
                              ("ok", 5.0, True), ("none", 0.0, False)):
        monkeypatch.setattr(cli, "_probe_info", lambda r=result, m=mbs:
                            (r, m))
        got = B.use_bb_wire()
        if get_lib() is None:
            assert got is False
        else:
            assert got is want, (result, mbs)


@pytest.mark.parametrize("link", ["ok", "slow", "none"])
def test_link_override_forces_the_probe(monkeypatch, link):
    """FOLDCOMP_TPU_LINK answers for the probe with 0 MB/s, which is below
    the bb band: the full wire."""
    monkeypatch.delenv("FOLDCOMP_TPU_WIRE", raising=False)
    monkeypatch.setenv("FOLDCOMP_TPU_LINK", link)
    monkeypatch.setattr(cli, "_run_probe", lambda: pytest.fail("probed"))
    assert cli._probe_info() == (link, 0.0)
    assert B.use_bb_wire() is False


def test_probe_runs_and_caches_in_its_own_file(monkeypatch, tmp_path):
    """Unforced, the probe runs its subprocess (no card here: 'none'),
    caches the answer in the port's own file, and answers from it."""
    import json
    import tempfile
    monkeypatch.delenv("FOLDCOMP_TPU_LINK", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got = cli._probe_info()
    if not torch.cuda.is_available():
        assert got == ("none", 0.0)
    assert got[0] in ("ok", "slow", "none")
    cache = tmp_path / f"foldcomp_tpu_torch_probe_{os.getuid()}.json"
    assert [p.name for p in tmp_path.iterdir()] == [cache.name]
    assert json.loads(cache.read_text())["result"] == got[0]
    monkeypatch.setattr(cli, "_run_probe", lambda: pytest.fail("probed"))
    assert cli._probe_info() == got


def _cli_db(tmp_path, fczs, wire):
    db = tmp_path / "in_db"
    if not db.exists():
        w = DatabaseWriter(str(db))
        for i, f in enumerate(fczs):
            w.append(serialize(f), i, f"p{i}")
        w.close()
    env = dict(os.environ, PYTHONPATH=str(REPO), FOLDCOMP_TORCH_DEVICE="cpu",
               FOLDCOMP_TPU_WIRE=wire)
    r = subprocess.run([sys.executable, "-m", "foldcomp_tpu_torch",
                        "decompress", "--fast", "in_db", f"out_{wire}",
                        "--db"], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    reader = DatabaseReader(str(tmp_path / f"out_{wire}"))
    try:
        return {name: bytes(data).rstrip(b"\x00").decode()
                for _, name, data in reader.entries()}
    finally:
        reader.close()


def test_cli_decompress_fast_bb_wire(tmp_path, mixed):
    """FOLDCOMP_TPU_WIRE=bb decompress --fast db -> db on the CPU: the
    same PDB texts as the full wire's in every non-coordinate column; in
    coordinates, backbone atoms within 1.2e-3 A of the full wire's and
    each protein no farther from the exact decoder than the full wire +
    1e-3 A, each with the print's rounding on top."""
    if get_lib() is None:
        pytest.skip("native library unavailable")
    fczs, _, _ = mixed
    full = _cli_db(tmp_path, fczs, "full")
    bb = _cli_db(tmp_path, fczs, "bb")
    assert sorted(bb) == sorted(full) == sorted(f"p{i}"
                                                for i in range(len(fczs)))
    for i, f in enumerate(fczs):
        b_lines, b_xyz = _split_pdb(bb[f"p{i}"])
        f_lines, f_xyz = _split_pdb(full[f"p{i}"])
        assert b_lines == f_lines
        assert b_xyz.shape == f_xyz.shape and len(b_xyz)
        names = [ln[12:16].strip() for ln in bb[f"p{i}"].splitlines()
                 if ln.startswith("ATOM")]
        backbone = np.isin(names, ("N", "CA", "C"))
        assert np.abs(b_xyz - f_xyz)[backbone].max() \
            <= TOL_BB_SLOT_A + PRINT_SLACK_A, i
        exact = np.asarray(decode_exact(f).coords, np.float64)
        n = min(len(exact), len(b_xyz))
        dev_bb = np.abs(b_xyz[:n] - exact[:n]).max()
        dev_full = np.abs(f_xyz[:n] - exact[:n]).max()
        assert dev_bb <= dev_full + TOL_SC_A + PRINT_SLACK_A, \
            (i, dev_full, dev_bb)
