"""The port's `decompress --fast` slice against the JAX reference, on CPU.

The port runs its plain PyTorch kernel versions (device="cpu"); the
reference is JAX `decode_seg_fused` in Pallas interpret mode. Both go
through the shared host stitch (_gather_a14) and native formatter, so the
PDB texts must agree in every non-coordinate column, and the printed
coordinates within 1e-3 A, one print unit. The wire carries mA offsets
from a f32 CA: a 1-unit offset flip (test_torch_decode_kernels.py) moves a
printed coordinate by one unit, and the CA's f32 drift between torch's and
XLA's CPU math (~2e-4 A on this corpus) does not reach a second one here.

Also here: the committed JAX-reference deviations
(tests/data/torch_port_ref_dev.json) recomputed, the port's verify module,
the CLI db -> db route, and the port's import boundary (no JAX).

Regenerate the reference file with `python tests/test_torch_decode_slice.py`.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_property_roundtrip import synthesize

from foldcomp_tpu.codec.batch import (_format_batch, _gather_a14,
                                      _outs_to_host, pack_decode_batch_lanes)
from foldcomp_tpu.codec.decoder import decode as decode_exact
from foldcomp_tpu.codec.encoder import encode
from foldcomp_tpu.codec.fcz import serialize
from foldcomp_tpu.io.db import DatabaseReader, DatabaseWriter
from foldcomp_tpu_torch import verify
from foldcomp_tpu_torch.codec.batch import (decode_fcz_batch,
                                            decode_fcz_host,
                                            decode_fcz_to_pdb_batch)

REPO = pathlib.Path(__file__).resolve().parents[1]
# bench.py's mixed-corpus lengths (bench_device_decode_mixed)
BENCH_LENGTHS = (120, 200, 280, 360, 480, 640, 840, 1080)
# one print unit (+ float parse slack)
COORD_TOL_A = 1e-3 + 1e-6
# the committed deviations are recomputed on another host's XLA: ulps
REF_DEV_TOL_A = 1e-5


def _jax_decode(fczs, refine_iters=2):
    from foldcomp_tpu.kernels.pallas_decode import decode_seg_fused
    arrays, metas = pack_decode_batch_lanes(fczs)
    out = decode_seg_fused(
        arrays["seg_records"], arrays["mins_lane"], arrays["cont_lane"],
        arrays["sc_codes_seg"], arrays["fwd9"], arrays["rev9"],
        arrays["is_first"], arrays["seg_m"], refine_iters=refine_iters,
        interpret=True, nl_out=int(arrays["nl_out"]))
    return _outs_to_host(out), metas


def compute_ref_dev():
    """({length: JAX fused-path max deviation from the exact decoder},
    the corpus) for bench.py's 8 synthetic lengths."""
    corpus = verify.synthetic_corpus(BENCH_LENGTHS)
    outs, metas = _jax_decode(list(corpus.values()))
    dev = {n: verify.max_deviation(_gather_a14(outs, m), m.res_code,
                                   np.asarray(decode_exact(f).coords))
           for (n, f), m in zip(corpus.items(), metas)}
    return dev, corpus


def _split_pdb(text):
    """PDB text -> (lines with the coordinate columns blanked, [n, 3]
    coordinates of the ATOM lines)."""
    masked, xyz = [], []
    for line in text.splitlines():
        if line.startswith("ATOM"):
            xyz.append([float(line[30:38]), float(line[38:46]),
                        float(line[46:54])])
            line = line[:30] + " " * 24 + line[54:]
        masked.append(line)
    return masked, np.asarray(xyz, np.float64).reshape(-1, 3)


def _assert_pdb_close(got, want, tol=COORD_TOL_A):
    g_lines, g_xyz = _split_pdb(got)
    w_lines, w_xyz = _split_pdb(want)
    assert g_lines == w_lines
    assert g_xyz.shape == w_xyz.shape and len(g_xyz)
    assert np.abs(g_xyz - w_xyz).max() <= tol


@pytest.fixture(scope="module")
def mixed():
    """The test_wclass.py corpus: several anchor-tail widths + a repeat."""
    return [encode(synthesize(n, seed=i))
            for i, n in enumerate((26, 60, 151, 240, 60))]


def test_pdb_text_matches_jax_reference(mixed):
    port = decode_fcz_to_pdb_batch(mixed, device="cpu")
    outs, metas = _jax_decode(mixed)
    ref = [t for _, t in _format_batch(mixed, metas, outs, False)]
    assert len(port) == len(ref) == len(mixed)
    for got, want in zip(port, ref):
        _assert_pdb_close(got, want)
    # the atom arrays agree with the text path
    atoms = decode_fcz_batch(mixed, device="cpu")
    assert [len(a) for a in atoms] == \
        [len(_split_pdb(t)[1]) for t in port]


def test_ref_dev_file_matches_jax_reference():
    """The committed deviations are the JAX fused path's, and the port's
    CPU path is no farther from the exact decoder than they + 1e-3 A."""
    dev, corpus = compute_ref_dev()
    committed = verify.load_ref_dev()
    assert sorted(committed) == list(BENCH_LENGTHS)
    for n in BENCH_LENGTHS:
        assert abs(dev[n] - committed[n]) <= REF_DEV_TOL_A, n
    outs, metas = decode_fcz_host(list(corpus.values()), device="cpu")
    for (n, f), m in zip(corpus.items(), metas):
        d = verify.max_deviation(_gather_a14(outs, m), m.res_code,
                                 np.asarray(decode_exact(f).coords))
        assert d <= committed[n] + verify.REF_DEV_SLACK_A, (n, d)


def test_verify_parity_check_on_cpu():
    got = verify.device_parity_check(device="cpu")
    assert got["device"] == "cpu"
    assert got["parity_ok"], got["failures"]
    assert len(got["max_dev_A"]) >= 2


def _db_of(fczs, path):
    w = DatabaseWriter(str(path))
    for i, f in enumerate(fczs):
        w.append(serialize(f), i, f"p{i}")
    w.close()


def _run_cli(args, cwd, **env):
    full = dict(os.environ, PYTHONPATH=str(REPO), **env)
    return subprocess.run([sys.executable, "-m", "foldcomp_tpu_torch",
                           *args], cwd=cwd, env=full, capture_output=True,
                          text=True, timeout=600)


def test_pad_rows_are_unread(mixed):
    """Rows s >= seg_m of a lane are pack padding: the host stitch reads
    none of them. Filled with a sentinel (off 32767, ca NaN) before the
    stitch, they leave every PDB text unchanged. This is what lets k3
    skip them."""
    from foldcomp_tpu_torch.codec import batch_host
    from foldcomp_tpu_torch.codec.batch import (_outs_to_host,
                                                _seg_decode_arrays,
                                                arrays_to_torch)
    arrays, metas = batch_host.pack_decode_batch_lanes(mixed)
    off, ca = _outs_to_host(_seg_decode_arrays(arrays_to_torch(arrays,
                                                               "cpu")))
    want = [t for _, t in batch_host._format_batch(mixed, metas, (off, ca),
                                                   False)]
    pad = np.arange(off.shape[1])[None, :] >= \
        arrays["seg_m"][:off.shape[0], None]
    assert pad.any() and not pad.all()
    off, ca = off.copy(), ca.copy()
    off[pad] = 32767
    ca[pad] = np.nan
    got = [t for _, t in batch_host._format_batch(mixed, metas, (off, ca),
                                                  False)]
    assert got == want


def test_cli_decompress_fast_db_to_db(tmp_path, mixed):
    _db_of(mixed, tmp_path / "in_db")
    r = _run_cli(["decompress", "--fast", "in_db", "out_db", "--db"],
                 tmp_path, FOLDCOMP_TORCH_DEVICE="cpu")
    assert r.returncode == 0, r.stderr
    reader = DatabaseReader(str(tmp_path / "out_db"))
    try:
        got = {name: bytes(data).rstrip(b"\x00").decode()
               for _, name, data in reader.entries()}
    finally:
        reader.close()
    want = decode_fcz_to_pdb_batch(mixed, device="cpu")
    assert sorted(got) == sorted(f"p{i}" for i in range(len(mixed)))
    for i, text in enumerate(want):
        # batches differ from the in-process call, lanes do not interact
        _assert_pdb_close(got[f"p{i}"], text)


def test_cli_decompress_fast_needs_a_card(tmp_path, mixed):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _db_of(mixed[:1], tmp_path / "in_db")
    env = {k: v for k, v in os.environ.items()
           if k != "FOLDCOMP_TORCH_DEVICE"}
    r = subprocess.run([sys.executable, "-m", "foldcomp_tpu_torch",
                        "decompress", "--fast", "in_db", "out_db", "--db"],
                       cwd=tmp_path, env=dict(env, PYTHONPATH=str(REPO)),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0
    assert "CUDA" in r.stderr


def test_port_imports_no_jax():
    """Importing every module of the port and encoding one batch on the
    CPU loads no JAX and nothing of foldcomp_tpu."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(REPO)!r}]\n"
        "import foldcomp_tpu_torch, foldcomp_tpu_torch.cli\n"
        "import foldcomp_tpu_torch.codec.batch as cb\n"
        "import foldcomp_tpu_torch.kernels.fused_decode\n"
        "import foldcomp_tpu_torch.kernels.fused_encode\n"
        "import foldcomp_tpu_torch.kernels.encode\n"
        "import foldcomp_tpu_torch.kernels.bitpack\n"
        "import foldcomp_tpu_torch.kernels.build, foldcomp_tpu_torch.verify\n"
        "import chip_smoke\n"
        "from foldcomp_tpu_torch.verify import synthesize\n"
        "assert 'jax' not in sys.modules\n"
        "assert 'foldcomp_tpu' not in sys.modules\n"
        "got = cb.encode_fragment_batch([synthesize(30, 1)], device='cpu')\n"
        "assert got[0] is not None\n"
        "assert 'foldcomp_tpu' not in sys.modules\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'foldcomp_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    dev, _ = compute_ref_dev()
    path = verify.REF_DEV_PATH
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        json.dump({
            "what": "max |coordinate difference| (A) of the JAX fused "
                    "decode (decode_seg_fused, refine_iters=2, Pallas "
                    "interpret mode on CPU) from codec.decoder.decode",
            "corpus": "encode(synthesize(L, seed=L)) from "
                      "tests/test_property_roundtrip.py, default anchor "
                      "interval, one batch",
            "max_dev_A": {str(n): dev[n] for n in BENCH_LENGTHS}},
            fh, indent=1)
        fh.write("\n")
    print(path)
