"""The port's `compress --fast` slice on CPU, end to end.

The port runs its plain PyTorch k4 and epilogue (device="cpu") through its
own submit/finish seam and foldcomp_tpu's shared host finish. The gate is
the repository's own: serialized FCZ bytes identical to the exact encoder
(codec/encoder.encode), on compact frames, frames with fewer than 4
residues, degenerate frames, frames off the millimetre grid (k4's f32
loader) and a protein longer than the JAX fused path's 1536-residue bound.
The CLI is held byte for byte, entry by entry, to the exact route and to
the JAX package's own `compress --fast` (fused kernel in interpret mode).
"""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from test_property_roundtrip import synthesize

from foldcomp_tpu.codec.batch import fragment_to_tensors
from foldcomp_tpu.codec.decoder import decode
from foldcomp_tpu.codec.encoder import encode as encode_exact
from foldcomp_tpu.codec.fcz import serialize
from foldcomp_tpu.io.db import DatabaseReader
from foldcomp_tpu.io.pdb import format_pdb
from foldcomp_tpu.native import get_lib
from foldcomp_tpu_torch.codec.batch import (encode_finish,
                                            encode_fragment_batch,
                                            encode_submit)
from foldcomp_tpu_torch.verify import on_milli_grid

REPO = pathlib.Path(__file__).resolve().parents[1]


def _degenerate(n, seed, at):
    a = on_milli_grid(synthesize(n, seed))
    ca = [i for i, nm in enumerate(a.atom_name) if nm == "CA"]
    a.coords[ca[at]] = a.coords[ca[at] - 1]
    return a


def _assert_bytes_exact(frames, device="cpu"):
    got = encode_fragment_batch(frames, device=device)
    assert len(got) == len(frames)
    for i, (a, g) in enumerate(zip(frames, got)):
        assert g is not None, i
        assert serialize(g) == serialize(encode_exact(a)), i


def _submit(frames, native_wire=True):
    tensors = [fragment_to_tensors(a) for a in frames]
    return encode_submit([t[:3] for t in tensors], [t[3] for t in tensors],
                         device="cpu", native_wire=native_wire)


@pytest.mark.parametrize("case", ["compact", "short", "degenerate",
                                  "off_grid", "long"])
def test_encode_bytes_match_exact_encoder(case):
    frames = {
        "compact": lambda: [on_milli_grid(synthesize(n, s))
                            for n, s in ((26, 0), (60, 1), (151, 2),
                                         (240, 3))],
        "short": lambda: [on_milli_grid(synthesize(n, s))
                          for n, s in ((2, 4), (3, 5), (3, 6), (40, 7))],
        "degenerate": lambda: [_degenerate(30, 5, 10), _degenerate(45, 6, 0),
                               _degenerate(33, 8, 32)],
        "off_grid": lambda: [synthesize(n, s) for n, s in
                             ((3, 9), (50, 10), (120, 11))],
        "long": lambda: [on_milli_grid(synthesize(1600, 12)),
                         on_milli_grid(synthesize(20, 13))],
    }[case]()
    route = _submit(frames)["wire"]
    assert route == ("f32" if case == "off_grid" else
                     "native" if get_lib() is not None else "numpy")
    _assert_bytes_exact(frames)


def test_native_and_numpy_wire_give_identical_parts():
    if get_lib() is None:
        pytest.skip("native library unavailable")
    frames = [on_milli_grid(synthesize(n, s))
              for n, s in ((12, 20), (70, 21), (33, 22))]
    native = _submit(frames)
    numpy_ = _submit(frames, native_wire=False)
    assert (native["wire"], numpy_["wire"]) == ("native", "numpy")
    for k, v in native["parts"].items():
        assert torch.equal(v, numpy_["parts"][k]), k
    a, b = encode_finish(native), encode_finish(numpy_)
    assert [serialize(f) for f in a] == [serialize(f) for f in b]


@pytest.fixture(scope="module")
def pdb_dir(tmp_path_factory):
    """PDB files of several lengths, 3-decimal coordinates."""
    d = tmp_path_factory.mktemp("encode_slice") / "pdbs"
    d.mkdir()
    for i, n in enumerate((26, 60, 151, 240, 7, 3)):
        atoms = decode(encode_exact(synthesize(n, seed=i)))
        (d / f"p{i}_L{n}.pdb").write_text(format_pdb(atoms, f"p{i}"))
    return d


def _cli(pkg, args, cwd, **env):
    full = {k: v for k, v in os.environ.items()
            if k != "FOLDCOMP_TORCH_DEVICE"}
    full.update(PYTHONPATH=str(REPO), **env)
    return subprocess.run([sys.executable, "-m", pkg, *args], cwd=cwd,
                          env=full, capture_output=True, text=True,
                          timeout=600)


def _read_db(path):
    reader = DatabaseReader(str(path))
    try:
        return {name: bytes(data) for _, name, data in reader.entries()}
    finally:
        reader.close()


def test_cli_compress_fast_matches_exact_and_jax_routes(pdb_dir):
    work = pdb_dir.parent
    runs = {
        "port": ("foldcomp_tpu_torch", ["--fast"],
                 {"FOLDCOMP_TORCH_DEVICE": "cpu"}),
        "port_numpy_wire": ("foldcomp_tpu_torch", ["--fast"],
                            {"FOLDCOMP_TORCH_DEVICE": "cpu",
                             "FOLDCOMP_TPU_PLANAR_WIRE": "0"}),
        "jax": ("foldcomp_tpu", ["--fast"],
                {"FOLDCOMP_TPU_FUSED_ENC": "interpret"}),
        "exact": ("foldcomp_tpu", [], {}),
    }
    dbs = {}
    for key, (pkg, fast, env) in runs.items():
        r = _cli(pkg, ["compress", *fast, "pdbs", f"db_{key}", "--db"],
                 work, **env)
        assert r.returncode == 0, (key, r.stderr[-3000:])
        dbs[key] = _read_db(work / f"db_{key}")
    names = sorted(f"p{i}_L{n}" for i, n in
                   enumerate((26, 60, 151, 240, 7, 3)))
    assert sorted(dbs["port"]) == names
    assert dbs["port"] == dbs["exact"]
    assert dbs["port_numpy_wire"] == dbs["exact"]
    assert dbs["port"] == dbs["jax"]


def test_cli_compress_fast_needs_a_card(pdb_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _cli("foldcomp_tpu_torch", ["compress", "--fast", "pdbs", "db_x",
                                    "--db"], pdb_dir.parent)
    assert r.returncode != 0
    assert "CUDA" in r.stderr
    assert not (pdb_dir.parent / "db_x").exists()


def test_finish_handles_no_live_fragments():
    h = encode_submit([None, None], [{}, {}], device="cpu")
    assert encode_finish(h) == [None, None]
