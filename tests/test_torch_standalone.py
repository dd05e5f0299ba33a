"""foldcomp_tpu_torch stands on its own, and its copies of foldcomp_tpu's
host layers give the same results as the originals.

Independence, shown mechanically: an AST scan of every module of the port
and of chip_smoke.py for an import of foldcomp_tpu or JAX at any depth, and
a subprocess whose import system refuses foldcomp_tpu and JAX while the
port's CLI runs its seven modes on the CPU, and `decompress --fast` on the
backbone-only wire as well.

Copy fidelity: on a seeded synthetic corpus at tests/test_wclass.py scale
(lengths 26-240), each copied stage against its foldcomp_tpu original, down
to the byte: the FCZ serializer and parser, the exact encoder and decoder,
the PDB writer, the ragged-lane pack, the bb wire's host stitch, the
device-encode parse and host finish, the database writer, verify's
synthetic structures, and the CLI's exact routes.
"""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_property_roundtrip import synthesize as orig_synthesize

from foldcomp_tpu.codec import batch as tpu_batch
from foldcomp_tpu.codec import decoder as tpu_decoder
from foldcomp_tpu.codec import encoder as tpu_encoder
from foldcomp_tpu.codec import fcz as tpu_fcz
from foldcomp_tpu.io import db as tpu_db
from foldcomp_tpu.io import pdb as tpu_pdb
from foldcomp_tpu_torch.codec import batch_host as port_batch
from foldcomp_tpu_torch.codec import decoder as port_decoder
from foldcomp_tpu_torch.codec import encoder as port_encoder
from foldcomp_tpu_torch.codec import fcz as port_fcz
from foldcomp_tpu_torch.io import db as port_db
from foldcomp_tpu_torch.io import pdb as port_pdb
from foldcomp_tpu_torch.verify import on_milli_grid, synthesize

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "foldcomp_tpu_torch"
FORBIDDEN = ("foldcomp_tpu", "jax")
# test_wclass.py scale: several anchor-tail widths and a repeat
LENGTHS = (26, 60, 151, 240, 60)


def _forbidden_imports(path):
    """(line, module) of every import of foldcomp_tpu[.*] or jax[.*] in the
    file, at any depth (inside functions too)."""
    tree = ast.parse(path.read_text(), str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        bad += [(node.lineno, m) for m in mods
                if m.split(".")[0] in FORBIDDEN]
    return bad


# Runs the port's CLI with an import system that refuses foldcomp_tpu and
# JAX. argv[1] is the work directory with pdbs/ in it.
_BLOCKED_RUN = textwrap.dedent("""
    import contextlib, importlib.abc, io, os, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("foldcomp_tpu", "jax"):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    from foldcomp_tpu_torch import cli

    os.chdir(sys.argv[1])
    runs = [
        ["compress", "--fast", "pdbs", "db_fast", "--db"],
        ["decompress", "--fast", "db_fast", "pdb_fast", "--db"],
        ["compress", "pdbs", "fcz_dir"],
        ["decompress", "fcz_dir", "pdb_dir"],
        ["extract", "--plddt", "fcz_dir", "plddt.txt"],
        ["check", "fcz_dir"],
        ["rmsd", "pdbs/p0.pdb", "pdb_dir/p0.pdb"],
        ["decompress", "--fast", "db_fast", "pdb_fast_bb", "--db"],
    ]
    for i, argv in enumerate(runs):
        if i == 7:      # the last run takes the backbone-only wire
            os.environ["FOLDCOMP_TPU_WIRE"] = "bb"
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        if rc != 0:
            sys.exit(f"{argv}: rc {rc}")
        print(argv[0], "ok", out.getvalue().strip().splitlines()[-1:])
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("foldcomp_tpu", "jax", "jaxlib"))
    sys.exit(f"loaded {bad}" if bad else 0)
""")


def _write_pdbs(d, lengths=LENGTHS):
    """3-decimal PDB files p<i>.pdb of the synthetic corpus."""
    d.mkdir(parents=True, exist_ok=True)
    for i, n in enumerate(lengths):
        atoms = port_decoder.decode(port_encoder.encode(synthesize(n, i)))
        (d / f"p{i}.pdb").write_text(port_pdb.format_pdb(atoms, f"p{i}"))
    return d


@pytest.mark.parametrize("case", ["ast_scan", "blocked_imports"])
def test_port_imports_nothing_of_foldcomp_tpu(case, tmp_path):
    if case == "ast_scan":
        files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
        assert len(files) > 20
        bad = {str(f.relative_to(REPO)): b for f in files
               if (b := _forbidden_imports(f))}
        assert not bad, bad
        return
    _write_pdbs(tmp_path / "pdbs", LENGTHS[:3])
    env = dict(os.environ, PYTHONPATH=str(REPO), FOLDCOMP_TORCH_DEVICE="cpu")
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count(" ok ") == 8, r.stdout
    assert len(list((tmp_path / "pdb_dir").iterdir())) == 3
    assert (tmp_path / "pdb_fast_bb").exists()


@pytest.fixture(scope="module")
def corpus():
    """Synthetic structures (one off the millimetre grid, the rest on it)
    and their exact FCZ payloads from the JAX package's encoder."""
    structs = [synthesize(n, i) for i, n in enumerate(LENGTHS)]
    structs = [structs[0]] + [on_milli_grid(a) for a in structs[1:]]
    return structs, [tpu_encoder.encode(a) for a in structs]


def _assert_same(a, b, where=""):
    """Equal values, recursively through dicts, lists and dataclasses;
    arrays equal in dtype, shape and bytes (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), where
        assert a.tobytes() == b.tobytes(), where
    elif hasattr(a, "__dataclass_fields__"):
        _assert_same(vars(a), vars(b), where)
    else:
        assert a == b or (a != a and b != b), where


def _cli(pkg, args, cwd):
    env = {k: v for k, v in os.environ.items()
           if k != "FOLDCOMP_TORCH_DEVICE"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-m", pkg, *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (pkg, args, r.stderr[-3000:])
    return r


def _db_files(path):
    return {p.name[len(path.name):]: p.read_bytes()
            for p in path.parent.glob(path.name + "*")}


def _fidelity_case(case, corpus, tmp_path):
    structs, fczs = corpus
    if case == "fcz_serialize_parse":
        blobs = [tpu_fcz.serialize(f) for f in fczs]
        assert [port_fcz.serialize(f) for f in fczs] == blobs
        for blob in blobs:
            _assert_same(vars(port_fcz.parse(blob)),
                         vars(tpu_fcz.parse(blob)))
    elif case == "exact_encode":
        for a, f in zip(structs, fczs):
            assert port_fcz.serialize(port_encoder.encode(a)) == \
                tpu_fcz.serialize(f)
            assert port_fcz.serialize(port_encoder.encode(
                a, anchor_threshold=200)) == tpu_fcz.serialize(
                    tpu_encoder.encode(a, anchor_threshold=200))
    elif case == "exact_decode":
        for f in fczs:
            for alt in (False, True):
                _assert_same(vars(port_decoder.decode(f, use_alt_order=alt)),
                             vars(tpu_decoder.decode(f, use_alt_order=alt)))
    elif case == "format_pdb":
        for f in fczs:
            atoms = tpu_decoder.decode(f)
            assert port_pdb.format_pdb(atoms, f.title) == \
                tpu_pdb.format_pdb(atoms, f.title)
    elif case == "pack_decode_batch_lanes":
        for native in (True, False):
            got = port_batch.pack_decode_batch_lanes(fczs, native=native)
            want = tpu_batch.pack_decode_batch_lanes(fczs, native=native)
            _assert_same(got[0], want[0], f"arrays native={native}")
            for gm, wm in zip(got[1], want[1]):
                _assert_same(vars(gm), vars(wm), "meta")
    elif case == "gather_a14_bb":
        # the bb wire's host stitch: the same host ("bb", off, ca) rows and
        # metas through both copies
        from foldcomp_tpu_torch.codec import batch as port_dev
        arrays, metas = port_dev.pack_decode_wire(fczs, bb_wire=True)
        outs = port_dev._outs_to_host(port_dev._seg_decode_arrays(
            port_dev.arrays_to_torch(arrays, "cpu")))
        assert outs[0] == "bb" and outs[1].shape[2] == 6
        for m, f in zip(metas, fczs):
            assert m.sc_codes.tobytes() == \
                np.asarray(f.sc_codes, np.uint8).tobytes()
            _assert_same(port_batch._gather_a14(outs, m),
                         tpu_batch._gather_a14(outs, m))
    elif case == "encode_pdb_device":
        for a in structs:
            text = tpu_pdb.format_pdb(a, "x").encode()
            _assert_same(port_batch.encode_pdb_device(text, 25),
                         tpu_batch.encode_pdb_device(text, 25))
            _assert_same(port_batch.fragment_to_tensors(a),
                         tpu_batch.fragment_to_tensors(a))
    elif case == "finish_encode_device":
        from foldcomp_tpu_torch.codec.batch import encode_submit
        tensors = [port_batch.fragment_to_tensors(a) for a in structs[1:]]
        tensors.append(port_batch.fragment_to_tensors(synthesize(3, 9)))
        h = encode_submit([t[:3] for t in tensors], [t[3] for t in tensors],
                          device="cpu")
        parts = {k: v.numpy() for k, v in h["parts"].items()}
        args = (h["atom14"], h["res_code"], h["tf_ca"], h["res_mask"])
        _assert_same(port_batch.finish_encode_device(parts, *args),
                     tpu_batch.finish_encode_device(parts, *args))
    elif case == "database":
        for mod, name in ((port_db, "port"), (tpu_db, "jax")):
            w = mod.DatabaseWriter(str(tmp_path / name))
            for i, f in enumerate(fczs):
                w.append(tpu_fcz.serialize(f), len(fczs) - i, f"e{i}")
            w.close()
        got, want = _db_files(tmp_path / "port"), _db_files(tmp_path / "jax")
        assert sorted(got) == sorted(want) and len(got) >= 3
        assert got == want
        r = port_db.DatabaseReader(str(tmp_path / "jax"))
        try:
            assert [bytes(d) for _, _, d in r.entries()] == \
                [tpu_fcz.serialize(fczs[len(fczs) - k]) for k in
                 range(1, len(fczs) + 1)]
        finally:
            r.close()
    elif case == "synthesize":
        # the corpus behind tests/data/torch_port_ref_dev.json, which
        # tests/test_torch_decode_slice.py writes from the original
        for n, seed in ((3, 9), *zip(LENGTHS, range(len(LENGTHS)))):
            _assert_same(vars(synthesize(n, seed)),
                         vars(orig_synthesize(n, seed)))
    elif case.startswith("cli_"):
        _write_pdbs(tmp_path / "pdbs")
        cmds = {
            "cli_compress": [["compress", "pdbs", "out", "--db"]],
            "cli_db_to_db": [["compress", "pdbs", "in_db", "--db"],
                             ["decompress", "in_db", "out", "--db"]],
            "cli_extract": [["compress", "pdbs", "in_db", "--db"],
                            ["extract", "--fasta", "in_db", "out"]],
        }[case]
        for pkg in ("foldcomp_tpu_torch", "foldcomp_tpu"):
            work = tmp_path / pkg
            work.mkdir()
            (work / "pdbs").symlink_to(tmp_path / "pdbs")
            for args in cmds:
                _cli(pkg, args + (["--exact"] if pkg == "foldcomp_tpu"
                                  else []), work)
        got = _db_files(tmp_path / "foldcomp_tpu_torch" / "out")
        want = _db_files(tmp_path / "foldcomp_tpu" / "out")
        assert got and got == want
    else:
        raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "fcz_serialize_parse", "exact_encode", "exact_decode", "format_pdb",
    "pack_decode_batch_lanes", "gather_a14_bb", "encode_pdb_device",
    "finish_encode_device",
    "database", "synthesize", "cli_compress", "cli_db_to_db", "cli_extract"])
def test_copy_matches_foldcomp_tpu(case, corpus, tmp_path):
    _fidelity_case(case, corpus, tmp_path)
