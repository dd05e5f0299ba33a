"""foldcomp_tpu_torch stands on its own, and its copies of foldcomp_tpu's
host layers give the same results as the originals.

Independence, shown mechanically: an AST scan of every module of the port
and of chip_smoke.py for an import of foldcomp_tpu or JAX at any depth, and
for code in a string (built for `python -c`) that names or imports one; a
subprocess whose import system refuses foldcomp_tpu and JAX while the
port's CLI runs its seven modes on the CPU, `decompress --fast` on the
backbone-only wire, the hybrid database route of both modes, `warmup` and
the sharded extract; one that refuses torch as well, in itself and in
every worker process it starts, while the hybrid scheduler and the sharded
extract run their process workers; and `python -m
foldcomp_tpu_torch.parallel.scaling --help` with foldcomp_tpu and JAX
refused.

Copy fidelity: on a seeded synthetic corpus at tests/test_wclass.py scale
(lengths 26-240), each copied stage against its foldcomp_tpu original, down
to the byte: the FCZ serializer and parser, the exact encoder and decoder,
the PDB writer, the ragged-lane pack, the bb wire's host stitch, the
device-encode parse and host finish, the database writer, verify's
synthetic structures, the CLI's exact routes, the Python API, the shard
layer (parallel/dist.py), the hybrid scheduler's host parts and the
scaling harness's synthetic batch and databases (parallel/scaling.py).
"""
import ast
import os
import pathlib
import re
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
from foldcomp_tpu_torch.parallel.hybrid import COLD_HORIZON_S
from foldcomp_tpu_torch.verify import on_milli_grid, synthesize

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "foldcomp_tpu_torch"
FORBIDDEN = ("foldcomp_tpu", "jax")
# test_wclass.py scale: several anchor-tail widths and a repeat
LENGTHS = (26, 60, 151, 240, 60)


# code in a string that names a module of foldcomp_tpu or imports it or JAX
FORBIDDEN_TEXT = re.compile(r"foldcomp_tpu\.|import foldcomp_tpu\b|"
                            r"from foldcomp_tpu\b|import jax\b|from jax\b")


def _forbidden_imports(path):
    """(line, module) of every import of foldcomp_tpu[.*] or jax[.*] in the
    file, at any depth (inside functions too), and (line, text) of every
    string constant but the docstrings that FORBIDDEN_TEXT matches: code
    built for another interpreter, which the import scan cannot see."""
    tree = ast.parse(path.read_text(), str(path))
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            bad += [(node.lineno, m.group())
                    for m in FORBIDDEN_TEXT.finditer(node.value)]
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
    # then the database jobs: warmup (its estimate under a scratch HOME),
    # the hybrid route with a device stream on the CPU (the link forced
    # ok, jobs above 2 entries) and the sharded extract
    hybrid_runs = [
        ["warmup", "db_fast"],
        ["decompress", "-t", "2", "db_fast", "pdb_hybrid", "--db"],
        ["compress", "-t", "2", "pdb_fast", "fcz_hybrid", "--db"],
        ["extract", "--plddt", "-t", "2", "db_fast", "plddt_sharded.txt"],
    ]
    for i, argv in enumerate(runs + hybrid_runs):
        if i == 7:      # the eighth run takes the backbone-only wire
            os.environ["FOLDCOMP_TPU_WIRE"] = "bb"
        if i == 8:
            os.environ.pop("FOLDCOMP_TPU_WIRE")
            os.environ.pop("FOLDCOMP_TPU_WARMUP_EST", None)
            os.environ.update(FOLDCOMP_TPU_LINK="ok",
                              HOME=os.path.abspath("home"))
            cli.FAST_DEFAULT_MIN = 2
        if i == 9:
            os.environ["FOLDCOMP_TPU_WARMUP_EST"] = "0"
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
    assert r.stdout.count(" ok ") == 12, r.stdout
    assert len(list((tmp_path / "pdb_dir").iterdir())) == 3
    assert (tmp_path / "pdb_fast_bb").exists()
    assert "device stream on cpu" in r.stderr
    for name in ("pdb_hybrid", "fcz_hybrid"):
        reader = port_db.DatabaseReader(str(tmp_path / name))
        assert len(reader) == 3
        reader.close()
    # the directory's records are named by path, the database's by name
    sharded, plain = ([ln for ln in (tmp_path / f).read_text().splitlines()
                       if not ln.startswith(">")]
                      for f in ("plddt_sharded.txt", "plddt.txt"))
    assert len(sharded) == 3 and sharded == plain
    assert [p.name for p in (tmp_path / "home").rglob("*.json")] == \
        ["device_warmup.json"]


# Installed by sitecustomize in a process and every worker process it
# starts: an import system that refuses foldcomp_tpu, JAX and torch.
_REFUSE_SITE = textwrap.dedent("""
    import importlib.abc, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("foldcomp_tpu", "jax", "jaxlib",
                                      "torch"):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
""")

# The process routes (no native library, FOLDCOMP_TPU_NO_NATIVE=1): the
# hybrid scheduler's native workers and the sharded extract's workers,
# started with `python -c`, in a work directory argv[1] with an FCZ db.
_WORKER_RUN = textwrap.dedent("""
    import contextlib, os, sys
    from foldcomp_tpu_torch import cli
    from foldcomp_tpu_torch.parallel.hybrid import (ChunkController,
                                                    EndgameGuard,
                                                    run_hybrid_db)

    os.chdir(sys.argv[1])
    with contextlib.redirect_stdout(sys.stderr):
        rcs = [run_hybrid_db("decompress", "db", "out_hybrid", n_native=2,
                             chunk_entries=1, use_device=False),
               cli.main(["extract", "--plddt", "-t", "2", "db", "x.txt"])]
    guard = EndgameGuard(ChunkController.create("ctrl", 4), 1, 4,
                         lambda: 0)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in
                 ("foldcomp_tpu", "jax", "jaxlib", "torch"))
    print(rcs, guard.warmup_est, bad)
    sys.exit(1 if any(rcs) or bad else 0)
""")


def test_process_workers_import_no_torch(tmp_path, corpus):
    """The hybrid scheduler's and the sharded extract's worker processes,
    and the parent of a job without a device stream, run with torch,
    JAX and foldcomp_tpu refused."""
    _, fczs = corpus
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_REFUSE_SITE)
    w = port_db.DatabaseWriter(str(tmp_path / "db"))
    for i, f in enumerate(fczs[:3]):
        w.append(tpu_fcz.serialize(f), i, f"e{i}")
    w.close()
    env = {k: v for k, v in os.environ.items()
           if k != "FOLDCOMP_TPU_WARMUP_EST"}
    env.update(PYTHONPATH=f"{site}{os.pathsep}{REPO}",
               FOLDCOMP_TPU_NO_NATIVE="1", HOME=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", _WORKER_RUN, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.split() == ["[0,", "0]", str(COLD_HORIZON_S), "[]"]
    reader = port_db.DatabaseReader(str(tmp_path / "out_hybrid"))
    try:
        got = {k: bytes(d) for k, _, d in reader.entries()}
    finally:
        reader.close()
    assert got == {i: (tpu_pdb.format_pdb(tpu_decoder.decode(f), f.title)
                       .encode() + b"\x00")
                   for i, f in enumerate(fczs[:3])}
    assert (tmp_path / "x.txt").read_text().count(">") == 3


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
    elif case == "split_lanes_classes":
        # the width-class split of one pack, forced and at the default gate
        # (one class too few to save: None from both)
        arrays, metas = tpu_batch.pack_decode_batch_lanes(fczs)
        for kw in ({"min_save": -100.0}, {}):
            got = port_batch.split_lanes_classes(dict(arrays), metas, **kw)
            want = tpu_batch.split_lanes_classes(dict(arrays), metas, **kw)
            assert (got is None) == (want is None) == (not kw.get("min_save"))
            if got is not None:
                _assert_same(got[0], want[0], f"classes {kw}")
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
    elif case == "api":
        from foldcomp_tpu import api as tpu_api
        from foldcomp_tpu_torch import api as port_api
        for i, (a, f) in enumerate(zip(structs, fczs)):
            text = tpu_pdb.format_pdb(a, f"s{i}")
            blob = tpu_fcz.serialize(f)
            for fn in (lambda m: m.compress(f"s{i}", text),
                       lambda m: m.decompress(blob),
                       lambda m: m.get_data(blob),
                       lambda m: m.get_data(text),
                       lambda m: m.split_pdb_by_chain(text)):
                _assert_same(fn(port_api), fn(tpu_api))
    elif case == "dist":
        from foldcomp_tpu.parallel import dist as tpu_dist
        from foldcomp_tpu_torch.parallel import dist as port_dist
        for n in (0, 1, 7, 24, 100):
            for k in (1, 2, 3, 8):
                assert [port_dist.shard_range(n, s, k) for s in range(k)] \
                    == [tpu_dist.shard_range(n, s, k) for s in range(k)]
        fdb, pdb = tmp_path / "fcz_db", tmp_path / "pdb_db"
        wf, wp = tpu_db.DatabaseWriter(str(fdb)), tpu_db.DatabaseWriter(
            str(pdb))
        for i, (a, f) in enumerate(zip(structs, fczs)):
            wf.append(tpu_fcz.serialize(f), 9 - i, f"e{i}")
            wp.append(tpu_pdb.format_pdb(a, f"e{i}").encode() + b"\x00",
                      9 - i, f"e{i}")
        wf.close()
        wp.close()
        for mod, name in ((port_dist, "port"), (tpu_dist, "jax")):
            for s in range(3):
                mod.decompress_db_shard(str(fdb), str(tmp_path / f"d_{name}"),
                                        s, 3, fast=False)
                mod.compress_db_shard(str(pdb), str(tmp_path / f"c_{name}"),
                                      s, 3, fast=False)
                mod.extract_db_shard(str(fdb), str(tmp_path / f"x_{name}"),
                                     s, 3, ext_mode=1)
                mod.extract_db_shard(str(fdb), str(tmp_path / f"m_{name}"),
                                     s, 3, digits=2, merged=True)
            for kind in "dcx":
                assert mod.merge_shard_dbs(str(tmp_path / f"{kind}_{name}"),
                                           3) == len(fczs)
            mod.merge_shard_files(str(tmp_path / f"m_{name}"), 3)
        for kind in "dcxm":
            got = _db_files(tmp_path / f"{kind}_port")
            assert got and got == _db_files(tmp_path / f"{kind}_jax"), kind
    elif case == "hybrid_host":
        from foldcomp_tpu.parallel import hybrid as tpu_hybrid
        from foldcomp_tpu_torch.parallel import hybrid as port_hybrid
        fdb, pdb = tmp_path / "fcz_db", tmp_path / "pdb_db"
        wf, wp = tpu_db.DatabaseWriter(str(fdb)), tpu_db.DatabaseWriter(
            str(pdb))
        for i, (a, f) in enumerate(zip(structs, fczs)):
            wf.append(tpu_fcz.serialize(f), 100 + i, f"e{i}")
            wp.append(tpu_pdb.format_pdb(a, f"e{i}").encode() + b"\x00",
                      100 + i, f"e{i}")
        wf.close()
        wp.close()
        for mod, name in ((port_hybrid, "port"), (tpu_hybrid, "jax")):
            # the controller's file after the same claims
            ctrl = mod.ChunkController.create(str(tmp_path / f"k_{name}"),
                                              9)
            claims = [ctrl.take_front(), ctrl.take_back(), ctrl.take_back()]
            assert claims == [0, 8, 7] and ctrl.peek() == (1, 7)
            # a worker of each mode drains the front of a fresh list, the
            # mop-up finishes two claimed chunks (one entry of them done)
            # and steals the rest
            for mode, src in (("decompress", fdb), ("compress", pdb)):
                out = str(tmp_path / f"{mode}_{name}")
                cpath = out + ".ctrl"
                ctrl = mod.ChunkController.create(cpath, len(fczs))
                ctrl.take_back()
                ctrl.take_back()
                worker = (mod.native_decompress_worker
                          if mode == "decompress"
                          else mod.native_compress_worker)
                assert worker(str(src), out, 0, cpath, 1) == len(fczs) - 2
                reader = mod.DatabaseReader(str(src), use_lookup=True)
                writer = mod.DatabaseWriter(mod.shard_db_path(out, 1))
                ctrl = mod.ChunkController.create(cpath, len(fczs))
                mod._native_mop_up(mode, reader, writer, ctrl, 2, [2, 1],
                                   {4}, 25)
                writer.close()
                reader.close()
        for mode in ("decompress", "compress"):
            for s in (0, 1):
                shard = f"{mode}_port.{s}"
                got = _db_files(tmp_path / shard)
                assert got and got == _db_files(
                    tmp_path / f"{mode}_jax.{s}"), shard
        assert (tmp_path / "k_port").read_bytes() == \
            (tmp_path / "k_jax").read_bytes()
    elif case == "scaling_host":
        from foldcomp_tpu.parallel import scaling as tpu_scaling
        from foldcomp_tpu_torch.parallel import scaling as port_scaling
        for b, l, seed in ((3, 17, 0), (2, 40, 5)):
            _assert_same(port_scaling.synthetic_batch(b, l, seed),
                         tpu_scaling.synthetic_batch(b, l, seed))
        blobs = [tpu_fcz.serialize(f) + b"\x00" for f in fczs]
        _assert_same(port_scaling._mixed_variants(blobs, seed=3),
                     tpu_scaling._mixed_variants(blobs, seed=3))
        src = tmp_path / "src_db"
        w = tpu_db.DatabaseWriter(str(src))
        for i, blob in enumerate(blobs):
            w.append(blob, i, f"s{i}")
        w.close()
        for mixed in (False, True):
            totals = [mod.build_synthetic_db(str(tmp_path / f"{name}_{mixed}"),
                                             12, src_db=str(src),
                                             mixed=mixed, seed=1)
                      for mod, name in ((port_scaling, "port"),
                                        (tpu_scaling, "jax"))]
            assert totals[0] == totals[1]
            got = _db_files(tmp_path / f"port_{mixed}")
            assert got and got == _db_files(tmp_path / f"jax_{mixed}")
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
    "pack_decode_batch_lanes", "split_lanes_classes", "gather_a14_bb",
    "encode_pdb_device",
    "finish_encode_device",
    "database", "synthesize", "cli_compress", "cli_db_to_db", "cli_extract",
    "api", "dist", "hybrid_host", "scaling_host"])
def test_copy_matches_foldcomp_tpu(case, corpus, tmp_path):
    _fidelity_case(case, corpus, tmp_path)


_SCALING_HELP = textwrap.dedent("""
    import importlib.abc, runpy, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("foldcomp_tpu", "jax", "jaxlib"):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.argv = ["scaling", "--help"]
    runpy.run_module("foldcomp_tpu_torch.parallel.scaling",
                     run_name="__main__")
""")


def test_scaling_cli_help_without_jax():
    """`python -m foldcomp_tpu_torch.parallel.scaling --help`, with JAX and
    foldcomp_tpu refused by the import system."""
    r = subprocess.run([sys.executable, "-c", _SCALING_HELP],
                       env=dict(os.environ, PYTHONPATH=str(REPO)),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    for flag in ("--devices", "--multiprocess", "--hybrid-additivity",
                 "--src-db"):
        assert flag in r.stdout, flag
