"""The port's foldcomp-compatible Python API against foldcomp_tpu's, on CPU.

The cases of tests/test_api.py, on seeded synthetic structures
(verify.synthesize) in place of the reference fixtures: each call goes
through `foldcomp_tpu` and `foldcomp_tpu_torch` on the same inputs, and
the results must be identical (FCZ bytes, PDB text, the get_data dicts,
the database views). Also: setup() without httpx, and that importing the
port, and its API, loads neither torch nor JAX.
"""
import os
import pathlib
import subprocess
import sys

import pytest

import foldcomp_tpu
import foldcomp_tpu_torch
from foldcomp_tpu.api import FoldcompError as TpuError
from foldcomp_tpu_torch import api as port_api
from foldcomp_tpu_torch.api import FoldcompError as PortError
from foldcomp_tpu_torch.codec.encoder import encode
from foldcomp_tpu_torch.codec.fcz import serialize
from foldcomp_tpu_torch.io.db import DatabaseWriter
from foldcomp_tpu_torch.io.pdb import format_pdb
from foldcomp_tpu_torch.verify import on_milli_grid, synthesize

REPO = pathlib.Path(__file__).resolve().parents[1]
PKGS = (foldcomp_tpu, foldcomp_tpu_torch)
ERRORS = {foldcomp_tpu: TpuError, foldcomp_tpu_torch: PortError}
LENGTHS = (26, 60, 151, 240)


@pytest.fixture(scope="module")
def structures():
    return [on_milli_grid(synthesize(n, i)) for i, n in enumerate(LENGTHS)]


@pytest.fixture(scope="module")
def pdb_texts(structures):
    return [format_pdb(a, f"s{i}") for i, a in enumerate(structures)]


def _both(fn):
    """fn(package) for each package; the two results must be equal."""
    got, want = fn(foldcomp_tpu_torch), fn(foldcomp_tpu)
    assert got == want
    return got


def _multichain(text_a, text_b):
    """Two chains: text_b's ATOM lines relabelled as chain B."""
    b = "".join(ln[:21] + "B" + ln[22:] + "\n" for ln in text_b.splitlines()
                if ln.startswith("ATOM"))
    return text_a + b


def test_roundtrip(pdb_texts):
    for i, text in enumerate(pdb_texts):
        blob = _both(lambda m: m.compress(f"s{i}", text))
        assert blob[:4] == b"FCMP"
        name, pdb = _both(lambda m: m.decompress(blob))
        assert name == f"s{i}"
        n_in = sum(ln.startswith("ATOM") for ln in text.splitlines())
        assert sum(ln.startswith("ATOM") for ln in pdb.splitlines()) == n_in
    _both(lambda m: m.compress("s0", pdb_texts[0],
                               anchor_residue_threshold=7))


def test_compress_multichain_rejected(pdb_texts):
    multichain = _multichain(pdb_texts[1], pdb_texts[2])
    for m in PKGS:
        with pytest.raises(ERRORS[m], match="Multiple chains"):
            m.compress("mc", multichain)
    chains = _both(lambda m: m.split_pdb_by_chain(multichain))
    assert len(chains) == 2
    for chain_str in chains:
        assert _both(lambda m: m.compress("mc", chain_str))[:4] == b"FCMP"
    for m in PKGS:
        with pytest.raises(ERRORS[m], match="No ATOM lines"):
            m.compress("empty", "HEADER only\n")
        with pytest.raises(ERRORS[m]):
            m.decompress(b"not an fcz stream")


def test_get_data_from_fcz(structures):
    for a in structures:
        f = encode(a)
        blob = serialize(f)
        d = _both(lambda m: m.get_data(blob))
        n = len(d["residues"])
        assert n == f.n_residue
        assert len(d["phi"]) == len(d["b_factors"]) == n
        assert len(d["torsion_angles"]) == 3 * (n - 1)


def test_get_data_from_pdb(pdb_texts):
    for text in pdb_texts:
        d = _both(lambda m: m.get_data(text))
        n = len(d["residues"])
        assert len(d["phi"]) == n - 1
        assert len(d["torsion_angles"]) == 3 * n - 3
        assert len(d["bond_angles"]) == 3 * n - 2
    for m in PKGS:
        with pytest.raises(ValueError):
            m.get_data(b"")


@pytest.fixture(scope="module")
def fcz_db(structures, tmp_path_factory):
    """A database of the corpus' FCZ entries, names e<i>, keys reversed."""
    path = tmp_path_factory.mktemp("api_db") / "db"
    w = DatabaseWriter(str(path))
    for i, a in enumerate(structures):
        w.append(serialize(encode(a, title=f"t{i}")), len(structures) - i,
                 f"e{i}")
    w.close()
    return str(path)


@pytest.mark.parametrize("case", ["full", "ids", "raw", "missing"])
def test_open(fcz_db, case):
    if case == "full":
        def view(m):
            with m.open(fcz_db) as db:
                items = list(db)
                assert len(items) == len(db) == len(LENGTHS)
                return items, db[-1], db[1:3]
        items, _, _ = _both(view)
        assert all("ATOM" in pdb for _, pdb in items)
    elif case == "ids":
        def view(m):
            with m.open(fcz_db, ids=["e2", "e0", "nope"]) as db:
                return len(db), list(db)
        n, items = _both(view)
        assert n == 2 and [name for name, _ in items] == ["t2", "t0"]
    elif case == "raw":
        def view(m):
            with m.open(pathlib.Path(fcz_db), decompress=False) as db:
                return [db[i] for i in range(len(db))]
        raw = _both(view)
        assert all(isinstance(b, bytes) and b[:4] == b"FCMP" for b in raw)
    else:
        for m in PKGS:
            with pytest.raises(KeyError):
                m.open(fcz_db, ids=["nonexistent-id"], err_on_missing=True)
            with m.open(fcz_db) as db, pytest.raises(IndexError):
                db[len(LENGTHS)]


def test_setup_without_httpx(monkeypatch, tmp_path):
    """setup() imports httpx only when called, and says what is missing."""
    monkeypatch.setitem(sys.modules, "httpx", None)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(PortError, match="httpx"):
        foldcomp_tpu_torch.setup("afdb_swissprot")
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(AttributeError):
        foldcomp_tpu_torch.no_such_name


def test_import_loads_neither_torch_nor_jax():
    code = (
        "import sys\n"
        "import foldcomp_tpu_torch as fc\n"
        "assert not {'torch', 'jax'} & set(sys.modules), 'package'\n"
        "for name in ('compress', 'decompress', 'open', 'get_data',\n"
        "             'setup', 'setup_async', 'split_pdb_by_chain',\n"
        "             'FoldcompDatabase'):\n"
        "    getattr(fc, name)\n"
        "from foldcomp_tpu_torch.verify import synthesize\n"
        "from foldcomp_tpu_torch.io.pdb import format_pdb\n"
        "name, pdb = fc.decompress(fc.compress('x', format_pdb(\n"
        "    synthesize(40, 3), 'x')))\n"
        "assert name == 'x' and 'ATOM' in pdb\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'jaxlib', 'foldcomp_tpu'))\n"
        "sys.exit(f'loaded {bad}' if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert port_api.DEFAULT_ANCHOR_THRESHOLD == 25
