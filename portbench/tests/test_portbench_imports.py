"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port. Names are compared whole, by their
top-level part: foldcomp_tpu_torch is not foldcomp_tpu."""
from __future__ import annotations

import ast
import subprocess
import sys

from portbench import harness, manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "foldcomp_tpu"}
PKG = manifest.ROOT / "portbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for p in PKG.rglob("*.py"):
        assert not set(_imports(p)) & FORBIDDEN, p


def test_reference_imports_nothing_of_the_port():
    for p in (PKG / "reference").rglob("*.py"):
        names = set(_imports(p))
        assert "foldcomp_tpu_torch" not in names, p
        assert names <= {"__future__", "ctypes", "math", "numpy", "struct",
                         "dataclasses", "os", "contextlib"}, (p, names)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "foldcomp_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "foldcomp_tpu.codec", sys)
    assert harness.forbidden_modules() == ["foldcomp_tpu"]


def test_a_run_loads_no_jax(tmp_path):
    """A tiny run in a fresh process: its modules, by top-level name."""
    code = (
        "import sys, time, os\n"
        "os.environ['FOLDCOMP_TPU_LINK'] = 'none'\n"
        "from portbench import harness\n"
        "from portbench.tests.tiny import TINY\n"
        "rc, res = harness.run_cell('swissprot.decompress_fast', 7, 0.3,"
        " False, time.perf_counter(), device='cpu', require_chip=False,"
        " overrides=TINY, workers=0)\n"
        "assert rc == 0 and res['correct'], res\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=manifest.ROOT, timeout=600,
                       env={**__import__("os").environ,
                            "FOLDCOMP_TPU_TORCH_CACHE": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-3000:]
    top = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "foldcomp_tpu_torch" in top
    assert not top & FORBIDDEN


def test_no_chip_no_result(tmp_path):
    """Without a CUDA card the command prints no result and fails."""
    r = subprocess.run([sys.executable, "-m", "portbench.run",
                        "--workload", "human.compress_fast", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=manifest.ROOT,
                       timeout=600)
    import torch
    if torch.cuda.is_available():
        return
    assert r.returncode == 3
    assert r.stdout.strip() == ""
