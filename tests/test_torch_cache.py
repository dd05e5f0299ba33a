"""The port's user cache (backend.cache_dir) and what it keeps, on the CPU:
the kernel library (kernels/build.py) and the hybrid guard's warmup
estimate (parallel/hybrid.py), as the JAX package keeps its compile cache,
its AOT artifacts and its estimate (foldcomp_tpu/backend.py:12-40,
kernels/aot.py:55-64,170-180, parallel/hybrid.py:149-157).

nvcc is a stub: a Python script at CUDA_HOME/bin/nvcc that appends one
line a run to a counter file and writes its -o file; for -shared a real
library, built with cc from a generated C file that exports every symbol
build._bind names. The cases: the cache root (default, moved, off); the
library's name and the toolkit; four processes on a cold cache build once;
pruning to build.KEEP, and the mtime a load refreshes; a broken library
rebuilt once, and a failed rebuild raising KernelBuildError with both
errors; the cache off, building into a temporary directory removed at
exit; the warmup estimate under the root; a harness's seeded child cache;
the CLI refusing before it opens an output; the console script.
"""
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import tomllib
import types

import pytest

from foldcomp_tpu_torch import backend, cli
from foldcomp_tpu_torch.codec import batch as port_batch
from foldcomp_tpu_torch.kernels import build
from foldcomp_tpu_torch.parallel.hybrid import (COLD_HORIZON_S,
                                                ChunkController,
                                                EndgameGuard)

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = pathlib.Path(build.__file__).resolve().parents[1]

_STUB = """#!{python}
import os, subprocess, sys, time
args = sys.argv[1:]
if args == ["--version"]:
    print({version!r})
    sys.exit(0)
with open({counter!r}, "a") as fh:
    fh.write(("link" if "-shared" in args else "compile") + "\\n")
if os.path.exists({fail!r}):
    print("stub nvcc: told to fail")
    sys.exit(1)
out = args[args.index("-o") + 1]
if "-shared" in args:
    subprocess.run(["cc", "-shared", "-fPIC", "-o", out, {csrc!r}],
                   check=True)
else:
    time.sleep(0.3)
    with open(out, "wb") as fh:
        fh.write(b"object")
"""


def _symbols():
    """The names build._bind gives types to."""
    names = set()

    class Lib:
        def __getattr__(self, name):
            names.add(name)
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    build._bind(Lib())
    return sorted(names)


def _c_library(path, symbols):
    """A shared library at `path` exporting `symbols`, each returning 0."""
    src = pathlib.Path(str(path) + ".c")
    src.write_text("".join(f"int {s}(void) {{ return 0; }}\n"
                           for s in symbols))
    subprocess.run(["cc", "-shared", "-fPIC", "-o", str(path), str(src)],
                   check=True)
    src.unlink()


class Toolkit:
    """A stub CUDA toolkit and a cache in `tmp`, set in this process's
    environment (CUDA_HOME, FOLDCOMP_TPU_TORCH_CACHE) and in `env`, the
    environment of a child."""

    def __init__(self, tmp, monkeypatch):
        self.tmp = tmp
        self.home = tmp / "cuda"
        (self.home / "bin").mkdir(parents=True)
        self.nvcc = self.home / "bin" / "nvcc"
        self.counter = tmp / "nvcc_runs"
        self.fail = tmp / "nvcc_fails"
        self.csrc = tmp / "kernels.c"
        self.csrc.write_text("".join(f"int {s}(void) {{ return 0; }}\n"
                                     for s in _symbols()))
        self.cache = tmp / "cache"
        self.write_nvcc("Cuda compilation tools, release 12.8")
        monkeypatch.setenv("CUDA_HOME", str(self.home))
        monkeypatch.setenv(backend.CACHE_ENV, str(self.cache))
        # the module's state as a fresh process has it
        monkeypatch.setattr(build, "_TOOLKITS", {})
        monkeypatch.setattr(build, "_TMP_DIR", None)
        monkeypatch.setattr(build, "BUILD_SECONDS", None)
        monkeypatch.setattr(build, "BUILD_LOG", None)
        self.env = dict(os.environ, PYTHONPATH=str(REPO))

    def write_nvcc(self, version):
        self.nvcc.write_text(_STUB.format(
            python=sys.executable, version=version,
            counter=str(self.counter), fail=str(self.fail),
            csrc=str(self.csrc)))
        self.nvcc.chmod(0o755)

    def runs(self):
        """The stub's runs so far, by kind."""
        lines = self.counter.read_text().split() \
            if self.counter.exists() else []
        return {k: lines.count(k) for k in ("compile", "link")}

    def libraries(self):
        d = self.cache / "kernels"
        return sorted(p.name for p in d.iterdir()
                      if p.name.startswith(build.PREFIX))


ONE_BUILD = {"compile": len(build.SOURCES), "link": 1}


@pytest.fixture
def toolkit(tmp_path, monkeypatch):
    return Toolkit(tmp_path, monkeypatch)


def _not_in_package(path):
    return not pathlib.Path(path).resolve().is_relative_to(PACKAGE)


@pytest.mark.parametrize("case", ["default", "moved", "off", "empty"])
def test_cache_root(case, tmp_path, monkeypatch):
    """~/.cache/foldcomp_tpu_torch, FOLDCOMP_TPU_TORCH_CACHE, or None for
    "0" and ""; read at each call, never the JAX package's variable. The
    library's path lies under <root>/kernels, or with the cache off in a
    temporary directory; never under the package."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("FOLDCOMP_TPU_JAX_CACHE", str(tmp_path / "jax"))
    monkeypatch.setattr(build, "_TMP_DIR", None)
    want = {"default": tmp_path / "home" / ".cache" / "foldcomp_tpu_torch",
            "moved": tmp_path / "moved", "off": None, "empty": None}[case]
    if case == "default":
        monkeypatch.delenv(backend.CACHE_ENV, raising=False)
    else:
        monkeypatch.setenv(backend.CACHE_ENV, {
            "moved": str(tmp_path / "moved"), "off": "0", "empty": ""}[case])
    got = backend.cache_dir()
    assert got == (None if want is None else str(want))
    lib = build.library_path()
    assert _not_in_package(lib)
    if want is None:
        assert pathlib.Path(lib).parent == pathlib.Path(build.kernels_dir())
        assert pathlib.Path(lib).parent.parent == pathlib.Path(
            tempfile.gettempdir())
    else:
        assert pathlib.Path(lib).parent == want / "kernels"
    # a child's cache, from its environment alone
    assert backend.cache_dir({"HOME": "/h"}) == "/h/.cache/foldcomp_tpu_torch"
    assert backend.cache_dir({"HOME": "/h", backend.CACHE_ENV: "0"}) is None


def test_library_name_follows_the_toolkit(toolkit):
    """The name hashes the sources, the flags and the toolkit: the same
    nvcc gives the same name, one with another version text another."""
    first = build.library_path()
    build._TOOLKITS.clear()
    assert build.library_path() == first
    toolkit.write_nvcc("Cuda compilation tools, release 12.9")
    build._TOOLKITS.clear()
    second = build.library_path()
    assert second != first
    assert pathlib.Path(first).parent == pathlib.Path(second).parent == \
        toolkit.cache / "kernels"


_CONTENDER = """\
import os, sys, time
from foldcomp_tpu_torch.kernels import build
open(sys.argv[1] + f".{os.getpid()}", "w").close()
while not os.path.exists(sys.argv[2]):
    time.sleep(0.01)
build.open_library()
print(build.BUILD_SECONDS is not None)
"""


def test_cold_cache_builds_once_across_processes(toolkit):
    """Four processes open the library on a cold cache at once: the stub's
    compile and link steps run once in all, one process built, and the
    other three loaded what it wrote."""
    ready, go = toolkit.tmp / "ready", toolkit.tmp / "go"
    procs = [subprocess.Popen([sys.executable, "-c", _CONTENDER, str(ready),
                               str(go)], env=toolkit.env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    try:
        deadline = time.monotonic() + 60
        while len(list(toolkit.tmp.glob("ready.*"))) < 4:
            assert time.monotonic() < deadline and \
                all(p.poll() is None for p in procs)
            time.sleep(0.01)
        go.touch()
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert sorted(o.strip() for o, _ in outs) == ["False"] * 3 + ["True"]
    assert toolkit.runs() == ONE_BUILD
    assert toolkit.libraries() == [os.path.basename(build.library_path())]


def test_prune_keeps_the_newest_and_load_refreshes(toolkit):
    """After a build the directory keeps the build.KEEP most recently used
    libraries; a load refreshes its library's mtime."""
    d = toolkit.cache / "kernels"
    d.mkdir(parents=True)
    old = [d / f"{build.PREFIX}{i:016x}.so" for i in range(build.KEEP + 3)]
    for i, p in enumerate(old):
        p.write_bytes(b"old")
        os.utime(p, (1000 + i, 1000 + i))
    build.open_library()
    path = build.library_path()
    assert toolkit.runs() == ONE_BUILD
    assert toolkit.libraries() == sorted(
        [os.path.basename(path)] + [p.name for p in old[-(build.KEEP - 1):]])
    assert [p.name for p in d.iterdir()
            if p.suffix in (".o", ".tmp")] == []
    os.utime(path, (1, 1))
    build.open_library()
    assert toolkit.runs() == ONE_BUILD
    assert os.path.getmtime(path) > time.time() - 600


@pytest.mark.parametrize("kind", ["garbage", "missing_symbol"])
def test_broken_library_is_rebuilt_once(kind, toolkit):
    """A cached library that does not open (4 KiB of garbage) or lacks a
    symbol _bind names is deleted and rebuilt once, then opens."""
    path = pathlib.Path(build.library_path())
    path.parent.mkdir(parents=True)
    if kind == "garbage":
        path.write_bytes(bytes(range(256)) * 16)
    else:
        _c_library(path, _symbols()[:-1])
    lib = build.open_library()
    assert toolkit.runs() == ONE_BUILD
    assert build.BUILD_SECONDS is not None
    for name in _symbols():
        assert getattr(lib, name).restype is not None, name


def test_failed_rebuild_raises_both_errors(toolkit):
    """A garbage library whose rebuild fails: KernelBuildError names the
    open's error and the compiler's, and leaves no library behind."""
    path = pathlib.Path(build.library_path())
    path.parent.mkdir(parents=True)
    path.write_bytes(bytes(range(256)) * 16)
    toolkit.fail.touch()
    with pytest.raises(build.KernelBuildError) as err:
        build.open_library()
    msg = str(err.value)
    assert "did not load" in msg and str(path) in msg
    assert ("invalid ELF header" in msg or "file too short" in msg
            or "not an ELF" in msg), msg
    assert "stub nvcc: told to fail" in msg
    assert not path.exists()


def test_cache_off_builds_in_a_temporary_directory(toolkit):
    """FOLDCOMP_TPU_TORCH_CACHE=0: the library builds into a temporary
    directory of the process, removed at its exit; nothing under HOME."""
    home, tmp = toolkit.tmp / "home", toolkit.tmp / "t"
    home.mkdir()
    tmp.mkdir()
    r = subprocess.run(
        [sys.executable, "-c",
         "from foldcomp_tpu_torch.kernels import build\n"
         "build.open_library()\n"
         "print(build.library_path())\n"],
        env=dict(toolkit.env, HOME=str(home), TMPDIR=str(tmp),
                 **{backend.CACHE_ENV: "0"}),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    lib = pathlib.Path(r.stdout.strip())
    assert lib.parent.parent == tmp and not lib.parent.exists()
    assert toolkit.runs() == ONE_BUILD
    assert list(home.rglob("*")) == [] and not toolkit.cache.exists()


@pytest.mark.parametrize("case", ["moved", "off"])
def test_warmup_estimate_follows_the_cache(case, tmp_path, monkeypatch):
    """The guard's device_warmup.json lies under the cache root; with the
    cache off it is neither read nor written, and the cold horizon is
    COLD_HORIZON_S."""
    home = tmp_path / "home"
    default = home / ".cache" / "foldcomp_tpu_torch" / "device_warmup.json"
    default.parent.mkdir(parents=True)
    default.write_text('{"warmup_s": 9.0}')
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv(backend.CACHE_ENV,
                       str(tmp_path / "moved") if case == "moved" else "0")
    monkeypatch.delenv("FOLDCOMP_TPU_WARMUP_EST", raising=False)
    monkeypatch.setattr(port_batch, "DEVICE_WARMED", False)
    want = tmp_path / "moved" / "device_warmup.json"
    assert EndgameGuard._warmup_path() == (str(want) if case == "moved"
                                           else None)
    assert EndgameGuard.cold_horizon() == COLD_HORIZON_S
    g = EndgameGuard(ChunkController.create(str(tmp_path / "ctrl"), 4), 64,
                     512, lambda: 64)
    g._time = lambda: g.t0 + 2.5
    g.next_action()
    written = g.finalize()
    if case == "moved":
        assert written == str(want)
        assert abs(EndgameGuard.cold_horizon() - 2.5) < 0.2
    else:
        assert written is None
        assert EndgameGuard.cold_horizon() == COLD_HORIZON_S
        assert sorted(p.name for p in tmp_path.rglob("*.json")) == [
            "device_warmup.json"]
    assert default.read_text() == '{"warmup_s": 9.0}'


def test_seed_cache_links_the_library_into_a_childs_cache(toolkit,
                                                          monkeypatch):
    """build.seed_cache(env) puts this process's library into the cache a
    child started with `env` uses, without a second build; that child
    finds it under the name it computes. A child with the cache off gets
    nothing."""
    src = build.build()
    child = {"HOME": str(toolkit.tmp / "child"),
             "CUDA_HOME": str(toolkit.home)}
    dst = build.seed_cache(child)
    assert os.path.samefile(src, dst)
    assert build.seed_cache(child) == dst
    assert toolkit.runs() == ONE_BUILD
    assert build.seed_cache(dict(child, **{backend.CACHE_ENV: "0"})) is None
    monkeypatch.setenv("HOME", child["HOME"])
    monkeypatch.delenv(backend.CACHE_ENV)
    assert build.library_path() == dst
    build.open_library()
    assert toolkit.runs() == ONE_BUILD


@pytest.mark.parametrize("mode", ["decompress", "compress"])
def test_cli_refuses_before_opening_an_output(mode, tmp_path, monkeypatch,
                                              capsys):
    """`--fast` on a card whose kernels cannot be built: [Error] with
    KernelBuildError's text, exit 1, and no output opened."""
    import torch

    def fail(device=None):
        raise build.KernelBuildError("nvcc failed (1): stub")

    monkeypatch.setattr(backend, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(build, "load", fail)
    src = tmp_path / "in.pdb"
    src.write_text("")
    out = tmp_path / "out"
    assert cli.main([mode, "--fast", str(src), str(out), "--db"]) == 1
    assert "[Error] --fast: KernelBuildError: nvcc failed (1): stub" in \
        capsys.readouterr().err
    assert list(tmp_path.iterdir()) == [src]


def test_console_script_resolves():
    """pyproject.toml names the port's console script beside the JAX
    package's, and its target is the port's CLI entry."""
    with open(REPO / "pyproject.toml", "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    assert scripts["foldcomp_tpu"] == "foldcomp_tpu.cli:main"
    module, _, attr = scripts["foldcomp_tpu_torch"].partition(":")
    assert module == "foldcomp_tpu_torch.cli"
    assert getattr(__import__(module, fromlist=[attr]), attr) is cli.main
