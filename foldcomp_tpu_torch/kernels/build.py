"""Build and load the CUDA kernels: nvcc into a plain C shared library,
bound with ctypes.

The library is compiled on first use from every csrc/*.cu source
(fused_decode.cu: k0-k3 and the bb wire's backbone kernel,
fused_encode.cu: k4 with the encode epilogue) into the port's user cache,
<cache>/kernels/ (backend.cache_dir: FOLDCOMP_TPU_TORCH_CACHE, else
~/.cache/foldcomp_tpu_torch), never into the package, which may lie in an
install the user cannot write. Its name hashes the sources, the flags and
the toolkit (nvcc's resolved path, size and mtime), so an edited source,
another flag set or another CUDA toolkit builds a new library and never
loads a stale one. With the cache off (FOLDCOMP_TPU_TORCH_CACHE=0) the
library builds into a temporary directory of the process, removed at
exit, and nothing is kept.

One nvcc per source runs at once, then one link. Processes that find the
cache cold together (the ranks of spawn_ranks, two CLI jobs) build once:
the build runs under an exclusive flock on the directory's build.lock,
and a process that waited for it finds the library there. The build still
writes temporary names and renames the library into place, so where flock
is only advisory (some network file systems) no process loads a
half-written file; the lock only saves the duplicate builds. After a
build the directory keeps the newest KEEP libraries, and every load
refreshes its library's mtime, so the pruning is least recently used. A
library that does not open or bind (a truncated copy, one from another
toolkit) is deleted and rebuilt once under the lock; if that fails too,
KernelBuildError carries both errors. There is no fallback to the plain
versions. Building and opening need no card and no torch; load() sets the
kernels' tables on a card.

Flags: sm_90a (Hopper), -O3, and -fmad=false with no --use_fast_math, so
the float operation order of the JAX reference holds (no contraction into
FMA, IEEE division and square root, full-precision sinf/cosf); -Xptxas -v,
so the compilers' output (BUILD_LOG) gives each kernel's registers, stack
frame, spills and shared memory.
"""
from __future__ import annotations

import _ctypes
import atexit
import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np

from ..backend import cache_dir, nvcc_path
from ..core import tables

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_HERE, "csrc", f)
                for f in ("fused_decode.cu", "fused_encode.cu"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
PREFIX = "libfoldcomp_kernels_"
# Libraries a cache directory keeps after a build, the most recently used
# first. Each is one set of sources, flags and toolkit, and serves every
# shape: a user who moves between a few checkouts or toolkits keeps each
# of them built. (The JAX package keeps 24 artifacts of each kind,
# foldcomp_tpu/kernels/aot.py:45-50, one for each traced shape.)
KEEP = 8

_LOCK = threading.RLock()
_LIB = None
_TABLES_ON = set()       # CUDA device indices whose constant tables are set
_TMP_DIR = None          # the build directory with the cache off
_TOOLKITS = {}           # nvcc's path -> its identity, read once a process
BUILD_SECONDS = None     # wall time of the build this process ran, if any
BUILD_LOG = None         # the compilers' output of that build


class KernelBuildError(RuntimeError):
    pass


def kernels_dir() -> str:
    """<cache>/kernels; with the cache off a temporary directory of this
    process, removed at exit."""
    global _TMP_DIR
    root = cache_dir()
    if root is not None:
        return os.path.join(root, "kernels")
    with _LOCK:
        if _TMP_DIR is None:
            _TMP_DIR = tempfile.mkdtemp(prefix="foldcomp_tpu_torch_kernels_")
            atexit.register(shutil.rmtree, _TMP_DIR, True)
    return _TMP_DIR


def _toolkit(nvcc) -> str:
    """The identity of the toolkit in the library's name: nvcc's resolved
    path, size and mtime (a stat, no process)."""
    if nvcc not in _TOOLKITS:
        if nvcc is None:
            _TOOLKITS[nvcc] = "no nvcc"
        else:
            real = os.path.realpath(nvcc)
            st = os.stat(real)
            _TOOLKITS[nvcc] = f"{real}\0{st.st_size}\0{st.st_mtime_ns}"
    return _TOOLKITS[nvcc]


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + b"\0"
                       + _toolkit(nvcc_path()).encode())
    for src in SOURCES:
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + b"\0" + fh.read())
    return os.path.join(kernels_dir(), f"{PREFIX}{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _build_lock(directory):
    """An exclusive flock on `directory`/build.lock, held by one process
    at a time; closing the file releases it, also when the process dies."""
    os.makedirs(directory, exist_ok=True)
    fd = os.open(os.path.join(directory, "build.lock"),
                 os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def _run_all(cmds) -> str:
    """Run the commands at once and return their output; raise
    KernelBuildError with the output of the first that fails. None is
    left running when this returns."""
    procs = []
    try:
        for c in cmds:
            procs.append(subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({p.returncode}): {' '.join(c)}\n{out}")
    return "".join(outs)


def _compile(path):
    """nvcc into `path` (the caller holds the build lock), then prune the
    directory. Raises KernelBuildError with nvcc's output on failure."""
    global BUILD_SECONDS, BUILD_LOG
    nvcc = nvcc_path()
    if nvcc is None:
        raise KernelBuildError("nvcc not found (CUDA_HOME, /usr/local/cuda "
                               "or PATH): cannot build the CUDA kernels")
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, src]
                        for o, src in zip(objs, SOURCES)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, path)
    finally:
        for f in (*objs, tmp):
            if os.path.exists(f):
                os.remove(f)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = log
    _prune(os.path.dirname(path))


def _prune(directory):
    """Delete all but the KEEP most recently used libraries (by mtime).
    A process that has a deleted library open keeps its mapping."""
    libs = sorted((os.path.join(directory, f) for f in os.listdir(directory)
                   if f.startswith(PREFIX) and f.endswith(".so")),
                  key=os.path.getmtime, reverse=True)
    for old in libs[KEEP:]:
        with contextlib.suppress(OSError):
            os.remove(old)


def build() -> str:
    """The library's path, compiled first unless this source, flag and
    toolkit set is built. Raises KernelBuildError with nvcc's output on
    failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    with _build_lock(os.path.dirname(path)):
        if not os.path.exists(path):     # else built while this one waited
            _compile(path)
    return path


def seed_cache(env) -> str | None:
    """Put this process's library (built first if need be) into the cache
    of a child process started with the environment `env`
    (backend.cache_dir(env)), as a hard link or, across file systems, a
    copy. The harnesses give their children a HOME of their own: a cold
    child then measures a fresh process with the library built, not a
    build. -> the path there; None when that child keeps no cache."""
    root = cache_dir(env)
    if root is None:
        return None
    src = build()
    dst = os.path.join(root, "kernels", os.path.basename(src))
    if os.path.exists(dst):
        return dst
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    tmp = f"{dst}.{os.getpid()}.tmp"
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    os.replace(tmp, dst)
    return dst


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fd_set_tables.argtypes = [vp, vp, vp, vp, ci, ci]
    lib.fd_prep.argtypes = [ci, vp, vp, vp]
    lib.fd_tails.argtypes = [ci, vp, vp, vp, ci, vp]
    lib.fd_backbone.argtypes = [vp] * 17 + [ci, ci, ci, vp]
    lib.fd_backbone_bb.argtypes = [vp] * 16 + [ci, ci, ci, ci, vp]
    lib.fd_sidechain.argtypes = [vp] * 8 + [ci, ci, ci, vp]
    lib.fe_encode.argtypes = [vp] * 8 + [ci] + [vp] * 6 + [ci, ci, vp]
    lib.fe_acos.argtypes = [vp, vp, ci, vp]
    for fn in (lib.fd_set_tables, lib.fd_prep, lib.fd_tails,
               lib.fd_backbone, lib.fd_backbone_bb, lib.fd_sidechain,
               lib.fe_encode, lib.fe_acos):
        fn.restype = ci
    return lib


def _open(path):
    """ctypes.CDLL(path), bound. A library that lacks a symbol is closed
    again: the dynamic loader hands out an open library by its path, so a
    rebuilt file at the same path would never be read."""
    lib = ctypes.CDLL(path)
    try:
        return _bind(lib)
    except AttributeError:
        _ctypes.dlclose(lib._handle)
        raise


def open_library():
    """The library, built if need be, opened and bound, its mtime
    refreshed. One that does not open (OSError) or lacks a symbol that
    _bind names (AttributeError) is deleted and rebuilt once under the
    build lock, unless another process has replaced it meanwhile; if the
    rebuild or its open fails too, KernelBuildError carries both errors.
    Needs no card."""
    path = build()
    try:
        lib = _open(path)
    except (OSError, AttributeError) as first:
        with _build_lock(os.path.dirname(path)):
            try:
                lib = _open(path)
            except (OSError, AttributeError):
                with contextlib.suppress(FileNotFoundError):
                    os.remove(path)
                try:
                    _compile(path)
                    lib = _open(path)
                except (KernelBuildError, OSError, AttributeError) as second:
                    raise KernelBuildError(
                        f"{path} did not load ({first}) and its rebuild "
                        f"failed: {second}") from second
    with contextlib.suppress(OSError):
        os.utime(path)
    return lib


def load(device=None):
    """The bound library (open_library), with its constant tables set on
    `device` (a CUDA torch.device or index; None: the current device).
    __constant__ memory is per device, so the tables are copied to each
    device the first time it is asked for. Raises on any failure; there is
    no fallback."""
    global _LIB
    import torch
    dev = torch.device("cuda" if device is None else device)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    with _LOCK:
        if _LIB is None:
            _LIB = open_library()
        if idx not in _TABLES_ON:
            arrs = [np.ascontiguousarray(tables.PRED32, np.int32),
                    np.ascontiguousarray(tables.BLEN32, np.float32),
                    np.ascontiguousarray(tables.BANG32, np.float32),
                    np.ascontiguousarray(tables.KERNEL_CONSTS, np.float32)]
            with torch.cuda.device(idx):
                err = _LIB.fd_set_tables(*(a.ctypes.data for a in arrs),
                                         len(tables.KERNEL_CONSTS),
                                         int(tables.PRO_CODE))
            if err != 0:
                raise RuntimeError(f"fd_set_tables on cuda:{idx} failed: "
                                   f"cudaError {err}")
            _TABLES_ON.add(idx)
    return _LIB
