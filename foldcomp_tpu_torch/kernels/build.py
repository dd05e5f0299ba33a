"""Build and load the CUDA kernels: nvcc into a plain C shared library,
bound with ctypes.

The library is compiled on first use from every csrc/*.cu source
(fused_decode.cu: k1-k3 and the bb wire's backbone kernel,
fused_encode.cu: k4 with the encode epilogue) into kernels/build/, named
by a hash of the sources and the flags, so an edited source or flag set
builds a new library and never loads a stale one. One nvcc per source
runs at once, then one link. The build writes to temporary names and
renames the library into place, so processes that build at once do not
see each other's half-written file.

Flags: sm_90a (Hopper), -O3, and -fmad=false with no --use_fast_math, so
the float operation order of the JAX reference holds (no contraction into
FMA, IEEE division and square root, full-precision sinf/cosf); -Xptxas -v,
so the compilers' output (BUILD_LOG) gives each kernel's registers, stack
frame, spills and shared memory.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np
import torch

from ..backend import nvcc_path
from ..core import tables

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_HERE, "csrc", f)
                for f in ("fused_decode.cu", "fused_encode.cu"))
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB = None
_TABLES_ON = set()       # CUDA device indices whose constant tables are set
BUILD_SECONDS = None     # wall time of the build this process ran, if any
BUILD_LOG = None         # the compilers' output of that build


class KernelBuildError(RuntimeError):
    pass


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR,
                        f"libfoldcomp_kernels_{h.hexdigest()[:16]}.so")


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


def build() -> str:
    """Compile the library unless this source and flag set is built.
    Raises KernelBuildError with nvcc's output on failure."""
    global BUILD_SECONDS, BUILD_LOG
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = nvcc_path()
    if nvcc is None:
        raise KernelBuildError("nvcc not found (CUDA_HOME, /usr/local/cuda "
                               "or PATH): cannot build the CUDA kernels")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, src]
                        for o, src in zip(objs, SOURCES)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, path)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = log
    return path


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fd_set_tables.argtypes = [vp, vp, vp, vp, ci, ci]
    lib.fd_tails.argtypes = [ci, vp, vp, vp, ci, vp]
    lib.fd_backbone.argtypes = [vp] * 17 + [ci, ci, ci, vp]
    lib.fd_backbone_bb.argtypes = [vp] * 16 + [ci, ci, ci, ci, vp]
    lib.fd_sidechain.argtypes = [vp] * 8 + [ci, ci, ci, vp]
    lib.fe_encode.argtypes = [vp] * 8 + [ci] + [vp] * 6 + [ci, ci, vp]
    lib.fe_acos.argtypes = [vp, vp, ci, vp]
    for fn in (lib.fd_set_tables, lib.fd_tails, lib.fd_backbone,
               lib.fd_backbone_bb, lib.fd_sidechain, lib.fe_encode,
               lib.fe_acos):
        fn.restype = ci
    return lib


def load(device=None):
    """The bound library, built, with its constant tables set on `device`
    (a CUDA torch.device or index; None: the current device). __constant__
    memory is per device, so the tables are copied to each device the first
    time it is asked for. Raises on any failure; there is no fallback."""
    global _LIB
    dev = torch.device("cuda" if device is None else device)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(build()))
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
