"""Device resolution, device description and the port's user cache.

The device is always explicit: a public entry point takes a `device`
argument, and `None` means "the CUDA card". The plain PyTorch versions run
on the CPU only when the caller names it — `device="cpu"` in the API, or
FOLDCOMP_TORCH_DEVICE=cpu for the CLI. With no card and no such choice the
device paths refuse to run (DeviceUnavailable) instead of degrading.

torch is imported inside the functions that need it: the hybrid
scheduler's native workers read cache_dir() and never load torch.
"""
from __future__ import annotations

import os
import shutil
import subprocess

DEVICE_ENV = "FOLDCOMP_TORCH_DEVICE"
CACHE_ENV = "FOLDCOMP_TPU_TORCH_CACHE"


def cache_dir(env=None) -> str | None:
    """The port's user cache: everything it builds or measures for a later
    process (the kernel library under kernels/, the hybrid guard's
    device_warmup.json). FOLDCOMP_TPU_TORCH_CACHE, else
    ~/.cache/foldcomp_tpu_torch; None when that variable is "0" or empty:
    nothing is kept. The counterpart of foldcomp_tpu/backend.py:12-15,
    whose FOLDCOMP_TPU_JAX_CACHE is not read: that cache holds a TPU's
    numbers. Read at each call from `env` (a process environment,
    os.environ by default), so a caller can name a child's cache."""
    env = os.environ if env is None else env
    root = env.get(CACHE_ENV)
    if root is None:
        home = env.get("HOME") or os.path.expanduser("~")
        return os.path.join(home, ".cache", "foldcomp_tpu_torch")
    return os.path.abspath(root) if root not in ("0", "") else None


class DeviceUnavailable(RuntimeError):
    """The device path was asked for a CUDA card that is not there."""


def resolve_device(device=None) -> torch.device:
    """`device`, else FOLDCOMP_TORCH_DEVICE, else the CUDA card.

    Raises DeviceUnavailable when the resolved device is CUDA and no card
    is present, and ValueError for a device type the port has no path for
    (only the CUDA kernels and the CPU plain versions exist)."""
    import torch
    if device is None:
        device = os.environ.get(DEVICE_ENV) or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "the --fast device paths need a CUDA device and none is "
                f"available (set {DEVICE_ENV}=cpu to run its plain "
                "PyTorch version on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev


def _run(cmd) -> str | None:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip() if res.returncode == 0 else None


def nvcc_path() -> str | None:
    """nvcc from CUDA_HOME, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            p = os.path.join(root, "bin", "nvcc")
            if os.path.exists(p):
                return p
    return shutil.which("nvcc")


def describe() -> dict:
    """The card and toolchain: name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (first card), device count, torch.version.cuda, nvcc version."""
    import torch
    out = {"torch": torch.__version__, "torch_cuda": torch.version.cuda,
           "cuda_available": torch.cuda.is_available(),
           "device_count": torch.cuda.device_count(),
           "gpu": None, "power_limit": None, "nvidia_smi": None,
           "nvcc": None}
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    if smi:
        first = smi.splitlines()[0]
        out["nvidia_smi"] = first
        name, _, limit = first.rpartition(",")
        out["gpu"] = name.strip()
        out["power_limit"] = limit.strip()
    nvcc = nvcc_path()
    if nvcc:
        ver = _run([nvcc, "--version"])
        if ver:
            out["nvcc"] = ver.splitlines()[-1].strip()
    return out
