"""Device resolution and device description.

The device is always explicit: a public entry point takes a `device`
argument, and `None` means "the CUDA card". The plain PyTorch versions run
on the CPU only when the caller names it — `device="cpu"` in the API, or
FOLDCOMP_TORCH_DEVICE=cpu for the CLI. With no card and no such choice the
device paths refuse to run (DeviceUnavailable) instead of degrading.
"""
from __future__ import annotations

import os
import shutil
import subprocess

import torch

DEVICE_ENV = "FOLDCOMP_TORCH_DEVICE"


class DeviceUnavailable(RuntimeError):
    """The device path was asked for a CUDA card that is not there."""


def resolve_device(device=None) -> torch.device:
    """`device`, else FOLDCOMP_TORCH_DEVICE, else the CUDA card.

    Raises DeviceUnavailable when the resolved device is CUDA and no card
    is present, and ValueError for a device type the port has no path for
    (only the CUDA kernels and the CPU plain versions exist)."""
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
