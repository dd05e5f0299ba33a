"""The benchmark's CPU tests: cells at tiny sizes through the harness on
the port's plain CPU path, the reference in this process. Run from the
root of the repo: python3 -m pytest portbench/tests -q"""
from __future__ import annotations

import pytest


@pytest.fixture(autouse=True)
def _port_env(monkeypatch, tmp_path):
    """The port's cache in the test's directory; the link probe answered
    without a subprocess; the product's routing variables unset."""
    monkeypatch.setenv("FOLDCOMP_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("FOLDCOMP_TPU_LINK", "none")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    for k in ("FOLDCOMP_TPU_WIRE", "FOLDCOMP_TPU_WCLASS",
              "FOLDCOMP_TPU_BATCH", "FOLDCOMP_TPU_PLANAR_WIRE",
              "FOLDCOMP_TORCH_DEVICE"):
        monkeypatch.delenv(k, raising=False)
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
