"""The port's single-device entry (foldcomp_tpu_torch/dryrun.py entry())
against the JAX package on the CPU.

entry() returns the decode step of the port's main path, decode_seg_fused
with refine_iters=2, and a synthetic batch of pack_decode_batch_lanes
tensors. On the CPU fn(*args) runs the plain versions; it is held to JAX
`decode_seg_fused(..., interpret=True)` on the same arrays, on the rows
each lane owns (r < seg_m), within 1 i16 unit (1 mA) and 1e-3 A, the
tolerance of tests/test_torch_wclass.py.
"""
import functools

import numpy as np
import torch

from foldcomp_tpu.kernels.pallas_decode import decode_seg_fused
from foldcomp_tpu_torch.dryrun import entry
from foldcomp_tpu_torch.kernels import fused_decode as FD

TOL_I16 = 1
TOL_CA_A = 1e-3


def test_entry_matches_jax_decode_seg_fused():
    fn, args = entry("cpu")
    assert isinstance(fn, functools.partial) and fn.func is FD.decode_seg_fused
    assert fn.keywords["refine_iters"] == 2
    assert all(t.device.type == "cpu" for t in args)
    nl_out = fn.keywords["nl_out"]
    seg_m = args[-1].numpy()

    off, ca = (t.numpy() for t in fn(*args))
    w_off, w_ca = (np.asarray(t) for t in decode_seg_fused(
        *(t.numpy() for t in args), refine_iters=2, interpret=True,
        nl_out=nl_out))
    assert off.shape == w_off.shape and ca.shape == w_ca.shape
    assert off.shape[0] == nl_out
    own = np.arange(off.shape[1])[None, :] < seg_m[:nl_out, None]
    d_off = np.abs(off.astype(np.int32) - w_off.astype(np.int32))[own]
    d_ca = np.abs(ca - w_ca)[own]
    assert own.sum() > 4000
    assert d_off.max() <= TOL_I16 and d_ca.max() <= TOL_CA_A, \
        (d_off.max(), d_ca.max())


def test_entry_defaults_to_the_card(monkeypatch):
    """With no device the entry asks for the card: on a host without one
    it raises instead of running on the CPU."""
    from foldcomp_tpu_torch.backend import DeviceUnavailable
    monkeypatch.delenv("FOLDCOMP_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        entry()
    except DeviceUnavailable:
        return
    raise AssertionError("entry() ran without a card")
