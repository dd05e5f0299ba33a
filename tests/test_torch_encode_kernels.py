"""Port encode kernel (foldcomp_tpu_torch/kernels/fused_encode.py and its
numerics in kernels/encode.py) against the JAX fused encode
(foldcomp_tpu/kernels/pallas_encode.py) and the shared host oracle.

- The constants equal the JAX modules' values.
- `div1000_cr` and `sqrt_rn` equal numpy's correctly rounded float32
  division and square root; `pack_records` equals numpy codec/fcz.py's.
- The plain k4's cosines are bit-equal to the host oracle of
  foldcomp_tpu/codec/batch.py (`_np_dihedral_parts`, `_np_bond_parts`,
  `_host_cos`: numpy float32 parts, float64 division) on every row the
  kernel does not flag as a rounding tie or a guard; torch's CPU
  elementwise float32 rounds like numpy's, op for op.
- The whole planar encode against JAX `_fused_parity_jit` in Pallas
  interpret mode at the same parts_eps, and the f32 form against JAX's XLA
  core `encode_parity_core`, in the tests/test_pallas_encode.py pattern:
  unflagged records and side-chain codes identical, flag disagreements
  within max(4, rows // 50). XLA:CPU contracts FMAs, so its parts sit
  ulps off the C order (that is why the JAX package's CPU parts_eps is not
  0), and the flags at the edge of a band can differ; the host rescues
  every flagged value, so bytes are still identical (the slice test).

Two JAX batch shapes, each built once per module: interpret mode compiles
each new shape for ~15 s. The CUDA kernel (k4 with the epilogue) runs
only on the card: chip_smoke.py holds its outputs bit-equal to
parity_tail(merged_plain(...)) there. Here the wrapper's CPU path, the
values the kernel writes at padding slots, its float constants and its
ctypes bindings are checked.
"""
import os
import re
import sys

import numpy as np
import pytest
import torch

from test_property_roundtrip import synthesize

from foldcomp_tpu.codec import fcz
from foldcomp_tpu.codec.batch import (_host_cos, _np_bond_parts,
                                      _np_dihedral_parts, fragment_to_tensors)
from foldcomp_tpu.core.aatable import PRED_IDX
from foldcomp_tpu_torch.codec.batch import _pack_encode_wire
from foldcomp_tpu_torch.core import tables as T
from foldcomp_tpu_torch.kernels import bitpack
from foldcomp_tpu_torch.kernels import encode as E
from foldcomp_tpu_torch.kernels import fused_encode as FE
from foldcomp_tpu_torch.verify import on_milli_grid

LENGTHS = ((5, 0), (24, 1), (60, 2), (130, 3), (240, 4))
PARTS_EPS = 64 * 2.0 ** -24
GUARD_T = 1 | 2          # tie, NaN guard of a torsion plane
GUARD_B = 8 | 16         # tie, guard of a bond plane


def _degenerate():
    """A duplicated CA (tests/test_pallas_encode.py:72-75)."""
    a = on_milli_grid(synthesize(30, 5))
    ca = [i for i, nm in enumerate(a.atom_name) if nm == "CA"]
    a.coords[ca[10]] = a.coords[ca[10] - 1]
    return a


def _batch(frames):
    """Padded numpy batch (l a multiple of 32, as encode_submit pads) and
    the native plane-major wire of it, or None off the compact form."""
    tensors = [fragment_to_tensors(a) for a in frames]
    b = len(tensors)
    n_res = np.asarray([t[0].shape[0] for t in tensors], np.int32)
    l = -(-int(n_res.max()) // 32) * 32
    res_code = np.zeros((b, l), np.int32)
    for k, t in enumerate(tensors):
        res_code[k, :n_res[k]] = t[1]
    atom14 = np.empty((b, l, 14, 3), np.float32)
    wire = _pack_encode_wire([(i, t[:3]) for i, t in enumerate(tensors)],
                             atom14)
    return dict(atom14=atom14, res_code=res_code, n_res=n_res,
                wire=wire if isinstance(wire, tuple) else None)


@pytest.fixture(scope="module")
def grid():
    """Millimetre-grid frames of lengths 5-240 and a degenerate one,
    through the port's plain planar encode and JAX's fused kernel."""
    from foldcomp_tpu.kernels.pallas_encode import _fused_parity_jit
    bt = _batch([on_milli_grid(synthesize(n, s)) for n, s in LENGTHS]
                + [_degenerate()])
    assert bt["wire"] is not None
    b = bt["res_code"].shape[0]
    t = {k: torch.from_numpy(v) for k, v in
         (("code", bt["res_code"]), ("n_res", bt["n_res"]))}
    wire_t = tuple(torch.from_numpy(a) for a in bt["wire"])
    bt["parts"] = FE.merged_plain(t["code"], wire=wire_t)
    bt["port"] = {k: v.numpy() for k, v in FE.encode_parity_fused_planar(
        *wire_t, t["code"], t["n_res"]).items()}
    bt["jax"] = {k: np.asarray(v) for k, v in _fused_parity_jit(
        *bt["wire"], bt["res_code"], bt["n_res"], pb=b,
        parts_eps=PARTS_EPS, interpret=True, planar=True).items()}
    return bt


def _assert_parity_pattern(port, ref, n_rows):
    trusted_bb = (port["bb_flags"] | ref["bb_flags"]) == 0
    rec_eq = (port["records"] == ref["records"]).all(axis=2)
    assert bool(rec_eq[trusted_bb].all())
    trusted_sc = (port["sc_flag_bits"] | ref["sc_flag_bits"]) == 0
    sc_eq = (port["sc_q"] == ref["sc_q"]).all(axis=2)
    assert bool(sc_eq[trusted_sc].all())
    for k in ("bb_flags", "cand_bits", "sc_flag_bits"):
        diff = int((port[k] != ref[k]).sum())
        assert diff <= max(4, n_rows // 50), (k, diff)
    for k, v in ref.items():
        assert port[k].dtype == v.dtype and port[k].shape == v.shape, k


def test_constants_match_jax_modules():
    from foldcomp_tpu.kernels import encode as JE
    from foldcomp_tpu.kernels import pallas_encode as JP
    for port, ref in ((T.NBIN_PHI_PSI, JE.NBIN_PHI_PSI),
                      (T.NBIN_OMEGA, JE.NBIN_OMEGA),
                      (T.NBIN_BOND, JE.NBIN_BOND),
                      (T.SC_DISC_F, JE._SC_DISC_F),
                      (T.BIGERR, JE._BIGERR), (T.DEG, JE._DEG),
                      (T.BIGF_LANES, JP._BIGF),
                      (T.PARTS_EPS, JE._PARTS_EPS_CPU)):
        assert type(port) is type(ref) and port == ref
    assert np.array_equal(T.PRED24, np.asarray(JP._PRED))


def test_div1000_cr_matches_numpy():
    """The dense sample of tests/test_fast_codec.py:173."""
    rng = np.random.default_rng(7)
    xi = rng.integers(-(2 ** 24) + 1, 2 ** 24, 1 << 20).astype(np.int32)
    edges = np.concatenate([
        np.arange(-2000, 2001, dtype=np.int32),
        np.array([2 ** 24 - 1, -(2 ** 24) + 1], np.int32),
        (np.arange(1, 16000, dtype=np.int32) * 1000),
        (np.arange(1, 16000, dtype=np.int32) * 1000 + 1),
        (np.arange(1, 16000, dtype=np.int32) * 1000 - 1)])
    xi = np.concatenate([xi, edges])
    got = E.div1000_cr(torch.from_numpy(xi)).numpy()
    np.testing.assert_array_equal(got, xi.astype(np.float32)
                                  / np.float32(1000.0))


def test_sqrt_rn_matches_numpy():
    rng = np.random.default_rng(11)
    x = np.concatenate([
        rng.random(1 << 20).astype(np.float32) * np.float32(1e6),
        rng.random(1 << 16).astype(np.float32) * np.float32(1e-36),
        np.array([0.0, 1.0, 2.0, np.inf, 3.4e38], np.float32)])
    np.testing.assert_array_equal(E.sqrt_rn(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))


def test_pack_records_matches_numpy():
    rng = np.random.default_rng(5)
    n = 4096
    fields = [rng.integers(0, 1 << w, n) for w in (5, 12, 12, 11, 8, 8, 8)]
    fields[1][:8] = [-1, 4095, 4096, 8191, 0, 1, 2047, 5000]  # wraps
    want = fcz.pack_records(*[f.astype(np.int64) % (1 << 32)
                              for f in fields])
    got = bitpack.pack_records(*[torch.from_numpy(f.astype(np.int32))
                                 for f in fields]).numpy()
    np.testing.assert_array_equal(got, want)


def test_merged_plain_matches_host_oracle(grid):
    """Cosines bit-equal to the numpy float32 parts divided in float64,
    on every row without a tie or guard bit; side-chain cosines bit-equal
    to numpy float32 inner / sqrt(denom2)."""
    tcos, bcos, tbits, scc, scb, _, _ = (p.numpy() for p in grid["parts"])
    atom14 = grid["atom14"]
    b, l = grid["res_code"].shape
    flat = atom14[:, :, :3].reshape(b, 3 * l, 3).transpose(1, 2, 0)
    px, py, pz = flat[:, 0], flat[:, 1], flat[:, 2]          # [3L, B]
    inner, denom2, _ = _np_dihedral_parts(px, py, pz)        # [3L-3, B]
    want_t = _host_cos(inner, denom2)
    b_inner, b_denom2 = _np_bond_parts(px, py, pz)           # [3L-2, B]
    want_b = _host_cos(b_inner, b_denom2)
    n_checked = 0
    for p in range(3):
        rows = np.arange(l)[3 * np.arange(l) + p <= 3 * l - 4]
        ok = (tbits[p][:, rows] & GUARD_T) == 0
        got = tcos[p][:, rows]
        want = want_t[3 * rows + p].T
        assert np.array_equal(got[ok], want[ok]), p
        n_checked += int(ok.sum())
        rows = np.arange(l)[3 * np.arange(l) + p <= 3 * l - 3]
        ok = (tbits[p][:, rows] & GUARD_B) == 0
        assert np.array_equal(bcos[p][:, rows][ok],
                              want_b[3 * rows + p].T[ok]), p
    # padding rows are all guards; nearly every real window is checked
    assert n_checked > 0.9 * 3 * int((grid["n_res"] - 2).sum())
    # side chains: slots 3..13 from their PRED_IDX predecessors
    code = np.clip(grid["res_code"], 0, 23)
    pred = np.asarray(PRED_IDX)
    for k in range(3, 14):
        pts = [np.take_along_axis(atom14, pred[code, k, j][..., None, None]
                                  .repeat(3, axis=3), axis=2)[:, :, 0]
               for j in range(3)] + [atom14[:, :, k]]
        d1, d2, d3 = (pts[i + 1] - pts[i] for i in range(3))
        u1, u2 = np.cross(d1, d2), np.cross(d2, d3)
        inner_s = (u1[..., 0] * u2[..., 0] + u1[..., 1] * u2[..., 1]
                   + u1[..., 2] * u2[..., 2])
        den = ((u1[..., 0] * u1[..., 0] + u1[..., 1] * u1[..., 1]
                + u1[..., 2] * u1[..., 2])
               * (u2[..., 0] * u2[..., 0] + u2[..., 1] * u2[..., 1]
                  + u2[..., 2] * u2[..., 2]))
        good = ((scb >> (k - 3)) & 1) == 0
        assert np.array_equal(good, den > 0), k
        np.testing.assert_array_equal(scc[k - 3][good],
                                      inner_s[good] / np.sqrt(den[good]))


def test_planar_encode_matches_jax_fused(grid):
    _assert_parity_pattern(grid["port"], grid["jax"],
                           grid["res_code"].size)


def test_f32_form_matches_jax_xla_core():
    """Frames off the millimetre grid take k4's f32 loader; the JAX
    package sends them to its XLA core."""
    from foldcomp_tpu.kernels.encode import encode_parity_core
    bt = _batch([synthesize(n, s + 10) for n, s in LENGTHS[:4]])
    assert bt["wire"] is None
    port = FE.encode_parity_f32(torch.from_numpy(bt["atom14"]),
                                torch.from_numpy(bt["res_code"]),
                                torch.from_numpy(bt["n_res"]))
    ref = encode_parity_core(bt["atom14"], bt["res_code"], bt["n_res"])
    _assert_parity_pattern({k: v.numpy() for k, v in port.items()},
                           {k: np.asarray(v) for k, v in ref.items()},
                           bt["res_code"].size)


def test_loaders_agree(grid):
    """The compact wire and the f32 atom14 of the same batch give the same
    parts: the wire decodes to the exact float32 coordinates."""
    via_f32 = FE.merged_plain(torch.from_numpy(grid["res_code"]),
                              atom14=torch.from_numpy(grid["atom14"]))
    for a, b in zip(grid["parts"], via_f32):
        assert torch.equal(a, b)


def test_wrapper_runs_plain_on_cpu_without_launching(grid):
    """On CPU tensors the fused kernel's wrapper is its plain version,
    parity_tail(merged_plain(...)), by either loader, and launches
    nothing."""
    code = torch.from_numpy(grid["res_code"])
    n_res = torch.from_numpy(grid["n_res"])
    wire = tuple(torch.from_numpy(a) for a in grid["wire"])
    want = FE.parity_tail(grid["parts"], code, n_res)
    FE.reset_launch_counts()
    for got in (FE.fused(code, n_res, wire=wire),
                FE.fused(code, n_res,
                         atom14=torch.from_numpy(grid["atom14"]))):
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert FE.launch_counts() == {"k4": 0}
    with pytest.raises(ValueError):
        FE.fused(code, n_res)
    with pytest.raises(ValueError):
        FE.fused(code, n_res, wire=wire, atom14=torch.zeros(1))
    x = torch.linspace(-1.0, 1.0, 257)
    assert torch.equal(FE.acos(x), torch.arccos(x))


def test_wrapper_refuses_other_devices():
    meta = torch.empty((2, 32), dtype=torch.int32, device="meta")
    n_res = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        FE.fused(meta, n_res,
                 atom14=torch.empty((2, 32, 14, 3), device="meta"))
    with pytest.raises(ValueError):
        FE.acos(torch.empty((8,), device="meta"))


def test_padding_slots_hold_the_constants(grid):
    """What the CUDA kernel writes without arithmetic: at slots r >= n_res
    (all-zero coordinates, as every pack leaves them) records, bb_flags
    and cand_bits 0, every side-chain code 127 and all 11 flags set; at
    r = n_res - 1 the record holds the residue code alone."""
    code = torch.from_numpy(grid["res_code"])
    n_res = torch.from_numpy(grid["n_res"])
    l = code.shape[1]
    pad = np.arange(l)[None, :] >= grid["n_res"][:, None]
    last = np.arange(l)[None, :] == grid["n_res"][:, None] - 1
    assert pad.sum() > l
    for parts in (grid["parts"], FE.merged_plain(
            code, atom14=torch.from_numpy(grid["atom14"]))):
        out = {k: v.numpy() for k, v in
               FE.parity_tail(parts, code, n_res).items()}
        assert (out["records"][pad] == 0).all()
        assert (out["bb_flags"][pad | last] == 0).all()
        assert (out["cand_bits"][pad | last] == 0).all()
        assert (out["sc_q"][pad] == 127).all()
        assert (out["sc_flag_bits"][pad] == 0x7FF).all()
        rec = out["records"][last]
        assert np.array_equal(rec[:, 0], (grid["res_code"][last] & 31) << 3)
        assert (rec[:, 1:] == 0).all()


def test_tail_consts_are_the_plain_versions_scalars():
    """The kernel's float constants (TailK) are the float32 values torch
    gives the plain epilogue's Python scalars, in TailK's order."""
    c = FE._TAIL_CONSTS
    assert c.dtype == np.float32 and c.shape == (24,)
    want = [E._EPS, E._DEG, E._BIGERR, E._BIGF, 5e-7, 2e-5, 1e-12, 1e-4,
            E._SC_DEG, E._SC_DISC_F, E._SC_TOL_F, 2e-4]
    assert np.array_equal(c[:12], np.asarray(want, np.float32))
    nbins = np.asarray([T.NBIN_PHI_PSI] * 2 + [T.NBIN_OMEGA]
                       + [T.NBIN_BOND] * 3, np.float32)
    assert np.array_equal(c[12:18], nbins)
    assert np.array_equal(c[18:], np.float32(1.0) / nbins)
    src = open(FE.__file__.replace("fused_encode.py",
                                   "csrc/fused_encode.cu")).read()
    body = src[src.index("struct TailK {"):src.index("};", src.index(
        "struct TailK {"))]
    fields = re.findall(r"float (\w+)(\[kStreams\])?;", body)
    assert sum(6 if arr else 1 for _, arr in fields) == c.shape[0]


def test_bind_sets_the_encode_argtypes():
    """build._bind gives each launcher of fused_encode.cu one ctypes type
    a C parameter: c_void_p for a pointer or the stream, c_int for an
    int."""
    import ctypes
    import types
    from foldcomp_tpu_torch.kernels import build

    class Lib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    lib = build._bind(Lib())
    src = open(build.SOURCES[1]).read()
    kinds = {"int": ctypes.c_int, "cudaStream_t": ctypes.c_void_p}
    sigs = re.findall(r"\ncudaError_t (fe_\w+)\(([^)]*)\)", src)
    assert {n for n, _ in sigs} == {"fe_encode", "fe_acos"}
    for name, params in sigs:
        want = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
                for p in params.split(",")]
        assert getattr(lib, name).argtypes == want, name
        assert getattr(lib, name).restype is ctypes.c_int, name
    assert lib.fe_encode.argtypes[0] is ctypes.c_void_p


def test_build_steps_report_the_failing_command():
    """The build runs one compiler per source at once; a failing one
    raises with its output (here with stand-in commands: no nvcc)."""
    from foldcomp_tpu_torch.kernels import build
    ok = [sys.executable, "-c", "pass"]
    bad = [sys.executable, "-c", "import sys; print('boom'); sys.exit(3)"]
    build._run_all([ok, ok])
    with pytest.raises(build.KernelBuildError, match="boom"):
        build._run_all([ok, bad])
    assert len(build.SOURCES) == 2
    from foldcomp_tpu_torch.backend import cache_dir
    assert build.library_path().startswith(
        os.path.join(cache_dir(), "kernels", build.PREFIX))
