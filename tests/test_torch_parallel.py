"""The port's multi-device layers on the CPU: parallel/dist.py
init_distributed and spawn_ranks, parallel/pipeline.py, parallel/seqpar.py
and dryrun.py, each rank a spawned process with its plain PyTorch versions,
the ranks joined in a gloo group over a file:// store.

The same inputs go through the JAX package's parallel layers on the
conftest's virtual CPU devices (a mesh of 1, 2 or 4). The tolerances:

- across world sizes 1, 2 and 4 the port's outputs are bit-identical
  (per-protein and per-window work; only the global RMSD's sum changes
  order, within 1e-6 relative);
- roundtrip records byte-identical to the exact encoder's; per protein the
  all-atom RMSD no larger than the JAX core's + 1e-3 A (the JAX core
  encodes through its XLA residue-space core, the port through k4's plain
  version and the host rescue); the global RMSD within 1e-3 A of JAX's;
- dihedrals and bond angles: the float32 parts bit-equal to JAX's, and so
  the cosines (same operation order, correctly rounded sqrt and divide);
  the two acos implementations (XLA's and torch's) differ by up to one
  float32 ulp in radians, which the multiplication by 180/pi turns into at
  most 3 ulps of the angle in degrees (< 1e-5 degrees below 32 degrees,
  4.6e-5 at 180). So the backbone features lie within those 3 ulps of
  JAX's reference_backbone_features (eager, the JAX operation order) and
  within 1e-3 degrees of the port's own; against JAX's sharded features,
  which XLA compiles with another rounding (up to 0.028 degrees from its
  own reference at a torsion of 180 degrees, where acos amplifies a
  cosine's last bit), no farther than JAX's reference is + 1e-3 degrees;
- sharded encode: quantized values equal to JAX's or one quantization
  step off where the angle sits on a bin's rounding edge (counts stated
  in test_encode_features_match_jax); encode_long_chain's FCZ decodes
  within the exact encoder's own RMSD + 1e-3 A.
"""
import os
import pathlib
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from foldcomp_tpu.codec.batch import segments_of
from foldcomp_tpu.codec.fcz import FczData
from foldcomp_tpu.kernels import geometry as tpu_geom
from foldcomp_tpu.parallel import pipeline as tpu_pipe
from foldcomp_tpu.parallel import seqpar as tpu_seqpar
from foldcomp_tpu_torch import dryrun
from foldcomp_tpu_torch.backend import DeviceUnavailable
from foldcomp_tpu_torch.codec.batch_host import _anchor_indices
from foldcomp_tpu_torch.codec.decoder import decode
from foldcomp_tpu_torch.codec.encoder import encode
from foldcomp_tpu_torch.codec.fcz import parse
from foldcomp_tpu_torch.kernels import geometry as port_geom
from foldcomp_tpu_torch.parallel import pipeline, seqpar
from foldcomp_tpu_torch.parallel.dist import init_distributed, spawn_ranks
from foldcomp_tpu_torch.parallel.scaling import mixed_batch, mixed_protos
from foldcomp_tpu_torch.verify import synthetic_structures

REPO = pathlib.Path(__file__).resolve().parents[1]
# test_wclass.py scale: several anchor-tail widths (synthesize(n, seed=n))
LENGTHS = (26, 60, 151, 240, 33, 90, 120, 200)
CHAIN = 2000
WORLDS = (1, 2, 4)
THRESHOLD = 25


def _jax_roundtrip(n, arrays, s_max, seg_width):
    """JAX's roundtrip on the same batch: the core (n 1, the function a
    one-device mesh maps) or the step on a mesh of n devices."""
    if n == 1:
        rec, dec, ss, na = jax.jit(lambda *a: tpu_pipe.roundtrip_core(
            *a, s_max=s_max, seg_width=seg_width, threshold=THRESHOLD))(
                *arrays)
        return np.asarray(dec), float(np.sqrt(np.asarray(ss)
                                              / np.asarray(na)))
    mesh = tpu_pipe.make_mesh(n)
    step = tpu_pipe.make_roundtrip_step(mesh, s_max=s_max,
                                        seg_width=seg_width,
                                        threshold=THRESHOLD)
    _, dec, g = step(*tpu_pipe.shard_batch(mesh, arrays))
    return np.asarray(dec), float(g)


def _jax_seqpar(n, chain, flat):
    mesh = tpu_pipe.make_mesh(n, axis_name="seq")
    a14, rc, tf = chain
    enc = tpu_seqpar.sharded_encode_features(mesh, a14, rc, tf, a14.shape[0])
    bb = tpu_seqpar.sharded_backbone_features(mesh, flat[:, 0], flat[:, 1],
                                              flat[:, 2])
    return ({k: np.asarray(v) for k, v in enc.items()},
            tuple(np.asarray(x) for x in bb))


@pytest.fixture(scope="module")
def runs():
    """Every world size's ranks (rank_checks on the CPU) and the JAX
    package's runs of the same inputs, all started at once."""
    if len(jax.devices()) < max(WORLDS):
        pytest.skip("needs the conftest's virtual CPU devices")
    protos = mixed_protos(LENGTHS)
    arrays = mixed_batch(protos, len(LENGTHS))
    chain, flat, long_atoms = dryrun.chain_inputs(CHAIN, CHAIN)
    cfg = dict(protos=protos, entries=len(LENGTHS), digests=False,
               flat=flat, chain=chain, long_atoms=long_atoms)
    # JAX's segment grid: as many segments and as wide as the batch needs
    s_max = max(n // THRESHOLD + 1 for n in LENGTHS)
    _, _, seg_m = pipeline.device_segments(arrays[3].sum(1),
                                           arrays[3].shape[1], s_max,
                                           THRESHOLD)
    seg_width = int(seg_m.max())
    with ThreadPoolExecutor(len(WORLDS) * 3) as ex:
        port = {w: ex.submit(spawn_ranks, dryrun.rank_checks, w, (cfg,),
                             devices=["cpu"] * w, timeout=600)
                for w in WORLDS}
        rt = {w: ex.submit(_jax_roundtrip, w, arrays, s_max, seg_width)
              for w in WORLDS}
        sp = {w: ex.submit(_jax_seqpar, w, chain, flat) for w in WORLDS}
        jax_ref = tuple(np.asarray(x) for x in
                        tpu_seqpar.reference_backbone_features(
                            flat[:, 0], flat[:, 1], flat[:, 2]))
        return dict(port={w: f.result() for w, f in port.items()},
                    jax_ref=jax_ref,
                    jax_rt={w: f.result() for w, f in rt.items()},
                    jax_sp={w: f.result() for w, f in sp.items()},
                    arrays=arrays, chain=chain, flat=flat,
                    long_atoms=long_atoms)


def _cat(ranks, key, sub=None):
    parts = [r[key] if sub is None else r[key][sub] for r in ranks]
    return np.concatenate(parts)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


# ------------------------------------------------------------------ (a), (b)

def test_device_segments_match_jax_and_host():
    """device_segments equals JAX's and the host anchors (_setAnchor) and
    segments (segments_of) for every length 2..300."""
    ns = np.arange(2, 301, dtype=np.int32)
    s_max = int(ns.max()) // THRESHOLD + 1
    got = [t.numpy() for t in pipeline.device_segments(
        torch.from_numpy(ns), 300, s_max, THRESHOLD)]
    want = [np.asarray(x) for x in tpu_pipe.device_segments(ns, 300, s_max,
                                                            THRESHOLD)]
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    anchor_idx, seg_start, seg_m = got
    for i, n in enumerate(ns):
        anchors = _anchor_indices(int(n), THRESHOLD)
        k = len(anchors)
        assert list(anchor_idx[i, :k]) == list(anchors), n
        f = FczData(
            n_residue=int(n), n_atom=0, idx_residue=0, idx_atom=0,
            n_anchor=k, chain="A", n_sc_torsion=0, first_residue="A",
            last_residue="A", title="", mins=np.zeros(6, np.float32),
            cont_fs=np.zeros(6, np.float32), anchor_indices=anchors,
            anchor_coords=np.zeros((k, 3, 3), np.float32), has_oxt=False,
            oxt_coords=np.zeros(3, np.float32),
            records=np.zeros((n, 8), np.uint8),
            sc_codes=np.zeros(0, np.uint8), tf_min=np.float32(0),
            tf_cont=np.float32(0), tf_codes=np.zeros(n, np.uint8))
        starts, counts = segments_of(f)
        assert list(seg_start[i, :k - 1]) == starts, n
        assert list(seg_m[i, :k - 1]) == counts, n


def test_geometry_matches_jax():
    """dihedral_c / bond_angle_c (and their parts) against JAX's on a
    seeded random-walk chain."""
    rng = np.random.default_rng(5)
    pts = np.cumsum(rng.normal(0, 1.5, (4099, 3)), 0).astype(np.float32)
    pts[100:104] = pts[100]                   # degenerate frames
    pts[200:204] = pts[200] + np.arange(4)[:, None] * np.float32(1.5)
    comp = [np.ascontiguousarray(pts[i:len(pts) - 3 + i, j])
            for i in range(4) for j in range(3)]
    tt = [torch.from_numpy(c) for c in comp]
    for name, n_args in (("dihedral", 12), ("bond_angle", 9)):
        jp = [np.asarray(x) for x in
              getattr(tpu_geom, f"{name}_parts_c")(*comp[:n_args])]
        tp = [x.numpy() for x in
              getattr(port_geom, f"{name}_parts_c")(*tt[:n_args])]
        assert all(_bits_equal(a, b) for a, b in zip(tp, jp)), name
        ja = np.asarray(getattr(tpu_geom, f"{name}_c")(*comp[:n_args]))
        ta = getattr(port_geom, f"{name}_c")(*tt[:n_args]).numpy()
        assert ta.dtype == np.float32
        # one ulp of acos in radians: <= 3 ulps of the angle in degrees
        ulp = np.spacing(np.abs(ja).astype(np.float32))
        assert np.all(np.abs(ta - ja) <= 3 * ulp), name
        assert np.mean(ta == ja) > 0.5, name
    # the degenerate frames take the JAX branch
    assert np.array_equal(
        port_geom.dihedral_c(*tt).numpy()[98:104],
        np.asarray(tpu_geom.dihedral_c(*comp))[98:104])


# ---------------------------------------------------------------------- (c)

def test_roundtrip_bit_identical_across_world_sizes(runs):
    one = runs["port"][1][0]
    b, l = runs["arrays"][1].shape
    assert one["records"].shape == (b, l, 8)
    assert one["atom14_dec"].shape == (b, l, 14, 3)
    for w in WORLDS[1:]:
        ranks = runs["port"][w]
        assert [r["rank"] for r in ranks] == list(range(w))
        assert all(r["backend"] == "gloo" and r["size"] == w
                   for r in ranks)
        for key in ("records", "atom14_dec"):
            assert _bits_equal(_cat(ranks, key), one[key]), (w, key)
        for r in ranks:
            assert abs(r["global_rmsd"] - one["global_rmsd"]) <= \
                1e-6 * one["global_rmsd"]


def test_roundtrip_records_match_exact_encoder(runs):
    one = runs["port"][1][0]
    for k, a in enumerate(synthetic_structures(LENGTHS).values()):
        f = encode(a, anchor_threshold=THRESHOLD)
        n = f.n_residue
        assert one["records"][k, :n].tobytes() == \
            np.asarray(f.records, np.uint8).tobytes(), n
        assert not one["records"][k, n:].any()


def test_roundtrip_rmsd_against_jax(runs):
    """Per protein no farther from the input than the JAX core + 1e-3 A;
    the global RMSD of every world size within 1e-3 A of JAX's on a mesh
    of the same size."""
    a14, rc, _, mask = runs["arrays"]
    amask = pipeline.atom_mask(torch.from_numpy(rc)).numpy() & \
        mask[..., None]

    def per_protein(dec):
        d2 = np.where(amask[..., None], (dec - a14) ** 2, 0.0)
        return np.sqrt(d2.sum((1, 2, 3)) / amask.sum((1, 2)))

    jax_dec, _ = runs["jax_rt"][1]
    got = per_protein(runs["port"][1][0]["atom14_dec"])
    want = per_protein(jax_dec)
    assert np.all(got <= want + 1e-3), (got, want)
    for w in WORLDS:
        g = runs["port"][w][0]["global_rmsd"]
        assert np.isfinite(g) and abs(g - runs["jax_rt"][w][1]) <= 1e-3, w


# ---------------------------------------------------------------------- (d)

def test_backbone_features(runs):
    one = runs["port"][1][0]
    for i in range(2):
        ref = runs["jax_ref"][i]
        assert np.abs(one["backbone"][i] - one["backbone_ref"][i]).max() \
            <= 1e-3
        assert np.all(np.abs(one["backbone"][i] - ref)
                      <= 3 * np.spacing(np.abs(ref))), i
        for w in WORLDS:
            got = _cat(runs["port"][w], "backbone", i)
            assert _bits_equal(got, one["backbone"][i]), (w, i)
            if w > 1:
                want = runs["jax_sp"][w][1][i]
                assert got.shape == want.shape
                assert np.all(np.abs(got - want)
                              <= np.abs(want - ref) + 1e-3), (w, i)
    # the chain's tail windows are masked, as in JAX
    t = runs["flat"].shape[0]
    assert not one["backbone"][0][t - 3:].any()
    assert not one["backbone"][1][t - 2:].any()


# ---------------------------------------------------------------------- (e)

# quantized values one step from JAX's on the 2,000-residue chain, as
# measured at every world size: 8 of the 12,000 backbone values of the
# records (4 omega, 3 psi, 1 phi: acos's last bit on a bin's rounding
# edge), none of the side-chain torsions or temperature factors
MAX_OFF_BY_ONE = {"records": 8, "sc_q": 0, "tf_q": 0}


def _fields(records):
    b = records.astype(np.int32)
    return np.stack([b[:, 0] >> 3, ((b[:, 0] & 7) << 8) | b[:, 1],
                     (b[:, 2] << 4) | (b[:, 3] >> 4),
                     ((b[:, 3] & 15) << 8) | b[:, 4], b[:, 5], b[:, 6],
                     b[:, 7]], 1)


def test_encode_features_bit_identical_across_world_sizes(runs):
    one = runs["port"][1][0]["encode"]
    assert one["records"].shape == (CHAIN, 8)
    assert one["sc_q"].shape == (CHAIN, 11) and one["tf_q"].shape == (CHAIN,)
    for w in WORLDS[1:]:
        ranks = runs["port"][w]
        for key in ("records", "sc_q", "tf_q"):
            got = np.concatenate([r["encode"][key] for r in ranks])
            assert _bits_equal(got[:CHAIN], one[key]), (w, key)
        for key in ("mins", "cont_fs", "tf_min", "tf_cont"):
            assert all(_bits_equal(r["encode"][key], one[key])
                       for r in ranks), (w, key)


def test_encode_features_match_jax(runs):
    for w in WORLDS:
        got = {k: np.concatenate([r["encode"][k] for r in runs["port"][w]])
               if k in ("records", "sc_q", "tf_q") else
               runs["port"][w][0]["encode"][k] for k in runs["jax_sp"][w][0]}
        want = runs["jax_sp"][w][0]
        for key, limit in MAX_OFF_BY_ONE.items():
            g, j = got[key], want[key]
            if key == "records":
                g, j = _fields(g), _fields(j)
            diff = np.abs(g.astype(np.int64) - j.astype(np.int64))
            assert diff.max() <= 1, (w, key)
            assert int((diff == 1).sum()) <= limit, (w, key, (diff == 1).sum())
        for key in ("mins", "cont_fs", "tf_min", "tf_cont"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       atol=2e-5, err_msg=f"{w} {key}")


def _matched_rmsd(atoms, ref_atoms):
    ref = {(int(r), nm): c for r, nm, c in
           zip(ref_atoms.residue_index, ref_atoms.atom_name,
               ref_atoms.coords)}
    pairs = [(c, ref[(int(r), nm)]) for r, nm, c in
             zip(atoms.residue_index, atoms.atom_name, atoms.coords)
             if (int(r), nm) in ref]
    assert len(pairs) > 0.9 * len(ref_atoms)
    got, want = (np.asarray([p[i] for p in pairs], np.float64)
                 for i in range(2))
    return float(np.sqrt(((got - want) ** 2).sum(1).mean()))


def test_encode_long_chain_roundtrip(runs):
    blobs = [runs["port"][w][0]["long_chain"] for w in WORLDS]
    assert all(b == blobs[0] for b in blobs)
    assert all(r["long_chain"] is None
               for w in WORLDS for r in runs["port"][w][1:])
    atoms = runs["long_atoms"]
    f = parse(blobs[0])
    assert f.n_residue == CHAIN
    exact = _matched_rmsd(decode(encode(atoms)), atoms)
    assert _matched_rmsd(decode(f), atoms) <= exact + 1e-3


# ---------------------------------------------------------------------- (f)

def test_init_distributed_unconfigured(monkeypatch):
    """Nothing configured: (0, 1) and no process group, as JAX's."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() == (0, 1)
    assert not torch.distributed.is_initialized()


_JOIN = textwrap.dedent("""
    import sys
    from foldcomp_tpu_torch.parallel.dist import init_distributed
    import torch.distributed as dist
    got = init_distributed(init_method=sys.argv[1])
    print(got[0], got[1], dist.get_backend())
    dist.destroy_process_group()
""")


def test_init_distributed_from_torchrun_variables(tmp_path):
    """Two processes with torchrun's RANK / WORLD_SIZE / LOCAL_RANK join one
    gloo group (FOLDCOMP_TORCH_DEVICE=cpu ranks); the rank and size come
    from the variables."""
    init = "file://" + str(tmp_path / "store")
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO), RANK=str(r),
                   WORLD_SIZE="2", LOCAL_RANK=str(r),
                   FOLDCOMP_TORCH_DEVICE="cpu")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _JOIN, init], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out.split())
    finally:
        for p in procs:
            p.kill()
    assert sorted(outs) == [["0", "2", "gloo"], ["1", "2", "gloo"]]


def test_parallel_dist_loads_no_torch():
    code = ("import sys, foldcomp_tpu_torch.parallel.dist, "
            "foldcomp_tpu_torch.parallel.hybrid; "
            "sys.exit('torch' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0


def test_device_refused_without_card(monkeypatch):
    """Without a card and without FOLDCOMP_TORCH_DEVICE=cpu the mesh and the
    step refuse; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("FOLDCOMP_TORCH_DEVICE", raising=False)
    with pytest.raises(DeviceUnavailable):
        pipeline.make_mesh()
    arrays = mixed_batch(mixed_protos((26,)), 1)
    with pytest.raises(DeviceUnavailable):
        pipeline.roundtrip_core(*arrays)
    assert pipeline.make_mesh(device="cpu").size == 1


def _fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    mesh.all_reduce(torch.ones(1))        # waits for rank 1, which is gone
    return "rank 0 done"


def test_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        spawn_ranks(_fail_on_rank_1, 2, devices=["cpu", "cpu"], timeout=120,
                    pg_timeout=30)
    with pytest.raises(ValueError):
        pipeline.shard_batch(pipeline.Mesh(0, 3, torch.device("cpu"),
                                           None), [np.zeros(4)])


# ------------------------------------------------------------------ dry run

def test_dryrun_multichip_on_cpu():
    """chip_smoke's multi_device phase, rehearsed on CPU ranks at a small
    size: one rank against two, every check of dryrun_multichip."""
    out = dryrun.dryrun_multichip(2, device="cpu", entries_per_rank=4,
                                  lengths=(120, 200), chain_res=600,
                                  long_res=300, timeout=300)
    assert [(r["world"], r["backend"]) for r in out["runs"]] == \
        [(1, "gloo"), (2, "gloo")]
    assert out["roundtrip"]["rows_equal"] == 8
    assert all(p["ok"] for p in out["roundtrip"]["parity"].values())
    assert out["backbone"]["max_dev_deg"] <= dryrun.BACKBONE_TOL_DEG
    assert out["encode"]["long_chain_bytes"] > 0
