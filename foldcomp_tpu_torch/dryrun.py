"""Multi-device dry run of the port's parallel layers.

The counterpart of the JAX package's `dryrun_multichip`
(__graft_entry__.py:90): one process per rank (parallel/dist.py
spawn_ranks), and for each layer a run on one rank beside a run on n:

- the data-parallel roundtrip step (parallel/pipeline.py) on a batch of
  the mixed corpus: records byte-identical and decoded atoms bit-identical
  to the one-rank run row for row, the kernels k1-k4 launched on every
  rank, the global RMSD beside the per-protein gate of
  verify.device_parity_check (the JAX reference's deviation from the
  exact decoder + 1e-3 A);
- sharded_backbone_features against the one-rank run (bit-identical) and
  against reference_backbone_features (within BACKBONE_TOL_DEG);
- sharded_encode_features on one long chain and encode_long_chain on its
  first residues, both bit-identical to the one-rank run.

On the CUDA cards the n-rank run is one rank per card under NCCL; a host
with one card runs two ranks on it under gloo instead (NCCL refuses two
ranks on one device), whose collectives stage through host memory
(pipeline.Mesh.staged). device="cpu" runs every rank on the CPU under
gloo, the CPU tests' rehearsal of the same checks.
"""
from __future__ import annotations

import hashlib
import time

import numpy as np

from .parallel.scaling import MIXED_LENGTHS, mixed_batch, mixed_protos

# titin's length, and a chain whose anchors still fit the FCZ header's u8
# count at the default interval
CHAIN_RES = 34350
LONG_RES = 6200
BACKBONE_TOL_DEG = 1e-3


def _row_digests(a):
    return [hashlib.blake2b(np.ascontiguousarray(r).tobytes(),
                            digest_size=16).hexdigest() for r in a]


def rank_checks(mesh, cfg):
    """One rank's part of the dry run; cfg (each part optional):

    - protos, entries, digests[, exact]: the roundtrip step on this rank's
      shard of mixed_batch(protos, entries); records and atom14_dec as
      arrays, or as per-row digests; with exact (one (coords, gate) per
      proto) the first row of each proto in the shard held to its gate;
    - flat: f32 [T, 3] backbone atoms, T a multiple of the mesh size, for
      sharded_backbone_features (and on a one-rank mesh
      reference_backbone_features);
    - chain: (atom14, res_code, tf_ca) of one chain for
      sharded_encode_features, padded to a multiple of the mesh size;
    - long_atoms: an AtomArray for encode_long_chain.

    Returns a dict of the rank's results (arrays on the host), its
    launch counts around the step and its times."""
    import torch

    from .kernels import fused_decode as FD
    from .kernels import fused_encode as FE
    from .parallel.pipeline import make_roundtrip_step, shard_batch
    from .parallel.seqpar import (encode_long_chain,
                                  reference_backbone_features,
                                  sharded_backbone_features,
                                  sharded_encode_features)
    from .verify import max_deviation

    dev = mesh.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn, *args):
        sync()
        t0 = time.perf_counter()
        res = fn(*args)
        sync()
        return res, time.perf_counter() - t0

    out = dict(rank=mesh.rank, size=mesh.size, backend=mesh.backend,
               device=str(dev), staged=mesh.staged, seconds={})
    if "protos" in cfg:
        protos = cfg["protos"]
        shard = shard_batch(mesh, mixed_batch(protos, cfg["entries"]))
        step = make_roundtrip_step(mesh)
        FD.reset_launch_counts()
        FE.reset_launch_counts()
        (records, dec, g_rmsd), dt = timed(step, *shard)
        out["launches"] = {**FD.launch_counts(), **FE.launch_counts()}
        out["seconds"]["roundtrip"] = dt
        out["residues"] = int(shard[3].sum())
        out["global_rmsd"] = float(g_rmsd)
        rec_h, dec_h = records.cpu().numpy(), dec.cpu().numpy()
        if cfg.get("digests"):
            out["records"], out["atom14_dec"] = (_row_digests(rec_h),
                                                 _row_digests(dec_h))
        else:
            out["records"], out["atom14_dec"] = rec_h, dec_h
        if cfg.get("exact"):
            rc = shard[1].cpu().numpy()
            first = mesh.rank * rc.shape[0]
            out["parity"] = {}
            for k in range(min(len(protos), rc.shape[0])):
                j = (first + k) % len(protos)
                n = protos[j][0].shape[0]
                coords, gate = cfg["exact"][j]
                d = max_deviation(dec_h[k, :n], rc[k, :n], coords)
                out["parity"][n] = dict(dev_A=d, gate_A=gate, ok=d <= gate)

    if "flat" in cfg:
        flat = torch.from_numpy(np.ascontiguousarray(cfg["flat"]))
        k = flat.shape[0] // mesh.size
        part = flat[mesh.rank * k:(mesh.rank + 1) * k].to(dev)
        (tors, angs), dt = timed(sharded_backbone_features, mesh,
                                 part[:, 0].contiguous(),
                                 part[:, 1].contiguous(),
                                 part[:, 2].contiguous())
        out["seconds"]["backbone"] = dt
        out["backbone"] = (tors.cpu().numpy(), angs.cpu().numpy())
        if mesh.size == 1:
            full = flat.to(dev)
            out["backbone_ref"] = tuple(
                t.cpu().numpy() for t in reference_backbone_features(
                    full[:, 0].contiguous(), full[:, 1].contiguous(),
                    full[:, 2].contiguous()))

    if "chain" in cfg:
        a14, rc, tf = cfg["chain"]
        n = a14.shape[0]
        ls = -(-n // mesh.size)
        lo = mesh.rank * ls

        def part(a):
            p = np.zeros((ls,) + a.shape[1:], a.dtype)
            got = a[lo:lo + ls]
            p[:got.shape[0]] = got
            return torch.from_numpy(p).to(dev)

        enc, dt = timed(sharded_encode_features, mesh, part(a14), part(rc),
                        part(tf), n)
        out["seconds"]["encode_features"] = dt
        out["encode"] = {k: v.cpu().numpy() for k, v in enc.items()}

    if "long_atoms" in cfg:
        out["long_chain"], dt = timed(encode_long_chain, cfg["long_atoms"],
                                      mesh)
        out["seconds"]["long_chain"] = dt
    return out


def _runs(n_devices, device):
    """[(world size, backend, devices)]: the one-rank run, then the n-rank
    run the host allows."""
    if device == "cpu":
        n = n_devices or 2
        return [(1, "gloo", ["cpu"]), (n, "gloo", ["cpu"] * n)]
    import torch

    from .backend import resolve_device
    resolve_device("cuda")
    count = torch.cuda.device_count()
    n = n_devices or max(count, 2)
    if count >= 2:
        if n > count:
            raise ValueError(f"{n} ranks on {count} cards")
        return [(1, "nccl", ["cuda:0"]),
                (n, "nccl", [f"cuda:{r}" for r in range(n)])]
    if n != 2:
        raise ValueError(f"one card: the n-rank run is 2 ranks, not {n}")
    return [(1, "nccl", ["cuda:0"]), (2, "gloo", ["cuda:0", "cuda:0"])]


def chain_inputs(chain_res=CHAIN_RES, long_res=LONG_RES, seed=34350):
    """(chain tensors, backbone atoms, first long_res residues as an
    AtomArray) of one synthesized chain of chain_res residues. The
    backbone is cut to a multiple of 12 atoms, which every world size of
    1, 2, 3 or 4 divides."""
    from .codec.batch_host import fragment_to_tensors
    from .verify import synthesize

    atoms = synthesize(chain_res, seed)
    a14, rc, tf, _ = fragment_to_tensors(atoms)
    flat = a14[:, :3].reshape(-1, 3)
    flat = flat[:flat.shape[0] // 12 * 12]
    cut = int(np.searchsorted(atoms.residue_index,
                              atoms.residue_index[0] + long_res))
    return (a14, rc, tf), flat, atoms.slice(0, cut)


def dryrun_multichip(n_devices: int | None = None, *,
                     entries_per_rank: int = 2048, lengths=MIXED_LENGTHS,
                     chain_res: int = CHAIN_RES, long_res: int = LONG_RES,
                     device=None, timeout: float = 600.0) -> dict:
    """Run the checks of the module docstring at one rank and at n
    (n_devices; default every card, or 2 ranks on a one-card host or on
    the CPU). Raises AssertionError when a check fails and RuntimeError
    when a rank fails; returns what was run and measured."""
    from .codec.decoder import decode
    from .codec.encoder import encode
    from .parallel.dist import spawn_ranks
    from .verify import REF_DEV_SLACK_A, load_ref_dev, synthetic_structures

    t_start = time.perf_counter()
    runs = _runs(n_devices, device)
    n = runs[-1][0]
    protos = mixed_protos(lengths)
    ref = load_ref_dev()
    exact = [(np.asarray(decode(encode(a)).coords),
              ref.get(m, float("inf")) + REF_DEV_SLACK_A)
             for m, a in synthetic_structures(lengths).items()]
    chain, flat, long_atoms = chain_inputs(chain_res, long_res)
    cfg = dict(protos=protos, entries=n * entries_per_rank, digests=True,
               exact=exact, flat=flat, chain=chain, long_atoms=long_atoms)
    setup_s = time.perf_counter() - t_start

    res = {}
    walls = {}
    for world, backend, devices in runs:
        t0 = time.perf_counter()
        res[world] = spawn_ranks(rank_checks, world, (cfg,), devices=devices,
                                 backend=backend, timeout=timeout,
                                 pg_timeout=timeout)
        walls[world] = time.perf_counter() - t0
    one, many = res[1][0], res[n]
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)

    for r in many + [one]:
        # on a CUDA rank every kernel of the step launched; the CPU runs
        # their plain versions, which count nothing
        bad = {k: v for k, v in r["launches"].items()
               if k in ("k1", "k2", "k3", "k4") and v < 1}
        check(not bad or r["device"] == "cpu",
              f"world {r['size']} rank {r['rank']}: no launch of "
              f"{sorted(bad)}")
        for length, p in r.get("parity", {}).items():
            check(p["ok"], f"world {r['size']} rank {r['rank']} L{length}: "
                           f"dev {p['dev_A']} A > gate {p['gate_A']} A")
    for key in ("records", "atom14_dec"):
        got = sum((r[key] for r in many), [])
        diff = [i for i, (a, b) in enumerate(zip(got, one[key])) if a != b]
        check(len(got) == len(one[key]) and not diff,
              f"roundtrip {key}: rows {diff[:8]} differ from one rank")
    rmsd = [r["global_rmsd"] for r in many]
    check(all(abs(x - one["global_rmsd"]) <= 1e-6 * one["global_rmsd"]
              for x in rmsd),
          f"global_rmsd {rmsd} vs one rank {one['global_rmsd']}")

    tors = np.concatenate([r["backbone"][0] for r in many])
    angs = np.concatenate([r["backbone"][1] for r in many])
    check(np.array_equal(tors.view(np.uint32),
                         one["backbone"][0].view(np.uint32))
          and np.array_equal(angs.view(np.uint32),
                             one["backbone"][1].view(np.uint32)),
          "sharded_backbone_features differ from one rank")
    ref_t, ref_a = one["backbone_ref"]
    bb_dev = float(max(np.abs(one["backbone"][0] - ref_t).max(),
                       np.abs(one["backbone"][1] - ref_a).max()))
    check(bb_dev <= BACKBONE_TOL_DEG,
          f"backbone features {bb_dev} deg from the reference")

    n_res = chain[0].shape[0]
    for key in ("records", "sc_q", "tf_q"):
        got = np.concatenate([r["encode"][key] for r in many])[:n_res]
        check(np.array_equal(got, one["encode"][key][:n_res]),
              f"sharded_encode_features {key} differ from one rank")
    for key in ("mins", "cont_fs", "tf_min", "tf_cont"):
        check(all(np.array_equal(r["encode"][key], one["encode"][key])
                  for r in many),
              f"sharded_encode_features {key} differ from one rank")
    check(many[0]["long_chain"] == one["long_chain"]
          and all(r["long_chain"] is None for r in many[1:]),
          "encode_long_chain differs from one rank")
    if failures:
        raise AssertionError("; ".join(failures))

    def rank_row(r):
        return dict(rank=r["rank"], device=r["device"],
                    launches=r["launches"], seconds=r["seconds"],
                    residues=r["residues"],
                    residues_per_s=r["residues"] / r["seconds"]["roundtrip"])

    return dict(
        runs=[dict(world=w, backend=b, devices=d,
                   staged=res[w][0]["staged"], wall_seconds=walls[w],
                   ranks=[rank_row(r) for r in res[w]])
              for w, b, d in runs],
        setup_seconds=setup_s,
        roundtrip=dict(entries=cfg["entries"], lengths=list(lengths),
                       rows_equal=len(one["records"]),
                       global_rmsd=one["global_rmsd"],
                       global_rmsd_ranks=rmsd,
                       parity={str(k): v for k, v in
                               one.get("parity", {}).items()}),
        backbone=dict(atoms=int(flat.shape[0]), max_dev_deg=bb_dev),
        encode=dict(residues=n_res, long_chain_residues=long_res,
                    long_chain_bytes=len(one["long_chain"])))
