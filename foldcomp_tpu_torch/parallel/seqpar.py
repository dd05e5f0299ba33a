"""Sequence-parallel backbone features and encode of one long chain.

The port's counterpart of foldcomp_tpu/parallel/seqpar.py. Extraction of
internal coordinates is a sliding-window computation over the atom
sequence (4-atom dihedral windows, 3-atom angle windows), so a chain too
long for one device's batch (titin, ~35k residues) can be split over the
ranks along the SEQUENCE axis: each rank holds its contiguous slice,
computes the windows that start in it, and takes a 3-atom halo from its
right neighbour.

What the torch.distributed version changes:

- each rank passes its own slice (the P("seq") block the JAX functions
  cut from the whole arrays; every rank's the same length) and gets its
  slice of the outputs back; per-chain values (quantizer ranges) come
  back on every rank;
- the mesh replaces the `axis_name` argument;
- the halo (`_halo_right`, JAX's ppermute) is one all_gather of every
  rank's first rows, and pmin/pmax are all_reduce(MIN/MAX)
  (pipeline.Mesh, which stages them through host memory for a gloo group
  of CUDA ranks);
- `encode_long_chain` gathers the shards on rank 0, which alone
  serializes the FCZ stream; the other ranks return None.

The JAX package computes this module in XLA, outside any Pallas kernel:
plain torch on the rank's device is its counterpart, with the JAX
operation order (kernels/geometry.py dihedral_c, bond_angle_c; the
quantizer floor((v - vmin) * (nbin / rng) + 0.5) in float32).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import tables as T
from ..core.aatable import MAX_ATOM, PRED_IDX
from ..kernels.bitpack import pack_records
from ..kernels.geometry import bond_angle_c, dihedral_c
from .pipeline import Mesh

F32 = torch.float32
I32 = torch.int32
# foldcomp_tpu/kernels/encode.py:38 and :43
NBIN_TEMP = np.float32(2 ** 8 - 1)
_BIG = float(np.float32(3.4e38))


def _halo_right(x, mesh: Mesh, n: int = 3):
    """The first n rows of the right neighbour's slice (the last rank
    wraps to rank 0; the wrapped values feed windows the caller masks)."""
    heads = mesh.all_gather(x[:n])
    return heads[(mesh.rank + 1) % mesh.size]


def _windows(fx, fy, fz, mesh: Mesh):
    """(torsions, angles) of the windows starting at each atom of the
    slice, the 3-atom halo from the right neighbour."""
    ex = torch.cat([fx, _halo_right(fx, mesh)])
    ey = torch.cat([fy, _halo_right(fy, mesh)])
    ez = torch.cat([fz, _halo_right(fz, mesh)])
    k = fx.shape[0]
    tors = dihedral_c(ex[:k], ey[:k], ez[:k],
                      ex[1:k + 1], ey[1:k + 1], ez[1:k + 1],
                      ex[2:k + 2], ey[2:k + 2], ez[2:k + 2],
                      ex[3:k + 3], ey[3:k + 3], ez[3:k + 3])
    angs = bond_angle_c(ex[:k], ey[:k], ez[:k],
                        ex[1:k + 1], ey[1:k + 1], ez[1:k + 1],
                        ex[2:k + 2], ey[2:k + 2], ez[2:k + 2])
    return tors, angs


def sharded_backbone_features(mesh: Mesh, flat_x, flat_y, flat_z):
    """Dihedrals and bond angles of a [T]-atom backbone split over the
    ranks (foldcomp_tpu/parallel/seqpar.py:40).

    flat_*: f32 [T / size], this rank's slice of the coordinate
    components. Returns this rank's slice of (torsions [T], angles [T]):
    entry i is the window starting (torsions) or centred (angles) at atom
    i; the chain's last 3 torsions and last 2 angles are zero, matching
    the unsharded stream lengths T-3 and T-2."""
    k = flat_x.shape[0]
    tors, angs = _windows(flat_x, flat_y, flat_z, mesh)
    t = k * mesh.size
    i = mesh.rank * k + torch.arange(k, device=flat_x.device)
    return (torch.where(i < t - 3, tors, 0.0),
            torch.where(i < t - 2, angs, 0.0))


def sharded_encode_features(mesh: Mesh, atom14, res_code, tf_ca, n_res: int):
    """FCZ quantization of ONE long chain split over the ranks
    (foldcomp_tpu/parallel/seqpar.py:84): the per-protein twin of the
    batched encode for B=1. Each rank extracts the torsion and angle
    windows that start in its residue slice (3-atom halo from the right
    neighbour), the quantizer ranges are reduced over the ranks with
    all_reduce(MIN/MAX), and each rank quantizes and bit-packs its own
    records: nothing materializes the whole chain on one device.

    atom14:   f32 [ls, 14, 3], this rank's slice (every rank's ls equal)
    res_code: i32 [ls]; tf_ca: f32 [ls]; n_res: real residues of the
              whole chain (the tail past it is padding)

    Returns this rank's slices of records u8 [ls, 8], sc_q u8 [ls, 11],
    tf_q u8 [ls], and the chain's mins / cont_fs f32 [6] (phi, psi,
    omega, n_ca_c, ca_c_n, c_n_ca) and tf_min / tf_cont f32 [] on every
    rank."""
    dev = atom14.device
    ls = atom14.shape[0]
    idx = mesh.rank * ls + torch.arange(ls, dtype=I32, device=dev)

    # backbone windows; stream order parity (foldcomp.cpp:484-505): the
    # window starting at backbone atom 3i is psi(i), and the angle classes
    # land on n_ca_c(i+1) / ca_c_n(i) / c_n_ca(i)
    flat = atom14[:, :3].reshape(3 * ls, 3)
    tors, angs = _windows(flat[:, 0], flat[:, 1], flat[:, 2], mesh)
    psi, omega, phi = tors[0::3], tors[1::3], tors[2::3]
    ncac_cls, cacn, cnca = angs[0::3], angs[1::3], angs[2::3]

    mtor = idx < n_res - 1
    mncac = (idx >= 1) & (idx <= n_res - 1)

    def quant(v, mask, nbin):
        vmin = mesh.all_reduce(torch.min(torch.where(mask, v, _BIG)), "min")
        vmax = mesh.all_reduce(torch.max(torch.where(mask, v, -_BIG)),
                               "max")
        rng = vmax - vmin
        q = torch.floor((v - vmin) * (float(nbin) / rng) + 0.5).to(I32)
        return q, vmin, rng / float(nbin)

    phi_q, phi_min, phi_cf = quant(phi, mtor, T.NBIN_PHI_PSI)
    psi_q, psi_min, psi_cf = quant(psi, mtor, T.NBIN_PHI_PSI)
    om_q, om_min, om_cf = quant(omega, mtor, T.NBIN_OMEGA)
    ncac_q, ncac_min, ncac_cf = quant(ncac_cls, mncac, T.NBIN_BOND)
    cacn_q, cacn_min, cacn_cf = quant(cacn, mtor, T.NBIN_BOND)
    cnca_q, cnca_min, cnca_cf = quant(cnca, mtor, T.NBIN_BOND)

    # record i stores n_ca_c(i+1): the class-0 stream shifted left by one
    # across the slice boundary (a 1-row halo)
    ncac_rec = torch.cat([ncac_q[1:], _halo_right(ncac_q, mesh, 1)])

    rec_mask = idx < n_res - 1          # the last residue stores zeros
    res_ok = idx < n_res

    def keep(mask, v):
        return torch.where(mask, v, 0)

    records = pack_records(keep(res_ok, res_code), keep(rec_mask, phi_q),
                           keep(rec_mask, psi_q), keep(rec_mask, om_q),
                           keep(rec_mask, ncac_rec), keep(rec_mask, cacn_q),
                           keep(rec_mask, cnca_q))

    # side chains are residue-local (atom14 slots): the fixed [-180, 180]
    # 255-bin truncating quantizer, the predecessors by where-chains
    sxa, sya, sza = (atom14[:, :, c].T for c in range(3))    # [14, ls]
    codes_c = torch.clamp(res_code.to(torch.int64), 0, 23)
    preds = torch.as_tensor(np.asarray(PRED_IDX, np.int32),
                            device=dev)[codes_c]             # [ls, 14, 3]

    def sel(arr, pidx, upto):
        acc = arr[0]
        for kk in range(1, upto):
            acc = torch.where(pidx == kk, arr[kk], acc)
        return acc

    sc_rows = []
    for ka in range(3, MAX_ATOM):
        p0, p1, p2 = preds[:, ka, 0], preds[:, ka, 1], preds[:, ka, 2]
        sc_rows.append(dihedral_c(
            sel(sxa, p0, ka), sel(sya, p0, ka), sel(sza, p0, ka),
            sel(sxa, p1, ka), sel(sya, p1, ka), sel(sza, p1, ka),
            sel(sxa, p2, ka), sel(sya, p2, ka), sel(sza, p2, ka),
            sxa[ka], sya[ka], sza[ka]))
    sc_ang = torch.stack(sc_rows, dim=-1)                    # [ls, 11]
    sc_q = torch.clamp(((sc_ang + 180.0) * float(T.SC_DISC_F)).to(I32),
                       0, 255).to(torch.uint8)

    # temperature factors: the per-chain rounding quantizer
    tf_q, tf_min, tf_cont = quant(tf_ca, res_ok, NBIN_TEMP)
    tf_q = keep(res_ok, tf_q).to(torch.uint8)

    return dict(records=records, sc_q=sc_q, tf_q=tf_q,
                mins=torch.stack([phi_min, psi_min, om_min, ncac_min,
                                  cacn_min, cnca_min]),
                cont_fs=torch.stack([phi_cf, psi_cf, om_cf, ncac_cf,
                                     cacn_cf, cnca_cf]),
                tf_min=tf_min, tf_cont=tf_cont)


def encode_long_chain(atoms, mesh: Mesh, anchor_threshold: int = 25):
    """AtomArray fragment -> FCZ bytes through the sequence-parallel
    encoder (foldcomp_tpu/parallel/seqpar.py:226). Every rank passes the
    whole fragment and encodes its slice on its device; the slices are
    gathered on rank 0, which returns the serialized stream with the
    exact float32 anchor coordinates (codec/fcz.serialize). The other
    ranks return None. The FCZ header counts anchors in a u8: at the
    default interval a chain past ~6,300 residues cannot be serialized
    (ValueError), as the exact encoder refuses it."""
    from ..codec.batch_host import _anchor_indices, fragment_to_tensors
    from ..codec.fcz import FczData, serialize
    from ..core.aatable import N_SC_TORSION
    from ..core.codes import NUM_AA

    a14, rc, tf, meta = fragment_to_tensors(atoms)
    n = a14.shape[0]
    anchors = _anchor_indices(n, anchor_threshold)
    if len(anchors) > 255:
        raise ValueError(f"{n} residues need {len(anchors)} anchors; the "
                         "FCZ header holds 255")
    ls = -(-n // mesh.size)
    l = ls * mesh.size
    a14p = np.zeros((l, 14, 3), np.float32)
    rcp = np.zeros(l, np.int32)
    tfp = np.zeros(l, np.float32)
    a14p[:n], rcp[:n], tfp[:n] = a14, rc, tf
    lo, hi = mesh.rank * ls, (mesh.rank + 1) * ls
    out = sharded_encode_features(
        mesh, torch.from_numpy(a14p[lo:hi]).to(mesh.device),
        torch.from_numpy(rcp[lo:hi]).to(mesh.device),
        torch.from_numpy(tfp[lo:hi]).to(mesh.device), n)
    parts = {k: mesh.gather(out[k]) for k in ("records", "sc_q", "tf_q")}
    if mesh.rank != 0:
        return None
    records, sc_q, tf_q = (torch.cat(parts[k]).cpu().numpy()[:n]
                           for k in ("records", "sc_q", "tf_q"))
    counts = np.where(rc < NUM_AA, N_SC_TORSION[np.minimum(rc, 23)], 0)
    sc_stream = sc_q[np.arange(sc_q.shape[1])[None, :] < counts[:, None]]
    fcz = FczData(
        n_residue=n, n_atom=meta["n_atom"],
        idx_residue=meta["idx_residue"], idx_atom=meta["idx_atom"],
        n_anchor=len(anchors), chain=meta["chain"],
        n_sc_torsion=len(sc_stream),
        first_residue=meta["first_residue"],
        last_residue=meta["last_residue"], title=meta["title"],
        mins=out["mins"].cpu().numpy(), cont_fs=out["cont_fs"].cpu().numpy(),
        anchor_indices=anchors,
        anchor_coords=a14[anchors, :3].astype(np.float32),
        has_oxt=meta["has_oxt"], oxt_coords=meta["oxt_coords"],
        records=records, sc_codes=sc_stream.astype(np.uint8),
        tf_min=np.float32(out["tf_min"].item()),
        tf_cont=np.float32(out["tf_cont"].item()),
        tf_codes=tf_q.astype(np.uint8))
    return serialize(fcz)


def reference_backbone_features(flat_x, flat_y, flat_z):
    """The unsharded twin of sharded_backbone_features, for validation:
    the whole [T] chain on one device."""
    tors = dihedral_c(flat_x[:-3], flat_y[:-3], flat_z[:-3],
                      flat_x[1:-2], flat_y[1:-2], flat_z[1:-2],
                      flat_x[2:-1], flat_y[2:-1], flat_z[2:-1],
                      flat_x[3:], flat_y[3:], flat_z[3:])
    angs = bond_angle_c(flat_x[:-2], flat_y[:-2], flat_z[:-2],
                        flat_x[1:-1], flat_y[1:-1], flat_z[1:-1],
                        flat_x[2:], flat_y[2:], flat_z[2:])
    return (torch.nn.functional.pad(tors, (0, 3)),
            torch.nn.functional.pad(angs, (0, 2)))
