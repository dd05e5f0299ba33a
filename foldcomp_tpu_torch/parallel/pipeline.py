"""Multi-device data-parallel codec pipeline on torch.distributed.

The port's counterpart of foldcomp_tpu/parallel/pipeline.py. The JAX
package shards a padded protein batch over a jax.sharding.Mesh and maps one
step over it with shard_map; here each rank is a process with its own
device (the torchrun model, parallel/dist.py init_distributed), holds its
contiguous slice of the batch (`shard_batch`, the rows P("data") gives it)
and runs the step on it. Per-protein encode and decode need no
communication, so the only collective is the one all_reduce that merges
the ranks' quality statistics into the global RMSD, the JAX step's `psum`.

Each rank's step runs the port's production kernels on its card: the
batched encode (codec/batch.encode_tensor_batch: k4_fused_encode and the
host rescue, FCZ byte-identical to the exact encoder), then the decode of
those FCZ records on the full wire (k1_tails, k2_backbone + k2_copy_out,
k3_sidechain) and the host stitch. On the CPU the same calls run the
kernels' plain versions.

A gloo group cannot run every collective on CUDA tensors; a Mesh whose
group is gloo and whose device is CUDA (two ranks on one card, which NCCL
refuses) stages its collectives' tensors through host memory
(`Mesh.staged`). The choice follows from the group's backend and the
device, and is not a fallback.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..backend import resolve_device
from ..core.aatable import MAX_ATOM, N_ATOMS

F32 = torch.float32
I32 = torch.int32
_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-D device mesh: its rank and the mesh size,
    its device, the process group (None at size 1, where every collective
    is the identity), the axis name and the process group's backend."""
    rank: int
    size: int
    device: torch.device
    group: object | None
    axis_name: str = "data"
    backend: str | None = None

    @property
    def staged(self) -> bool:
        """Collectives copy CUDA tensors through host memory (gloo)."""
        return self.group is not None and self.backend == "gloo" \
            and self.device.type == "cuda"

    def all_reduce(self, t, op: str = "sum"):
        """t reduced over the mesh by `op` (sum, min or max), a new tensor
        on t's device."""
        if self.group is None:
            return t.clone()
        import torch.distributed as tdist
        buf = t.cpu() if self.staged else t.clone()
        tdist.all_reduce(buf, getattr(tdist.ReduceOp, _OPS[op]),
                         group=self.group)
        return buf.to(t.device)

    def all_gather(self, t):
        """[every rank's t] in rank order (t: same shape on every rank)."""
        if self.group is None:
            return [t]
        import torch.distributed as tdist
        src = t.contiguous().cpu() if self.staged else t.contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        tdist.all_gather(out, src, group=self.group)
        return [o.to(t.device) for o in out]

    def gather(self, t):
        """[every rank's t] in rank order on rank 0, None on the others."""
        if self.group is None:
            return [t]
        import torch.distributed as tdist
        src = t.contiguous().cpu() if self.staged else t.contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)] \
            if self.rank == 0 else None
        tdist.gather(src, out, dst=0, group=self.group)
        return None if out is None else [o.to(t.device) for o in out]


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              device=None) -> Mesh:
    """This rank's mesh over every rank of the default process group
    (parallel/dist.py init_distributed), or a one-rank mesh: without a
    process group, or with n_devices=1 (each rank alone, as the
    comparisons with a one-device run use it). Other sizes need that many
    ranks. device: this rank's device (default dist.local_device())."""
    import torch.distributed as tdist

    from .dist import local_device
    dev = local_device() if device is None else resolve_device(device)
    if not (tdist.is_available() and tdist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} devices needs as many "
                             "ranks: call init_distributed first")
        return Mesh(0, 1, dev, None, axis_name)
    backend = tdist.get_backend()
    world = tdist.get_world_size()
    n = world if n_devices is None else n_devices
    if n == 1:
        return Mesh(0, 1, dev, None, axis_name, backend)
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} "
                         "ranks: start one rank per device")
    return Mesh(tdist.get_rank(), world, dev, tdist.group.WORLD, axis_name,
                backend)


def device_segments(n_res, l: int, s_max: int, threshold: int):
    """Anchor segmentation on the device (_setAnchor parity,
    foldcomp.cpp:745-761), foldcomp_tpu/parallel/pipeline.py:37-59.

    n_res: i32 [B]; returns (anchor_idx [B, s_max+1], seg_start [B, s_max],
    seg_m [B, s_max]), i32, with padded segments pushed past the stitch
    window."""
    n_res = torch.as_tensor(n_res, dtype=I32)
    dev = n_res.device
    n_inner = n_res // threshold
    n_all = n_inner + 2
    interval = n_res // (n_all - 1)
    s = torch.arange(s_max + 1, dtype=I32, device=dev)[None, :]
    is_inner = s < (n_all[:, None] - 1)
    anchor_idx = torch.where(is_inner, s * interval[:, None],
                             n_res[:, None] - 1)
    seg_start = anchor_idx[:, :-1]
    n_seg = n_all - 1
    seg_ar = torch.arange(s_max, dtype=I32, device=dev)[None, :]
    seg_valid = seg_ar < n_seg[:, None]
    nxt = torch.minimum(anchor_idx[:, 1:] + 1, n_res[:, None] - 1)
    is_final = seg_ar == (n_seg[:, None] - 1)
    seg_m = torch.where(is_final, n_res[:, None] - seg_start,
                        nxt - seg_start)
    seg_m = torch.where(seg_valid, torch.clamp_min(seg_m, 1), 1)
    seg_start = torch.where(seg_valid, seg_start, l + s_max + 2)
    return anchor_idx.to(I32), seg_start.to(I32), seg_m.to(I32)


def atom_mask(res_code):
    """bool [..., 14]: the atom slot exists for this residue code
    (foldcomp_tpu/kernels/sidechain.py:215 atom_mask)."""
    code = torch.clamp(res_code.to(torch.int64), 0, 23)
    n = torch.as_tensor(np.asarray(N_ATOMS, np.int32),
                        device=code.device)[code]
    slots = torch.arange(MAX_ATOM, dtype=I32, device=code.device)
    return slots < n[..., None]


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# the header fields encode_tensor_batch puts beside each row's records in
# its FczData; the roundtrip reads only the records
_META = dict(n_atom=0, idx_residue=1, idx_atom=1, chain="A",
             first_residue="X", last_residue="X", title="", has_oxt=False,
             oxt_coords=np.zeros(3, np.float32))


def roundtrip_core(atom14, res_code, tf_ca, res_mask, *, threshold: int = 25,
                   refine_iters: int = 2, device=None):
    """One shard's pipeline step: encode -> decode -> quality statistics.

    atom14 f32 [B, L, 14, 3], res_code i32 [B, L], tf_ca f32 [B, L] and
    res_mask bool [B, L] (tensors or arrays; each row's real residues a
    prefix of 2 or more). Returns (records u8 [B, L, 8], atom14_dec f32
    [B, L, 14, 3], sum_sq f32 [], n_atoms f32 []) on `device` (default:
    the card, or the inputs' device when they are tensors); padding rows
    are zero.

    Unlike foldcomp_tpu's core (:61), which takes `s_max` and `seg_width`
    to size its dense [B, S] segment grid, this one has no such
    arguments: the decode packs ragged lanes, one per protein and anchor
    segment, each as wide as its own segment. The encode is the port's
    batched encode of the real residues (records byte-identical to the
    exact encoder's), the decode runs those records through the full wire
    (pinned, so that the side-chain kernel places every atom; one lane
    class, so that each kernel launches once a step) and the host stitch, and the masked squared error is summed on the device."""
    from ..codec.batch import (_outs_to_host, _seg_decode_arrays,
                               arrays_to_torch, encode_tensor_batch,
                               pack_decode_wire)
    from ..codec.batch_host import _gather_a14

    if device is None and isinstance(atom14, torch.Tensor):
        device = atom14.device
    dev = resolve_device(device)
    a14, rc, tf, mask = (_host(atom14), _host(res_code), _host(tf_ca),
                         _host(res_mask).astype(bool))
    b, l = rc.shape
    n_res = mask.sum(axis=1)
    if not np.array_equal(mask, np.arange(l)[None, :] < n_res[:, None]):
        raise ValueError("res_mask: each row's residues must be a prefix")
    if b and n_res.min() < 2:
        raise ValueError("every row needs at least 2 residues")
    frags = [(a14[k, :n], rc[k, :n], tf[k, :n]) for k, n in enumerate(n_res)]
    fczs = encode_tensor_batch(frags, [_META] * b, threshold, device=dev)
    if any(f is None for f in fczs):
        raise ValueError("a row has more anchors than the FCZ header holds")

    records = np.zeros((b, l, 8), np.uint8)
    dec = np.zeros((b, l, MAX_ATOM, 3), np.float32)
    if b:
        arrays, dmetas = pack_decode_wire(fczs, False, wclass="0")
        outs = _outs_to_host(_seg_decode_arrays(
            arrays_to_torch(arrays, dev), refine_iters))
        for k, (f, m) in enumerate(zip(fczs, dmetas)):
            records[k, :f.n_residue] = f.records
            dec[k, :f.n_residue] = _gather_a14(outs, m)

    dec_t = torch.from_numpy(dec).to(dev)
    a14_t = torch.as_tensor(atom14, dtype=F32).to(dev)
    amask = atom_mask(torch.as_tensor(res_code).to(dev)) & \
        torch.as_tensor(res_mask).to(dev, torch.bool)[..., None]
    err = torch.where(amask[..., None], dec_t - a14_t, 0.0)
    sum_sq = torch.sum(err * err)
    n_atoms = torch.sum(amask).to(F32)
    return torch.from_numpy(records).to(dev), dec_t, sum_sq, n_atoms


def make_roundtrip_step(mesh: Mesh, *, threshold: int = 25,
                        refine_iters: int = 2):
    """The data-parallel roundtrip step on this rank's shard
    (foldcomp_tpu/parallel/pipeline.py:91).

    step(atom14, res_code, tf_ca, res_mask) -> (records, atom14_dec,
    global_rmsd): the shard's records and decoded atoms, and the all-atom
    RMSD over every rank's shard, from one all_reduce(SUM) of [sum_sq,
    n_atoms] over the mesh's group (the JAX step's psum)."""
    def step(atom14, res_code, tf_ca, res_mask):
        records, atom14_dec, sum_sq, n_atoms = roundtrip_core(
            atom14, res_code, tf_ca, res_mask, threshold=threshold,
            refine_iters=refine_iters, device=mesh.device)
        g_sum, g_n = mesh.all_reduce(torch.stack([sum_sq, n_atoms]))
        global_rmsd = torch.sqrt(g_sum / torch.clamp_min(g_n, 1.0))
        return records, atom14_dec, global_rmsd

    return step


def shard_batch(mesh: Mesh, arrays):
    """This rank's contiguous slice of each array's batch axis (the rows
    P("data") gives rank `mesh.rank`), as tensors on the mesh's device.
    The batch must divide by the mesh size: nothing is padded."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.shape[0] % mesh.size:
            raise ValueError(f"batch of {t.shape[0]} rows does not divide "
                             f"over {mesh.size} ranks")
        k = t.shape[0] // mesh.size
        out.append(t[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device))
    return tuple(out)
