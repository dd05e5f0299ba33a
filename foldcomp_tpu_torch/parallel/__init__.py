"""Multi-device and multi-host parallel layers (the port's copy of
foldcomp_tpu/parallel/).

- dist:     contiguous-range database shards and the index-rebasing merge;
            init_distributed joins a torch.distributed process group (NCCL
            between cards, gloo on the CPU), spawn_ranks starts one
            process per rank on this host
- hybrid:   CPU + CUDA work stealing over one database
- pipeline: the data-parallel roundtrip step on the production kernels,
            one rank per card, one all_reduce for the global RMSD
- seqpar:   sequence-parallel encode of one long chain (all_gather halo,
            all_reduce MIN/MAX quantizer ranges, per-rank record packing)
- scaling:  residues/s per device across world sizes

The JAX package maps its steps over a jax.sharding.Mesh in one process;
here every rank is a process with its own device, and pipeline.Mesh is
that rank's view of the mesh. pipeline's and seqpar's symbols are
re-exported lazily: importing `parallel.dist` or `parallel.hybrid` (the
native CPU workers, thread or process) must not load torch, and neither
module imports it outside the functions that use a device or a process
group.
"""


def __getattr__(name):
    if name in ("make_mesh", "make_roundtrip_step", "roundtrip_core",
                "shard_batch"):
        from . import pipeline
        return getattr(pipeline, name)
    if name in ("encode_long_chain", "sharded_encode_features",
                "sharded_backbone_features"):
        from . import seqpar
        return getattr(seqpar, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
