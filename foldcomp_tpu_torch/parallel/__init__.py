"""Database parallelism on one host (the port's copy of
foldcomp_tpu/parallel/, host parts).

- dist:   contiguous-range database shards and the index-rebasing merge
- hybrid: CPU + CUDA work stealing over one database

Both import torch only inside their device functions, so that native CPU
workers, thread or process, never pay for it or create a CUDA context.
The multi-device layers (the JAX package's pipeline, seqpar, scaling and
dist.init_distributed) are not ported yet.
"""
