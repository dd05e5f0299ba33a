"""foldcomp_tpu_torch: the PyTorch/CUDA port of foldcomp_tpu's device paths.

The byte-exact host layers (FCZ parse/serialize, the ragged-lane pack, the
native C codec and PDB formatter, the database engine) are imported from
`foldcomp_tpu`, which loads no JAX for them; this package ports only the
device decode and its glue. Its kernels are hand-written CUDA for Hopper
(kernels/csrc/fused_decode.cu), each beside a plain PyTorch version that
is the CPU path and the kernel's oracle.

Modules are imported lazily; `import foldcomp_tpu_torch` stays cheap and
loads neither torch nor JAX.
"""

__version__ = "0.1.0"
