"""foldcomp_tpu_torch: the PyTorch/CUDA port of foldcomp_tpu's device paths.

The package stands on its own: it imports nothing of `foldcomp_tpu` and
nothing of JAX. It carries its own copies of the byte-exact host layers
(core/, io/, codec/fcz.py, extract.py, encoder.py, decoder.py, the host
stages of the batched codec in codec/batch_host.py, the ctypes binding
native.py and the CLI), which build the repository's one C codec
(native/fcio.c, native/fccodec.c) into the port's own directory. Its
device kernels are hand-written CUDA for Hopper (kernels/csrc/), each
beside a plain PyTorch version that is the CPU path and the kernel's
oracle.

Modules are imported lazily; `import foldcomp_tpu_torch` stays cheap and
loads neither torch nor JAX.
"""

__version__ = "0.1.0"
