"""Device kernels of the port: plain PyTorch versions beside hand-written
CUDA (csrc/), built on first use by build.py."""
