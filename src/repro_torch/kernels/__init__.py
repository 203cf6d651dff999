"""Hand-written Hopper kernels of the port.

Each kernel package keeps three files: ``kernel.py`` wraps the CUDA kernel
(built from ``csrc/`` by ``_build``), ``ops.py`` dispatches (kernel for a
CUDA tensor, plain version for a CPU tensor), ``ref.py`` holds the plain
PyTorch version the kernel is held against.
"""
