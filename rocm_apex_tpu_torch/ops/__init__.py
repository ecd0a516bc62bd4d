"""Hand-written Hopper kernels and their plain PyTorch versions.

Every module that wraps a kernel registers it in `_build.KERNELS`; a
wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version only for CPU tensors.
"""
