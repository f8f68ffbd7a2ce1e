"""Kernels of the port: CUDA C++ for ``sm_90a`` beside a plain PyTorch version.

Each wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; it counts its kernel launches in a ``launches`` attribute.
"""
