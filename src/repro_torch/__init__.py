"""The PyTorch/CUDA port of the SDP streaming partitioner.

A second package beside the JAX reference ``repro``: it imports torch and
numpy only, never jax and nothing of ``repro``. Entry points run on the
CUDA card unless the caller passes ``device="cpu"``; the kernels are CUDA
C++ for Hopper (``csrc/``), each with a plain PyTorch version that runs
for CPU tensors.
"""
