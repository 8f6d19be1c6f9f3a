"""PyTorch / CUDA port of classpose_tpu for NVIDIA Hopper (H100).

The JAX package ``classpose_tpu`` stays the reference; this package
imports nothing of it and nothing of JAX. Its hand-written CUDA kernels
(``csrc/``) are built by nvcc into ``_build/`` on first use.
"""
