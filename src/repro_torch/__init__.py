"""PyTorch/CUDA port of the function-space LSH system (``repro``).

Mirrors the JAX package's module paths.  Its kernels are hand-written CUDA
C++ for Hopper (``csrc/``), built with nvcc on first use; entry points run
on the card unless the caller passes ``device="cpu"``, where each kernel's
plain PyTorch version runs instead.  Nothing here imports jax or repro.
"""
