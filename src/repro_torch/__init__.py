"""PyTorch/CUDA port of the function-space LSH system (``repro``).

Mirrors the JAX package's module paths.  Its kernels are hand-written CUDA
C++ for Hopper (``csrc/``), built with nvcc on first use; entry points run
on the card unless the caller passes ``device="cpu"``, where each kernel's
plain PyTorch version runs instead.  Nothing here imports jax or repro.
"""

import torch as _torch

# MKL's vector math library (torch.sqrt, exp, log and pow on CPU float
# tensors) sets itself up on its first call.  When that first call is split
# over several threads, one thread's block can come back from a less exact
# path: seen with torch 2.13's CPU build, ~2e-4 relative on a (9, 2048)
# sqrt in a few percent of fresh processes, so the plain versions' answers
# were not reproducible from process to process.  A one-element call runs
# on one thread and settles the library for the process.
_torch.sqrt(_torch.ones(1))
