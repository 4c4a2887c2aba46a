"""Hand-written Hopper kernels of the port and their plain versions.

K1 ``hash_mm``, K2 ``fused_query``, K3 ``merge`` and K4 ``dct_mm`` are CUDA
C++ under ``csrc/``, built by :mod:`._build`; :mod:`.ops` routes CUDA
tensors to them and CPU tensors to :mod:`.ref`.
"""
