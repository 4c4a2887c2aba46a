"""Hand-written Hopper kernels of the port and their plain versions.

K1 ``hash_mm``, K2 ``fused_query``, K3 ``merge``, K4 ``dct_mm``, K5
``quantized_query``, K6 ``rerank`` and K7 ``simhash_pack`` are CUDA C++
under ``csrc/``, built by :mod:`._build`; :mod:`.ops` routes CUDA tensors
to them and CPU tensors to :mod:`.ref`.  :mod:`.quantize` is the storage
tier's codec and survivor rescore.
"""
