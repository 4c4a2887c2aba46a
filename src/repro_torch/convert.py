"""Carry state into the port from numpy arrays.

Tests hand the JAX package's family and built tables to the port with
``np.asarray`` of each leaf, so that both packages compute the same thing.
Nothing here imports jax: the arrays arrive as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.index import Family, LSHIndexState
from .kernels import dispatch


def _tensor(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=dev).to(dtype).contiguous()


def family_from_numpy(alpha, b, mix, device=None) -> Family:
    """(alpha (N, L*K) f32, b (L*K,) f32, mix (L, K) uint32) -> the port's
    family on ``device``; ``mix`` is held as int64 in [0, 2^32)."""
    dev = dispatch.resolve_device(device)
    mix64 = np.asarray(mix).astype(np.uint32).astype(np.int64)
    return (_tensor(alpha, torch.float32, dev), _tensor(b, torch.float32, dev),
            _tensor(mix64, torch.int64, dev))


def state_from_numpy(alpha, b, mix, table, counts, db, device=None
                     ) -> LSHIndexState:
    """A built index's leaves -> the port's ``LSHIndexState``."""
    dev = dispatch.resolve_device(device)
    a, bb, m = family_from_numpy(alpha, b, mix, device=dev)
    return LSHIndexState(alpha=a, b=bb, mix=m,
                         table=_tensor(table, torch.int32, dev),
                         counts=_tensor(counts, torch.int32, dev),
                         db=_tensor(db, torch.float32, dev))


def basis_constants_from_numpy(pre, mat, scale, device=None):
    """The Chebyshev embedder's (pre (N,), mat (N, N), scale (N,)) as f32
    tensors, ready for ``BasisEmbedder.set_constants``."""
    dev = dispatch.resolve_device(device)
    return tuple(_tensor(t, torch.float32, dev) for t in (pre, mat, scale))
