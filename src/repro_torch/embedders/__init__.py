"""Function -> R^N embedders (port of repro/embedders).

Only the truncated orthonormal-basis embedder (paper Eq. 3) is ported so
far; the QMC and Wasserstein embedders are later slices.
"""

from .base import (FunctionEmbedder, embedder_names, make_embedder,
                   register_embedder)
from .basis import BasisEmbedder

__all__ = [
    "BasisEmbedder",
    "FunctionEmbedder",
    "embedder_names",
    "make_embedder",
    "register_embedder",
]
