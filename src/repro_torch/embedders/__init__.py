"""Function -> R^N embedders (port of repro/embedders).

The paper's three constructions as spec-driven objects resolved from a
name and a params dict: the truncated orthonormal basis (Eq. 3, K4 on the
card), (Q)MC node sampling (Eq. 6) and the clipped quantile embedding of
1-D distributions (Remark 1), the last two a scale multiply, and a sort
and gather, with no kernel.
"""

from .base import (FunctionEmbedder, embedder_names, make_embedder,
                   register_embedder)
from .basis import BasisEmbedder
from .qmc import QMCEmbedder
from .wass import WassersteinEmbedder

__all__ = [
    "BasisEmbedder",
    "FunctionEmbedder",
    "QMCEmbedder",
    "WassersteinEmbedder",
    "embedder_names",
    "make_embedder",
    "register_embedder",
]
