"""BasisEmbedder: truncated orthonormal-basis embedding (paper Eq. 3).

Chebyshev (the paper's choice) folds the node weight, the DCT-II and the
orthonormal scale into one ``(F * pre) @ M^T * scale`` and runs it through
``ops.cheb_embed`` -- K4 ``dct_mm`` on the card.  Legendre's design matrix
is (2N, N), outside K4's square contract, so it stays a plain matmul, as in
the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import basis
from ..kernels import ops
from .base import FunctionEmbedder, register_embedder


@register_embedder("basis")
class BasisEmbedder(FunctionEmbedder):
    """Chebyshev/Legendre orthonormal truncation: (B, in_width) -> (B, N).

    ``basis`` is ``"chebyshev"`` (default) or ``"legendre"``; ``measure``
    (Chebyshev only) is ``"lebesgue"`` (default) or ``"theta"``.
    """

    def __init__(self, n_dims: int, p: float = 2.0, volume: float = 1.0,
                 interval: Tuple[float, float] = (-1.0, 1.0),
                 basis: str = "chebyshev", measure: str = "lebesgue",
                 device=None):
        super().__init__(n_dims, p, interval=interval, volume=volume,
                         device=device)
        if basis not in ("chebyshev", "legendre"):
            raise ValueError(f"unknown basis {basis!r}")
        if measure not in ("lebesgue", "theta"):
            raise ValueError(f"unknown measure {measure!r}")
        self.basis = basis
        self.measure = measure
        if basis == "chebyshev":
            pre, mat, scale = cheb_kernel_constants(n_dims, self.interval,
                                                    measure)
            self.set_constants(pre, mat, scale)

    def set_constants(self, pre, mat, scale) -> None:
        """Install the (pre, mat, scale) triple K4 consumes -- e.g. the JAX
        package's, carried over by ``convert.basis_constants_from_numpy``."""
        self._pre, self._mat, self._scale = (
            torch.as_tensor(t, dtype=torch.float32,
                            device=self.device).contiguous()
            for t in (pre, mat, scale))

    def nodes(self) -> np.ndarray:
        if self.basis == "chebyshev":
            return basis.cheb_nodes(self.n_dims, self.interval).numpy()
        return basis.legendre_nodes(self.n_dims, self.interval,
                                    n_quad=2 * self.n_dims).numpy()

    def params(self) -> dict:
        return {"interval": list(self.interval), "basis": self.basis,
                "measure": self.measure}

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        if self.basis == "legendre":
            return basis.legendre_l2_coeffs(x, self.interval,
                                            n_coeff=self.n_dims)
        return ops.cheb_embed((x * self._pre).contiguous(), self._mat,
                              self._scale)


def cheb_kernel_constants(n: int, interval: Tuple[float, float],
                          measure: str
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Node weight, transposed DCT-II matrix and fused scale, float32:
    the Chebyshev embedding is ``((F * pre) @ mat) * scale``."""
    a, b = interval
    j = np.arange(n)
    t = np.cos(np.pi * (j + 0.5) / n)
    pre = (1.0 - t * t) ** 0.25 if measure == "lebesgue" else np.ones(n)
    s1 = np.concatenate([[0.5 / n], np.full(n - 1, 1.0 / n)])
    s2 = np.concatenate([[np.sqrt(np.pi)],
                         np.full(n - 1, np.sqrt(np.pi / 2.0))])
    scale = s1 * s2 * np.sqrt((b - a) / 2.0)
    return (pre.astype(np.float32),
            np.ascontiguousarray(basis.dct2_matrix(n).T.numpy()),
            scale.astype(np.float32))
