"""Orthonormal-basis constants for the basis embedder (paper Sec. 3.1).

The port keeps what the embedder needs: Chebyshev nodes and the DCT-II
matrix (the Chebyshev path's matmul runs on K4), plus the Gauss-Legendre
design matrix (the Legendre path stays a plain matmul, as in JAX).  The
matrices are built in float64 numpy and cast once, so both packages hold
the same float32 constants.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def cheb_nodes(n: int, interval: Tuple[float, float] = (-1.0, 1.0)
               ) -> torch.Tensor:
    """Chebyshev points of the first kind mapped to ``interval``:
    x_j = cos(pi (j + 1/2) / n), j = 0..n-1 (descending), float32."""
    a, b = interval
    j = torch.arange(n, dtype=torch.float32)
    x = torch.cos(torch.pi * (j + 0.5) / n)
    return 0.5 * (a + b) + 0.5 * (b - a) * x


def dct2_matrix(n: int) -> torch.Tensor:
    """M with M @ fvals = DCT-II(fvals) (scipy norm=None):
    M[k, j] = 2 cos(pi k (2j + 1) / (2n)), float32."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    m = 2.0 * np.cos(np.pi * k * (2 * j + 1) / (2 * n))
    return torch.as_tensor(m, dtype=torch.float32)


@functools.lru_cache(maxsize=32)
def _legendre_quad(n_coeff: int, n_quad: int):
    """Gauss-Legendre nodes and L[k, i] = sqrt((2k+1)/2) P_k(t_i) w_i."""
    t, w = np.polynomial.legendre.leggauss(n_quad)
    P = np.zeros((n_coeff, n_quad))
    P[0] = 1.0
    if n_coeff > 1:
        P[1] = t
    for k in range(2, n_coeff):
        P[k] = ((2 * k - 1) * t * P[k - 1] - (k - 1) * P[k - 2]) / k
    norm = np.sqrt((2 * np.arange(n_coeff) + 1) / 2.0)
    return t, norm[:, None] * P * w[None, :]


def legendre_nodes(n_coeff: int, interval: Tuple[float, float] = (-1.0, 1.0),
                   n_quad: int | None = None) -> torch.Tensor:
    a, b = interval
    t, _ = _legendre_quad(n_coeff, n_quad or 2 * n_coeff)
    return torch.as_tensor(0.5 * (a + b) + 0.5 * (b - a) * t,
                           dtype=torch.float32)


def legendre_l2_coeffs(fvals: torch.Tensor,
                       interval: Tuple[float, float] = (-1.0, 1.0),
                       n_coeff: int | None = None) -> torch.Tensor:
    """gamma_k = <e_k, f> in L^2([a, b], dx), e_k orthonormal Legendre;
    ``fvals`` sampled at ``legendre_nodes(n_coeff, interval, n_quad)``."""
    a, b = interval
    n_quad = fvals.shape[-1]
    _, L = _legendre_quad(n_coeff or n_quad // 2, n_quad)
    Lj = torch.as_tensor(L, dtype=torch.float32, device=fvals.device)
    return (fvals @ Lj.T) * float(np.float32(np.sqrt((b - a) / 2.0)))
