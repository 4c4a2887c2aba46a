"""Orthonormal-basis embeddings (paper Sec. 3.1), the port of
``repro/core/basis.py``.

Chebyshev nodes and the DCT-II matrix (the basis embedder's Chebyshev
matmul runs on K4), the Gauss-Legendre design matrix (the Legendre path
stays a plain matmul, as in JAX), and the plain-PyTorch coefficient
functions (``cheb_coeffs``, ``cheb_l2_coeffs``; the Wasserstein module's
Chebyshev route) with Algorithm 1's truncation (``choose_Nf``,
``truncate_pad``).  The matrices are built in float64 numpy and cast once,
so both packages hold the same float32 constants.
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


# -- Chebyshev coefficients (the plain path; the embedder's runs on K4) -------


def _dct2(fvals: torch.Tensor) -> torch.Tensor:
    """DCT-II along the last axis (scipy norm=None) through one FFT
    (Makhoul's reordering): y_k = 2 Re(exp(-i pi k / 2n) FFT(v)_k) with v
    the even samples followed by the odd ones reversed."""
    n = fvals.shape[-1]
    v = torch.cat([fvals[..., ::2], fvals[..., 1::2].flip(-1)], dim=-1)
    k = torch.arange(n, dtype=torch.float64, device=fvals.device)
    w = torch.exp(-1j * torch.pi * k / (2 * n))
    return (2.0 * (torch.fft.fft(v.to(torch.float64)) * w).real).to(
        fvals.dtype)


def cheb_coeffs(fvals: torch.Tensor, use_matmul: bool = True
                ) -> torch.Tensor:
    """Chebyshev interpolation coefficients c_k from samples at first-kind
    nodes: f(x) ~= sum_k c_k T_k(x) with x_j = cheb_nodes(n).  fvals (...,
    n); c_0 = y_0 / (2n), c_k = y_k / n where y = DCT-II(fvals)."""
    n = fvals.shape[-1]
    if use_matmul:
        y = fvals @ dct2_matrix(n).to(fvals.device, fvals.dtype).T
    else:
        y = _dct2(fvals)
    scale = torch.full((n,), 1.0 / n, dtype=fvals.dtype, device=fvals.device)
    scale[0] = 0.5 / n
    return y * scale


def cheb_l2_coeffs(fvals: torch.Tensor,
                   interval: Tuple[float, float] = (-1.0, 1.0),
                   use_matmul: bool = True, measure: str = "lebesgue"
                   ) -> torch.Tensor:
    """Orthonormal-basis coefficients gamma of f from Chebyshev-node samples
    (``repro/core/basis.py:cheb_l2_coeffs``): ``measure="lebesgue"``
    expands u(x) = f(x) (1 - x^2)^(1/4), an isometry into L^2([a, b], dx);
    ``"theta"`` is the literal Sec.-3.1 cosine-series construction.  Both
    carry the sqrt((b - a) / 2) pull-back scale."""
    a, b = interval
    n = fvals.shape[-1]
    if measure == "lebesgue":
        j = torch.arange(n, dtype=fvals.dtype, device=fvals.device)
        t = torch.cos(torch.pi * (j + 0.5) / n)
        fvals = fvals * (1.0 - t * t) ** 0.25
    elif measure != "theta":
        raise ValueError(f"unknown measure {measure!r}")
    c = cheb_coeffs(fvals, use_matmul=use_matmul)
    scale = torch.full((n,), float(np.float32(np.sqrt(np.pi / 2.0))),
                       dtype=c.dtype, device=c.device)
    scale[0] = float(np.float32(np.sqrt(np.pi)))
    return c * scale * float(np.float32(np.sqrt((b - a) / 2.0)))


# -- truncation / padding: the embedding T_N of Eq. (4) -----------------------


def choose_Nf(coeffs: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """Chebfun-style plateau heuristic for the truncation length N_f: the
    smallest m such that every coefficient past m is below tol * max|c|.
    Returns int64 (...,), at least 1."""
    mag = coeffs.abs()
    keep = mag > tol * mag.amax(dim=-1, keepdim=True)
    idx = torch.arange(1, coeffs.shape[-1] + 1, device=coeffs.device)
    return torch.where(keep, idx, 0).amax(dim=-1).clamp(min=1)


def truncate_pad(coeffs: torch.Tensor, n_f, n_total: int) -> torch.Tensor:
    """T_N(f): zero the entries at index >= N_f (an int or a (...,) tensor)
    and pad or truncate to ``n_total``."""
    n = coeffs.shape[-1]
    idx = torch.arange(n, device=coeffs.device)
    if isinstance(n_f, torch.Tensor) and n_f.dim():
        keep = idx < n_f.to(coeffs.device)[..., None]
    else:
        keep = idx < int(n_f)
    masked = torch.where(keep, coeffs, 0.0)
    if n_total <= n:
        return masked[..., :n_total]
    return torch.nn.functional.pad(masked, (0, n_total - n))


def embed_functions(fn, n: int, interval: Tuple[float, float] = (-1.0, 1.0),
                    basis: str = "chebyshev") -> torch.Tensor:
    """Sample a (batched) function at the basis nodes and return T_N(f).
    ``fn`` maps (n,) nodes -> (..., n) values."""
    if basis == "chebyshev":
        return cheb_l2_coeffs(fn(cheb_nodes(n, interval)), interval)
    if basis == "legendre":
        nodes = legendre_nodes(n, interval, n_quad=2 * n)
        return legendre_l2_coeffs(fn(nodes), interval, n_coeff=n)
    raise ValueError(f"unknown basis {basis!r}")
