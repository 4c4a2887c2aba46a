"""Theoretical collision probabilities and the paper's Theorem 1 bounds, the
port of ``repro/core/collision.py``.

* SimHash (Eq. 7):      P = 1 - arccos(cossim) / pi.
* p-stable hash (Eq. 8): P(c) = int_0^r (1/c) f_p(t/c) (1 - t/r) dt with f_p
  the pdf of |X|, X p-stable.  Closed forms at p = 2 (Gaussian) and p = 1
  (Cauchy); a Monte Carlo estimate over 200,000 p-stable draws otherwise.
* Theorem 1: bounds on the collision probability after an embedding with
  distance error <= eps, as stated and as corrected.

Values are f32 tensors, as the JAX package's are with x64 off.
"""

from __future__ import annotations

import numpy as np
import torch

SQRT_2_OVER_PI = float(np.sqrt(2.0 / np.pi))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def simhash_collision_prob(cossim) -> torch.Tensor:
    """Eq. (7)."""
    s = torch.clamp(_f32(cossim), -1.0, 1.0)
    return 1.0 - torch.arccos(s) / torch.pi


def pstable_collision_prob(c, r: float, p: float = 2.0) -> torch.Tensor:
    """Eq. (8) and its p = 1 analogue; c = ||x - y||_p > 0."""
    c = _f32(c)
    if p == 2.0:
        # P = 2 Phi(r/c) - 1 - 2c/(sqrt(2 pi) r) (1 - exp(-r^2 / 2 c^2))
        z = r / c
        phi = 0.5 * (1.0 + torch.special.erf(z / float(np.sqrt(2.0))))
        return 2.0 * phi - 1.0 - (2.0 * c / (np.sqrt(2.0 * np.pi) * r)) * (
            1.0 - torch.exp(-(z ** 2) / 2.0))
    if p == 1.0:
        # f_1(t) = 2 / (pi (1 + t^2)):
        # P = (2/pi) [ arctan(r/c) - c/(2r) ln(1 + (r/c)^2) ]
        z = r / c
        return (2.0 / torch.pi) * (torch.arctan(z)
                                   - (1.0 / (2.0 * z)) * torch.log1p(z ** 2))
    return _pstable_collision_prob_mc(c, r, p)


def _pstable_collision_prob_mc(c, r: float, p: float,
                               n_samples: int = 200_000, seed: int = 0
                               ) -> torch.Tensor:
    """Quadrature-free estimate for any p: P = E[(1 - |c X| / r)_+] over
    ``n_samples`` p-stable X from a CPU generator seeded with ``seed``."""
    from .hashes import sample_pstable   # hashes imports kernels; keep lazy
    x = sample_pstable(torch.Generator().manual_seed(seed), (n_samples,),
                       p).abs()
    c = torch.atleast_1d(_f32(c))
    t = c[:, None] * x[None, :]
    val = torch.clamp(1.0 - t / r, min=0.0).mean(dim=1)
    return val[0] if val.shape == (1,) else val


def fp_sup(p: float) -> float:
    """||f_p||_inf for the pdf of |X| (Theorem 1 constant)."""
    if p == 2.0:
        return SQRT_2_OVER_PI          # 2 * (1/sqrt(2 pi)) at 0
    if p == 1.0:
        return 2.0 / np.pi             # 2/(pi (1+t^2)) at 0
    raise ValueError(f"fp_sup known only for p in {{1, 2}}, got {p}")


def _bounds(c, r, eps, p, lower_fp):
    c, eps = _f32(c), _f32(eps)
    P = pstable_collision_prob(c, r, p)
    finf = fp_sup(p)
    upper = P + torch.minimum(eps / (c - eps),
                              eps * r * finf / (2.0 * (c - eps) ** 2))
    lower = P - torch.minimum(2.0 * eps / (c + eps), lower_fp(c, eps, finf))
    return torch.clamp(lower, 0.0, 1.0), torch.clamp(upper, 0.0, 1.0)


def theorem1_bounds(c, r: float, eps, p: float = 2.0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Theorem 1 as stated in the paper: (lower, upper) bounds on P[H(f) =
    H(g)] when the embedding moves c = ||f - g|| by at most eps.  Its
    ||f_p||_inf lower bound drops a boundary integral and can be violated
    by O(eps^2 / c^2) (see :func:`theorem1_bounds_corrected`)."""
    return _bounds(c, r, eps, p, lambda c, e, f: e * r * f
                   / (2.0 * (c + e) ** 2))


def theorem1_bounds_corrected(c, r: float, eps, p: float = 2.0
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Theorem 1 with the lower bound's ||f_p||_inf branch repaired:
    deficit <= eps r ||f_p||_inf / (2 c (c + eps))."""
    return _bounds(c, r, eps, p, lambda c, e, f: e * r * f
                   / (2.0 * c * (c + e)))


def expected_collisions_k_l(P1, k: int, l: int) -> torch.Tensor:
    """(k AND, l OR) amplification: the probability that the structure
    reports a pair whose single-hash collision probability is P1."""
    return 1.0 - (1.0 - _f32(P1) ** k) ** l
