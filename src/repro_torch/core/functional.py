"""Function datasets with closed-form similarities (paper Sec. 4), the port
of ``repro/core/functional.py``.

* Random sines f(x) = sin(2 pi x + delta), delta ~ U[0, 2 pi), on [0, 1]:
  <f, g> = cos(delta_f - delta_g) / 2, cossim = cos(delta_f - delta_g),
  ||f - g|| = sqrt(1 - cos(delta_f - delta_g)).
* Random 1-D Gaussians (means U[-1, 1], variances U[0, 1]) with the
  Olkin-Pukelsheim W^2 closed form (``wasserstein.gaussian_w2``).

Draws come from a ``torch.Generator`` on its device (the JAX package's
``jax.random`` bits cannot be reproduced).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _uniform(generator: torch.Generator, n: int, lo: float, hi: float
             ) -> torch.Tensor:
    u = torch.rand((n,), generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def random_sines(generator: torch.Generator, n: int) -> torch.Tensor:
    """Phases delta (n,) of f_i(x) = sin(2 pi x + delta_i)."""
    return _uniform(generator, n, 0.0, 2.0 * torch.pi)


def sine_values(delta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(batch...,) phases x (n,) nodes -> (batch..., n) samples."""
    return torch.sin(2.0 * torch.pi * x[None, :] + delta[..., None])


def sine_cossim(d1, d2) -> torch.Tensor:
    return torch.cos(d1 - d2)


def sine_inner(d1, d2) -> torch.Tensor:
    return 0.5 * torch.cos(d1 - d2)


def sine_l2_dist(d1, d2) -> torch.Tensor:
    return torch.sqrt(torch.clamp(1.0 - torch.cos(d1 - d2), min=0.0))


def random_gaussians(generator: torch.Generator, n: int,
                     mu_range: Tuple[float, float] = (-1.0, 1.0),
                     sigma_range: Tuple[float, float] = (0.0, 1.0)
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu, sigma), each (n,): mu ~ U[mu_range], sigma = sqrt(v) with v ~
    U[sigma_range[0]^2, sigma_range[1]^2] (the paper: variances U[0, 1])."""
    mu = _uniform(generator, n, *mu_range)
    var = _uniform(generator, n, sigma_range[0] ** 2, sigma_range[1] ** 2)
    return mu, torch.sqrt(var)
