"""p-stable LSH family on R^N (Datar et al. 2004), drawn with torch.

``h(x) = floor(alpha^T x / r + b)`` with alpha i.i.d. p-stable and
b ~ U[0, 1).  The JAX package draws with ``jax.random``; torch cannot
reproduce those bits, so draws here come from an explicit
``torch.Generator`` and tests hand both packages one numpy-drawn family.
"""

from __future__ import annotations

import dataclasses

import torch


def sample_pstable(generator: torch.Generator, shape, p: float
                   ) -> torch.Tensor:
    """Symmetric p-stable samples on the generator's device: p = 2 gives
    N(0, 1), p = 1 gives Cauchy(0, 1).  Other p are not ported yet."""
    if p == 2.0:
        return torch.randn(shape, generator=generator,
                           device=generator.device)
    if p == 1.0:
        out = torch.empty(shape, device=generator.device)
        return out.cauchy_(generator=generator)
    raise ValueError(f"p must be 1 or 2 in the port, got {p}")


@dataclasses.dataclass
class PStableHash:
    """K independent p-stable hashes.  alpha (N, K); b (K,) ~ U[0, 1).
    Hashing itself is ``kernels.ops.pstable_hash_proj`` (K1 on the card)."""

    alpha: torch.Tensor
    b: torch.Tensor
    r: float
    p: float = 2.0

    @classmethod
    def create(cls, generator: torch.Generator, n_dims: int, n_hashes: int,
               r: float = 1.0, p: float = 2.0) -> "PStableHash":
        alpha = sample_pstable(generator, (n_dims, n_hashes), p)
        b = torch.rand((n_hashes,), generator=generator,
                       device=generator.device)
        return cls(alpha=alpha, b=b, r=float(r), p=p)
