"""1-D Wasserstein distances and their LSH embeddings (paper Sec. 2.2,
Remark 1), the port of ``repro/core/wasserstein.py``.

W^p(f, g) = || F^{-1} - G^{-1} ||_{L^p([0,1])} for distributions on R with
d(x, y) = |x - y|, so hashing W^p reduces to hashing inverse CDFs with the
function-space L^p hash.  Inverse CDFs are hashed on the clipped interval
[delta, 1 - delta] (delta = 1e-3, paper footnote 1).

Every function is plain PyTorch on its inputs' device: the JAX package has
no kernel here either.  ``empirical_icdf`` computes ``floor(u * m)`` from
the same f32 ``u`` in f32, so its quantile indices, and the embedding, are
bit-equal to the JAX package's for any m.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import basis, montecarlo

CLIP = 1e-3


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# -- closed forms (oracles) ---------------------------------------------------


def gaussian_w2(mu1, s1, mu2, s2) -> torch.Tensor:
    """Olkin & Pukelsheim closed form for 1-D Gaussians:
    W2 = sqrt((mu1 - mu2)^2 + (sigma1 - sigma2)^2)."""
    mu1, s1, mu2, s2 = (_f32(t) for t in (mu1, s1, mu2, s2))
    return torch.sqrt((mu1 - mu2) ** 2 + (s1 - s2) ** 2)


def gaussian_icdf(u, mu, sigma) -> torch.Tensor:
    """Inverse CDF of N(mu, sigma^2); broadcasts mu / sigma against u."""
    u = _f32(u)
    return _f32(mu, u.device) + _f32(sigma, u.device) * torch.special.ndtri(u)


# -- empirical quantile functions (samples -> inverse CDF) --------------------


def empirical_icdf(samples: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Step-function quantile of an empirical distribution.  samples (...,
    m) raw draws (unsorted ok); u (n,) in (0, 1).  Returns (..., n):
    F^{-1}(u) = sorted[floor(u m)], the index clipped to [0, m - 1]."""
    srt = torch.sort(samples, dim=-1).values
    m = samples.shape[-1]
    idx = torch.floor(u * m).to(torch.int64).clamp(0, m - 1)
    return srt.index_select(-1, idx.to(srt.device))


def wasserstein_1d_exact(samples_f: torch.Tensor, samples_g: torch.Tensor,
                         p: float = 2.0) -> torch.Tensor:
    """Exact W^p between two empirical 1-D distributions of m and n atoms:
    |F^{-1} - G^{-1}|^p integrated piecewise over the merged breakpoints
    {i/m} U {j/n} (an f32 grid, as the JAX package's).  Oracle for tests."""
    sf = torch.sort(_f32(samples_f)).values
    sg = torch.sort(_f32(samples_g)).values
    m, n = sf.shape[-1], sg.shape[-1]
    dev = sf.device

    def steps(k):
        return torch.arange(k + 1, dtype=torch.float32, device=dev) / k
    grid = torch.sort(torch.cat([steps(m), steps(n)])).values
    lengths = torch.diff(grid)
    mid = (grid[:-1] + grid[1:]) / 2.0
    fi = torch.floor(mid * m).to(torch.int64).clamp(0, m - 1)
    gi = torch.floor(mid * n).to(torch.int64).clamp(0, n - 1)
    diff = (sf[..., fi] - sg[..., gi]).abs() ** p
    return (diff * lengths).sum(dim=-1) ** (1.0 / p)


# -- embeddings of inverse CDFs (Remark 1) ------------------------------------


def icdf_nodes_mc(generator: torch.Generator, n: int, clip: float = CLIP,
                  device=None) -> Tuple[torch.Tensor, float]:
    """Uniform MC nodes on [clip, 1 - clip] from a CPU ``generator``, on
    ``device`` (default: the card); returns (nodes (n,), volume)."""
    u = montecarlo.mc_nodes(generator, n, 1, (clip, 1.0 - clip),
                            device=device)[:, 0]
    return u, 1.0 - 2.0 * clip


def icdf_nodes_qmc(n: int, clip: float = CLIP, sequence: str = "sobol",
                   device=None) -> Tuple[torch.Tensor, float]:
    """Low-discrepancy nodes on [clip, 1 - clip], on ``device`` (default:
    the card); returns (nodes (n,), volume)."""
    u = montecarlo.qmc_nodes(n, 1, (clip, 1.0 - clip), sequence,
                             device=device)[:, 0]
    return u, 1.0 - 2.0 * clip


def icdf_nodes_cheb(n: int, clip: float = CLIP) -> torch.Tensor:
    """Chebyshev (first-kind) nodes on [clip, 1 - clip] for the basis
    method."""
    return basis.cheb_nodes(n, (clip, 1.0 - clip))


def embed_icdf_mc(icdf_vals: torch.Tensor, volume: float, p: float = 2.0
                  ) -> torch.Tensor:
    """Monte Carlo embedding of an inverse CDF sampled at shared nodes."""
    return montecarlo.mc_embedding(icdf_vals, volume, p)


def embed_icdf_cheb(icdf_vals: torch.Tensor, clip: float = CLIP
                    ) -> torch.Tensor:
    """Orthonormal-basis embedding (p = 2 only) of an inverse CDF sampled
    at :func:`icdf_nodes_cheb` nodes."""
    return basis.cheb_l2_coeffs(icdf_vals, (clip, 1.0 - clip))


def _embed(vals, volume, method):
    if method == "mc":
        return embed_icdf_mc(vals, volume)
    if method == "cheb":
        return embed_icdf_cheb(vals)
    raise ValueError(method)


def w2_embedding_gaussian(mu, sigma, nodes: torch.Tensor,
                          volume: float | None, method: str = "mc"
                          ) -> torch.Tensor:
    """Embedding of N(mu, sigma^2) for W^2 hashing: mu, sigma (...,)
    batched parameters; nodes (N,) quantile levels."""
    vals = gaussian_icdf(nodes, _f32(mu, nodes.device)[..., None],
                         _f32(sigma, nodes.device)[..., None])
    return _embed(vals, volume, method)


def w2_embedding_samples(samples: torch.Tensor, nodes: torch.Tensor,
                         volume: float | None, method: str = "mc"
                         ) -> torch.Tensor:
    """Embedding of an empirical distribution given raw draws (..., m)."""
    return _embed(empirical_icdf(samples, nodes), volume, method)


def w2_embedding_logits(logits: torch.Tensor, support: torch.Tensor,
                        nodes: torch.Tensor, volume: float) -> torch.Tensor:
    """Embedding of a categorical distribution over a numeric ``support``
    grid: logits (..., V) -> inverse-CDF values at ``nodes`` -> MC
    embedding.  F^{-1}(u) is the support value at the count of cdf < u."""
    cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    idx = (cdf[..., None, :] < nodes[:, None]).sum(dim=-1)       # (..., N)
    idx = idx.clamp(0, support.shape[-1] - 1)
    vals = support[idx]
    return montecarlo.mc_embedding(vals.to(torch.float32), volume)
