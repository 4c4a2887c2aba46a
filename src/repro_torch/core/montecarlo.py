"""(Quasi-)Monte Carlo embeddings of L^p_mu(Omega) into l^p_N (paper Sec. 3.2).

T(f) = (V/N)^(1/p) * (f(x_1), ..., f(x_N)) with x_i drawn from mu/V: plain
Monte Carlo (error O(N^-1/2)) or a low-discrepancy sequence (Sobol /
Halton; error O((log N)^d / N)).

The port of ``repro/core/montecarlo.py``.  The Sobol and Halton generators
are numpy (static data, float64), copied so that the port imports nothing
of the JAX package.  ``qmc_nodes`` maps the points onto the interval in
float64 and casts to float32 once, as the JAX package's ``jnp.asarray``
does with x64 off; doing that arithmetic in float32 would round otherwise
and move the nodes.  ``mc_nodes`` draws from a CPU ``torch.Generator``
(a CUDA generator draws other numbers), so one seed gives one node set on
every device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels import dispatch

# (s, a, m) per dimension >= 2; dimension 1 is van der Corput.
# s = degree of primitive polynomial, a = interior coefficient bits,
# m = initial odd direction integers (m_i < 2^i).  Joe & Kuo (2008) table
# prefix.
_JOE_KUO = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
    (5, 4, [1, 1, 5, 5, 5]),
    (5, 7, [1, 1, 7, 11, 19]),
]

_SOBOL_BITS = 32

_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]


def _direction_numbers(dim_index: int) -> np.ndarray:
    """v_k (k = 1.._SOBOL_BITS) as uint64 left-aligned to _SOBOL_BITS bits."""
    v = np.zeros(_SOBOL_BITS + 1, dtype=np.uint64)
    if dim_index == 0:  # van der Corput
        for k in range(1, _SOBOL_BITS + 1):
            v[k] = np.uint64(1) << np.uint64(_SOBOL_BITS - k)
        return v
    s, a, m = _JOE_KUO[dim_index - 1]
    for k in range(1, s + 1):
        v[k] = np.uint64(m[k - 1]) << np.uint64(_SOBOL_BITS - k)
    for k in range(s + 1, _SOBOL_BITS + 1):
        vk = v[k - s] ^ (v[k - s] >> np.uint64(s))
        for i in range(1, s):
            if (a >> (s - 1 - i)) & 1:
                vk ^= v[k - i]
        v[k] = vk
    return v


def sobol(n: int, d: int = 1, skip: int = 0) -> np.ndarray:
    """First ``n`` Sobol points in [0,1)^d (Gray-code order), numpy float64.

    d <= 10.  ``skip`` discards the first points (common QMC practice)."""
    if d > len(_JOE_KUO) + 1:
        raise ValueError(f"sobol supports d <= {len(_JOE_KUO) + 1}, got {d}")
    idx = np.arange(skip, skip + n, dtype=np.uint64)
    gray = idx ^ (idx >> np.uint64(1))
    out = np.zeros((n, d), dtype=np.uint64)
    for j in range(d):
        v = _direction_numbers(j)
        x = np.zeros(n, dtype=np.uint64)
        for k in range(_SOBOL_BITS):
            bit = (gray >> np.uint64(k)) & np.uint64(1)
            x ^= bit * v[k + 1]
        out[:, j] = x
    return out.astype(np.float64) / float(1 << _SOBOL_BITS)


def halton(n: int, d: int = 1, skip: int = 0) -> np.ndarray:
    """First ``n`` Halton points in [0,1)^d, numpy float64 (d <= 12)."""
    if d > len(_PRIMES):
        raise ValueError(f"halton supports d <= {len(_PRIMES)}")
    idx = np.arange(skip + 1, skip + n + 1)
    out = np.zeros((n, d))
    for j, base in enumerate(_PRIMES[:d]):
        i = idx.copy()
        r = np.zeros(n)
        fb = float(base)
        denom = fb
        while i.max() > 0:
            r += (i % base) / denom
            i //= base
            denom *= fb
        out[:, j] = r
    return out


def mc_nodes(generator: torch.Generator, n: int, d: int = 1,
             interval: Tuple[float, float] = (0.0, 1.0),
             device=None) -> torch.Tensor:
    """i.i.d. uniform nodes in interval^d, (n, d) f32, drawn from a CPU
    ``generator`` and then moved to ``device`` (default: the card)."""
    if generator.device.type != "cpu":
        raise ValueError("mc_nodes draws from a CPU generator, got one on "
                         f"{generator.device}")
    a, b = interval
    u = torch.rand((n, d), generator=generator)
    return (a + (b - a) * u).to(dispatch.resolve_device(device))


def qmc_nodes(n: int, d: int = 1, interval: Tuple[float, float] = (0.0, 1.0),
              sequence: str = "sobol", skip: int = 64,
              device=None) -> torch.Tensor:
    """Low-discrepancy nodes in interval^d, (n, d) f32 on ``device``
    (default: the card): mapped in float64, cast once."""
    a, b = interval
    if sequence == "sobol":
        u = sobol(n, d, skip=skip)
    elif sequence == "halton":
        u = halton(n, d, skip=skip)
    else:
        raise ValueError(f"unknown sequence {sequence!r}")
    return torch.as_tensor((a + (b - a) * u).astype(np.float32),
                           device=dispatch.resolve_device(device))


def mc_embedding(fvals: torch.Tensor, volume: float, p: float = 2.0
                 ) -> torch.Tensor:
    """T(f) = (V/N)^(1/p) fvals (Eq. 6).  fvals: (..., N) samples of f at
    the shared node set.  The scale is a Python float, rounded to f32 once
    by the multiply, as the JAX package rounds it."""
    n = fvals.shape[-1]
    return fvals * ((volume / n) ** (1.0 / p))


def embed_functions_mc(fn, nodes: torch.Tensor, volume: float,
                       p: float = 2.0) -> torch.Tensor:
    """Sample a (batched) function at shared nodes and MC-embed it.

    ``fn`` maps (N,) or (N, d) nodes -> (..., N) values."""
    x = nodes[:, 0] if nodes.dim() == 2 and nodes.shape[1] == 1 else nodes
    return mc_embedding(fn(x), volume, p)
