"""LSH families on R^N, drawn with torch.

* ``PStableHash`` -- Datar et al. (2004): ``h(x) = floor(alpha^T x / r +
  b)`` with alpha i.i.d. p-stable and b ~ U[0, 1); K1 on the card.  p = 2
  (normal), p = 1 (Cauchy), any p in (0, 2) by Chambers-Mallows-Stuck.
* ``SimHash`` -- Charikar (2002): ``sign(alpha^T x)``, bit-packed; K7 on
  the card.
* ``LazyCoeffs`` / ``LazyPStableHash`` -- Algorithm 1's lazily grown
  alpha: block i of 128 rows is a pure function of (seed, i), so growing
  alpha never changes an issued row.
* ``ALSH`` -- Shrivastava & Li's asymmetric transforms for MIPS, hashed
  with ``PStableHash`` (``"l2"``) or ``SimHash`` (``"sign"``).

The JAX package draws with ``jax.random``; torch cannot reproduce those
bits, so draws here come from an explicit ``torch.Generator`` and tests
hand both packages one numpy-drawn family (``convert.py`` carries a JAX
family's arrays, its lazy blocks or an ALSH's inner family).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import dispatch, ops


def _cms(theta: torch.Tensor, w: torch.Tensor, p: float) -> torch.Tensor:
    """Chambers-Mallows-Stuck for a symmetric p-stable variable (beta = 0)
    from theta ~ U(-pi/2, pi/2) and w ~ Exp(1), as the JAX package writes
    it."""
    return (torch.sin(p * theta) / torch.cos(theta) ** (1.0 / p)
            * (torch.cos(theta * (1.0 - p)) / w) ** ((1.0 - p) / p))


def sample_pstable(generator: torch.Generator, shape, p: float
                   ) -> torch.Tensor:
    """Symmetric p-stable f32 samples on the generator's device: p = 2
    gives N(0, 1), p = 1 Cauchy(0, 1), 0 < p < 2 Chambers-Mallows-Stuck."""
    dev = generator.device
    if p == 2.0:
        return torch.randn(shape, generator=generator, device=dev)
    if p == 1.0:
        return torch.empty(shape, device=dev).cauchy_(generator=generator)
    if not 0.0 < p < 2.0:
        raise ValueError(f"p must be in (0, 2], got {p}")
    theta = (torch.rand(shape, generator=generator, device=dev) - 0.5) \
        * torch.pi
    w = torch.empty(shape, device=dev).exponential_(generator=generator)
    return _cms(theta, w, p)


# -- lazy coefficient store (Algorithm 1) -------------------------------------


BLOCK = 128  # rows of alpha per growth step


def _derived_seed(*words: int) -> int:
    """A 63-bit generator seed that is a pure function of ``words``."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))


class LazyCoeffs:
    """Deterministic lazily grown i.i.d. p-stable matrix alpha (N x K).

    Block ``i`` of :data:`BLOCK` rows is drawn on the CPU from a generator
    seeded with ``_derived_seed(seed, 1, i)``, so alpha[j] is a pure
    function of (seed, j) whatever the order and granularity of growth:
    Algorithm 1's "append new coefficients when a new largest N_f
    arrives", reproducible.
    Blocks are kept as f32 numpy (``convert.lazy_coeffs_from_numpy`` puts
    the JAX package's there); ``alpha(n)`` hands them to ``device`` (default:
    the card).
    """

    def __init__(self, seed: int, n_hashes: int, p: float = 2.0,
                 device=None):
        self.seed = int(seed)
        self.k = int(n_hashes)
        self.p = float(p)
        self.device = dispatch.resolve_device(device)
        self._blocks: list[np.ndarray] = []

    def _gen_block(self, i: int) -> np.ndarray:
        gen = torch.Generator().manual_seed(_derived_seed(self.seed, 1, i))
        return sample_pstable(gen, (BLOCK, self.k), self.p).numpy()

    def ensure(self, n: int) -> None:
        """Grow alpha to at least n rows."""
        while len(self._blocks) * BLOCK < n:
            self._blocks.append(self._gen_block(len(self._blocks)))

    def alpha(self, n: int) -> torch.Tensor:
        """The first n rows, (n, K) f32 on the device."""
        self.ensure(n)
        full = np.concatenate(self._blocks, axis=0)
        return torch.as_tensor(full[:n], device=self.device).contiguous()

    @property
    def current_n(self) -> int:
        return len(self._blocks) * BLOCK


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(..., N) -> contiguous (B, N) rows for a kernel."""
    return x.reshape(-1, x.shape[-1]).contiguous()


@dataclasses.dataclass
class PStableHash:
    """K independent p-stable hashes.  alpha (N, K); b (K,) ~ U[0, 1).
    Hashing itself is ``kernels.ops.pstable_hash_proj`` (K1 on the card):
    x (..., N) -> (..., K), flattened to rows for the kernel."""

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

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """int32 hashes ``floor(x @ alpha / r + b)``, (..., K)."""
        h = ops.pstable_hash(_rows(x), self.alpha, self.b, self.r)
        return h.reshape(*x.shape[:-1], -1)

    def projections(self, x: torch.Tensor) -> torch.Tensor:
        """Pre-floor projections ``x @ alpha / r + b`` (used by multi-probe
        LSH), (..., K) f32."""
        _, proj = ops.pstable_hash_proj(_rows(x), self.alpha, self.b, self.r)
        return proj.reshape(*x.shape[:-1], -1)


@dataclasses.dataclass
class LazyPStableHash:
    """Algorithm 1: hashes inputs of varying N_f with a lazily extended
    alpha (``coeffs``), b (K,) and width r; K1 on the card."""

    coeffs: LazyCoeffs
    b: torch.Tensor
    r: float

    @classmethod
    def create(cls, seed: int, n_hashes: int, r: float = 1.0, p: float = 2.0,
               device=None) -> "LazyPStableHash":
        """alpha's blocks from ``seed`` (:class:`LazyCoeffs`); b ~ U[0, 1)
        from a CPU generator seeded apart from every block's; both on
        ``device`` (default: the card)."""
        device = dispatch.resolve_device(device)
        gen = torch.Generator().manual_seed(_derived_seed(seed, 0))
        b = torch.rand((n_hashes,), generator=gen).to(device)
        return cls(coeffs=LazyCoeffs(seed, n_hashes, p, device=device), b=b,
                   r=float(r))

    def __call__(self, gamma: torch.Tensor) -> torch.Tensor:
        """gamma (N_f,) or (batch, N_f) coefficients -> int32 (..., K).
        N_f may differ between calls: alpha grows, and earlier hashes stay
        valid (Remark 2: only the first N_f rows of alpha matter)."""
        alpha = self.coeffs.alpha(gamma.shape[-1])
        h = ops.pstable_hash(_rows(gamma.float()), alpha, self.b, self.r)
        return h.reshape(*gamma.shape[:-1], -1)


@dataclasses.dataclass
class SimHash:
    """Charikar (2002) sign-random-projection hash, bit-packed to int32
    words.  alpha (N, K).

    Takes fp32 ``x`` only, the dtype every caller in the JAX package
    passes; any other dtype raises ``ValueError``.  When K is not a
    multiple of 32 the reference pads the bits with 0: here alpha is
    padded with zero columns for the kernel, whose projections (0 >= 0)
    would set those bits, and the pad bits of the last word are then
    cleared."""

    alpha: torch.Tensor

    @classmethod
    def create(cls, generator: torch.Generator, n_dims: int, n_hashes: int
               ) -> "SimHash":
        """N(0, 1) directions drawn from ``generator`` on its device."""
        return cls(alpha=torch.randn((n_dims, n_hashes), generator=generator,
                                     device=generator.device))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Packed signature of x (..., N): (..., ceil(K / 32)) int32, bit j
        of word w set where ``(x @ alpha)[..., 32w+j] >= 0``, through
        ``ops.simhash_signature`` (K7 on the card)."""
        if x.dtype != torch.float32:
            raise ValueError(f"SimHash takes float32 x, got {x.dtype}")
        k = self.alpha.shape[1]
        pad = -k % 32
        alpha = self.alpha
        if pad:
            alpha = torch.cat([alpha, alpha.new_zeros((alpha.shape[0], pad))],
                              dim=1)
        sig = ops.simhash_signature(_rows(x), alpha.contiguous())
        if pad:
            sig[:, -1] &= (1 << (32 - pad)) - 1
        return sig.reshape(*x.shape[:-1], -1)

    def bits(self, x: torch.Tensor) -> torch.Tensor:
        """(..., K) int32 {0, 1} sign bits: the signature's, unpacked, so
        that the two always agree."""
        sig = self(x)
        shifts = torch.arange(32, dtype=torch.int32, device=sig.device)
        bits = (sig[..., None] >> shifts) & 1
        return bits.reshape(*sig.shape[:-1], -1)[..., :self.alpha.shape[1]]

    @staticmethod
    def hamming(sig_a: torch.Tensor, sig_b: torch.Tensor) -> torch.Tensor:
        """Hamming distance between packed signatures: the popcount of
        their xor, summed over the last axis, int32."""
        v = torch.bitwise_xor(sig_a, sig_b).to(torch.int64) & 0xFFFFFFFF
        v = v - ((v >> 1) & 0x55555555)
        v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
        v = (v + (v >> 4)) & 0x0F0F0F0F
        return (((v * 0x01010101) >> 24) & 0xFF).sum(dim=-1).to(torch.int32)


# -- ALSH for maximum inner product search (paper Sec. 5 outlook) -------------


@dataclasses.dataclass
class ALSH:
    """Shrivastava & Li asymmetric LSH for MIPS.

    ``variant="l2"`` (NIPS 2014): P(x) = [Ux; ||Ux||^2; ...; ||Ux||^(2^m)],
    Q(q) = [q/||q||; 1/2; ...; 1/2], hashed with :class:`PStableHash` (K1).
    ``variant="sign"`` (UAI 2015): P(x) = [Ux; 1/2 - ||Ux||^2; ...],
    Q(q) = [q/||q||; 0; ...; 0], hashed with :class:`SimHash` (K7).
    """

    m: int
    scale_u: float
    inner: object  # PStableHash or SimHash over n_dims + m
    variant: str = "sign"

    @classmethod
    def create(cls, generator: torch.Generator, n_dims: int, n_hashes: int,
               m: int = 3, scale_u: float = 0.83, r: float = 1.0,
               variant: str = "sign") -> "ALSH":
        if variant == "l2":
            inner = PStableHash.create(generator, n_dims + m, n_hashes, r=r,
                                       p=2.0)
        elif variant == "sign":
            inner = SimHash.create(generator, n_dims + m, n_hashes)
        else:
            raise ValueError(variant)
        return cls(m=m, scale_u=scale_u, inner=inner, variant=variant)

    def _powers(self, sq_norm: torch.Tensor) -> torch.Tensor:
        out = []
        s = sq_norm
        for _ in range(self.m):
            out.append(s)
            s = s * s
        return torch.stack(out, dim=-1)

    def preprocess(self, x: torch.Tensor,
                   max_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """P(.) of database vectors (..., N) -> (..., N + m)."""
        nrm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        mx = nrm.max() if max_norm is None else torch.as_tensor(
            max_norm, dtype=x.dtype, device=x.device)
        u = self.scale_u * x / torch.clamp(mx, min=1e-30)
        powers = self._powers(torch.sum(u * u, dim=-1))
        if self.variant == "sign":
            powers = 0.5 - powers
        return torch.cat([u, powers], dim=-1)

    def query_transform(self, q: torch.Tensor) -> torch.Tensor:
        """Q(.) of queries (..., N) -> (..., N + m)."""
        qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                             min=1e-30)
        fill = 0.5 if self.variant == "l2" else 0.0
        tail = torch.full(q.shape[:-1] + (self.m,), fill, dtype=q.dtype,
                          device=q.device)
        return torch.cat([qn, tail], dim=-1)

    def hash_db(self, x: torch.Tensor,
                max_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.inner(self.preprocess(x, max_norm))

    def hash_query(self, q: torch.Tensor) -> torch.Tensor:
        return self.inner(self.query_transform(q))
