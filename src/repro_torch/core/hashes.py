"""LSH families on R^N, drawn with torch.

* ``PStableHash`` -- Datar et al. (2004): ``h(x) = floor(alpha^T x / r +
  b)`` with alpha i.i.d. p-stable and b ~ U[0, 1); K1 on the card.
* ``SimHash`` -- Charikar (2002): ``sign(alpha^T x)``, bit-packed; K7 on
  the card.

The JAX package draws with ``jax.random``; torch cannot reproduce those
bits, so draws here come from an explicit ``torch.Generator`` and tests
hand both packages one numpy-drawn family.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops


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
