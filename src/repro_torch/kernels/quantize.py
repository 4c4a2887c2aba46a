"""Symmetric per-segment storage quantizer + dequant-free candidate scoring.

The port of ``repro/kernels/quantize.py`` (the storage-precision tier):
sealed segments may hold their rows at reduced precision -- ``bf16`` (a
cast) or ``int8`` (symmetric, one scale per segment: ``scale = max|x| *
f32(1/127)``, ``code = round(x / scale)``) -- while the mutable delta stays
fp32.  The scale is a multiply by the f32 reciprocal, not a division: the
JAX package writes ``max|x| / 127.0``, and XLA folds a division by a
constant into that multiply, so these are the JAX package's scale bits (a
true division differs by one ulp in some 4% of segments).

Candidate scoring against a quantized segment maps the query into code
space once and computes L^p between codes widened in registers (K5,
:func:`repro_torch.kernels.ops.quantized_query_topk`); one multiply by
``scale`` makes distances comparable across segments.  The result is only
a survivor set: :func:`rerank_survivors` rescores it exactly from fp32
rows (K6 for the distances, the K3 network for the order).
"""

from __future__ import annotations

import numpy as np
import torch

from . import ops
from .fused_query import KP
from .ref import code_query as _code_query  # noqa: F401
from .ref import quantized_topk_ref  # noqa: F401

PRECISIONS = ("fp32", "bf16", "int8")

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
_WIDTHS = {"fp32": 4, "bf16": 2, "int8": 1}
_INV_127 = float(np.float32(1) / np.float32(127))   # an f32 value, exact


def storage_dtype(precision: str) -> torch.dtype:
    """The dtype a sealed segment's ``db`` holds at this tier."""
    if precision not in _DTYPES:
        raise ValueError(
            f"unknown precision {precision!r}; want one of {PRECISIONS}")
    return _DTYPES[precision]


def bytes_per_item(precision: str, n_dims: int) -> int:
    """Sealed-storage bytes per item row (the capacity-planning number)."""
    return _WIDTHS[precision] * n_dims


def encode(db: torch.Tensor, precision: str
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 rows -> (codes, scale () f32) at ``precision``.

    int8: ``scale = max|x| * f32(1/127)`` (1 for an all-zero segment; the
    JAX package's bits, see the module docstring), ``codes = clip(round(x
    / scale), -127, 127)`` with true division and round half to even.
    bf16: a cast with scale 1.  fp32 never encodes.  Non-finite rows must
    be refused upstream: their codes are undefined."""
    if precision == "int8":
        x = db.float()
        amax = torch.max(torch.abs(x)) if x.numel() else x.new_zeros(())
        scale = torch.where(amax > 0, amax * _INV_127,
                            torch.ones_like(amax)).to(torch.float32)
        codes = torch.clamp(torch.round(x / scale), -127, 127)
        return codes.to(torch.int8), scale
    if precision == "bf16":
        return (db.to(torch.bfloat16),
                torch.ones((), dtype=torch.float32, device=db.device))
    raise ValueError(f"no encoder for precision {precision!r}")


def decode(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(codes, scale) -> fp32 rows (within scale/2 per coordinate for int8;
    exact rows for survivors come from the fp32 pool, not from here)."""
    if codes.dtype == torch.int8:
        return codes.float() * scale
    return codes.float()


def rerank_survivors(q: torch.Tensor, rows: torch.Tensor, gids: torch.Tensor,
                     k: int, p: float = 2.0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly rescore the survivor set from fp32 rows and take top-k.

    q (nq, N) f32; rows (nq, m, N) fp32 rows of the m merged survivors
    (garbage where gid < 0); gids (nq, m) int32, -1 = empty.  Returns
    (gids (nq, k), dists (nq, k)) under the (distance, gid) order of every
    merge in the stack: the distances are K6's, the sort is the network of
    ``ops.merge_topk`` (K3 on the card)."""
    gids = gids.to(torch.int32).contiguous()
    d = ops.candidate_distances(q.float().contiguous(),
                                rows.float().contiguous(), gids, p=p)
    sd, sg = ops.merge_topk(d, gids, k)
    return sg, sd


def survivor_width(k: int, survivor_k: int, cap: int) -> int:
    """The survivor-pool width m: ``survivor_k`` when set, else 4k, clipped
    to [k, cap] and to the kernels' top-k width (128)."""
    m = survivor_k if survivor_k and survivor_k > 0 else 4 * k
    return max(k, min(int(m), int(cap), KP))


__all__ = [
    "PRECISIONS", "storage_dtype", "bytes_per_item", "encode", "decode",
    "quantized_topk_ref", "rerank_survivors", "survivor_width",
]
