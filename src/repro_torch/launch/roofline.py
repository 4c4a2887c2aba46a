"""The H100's bound on a piece of work: the least time the card could take.

The JAX package's ``launch/roofline.py`` reads FLOPs, bytes and collective
traffic off compiled TPU HLO.  The port runs on the card, so it measures
times and holds each against this bound instead: the larger of the bytes
the work must move (each input read once, each output written once) over
the card's memory rate, and its operations over the card's fp32 rate
outside the tensor cores (H100 SXM, the figures ``chip_smoke.py`` and
PERF.md use).
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores


def bound_by(nbytes: float, ops: float) -> Tuple[float, str]:
    """(max(bytes / memory rate, operations / fp32 rate) in seconds,
    ``"bytes"`` or ``"operations"``: which of the two sets it)."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")
