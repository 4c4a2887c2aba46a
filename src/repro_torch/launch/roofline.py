"""The H100's bound on a piece of work: the least time the card could take.

The JAX package's ``launch/roofline.py`` reads FLOPs, bytes and collective
traffic off compiled TPU HLO.  The port runs on the card, so it measures
times and holds each against this bound instead: the larger of the bytes
the work must move (each input read once, each output written once) over
the card's memory rate, and its operations over the card's fp32 rate
outside the tensor cores (H100 SXM, the figures ``chip_smoke.py`` and
PERF.md use).  The LM stack's steps are held against the model's FLOPs
(:func:`model_flops`, the JAX package's count) over the bf16 dense
tensor-core rate.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12   # H100 SXM bf16 dense tensor-core rate


def bound_by(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> Tuple[float, str]:
    """(max(bytes / memory rate, operations / ``ops_per_s``) in seconds,
    ``"bytes"`` or ``"operations"``: which of the two sets it).  The rate is
    the card's for the operations' type: fp32 outside the tensor cores by
    default, ``BF16_TENSOR_OPS_PER_S`` for bf16 matrix products."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (tb, "bytes") if tb >= to else (to, "operations")


def model_flops(kind: str, n_active_params: float, global_batch: int,
                seq_len: int) -> float:
    """The model's FLOPs for one step of ``kind``: 6 N D to train, 2 N D to
    prefill, 2 N per sequence to decode one token
    (``repro/launch/roofline.py:157``)."""
    if kind == "train":
        return 6.0 * n_active_params * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * n_active_params * global_batch * seq_len
    return 2.0 * n_active_params * global_batch  # decode: 1 token / seq
