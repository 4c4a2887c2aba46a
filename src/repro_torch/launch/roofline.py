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

:class:`Roofline` is the JAX package's three-term roofline with the
card's constants, for the meta-device dry run (``launch/dryrun.py``):

    compute    = FLOPs_per_chip / BF16_TENSOR_OPS_PER_S
    memory     = bytes_per_chip / HBM_BYTES_PER_S
    collective = collective_bytes_per_chip / NVLINK_BYTES_PER_S

The port has no HLO, so the JAX ``parse_collectives`` has no counterpart:
:func:`analyze` takes FLOPs from :func:`model_flops` and the bytes and the
collective volumes from the sharded shapes (``launch/dryrun.py`` counts
them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12   # H100 SXM bf16 dense tensor-core rate
# device memory of one card: 80 GB, as nvidia-smi names it ("NVIDIA H100
# 80GB HBM3"), in bytes
HBM_BYTES = 80e9
# NVLink 4: 900 GB/s a GPU in NVIDIA's H100 SXM datasheet, both directions
# together; a ring collective sends and receives at once, so the bytes a
# chip receives move at one direction's half
NVLINK_BYTES_PER_S = 450e9


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


@dataclasses.dataclass
class Roofline:
    """The three-term roofline of one step on one chip of a mesh
    (``repro/launch/roofline.py:94``, with the H100's constants)."""

    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    chips: int
    model_flops_global: float          # 6ND / 2ND / 2N_active*tokens
    collectives: Dict[str, float]
    memory_stats: Dict[str, float]

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / BF16_TENSOR_OPS_PER_S

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / NVLINK_BYTES_PER_S

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """Model FLOPs over the FLOPs the chips run (remat's recompute)."""
        total = self.flops_per_chip * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-flops utilization at the roofline bound: useful model
        flops per chip-second at t_bound over the peak."""
        if self.t_bound == 0:
            return 0.0
        return ((self.model_flops_global / self.chips) / self.t_bound
                / BF16_TENSOR_OPS_PER_S)

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "chips": self.chips,
            "model_flops_global": self.model_flops_global,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "collectives": self.collectives,
            "memory_stats": self.memory_stats,
        }


def analyze(chips: int, kind: str, n_active_params: float, global_batch: int,
            seq_len: int, bytes_per_chip: float,
            collectives: Dict[str, float], memory_stats: Dict[str, float],
            recompute: float = 1.0, computing_chips: int = 0) -> Roofline:
    """The counterpart of ``repro/launch/roofline.py:166`` ``analyze``:
    FLOPs per chip are the model's (times ``recompute``, the forward
    recomputed under remat) over the chips that compute
    (``computing_chips``, default all); ``collectives`` maps each kind of
    collective to the bytes one chip moves a step."""
    mf = model_flops(kind, n_active_params, global_batch, seq_len)
    return Roofline(flops_per_chip=mf * recompute / (computing_chips
                                                     or chips),
                    bytes_per_chip=float(bytes_per_chip),
                    collective_bytes_per_chip=float(sum(
                        collectives.values())),
                    chips=chips, model_flops_global=mf,
                    collectives=dict(collectives),
                    memory_stats=dict(memory_stats, hbm_bytes=HBM_BYTES))
