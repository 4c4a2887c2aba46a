"""K2 fused_query on the card: gather + masked L^p + top-k per query row.

Launches ``csrc/fused_query.cu`` (the port of
``repro/kernels/fused_query.py``).  Its plain version is
:func:`repro_torch.kernels.ref.fused_query_topk_ref`, re-exported here as
``plain``.  :func:`_plan` splits each row across a cluster of blocks for
both K2 and K5 (``csrc/topk.cuh``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, dispatch
from .ref import fused_query_topk_ref as plain  # noqa: F401

KP = 128                    # the largest k the kernel takes (ops contract)
SMEM_LIMIT = 200 * 1024     # C x 8 + N x 4 bytes: the accepted (C, N)

# _plan's constants, mirrored from csrc/topk.cuh
MAX_CLUSTER = 4             # blocks per row; the kernel takes up to 8
TARGET_BLOCKS = 264         # one wave of two blocks on each of 132 SMs
MIN_SLOTS = 32              # a rank owns at least a warp's worth of slots
SMEM_PER_BLOCK = 227 * 1024 - 4096   # dynamic bytes beside the static
# scratch (topk::Scratch, ~2.3 KB) within the 227 KB a block may use


class Plan(NamedTuple):
    """How one launch splits its rows: ``cluster`` (G) blocks per row,
    ``slots`` (S) candidate slots at most per block, ``lanes`` (L) lanes
    per candidate row, ``vec`` True for one 16-byte load per lane (else the
    scalar instantiation), ``smem`` dynamic shared bytes per block."""
    cluster: int
    slots: int
    lanes: int
    vec: bool
    smem: int

    def owner(self, slot: int) -> int:
        """The cluster rank whose block scores candidate slot ``slot``:
        slots are dealt round-robin, since a gathered row fills each
        bucket's first slots and a contiguous split would load rank 0."""
        return slot % self.cluster


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def _plan(nq: int, c: int, n: int, itemsize: int, aligned: bool = True
          ) -> Plan:
    """The launch plan for nq rows of C candidate slots over rows of N
    values of ``itemsize`` bytes (``aligned``: the table's base address is
    a multiple of 16).  G doubles, up to 4, while the doubled grid of nq x
    2G blocks still fits two blocks per SM (one wave) and every rank keeps
    >= 32 slots: G = 4 at 32 rows and 2 at 128 rows for C = 1024.  (G = 8
    measured slower at both: rank 0's merge of 8 lists costs more than the
    extra SMs save.)  L is the largest power of two <= min(32, row bytes /
    16), so no lane of a candidate's sub-warp is idle."""
    g = 1
    while (2 * g <= MAX_CLUSTER and nq * 2 * g <= TARGET_BLOCKS
           and c >= 2 * g * MIN_SLOTS):
        g *= 2
    slots = -(-c // g)
    row_bytes = n * itemsize
    vec = aligned and row_bytes % 16 == 0
    lanes = min(32, _pow2_floor(-(-row_bytes // 16)))
    pool = g * KP if g > 1 else 0
    smem = -(-n * 4 // 16) * 16 + 8 * (slots + KP + pool) + 4 * pool
    return Plan(g, slots, lanes, vec, smem)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.library("fused_query")
    fn = lib.fused_query_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def fused_query_topk(q: torch.Tensor, db: torch.Tensor, ids: torch.Tensor,
                     k: int, p: float = 2.0, valid_items=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (nq, N) f32, db (M, N) f32, ids (nq, C) int32 on one CUDA device.
    Returns ascending (dists (nq, k) f32, ids (nq, k) int32), (+inf, -1)
    where fewer than k candidates are valid; ids < 0 or >= valid_items
    (default M) are invalid."""
    f32 = torch.float32
    dispatch.check_cuda_args("fused_query", q, db, ids,
                             dtypes=(f32, f32, torch.int32))
    if q.dim() != 2 or db.dim() != 2 or ids.dim() != 2 \
            or db.shape[1] != q.shape[1] or ids.shape[0] != q.shape[0]:
        raise ValueError(f"fused_query: shapes q {tuple(q.shape)}, db "
                         f"{tuple(db.shape)}, ids {tuple(ids.shape)}")
    nq, n = q.shape
    c = ids.shape[1]
    if not 1 <= k <= min(c, KP):
        raise ValueError(f"fused_query: k={k} outside 1..min(C={c}, {KP})")
    if c * 8 + n * 4 > SMEM_LIMIT:
        raise ValueError(f"fused_query: C={c}, N={n} needs {c * 8 + n * 4} "
                         f"bytes of shared memory per block, over "
                         f"{SMEM_LIMIT}; query fewer candidates per row")
    valid = db.shape[0] if valid_items is None else int(valid_items)
    pmode = 2 if p == 2.0 else (1 if p == 1.0 else 0)
    out_d = torch.empty((nq, k), dtype=f32, device=q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    if nq == 0:
        return out_d, out_i
    plan = _plan(nq, c, n, 4, aligned=db.data_ptr() % 16 == 0)
    lib, fn = _launcher()
    with dispatch.on_device(q):
        code = fn(q.data_ptr(), db.data_ptr(), ids.data_ptr(), nq, n, c,
                  k, valid, pmode, float(p), plan.cluster, plan.slots,
                  plan.lanes.bit_length() - 1, int(plan.vec),
                  out_d.data_ptr(), out_i.data_ptr(),
                  dispatch.stream_handle(q))
        _build.check(lib, "fused_query", code)
    dispatch.count_launch("fused_query")
    return out_d, out_i
