"""K6 rerank on the card: masked L^p distances, q vs pre-gathered rows.

Launches ``csrc/rerank.cu`` (the port of ``repro/kernels/rerank.py``'s
``rerank_distances``).  Its plain version is
:func:`repro_torch.kernels.ref.rerank_ref`, re-exported here as ``plain``.
:func:`plan` picks the query rows a block owns, the lanes a pair and the
load width.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, dispatch
from .ref import rerank_ref as plain  # noqa: F401

TARGET_BLOCKS = 264          # a block owns more rows only past one wave
PRE = 2                      # units of a row a lane reads at once (kPre)
SMEM_LIMIT = 48 * 1024       # query rows a block keeps in shared memory


class Plan(NamedTuple):
    """``rows`` query rows a block, ``lanes`` (L) lanes per (b, c) pair,
    ``vec`` True for 16-byte loads (else the scalar instantiation),
    ``smem`` dynamic shared bytes a block."""
    rows: int
    lanes: int
    vec: bool
    smem: int


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


@functools.lru_cache(maxsize=1024)
def plan(b: int, n: int, aligned: bool = True) -> Plan:
    """The plan for B query rows of N floats (``aligned``: q and emb start
    on a 16-byte boundary).  One row a block (128 blocks at the path's 128
    rows), doubling only while the grid exceeds one wave and the rows fit
    48 KB.  A lane reads two units of a row at once (16-byte chunks on the
    vector path, else floats), so L is the largest power of two <= min(32,
    units / 2): 8 at N = 64, two chunks a lane."""
    ldq = -(-n // 4) * 4
    rows = 1
    while -(-b // rows) > TARGET_BLOCKS and 2 * rows * ldq * 4 <= SMEM_LIMIT:
        rows *= 2
    vec = aligned and n % 4 == 0
    units = n // 4 if vec else n
    lanes = min(32, _pow2_floor(-(-units // PRE)))
    return Plan(rows, lanes, vec, rows * ldq * 4)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.library("rerank")
    fn = lib.rerank_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, i, i, i, p, p]
    fn.restype = i
    return lib, fn


def rerank_distances(q: torch.Tensor, emb: torch.Tensor, ids: torch.Tensor,
                     p: float = 2.0) -> torch.Tensor:
    """q (B, N) f32, emb (B, C, N) f32, ids (B, C) int32 on one CUDA device.
    Returns (B, C) f32 distances, +inf where ids < 0 (those rows are not
    read)."""
    f32 = torch.float32
    dispatch.check_cuda_args("rerank", q, emb, ids,
                             dtypes=(f32, f32, torch.int32))
    if q.dim() != 2 or emb.dim() != 3 or ids.dim() != 2 \
            or emb.shape[0] != q.shape[0] or emb.shape[2] != q.shape[1] \
            or ids.shape != emb.shape[:2]:
        raise ValueError(f"rerank: shapes q {tuple(q.shape)}, emb "
                         f"{tuple(emb.shape)}, ids {tuple(ids.shape)}")
    b, c, n = emb.shape
    if n * 4 > SMEM_LIMIT:
        raise ValueError(f"rerank: N={n} query row over {SMEM_LIMIT} bytes "
                         "of shared memory")
    out = q.new_empty((b, c))
    if b == 0 or c == 0:
        return out
    pmode = 2 if p == 2.0 else (1 if p == 1.0 else 0)
    pq, pe = q.data_ptr(), emb.data_ptr()
    pl = plan(b, n, (pq | pe) % 16 == 0)
    lib, fn = _launcher()
    with dispatch.on_device(q):
        code = fn(pq, pe, ids.data_ptr(), b, c, n, pmode, float(p), pl.rows,
                  pl.lanes.bit_length() - 1, int(pl.vec), out.data_ptr(),
                  dispatch.stream_handle(q))
        _build.check(lib, "rerank", code)
    dispatch.count_launch("rerank")
    return out
