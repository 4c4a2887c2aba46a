"""K2 fused_query on the card: gather + masked L^p + top-k per query row.

Launches ``csrc/fused_query.cu`` (the port of
``repro/kernels/fused_query.py``).  Its plain version is
:func:`repro_torch.kernels.ref.fused_query_topk_ref`, re-exported here as
``plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, dispatch
from .ref import fused_query_topk_ref as plain  # noqa: F401

KP = 128                    # the largest k the kernel takes (ops contract)
SMEM_LIMIT = 200 * 1024     # per-row candidate table + query row, bytes


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.library("fused_query")
    fn = lib.fused_query_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
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
    lib, fn = _launcher()
    code = fn(q.data_ptr(), db.data_ptr(), ids.data_ptr(), nq, n, c, k, valid,
              pmode, float(p), out_d.data_ptr(), out_i.data_ptr(),
              dispatch.stream_handle(q))
    _build.check(lib, "fused_query", code)
    dispatch.launches["fused_query"] += 1
    return out_d, out_i
