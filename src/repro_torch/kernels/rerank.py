"""K6 rerank on the card: masked L^p distances, q vs pre-gathered rows.

Launches ``csrc/rerank.cu`` (the port of ``repro/kernels/rerank.py``'s
``rerank_distances``).  Its plain version is
:func:`repro_torch.kernels.ref.rerank_ref`, re-exported here as ``plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, dispatch
from .ref import rerank_ref as plain  # noqa: F401


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.library("rerank")
    fn = lib.rerank_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
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
    out = torch.empty((b, c), dtype=f32, device=q.device)
    if b == 0 or c == 0:
        return out
    pmode = 2 if p == 2.0 else (1 if p == 1.0 else 0)
    lib, fn = _launcher()
    code = fn(q.data_ptr(), emb.data_ptr(), ids.data_ptr(), b, c, n, pmode,
              float(p), out.data_ptr(), dispatch.stream_handle(q))
    _build.check(lib, "rerank", code)
    dispatch.launches["rerank"] += 1
    return out
