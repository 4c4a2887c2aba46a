"""K5 quantized_query on the card: gather int8/bf16 codes + code-space L^p
+ top-k per query row, the k winners scaled into the fp32 metric.

Launches ``csrc/quantized_query.cu`` (the port of
``repro/kernels/quantize.py``'s ``quantized_query_topk``).  Its plain
version is :func:`repro_torch.kernels.ref.quantized_topk_ref`, re-exported
here as ``plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, dispatch
from .fused_query import KP, SMEM_LIMIT, _plan
from .ref import quantized_topk_ref as plain  # noqa: F401

CODE_DTYPES = (torch.int8, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.library("quantized_query")
    fn = lib.quantized_query_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, i, p, i, i, i, i, i, i, ctypes.c_float, i, i,
                   i, i, p, p, p]
    fn.restype = ctypes.c_int
    return lib, fn


def quantized_query_topk(q: torch.Tensor, codes: torch.Tensor,
                         scale: torch.Tensor, ids: torch.Tensor, k: int,
                         p: float = 2.0, valid_items=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (nq, N) f32, codes (M, N) int8 or bf16, scale one f32 or (S,) f32
    (S dividing nq: row r reads ``scale[r // (nq / S)]``, the stacked
    query's one scale per segment), ids (nq, C) int32, all on one CUDA
    device.  Returns ascending (dists (nq, k) f32 in the fp32 metric, ids
    (nq, k) int32), (+inf, -1) where fewer than k candidates are valid; ids
    < 0 or >= valid_items (default M) are invalid.  k must be <= min(C,
    128)."""
    dispatch.check_cuda_args("quantized_query", q, scale, ids, codes,
                             dtypes=(torch.float32, torch.float32,
                                     torch.int32))
    if codes.dtype not in CODE_DTYPES:
        raise TypeError(f"quantized_query: codes are {codes.dtype}, want "
                        f"one of {CODE_DTYPES}")
    if q.dim() != 2 or codes.dim() != 2 or ids.dim() != 2 \
            or codes.shape[1] != q.shape[1] or ids.shape[0] != q.shape[0] \
            or scale.numel() < 1 or q.shape[0] % scale.numel():
        raise ValueError(f"quantized_query: shapes q {tuple(q.shape)}, codes "
                         f"{tuple(codes.shape)}, scale {tuple(scale.shape)}, "
                         f"ids {tuple(ids.shape)}")
    nq, n = q.shape
    c = ids.shape[1]
    if not 1 <= k <= min(c, KP):
        raise ValueError(f"quantized_query: k={k} outside 1..min(C={c}, "
                         f"{KP})")
    if c * 8 + n * 4 > SMEM_LIMIT:
        raise ValueError(f"quantized_query: C={c}, N={n} needs "
                         f"{c * 8 + n * 4} bytes of shared memory per block, "
                         f"over {SMEM_LIMIT}; query fewer candidates per row")
    valid = codes.shape[0] if valid_items is None else int(valid_items)
    pmode = 2 if p == 2.0 else (1 if p == 1.0 else 0)
    out_d = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    if nq == 0:
        return out_d, out_i
    rows_per_scale = nq // scale.numel()
    plan = _plan(nq, c, n, codes.element_size(),
                 aligned=codes.data_ptr() % 16 == 0)
    lib, fn = _launcher()
    with dispatch.on_device(q):
        code = fn(q.data_ptr(), codes.data_ptr(),
                  int(codes.dtype == torch.int8), scale.data_ptr(),
                  rows_per_scale, ids.data_ptr(), nq, n, c, k, valid, pmode,
                  float(p), plan.cluster, plan.slots,
                  plan.lanes.bit_length() - 1, int(plan.vec),
                  out_d.data_ptr(), out_i.data_ptr(),
                  dispatch.stream_handle(q))
        _build.check(lib, "quantized_query", code)
    dispatch.count_launch("quantized_query")
    return out_d, out_i
