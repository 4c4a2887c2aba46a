"""K1 hash_mm on the card: ``floor((X @ A) / r + b)`` with its projections.

Launches ``csrc/hash_mm.cu`` (the port of ``repro/kernels/hash_mm.py``).
Its plain version is :func:`repro_torch.kernels.ref.hash_mm_proj_ref`,
re-exported here as ``plain``.  Its grid comes from
:func:`repro_torch.kernels.small_gemm.plan`, shared with K4.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, dispatch
from .ref import hash_mm_proj_ref as plain  # noqa: F401  (the plain version)
from .small_gemm import plan as _plan


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.library("hash_mm")
    fn = lib.hash_mm_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def hash_mm(x: torch.Tensor, alpha: torch.Tensor, b: torch.Tensor, r: float
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, N), alpha (N, K), b (K,), all fp32 on one CUDA device.
    Returns (hashes (B, K) int32, proj (B, K) f32)."""
    f32 = torch.float32
    dispatch.check_cuda_args("hash_mm", x, alpha, b, dtypes=(f32, f32, f32))
    if x.dim() != 2 or alpha.dim() != 2 or x.shape[1] != alpha.shape[0] \
            or b.shape != (alpha.shape[1],):
        raise ValueError(f"hash_mm: shapes x {tuple(x.shape)}, alpha "
                         f"{tuple(alpha.shape)}, b {tuple(b.shape)}")
    m, n = x.shape
    k = alpha.shape[1]
    # new_empty: cheaper on the host than torch.empty(..., device=...)
    h = x.new_empty((m, k), dtype=torch.int32)
    proj = x.new_empty((m, k))
    if m == 0 or k == 0:
        return h, proj
    px, pa, pb = x.data_ptr(), alpha.data_ptr(), b.data_ptr()
    plan = _plan(m, n, k, (px | pa | pb) % 16 == 0)
    lib, fn = _launcher()
    with dispatch.on_device(x):
        code = fn(px, pa, pb, float(r), m, n, k, plan.rows, plan.vec,
                  h.data_ptr(), proj.data_ptr(), dispatch.stream_handle(x))
        _build.check(lib, "hash_mm", code)
    dispatch.count_launch("hash_mm")
    return h, proj
