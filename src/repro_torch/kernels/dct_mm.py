"""K4 dct_mm on the card: ``(F @ Mt) * scale``, the Chebyshev embedding.

Launches ``csrc/dct_mm.cu`` (the port of ``repro/kernels/dct_mm.py``).
Its plain version is :func:`repro_torch.kernels.ref.dct_mm_ref`,
re-exported here as ``plain``.  Its grid comes from
:func:`repro_torch.kernels.small_gemm.plan`, shared with K1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, dispatch
from .ref import dct_mm_ref as plain  # noqa: F401  (the plain version)
from .small_gemm import plan as _plan


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.library("dct_mm")
    fn = lib.dct_mm_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def dct_mm(fvals: torch.Tensor, dct_t: torch.Tensor, scale: torch.Tensor
           ) -> torch.Tensor:
    """fvals (B, N), dct_t (N, D), scale (D,), fp32 on one CUDA device.
    Returns (B, D) f32."""
    f32 = torch.float32
    dispatch.check_cuda_args("dct_mm", fvals, dct_t, scale,
                             dtypes=(f32, f32, f32))
    if fvals.dim() != 2 or dct_t.dim() != 2 \
            or fvals.shape[1] != dct_t.shape[0] \
            or scale.shape != (dct_t.shape[1],):
        raise ValueError(f"dct_mm: shapes fvals {tuple(fvals.shape)}, dct_t "
                         f"{tuple(dct_t.shape)}, scale {tuple(scale.shape)}")
    m, n = fvals.shape
    d = dct_t.shape[1]
    out = fvals.new_empty((m, d))     # f32, like fvals; cheaper on the host
    if m == 0 or d == 0:
        return out
    pf, pm, ps = fvals.data_ptr(), dct_t.data_ptr(), scale.data_ptr()
    plan = _plan(m, n, d, (pf | pm | ps) % 16 == 0)
    lib, fn = _launcher()
    with dispatch.on_device(fvals):
        code = fn(pf, pm, ps, m, n, d, plan.rows, plan.vec, out.data_ptr(),
                  dispatch.stream_handle(fvals))
        _build.check(lib, "dct_mm", code)
    dispatch.count_launch("dct_mm")
    return out
