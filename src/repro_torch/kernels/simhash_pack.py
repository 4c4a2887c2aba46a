"""K7 simhash_pack on the card: ``pack32(X @ A >= 0)``.

Launches ``csrc/simhash_pack.cu`` (the port of
``repro/kernels/simhash_pack.py``).  Its plain version is
:func:`repro_torch.kernels.ref.simhash_pack_ref`, re-exported here as
``plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, dispatch
from .ref import simhash_pack_ref as plain  # noqa: F401


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.library("simhash_pack")
    fn = lib.simhash_pack_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def simhash_pack(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x (B, N) f32, alpha (N, K) f32 with K % 32 == 0, on one CUDA device.
    Returns (B, K / 32) int32: bit j of word w is ``(x @ alpha)[:, 32w+j]
    >= 0``."""
    f32 = torch.float32
    dispatch.check_cuda_args("simhash_pack", x, alpha, dtypes=(f32, f32))
    if x.dim() != 2 or alpha.dim() != 2 or x.shape[1] != alpha.shape[0] \
            or alpha.shape[1] % 32:
        raise ValueError(f"simhash_pack: shapes x {tuple(x.shape)}, alpha "
                         f"{tuple(alpha.shape)} (K must be a multiple of 32)")
    m, n = x.shape
    k = alpha.shape[1]
    sig = torch.empty((m, k // 32), dtype=torch.int32, device=x.device)
    if m == 0 or k == 0:
        return sig
    lib, fn = _launcher()
    code = fn(x.data_ptr(), alpha.data_ptr(), m, n, k, sig.data_ptr(),
              dispatch.stream_handle(x))
    _build.check(lib, "simhash_pack", code)
    dispatch.launches["simhash_pack"] += 1
    return sig
