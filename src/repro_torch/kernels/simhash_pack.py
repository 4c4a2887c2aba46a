"""K7 simhash_pack on the card: ``pack32(X @ A >= 0)``.

Launches ``csrc/simhash_pack.cu`` (the port of
``repro/kernels/simhash_pack.py``).  Its plain version is
:func:`repro_torch.kernels.ref.simhash_pack_ref`, re-exported here as
``plain``.  Its tile width and copy width come from :func:`plan`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, dispatch
from .ref import simhash_pack_ref as plain  # noqa: F401

WORDS = (4, 2, 1)       # output words a block may own, widest first


class Plan(NamedTuple):
    """What a launch passes: ``words`` (a block of csrc/simhash_pack.cu
    owns 32 rows by 32 x ``words`` columns; the kernel derives its grid
    and shared memory from it) and ``vec`` (True for 16-byte copies, else
    the scalar instantiation)."""
    words: int
    vec: bool


@functools.lru_cache(maxsize=1024)
def plan(m: int, n: int, k: int, aligned: bool = True) -> Plan:
    """The plan for X (m, n) @ A (n, k) with ``k % 32 == 0`` (``aligned``: X
    and A both start on a 16-byte boundary).  A block owns the widest
    column tile of 1, 2 or 4 words that ``k`` fills: 4 at the benchmark's
    k = 1024, 16 x 8 = 128 blocks at m = 512, one wave on 132 SMs.  The
    16-byte path needs both pointers aligned and n a multiple of 4."""
    words = next(w for w in WORDS if k >= 32 * w or w == 1)
    return Plan(words, aligned and n % 4 == 0)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.library("simhash_pack")
    fn = lib.simhash_pack_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, i, p, p]
    fn.restype = i
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
    sig = x.new_empty((m, k // 32), dtype=torch.int32)
    if m == 0 or k == 0:
        return sig
    px, pa = x.data_ptr(), alpha.data_ptr()
    pl = plan(m, n, k, (px | pa) % 16 == 0)
    lib, fn = _launcher()
    with dispatch.on_device(x):
        code = fn(px, pa, m, n, k, pl.words, int(pl.vec), sig.data_ptr(),
                  dispatch.stream_handle(x))
        _build.check(lib, "simhash_pack", code)
    dispatch.count_launch("simhash_pack")
    return sig
