"""K3 merge on the card: the bitonic (distance, id) network in one kernel.

Launches ``csrc/merge.cu`` (the port of ``repro/kernels/merge.py``'s
``sort_pairs_pallas``).  The plain version is the network itself,
:func:`repro_torch.kernels.ref.sort_pairs` (re-exported here with
``_network``); the kernel is bit-identical to it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, dispatch
from .ref import _network, next_pow2, sort_pairs  # noqa: F401

SMEM_LIMIT = 232448          # 227 KB: the most shared memory a block can use


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.library("merge")
    fn = lib.merge_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def sort_pairs_kernel(d: torch.Tensor, i: torch.Tensor, sorted_run: int = 1,
                      n_out=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each row of (d (rows, M) f32, i (rows, M) int32) by (distance,
    id) ascending on the card; returns the first ``n_out`` (default M)
    columns of the sorted rows."""
    dispatch.check_cuda_args("merge", d, i,
                             dtypes=(torch.float32, torch.int32))
    if d.dim() != 2 or d.shape != i.shape:
        raise ValueError(f"merge: shapes d {tuple(d.shape)}, "
                         f"i {tuple(i.shape)}")
    rows, m = d.shape
    n_out = m if n_out is None else int(n_out)
    if not 0 <= n_out <= m:
        raise ValueError(f"merge: n_out={n_out} outside 0..{m}")
    if sorted_run < 1 or sorted_run & (sorted_run - 1):
        raise ValueError(f"merge: sorted_run={sorted_run} is not a power "
                         "of two")
    pw = next_pow2(m)
    if pw * 8 > SMEM_LIMIT:
        raise ValueError(f"merge: a pool of {m} pairs (padded to {pw}) "
                         f"needs {pw * 8} bytes of shared memory, over "
                         f"{SMEM_LIMIT}")
    d_out = torch.empty((rows, n_out), dtype=torch.float32, device=d.device)
    i_out = torch.empty((rows, n_out), dtype=torch.int32, device=d.device)
    if rows == 0 or m == 0 or n_out == 0:
        return d_out, i_out
    lib, fn = _launcher()
    code = fn(d.data_ptr(), i.data_ptr(), rows, m, pw, sorted_run, n_out,
              d_out.data_ptr(), i_out.data_ptr(), dispatch.stream_handle(d))
    _build.check(lib, "merge", code)
    dispatch.launches["merge"] += 1
    return d_out, i_out
