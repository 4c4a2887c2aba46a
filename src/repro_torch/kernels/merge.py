"""K3 merge on the card: the first ``n_out`` (distance, id) pairs of a row.

Launches ``csrc/merge.cu`` (the port of ``repro/kernels/merge.py``'s
``sort_pairs_pallas``) by one of two routes, chosen by :func:`route` from
the shapes alone:

- ``"select"`` (``n_out <= 128`` and ``sorted_run == 1``, every call of
  ``ops.merge_topk``): a top-k selection split over a thread-block
  cluster, with no cap on the pool (:func:`plan`).  Its inputs must hold
  no NaN.  It orders ``-0.0`` as ``+0.0``, ties broken by id, as the
  network does, and writes each picked zero with its own pair's sign --
  but where a row pairs one id with both ``-0.0`` and ``+0.0``: the
  network places such equal pairs by its own compare pattern, which no
  selection reproduces, and the kernel writes that id's zeros as
  ``-0.0``.  The path's distances are sums of non-negative terms and
  never ``-0.0``.
- ``"network"`` (the full sort, or ``sorted_run > 1``): the bitonic network
  the TPU kernel runs, one block a row, the pool in shared memory, so at
  most 16,384 pairs a row.

Both are bit-identical to the plain network,
:func:`repro_torch.kernels.ref.sort_pairs` (re-exported here with
``_network``), on the inputs they take, the select route but for that
one case of signed zeros.  Neither falls back to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, dispatch
from .ref import _network, next_pow2, sort_pairs  # noqa: F401

SMEM_LIMIT = 232448          # 227 KB: the most shared memory a block can use

# The selection route's constants, mirrored from csrc/merge.cu
KP = 128                     # the largest n_out it takes (kMaxK)
MAX_CLUSTER = 4              # blocks a row at most (the kernel takes 8)
TARGET_BLOCKS = 264          # one wave of two blocks on each of 132 SMs
MIN_SHARE = 256              # a rank owns at least one pair a thread
MAX_TILE = 8192              # keys a tile holds at most (kMaxTile)


class Plan(NamedTuple):
    """How the selection route splits its rows: ``cluster`` (G) blocks a
    row, each owning ``share`` consecutive pairs (a multiple of 4), read in
    tiles of at most ``tile`` keys; ``vec`` True for 16-byte loads (else the
    scalar instantiation); ``smem`` dynamic shared bytes a block."""
    cluster: int
    share: int
    tile: int
    vec: bool
    smem: int

    def owner(self, j: int) -> int:
        """The cluster rank that reads pair ``j`` of a row."""
        return j // self.share


def route(rows: int, m: int, n_out: int, sorted_run: int) -> str:
    """``"select"`` for ``n_out <= 128`` with ``sorted_run == 1``, else
    ``"network"``.  On runs sorted by distance but not by id, the network
    with ``sorted_run > 1`` may differ from a full sort, so those calls
    keep it."""
    del rows, m            # the choice does not depend on them
    return "select" if n_out <= KP and sorted_run == 1 else "network"


def smem_bytes(tile: int, cluster: int) -> int:
    """``select_smem_bytes`` of csrc/merge.cu: the pool (KP + tile keys),
    the rank's list, two placement lists and, on a cluster, rank 0's G
    lists, 8 bytes a key."""
    return 8 * (KP + tile + 3 * KP + (cluster * KP if cluster > 1 else 0))


@functools.lru_cache(maxsize=1024)
def plan(rows: int, m: int, aligned: bool = True) -> Plan:
    """The selection route's plan for ``rows`` rows of ``m`` pairs
    (``aligned``: d and ids sit at the same offset from a 16-byte boundary).
    G doubles, up to 4, while the doubled grid still fits one wave of 264
    blocks and every rank keeps >= 256 pairs: G = 4 at (32, 2570), 2 at
    (128, 10,320), 1 at (128, 40).  (G = 8 measured slower at (32, 2570):
    clusters of 8 start over several µs, and rank 0 merges 8 lists.)  A
    rank's share is rounded up to a multiple of 4; a share over 8,192 keys
    is read in tiles of 8,192."""
    g = 1
    while (2 * g <= MAX_CLUSTER and rows * 2 * g <= TARGET_BLOCKS
           and -(-m // (2 * g)) >= MIN_SHARE):
        g *= 2
    share = -(-max(1, -(-m // g)) // 4) * 4
    # the 16-byte chunks over a share may start up to 3 pairs early
    tile = min(MAX_TILE, share + (4 if aligned else 0))
    tile = -(-tile // 4) * 4
    return Plan(g, share, tile, aligned, smem_bytes(tile, g))


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.library("merge")
    p, i = ctypes.c_void_p, ctypes.c_int
    net = lib.merge_launch
    net.argtypes = [p, p, i, i, i, i, i, p, p, p]
    net.restype = i
    sel = lib.merge_select_launch
    sel.argtypes = [p, p, i, i, i, i, i, i, i, i, p, p, p]
    sel.restype = i
    return lib, net, sel


def _select(d: torch.Tensor, i: torch.Tensor, n_out: int, mask_invalid: bool
            ) -> tuple[torch.Tensor, torch.Tensor]:
    rows, m = d.shape
    d_out = d.new_empty((rows, n_out))
    i_out = i.new_empty((rows, n_out))
    if rows == 0:
        return d_out, i_out
    pd, pi = d.data_ptr(), i.data_ptr()
    pl = plan(rows, m, pd % 16 == pi % 16)
    lib, _, fn = _launcher()
    with dispatch.on_device(d):
        code = fn(pd, pi, rows, m, n_out, pl.cluster, pl.share, pl.tile,
                  int(pl.vec), int(mask_invalid), d_out.data_ptr(),
                  i_out.data_ptr(), dispatch.stream_handle(d))
        _build.check(lib, "merge", code)
    dispatch.count_launch("merge")
    return d_out, i_out


def _check(d: torch.Tensor, i: torch.Tensor) -> None:
    dispatch.check_cuda_args("merge", d, i,
                             dtypes=(torch.float32, torch.int32))
    if d.dim() != 2 or d.shape != i.shape:
        raise ValueError(f"merge: shapes d {tuple(d.shape)}, "
                         f"i {tuple(i.shape)}")


def sort_pairs_kernel(d: torch.Tensor, i: torch.Tensor, sorted_run: int = 1,
                      n_out=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each row of (d (rows, M) f32, i (rows, M) int32) by (distance,
    id) ascending on the card; returns the first ``n_out`` (default M)
    columns of the sorted rows, by the route :func:`route` names."""
    _check(d, i)
    rows, m = d.shape
    n_out = m if n_out is None else int(n_out)
    if not 0 <= n_out <= m:
        raise ValueError(f"merge: n_out={n_out} outside 0..{m}")
    if sorted_run < 1 or sorted_run & (sorted_run - 1):
        raise ValueError(f"merge: sorted_run={sorted_run} is not a power "
                         "of two")
    if n_out == 0:
        return d.new_empty((rows, 0)), i.new_empty((rows, 0))
    if route(rows, m, n_out, sorted_run) == "select":
        return _select(d, i, n_out, mask_invalid=False)
    pw = next_pow2(m)
    if pw * 8 > SMEM_LIMIT:
        raise ValueError(f"merge: the network route holds a row in shared "
                         f"memory, and a pool of {m} pairs (padded to {pw}) "
                         f"needs {pw * 8} bytes, over {SMEM_LIMIT}; the "
                         f"select route (n_out <= {KP}, sorted_run 1) has "
                         "no cap")
    d_out = d.new_empty((rows, n_out))
    i_out = i.new_empty((rows, n_out))
    if rows == 0:
        return d_out, i_out
    lib, fn, _ = _launcher()
    with dispatch.on_device(d):
        code = fn(d.data_ptr(), i.data_ptr(), rows, m, pw, sorted_run,
                  n_out, d_out.data_ptr(), i_out.data_ptr(),
                  dispatch.stream_handle(d))
        _build.check(lib, "merge", code)
    dispatch.count_launch("merge")
    return d_out, i_out


def merge_topk_kernel(d: torch.Tensor, i: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``ops.merge_topk`` on the card, for rows of M >= k pairs: the first
    k pairs under (distance, id) with a pair whose id is < 0 read as +inf,
    and id -1 beside every +inf distance picked.  k <= 128 is one launch of
    the select route, the masking inside the kernel; a larger k masks
    around the network route."""
    _check(d, i)
    rows, m = d.shape
    if not 1 <= k <= m:
        raise ValueError(f"merge: k={k} outside 1..{m}")
    if route(rows, m, k, 1) == "select":
        return _select(d, i, k, mask_invalid=True)
    sd, si = sort_pairs_kernel(torch.where(i < 0, torch.inf, d), i, n_out=k)
    return sd, torch.where(torch.isinf(sd), -1, si)
