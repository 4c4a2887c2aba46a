"""The launch plan of the small fp32 GEMM that K1 (``hash_mm``) and K4
(``dct_mm``) share, ``csrc/small_gemm.cuh``.

A block of the kernel owns ``rows`` output rows by ``COLS`` columns, one
thread per output; the 1-D grid walks the column tiles fastest.  The plan
picks ``rows`` and the copy width; the kernel derives the rest.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

COLS = 32               # output columns per block, one per lane (kCols)
MAX_ROWS = 8            # rows per block at most: one per warp (kMaxWarps)
TARGET_BLOCKS = 64      # rows per block double until the grid is this small


class Plan(NamedTuple):
    """What a launch passes: ``rows`` output rows per block and ``vec``,
    True for 16-byte copies (else the scalar instantiation)."""
    rows: int
    vec: bool


@functools.lru_cache(maxsize=1024)
def plan(m: int, k: int, n: int, aligned: bool = True) -> Plan:
    """The plan for X (m, k) @ A (k, n) (``aligned``: X, A and the
    per-column vector all start on a 16-byte boundary).  Rows per block
    double from 1 while the grid exceeds 64 blocks, so that the path's
    shapes take 32-64 SMs in one wave: 1 row at 32 x 32, 2 at 128 x 32, 4
    at 256 x 32 and at K4's 128 x 64.  The 16-byte path needs the pointers
    aligned and k and n multiples of 4 floats."""
    col_tiles = -(-n // COLS)
    rows = 1
    while rows < MAX_ROWS and col_tiles * -(-m // rows) > TARGET_BLOCKS:
        rows *= 2
    return Plan(rows, aligned and k % 4 == 0 and n % 4 == 0)
