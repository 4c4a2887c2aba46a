"""The launch plans of the port's kernels: the one K2 and K5 share
(``kernels/fused_query._plan``), the small GEMM's of K1 and K4
(``kernels/small_gemm.plan``, for ``csrc/small_gemm.cuh``), K3's select
route (``kernels/merge.plan`` and ``route``) and K6's
(``kernels/rerank.plan``).

A row of C candidate slots is split across a cluster of G blocks of S
slots each, and each candidate row is read by L lanes.  On the CPU the
plan is pure arithmetic, so these tests hold it to what the kernel in
``csrc/topk.cuh`` assumes: every slot owned by exactly one rank, G <= 8,
shared memory within a block's limit for every (C, N) the wrappers
accept, and a vector width that covers the row or the scalar path.
"""

from collections import Counter

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import fused_query  # noqa: E402
from repro_torch.kernels import (merge, rerank, simhash_pack,  # noqa: E402
                                 small_gemm)
from repro_torch.kernels.fused_query import (KP, SMEM_LIMIT,  # noqa: E402
                                             SMEM_PER_BLOCK, _plan)

NQS = [1, 5, 32, 33, 128, 129, 1000, 4096]
CS = [1, 2, 31, 63, 64, 127, 200, 256, 1000, 1023, 1024, 4097, 25000]


def _max_c(n):
    """The largest C the wrappers accept at width N."""
    return (SMEM_LIMIT - 4 * n) // 8


@pytest.mark.parametrize("c", CS)
@pytest.mark.parametrize("nq", NQS)
def test_plan_covers_every_slot_once(nq, c):
    plan = _plan(nq, c, 64, 4)
    g = plan.cluster
    seen = [0] * c
    for rank in range(g):
        # the kernel's walk: rank, rank + G, ... below C
        owned = list(range(rank, c, g))
        assert 1 <= len(owned) <= plan.slots
        assert all(plan.owner(s) == rank for s in owned)
        for s in owned:
            seen[s] += 1
    assert seen == [1] * c
    assert plan.slots == -(-c // g)


@pytest.mark.parametrize("nq", NQS)
def test_plan_cluster_is_a_power_of_two_at_most_8(nq):
    for c in CS:
        g = _plan(nq, c, 64, 4).cluster
        assert 1 <= g <= fused_query.MAX_CLUSTER <= 8 and g & (g - 1) == 0
        if g > 1:
            assert -(-c // g) >= fused_query.MIN_SLOTS


@pytest.mark.parametrize("nq,want", [(32, 4), (128, 2), (1, 4), (33, 4),
                                     (66, 4), (67, 2), (132, 2), (133, 1),
                                     (4096, 1)])
def test_plan_fills_one_wave_at_the_path_shapes(nq, want):
    """C = 1024: 32 rows (the profiled batch) take G = 4, 128 rows (the
    loop's chunk) G = 2; the grid stays within one wave of 264 blocks
    unless nq alone exceeds it, and doubling G again would not."""
    plan = _plan(nq, 1024, 64, 4)
    assert plan.cluster == want
    assert nq * plan.cluster <= max(nq, fused_query.TARGET_BLOCKS)
    if plan.cluster < fused_query.MAX_CLUSTER:
        assert nq * 2 * plan.cluster > fused_query.TARGET_BLOCKS


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 3, 16, 48, 50, 64, 100, 128, 4096,
                               51000])
def test_plan_shared_memory_within_the_block_limit(n, itemsize):
    """Every C the wrappers accept at this N, for every nq: the dynamic
    bytes fit beside the static scratch, and they are the sum the kernel
    lays out (query, S keys, the k winners, rank 0's pool)."""
    max_c = _max_c(n)
    assert max_c >= 1
    cs = sorted({1, 2, 33, 200, 1024, max_c // 2, max_c} & set(
        range(1, max_c + 1)))
    for nq in NQS:
        for c in cs:
            plan = _plan(nq, c, n, itemsize)
            assert plan.smem <= SMEM_PER_BLOCK, (nq, c, n, plan)
            pool = plan.cluster * KP if plan.cluster > 1 else 0
            assert plan.smem == (-(-4 * n // 16) * 16 + 8 * plan.slots
                                 + 8 * KP + 12 * pool)


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 3, 4, 8, 16, 48, 50, 64, 96, 100, 512])
def test_plan_vector_width_covers_the_row(n, itemsize):
    plan = _plan(32, 1024, n, itemsize)
    row_bytes = n * itemsize
    assert plan.vec == (row_bytes % 16 == 0)
    assert 1 <= plan.lanes <= 32 and plan.lanes & (plan.lanes - 1) == 0
    if plan.vec:
        chunks = row_bytes // 16
        # lane l reads chunks l, l + L, ...: each chunk exactly once, and
        # no lane idle
        seen = sorted(j for lane in range(plan.lanes)
                      for j in range(lane, chunks, plan.lanes))
        assert seen == list(range(chunks))
        assert plan.lanes <= chunks
    else:
        seen = sorted(j for lane in range(plan.lanes)
                      for j in range(lane, n, plan.lanes))
        assert seen == list(range(n))


def test_plan_path_shapes_lanes():
    """At N = 64: fp32 rows take 16 lanes, bf16 8, int8 4, each one
    16-byte load; N = 50 takes the scalar path."""
    assert [_plan(32, 1024, 64, s).lanes for s in (4, 2, 1)] == [16, 8, 4]
    assert all(_plan(32, 1024, 64, s).vec for s in (4, 2, 1))
    assert not any(_plan(32, 1024, 50, s).vec for s in (4, 2, 1))


def test_plan_unaligned_table_takes_the_scalar_path():
    assert _plan(32, 1024, 64, 4).vec
    assert not _plan(32, 1024, 64, 4, aligned=False).vec


# -- K1 / K4: the small GEMM (csrc/small_gemm.cuh) ---------------------------

GEMM_MS = [1, 8, 32, 33, 128, 256, 300]
GEMM_NS = [17, 32, 40, 64]
GEMM_KS = [17, 50, 64, 96, 200]
H100_SMS = 132
# The kernel's layout, as csrc/small_gemm.cuh lays it out: kDepth values of
# depth per round, one or (beyond kDepth) two buffers of the block's rows
# of X and of A's column tile, then the tile's entries of the vector.
DEPTH = 64
SMEM_NO_OPT_IN = 48 * 1024   # dynamic shared bytes a block takes as is


def _grid(m, n, plan):
    """(column tiles, blocks) of the kernel's 1-D grid."""
    col_tiles = -(-n // small_gemm.COLS)
    return col_tiles, col_tiles * -(-m // plan.rows)


@pytest.mark.parametrize("k", GEMM_KS)
@pytest.mark.parametrize("n", GEMM_NS)
@pytest.mark.parametrize("m", GEMM_MS)
def test_gemm_plan_covers_every_output_once(m, n, k):
    """The kernel's walk: block b owns rows from (b // col_tiles) * rows
    and columns from (b % col_tiles) * COLS, thread (lane, y < rows) the
    output (row0 + y, col0 + lane); every output of the (m, n) result is
    owned by exactly one thread."""
    plan = small_gemm.plan(m, k, n)
    col_tiles, blocks = _grid(m, n, plan)
    seen = Counter()
    for blk in range(blocks):
        row0 = (blk // col_tiles) * plan.rows
        col0 = (blk % col_tiles) * small_gemm.COLS
        for y in range(plan.rows):
            for lane in range(small_gemm.COLS):
                if row0 + y < m and col0 + lane < n:
                    seen[(row0 + y, col0 + lane)] += 1
    assert len(seen) == m * n
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("n", GEMM_NS)
@pytest.mark.parametrize("m", GEMM_MS)
def test_gemm_plan_fits_one_wave(m, n):
    """At most one block per SM, at most one row a warp (8 warps a block,
    the kernel's launch bounds), rows a power of two, and no more rows a
    block than it takes to bring the grid down to the target."""
    for k in GEMM_KS:
        plan = small_gemm.plan(m, k, n)
        col_tiles, blocks = _grid(m, n, plan)
        assert blocks <= H100_SMS
        assert 1 <= plan.rows <= small_gemm.MAX_ROWS == 8
        assert plan.rows & (plan.rows - 1) == 0
        if plan.rows > 1:
            assert col_tiles * -(-m // (plan.rows // 2)) \
                > small_gemm.TARGET_BLOCKS


@pytest.mark.parametrize("m,k,n,rows,blocks", [
    (32, 64, 32, 1, 32),      # K1, a query micro-batch
    (128, 64, 32, 2, 64),     # K1, the loop's chunk
    (256, 64, 32, 4, 64),     # K1, an insert chunk
    (128, 64, 64, 4, 64),     # K4, an embed chunk
])
def test_gemm_plan_spreads_the_path_shapes(m, k, n, rows, blocks):
    """The path's shapes take tens of SMs (one tile of 32 x 32 a block
    left 1 or 8 busy)."""
    plan = small_gemm.plan(m, k, n)
    assert (plan.rows, _grid(m, n, plan)[1]) == (rows, blocks)
    assert plan.vec


@pytest.mark.parametrize("k", [0, 1, 4, 17, 50, 63, 64, 65, 96, 128, 200,
                               4096, 1_000_000])
def test_gemm_plan_shared_memory_within_the_block_limit(k):
    """Every depth the wrappers accept: one buffer up to 64, two beyond
    (the next tile's copies in flight), within what a block takes without
    opting in."""
    for m in GEMM_MS + [100_000]:
        for n in GEMM_NS + [1, 1000]:
            plan = small_gemm.plan(m, k, n)
            stages = 2 if k > DEPTH else 1
            smem = 4 * (stages * (plan.rows * DEPTH
                                  + DEPTH * small_gemm.COLS)
                        + small_gemm.COLS)
            assert smem <= SMEM_NO_OPT_IN


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", GEMM_NS + [4, 36])
@pytest.mark.parametrize("k", GEMM_KS + [4, 16])
def test_gemm_plan_vector_path_only_when_aligned(k, n, aligned):
    """16-byte copies only when every pointer is aligned and both row
    lengths (k for X, n for A and the column vector) are multiples of 4."""
    assert small_gemm.plan(32, k, n, aligned).vec == (
        aligned and k % 4 == 0 and n % 4 == 0)


# -- K3 merge: the select route's plan (csrc/merge.cu) ------------------------

MERGE_ROWS = [1, 5, 32, 33, 128, 129, 264, 300, 4096]
MERGE_MS = [1, 2, 3, 5, 40, 255, 256, 511, 513, 2570, 8192, 10320, 16385,
            41280, 100_000, 1_000_000]
# a block's 227 KB less its static scratch (merge.cu's Scratch, ~2.3 KB)
MERGE_SMEM_MAX = 227 * 1024 - 4096


@pytest.mark.parametrize("m", MERGE_MS)
@pytest.mark.parametrize("rows", MERGE_ROWS)
def test_merge_plan_owns_every_pair_once(rows, m):
    """Rank r reads pairs [r * share, (r + 1) * share) of a row: every pair
    has exactly one owner, every rank owns at least one pair, and the share
    is a multiple of 4 (the 16-byte chunks)."""
    for aligned in (True, False):
        plan = merge.plan(rows, m, aligned)
        g, share = plan.cluster, plan.share
        assert share % 4 == 0 and share * g >= m
        owners = Counter(plan.owner(j) for j in range(0, m, max(1, m // 997)))
        owners.update(plan.owner(j) for j in (0, m - 1))
        assert set(owners) <= set(range(g))
        for r in range(g):
            lo, hi = r * share, min(m, (r + 1) * share)
            assert lo < hi, (rows, m, plan)
            assert plan.owner(lo) == r and plan.owner(hi - 1) == r


@pytest.mark.parametrize("rows", MERGE_ROWS)
def test_merge_plan_grid_is_one_wave(rows):
    """rows x G blocks stay within one wave of 264 unless the rows alone
    exceed it, G is a power of two <= 8, and doubling G again would leave
    the wave or a rank with fewer than 256 pairs."""
    for m in MERGE_MS:
        plan = merge.plan(rows, m)
        g = plan.cluster
        assert 1 <= g <= merge.MAX_CLUSTER <= 8 and g & (g - 1) == 0
        assert rows * g <= max(rows, merge.TARGET_BLOCKS)
        if g < merge.MAX_CLUSTER:
            assert (rows * 2 * g > merge.TARGET_BLOCKS
                    or -(-m // (2 * g)) < merge.MIN_SHARE)


@pytest.mark.parametrize("m", MERGE_MS + list(range(1, 10))
                         + [10 ** 6 - 1, 999_983])
def test_merge_plan_shared_memory_within_the_block_limit(m):
    """Every M up to 10^6: the tile holds at most 8,192 keys, the pool
    (KP + tile keys), three lists of KP and rank 0's G lists fit beside the
    static scratch, and a share of at most 8,192 keys is one tile (the
    16-byte chunks may start 3 pairs early)."""
    for rows in MERGE_ROWS:
        for aligned in (True, False):
            plan = merge.plan(rows, m, aligned)
            assert plan.tile % 4 == 0 and 4 <= plan.tile <= merge.MAX_TILE
            assert plan.smem == merge.smem_bytes(plan.tile, plan.cluster)
            assert plan.smem <= MERGE_SMEM_MAX
            assert merge.smem_bytes(merge.MAX_TILE,
                                    merge.MAX_CLUSTER) <= MERGE_SMEM_MAX
            chunk = 4 if plan.vec else 1
            chunks = -(-(plan.share + chunk - 1) // chunk)
            if chunks * chunk <= merge.MAX_TILE:
                assert chunks * chunk <= plan.tile


def test_merge_plan_path_shapes():
    """G = 4 at the fp32 fan-in (32, 2570), 2 at the int8 fan-in (128,
    10,320) and at 1,032 int8 segments (128, 41,280), which streams three
    tiles a rank; the survivor sort (128, 40) takes one block a row."""
    assert merge.plan(32, 2570).cluster == 4
    assert merge.plan(128, 10320).cluster == 2
    p = merge.plan(128, 41280)
    assert p.cluster == 2 and -(-p.share // p.tile) == 3
    assert merge.plan(128, 40)[:3] == (1, 40, 44)
    assert merge.plan(1, 100_000).share > merge.MAX_TILE


@pytest.mark.parametrize("n_out,run,want", [
    (1, 1, "select"), (10, 1, "select"), (128, 1, "select"),
    (129, 1, "network"), (4096, 1, "network"), (10, 2, "network"),
    (40, 16, "network"), (129, 16, "network")])
def test_merge_route(n_out, run, want):
    """n_out > 128 or sorted_run > 1 takes the network; the choice reads
    no tensor and no environment."""
    for rows in (1, 32, 300):
        for m in (n_out, 2570, 41280):
            assert merge.route(rows, m, n_out, run) == want


# -- K6 rerank's plan (csrc/rerank.cu) ----------------------------------------


@pytest.mark.parametrize("n", [1, 3, 4, 48, 50, 64, 100, 200, 4096])
@pytest.mark.parametrize("b", [1, 9, 128, 264, 265, 1000, 100_000])
def test_rerank_plan(b, n):
    """One query row a block until the grid passes one wave; the rows fit
    48 KB; L lanes (a power of two <= 32) cover a row's 16-byte chunks once
    with no lane idle, or its floats on the scalar path."""
    for aligned in (True, False):
        plan = rerank.plan(b, n, aligned)
        ldq = -(-n // 4) * 4
        assert plan.smem == plan.rows * ldq * 4 <= rerank.SMEM_LIMIT
        assert plan.rows == 1 or -(-b // (plan.rows // 2)) > 264
        assert plan.vec == (aligned and n % 4 == 0)
        assert 1 <= plan.lanes <= 32 and plan.lanes & (plan.lanes - 1) == 0
        units = n // 4 if plan.vec else n
        seen = sorted(j for lane in range(plan.lanes)
                      for j in range(lane, units, plan.lanes))
        assert seen == list(range(units))
        # every lane has a first unit, and two at once when the row has them
        assert plan.lanes <= max(1, -(-units // rerank.PRE))


def test_rerank_plan_path_shape():
    """(128, 40, 64): 128 blocks of one row, 8 lanes a pair (four pairs a
    warp), two 16-byte loads a lane at once."""
    assert rerank.plan(128, 64) == rerank.Plan(1, 8, True, 256)


# -- K7 simhash_pack's plan (csrc/simhash_pack.cu) ----------------------------

SIM_MS = [1, 31, 32, 37, 512, 513, 4096]
SIM_KS = [32, 64, 96, 128, 160, 1024, 2048]
SIM_NS = [1, 16, 50, 64, 65, 100, 200]
SIM_ROWS, SIM_DEPTH = 32, 64    # the kernel's rows a block, depth a stage


def _sim_outputs(m, k, words):
    """The kernel's walk: block b owns rows from (b // col_tiles) * 32 and
    words from (b % col_tiles) * words; each (row, word) of the (m, k / 32)
    result, counted by the block that stores it."""
    col_tiles = -(-k // (32 * words))
    blocks = col_tiles * -(-m // SIM_ROWS)
    seen = Counter()
    for blk in range(blocks):
        row0 = (blk // col_tiles) * SIM_ROWS
        word0 = (blk % col_tiles) * words
        for r in range(row0, min(m, row0 + SIM_ROWS)):
            for w in range(word0, min(k // 32, word0 + words)):
                seen[(r, w)] += 1
    return blocks, seen


@pytest.mark.parametrize("k", SIM_KS)
@pytest.mark.parametrize("m", SIM_MS)
def test_simhash_plan_covers_every_word_once(m, k):
    """Words a block 1, 2 or 4, the widest that k fills; the kernel's grid
    for it stores every output word once."""
    plan = simhash_pack.plan(m, 64, k)
    assert plan.words in (1, 2, 4)
    assert 32 * plan.words <= k or plan.words == 1
    assert plan.words == 4 or 32 * 2 * plan.words > k
    _, seen = _sim_outputs(m, k, plan.words)
    assert len(seen) == m * (k // 32) and set(seen.values()) == {1}


@pytest.mark.parametrize("n", SIM_NS)
def test_simhash_plan_depth_and_copy_width(n):
    """The kernel's shared memory for the plan's words -- one stage (X 32 x
    64 and A 64 x 32 * words floats) up to depth 64, two past it -- fits a
    block's limit; 16-byte copies only with both pointers aligned and
    n % 4 == 0."""
    for k in SIM_KS:
        for aligned in (True, False):
            plan = simhash_pack.plan(512, n, k, aligned)
            stage = 4 * (SIM_ROWS * SIM_DEPTH + SIM_DEPTH * 32 * plan.words)
            assert (2 if n > SIM_DEPTH else 1) * stage <= merge.SMEM_LIMIT
            assert plan.vec == (aligned and n % 4 == 0)


@pytest.mark.parametrize("m,n,k,aligned,want", [
    # the benchmark's shape: 16 x 8 = 128 blocks, one wave on 132 SMs
    (512, 64, 1024, True, simhash_pack.Plan(4, True)),
    (512, 64, 1024, False, simhash_pack.Plan(4, False)),
    (37, 50, 96, True, simhash_pack.Plan(2, False)),
    (1, 64, 32, True, simhash_pack.Plan(1, True)),
    (513, 100, 160, True, simhash_pack.Plan(4, True)),
    (4096, 200, 2048, True, simhash_pack.Plan(4, True)),
])
def test_simhash_plan_shapes(m, n, k, aligned, want):
    assert simhash_pack.plan(m, n, k, aligned) == want
    blocks, _ = _sim_outputs(m, k, want.words)
    assert blocks <= H100_SMS or m > 512
