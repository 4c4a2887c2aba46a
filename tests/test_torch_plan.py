"""The launch plan K2 and K5 share (``kernels/fused_query._plan``).

A row of C candidate slots is split across a cluster of G blocks of S
slots each, and each candidate row is read by L lanes.  On the CPU the
plan is pure arithmetic, so these tests hold it to what the kernel in
``csrc/topk.cuh`` assumes: every slot owned by exactly one rank, G <= 8,
shared memory within a block's limit for every (C, N) the wrappers
accept, and a vector width that covers the row or the scalar path.
"""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import fused_query  # noqa: E402
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
