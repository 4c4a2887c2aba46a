"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each function computes what its CUDA kernel computes, in ordinary tensor
ops.  On a CPU tensor the ops wrappers run these; on the card
``chip_smoke.py`` holds every kernel against them on the same inputs, and
the CPU tests hold them against the JAX package's ``repro.kernels.ref`` and
``repro.kernels.merge``.

Tie order: ``lax.top_k`` puts the lower index first among equal values;
``torch.topk`` promises no order, so the selections here use a stable
ascending sort, which does.
"""

from __future__ import annotations

import torch

SENTINEL_ID = torch.iinfo(torch.int32).max
INT32_MIN = torch.iinfo(torch.int32).min


# -- K1 hash_mm, K4 dct_mm ----------------------------------------------------


def floor_to_int32(x: torch.Tensor) -> torch.Tensor:
    """``floor(x)`` as int32, saturating as the card's ``cvt.rzi.s32.f32``
    and JAX's ``astype(int32)`` do: >= 2^31 and +inf give INT32_MAX, < -2^31
    and -inf give INT32_MIN, NaN gives 0.  (``.to(torch.int32)`` gives
    INT32_MIN for all five on the CPU; 2^31 - 1 is not an f32, so a float
    clamp cannot reach INT32_MAX: the limits are selected on the float.)"""
    f = torch.floor(x)
    lim = 2.0 ** 31
    inside = (f >= -lim) & (f < lim)          # False for NaN and +-inf
    h = torch.where(inside, f, 0.0).to(torch.int32)
    h = torch.where(f >= lim, SENTINEL_ID, h)
    return torch.where(f < -lim, INT32_MIN, h)


def hash_mm_proj_ref(x: torch.Tensor, alpha: torch.Tensor, b: torch.Tensor,
                     r: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(floor hashes int32, pre-floor projections f32) with
    proj = (x @ alpha) / r + b -- true division, as the kernel does; the
    floor saturates to int32 as the kernel's conversion does
    (:func:`floor_to_int32`)."""
    proj = (x.float() @ alpha.float()) / r + b.float()
    return floor_to_int32(proj), proj


def dct_mm_ref(fvals: torch.Tensor, dct_t: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """(fvals @ dct_t) * scale."""
    return (fvals.float() @ dct_t.float()) * scale.float()


# -- K2 fused_query, K6 rerank ------------------------------------------------


def rerank_ref(q: torch.Tensor, emb: torch.Tensor, ids: torch.Tensor,
               p: float = 2.0) -> torch.Tensor:
    """Masked L^p distances between q (B, N) and emb (B, C, N); +inf where
    ids < 0."""
    diff = emb.float() - q.float()[:, None, :]
    if p == 2.0:
        d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    elif p == 1.0:
        d = torch.sum(torch.abs(diff), dim=-1)
    else:
        d = torch.sum(torch.abs(diff) ** p, dim=-1) ** (1.0 / p)
    return torch.where(ids < 0, torch.inf, d)


def fused_query_topk_ref(q: torch.Tensor, db: torch.Tensor, ids: torch.Tensor,
                         k: int, p: float = 2.0, valid_items=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather + masked re-rank + top-k, materialising (nq, C, N) -- the
    path the fused kernel exists to avoid.  Returns ascending (dists (nq, k)
    f32, ids (nq, k) int32), -1 where the distance is +inf."""
    m = db.shape[0]
    emb = db[ids.clamp(0, m - 1).long()]                  # (nq, C, N)
    d = rerank_ref(q, emb, ids, p)
    if valid_items is not None:
        d = torch.where(ids >= valid_items, torch.inf, d)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    dist, idx = dist[:, :k], idx[:, :k]
    out_ids = torch.gather(ids.to(torch.int32), 1, idx)
    return dist, torch.where(torch.isinf(dist), -1, out_ids)


# -- K5 quantized_query ------------------------------------------------------


def _row_scale(scale: torch.Tensor, nq: int) -> torch.Tensor:
    """One dequant scale () as it is, or S per-segment scales (S,) as the
    (nq, 1) column each of S equal blocks of nq / S rows reads."""
    if scale.numel() == 1:
        return scale.reshape(())
    return scale.reshape(-1).repeat_interleave(nq // scale.numel())[:, None]


def code_query(q: torch.Tensor, codes_dtype: torch.dtype, scale: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Map fp32 queries into a segment's code space: (q_c, post_scale).
    int8: ``round(q / scale)`` (true division, round half to even); bf16:
    the queries as they are, post-scale 1.  ``scale`` is one f32, or (S,)
    f32 for S equal blocks of q's rows (row r reads ``scale[r // (nq /
    S)]``)."""
    if codes_dtype == torch.int8:
        s = _row_scale(scale, q.shape[0])
        return torch.round(q / s), s
    return q, torch.ones((), dtype=torch.float32, device=q.device)


def quantized_topk_ref(q: torch.Tensor, codes: torch.Tensor,
                       scale: torch.Tensor, ids: torch.Tensor, k: int,
                       p: float = 2.0, valid_items=None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather int8/bf16 candidate rows, score them in code space, top-k,
    then scale the k distances into the fp32 metric.  ``scale`` is one f32
    or one per block of rows (:func:`code_query`): the stacked query's S
    segments, each row of block s read against its segment's scale.

    The JAX oracle (``repro/kernels/quantize.py:110``) scales before its
    top-k, the Pallas kernel after; this follows the kernel, which selects
    on the unscaled distances.  The distances are the same multiply either
    way, and the ids differ only where scaling merges two distances."""
    qc, post = code_query(q.float(), codes.dtype, scale)
    dist, out_ids = fused_query_topk_ref(qc, codes, ids, k, p=p,
                                         valid_items=valid_items)
    return dist * post, out_ids


# -- K7 simhash_pack ----------------------------------------------------------


def simhash_pack_ref(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """pack32(x @ alpha >= 0): (B, K) sign bits -> (B, K/32) int32 words,
    bit j of word w = column 32w+j.  The words are summed in int64 (torch
    widens an int32 sum) and their low 32 bits reinterpreted as int32, so
    bit 31 gives a negative word as JAX's wrapping int32 sum does."""
    return _pack32(x.float() @ alpha.float() >= 0)


def _pack32(bits: torch.Tensor) -> torch.Tensor:
    """(B, K) bool -> (B, K/32) int32 words, bit j of word w = column
    32w+j."""
    bits = bits.to(torch.int64)
    words = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 32, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    packed = (words << shifts).sum(dim=-1)
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32,
                       packed).to(torch.int32)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """fp32 ``fmaf(a, b, c)``, correctly rounded, for finite inputs.  The
    product is exact in float64, and TwoSum gives the float64 sum's exact
    error; rounding that sum to fp32 is then right except where it lies
    exactly halfway between two floats, where the error's sign decides."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.float()
    up = torch.nextafter(r, torch.full_like(r, torch.inf))
    down = torch.nextafter(r, torch.full_like(r, -torch.inf))
    rd = r.double()
    half_up = (s > rd) & (s == (rd + up.double()) / 2)
    half_down = (s < rd) & (s == (rd + down.double()) / 2)
    r = torch.where(half_up & (err > 0), up, r)
    return torch.where(half_down & (err < 0), down, r)


def simhash_pack_chain_ref(x: torch.Tensor, alpha: torch.Tensor
                           ) -> torch.Tensor:
    """:func:`simhash_pack_ref` in the kernel's own arithmetic, bit for
    bit: each projection one ``fmaf`` chain from 0.0 over t = 0 .. N-1 in
    order (:func:`fma32`), then ``>= 0`` and the packing.  Slow (N passes
    over (B, K)); for checks of K7 on the card."""
    x, alpha = x.float(), alpha.float()
    acc = x.new_zeros((x.shape[0], alpha.shape[1]))
    for t in range(x.shape[1]):
        acc = fma32(x[:, t:t + 1].expand_as(acc), alpha[t].expand_as(acc),
                    acc)
    return _pack32(acc >= 0)


# -- K3 merge: the bitonic (distance, id) network -----------------------------


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _compare_exchange(d: torch.Tensor, i: torch.Tensor, span: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One pass: compare-exchange the two halves of every length-``span``
    chunk under the (distance, id) lexicographic order."""
    shape = d.shape
    p = shape[-1]
    dr = d.reshape(*shape[:-1], p // span, 2, span // 2)
    ir = i.reshape(*shape[:-1], p // span, 2, span // 2)
    d0, d1 = dr[..., 0, :], dr[..., 1, :]
    i0, i1 = ir[..., 0, :], ir[..., 1, :]
    swap = (d1 < d0) | ((d1 == d0) & (i1 < i0))
    lo_d, hi_d = torch.where(swap, d1, d0), torch.where(swap, d0, d1)
    lo_i, hi_i = torch.where(swap, i1, i0), torch.where(swap, i0, i1)
    d = torch.stack([lo_d, hi_d], dim=-2).reshape(shape)
    i = torch.stack([lo_i, hi_i], dim=-2).reshape(shape)
    return d, i


def _network(d: torch.Tensor, i: torch.Tensor, sorted_run: int = 1
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The staged bitonic network over a power-of-two last axis.  Entering
    each stage every length-``run`` chunk is sorted; reversing the odd chunk
    of each pair makes each length-``2*run`` chunk bitonic, and log2(2*run)
    compare-exchange passes sort it.  ``sorted_run > 1`` skips the stages
    the caller's pre-sorted runs make unnecessary."""
    shape = d.shape
    p = shape[-1]
    run = sorted_run
    while run < p:
        dr = d.reshape(*shape[:-1], p // (2 * run), 2, run)
        ir = i.reshape(*shape[:-1], p // (2 * run), 2, run)
        dr = torch.cat([dr[..., :1, :], dr[..., 1:, :].flip(-1)], dim=-2)
        ir = torch.cat([ir[..., :1, :], ir[..., 1:, :].flip(-1)], dim=-2)
        d, i = dr.reshape(shape), ir.reshape(shape)
        span = 2 * run
        while span >= 2:
            d, i = _compare_exchange(d, i, span)
            span //= 2
        run *= 2
    return d, i


def _pad_pow2(d: torch.Tensor, i: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Right-pad the last axis to a power of two with (+inf, INT32_MAX),
    which sorts after every real pair."""
    m = d.shape[-1]
    p = next_pow2(m)
    if p != m:
        pad = p - m
        d = torch.cat([d, d.new_full((*d.shape[:-1], pad), torch.inf)], -1)
        i = torch.cat([i, i.new_full((*i.shape[:-1], pad), SENTINEL_ID)], -1)
    return d, i, m


def sort_pairs(d: torch.Tensor, i: torch.Tensor, sorted_run: int = 1
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort (distance, id) pairs ascending-lexicographic through the
    bitonic network.  d: (..., M) f32; i: (..., M) int32."""
    dp, ip, m = _pad_pow2(d.float(), i.to(torch.int32))
    ds, is_ = _network(dp, ip, sorted_run=sorted_run)
    return ds[..., :m], is_[..., :m]


def drop_adjacent_duplicates(sd: torch.Tensor, si: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """On rows sorted by (distance, id): every pair whose id >= 0 repeats
    the id just before it becomes (+inf, -1).  Replicas of one segment
    return bit-equal (distance, gid) pairs, so after the sort they sit side
    by side and the first is kept."""
    dup = torch.zeros_like(si, dtype=torch.bool)
    dup[..., 1:] = (si[..., 1:] == si[..., :-1]) & (si[..., 1:] >= 0)
    return torch.where(dup, torch.inf, sd), torch.where(dup, -1, si)


def merge_topk_unique_ref(dists: torch.Tensor, ids: torch.Tensor, k: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``ops.merge_topk_unique`` in plain ops, on rows of M >= k pairs: a
    full (distance, id) sort with ids < 0 read as +inf, the adjacent
    duplicates dropped, a second sort, the first k, and -1 beside every
    +inf (``repro/kernels/ops.py`` ``_merge_topk_unique_impl``)."""
    d = torch.where(ids < 0, torch.inf, dists).contiguous()
    sd, si = sort_pairs(d, ids.to(torch.int32).contiguous())
    sd, si = sort_pairs(*drop_adjacent_duplicates(sd, si))
    sd, si = sd[..., :k], si[..., :k]
    return sd, torch.where(torch.isinf(sd), -1, si)
