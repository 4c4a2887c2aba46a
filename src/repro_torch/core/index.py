"""Multi-table, multi-probe LSH index over fixed-shape tensors.

The port of ``repro/core/index.py``: L tables x K hashes from one p-stable
family, evaluated as one matmul (K1 ``hash_mm`` on the card); buckets are
fixed-capacity slot arrays ``table[l, b, s] -> item id`` (-1 empty) filled
by sort + segmented rank; multi-probe adds the best single-coordinate
perturbations ranked by distance to the bucket boundary; a query gathers
the probed slots, drops duplicates, and re-ranks through K2
``fused_query`` -- or, on a quantized (int8/bf16) segment, scores the
candidates in code space through K5 ``quantized_query``.

Hashing is not switchable: build and query hash through one
implementation per device (the kernel on the card, the plain version on
the CPU), so an item is always found in the bucket it was put in.

Bucket mixing is uint32 arithmetic in JAX.  PyTorch has no dependable
uint32 ops, so values are held in int64 within [0, 2^32) and every product
splits the multiplier into 16-bit halves (no product exceeds 2^48); the
bucket ids equal JAX's bit for bit for equal hashes.

Functions return new state (the JAX package's are pure); nothing here
updates a caller's tensors in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import dispatch, ops
from .hashes import PStableHash

GOLDEN = 0x9E3779B1
MASK32 = 0xFFFFFFFF

# Above this many first-seen table elements (nq * n_items) the dedup falls
# back to a sort (the table would cost nq * n_items * 8 bytes).
DEDUP_SCATTER_MAX_ELEMS = 1 << 26

Family = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    n_dims: int                 # embedding dimension N
    n_tables: int = 8           # L
    n_hashes: int = 4           # K per table
    log2_buckets: int = 12      # B = 2**log2_buckets
    bucket_capacity: int = 32   # S
    r: float = 1.0
    p: float = 2.0

    @property
    def n_buckets(self) -> int:
        return 1 << self.log2_buckets


@dataclasses.dataclass
class LSHIndexState:
    """Hash family + bucket arrays + stored embeddings, all on one device."""

    alpha: torch.Tensor     # (N, L*K) f32 p-stable projections
    b: torch.Tensor         # (L*K,) f32 offsets
    mix: torch.Tensor       # (L, K) int64 odd multipliers in [0, 2^32)
    table: torch.Tensor     # (L, B, S) int32 item ids, -1 = empty
    counts: torch.Tensor    # (L, B) int32 items per bucket (pre-clip)
    db: torch.Tensor        # (n_items, N) f32 stored embeddings


def _mul32(a: torch.Tensor, m) -> torch.Tensor:
    """(a * m) mod 2^32 for int64 a, m in [0, 2^32): m is split into 16-bit
    halves so no intermediate product exceeds 2^48."""
    lo = m & 0xFFFF
    hi = m >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def _bucket_ids(hashes: torch.Tensor, mix: torch.Tensor,
                log2_buckets: int) -> torch.Tensor:
    """Combine per-table K hashes into bucket ids, as uint32 arithmetic:
    ``((sum_k h_k * m_k) * GOLDEN) >> (32 - log2B)``.
    hashes (..., L, K) integer; mix (L, K) int64.  Returns int64 ids."""
    h = hashes.to(torch.int64) & MASK32
    acc = _mul32(h, mix).sum(dim=-1) & MASK32
    return _mul32(acc, GOLDEN) >> (32 - log2_buckets)


def make_family(generator: torch.Generator, cfg: IndexConfig) -> Family:
    """Draw a hash family (alpha, b, mix) from ``generator``."""
    fam = PStableHash.create(generator, cfg.n_dims,
                             cfg.n_tables * cfg.n_hashes, r=cfg.r, p=cfg.p)
    mix = torch.randint(0, 2 ** 31 - 1, (cfg.n_tables, cfg.n_hashes),
                        generator=generator, device=generator.device,
                        dtype=torch.int64) | 1
    return fam.alpha, fam.b, mix


def create_index(cfg: IndexConfig, n_items_cap: int,
                 family: Optional[Family] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> LSHIndexState:
    """A fresh empty index on ``device`` (default: the card).  ``family``
    (alpha, b, mix) reuses an existing family so several indexes -- the
    segments of a streaming index -- give an item the same buckets; without
    it one is drawn from ``generator`` (default seed 0)."""
    dev = dispatch.resolve_device(device)
    if family is None:
        family = make_family(generator or torch.Generator().manual_seed(0),
                             cfg)
    alpha, b, mix = (t.to(dev) for t in family)
    L, B, S = cfg.n_tables, cfg.n_buckets, cfg.bucket_capacity
    return LSHIndexState(
        alpha=alpha.float().contiguous(), b=b.float().contiguous(),
        mix=mix.to(torch.int64),
        table=torch.full((L, B, S), -1, dtype=torch.int32, device=dev),
        counts=torch.zeros((L, B), dtype=torch.int32, device=dev),
        db=torch.zeros((n_items_cap, cfg.n_dims), dtype=torch.float32,
                       device=dev))


def hash_stage(alpha: torch.Tensor, b: torch.Tensor, cfg: IndexConfig,
               x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., L, K) int32 hashes and f32 pre-floor projections (K1)."""
    h, proj = ops.pstable_hash_proj(x, alpha, b, cfg.r)
    shape = x.shape[:-1] + (cfg.n_tables, cfg.n_hashes)
    return h.reshape(shape), proj.reshape(shape)


def _as_rows(state: LSHIndexState, x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32,
                           device=state.db.device).contiguous()


def insert_items(state: LSHIndexState, cfg: IndexConfig, embeddings,
                 start: int, n_valid: int) -> LSHIndexState:
    """Append ``embeddings[:n_valid]`` as items ``start .. start+n_valid-1``.

    Rows at and after ``n_valid`` are padding and land nowhere, so callers
    can pass one fixed chunk shape.  Per table: sort the rows by bucket
    (stable), rank each within its bucket, offset by the bucket's current
    count, and scatter into the slots that fit (overflow is dropped;
    ``counts`` still records true occupancy) -- placement equal to the JAX
    package's for equal hashes.
    """
    x = _as_rows(state, embeddings)
    m = x.shape[0]
    dev = x.device
    L, B, S = cfg.n_tables, cfg.n_buckets, cfg.bucket_capacity
    hashes, _ = hash_stage(state.alpha, state.b, cfg, x)
    buckets = _bucket_ids(hashes, state.mix, cfg.log2_buckets).T    # (L, m)
    ar = torch.arange(m, device=dev)
    valid = ar < n_valid
    ids = (start + ar).to(torch.int32)
    # padding rows get sentinel bucket B: they sort last and are dropped
    b_eff = torch.where(valid, buckets, B)
    sb, order = torch.sort(b_eff, dim=1, stable=True)
    is_start = torch.ones_like(sb, dtype=torch.bool)
    is_start[:, 1:] = sb[:, 1:] != sb[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, ar, 0), dim=1).values
    rank = ar - seg_start
    slot = torch.gather(state.counts.to(torch.int64), 1,
                        sb.clamp(max=B - 1)) + rank
    fits = (slot < S) & (sb < B)
    flat_pos = torch.arange(L, device=dev)[:, None] * (B * S) + sb * S + slot
    # one spare slot past the end takes every write that must be dropped
    pos = torch.where(fits, flat_pos, L * B * S)
    flat = torch.cat([state.table.reshape(-1),
                      state.table.new_full((1,), -1)])
    flat[pos.reshape(-1)] = ids[order].reshape(-1)
    counts = torch.cat([state.counts,
                        state.counts.new_zeros((L, 1))], dim=1)
    counts.scatter_add_(1, b_eff, torch.ones_like(b_eff, dtype=torch.int32))
    db = state.db.clone()
    db[start:start + n_valid] = x[:n_valid]
    return dataclasses.replace(state, table=flat[:-1].view(L, B, S),
                               counts=counts[:, :B].contiguous(), db=db)


def build_index(state: LSHIndexState, cfg: IndexConfig, embeddings
                ) -> LSHIndexState:
    """One-shot build into a fresh state: ``embeddings`` become items
    0..n-1 (the same placement as :func:`insert_items` from empty)."""
    x = _as_rows(state, embeddings)
    return insert_items(state, cfg, x, 0, x.shape[0])


def probe_stage(mix: torch.Tensor, cfg: IndexConfig, hashes: torch.Tensor,
                proj: torch.Tensor, n_probes: int) -> torch.Tensor:
    """(..., L, T) probed bucket ids: the base bucket plus the best T-1
    single-coordinate +-1 perturbations, ranked by distance to the boundary
    (Lv et al. 2007)."""
    frac = proj - torch.floor(proj)
    # score for delta=+1 is (1 - frac), for delta=-1 is frac; smaller first
    scores = torch.cat([1.0 - frac, frac], dim=-1)                # (..., L, 2K)
    base = _bucket_ids(hashes, mix, cfg.log2_buckets)[..., None]
    if n_probes <= 1:
        return base
    t = min(n_probes - 1, 2 * cfg.n_hashes)
    pick = torch.sort(scores, dim=-1, stable=True).indices[..., :t]
    k_idx = pick % cfg.n_hashes
    delta = torch.where(pick < cfg.n_hashes, 1, -1)
    pert = hashes.to(torch.int64)[..., None, :] + delta[..., :, None] * (
        F.one_hot(k_idx, cfg.n_hashes))                             # (..., L, t, K)
    pb = _bucket_ids(pert, mix[:, None, :], cfg.log2_buckets)
    return torch.cat([base, pb], dim=-1)


def _dedup_candidates(cands: torch.Tensor, buckets: torch.Tensor,
                      cfg: IndexConfig, n_cap: int) -> torch.Tensor:
    """Mark duplicate candidate ids -1, first occurrence kept.

    ``cands`` (..., nq, C) are the (nq, C) candidate rows of one segment,
    or of a stack of segments on the leading axis; ``buckets`` (nq, L, T)
    are shared by every segment, and each (segment, query) row is deduped
    exactly as its own segment's call would.

    1. Bucket-local: within a table an item sits in one bucket, so a
       repeat can only come from probing one bucket twice -- kill repeated
       (L, T) buckets whole.
    2. Cross-table: scatter-min each id's slot position into a (rows,
       n_cap) first-seen table and keep a slot iff it came first; where
       one segment's table would pass ``DEDUP_SCATTER_MAX_ELEMS`` (nq *
       n_cap, whatever the number of segments, so that the route does not
       change with the segment count) sort instead (the sorted ids,
       repeats set to -1).
    """
    *lead, nq, c = cands.shape
    t = buckets.shape[-1]
    dup_b = buckets[..., :, None] == buckets[..., None, :]          # (nq,L,T,T)
    earlier = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                    device=cands.device), diagonal=-1)
    dup_b = (dup_b & earlier).any(dim=-1)                           # (nq, L, T)
    cands = torch.where(dup_b[..., None], -1,
                        cands.reshape(*lead, nq, cfg.n_tables, t,
                                      cfg.bucket_capacity)
                        ).reshape(*lead, nq, c)

    if nq * n_cap > DEDUP_SCATTER_MAX_ELEMS:
        cs = torch.sort(cands, dim=-1).values
        dup = torch.zeros_like(cs, dtype=torch.bool)
        dup[..., 1:] = cs[..., 1:] == cs[..., :-1]
        return torch.where(dup, -1, cs)

    shape = cands.shape
    cands = cands.reshape(-1, c)
    rows = cands.shape[0]
    pos = torch.arange(c, device=cands.device).expand(rows, c)
    # -1 slots scatter into a spare last column that is never read
    scat = torch.where(cands >= 0, cands.to(torch.int64), n_cap).clamp(
        max=n_cap)
    first = torch.full((rows, n_cap + 1), c, dtype=torch.int64,
                       device=cands.device)
    first.scatter_reduce_(1, scat, pos, reduce="amin", include_self=True)
    seen_at = torch.gather(first, 1, cands.clamp(0, n_cap - 1).to(torch.int64))
    keep = (cands >= 0) & (seen_at == pos)
    return torch.where(keep, cands, -1).reshape(shape)


def _live_filter(cands: torch.Tensor, live_mask: torch.Tensor
                 ) -> torch.Tensor:
    """-1 where a candidate is tombstoned: ``live_mask`` (cap,) for (nq, C)
    candidates, or (n_seg, cap) for a stack's (n_seg, nq, C)."""
    safe = cands.clamp(0, live_mask.shape[-1] - 1).to(torch.int64)
    if live_mask.dim() == 1:
        alive = live_mask[safe]
    else:
        alive = torch.gather(live_mask, 1, safe.flatten(1)).view_as(safe)
    return torch.where((cands >= 0) & alive, cands, -1)


def gather_stage(table: torch.Tensor, buckets: torch.Tensor,
                 cfg: IndexConfig, n_cap: int,
                 live_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather probed bucket slots + dedup (+ tombstone filter): (nq, L*T*S)
    int32 candidate ids, -1 = empty/duplicate/dead.

    ``table`` (L, B, S) is one segment's; a stack of segments' tables
    (n_seg, L, B, S), with ``live_mask`` (n_seg, cap), gives (n_seg, nq,
    L*T*S) local slots from buckets computed once, each segment's rows
    equal to its own call's."""
    nq = buckets.shape[0]
    tables = torch.arange(cfg.n_tables, device=table.device)[:, None, None]
    bk = buckets.permute(1, 0, 2)                               # (L, nq, T)
    if table.dim() == 4:                                  # (n, L, nq, T, S)
        segs = torch.arange(table.shape[0], device=table.device)
        cands = table[segs[:, None, None, None], tables, bk]
    else:                                                    # (L, nq, T, S)
        cands = table[tables, bk]
    cands = cands.transpose(-4, -3).reshape(*table.shape[:-3], nq, -1)
    cands = _dedup_candidates(cands, buckets, cfg, n_cap)
    if live_mask is not None:
        cands = _live_filter(cands, live_mask)
    return cands


def flat_rows(cands: torch.Tensor, capacity: int) -> torch.Tensor:
    """A stack's (n_seg, nq, C) local slots -> (n_seg * nq, C) int32 rows
    of its ``db`` viewed as (n_seg * capacity, N): slot ``j`` of segment
    ``s`` is row ``s * capacity + j``, -1 stays.  The offset is the same
    for every slot of a segment, so each row's (distance, id) order is its
    segment's own."""
    n_seg = cands.shape[0]
    base = (torch.arange(n_seg, device=cands.device, dtype=torch.int32)
            * capacity)[:, None, None]
    return torch.where(cands >= 0, cands + base, -1).reshape(
        -1, cands.shape[-1]).to(torch.int32).contiguous()


def _candidate_ids(state: LSHIndexState, cfg: IndexConfig, q: torch.Tensor,
                   n_probes: int, live_mask: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """hash -> probe -> gather -> dedup (+ tombstone filter): the candidate
    pipeline every tier shares.  (nq, C) int32, -1 = no candidate."""
    hashes, proj = hash_stage(state.alpha, state.b, cfg, q)
    buckets = probe_stage(state.mix, cfg, hashes, proj, n_probes)
    cands = gather_stage(state.table, buckets, cfg, state.db.shape[0])
    if live_mask is not None:
        cands = _live_filter(cands, live_mask)
    return cands.contiguous()


def _to_gids(ids: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """Local slots -> global ids through ``gids`` (n_items_cap,); -1 stays."""
    return torch.where(ids >= 0,
                       gids[ids.clamp(0, gids.shape[0] - 1).to(torch.int64)],
                       -1)


def query_index(state: LSHIndexState, cfg: IndexConfig, queries, k: int,
                n_probes: int = 1, valid_items: Optional[int] = None,
                live_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN query: hash -> probe -> gather -> dedup -> re-rank -> top-k.

    queries (nq, N); ``valid_items`` masks item ids at and above it;
    ``live_mask`` (n_items_cap,) bool drops tombstoned rows.  Returns
    ascending (ids (nq, k) int32, dists (nq, k) f32), (-1, +inf) padded."""
    q = _as_rows(state, queries)
    cands = _candidate_ids(state, cfg, q, n_probes, live_mask)
    dist, ids = ops.fused_query_topk(q, state.db, cands, k, p=cfg.p,
                                     valid_items=valid_items)
    return ids, dist


def query_index_batched(state: LSHIndexState, cfg: IndexConfig, queries,
                        k: int, n_probes: int = 1,
                        valid_items: Optional[int] = None,
                        batch_size: int = 1024,
                        live_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`query_index` over a large query set in fixed ``batch_size``
    chunks (the last one zero-padded, its padding rows sliced off), so
    every chunk launches K1 and K2 at one shape and the candidate tables
    stay O(batch_size * C).  At most ``batch_size`` rows: one
    :func:`query_index` call.  Returns (ids (nq, k), dists (nq, k))."""
    q = _as_rows(state, queries)
    nq = q.shape[0]
    if nq <= batch_size:
        return query_index(state, cfg, q, k, n_probes, valid_items,
                           live_mask=live_mask)
    ids_out, dist_out = [], []
    for start in range(0, nq, batch_size):
        chunk = q[start:start + batch_size]
        take = chunk.shape[0]
        if take < batch_size:
            chunk = torch.cat([chunk, chunk.new_zeros(
                (batch_size - take, chunk.shape[1]))])
        ids, dist = query_index(state, cfg, chunk, k, n_probes, valid_items,
                                live_mask=live_mask)
        ids_out.append(ids[:take])
        dist_out.append(dist[:take])
    return torch.cat(ids_out), torch.cat(dist_out)


def query_index_gids(state: LSHIndexState, cfg: IndexConfig, queries,
                     k: int, gids: torch.Tensor, n_probes: int = 1,
                     live_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`query_index` with local slots translated to global ids through
    ``gids`` (n_items_cap,) int32.  Returns (gids (nq, k), dists (nq, k))."""
    ids, dist = query_index(state, cfg, queries, k, n_probes=n_probes,
                            live_mask=live_mask)
    return _to_gids(ids, gids), dist


def query_index_quantized(state: LSHIndexState, cfg: IndexConfig, queries,
                          k: int, scale: torch.Tensor, n_probes: int = 1,
                          valid_items: Optional[int] = None,
                          live_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`query_index` over a quantized segment (int8/bf16
    ``state.db``, dequant ``scale`` () f32).

    The candidate pipeline is the fp32 one -- hashing reads only the
    family, which stays fp32 at every tier -- and only the scoring tail
    switches to code space (K5).  Distances are in the fp32 metric,
    approximate within O(scale); serve callers rescore survivors exactly
    (``kernels.quantize.rerank_survivors``)."""
    q = _as_rows(state, queries)
    cands = _candidate_ids(state, cfg, q, n_probes, live_mask)
    dist, ids = ops.quantized_query_topk(q, state.db, scale, cands, k,
                                         p=cfg.p, valid_items=valid_items)
    return ids, dist


def query_index_gids_quantized(state: LSHIndexState, cfg: IndexConfig,
                               queries, k: int, gids: torch.Tensor,
                               scale: torch.Tensor, n_probes: int = 1,
                               live_mask: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`query_index_quantized` with local slots translated to global
    ids -- the quantized analogue of :func:`query_index_gids`."""
    ids, dist = query_index_quantized(state, cfg, queries, k, scale,
                                      n_probes=n_probes, live_mask=live_mask)
    return _to_gids(ids, gids), dist


def brute_force_topk(db, queries, k: int, p: float = 2.0,
                     valid_items: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN (the recall oracle): (ids (nq, k) int64, dists (nq, k)).
    Queries go through in chunks so the (chunk, n_items, N) difference
    tensor stays near 2^26 elements."""
    db = torch.as_tensor(db, dtype=torch.float32)
    q = torch.as_tensor(queries, dtype=torch.float32, device=db.device)
    n, dims = db.shape
    step = max(1, DEDUP_SCATTER_MAX_ELEMS // max(n * dims, 1))
    ids_out, d_out = [], []
    for s in range(0, q.shape[0], step):
        diff = db[None, :, :] - q[s:s + step, None, :]
        if p == 2.0:
            d = torch.linalg.vector_norm(diff, dim=-1)
        else:
            d = torch.sum(torch.abs(diff) ** p, dim=-1) ** (1.0 / p)
        if valid_items is not None:
            d[:, valid_items:] = torch.inf
        ds, idx = torch.sort(d, dim=-1, stable=True)
        ids_out.append(idx[:, :k])
        d_out.append(ds[:, :k])
    if not ids_out:
        return (torch.zeros((0, k), dtype=torch.int64, device=db.device),
                torch.zeros((0, k), device=db.device))
    return torch.cat(ids_out), torch.cat(d_out)


def recall_at_k(lsh_ids: torch.Tensor, exact_ids: torch.Tensor
                ) -> torch.Tensor:
    """Fraction of the exact top-k the LSH query retrieved, averaged over
    queries (-1 = empty slot)."""
    hit = (lsh_ids[:, :, None] == exact_ids[:, None, :]) & \
        (exact_ids[:, None, :] >= 0)
    per_q = hit.any(dim=1).sum(dim=-1) / \
        (exact_ids >= 0).sum(dim=-1).clamp(min=1)
    return per_q.float().mean()
