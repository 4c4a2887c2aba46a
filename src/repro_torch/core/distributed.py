"""Cross-segment k-NN over a stack of sealed segments on one device
(:func:`query_segments_stacked`), or over a placement of them across the
ranks of a serve mesh (:func:`query_segments_sharded`).

The port of ``repro/core/distributed.py``'s ``query_segments_sharded``, for
one device and with no collective, over a
:class:`repro_torch.sharding.placement.SegmentStack`.  Every segment shares
one hash family, so a query batch is hashed and probed once (the JAX
package's staged engine, ``repro/serve/segments.py:177-202``), and:

1. one gather over the stacked tables gives (S, nq, C) local slots, each
   (segment, query) row deduped and filtered by its segment's live mask as
   that segment's own query would;
2. one scorer launch covers every sealed segment: K2 ``fused_query`` on
   fp32 rows, or K5 ``quantized_query`` on int8/bf16 codes with one scale
   per segment, over (S * nq) rows of flat ids ``s * cap + slot`` into the
   stacked ``db``, the queries repeated per segment;
3. the delta is scored by its own K2 call, as the JAX collective scores
   the replicated delta apart;
4. the flat ids become global ids through the stacked ``gids``, and one
   K3 ``merge_topk`` takes the top k of the (nq, S * k + k) pool.

A kernel launch count that does not grow with the segment count: K1 once,
K2/K5 once or twice, K3 once.

The five steps are the JAX staged engine's stages -- ``hash`` (K1),
``probe``, ``gather`` (the stack's and the delta's), ``rerank`` (the
stacked launch and the delta's) and ``merge`` (K3) -- each run inside
``stage(name)``, a no-op unless the caller passes one: the deep-traced
query (``SegmentedIndex.query``) passes a span that syncs the device at its
end, so the staged form is this very function, in this order, with the
same launches and the same bits.

The answer is the per-segment fan-out's bit for bit: each row's
candidates, distances and tie order are its segment's own, and the
merge's (distance, gid) order is total.

:func:`query_segments_sharded` is the port of the JAX collective
(``repro/core/distributed.py:140-370``) for one process driving every rank
of a ``launch.mesh.ServeMesh``: the batch is hashed and probed once (K1)
and the buckets go to each rank's device; then each rank gathers from its
block, scores its ``per_dev`` instances in one K2 launch (K5 on a
quantized tier), silences the instances the router did not pick (-1,
+inf), adds the delta on rank 0 only, and takes its local top k (K3); the
ranks' (nq, k) winners go to rank 0's device, where
``ops.merge_topk_unique`` (two K3 launches) is the fan-in, dropping the
copies replicas answer.  Its stages are the stacked query's plus
``fanin``, run inside ``stage(name)`` likewise, so the deep-traced form is
this very function.  The answer is the stacked query's bit for bit: each
instance's rows are its segment's own, and a two-level merge under a total
order is a one-level merge.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch

from ..kernels import ops
from . import index as lidx
from .index import IndexConfig

_NO_STAGE = contextlib.nullcontext()


def _no_stage(name: str):
    return _NO_STAGE


def query_segments_stacked(stack, delta, family, cfg: IndexConfig,
                           q: torch.Tensor, k: int, n_probes: int = 1,
                           stage: Optional[Callable] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN over ``stack``'s sealed segments and the ``delta`` segment.

    stack: a ``SegmentStack`` (fp32 rows score through K2; int8/bf16 codes
    with per-segment scales through K5, whose distances are approximate:
    the serve layer rescores them); delta: the mutable ``Segment`` (fp32),
    or None; family: (alpha, b, mix) shared by every segment; q (nq, N)
    f32 on the stack's device; ``stage(name)`` a context manager around
    each stage (None: none).  Returns (gids (nq, k) int32, dists (nq, k)
    f32), ascending under the (distance, gid) order, (-1, +inf) padded.
    """
    nq = q.shape[0]
    n_sealed = stack.n_sealed
    with_delta = delta is not None and delta.n_live > 0
    if not n_sealed and not with_delta:
        return (torch.full((nq, k), -1, dtype=torch.int32, device=q.device),
                torch.full((nq, k), torch.inf, device=q.device))
    stage = _no_stage if stage is None else stage
    alpha, b, mix = family
    with stage("hash"):
        hashes, proj = lidx.hash_stage(alpha, b, cfg, q)
    with stage("probe"):
        buckets = lidx.probe_stage(mix, cfg, hashes, proj, n_probes)
    with stage("gather"):
        if n_sealed:
            table, db, gids, live, scale = stack.sealed()
            rows = lidx.flat_rows(
                lidx.gather_stage(table, buckets, cfg, stack.capacity,
                                  live_mask=live), stack.capacity)
        if with_delta:
            delta_cands = lidx.gather_stage(
                delta.state.table, buckets, cfg, delta.capacity,
                live_mask=delta.live).contiguous()
    parts_d, parts_g = [], []
    with stage("rerank"):
        if n_sealed:
            q_rep = q.repeat(n_sealed, 1)
            db_flat = db.reshape(-1, db.shape[-1])
            if scale is None:
                dist, ids = ops.fused_query_topk(q_rep, db_flat, rows, k,
                                                 p=cfg.p)
            else:
                dist, ids = ops.quantized_query_topk(q_rep, db_flat, scale,
                                                     rows, k, p=cfg.p)
            g = lidx._to_gids(ids, gids.reshape(-1))
            # (S * nq, k) segment-major -> (nq, S * k): segment s's k
            # columns
            parts_d.append(dist.view(n_sealed, nq, k).transpose(0, 1)
                           .reshape(nq, n_sealed * k))
            parts_g.append(g.view(n_sealed, nq, k).transpose(0, 1)
                           .reshape(nq, n_sealed * k))
        if with_delta:
            dist, ids = ops.fused_query_topk(q, delta.state.db, delta_cands,
                                             k, p=cfg.p)
            parts_d.append(dist)
            parts_g.append(lidx._to_gids(ids, delta.gids))
    with stage("merge"):
        d, g = ops.merge_topk(torch.cat(parts_d, dim=1),
                              torch.cat(parts_g, dim=1), k)
    return g, d


def query_segments_sharded(placement, family, cfg: IndexConfig,
                           q: torch.Tensor, k: int, n_probes: int = 1,
                           active=None, stage: Optional[Callable] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN over a ``sharding.placement.SegmentPlacement``.

    ``family``: (alpha, b, mix) shared by every segment, on ``q``'s device;
    q (nq, N) f32; ``active``: (n_dev * per_dev,) bool in rank-stripe
    order, the router's pick (None: every instance answers, and the fan-in
    drops replica copies); ``stage(name)``: as in
    :func:`query_segments_stacked`.  A quantized placement scores its
    instances by K5 (pass the survivor width as ``k`` and rescore).
    Returns (gids (nq, k) int32, dists (nq, k) f32) on rank 0's device,
    (-1, +inf) padded."""
    nq = q.shape[0]
    stage = _no_stage if stage is None else stage
    blocks, per_dev = placement.blocks, placement.per_dev
    dev0 = blocks[0].device
    delta = placement.delta
    with_delta = delta is not None and delta.n_live > 0
    alpha, b, mix = family
    with stage("hash"):
        hashes, proj = lidx.hash_stage(alpha, b, cfg, q)
    with stage("probe"):
        buckets = lidx.probe_stage(mix, cfg, hashes, proj, n_probes)
    cap = blocks[0].gids.shape[1]
    with stage("gather"):
        rows, q_at = [], {}
        for blk in blocks:
            dev = blk.device
            if dev not in q_at:
                q_at[dev] = (q.to(dev), buckets.to(dev))
            rows.append(lidx.flat_rows(lidx.gather_stage(
                blk.table, q_at[dev][1], cfg, cap, live_mask=blk.live), cap))
        if with_delta:
            delta_cands = lidx.gather_stage(
                delta.state.table, q_at[dev0][1], cfg, delta.capacity,
                live_mask=delta.live).contiguous()
    parts = []
    with stage("rerank"):
        mask = None
        if active is not None:
            mask = torch.as_tensor(active, dtype=torch.bool).reshape(
                len(blocks), per_dev)
        for r, (blk, rr) in enumerate(zip(blocks, rows)):
            q_rep = q_at[blk.device][0].repeat(per_dev, 1)
            db_flat = blk.db.reshape(-1, blk.db.shape[-1])
            if blk.scale is None:
                dist, ids = ops.fused_query_topk(q_rep, db_flat, rr, k,
                                                 p=cfg.p)
            else:
                dist, ids = ops.quantized_query_topk(q_rep, db_flat,
                                                     blk.scale, rr, k,
                                                     p=cfg.p)
            g = lidx._to_gids(ids, blk.gids.reshape(-1))
            # (per_dev * nq, k) instance-major -> (nq, per_dev * k)
            d = (dist.view(per_dev, nq, k).transpose(0, 1)
                 .reshape(nq, per_dev * k))
            g = g.view(per_dev, nq, k).transpose(0, 1).reshape(nq,
                                                                per_dev * k)
            if mask is not None and not bool(mask[r].all()):
                on = mask[r].repeat_interleave(k).to(blk.device)
                d = torch.where(on, d, torch.inf)
                g = torch.where(on, g, -1)
            parts.append([d, g])
        if with_delta:
            dist, ids = ops.fused_query_topk(q_at[dev0][0], delta.state.db,
                                             delta_cands, k, p=cfg.p)
            parts[0][0] = torch.cat([parts[0][0], dist], dim=1)
            parts[0][1] = torch.cat([parts[0][1],
                                     lidx._to_gids(ids, delta.gids)], dim=1)
    with stage("merge"):
        local = [ops.merge_topk(d, g, k) for d, g in parts]
    with stage("fanin"):
        d, g = ops.merge_topk_unique(
            torch.cat([d.to(dev0) for d, _ in local], dim=1),
            torch.cat([g.to(dev0) for _, g in local], dim=1), k)
    return g, d
