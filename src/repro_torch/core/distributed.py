"""Cross-segment k-NN over a stack of sealed segments on one device.

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
