"""Cross-segment k-NN over a stack of sealed segments on one device
(:func:`query_segments_stacked`), or over a placement of them across the
ranks of a serve mesh (:func:`query_segments_sharded`); and the paper's
index at pod scale, one independent-family index a rank of a ``(data,
model)`` mesh (:func:`build_distributed`, :func:`query_distributed`,
:func:`brute_force_distributed`).

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

The pod index is the port of ``repro/core/distributed.py:58-137,
373-399`` for one process driving every rank of a
``launch.mesh.PodMesh`` (ranks may share a card).  Items are split in
contiguous blocks over the ``data`` axis; each rank ``(di, mi)`` builds its
own ``LSHIndexState`` over block ``di`` with its own hash family, so the
pod holds L x M OR-amplified tables.  A query runs ``query_index`` on every
rank (K1, K2), turns local ids into global ones (``id + di * n_local``),
and fans the (nq, k) lists in on rank (0, 0)'s device through
``ops.merge_topk_unique`` (two K3 launches), which drops the copies of an
item that several model shards found.  Brute force takes an exact top k
over each data block and merges the (nq, D * k) lists by K3.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from . import index as lidx
from .index import IndexConfig, LSHIndexState

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


# -- the independent-family pod index -----------------------------------------


PodState = Tuple[Tuple[LSHIndexState, ...], ...]

# Brute force scores at most this many items of a block a K2 launch, and
# fewer when nq x chunk would pass BRUTE_IDS_MAX_ELEMS (the launch's
# (nq, chunk) id table: 256 MiB of int32).
BRUTE_CHUNK_MAX = 16384
BRUTE_IDS_MAX_ELEMS = 1 << 26


def family_seed(seed: int, di: int, mi: int, n_model: int) -> int:
    """The generator seed of rank (di, mi)'s drawn family."""
    return seed * 1_000_003 + di * n_model + mi


def _rank_family(fam, dev):
    """A family given as tensors or as numpy arrays (``mix`` uint32, as the
    JAX package's) -> tensors on ``dev``, ``mix`` int64."""
    def tensor(t, dtype):
        if not isinstance(t, torch.Tensor):
            a = np.array(t)
            t = torch.from_numpy(a.astype(np.int64) if dtype == torch.int64
                                 else a)
        return t.to(dev, dtype).contiguous()
    alpha, b, mix = fam
    return (tensor(alpha, torch.float32), tensor(b, torch.float32),
            tensor(mix, torch.int64))


def _split(embeddings, d: int, what: str) -> Tuple[torch.Tensor, int]:
    """(the items as a tensor, rows a data block); raises unless they split
    into ``d`` equal blocks, as JAX's ``shard_map`` requires."""
    x = embeddings if isinstance(embeddings, torch.Tensor) else \
        torch.as_tensor(embeddings)
    if x.shape[0] % d:
        raise ValueError(f"{what}: {x.shape[0]} items do not split into "
                         f"{d} equal data blocks")
    return x, x.shape[0] // d


def build_distributed(cfg: IndexConfig, embeddings, mesh, families=None,
                      seed: int = 0) -> PodState:
    """Build the pod index: rank (di, mi) of ``mesh`` (a ``PodMesh``) holds
    one ``LSHIndexState`` on its device over data block di.

    embeddings: (n_items, N), numpy or a tensor on any device (bf16 is cast
    to fp32 at insert); ``n_items`` must divide by D, as JAX's
    ``shard_map`` requires.  ``families``: a (D, M) grid of (alpha, b,
    mix), as tensors or numpy arrays; the JAX package draws rank (di, mi)'s
    from ``fold_in(fold_in(key, di), mi)``, which torch cannot redraw, so
    parity tests pass those arrays in.  Without it each rank draws from a
    ``torch.Generator`` seeded :func:`family_seed` (``seed * 1_000_003 +
    di * M + mi``): not the JAX draw, but as independent across ranks.

    Model shards of one data block on one device share one ``db`` tensor
    (the same rows; nothing updates a state in place).  Returns the (D, M)
    grid of states, ``[di][mi]``."""
    d, m = len(mesh.devices), len(mesh.devices[0])
    x, n_local = _split(embeddings, d, "build_distributed")
    grid = []
    for di in range(d):
        block, row = x[di * n_local:(di + 1) * n_local], []
        for mi in range(m):
            dev = mesh.devices[di][mi]
            if families is not None:
                fam = _rank_family(families[di][mi], dev)
            else:
                gen = torch.Generator().manual_seed(
                    family_seed(seed, di, mi, m))
                fam = lidx.make_family(gen, cfg)
            state = lidx.build_index(
                lidx.create_index(cfg, n_local, family=fam, device=dev), cfg,
                block.to(dev, torch.float32))
            if row and row[0].db.device == state.db.device:
                state = dataclasses.replace(state, db=row[0].db)
            row.append(state)
        grid.append(tuple(row))
    return tuple(grid)


def query_distributed(pod: PodState, cfg: IndexConfig, queries, k: int,
                      n_probes: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global k-NN over the pod index: :func:`query_lists` fanned in by
    :func:`fan_in`.

    An item several model shards found comes back from each with
    bit-equal distances (the same row, query and kernel), so its copies
    sit side by side in the (distance, id) order and the first stays: the
    pick of JAX's stable sort by id, duplicate masking and ``top_k``, the
    lowest id among equal distances.  queries: (nq, N).  Returns (ids (nq,
    k) int32, dists (nq, k) f32) on rank (0, 0)'s device, (-1, +inf) where
    fewer than k were found."""
    return fan_in(*query_lists(pod, cfg, queries, k, n_probes), k)


def query_lists(pod: PodState, cfg: IndexConfig, queries, k: int,
                n_probes: int = 1) -> Tuple[list, list]:
    """Every rank's answer before the fan-in: each rank queries its own
    index (``query_index``: K1, K2) and ids >= 0 become global ids ``id +
    di * n_local``.  Returns (dists, gids): lists of (nq, k) tensors on
    rank (0, 0)'s device in (di, mi) row-major order, the order of JAX's
    all-gather over ``(data, model)``."""
    dev0 = pod[0][0].db.device
    q_at, parts_d, parts_g = {}, [], []
    for di, row in enumerate(pod):
        for state in row:
            dev = state.db.device
            if dev not in q_at:
                q_at[dev] = torch.as_tensor(queries, dtype=torch.float32,
                                            device=dev).contiguous()
            ids, dist = lidx.query_index(state, cfg, q_at[dev], k,
                                         n_probes=n_probes)
            n_local = state.db.shape[0]
            parts_g.append(torch.where(ids >= 0, ids + di * n_local,
                                       -1).to(torch.int32).to(dev0))
            parts_d.append(dist.to(dev0))
    return parts_d, parts_g


def fan_in(dists, gids, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pod query's fan-in: the ranks' (nq, k) lists in (di, mi)
    row-major order, on one device -> (gids (nq, k) int32, dists (nq, k)
    f32), ascending under (distance, gid), each gid once, (-1, +inf)
    padded.  ``ops.merge_topk_unique``: on the card two K3 launches."""
    d, g = ops.merge_topk_unique(torch.cat(list(dists), dim=1),
                                 torch.cat(list(gids), dim=1), k)
    return g, d


def block_lists(block: torch.Tensor, q: torch.Tensor, k: int,
                p: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top k of each chunk of the rows of ``block`` for each query,
    before the chunks are merged: (dists (nq, chunks * k) f32, ids (nq,
    chunks * k) int32, ids local to ``block``).

    The items go through K2 (``ops.fused_query_topk``) in chunks, every
    item of a chunk a candidate of every query: the difference-norm
    distances JAX's ``brute_force_topk`` takes, never ``||x||^2 - 2 x.q +
    ||q||^2``, and K2's order is (distance, lower slot), here (distance,
    lower id).  ``core/index.brute_force_topk`` would materialise (nq, n,
    N) a query at a time; ``torch.cdist`` without the matmul runs one
    thread block a (query, item) pair."""
    nq, n = q.shape[0], block.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"brute force: k={k} outside 1..{n} items a block")
    chunk = max(k, min(BRUTE_CHUNK_MAX, n, BRUTE_IDS_MAX_ELEMS // max(nq, 1)))
    slots = {}
    parts_d, parts_g = [], []
    for start in range(0, n, chunk):
        rows = block[start:start + chunk]
        c = rows.shape[0]
        if c not in slots:
            slots[c] = torch.arange(c, dtype=torch.int32,
                                    device=q.device).expand(nq, c).contiguous()
        dist, ids = ops.fused_query_topk(q, rows, slots[c], min(k, c), p=p)
        parts_d.append(dist)
        parts_g.append(torch.where(ids >= 0, ids + start, -1))
    return torch.cat(parts_d, dim=1), torch.cat(parts_g, dim=1)


def brute_force_lists(embeddings, queries, k: int, mesh, p: float = 2.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every data block's exact top k before the last merge: data rank di
    (rank (di, 0) of ``mesh``) merges its :func:`block_lists` by K3
    (``ops.merge_topk``) and makes the ids global (``id + di * n_local``).
    Returns (dists (nq, D * k) f32, gids (nq, D * k) int32) on rank (0,
    0)'s device, the blocks in order."""
    d = len(mesh.devices)
    x, n_local = _split(embeddings, d, "brute_force_distributed")
    dev0 = mesh.devices[0][0]
    parts_d, parts_g = [], []
    for di in range(d):
        dev = mesh.devices[di][0]
        block = x[di * n_local:(di + 1) * n_local].to(
            dev, torch.float32).contiguous()
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=dev).contiguous()
        dist, ids = ops.merge_topk(*block_lists(block, q, k, p), k)
        parts_g.append(torch.where(ids >= 0, ids + di * n_local,
                                   -1).to(torch.int32).to(dev0))
        parts_d.append(dist.to(dev0))
    return torch.cat(parts_d, dim=1), torch.cat(parts_g, dim=1)


def brute_force_distributed(embeddings, queries, k: int, mesh,
                            p: float = 2.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN over the pod's data blocks (the baseline the paper
    competes with; JAX ``repro/core/distributed.py:373-399``): the (nq, D
    * k) lists of :func:`brute_force_lists` merged on rank (0, 0)'s device
    by K3 (``ops.merge_topk``), the (distance, id) order JAX's ``top_k``
    over the gathered lists gives.  Returns (ids (nq, k) int32, dists (nq,
    k) f32)."""
    dist, ids = ops.merge_topk(*brute_force_lists(embeddings, queries, k,
                                                  mesh, p), k)
    return ids, dist
