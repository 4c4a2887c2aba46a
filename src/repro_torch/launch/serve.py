"""Streaming serve demo on the card: the l2-basis tenant, end to end.

    python -m repro_torch.launch.serve                       # on the card
    python -m repro_torch.launch.serve --n-items 262144 --steps 20
    python -m repro_torch.launch.serve --device cpu --n-items 2048 --steps 4
    python -m repro_torch.launch.serve --precision int8      # int8 tier
    python -m repro_torch.launch.serve --device cpu --n-items 0 --steps 40 \
        --delete-frac 0.9 --compact-at 0.3                  # compacts

The port of the scripted demo loop of ``repro/launch/serve.py`` for the
``l2-basis`` tenant (p = 2, Chebyshev-basis embedding, Eq. 3).  It first
fills the index with ``--n-items`` random smooth functions (embed +
insert), then runs ``--steps`` ticks, each of which embeds and inserts a
batch, submits several small query requests (perturbations of fresh
functions) through the micro-batcher, tombstones a slice of the oldest
items, and compacts the tenant (``servable.maintenance.compact()``) once
its tombstone share exceeds ``--compact-at``.  It ends with a report:
ingest rate, QPS and latency percentiles, recall@k against exact brute
force on a probe set, the self-hit rate of stored items queried exactly,
segment occupancy, compactions, the sealed store's bytes per item, device
memory, and the kernels' launch counts.  ``--precision`` stores the sealed
segments as bf16 or int8 codes (the quantized tier).

The other tenants, WAL, snapshots and sharding are not ported yet; the
defaults keep the JAX demo's shapes.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..kernels import dispatch
from ..serve import ServableRegistry, ServableSpec, recall_proxy


def default_spec(n_dims: int = 64, segment_capacity: int = 1024,
                 max_delay_ms: float = 2.0, precision: str = "fp32"
                 ) -> ServableSpec:
    """The demo's l2-basis tenant (JAX ``launch/serve.py:81``) at a storage
    tier (JAX ``--precision``)."""
    return ServableSpec(name="l2-basis", n_dims=n_dims, p=2.0, r=4.0,
                        embedder="basis", segment_capacity=segment_capacity,
                        chunk_sizes=(8, 32, 128), max_delay_ms=max_delay_ms,
                        precision=precision)


def sample_fvals(rng: np.random.Generator, nodes: np.ndarray, n: int
                 ) -> np.ndarray:
    """n random smooth functions (sums of three random sines) at ``nodes``."""
    amps = rng.normal(size=(n, 3)) / 3.0
    freqs = rng.uniform(0.5, 4.0, size=(n, 3))
    phase = rng.uniform(0, 2 * np.pi, size=(n, 3))
    return np.sum(amps[:, :, None] *
                  np.sin(freqs[:, :, None] * nodes[None, None, :]
                         + phase[:, :, None]), axis=1).astype(np.float32)


def _held_mask(index) -> torch.Tensor:
    """Per live item, in ``index.live_items()`` order: is it held in a
    bucket slot of at least one table?"""
    parts = []
    for seg in index.segments:
        if seg.n_live == 0:
            continue
        held = torch.zeros(seg.capacity, dtype=torch.bool,
                           device=seg.live.device)
        slots = seg.state.table.flatten()
        held[slots[slots >= 0].to(torch.int64)] = True
        parts.append(held[:seg.n_items][seg.live[:seg.n_items]])
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.bool)


def self_hit_rate(sv, k: int, n_probes: int, n: int) -> float:
    """Share of ``n`` stored items (evenly spaced over the live items held
    in at least one table) that, queried exactly, come back first at
    distance 0.  An item every one of whose buckets overflowed is in no
    table and no query can find it, so it is not asked for."""
    emb_live, gid_live = sv.index.live_items()
    held_idx = torch.nonzero(_held_mask(sv.index)).flatten().cpu().numpy()
    pick = held_idx[np.linspace(0, held_idx.size - 1,
                                min(n, held_idx.size)).astype(int)]
    g, d = sv.query(emb_live[pick].cpu().numpy(), k, n_probes)
    want = gid_live[pick].cpu().numpy()
    return float(np.mean((g[:, 0] == want) & (d[:, 0] == 0.0)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(*, device=None, n_items: int = 0, steps: int = 20,
        insert_batch: int = 64, query_batch: int = 8,
        queries_per_step: int = 4, k: int = 10, n_probes: int = 4,
        delete_frac: float = 0.05, compact_at: float = 0.3, n_dims: int = 64,
        segment_capacity: int = 1024, recall_probe_size: int = 64,
        self_hit_probes: int = 64, fill_batch: int = 8192, seed: int = 0,
        precision: str = "fp32", registry=None, log=print) -> dict:
    """Fill, run the demo loop, and return the report dict.  The tenant
    is registered in ``registry`` (a fresh one on ``device`` by default),
    so a caller that passes its own can keep querying it afterwards."""
    registry = registry or ServableRegistry(device=device)
    dev = registry.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(seed)
    sv = registry.register(default_spec(n_dims, segment_capacity,
                                        precision=precision))
    nodes = sv.nodes()
    inserted: list = []
    compactions = 0

    t0 = time.perf_counter()
    for start in range(0, n_items, fill_batch):
        rows = min(fill_batch, n_items - start)
        inserted.extend(sv.insert(sv.embed(sample_fvals(rng, nodes, rows)))
                        .tolist())
    _sync(dev)
    fill_s = time.perf_counter() - t0
    log(f"[serve] filled {n_items} items in {fill_s:.3f}s "
        f"({len(sv.index.segments)} segments)")

    futures = []
    t0 = time.perf_counter()
    for step in range(steps):
        emb = sv.embed(sample_fvals(rng, nodes, insert_batch))
        inserted.extend(sv.insert(emb).tolist())
        for _ in range(queries_per_step):
            base = sv.embed(sample_fvals(rng, nodes, query_batch)).cpu()
            qs = base.numpy() + rng.normal(
                scale=0.05, size=tuple(base.shape)).astype(np.float32)
            futures.append(sv.submit_query(qs, k, n_probes))
        sv.batcher.pump()
        n_del = int(delete_frac * insert_batch)
        if n_del and len(inserted) > 4 * n_del:
            victims, inserted = inserted[:n_del], inserted[n_del:]
            sv.delete(victims)
        # the tombstone share from the index's host counters (a device
        # reduction per segment would cost a sync each)
        n_all = sv.index.n_items
        if n_all and (n_all - sv.index.n_live) / n_all > compact_at:
            sv.maintenance.compact()
            compactions += 1
    sv.batcher.flush_all()
    _sync(dev)
    loop_s = time.perf_counter() - t0
    for f in futures:
        f.result()             # a failed batch raises here
    n_rows = sum(f.result()[0].shape[0] for f in futures)
    log(f"[serve] {steps} steps in {loop_s:.3f}s: {len(futures)} requests, "
        f"{n_rows} query rows answered")

    probe = sv.embed(sample_fvals(rng, nodes, recall_probe_size))
    recall = recall_proxy(sv.index, probe, k, n_probes=n_probes)
    sv.stats.record_recall(recall)

    # Stored items queried exactly must come back first, at distance 0:
    # build and query hash through one implementation.
    self_hit = self_hit_rate(sv, k, n_probes, self_hit_probes)

    rep = sv.report()
    stats = rep["stats"]
    report = {
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "n_items_filled": n_items,
        "fill_s": fill_s,
        "ingest_rows_per_s": n_items / fill_s if fill_s > 0 else 0.0,
        "steps": steps,
        "loop_s": loop_s,
        "requests": len(futures),
        "query_rows": n_rows,
        "qps": stats["qps"],
        "p50_ms": stats["p50_ms"],
        "p95_ms": stats["p95_ms"],
        "recall_at_k": recall,
        "k": k,
        "recall_probe_size": recall_probe_size,
        "self_hit_rate": self_hit,
        "held_frac": float(_held_mask(sv.index).float().mean()),
        "precision": precision,
        "store_bytes_per_item": rep["store"]["store_bytes_per_item"],
        "rerank_survivor_frac": rep["store"]["rerank_survivor_frac"],
        "n_segments": rep["occupancy"]["n_segments"],
        "n_live": rep["occupancy"]["n_live"],
        "compactions": compactions,
        "bucket_overflow_frac": rep["occupancy"]["bucket_overflow_frac"],
        "unique_shapes": rep["batcher"]["unique_shapes"],
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
        "launches": dict(dispatch.launches),
    }
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n-items", type=int, default=0,
                    help="items to insert before the loop")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--insert-batch", type=int, default=64)
    ap.add_argument("--query-batch", type=int, default=8)
    ap.add_argument("--queries-per-step", type=int, default=4)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--n-probes", type=int, default=4)
    ap.add_argument("--n-dims", type=int, default=64)
    ap.add_argument("--delete-frac", type=float, default=0.05)
    ap.add_argument("--compact-at", type=float, default=0.3,
                    help="compact the tenant when its tombstone share "
                         "exceeds this")
    ap.add_argument("--segment-capacity", type=int, default=1024)
    ap.add_argument("--recall-probe-size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", default="fp32",
                    choices=dispatch.STORE_DTYPES,
                    help="sealed-segment storage tier: fp32 is exact, "
                         "bf16/int8 are bounded-loss with an exact fp32 "
                         "survivor rerank")
    args = ap.parse_args(argv)
    report = run(device=args.device, n_items=args.n_items, steps=args.steps,
                 insert_batch=args.insert_batch,
                 query_batch=args.query_batch,
                 queries_per_step=args.queries_per_step, k=args.k,
                 n_probes=args.n_probes, delete_frac=args.delete_frac,
                 compact_at=args.compact_at,
                 n_dims=args.n_dims, segment_capacity=args.segment_capacity,
                 recall_probe_size=args.recall_probe_size, seed=args.seed,
                 precision=args.precision)
    print("[serve] report:", json.dumps(report))
    print("[serve] OK")
    return report


if __name__ == "__main__":
    main()
