"""The paper's cell at pod scale, run on the card: k-NN over the
independent-family pod index against the exact brute-force baseline.

The port of ``repro/launch/lsh_cell.py`` with its constants and index
config: 16,777,216 function embeddings (N 64, the paper's dimension) split
over the ``data`` axis, 16 tables a model shard, 4,096 queries, k 10, 4
probes.  The JAX cell compiles for 512 forced host devices and reads a
roofline off the compiled HLO; this one builds the pod index on a ``(D,
M)`` mesh of ranks on one card, queries it and runs brute force, and holds
each phase's card time against the H100's bound (``launch/roofline.py``).

Items are the l2-basis tenant's functions (``launch.serve.sample_fvals``:
three random sines at the tenant's 64 nodes, from ``--seed``) embedded by
the basis embedder (K4), 131,072 rows at a time so the host never holds
the whole float64 draw; the queries are 4,096 more from the same seed.  Three phases, each timed with CUDA events after a warm-up:

* ``lsh_build``: ``build_distributed`` (K1 over every rank's block, the
  bucket sort, the tables);
* ``lsh_query``: ``query_distributed`` (K1, K2 a rank, two K3 to fan in);
* ``brute_force_query``: ``brute_force_distributed`` (K2 over item chunks,
  K3).

Each entry holds the card and host milliseconds, the bytes and operations
this run's data needs, the bound, the peak of ``torch.cuda.
max_memory_allocated`` in the phase, the kernel launches of one call
(``dispatch.launches``, and the profiler's count of every card kernel),
recall@10 of the LSH query against brute force and the held share (items
in at least one table).  The default mesh is 16 x 2: one rank does what
one chip of the pod's 16 x 16 does, every item is kept, and both axes are
there; 16 x 16 would need ~193 GiB of tables.

    python -m repro_torch.launch.lsh_cell [--dtype f32|bf16] [--mesh D,M]
        [--device cuda|cpu] [--n-items N] [--queries Q] [--out PATH]

Writes the entries, keyed ``single/{phase}_{dtype}_L{tables}``, into
``--out`` (default ``experiments/lsh_cell.json``), merged with what is
there.  Tests run a toy shape on the CPU (``--device cpu`` and small
``--n-items``, ``--queries`` and ``--tables-per-shard``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from ..core import distributed, index as lidx
from ..embedders import make_embedder
from ..kernels import dispatch
from . import profiled, roofline
from .mesh import make_pod_mesh
from .serve import default_spec, sample_fvals

N_ITEMS = 1 << 24          # 16.7M embeddings
N_DIMS = 64                # the paper's N
N_QUERIES = 4096
K = 10
N_PROBES = 4
MESH = (16, 2)
EMBED_CHUNK = 1 << 17      # rows drawn and embedded at a time
DRAW_THREADS = 8           # host threads drawing the chunks
WARM_BF_QUERIES = 64       # brute force's warm-up rows


def cell_config(tables_per_shard: int = 16) -> lidx.IndexConfig:
    """The JAX cell's index config (``repro/launch/lsh_cell.py``)."""
    return lidx.IndexConfig(n_dims=N_DIMS, n_tables=tables_per_shard,
                            n_hashes=4, log2_buckets=16, bucket_capacity=128,
                            r=0.5)


def _draws(seed: int, n_items: int, n_queries: int, nodes: np.ndarray):
    """The cell's function samples, in order: ``sample_fvals`` over chunks
    of ``EMBED_CHUNK`` items, then the queries.  Chunk i draws from the
    i-th child of ``SeedSequence(seed)`` and the queries from the next one,
    so the chunks are computed on a few threads (numpy's sines release
    the interpreter lock) and the data depends on the seed alone."""
    sizes = [min(EMBED_CHUNK, n_items - s)
             for s in range(0, n_items, EMBED_CHUNK)] + [n_queries]
    seqs = np.random.SeedSequence(seed).spawn(len(sizes))
    draw = lambda i: sample_fvals(np.random.default_rng(seqs[i]), nodes,  # noqa: E731
                                  sizes[i])
    workers = max(1, min(DRAW_THREADS, os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        ahead = [pool.submit(draw, i) for i in range(min(2 * workers,
                                                         len(sizes)))]
        for i in range(len(sizes)):
            if i + len(ahead) < len(sizes):
                ahead.append(pool.submit(draw, i + len(ahead)))
            yield ahead.pop(0).result()


def make_inputs(n_items: int, n_queries: int, seed: int, dev: torch.device,
                dtype: torch.dtype):
    """(items (n_items, N) of ``dtype`` on ``dev``, queries (n_queries, N)
    f32 on ``dev``, rounded through ``dtype`` as the JAX cell feeds them):
    l2-basis functions (:func:`_draws`) embedded by K4 a chunk at a
    time."""
    spec = default_spec(n_dims=N_DIMS)
    emb = make_embedder(spec.embedder, n_dims=spec.n_dims, p=spec.p,
                        volume=spec.volume, params=spec.embedder_params,
                        device=dev)
    items = torch.empty((n_items, N_DIMS), dtype=dtype, device=dev)
    start, queries = 0, None
    for fvals in _draws(seed, n_items, n_queries, emb.nodes()):
        if start < n_items:
            items[start:start + fvals.shape[0]] = emb.embed(fvals)
            start += fvals.shape[0]
        else:
            queries = emb.embed(fvals)
    return items, queries.to(dtype).float().contiguous()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn: Callable, dev: torch.device) -> tuple:
    """(fn's result, {card_ms: between CUDA events, None on the CPU;
    host_ms; peak_bytes: ``max_memory_allocated`` in the call, None on the
    CPU; launches: the port's kernel launches in the call})."""
    cuda = dev.type == "cuda"
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    before = dict(dispatch.launches)
    t0 = time.perf_counter()
    if cuda:
        a.record()
    out = fn()
    if cuda:
        b.record()
    _sync(dev)
    rec = {"card_ms": a.elapsed_time(b) if cuda else None,
           "host_ms": (time.perf_counter() - t0) * 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
           else None,
           "launches": {k: v - before[k] for k, v in dispatch.launches.items()
                        if v > before[k]}}
    return out, rec


def held_share(pod) -> float:
    """Items held in at least one table of any rank of their data block."""
    held = 0
    for row in pod:
        seen = torch.zeros(row[0].db.shape[0], dtype=torch.bool,
                           device=row[0].db.device)
        for state in row:
            for table in state.table:          # one table at a time
                t = table.reshape(-1)
                seen[t[t >= 0].long().to(seen.device)] = True
        held += int(seen.sum())
    return held / sum(row[0].db.shape[0] for row in pod)


def query_work(pod, cfg, q: torch.Tensor, n_probes: int) -> dict:
    """What the LSH query reads and computes on this run's data, over every
    rank: the distinct (table, bucket) pairs it probes, the candidate slots
    it scores after the dedup, and the distinct rows they name."""
    work = {"buckets": 0, "candidates": 0, "rows": 0}
    for row in pod:
        for st in row:
            qq = q.to(st.db.device)
            h, pj = lidx.hash_stage(st.alpha, st.b, cfg, qq)
            bk = lidx.probe_stage(st.mix, cfg, h, pj, n_probes)
            tables = torch.arange(cfg.n_tables, device=bk.device)[:, None]
            flat = (tables * cfg.n_buckets + bk.transpose(0, 1).reshape(
                cfg.n_tables, -1)).reshape(-1)
            work["buckets"] += int(torch.unique(flat).numel())
            c = lidx.gather_stage(st.table, bk, cfg, st.db.shape[0])
            c = c[c >= 0]
            work["candidates"] += int(c.numel())
            work["rows"] += int(torch.unique(c).numel())
    return work


def run(n_items: int = N_ITEMS, n_queries: int = N_QUERIES,
        mesh_shape=MESH, device=None, seed: int = 0, dtype: str = "f32",
        tables_per_shard: int = 16, log: Callable = print,
        on_built: Optional[Callable] = None) -> dict:
    """The cell; returns ``{"{phase}_{dtype}_L{L}": entry}`` and, under
    ``"cell"``, what the run was, with ``launches``: the kernel launches
    of the embed and the three timed calls (warm-ups, the profiled query
    and the query's work count left out).  ``on_built(pod, cfg, queries,
    items)``, if given, sees the built pod and the data after the phases
    (to time a kernel at the cell's shapes, say)."""
    dev = dispatch.resolve_device(device)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    mesh = make_pod_mesh(mesh_shape, dev)
    d, m = mesh_shape
    cfg = cell_config(tables_per_shard)
    L, B, S = cfg.n_tables, cfg.n_buckets, cfg.bucket_capacity
    n_local = n_items // d
    if n_items % d:
        raise ValueError(f"{n_items} items do not split over {d} data ranks")
    (items, queries), setup = timed(
        lambda: make_inputs(n_items, n_queries, seed, dev, tdt), dev)
    setup_s = setup["host_ms"] / 1e3
    log(f"[lsh_cell] {n_items} items x {N_DIMS} {dtype} and {n_queries} "
        f"queries on {dev} in {setup_s:.1f}s; mesh {d} x {m}, L {L} a "
        f"rank, B {B}, S {S}")
    isz = items.element_size()

    # lsh_build: warm up on one rank's block, then the whole pod
    warm = distributed.build_distributed(
        cfg, items[:n_local], make_pod_mesh((1, 1), dev), seed=seed)
    del warm
    pod, build = timed(
        lambda: distributed.build_distributed(cfg, items, mesh, seed=seed),
        dev)
    build.update(bytes=(m * n_items * N_DIMS * isz      # K1 reads, a shard
                        + d * m * L * B * (S + 1) * 4    # tables and counts
                        + n_items * N_DIMS * 4),         # db, a data block
                 ops=2 * m * n_items * N_DIMS * L * cfg.n_hashes)
    held = held_share(pod)

    # lsh_query: one call to warm up, one timed, one profiled
    run_q = lambda: distributed.query_distributed(pod, cfg, queries, K,  # noqa: E731
                                                  n_probes=N_PROBES)
    run_q()
    (l_ids, _), query = timed(run_q, dev)
    query["card_kernels"] = (profiled.card_kernels(run_q, dev)
                             if dev.type == "cuda" else None)
    work = query_work(pod, cfg, queries, N_PROBES)
    query.update(bytes=(4 * S * work["buckets"] + 4 * N_DIMS * work["rows"]
                        + 4 * N_DIMS * n_queries + 8 * K * n_queries),
                 ops=(2 * d * m * n_queries * N_DIMS * L * cfg.n_hashes
                      + 3 * N_DIMS * work["candidates"]))

    # brute_force_query: warm up on a few rows, then all
    distributed.brute_force_distributed(items, queries[:WARM_BF_QUERIES], K,
                                        mesh)
    (e_ids, e_d), brute = timed(
        lambda: distributed.brute_force_distributed(items, queries, K, mesh),
        dev)
    brute.update(bytes=(n_items * N_DIMS * isz + n_queries * N_DIMS * 4
                        + n_queries * K * 8),
                 ops=3 * n_queries * n_items * N_DIMS)   # sub, square, add

    if on_built is not None:
        on_built(pod, cfg, queries, items)
    recall = float(lidx.recall_at_k(l_ids.cpu(), e_ids.cpu()))
    cell = {"n_items": n_items, "n_queries": n_queries, "k": K,
            "n_probes": N_PROBES, "mesh": [d, m], "n_local": n_local,
            "tables_per_rank": L, "tables_an_item_sees": L * m,
            "n_buckets": B, "bucket_capacity": S, "r": cfg.r, "dtype": dtype,
            "device": str(dev), "card": (torch.cuda.get_device_name(dev)
                                         if dev.type == "cuda" else None),
            "seed": seed, "setup_s": setup_s, "recall_at_10": recall,
            "held_share": held, "query_work": work,
            "launches": {k: sum(e["launches"].get(k, 0) for e in (
                setup, build, query, brute)) for k in dispatch.KERNELS},
            "brute_force_finite": bool(torch.isfinite(e_d).all())
            and bool((e_ids >= 0).all())}
    out = {}
    for name, e in (("lsh_build", build), ("lsh_query", query),
                    ("brute_force_query", brute)):
        bs, by = roofline.bound_by(e["bytes"], e["ops"])
        e.update(bound_ms=bs * 1e3, bound_by=by, recall_at_10=recall,
                 held_share=held, mesh=[d, m])
        out[f"{name}_{dtype}_L{L}"] = e
        card = e["card_ms"]
        log(f"[lsh_cell] {name} [{dtype}]: card "
            f"{'not measured' if card is None else f'{card:.3f} ms'}, host "
            f"{e['host_ms']:.3f} ms, bound {e['bound_ms']:.3f} ms ({by}), "
            f"peak {e['peak_bytes']}, launches {e['launches']}")
    log(f"[lsh_cell] recall@{K} {recall:.4f}, held share {held:.4f}, "
        f"query work {work}")
    out["cell"] = cell
    return out


def main(argv=None, on_built: Optional[Callable] = None) -> dict:
    """The command line; returns :func:`run`'s entries and ``"cell"``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--tables-per-shard", type=int, default=16)
    ap.add_argument("--out", default="experiments/lsh_cell.json")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=",".join(map(str, MESH)),
                    help="D,M: data and model ranks (default 16,2)")
    ap.add_argument("--n-items", type=int, default=N_ITEMS)
    ap.add_argument("--queries", type=int, default=N_QUERIES)
    args = ap.parse_args(argv)
    shape = tuple(int(v) for v in args.mesh.split(","))
    if len(shape) != 2:
        raise SystemExit(f"--mesh wants D,M, got {args.mesh!r}")
    res = run(args.n_items, args.queries, shape, args.device, args.seed,
              args.dtype, args.tables_per_shard, on_built=on_built)
    cell = res.pop("cell")
    merged = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            merged = json.load(f)
    merged.update({f"single/{k}": dict(v, cell=cell) for k, v in res.items()})
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(merged, f, indent=1)
    print(f"-> {args.out}")
    res["cell"] = cell
    return res


if __name__ == "__main__":
    main()
