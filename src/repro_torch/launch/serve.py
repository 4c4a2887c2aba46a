"""Streaming serve demo on the card: the JAX demo's three tenants.

    python -m repro_torch.launch.serve                       # on the card
    python -m repro_torch.launch.serve --n-items 262144 --steps 20
    python -m repro_torch.launch.serve --device cpu --n-items 2048 --steps 4
    python -m repro_torch.launch.serve --tenants l1-qmc,w2-quantile
    python -m repro_torch.launch.serve --precision int8      # int8 tier
    python -m repro_torch.launch.serve --device cpu --n-items 0 --steps 40 \
        --delete-frac 0.9 --compact-at 0.3                  # compacts
    python -m repro_torch.launch.serve --device cpu --wal-dir W --snapshot S
    python -m repro_torch.launch.serve --device cpu --wal-dir W --restore S
    python -m repro_torch.launch.serve --device cpu --standby W  # SIGTERM
    python -m repro_torch.launch.serve --device cpu --metrics-dir M \
        --trace-sample 1.0 --trace-deep                     # telemetry
    python -m repro_torch.launch.serve --listen 127.0.0.1:0 # network server
    python -m repro_torch.launch.serve --shard 8 --replicate static:2
    python -m repro_torch.launch.serve --device cpu --shard 4 \
        --replicate static:2 --n-items 4096 --steps 4        # 4 CPU ranks

The port of the scripted demo loop of ``repro/launch/serve.py``.  It
serves the JAX demo's tenants (``default_specs``): ``l2-basis`` (p = 2,
the Chebyshev-basis embedding, Eq. 3), ``l1-qmc`` (p = 1, Sobol node
sampling, Eq. 6) and ``w2-quantile`` (W^2 over 1-D distributions by their
clipped quantile functions, Remark 1); ``--tenants`` picks some of them.
It first fills each tenant with ``--n-items`` items (embed + insert):
random smooth functions at the tenant's nodes, or for the Wasserstein
tenant 256 raw draws from a random Gaussian.  Then it runs ``--steps``
ticks; in each, every tenant in name order embeds and inserts a batch,
submits several small query requests (perturbations of fresh items)
through its micro-batcher, tombstones a slice of its oldest items, and
compacts (``servable.maintenance.compact()``) once its tombstone share
exceeds ``--compact-at``.  It ends with a report per tenant: ingest rate,
QPS and latency percentiles, recall@k against exact brute force on a probe
set, the self-hit rate of stored items queried exactly, segment
occupancy, compactions, the sealed store's bytes per item, and, for the
run as a whole, device memory and the kernels' launch counts.
``--precision`` stores the sealed segments as bf16 or int8 codes.

Each tenant draws its data from its own generator, seeded ``seed + i``
with i its place in ``TENANTS`` (the JAX demo shares one), so a tenant
holds the same items whichever other tenants are served.  The defaults
keep the JAX demo's shapes.

Durability, with the JAX launcher's meanings: ``--wal-dir DIR`` logs every
tenant's mutations to ``DIR/<name>.wal`` (group commit every
``--fsync-every`` records); ``--snapshot DIR`` checkpoints every tenant at
the end; ``--restore DIR`` starts from a snapshot, and with ``--wal-dir``
too goes through ``ServableRegistry.recover`` (the newest verifiable
snapshot plus the WAL tail) and prints each tenant's recovery report; a
restored tenant is served as it was restored.  ``--standby WAL_DIR`` runs
a warm standby instead: it tails a primary's WAL directory until SIGTERM
(or SIGINT), then promotes and prints the failover report.  Logs and
snapshots are the JAX package's format.

Sharding, with the JAX launcher's meanings: ``--shard N`` serves every
tenant over a serve mesh of N ranks (``launch.mesh.make_serve_mesh``: one
process drives them all; the ranks follow ``--device``, so on one card all
N share it and on the CPU all are ``cpu``), a restored or recovered tenant
included, and ``--replicate none|static:k|auto`` is the tenants'
hot-segment replication (``auto`` re-places from the live
``shard_balance`` at each compaction).  Each tenant's report line then
gives ``shards=NxP replicas=I/S`` (ranks x instances a rank, instances /
sealed segments) and its ``shard_balance``.

Telemetry, with the JAX launcher's meanings: ``--metrics-dir DIR``
exports the metrics registry and the drained trace spans every loop step
and at the end, to ``DIR/metrics.jsonl`` (JSON lines, appended) and
``DIR/metrics.prom`` (Prometheus text, rewritten), which
``tools/check_metrics_export.py DIR`` validates against the catalog;
``--trace-sample`` is the share of query traces sampled (default
``$REPRO_TRACE_SAMPLE`` or 0: off) and ``--trace-deep`` runs sampled fp32
queries through the staged engine, a span and a device sync per stage.

``--listen HOST:PORT`` serves live traffic instead of the demo loop, with
the JAX launcher's knobs: the ``--tenants`` are registered from
``default_specs`` (or restored, or recovered, as above), with no fill and
no loop, and handed to the network front-end (``serve/frontend.py``):
per-tenant admission control (``--max-inflight``, ``--queue-depth``),
wall-clock micro-batch deadlines (``--max-delay-ms``), the ``maintenance``
verb's ``--maint-workers`` background threads, and a graceful drain on
SIGTERM or SIGINT (``--drain-timeout``, per tenant
``--tenant-drain-timeout NAME=SECS``).  It prints ``[frontend] listening
on H:P`` once bound (port 0 picks a free one) and the drain line on the
way out, then exits 0; ``--metrics-dir`` exports the front end's series
every half second and at the end.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading
import time

import numpy as np
import torch

from ..kernels import dispatch
from ..obs import Exporter, configure as obs_configure
from ..serve import ServableRegistry, ServableSpec, recall_proxy, run_server
from .mesh import make_serve_mesh

TENANTS = ("l2-basis", "l1-qmc", "w2-quantile")
W2_DRAWS = 256          # raw draws per distribution the W^2 tenant ingests


def default_specs(n_dims: int = 64, segment_capacity: int = 1024,
                  max_delay_ms: float = 2.0, precision: str = "fp32",
                  shard_axis=None, replicate: str = "none") -> tuple:
    """The demo's three tenants (JAX ``launch/serve.py:66-87``) at a
    storage tier, sharded over ``shard_axis`` (None: not) with the
    ``replicate`` policy, in :data:`TENANTS` order."""
    common = dict(n_dims=n_dims, segment_capacity=segment_capacity,
                  chunk_sizes=(8, 32, 128), max_delay_ms=max_delay_ms,
                  precision=precision, shard_axis=shard_axis,
                  replication=replicate)
    return (ServableSpec(name="l2-basis", p=2.0, r=4.0, embedder="basis",
                         **common),
            ServableSpec(name="l1-qmc", p=1.0, r=8.0, embedder="qmc",
                         **common),
            ServableSpec(name="w2-quantile", p=2.0, r=0.5,
                         embedder="wasserstein", **common))


def default_spec(n_dims: int = 64, segment_capacity: int = 1024,
                 max_delay_ms: float = 2.0, precision: str = "fp32"
                 ) -> ServableSpec:
    """The demo's l2-basis tenant (JAX ``launch/serve.py:81``)."""
    return default_specs(n_dims, segment_capacity, max_delay_ms,
                         precision)[0]


def sample_fvals(rng: np.random.Generator, nodes: np.ndarray, n: int
                 ) -> np.ndarray:
    """n random smooth functions (sums of three random sines) at ``nodes``."""
    amps = rng.normal(size=(n, 3)) / 3.0
    freqs = rng.uniform(0.5, 4.0, size=(n, 3))
    phase = rng.uniform(0, 2 * np.pi, size=(n, 3))
    return np.sum(amps[:, :, None] *
                  np.sin(freqs[:, :, None] * nodes[None, None, :]
                         + phase[:, :, None]), axis=1).astype(np.float32)


def sample_gaussian_draws(rng: np.random.Generator, n: int,
                          draws: int = W2_DRAWS):
    """n random 1-D Gaussians, mu ~ U[-1, 1] and sigma ~ U[0.1, 1], and
    ``draws`` raw samples of each: (samples (n, draws) f64, mu (n,),
    sigma (n,))."""
    mu = rng.uniform(-1.0, 1.0, size=(n, 1))
    sig = rng.uniform(0.1, 1.0, size=(n, 1))
    return mu + sig * rng.normal(size=(n, draws)), mu[:, 0], sig[:, 0]


def sample_inputs(sv, rng: np.random.Generator, n: int):
    """A tenant's synthetic ingest (JAX ``launch/serve.py:292-311``): raw
    Gaussian draws for the Wasserstein tenant, three-sine functions at the
    tenant's nodes otherwise.  Returns (inputs for ``sv.embed``, (mu,
    sigma) of the Gaussians or None)."""
    if sv.spec.embedder == "wasserstein":
        x, mu, sig = sample_gaussian_draws(rng, n)
        return x, (mu, sig)
    return sample_fvals(rng, sv.nodes(), n), None


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


def run(*, device=None, tenants=None, n_items: int = 0, steps: int = 20,
        insert_batch: int = 64, query_batch: int = 8,
        queries_per_step: int = 4, k: int = 10, n_probes: int = 4,
        delete_frac: float = 0.05, compact_at: float = 0.3, n_dims: int = 64,
        segment_capacity: int = 1024, recall_probe_size: int = 64,
        self_hit_probes: int = 64, fill_batch: int = 8192, seed: int = 0,
        precision: str = "fp32", max_delay_ms: float = 2.0, registry=None,
        replicate: str = "none", on_insert=None, exporter=None,
        log=print) -> dict:
    """Fill, run the demo loop, and return the report: one entry per
    tenant, by name, as ``registry.report()`` gives.  ``tenants`` names
    some of :data:`TENANTS` (None: all three).  The tenants are registered
    in ``registry`` (a fresh one on ``device`` by default), so a caller
    that passes its own can keep querying them afterwards.
    ``on_insert(name, gids, params)``, when given, sees every insert: the
    gids and, for the Wasserstein tenant, the Gaussians' (mu, sigma).
    ``exporter`` (an ``obs.Exporter``), when given, is flushed after every
    loop step.  A registry with a serve mesh shards the tenants it
    registers here over it, with the ``replicate`` policy."""
    names = TENANTS if tenants is None else tuple(tenants)
    unknown = sorted(set(names) - set(TENANTS))
    if unknown:
        raise ValueError(f"unknown tenants {unknown}; have {TENANTS}")
    registry = registry or ServableRegistry(device=device)
    dev = registry.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    specs = {sp.name: sp for sp in default_specs(
        n_dims, segment_capacity, max_delay_ms=max_delay_ms,
        precision=precision,
        shard_axis=None if registry.mesh is None else "serve",
        replicate=replicate)}
    svs, rngs = {}, {}
    for name in sorted(names):
        # a tenant the registry already holds (restored) is served as is
        svs[name] = (registry.get(name) if name in registry.names()
                     else registry.register(specs[name]))
        rngs[name] = np.random.default_rng(seed + TENANTS.index(name))
    inserted = {name: [] for name in svs}
    compactions = {name: 0 for name in svs}
    fill_s = {}

    def ingest(name, n):
        x, params = sample_inputs(svs[name], rngs[name], n)
        gids = svs[name].insert(svs[name].embed(x))
        inserted[name].extend(gids.tolist())
        if on_insert is not None:
            on_insert(name, gids, params)

    for name, sv in svs.items():
        t0 = time.perf_counter()
        for start in range(0, n_items, fill_batch):
            ingest(name, min(fill_batch, n_items - start))
        _sync(dev)
        fill_s[name] = time.perf_counter() - t0
        log(f"[serve] {name}: filled {n_items} items in "
            f"{fill_s[name]:.3f}s ({len(sv.index.segments)} segments)")

    futures = {name: [] for name in svs}
    t0 = time.perf_counter()
    for step in range(steps):
        for name, sv in svs.items():
            rng = rngs[name]
            ingest(name, insert_batch)
            for _ in range(queries_per_step):
                base = sv.embed(sample_inputs(sv, rng, query_batch)[0]).cpu()
                qs = base.numpy() + rng.normal(
                    scale=0.05, size=tuple(base.shape)).astype(np.float32)
                futures[name].append(sv.submit_query(qs, k, n_probes))
            sv.batcher.pump()
            n_del = int(delete_frac * insert_batch)
            if n_del and len(inserted[name]) > 4 * n_del:
                victims = inserted[name][:n_del]
                inserted[name] = inserted[name][n_del:]
                sv.delete(victims)
            # the tombstone share from the index's host counters (a device
            # reduction per segment would cost a sync each)
            n_all = sv.index.n_items
            if n_all and (n_all - sv.index.n_live) / n_all > compact_at:
                sv.maintenance.compact()
                compactions[name] += 1
        if exporter is not None:
            exporter.flush()
    for sv in svs.values():
        sv.batcher.flush_all()
    _sync(dev)
    loop_s = time.perf_counter() - t0
    n_rows = {}
    for name, futs in futures.items():
        for f in futs:
            f.result()             # a failed batch raises here
        n_rows[name] = sum(f.result()[0].shape[0] for f in futs)
    log(f"[serve] {steps} steps in {loop_s:.3f}s: "
        + ", ".join(f"{name} {len(futures[name])} requests, {n_rows[name]} "
                    "query rows answered" for name in svs))

    report = {}
    for name, sv in svs.items():
        probe = sv.embed(sample_inputs(sv, rngs[name],
                                       recall_probe_size)[0])
        recall = recall_proxy(sv.index, probe, k, n_probes=n_probes)
        sv.stats.record_recall(recall)
        # Stored items queried exactly must come back first, at distance
        # 0: build and query hash through one implementation.
        self_hit = self_hit_rate(sv, k, n_probes, self_hit_probes)
        rep = sv.report()
        stats = rep["stats"]
        report[name] = {
            "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "embedder": sv.spec.embedder,
            "p": sv.spec.p,
            "r": sv.spec.r,
            "n_items_filled": n_items,
            "fill_s": fill_s[name],
            "ingest_rows_per_s": (n_items / fill_s[name]
                                  if fill_s[name] > 0 else 0.0),
            "steps": steps,
            "loop_s": loop_s,
            "requests": len(futures[name]),
            "query_rows": n_rows[name],
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
            "compactions": compactions[name],
            "bucket_overflow_frac": rep["occupancy"]["bucket_overflow_frac"],
            "unique_shapes": rep["batcher"]["unique_shapes"],
            "shard_layout": rep["shard_layout"],
            "shard_balance": stats["shard_balance"],
            # the run's, over every tenant
            "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None),
            "launches": dict(dispatch.launches),
        }
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--tenants", default=",".join(TENANTS),
                    help="comma-separated tenants to serve, of "
                         f"{', '.join(TENANTS)} (default: all)")
    ap.add_argument("--n-items", type=int, default=0,
                    help="items to insert into each tenant before the loop")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--insert-batch", type=int, default=64)
    ap.add_argument("--query-batch", type=int, default=8)
    ap.add_argument("--queries-per-step", type=int, default=4)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--n-probes", type=int, default=4)
    ap.add_argument("--n-dims", type=int, default=64)
    ap.add_argument("--delete-frac", type=float, default=0.05)
    ap.add_argument("--compact-at", type=float, default=0.3,
                    help="compact a tenant when its tombstone share "
                         "exceeds this")
    ap.add_argument("--segment-capacity", type=int, default=1024)
    ap.add_argument("--recall-probe-size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", default="fp32",
                    choices=dispatch.STORE_DTYPES,
                    help="sealed-segment storage tier: fp32 is exact, "
                         "bf16/int8 are bounded-loss with an exact fp32 "
                         "survivor rerank ($REPRO_STORE_DTYPE wins)")
    ap.add_argument("--snapshot", default=None,
                    help="checkpoint every tenant here at the end")
    ap.add_argument("--restore", default=None,
                    help="start from the snapshot here")
    ap.add_argument("--wal-dir", default=None,
                    help="log every tenant's mutations under this dir "
                         "(with --restore: crash recovery, snapshot + WAL "
                         "tail)")
    ap.add_argument("--fsync-every", type=int, default=None,
                    help="WAL group-commit interval in records (1: every "
                         "record, 0: only at snapshots; default "
                         "$REPRO_WAL_FSYNC_EVERY or 8)")
    ap.add_argument("--standby", default=None, metavar="WAL_DIR",
                    help="run as a warm standby: tail this WAL directory, "
                         "promote on SIGTERM and print the failover report")
    ap.add_argument("--metrics-dir", default=None,
                    help="export telemetry here every loop step: "
                         "metrics.jsonl (metric snapshots and trace spans, "
                         "JSON lines) and metrics.prom (Prometheus text)")
    ap.add_argument("--trace-sample", type=float, default=None,
                    help="share of query traces to sample (default "
                         "$REPRO_TRACE_SAMPLE or 0: tracing off)")
    ap.add_argument("--trace-deep", action="store_true",
                    help="run sampled fp32 queries through the staged "
                         "engine, a span per stage (default "
                         "$REPRO_TRACE_DEEP)")
    ap.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="micro-batcher flush deadline per tenant")
    ap.add_argument("--shard", type=int, default=0,
                    help="serve every tenant over a mesh of this many "
                         "ranks on --device (0: unsharded)")
    ap.add_argument("--replicate", default="none",
                    help="hot-segment replication of sharded tenants: "
                         "none | static:k | auto (re-placed from the live "
                         "shard_balance at each compaction)")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="serve live traffic instead of the demo loop: "
                         "bind the network front-end here (port 0 picks a "
                         "free port, printed as '[frontend] listening on "
                         "H:P'), run until SIGTERM, then drain")
    ap.add_argument("--max-inflight", type=int, default=64,
                    help="per-tenant admitted-but-unanswered request quota")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="per-tenant batcher queue-depth cap sampled at "
                         "admission (beyond it: queue_full + "
                         "retry_after_ms)")
    ap.add_argument("--drain-timeout", type=float, default=10.0,
                    help="graceful-drain backstop on SIGTERM and unload "
                         "(seconds)")
    ap.add_argument("--tenant-drain-timeout", action="append", default=[],
                    metavar="NAME=SECS",
                    help="per-tenant drain budget (repeatable); tenants "
                         "not named keep --drain-timeout")
    ap.add_argument("--maint-workers", type=int, default=None,
                    help="background threads of the 'maintenance' verb "
                         "(default $REPRO_MAINT_WORKERS or 1)")
    args = ap.parse_args(argv)
    if args.trace_sample is not None or args.trace_deep:
        obs_configure(sample_rate=args.trace_sample,
                      deep=True if args.trace_deep else None)
    mesh = (make_serve_mesh(args.shard, device=args.device) if args.shard
            else None)
    if args.standby:
        return standby(args.standby, device=args.device,
                       fsync_every=args.fsync_every, mesh=mesh)
    exporter = (Exporter.for_directory(args.metrics_dir)
                if args.metrics_dir else None)
    registry = ServableRegistry(device=args.device, mesh=mesh,
                                wal_dir=args.wal_dir,
                                fsync_every=args.fsync_every)
    if mesh is not None:
        print(f"[serve] serve mesh: {mesh.describe()}")
    if args.restore and args.wal_dir:
        reports = registry.recover(ckpt_root=args.restore,
                                   wal_dir=args.wal_dir)
        for name, rep in sorted(reports.items()):
            print(f"[serve] recovered {name}: "
                  f"step={rep.get('restored_step')} "
                  f"replayed={rep.get('applied', 0)} "
                  f"dup_dropped={rep.get('dropped_duplicates', 0)} "
                  f"truncated={rep.get('truncated', False)}")
    elif args.restore:
        print(f"[serve] restored tenants {registry.restore(args.restore)} "
              f"from {args.restore}")
    if args.restore and mesh is not None:
        # the command line's mesh wins over the snapshot's: a tenant
        # snapshotted unsharded (or on another mesh) serves on this one
        for name in registry.names():
            registry.get(name).index.shard(mesh, "serve")
    if args.listen:
        return listen(args, registry, exporter)
    report = run(registry=registry,
                 tenants=[t for t in args.tenants.split(",") if t],
                 n_items=args.n_items, steps=args.steps,
                 insert_batch=args.insert_batch,
                 query_batch=args.query_batch,
                 queries_per_step=args.queries_per_step, k=args.k,
                 n_probes=args.n_probes, delete_frac=args.delete_frac,
                 compact_at=args.compact_at,
                 n_dims=args.n_dims, segment_capacity=args.segment_capacity,
                 recall_probe_size=args.recall_probe_size, seed=args.seed,
                 precision=args.precision, max_delay_ms=args.max_delay_ms,
                 replicate=args.replicate, exporter=exporter)
    if args.snapshot:
        registry.snapshot(args.snapshot, step=args.steps)
        print(f"[serve] snapshot -> {args.snapshot}")
    if exporter is not None:
        # the last snapshot holds the final recall probes and the snapshot
        exporter.close()
        print(f"[serve] telemetry -> {args.metrics_dir}")
    for name in registry.names():
        wal = registry.get(name).index.wal
        if wal is not None:
            s = wal.stats()
            print(f"[serve] wal {name}: {s['offset']}B "
                  f"appends={s['appends']} fsyncs={s['syncs']}")
    for name, rep in report.items():
        lay, bal = rep["shard_layout"], rep["shard_balance"]
        shard_s = (f"shards={lay['n_dev']}x{lay['per_dev']} "
                   f"replicas={lay['n_instances']}/{lay['n_sealed']}"
                   if lay else "shards=off")
        print(f"[serve] {name}: live={rep['n_live']} "
              f"segments={rep['n_segments']} "
              f"compactions={rep['compactions']} {shard_s} "
              f"recall@{rep['k']}={rep['recall_at_k']:.3f} "
              f"self_hit={rep['self_hit_rate']:.3f} qps={rep['qps']} "
              f"p95={rep['p95_ms']}ms "
              f"shard_balance=" + json.dumps({
                  key: bal[key] for key in (
                      "device_imbalance", "device_load_imbalance",
                      "per_device_wins", "per_device_load")}))
    print("[serve] report:", json.dumps(report))
    print("[serve] OK")
    return report


def listen(args, registry, exporter) -> dict:
    """``--listen`` mode: register the ``--tenants`` (unless restored or
    recovered), serve them until SIGTERM, drain; returns the gate's
    totals."""
    if not args.restore:
        names = [t for t in args.tenants.split(",") if t]
        unknown = sorted(set(names) - set(TENANTS))
        if unknown:
            raise ValueError(f"unknown tenants {unknown}; have {TENANTS}")
        for spec in default_specs(
                args.n_dims, args.segment_capacity,
                max_delay_ms=args.max_delay_ms, precision=args.precision,
                shard_axis=None if registry.mesh is None else "serve",
                replicate=args.replicate):
            if spec.name in names:
                registry.register(spec)
        print(f"[serve] registered tenants {registry.names()}", flush=True)
    host, _, port = args.listen.rpartition(":")
    overrides = {}
    for item in args.tenant_drain_timeout:
        name, _, secs = item.partition("=")
        overrides[name] = float(secs)
    totals = run_server(registry, host or "127.0.0.1", int(port or 0),
                        max_inflight=args.max_inflight,
                        queue_depth=args.queue_depth,
                        drain_timeout_s=args.drain_timeout,
                        tenant_drain_timeouts=overrides or None,
                        maint_workers=args.maint_workers, exporter=exporter)
    if exporter is not None:
        exporter.close()
        print(f"[serve] telemetry -> {args.metrics_dir}")
    print("[serve] OK", flush=True)
    return totals


def standby(wal_dir: str, device=None, fsync_every=None, mesh=None
            ) -> dict:
    """Warm-standby mode: tail ``wal_dir`` until SIGTERM or SIGINT, then
    promote; returns the promotion reports.  With a ``mesh`` the replayed
    tenants whose spec names its axis are sharded over it."""
    from ..serve.standby import WalStandby
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    sb = WalStandby(wal_dir, device=device, mesh=mesh,
                    fsync_every=fsync_every)
    sb.start()
    print(f"[serve] standby tailing {wal_dir}", flush=True)
    stop.wait()
    reports = sb.promote()
    for name, rep in sorted(reports.items()):
        print(f"[serve] promoted {name}: applied={rep.get('applied', 0)} "
              f"offset={rep.get('end_offset', 0)} "
              f"truncated={rep.get('truncated', False)}")
    print(f"[serve] standby promoted: tenants {sb.registry.names()}")
    print("[serve] OK", flush=True)
    return reports


if __name__ == "__main__":
    main()
