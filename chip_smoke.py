#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and nvcc (``$CUDA_HOME`` or /usr/local/cuda).  Phases,
each of which raises on failure (the script then exits non-zero):

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every ``csrc/*.cu`` compiled by nvcc for sm_90a, in parallel,
   and beside them the launch floor (``tools/launch_floor.cu``);
3. kernel checks: each kernel against its plain PyTorch version on the
   card, at the main path's shapes and at edge shapes (K1 and K4 also on
   unaligned views, and bit for bit across batch sizes; K3's two routes
   bit for bit, the select route up to 41,280-pair rows and one row of
   100,000, on duplicate-heavy rows, on mixed +0.0 / -0.0 rows (signs
   kept) and through ``ops.merge_topk``; K1's saturating conversion on a
   1e12 alpha entry and on +-inf / NaN rows, bit-equal to the plain
   version; ALSH through K7 (``"sign"``, (512, 67) -> 1024 bits) and K1
   (``"l2"``); K1 through ``LazyPStableHash`` (p = 1.5, alpha grown from
   128 to 384 rows) and a p = 0.5 ``PStableHash``; K2 and K5 at the
   stacked launches' shapes, 258 segments x 32 and x 128 rows, at p = 2
   and p = 1, K5 with one scale per segment; ``ops.merge_topk_unique``
   (the sharded fan-in: two K3 launches) at 32 and 128 rows x 8 ranks x k
   10 and 40, bit for bit against its plain version, on rows holding
   replica copies, and equal to ``merge_topk`` on rows without;
   K6 at five widths and three metrics, aligned and not; K7 bit for bit
   against its fmaf chain at five shapes, aligned and not, and across
   batch sizes; the tie check over 8 seeds; query rows holding a NaN or
   an infinity at fp32 / bf16 / int8, stacked and fanned out: (-1, +inf)
   on the card as on the CPU, the other rows unchanged, no kernel given a
   NaN); ``query_index_batched`` at 5,000 rows in 1,024-row chunks on one
   1,024-item segment, bit-equal to one ``query_index`` call and equal to
   the plain path on the CPU under the parity contract;
4. parity: the l2-basis, l1-qmc and w2-quantile pipelines at 8,192 items
   on the CPU (plain versions) and on the card (kernels) with one
   injected family each, and l2-basis at the int8 tier (whose gids must
   be equal);
5. timings: each kernel, its plain version and a PyTorch library call,
   CUDA-event medians, with the bytes and operations for the bound, and
   the host time per call of the kernel's wrapper and of the library
   call, between CUDA events and on the host clock; K2 and K5 at one
   segment of both micro-batch shapes (32 and 128 rows) and at the stacked
   launches over 258 segments (8,256 and 33,024 rows), K1 at 32, 128
   and 256 rows, K3 at the fp32 and int8 fan-ins, at 1,032 int8 segments
   and at the survivor sort (with ``torch.topk`` on int64 keys beside the
   two-sort library call); K2 stacked at p = 1 on the l1-qmc tenant's
   candidates (8,256 rows); and the launch floor, an empty kernel called
   through K1's ctypes route and launched as K1 is;
6. main path: ``repro_torch.launch.serve`` filled to 262,144 items
   (256 sealed segments), then 20 demo steps; launch counts read around
   it; two profiled 32-row batches (kernels and launches per batch); the
   stacked query bit-equal to the per-segment fan-out at 32 and 128 rows;
7. int8 path: the same run with ``precision="int8"`` (phase 6's tenant
   still alive), profiled and held against the fan-out likewise, then
   both tenants answer the same 64 probes; and the simhash path:
   ``SimHash.__call__`` over every live item;
8. compaction, on phase 6's tenant and then phase 7's: 35% of the live
   gids deleted, the delta sealed, then a ``MaintenancePool`` worker
   compacts the index while the main thread streams 32-row batches, each
   of whose answers must equal, bit for bit, the answer before the job or
   the one after it; afterwards the index must hold only live items in
   ceil(n_live / 1024) segments, answer bit for bit as its per-segment
   fan-out and as an index filled with the same live items in gid order,
   and find its held items (self-hit >= 0.95); on the int8 tenant the
   kept items' survivor rows must be bit-exact, and both compacted tenants
   must still give int8 recall@10 vs fp32 >= 0.98 at <= 1/3 the bytes;
9. tenants, after phases 6-8's tenants are released: the JAX demo's
   l1-qmc (p = 1, Sobol nodes) and w2-quantile (W2 over 256 raw draws a
   distribution) tenants through ``repro_torch.launch.serve`` at 262,144
   items each and 20 steps at fp32, then l1-qmc at int8; for each, two
   profiled 32-row batches, the stacked query bit-equal to the fan-out,
   self-hit >= 0.95, the held share and recall@10; K4 launched 0 times;
   int8 l1-qmc vs fp32 recall@10 >= 0.98 at <= 1/3 the bytes; the W2
   oracle gate (``launch.w2_gate``, the bench's full config: best
   recall@10 against ``gaussian_w2`` >= 0.9); the big W2 tenant's
   recall@10 against ``gaussian_w2`` on 64 fresh Gaussians (reported);
   the Wasserstein embed's card and host time per 128-row chunk;
10. durability, after phase 9's tenants are released, at fp32 then int8:
   l2-basis with a WAL (``ServableRegistry(wal_dir=...)``) filled to
   262,144 items and snapshotted, then 20 steps of inserts and deletes
   with an explicit seal and a compaction, while a ``WalStandby`` tails
   the WAL; promoted, it must answer 64 probes bit-equal to the primary.
   The same workload runs in a child process on the card that a
   ``FaultPlan`` kills (SIGKILL) at ``wal.append`` (step 7's INSERT) and,
   in another child, at ``compact.swap``; a fresh child recovers each
   (``recover``: snapshot + WAL tail) and must answer bit-equal (gids and
   distance bits) to a fresh index fed the durable prefix in this
   process, and a second replay must drop duplicates and change no bit.
   It prints the snapshot's bytes and seconds, WAL bytes per inserted
   item, replay rows/s, the recovery's wall, and ingest rows/s with no
   WAL and at fsync_every 1, 8 and 0, and beside them the telemetry's
   counters, which must agree: ``wal_bytes_total`` and
   ``wal_appends_total`` with the WAL file's bytes and records, one
   ``ckpt_saves_total``, ``standby_replayed_records_total`` with the
   standby's polls, one promotion, and in each recovering child
   ``recovery_replayed_records_total`` with its tail records and one
   restore;
11. telemetry, on phase 6's fp32 tenant at 262,144 items (it runs right
   after phase 6, before phase 7): with ``obs.configure(sample_rate=1.0,
   deep=True)`` (restored after), 20 staged 32-row and 5 staged 128-row
   batches through the batcher, each bit-equal to ``_query_stacked`` on
   its rows; the median microseconds of the hash, probe, gather, rerank
   and merge spans and of the batch span; the stage spans must cover >=
   90% of their batch spans, summed over the 25 batches; then an
   ``Exporter`` flush whose every line must match the port's ``CATALOG``
   (name, type, label keys), with every required metric present but the
   multi-device ``serve_device_wins_total``.
12. front end, on phases 6-7's tenants after their compaction (it runs
   right after phase 8, before phase 9 releases them), fp32 then int8: a
   ``Frontend`` on an asyncio loop in a thread at 127.0.0.1:0; 16
   closed-loop ``FrontendClient`` connections of 64 requests of 8 rows (k
   10, 4 probes), every answer (gids and distance bits through the
   float64 wire) equal to ``_query_stacked`` on its rows, beside the same
   streams through ``submit_query`` with no sockets (request rate, rows/s,
   p50 / p95 / p99 on the client clock, rows per padded batch); NaN and
   +-inf rows answering (-1, +inf) as the direct call; the ``embed`` verb
   bit-equal to ``Servable.embed``; kernels per wire batch; a ``load``-ed
   l1-qmc tenant under another name fed 65,536 rows in 1,024-row frames
   (wire ingest rows/s), 35% deleted, sealed and compacted by the
   ``maintenance`` verb under 4 query streams (each answer equal to the one
   before or after the job), an unknown job id, ``unload`` (drained, then
   ``unknown_tenant``) and ``torch.cuda.memory_allocated`` back within 5%
   of its value before the ``load``; ``update`` of the palette and
   deadline (answers unchanged, the new palette in ``unique_shapes``; a
   malformed replication policy ``bad_request``, a replication update
   accepted with no answer moved); ``health`` and ``stats`` (the
   catalog equal to ``CATALOG``); a second ``Frontend`` with
   ``max_inflight=2, queue_depth=2`` under 32 connections (nonzero
   ``overloaded`` / ``queue_full`` rejects, each with ``retry_after_ms``,
   no dropped connection; the reject share); the export against the
   catalog with every ``frontend_*`` series the phase exercised.  Then,
   once, a child ``python -m repro_torch.launch.serve --listen
   127.0.0.1:0 --tenants l2-basis`` on the card (300 s timeout): 16,384
   rows inserted over the wire, 8 query streams, SIGTERM mid-traffic; it
   must exit 0 with ``settled == admitted`` and ``inflight=0``, each
   stream ending in one ``shutting_down``; the drain wall.  One
   ``frontend {...}`` line per tier and one for the drain.

13. sharded path, after every other phase's tenants are released: the
   slice's path through ``repro_torch.launch.serve.run`` on an 8-rank
   serve mesh over the one card (``make_serve_mesh(8)``), l2-basis at
   262,144 items then 20 steps, fp32 (``replicate="auto"``) then int8.
   Per tier: 64 probes as two 32-row batches and 128 as one, sharded
   unreplicated, at static:2 routed (three rounds) and at static:2 with
   every replica answering, gids and distance bits equal to the same index
   after ``unshard()``; ``shard_layout()`` n_dev 8, per_dev 33 / 65,
   n_instances 257 / 514; a profiled 32-row batch with K1 / K2+K5 / K3
   launches 1 / 9 / 10 (11 at int8: the survivor sort); p50 and rate of
   50 32-row batches sharded, then unsharded; the card bytes of each
   rank's block and at peak.  At fp32 also: one seal through the
   maintenance handle moves at most two segments' bytes
   (``placement_replaced_bytes_total``) against the restack counter's
   whole stack; a skewed stream (rows near items of 4 sealed segments),
   35% deleted, and a ``MaintenancePool`` compaction under streamed
   batches (none torn) whose auto factors exceed 1 on the hot segments,
   then the skewed stream routed (``device_imbalance`` unrouted and
   routed, ``device_load_imbalance``) and the answers equal to
   ``unshard()``'s; a ``maintenance`` frame of kind ``set_replication``
   and an ``update`` of ``replication`` over the wire, answers bit-equal
   to direct calls.  One ``sharded {...}`` line per tier.
14. pod index: (a) ``core.distributed.build_distributed`` /
   ``query_distributed`` / ``brute_force_distributed`` at the CPU tests'
   shape (512 items, N 32, a 2 x 4 mesh, one numpy-drawn family a rank) on
   ``cuda:0`` ranks against the same calls on ``cpu`` ranks: hashes apart
   only at a floor boundary (counted), tables equal where hashes are,
   query ids equal where distances are distinct (rows touched by a
   boundary excepted, counted), brute force likewise, distances rtol 1e-5
   atol 1e-6; (b) the paper's cell at full shape through
   ``launch.lsh_cell.main`` (16,777,216 l2-basis items of N 64 embedded by
   K4, 16 tables a rank of a 16 x 2 mesh on the card, 4,096 queries, k 10,
   4 probes): card and host ms, bytes, operations, bound and peak memory
   of the build, the query and brute force, launches, recall@10 and the
   held share; then, on the cell's own tensors, every kernel launch of
   its path at its shape against its plain version: K1 over a rank's
   1,048,576 rows, K2 over its 4,096 x 8,192 candidates, the query's
   fan-in (two K3 over (4,096, 320) pairs, bit for bit), K2 over one
   brute-force chunk of 16,384 items (ids equal where distances are
   distinct, rtol 1e-5; ``torch.cdist`` the library call), and brute
   force's two K3 merges, (4,096, 640) and (4,096, 160), bit for bit.
   One ``pod {...}`` line.
15. LM stack, last (after phase 14 releases its memory): (a) the
   llama3.2-3b smoke config in fp32, one parameter set on the CPU and on
   the card: forward logits (rtol 1e-4, atol 1e-4), the loss and every
   gradient of a 4-micro-batch step (rtol 1e-4, atol 1e-5), 16 decode
   steps through ``make_serve_step`` (logits, caches; signatures equal
   except at a counted floor boundary on rows that embed alike), the
   signature's K1 launch against its plain version, and the 30-step loss
   decrease of ``tests/test_train.py``'s tiny setup on the card; (b)
   llama3.2-3b at full width (28 layers, d 3,072, 32 padded heads, vocab
   128,256, bf16 compute, fp32 master weights and moments, remat full)
   drawn on the card: 4 steps of ``make_train_step`` at seq 2,048, global
   batch 4, grad_accum 4 (finite loss and grad norm each step; step ms,
   tokens/s, model FLOPs over step time and over the bf16 dense peak,
   peak memory), then ``launch.train --smoke`` on the card to 40 steps
   and again to 60, which must resume from 40; (c) the same weights in
   the serve step with ``LshServeParams.create`` (64 nodes, 16 hashes):
   batch 8, cache 2,048, rows 0-2 one 32-token prompt and rows 3-4
   another, fed token by token, then 32 greedy steps: ms and tokens/s a
   step beside the bound of the bytes a step reads, the signature's dedup
   groups each step (rows 0-2 must share every signature), the greedy
   tokens' agreement with the teacher-forced forward's argmax and the
   largest |difference| over the logits' scale (reported); K1's launches
   counted around (c), and K1 timed at the signature's shape.  A train
   step and a decode step are each profiled once, from a window that lost
   no kernel record (``launch/profiled.kernel_records``).  One ``lm``
   line per part.
16. LM families, last: (a) the smoke configs of qwen2-moe-a2.7b,
   arctic-480b, mamba2-2.7b, recurrentgemma-2b and seamless-m4t-medium in
   fp32, each on the CPU and on the card with one parameter set, at phase
   15 (a)'s bars: forward logits and aux loss, the loss and every gradient
   of a 4-micro-batch step, 16 decode steps through ``make_serve_step``
   (logits, every cache leaf -- K/V, ring buffers, conv and recurrent
   states, the enc-dec's cross cache filled by ``fill_cross_cache`` --,
   signatures), the signature's K1 launch; and a mamba2 step at its
   config's SSD chunk of 256, whose gradients must be finite and agree;
   (b) at full width, bf16 compute, fp32 master weights and moments, remat
   full: 3 steps of ``make_train_step`` at seq 2,048, global batch 4,
   grad_accum 4 of mamba2-2.7b (64 layers), recurrentgemma-2b (26, heads
   padded 10 -> 16), seamless-m4t-medium (12 + 12, frames one a token)
   and qwen2-moe-a2.7b cut to 4 of 24 layers: step ms (median of steps
   2-3), tokens/s, ``mfu`` on active parameters, peak memory, 0 non-finite
   steps; (c) each of the five at full width in the serve step with the
   signature, batch 8, cache 2,048 (qwen2-moe at full depth, arctic cut to
   2 of 35 layers, decode only; seamless after ``encode`` of 8 x 1,024
   frames and ``fill_cross_cache``): rows 0-2 one prompt (and one set of
   frames), rows 3-4 another, 8 prompt tokens then greedy, 16 steps: decode
   ms and tokens/s beside the bound of the bytes a step reads, K1 launched
   once a step, rows 0-2 sharing every signature; (d) one decode step per
   family profiled as in phase 15.  Every cut is listed in the phase's
   line.  One ``lm families (a)`` line, one ``train`` line per trained and
   one ``serve`` line per served config.
17. training on a mesh, last: (a) the smoke configs of llama3.2-3b,
   qwen2-moe-a2.7b and internlm2-20b (its ``fsdp_params`` on) in fp32,
   trained 2 steps of 4 micro-batches by ``shard_train_step`` on a (2, 4)
   mesh of ``cuda:0`` ranks, against the same on ``cpu`` ranks and the
   unsharded ``make_train_step`` on the card at phase 15 (a)'s bars: loss,
   aux and grad norm, every updated parameter and moment, each rank's block
   equal to its slice of the gathered tensor; then 16 decode steps of
   ``shard_serve_step`` (the cache's blocks gathered, decoded and
   scattered back) against
   ``make_serve_step`` on the card: logits, every cache leaf, signatures,
   and K1 against its plain version; (b) llama3.2-3b at full width on the
   (2, 4) mesh, its depth cut as far as the card forces (the cut is in the
   line): 3 sharded steps at seq 2,048, global batch 4, grad_accum 4 (step
   ms, ``mfu``, peak memory, 0 non-finite steps), each rank's parameter and
   moment bytes equal to the dry run's prediction to the byte; then at full
   depth its sharded serve step, batch 8, cache 2,048, 16 steps (8 prompt
   tokens, rows 0-2 one prompt, rows 3-4 another, then greedy), launch
   counts read around it (K1 once a step), rows 0-2 sharing every
   signature, and the unsharded serve step fed the same tokens beside it
   (decode ms, the logits' largest difference over their scale); one
   sharded train step and one sharded decode step profiled as in phase
   15; (c) a
   checkpoint of sharded parameters saved from (2, 4) and restored onto
   (4, 2), every block bit-equal on its new rank, then ``launch.train
   --smoke --mesh-devices 8`` on the card to 20 steps and again to 30,
   which must resume from 20; (d) ``ef_compress`` and ``compressed_psum``
   over 8 ranks on the card against the CPU, codes and scales bit-equal;
   (e) the dry run over every (arch x shape) cell of the production 16 x
   16 mesh on ``meta``, its fits table printed.  One ``mesh`` line per
   part.

Launch counts are read around each of phases 6-13, phase 15 (c), phase
16 (b)-(d) and phase 17 (b)'s sharded serve; in phase 14 they are the
cell's own count of its embed and three timed calls (its warm-ups,
profiled query and work count left out).

The last lines are the card's name and power limit, one JSON object with
a record per kernel (K1 four times: at the index's shape and at the LM
signatures of phases 15, 16 and 17), and ``{"ok": true, "device":
{...}}``.

    python3 chip_smoke.py --timings-only

runs phases 1, 2, 4 and 5 and ends with the card's line and one JSON
object of timing records, and

    python3 chip_smoke.py --paths-only

runs phases 1, 2 and 6-17 and ends with the card's line and one JSON
object of the paths' profiles and reports.  Copied to the root of another
checkout (an earlier commit, say), either times or profiles that
checkout's kernels on the same inputs, so two versions can be compared in
turns within one machine.

    python3 chip_smoke.py --pod-only

runs phases 1, 2 and 14 and ends with the card's line and one JSON object
of the phase's numbers; ``--lm-only`` does the same for phase 15,
``--families-only`` for phase 16 and ``--mesh-only`` for phase 17.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MAIN_ITEMS = 262144
MAIN_STEPS = 20
PARITY_ITEMS = 8192
WARMUP, REPS, GRAPH_REPLAYS = 10, 50, 10
HOST_CALLS, HOST_ROUNDS = 100, 9

SIMHASH_BATCH, SIMHASH_BITS = 512, 1024   # bench_hash_throughput's shape

REPLACES = {
    "hash_mm": "src/repro/kernels/hash_mm.py:25",
    "fused_query": "src/repro/kernels/fused_query.py:51",
    "merge": "src/repro/kernels/merge.py:123",
    "dct_mm": "src/repro/kernels/dct_mm.py:27",
    "quantized_query": "src/repro/kernels/quantize.py:146",
    "rerank": "src/repro/kernels/rerank.py:24",
    "simhash_pack": "src/repro/kernels/simhash_pack.py:23",
}
FP32_PATH = ("hash_mm", "dct_mm", "fused_query", "merge")
INT8_PATH = FP32_PATH + ("quantized_query", "rerank")


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def host_ms(fn, warmup=WARMUP, reps=REPS) -> float:
    """Median per-call time of ``fn()`` between CUDA events recorded around
    each call.  The card waits for the host between calls, so this is the
    host-inclusive cost a caller sees, launch overhead and all (the
    yardstick of the host column up to PR 13; the events add their own
    cost to each call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def host_clock_ms(fn, warmup=WARMUP, calls=HOST_CALLS, rounds=HOST_ROUNDS
                  ) -> float:
    """Host time per call of ``fn()`` on the host clock, no events: rounds
    of ``calls`` calls, each started on an idle card and closed by a
    synchronize outside the timed span, so the launch queue never fills
    and the card never holds the host back; the median round."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def host_times(fn, prefix="") -> dict:
    """``fn``'s host time per call by both yardsticks: ``host_ms`` between
    CUDA events, ``host_clock_ms`` on the host clock."""
    return {f"{prefix}host_ms": host_ms(fn),
            f"{prefix}host_clock_ms": host_clock_ms(fn)}


def time_ms(fn, warmup=WARMUP, reps=REPS, replays=GRAPH_REPLAYS) -> float:
    """Device time per call of ``fn()``: ``reps`` calls captured in one CUDA
    graph, the graph replayed between CUDA events ``replays`` times after
    warm-up; the median replay over ``reps``.  The host is out of the
    loop, so this is what the card spends on the call."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The H100's bound in ms and what sets it (``launch/roofline.py``)."""
    from repro_torch.launch import roofline
    s, by = roofline.bound_by(nbytes, ops)
    return s * 1e3, by


def bits(t):
    import torch
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


# -- phase 3: kernel checks ---------------------------------------------------


def on_card(t, offset=0):
    """``t`` copied to the card, ``offset`` elements past a 16-byte-aligned
    base: a contiguous view that is unaligned when offset % 4 != 0."""
    import torch
    flat = torch.empty(offset + t.numel(), dtype=t.dtype, device="cuda")
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


def check_hash_mm(gen, m, n, k, r=4.0, offset=0, quiet=False):
    import torch
    from repro_torch.kernels import hash_mm, ref
    x = on_card(torch.randn((m, n), generator=gen) * 0.5, offset)
    a = on_card(torch.randn((n, k), generator=gen), offset)
    b = on_card(torch.rand((k,), generator=gen), offset)
    h, p = hash_mm.hash_mm(x, a, b, r)
    hp, pp = ref.hash_mm_proj_ref(x, a, b, r)
    torch.cuda.synchronize()
    if not torch.allclose(p, pp, rtol=1e-6, atol=1e-5):
        raise AssertionError(f"hash_mm proj {m}x{n}x{k}: max err "
                             f"{(p - pp).abs().max().item()}")
    safe = (pp - torch.round(pp)).abs() > 1e-4
    bad = int(((h != hp) & safe).sum())
    if bad:
        raise AssertionError(f"hash_mm {m}x{n}x{k}: {bad} hashes differ "
                             "away from a bucket boundary")
    boundary = int((~safe).sum())
    flips = int((h != hp).sum())
    if not quiet:
        log(f"  hash_mm {m}x{n}x{k} offset {offset}: ok (max |proj err| "
            f"{(p - pp).abs().max().item():.3g}, {boundary} boundary "
            f"values, {flips} flipped)")
    return float((p - pp).abs().max())


def check_hash_saturation(gen):
    """K1's float -> int32 conversion against the plain version's
    saturating one (``ref.floor_to_int32``): a family with one alpha entry
    of 1e12 (its column's projections pass 2^31 both ways) and rows of
    +inf, -inf, NaN, one +inf and one -inf entry.  Every saturated,
    infinite or NaN projection must hash bit-equal (INT32_MAX, INT32_MIN,
    0), the projections must agree as values (NaN where NaN), and the
    finite ones away from a relative floor boundary as check_hash_mm."""
    import torch
    from repro_torch.kernels import hash_mm, ref
    m, n, k, r = 32, 64, 32, 8.0
    x = torch.randn((m, n), generator=gen) * 0.5
    x[1], x[2], x[3] = torch.inf, -torch.inf, torch.nan
    x[4, 0], x[5, 7] = torch.inf, -torch.inf
    a = torch.empty((n, k)).cauchy_(generator=gen)
    a[3, 5] = 1e12
    b = torch.rand((k,), generator=gen)
    x, a, b = x.cuda(), a.cuda(), b.cuda()
    h, pj = hash_mm.hash_mm(x, a, b, r)
    hp, pp = ref.hash_mm_proj_ref(x, a, b, r)
    torch.cuda.synchronize()
    wild = ~torch.isfinite(pp) | (pp.abs() >= 2.0 ** 31)
    if not (torch.equal(torch.isnan(pj), torch.isnan(pp))
            and torch.equal(pj[torch.isinf(pp)], pp[torch.isinf(pp)])):
        raise AssertionError("hash_mm saturation: inf / NaN projections "
                             "differ from the plain version's")
    if not torch.equal(h[wild], hp[wild]):
        raise AssertionError("hash_mm saturation: a saturated, infinite or "
                             "NaN projection hashes otherwise than the "
                             "plain version")
    fin = ~wild
    safe = fin & ((pp - torch.round(pp)).abs() > 1e-4 + 1e-6 * pp.abs())
    if not (torch.allclose(pj[fin], pp[fin], rtol=1e-6, atol=1e-5)
            and torch.equal(h[safe], hp[safe])):
        raise AssertionError("hash_mm saturation: finite projections differ")
    vals = {"INT32_MAX": int((h == 2 ** 31 - 1).sum()),
            "INT32_MIN": int((h == -2 ** 31).sum()),
            "NaN -> 0": int((torch.isnan(pp) & (h == 0)).sum())}
    if not all(vals.values()):
        raise AssertionError(f"hash_mm saturation: a case is missing {vals}")
    log(f"  hash_mm saturation: {int(wild.sum())} saturated / infinite / NaN "
        f"projections bit-equal to the plain version's {json.dumps(vals)}; "
        f"{int((fin & ~safe).sum())} finite boundary values")


def check_general_p_families(gen):
    """K1 through the general-p families, each against the plain version
    on the same rows: ``LazyPStableHash`` on its default device (the card)
    with Chambers-Mallows-Stuck blocks at p = 1.5, at N_f = 100 and then
    300, which grows alpha from 128 to 384 rows (the first 128 rows and the
    N_f = 100 hashes must not change), and a ``PStableHash`` at p = 0.5
    drawn by Chambers-Mallows-Stuck.  Projections within 1e-5 + 1e-6 of
    their terms' size t = |x| @ |alpha| / r + |b|, hashes equal where
    |proj - round(proj)| > 1e-4 + 1e-6 t (a heavy-tailed alpha makes the
    boundary relative)."""
    import torch
    from repro_torch.core.hashes import LazyPStableHash, PStableHash
    from repro_torch.kernels import ref

    def held(what, x, alpha, b, r, h, pj=None):
        hp, pp = ref.hash_mm_proj_ref(x, alpha, b, r)
        terms = (x.abs() @ alpha.abs()) / r + b.abs()
        if pj is not None and not (
                (pj - pp).abs() <= 1e-5 + 1e-6 * terms).all():
            raise AssertionError(f"{what}: projections differ from the "
                                 "plain version's")
        near = (pp - torch.round(pp)).abs() <= 1e-4 + 1e-6 * terms
        bad = int(((h != hp) & ~near).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} hashes differ from the "
                                 "plain version away from a floor boundary")
        return (f"{what} {tuple(h.shape)}: {int(near.sum())} boundary "
                f"values, {int((h != hp).sum())} flipped, max |proj| "
                f"{pp.abs().max().item():.3g}")

    lz = LazyPStableHash.create(19, 32, r=4.0, p=1.5)
    if lz.b.device.type != "cuda" or lz.coeffs.device.type != "cuda":
        raise AssertionError("LazyPStableHash did not default to the card")
    g = (torch.randn((64, 300), generator=gen) * 0.5).cuda()
    h100 = lz(g[:, :100])
    a128 = lz.coeffs.alpha(128).clone()
    n_before = lz.coeffs.current_n
    h300 = lz(g)
    if (n_before, lz.coeffs.current_n) != (128, 384):
        raise AssertionError(f"LazyPStableHash grew alpha from {n_before} "
                             f"to {lz.coeffs.current_n} rows, not 128 to 384")
    if not (torch.equal(lz.coeffs.alpha(128), a128)
            and torch.equal(lz(g[:, :100]), h100)):
        raise AssertionError("LazyPStableHash: growing alpha changed an "
                             "issued row or hash")
    lines = [held("LazyPStableHash p 1.5 N_f 100", g[:, :100],
                  lz.coeffs.alpha(100), lz.b, lz.r, h100),
             held("LazyPStableHash p 1.5 N_f 300", g, lz.coeffs.alpha(300),
                  lz.b, lz.r, h300)]
    fam = PStableHash.create(torch.Generator("cuda").manual_seed(19), 64, 32,
                             r=8.0, p=0.5)
    x = (torch.randn((128, 64), generator=gen) * 0.5).cuda()
    lines.append(held("PStableHash p 0.5", x, fam.alpha, fam.b, fam.r,
                      fam(x), fam.projections(x)))
    torch.cuda.synchronize()
    for line in lines:
        log(f"  {line}: equal to the plain version")


def check_alsh(gen):
    """ALSH (``core.hashes.ALSH``) on the card against its plain version
    on the same transformed rows: the ``"sign"`` variant's words through
    K7 at (512, 67) -> 1024 bits, every bit equal where |P(x) @ alpha| >=
    1e-5 and bit for bit K7's fmaf chain; the ``"l2"`` variant's hashes
    through K1, equal away from a floor boundary; both for the database
    transform P and the query transform Q."""
    import torch
    from repro_torch.core.hashes import ALSH
    from repro_torch.kernels import ref
    db = (torch.randn((SIMHASH_BATCH, 64), generator=gen) * 0.5).cuda()
    shifts = torch.arange(32, device="cuda")
    for variant in ("sign", "l2"):
        al = ALSH.create(torch.Generator("cuda").manual_seed(19), 64,
                         SIMHASH_BITS if variant == "sign" else 32,
                         r=1.0, variant=variant)
        for what, x, hashed in (
                ("P", al.preprocess(db), al.hash_db(db)),
                ("Q", al.query_transform(db[:37]), al.hash_query(db[:37]))):
            if variant == "sign":
                want = ref.simhash_pack_ref(x, al.inner.alpha)
                chain = ref.simhash_pack_chain_ref(x, al.inner.alpha)
                near = (x.double() @ al.inner.alpha.double()).abs() < 1e-5
                bits_ = lambda w: ((w[..., None] >> shifts) & 1).reshape(
                    w.shape[0], -1)
                bad = int(((bits_(hashed) != bits_(want)) & ~near).sum())
                ok = bad == 0 and torch.equal(hashed, chain)
            else:
                want, pp = ref.hash_mm_proj_ref(x, al.inner.alpha,
                                                al.inner.b, al.inner.r)
                near = (pp - torch.round(pp)).abs() <= 1e-4 + 1e-6 * pp.abs()
                ok = torch.equal(hashed[~near], want[~near])
            if not ok:
                raise AssertionError(f"ALSH {variant} {what} {tuple(x.shape)}"
                                     ": differs from the plain version")
            log(f"  ALSH {variant} {what}: {tuple(x.shape)} -> "
                f"{tuple(hashed.shape)}, equal to the plain version "
                f"({int(near.sum())} values near a sign or floor boundary)")


def check_dct_mm(gen, m, n, d=None, offset=0, quiet=False):
    """K4 against its plain version, rtol 1e-5 atol 1e-5: with the
    Chebyshev constants of width n (d None), else a random (n, d) matrix
    and scale with entries of the DCT's size (1 / sqrt(n))."""
    import torch
    from repro_torch.embedders.basis import cheb_kernel_constants
    from repro_torch.kernels import dct_mm, ref
    if d is None:
        pre, mat, scale = (torch.as_tensor(t) for t in cheb_kernel_constants(
            n, (-1.0, 1.0), "lebesgue"))
        f = torch.randn((m, n), generator=gen) * pre
    else:
        mat = torch.randn((n, d), generator=gen) / n ** 0.5
        scale = torch.rand((d,), generator=gen)
        f = torch.randn((m, n), generator=gen)
    f, mat, scale = (on_card(t.contiguous(), offset) for t in (f, mat, scale))
    out = dct_mm.dct_mm(f, mat, scale)
    want = ref.dct_mm_ref(f, mat, scale)
    torch.cuda.synchronize()
    if not torch.allclose(out, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"dct_mm {m}x{n}x{d}: max err "
                             f"{(out - want).abs().max().item()}")
    err = float((out - want).abs().max())
    if not quiet:
        log(f"  dct_mm {m}x{n}x{d or n} offset {offset}: ok (max err "
            f"{err:.3g})")
    return err


def check_small_gemm_shapes(gen):
    """K1 and K4 (csrc/small_gemm.cuh) at every m x depth x columns of the
    plan's edges, aligned and 1 float past alignment (the scalar path)."""
    n_cases, worst = 0, 0.0
    for m in (1, 8, 32, 33, 128, 256, 300):
        for cols in (17, 32, 40, 64):
            for depth in (17, 50, 64, 96, 200):
                for offset in (0, 1):
                    worst = max(worst, check_hash_mm(
                        gen, m, depth, cols, offset=offset, quiet=True))
                    worst = max(worst, check_dct_mm(
                        gen, m, depth, cols, offset=offset, quiet=True))
                    n_cases += 2
    log(f"  hash_mm + dct_mm at m in (1, 8, 32, 33, 128, 256, 300) x "
        f"columns in (17, 32, 40, 64) x depth in (17, 50, 64, 96, 200), "
        f"aligned and offset by 1 float: {n_cases} cases ok (max err "
        f"{worst:.3g})")


def check_batch_invariance(gen):
    """K1 and K4: a 256-row call against its 8-, 33- and 128-row slices
    (each on its own plan), bit for bit."""
    import torch
    from repro_torch.kernels import dct_mm, hash_mm
    x = torch.randn((256, 64), generator=gen).cuda()
    a = torch.randn((64, 32), generator=gen).cuda()
    b = torch.rand((32,), generator=gen).cuda()
    mt = torch.randn((64, 64), generator=gen).cuda()
    scale = torch.rand((64,), generator=gen).cuda()
    h, p = hash_mm.hash_mm(x, a, b, 4.0)
    e = dct_mm.dct_mm(x, mt, scale)
    for lo, hi in ((0, 8), (5, 38), (128, 256)):
        hs, ps = hash_mm.hash_mm(x[lo:hi], a, b, 4.0)
        es = dct_mm.dct_mm(x[lo:hi], mt, scale)
        if not (torch.equal(hs, h[lo:hi]) and torch.equal(bits(ps),
                                                          bits(p[lo:hi]))
                and torch.equal(bits(es), bits(e[lo:hi]))):
            raise AssertionError(f"batch invariance: rows {lo}:{hi} of a "
                                 "256-row call differ from the slice's call")
    torch.cuda.synchronize()
    log("  hash_mm + dct_mm: rows 0:8, 5:38 and 128:256 of a 256-row call "
        "bit-identical to the slices' own calls")


def _distinct(dp, dfull, k):
    """Slots whose plain distance is not (nearly) tied with a neighbour in
    the full plain order: there the ids must agree."""
    import torch
    near = lambda a, b: (a - b).abs() <= 1e-5 * b.abs().clamp(min=1e-30)
    tie = torch.zeros_like(dp, dtype=torch.bool)
    tie[:, 1:] |= near(dfull[:, 1:k], dfull[:, :k - 1])
    nxt = dfull[:, 1:k + 1]
    tie[:, :nxt.shape[1]] |= near(dfull[:, :nxt.shape[1]], nxt)
    return ~tie


def _thin_rows(ids, invalid_rows, sparse_rows, k):
    """Rows [0, invalid_rows) all invalid; the next ``sparse_rows`` rows
    keep only k // 2 valid slots (fewer valid candidates than k)."""
    ids[:invalid_rows] = -1
    thin = ids[invalid_rows:invalid_rows + sparse_rows]
    keep = thin[:, :k // 2].clamp(min=0)
    thin[:] = -1
    thin[:, :k // 2] = keep


def check_fused_query(gen, nq, n, m, c, k, p=2.0, valid_items=None,
                      invalid_rows=0, sparse_rows=0, quiet=False):
    import torch
    from repro_torch.kernels import fused_query, ref
    q = torch.randn((nq, n), generator=gen).cuda()
    db = torch.randn((m, n), generator=gen).cuda()
    db[1::7] = db[::7][:db[1::7].shape[0]]            # duplicate rows: ties
    ids = torch.randint(-1, m, (nq, c), generator=gen,
                        dtype=torch.int32).cuda()
    _thin_rows(ids, invalid_rows, sparse_rows, k)
    d, i = fused_query.fused_query_topk(q, db, ids, k, p=p,
                                        valid_items=valid_items)
    dp, ip = ref.fused_query_topk_ref(q, db, ids, k, p=p,
                                      valid_items=valid_items)
    # the full plain order, to tell distinct distances from ties
    dfull, _ = ref.fused_query_topk_ref(q, db, ids, ids.shape[1], p=p,
                                        valid_items=valid_items)
    torch.cuda.synchronize()
    fin = torch.isfinite(dp)
    if not torch.equal(fin, torch.isfinite(d)):
        raise AssertionError(f"fused_query {nq}x{c} k={k}: inf pattern")
    if not torch.allclose(d[fin], dp[fin], rtol=1e-5, atol=1e-6):
        raise AssertionError(f"fused_query {nq}x{c} k={k}: distances")
    tie = ~_distinct(dp, dfull, k) & fin
    bad = int(((i != ip) & ~tie).sum())
    if bad:
        raise AssertionError(f"fused_query {nq}x{c} k={k}: {bad} ids differ "
                             "at distinct distances")
    if not torch.equal(i[~fin], ip[~fin]):
        raise AssertionError(f"fused_query {nq}x{c} k={k}: -1 padding")
    err = float((d[fin] - dp[fin]).abs().max()) if fin.any() else 0.0
    if not quiet:
        log(f"  fused_query nq={nq} N={n} M={m} C={c} k={k} p={p} "
            f"valid={valid_items} invalid_rows={invalid_rows}: ok "
            f"(max err {err:.3g}, {int(tie.sum())} tied slots)")
    return err


def check_quantized_query(gen, nq, m, c, k, dtype, p=2.0, valid_items=None,
                          invalid_rows=0, n=64, sparse_rows=0, quiet=False):
    """K5 against its plain version: bit for bit for int8 at p in {1, 2}
    (every partial sum is an exact integer), else distances rtol 1e-5 atol
    1e-6 and ids equal at distinct distances."""
    import torch
    from repro_torch.kernels import quantize, quantized_query, ref
    db = torch.randn((m, n), generator=gen)
    db[1::7] = db[::7][:db[1::7].shape[0]]            # duplicate rows: ties
    tier = "int8" if dtype == torch.int8 else "bf16"
    codes, scale = quantize.encode(db.cuda(), tier)
    amax = db.abs().max()
    q = (db[torch.randint(0, m, (nq,), generator=gen)]
         + 0.2 * torch.randn((nq, n), generator=gen)).clamp(-amax, amax)
    q = q.cuda()                            # |q / scale| <= 127: exact sums
    ids = torch.randint(-1, m, (nq, c), generator=gen,
                        dtype=torch.int32).cuda()
    _thin_rows(ids, invalid_rows, sparse_rows, k)
    d, i = quantized_query.quantized_query_topk(q, codes, scale, ids, k, p=p,
                                                valid_items=valid_items)
    dp, ip = ref.quantized_topk_ref(q, codes, scale, ids, k, p=p,
                                    valid_items=valid_items)
    torch.cuda.synchronize()
    tag = (f"quantized_query {tier} nq={nq} M={m} C={c} k={k} p={p} "
           f"valid={valid_items} invalid_rows={invalid_rows}")
    if tier == "int8" and p in (1.0, 2.0):
        if not (torch.equal(bits(d), bits(dp)) and torch.equal(i, ip)):
            raise AssertionError(f"{tag}: not bit-identical to the plain "
                                 "version")
        if not quiet:
            log(f"  {tag}: bit-identical")
        return 0.0
    fin = torch.isfinite(dp)
    if not torch.equal(fin, torch.isfinite(d)):
        raise AssertionError(f"{tag}: inf pattern")
    if not torch.allclose(d[fin], dp[fin], rtol=1e-5, atol=1e-6):
        raise AssertionError(f"{tag}: distances")
    dfull, _ = ref.quantized_topk_ref(q, codes, scale, ids, c, p=p,
                                      valid_items=valid_items)
    ok = _distinct(dp, dfull, k) & fin
    bad = int(((i != ip) & ok).sum())
    if bad:
        raise AssertionError(f"{tag}: {bad} ids differ at distinct "
                             "distances")
    if not torch.equal(i[~fin], ip[~fin]):
        raise AssertionError(f"{tag}: -1 padding")
    err = float((d[fin] - dp[fin]).abs().max()) if fin.any() else 0.0
    if not quiet:
        log(f"  {tag}: ok (max err {err:.3g}, {int((~ok & fin).sum())} tied "
            "slots)")
    return err


def check_query_ties(gen, nq, dtype, n=64, c=1024, quiet=False):
    """K2 (fp32) or K5 (int8/bf16): ids 0..G-1 name one vector, the query
    itself, and sit in slots owned by different cluster ranks in an order
    unlike their ids.  The lower slot must win each tie, exactly, the ids
    must equal the plain version's, and so must the tied distances: bit
    for bit for fp32 and int8 (exact sums: 0 and integers), within K5's
    bf16 contract (rtol 1e-5) for bf16, whose 64 products the plain
    version and the kernel sum in different orders
    (tools/probe_sum_order.py, which also times a copy of K5 that follows
    the plain order: slower).  Returns whether the tied distances were
    bit-equal."""
    import torch
    from repro_torch.kernels import (fused_query, quantize, quantized_query,
                                     ref)
    db = torch.randn((512, n), generator=gen)
    db[:8] = db[0]
    q = db[0].repeat(nq, 1)
    ids = torch.randint(8, 512, (nq, c), generator=gen, dtype=torch.int32)
    plan = fused_query._plan(nq, c, n, torch.empty((), dtype=dtype)
                             .element_size())
    g = plan.cluster
    # id j at a slot of rank G - 1 - j: slot order runs against id order
    slots = [(g - 1 - j) + g * (3 + 5 * (g - 1 - j)) for j in range(g)]
    if sorted(plan.owner(s_) for s_ in slots) != list(range(g)):
        raise AssertionError(f"ties: slots {slots} miss a rank of {g}")
    for j, s_ in enumerate(slots):
        ids[:, s_] = j
    want = [j for _, j in sorted((s_, j) for j, s_ in enumerate(slots))]
    k = len(want) + 2
    q, ids = q.cuda(), ids.cuda()
    if dtype == torch.float32:
        db = db.cuda()
        d, i = fused_query.fused_query_topk(q, db, ids, k)
        dp, ip = ref.fused_query_topk_ref(q, db, ids, k)
    else:
        codes, scale = quantize.encode(
            db.cuda(), "int8" if dtype == torch.int8 else "bf16")
        d, i = quantized_query.quantized_query_topk(q, codes, scale, ids, k)
        dp, ip = ref.quantized_topk_ref(q, codes, scale, ids, k)
    torch.cuda.synchronize()
    nt = len(want)
    bit_equal = torch.equal(bits(d[:, :nt]), bits(dp[:, :nt]))
    if dtype == torch.bfloat16:
        close = torch.allclose(d[:, :nt], dp[:, :nt], rtol=1e-5, atol=0)
    else:
        close = bit_equal
    if not (close and bool((d[:, :nt] == d[:, :1]).all())
            and torch.equal(i, ip) and i[:, :nt].tolist() == [want] * nq):
        raise AssertionError(f"ties nq={nq} {dtype} G={plan.cluster}: "
                             f"got {i[0, :nt].tolist()}, want {want}")
    if not quiet:
        log(f"  ties across {plan.cluster} cluster ranks, nq={nq} {dtype}: "
            f"lower slot first, ids {want}")
    return bit_equal


def check_query_ties_seeds(seeds=8):
    """check_query_ties at both row counts and all three dtypes, its
    inputs drawn from ``seeds`` generator seeds of their own; raises on
    any failure, and logs how many passed and how often the bf16 tied
    distances were also bit-equal to the plain version's."""
    import torch
    n_pass, n_bf16, bf16_bit_equal = 0, 0, 0
    for seed in range(seeds):
        g = torch.Generator().manual_seed(1000 + seed)
        for nq in (32, 128):
            for dt in (torch.float32, torch.int8, torch.bfloat16):
                same = check_query_ties(g, nq, dt, quiet=True)
                n_pass += 1
                if dt == torch.bfloat16:
                    n_bf16 += 1
                    bf16_bit_equal += same
    log(f"  ties over {seeds} seeds x nq in (32, 128) x (fp32, int8, bf16): "
        f"{n_pass} of {n_pass} pass; bf16 tied distances bit-equal to the "
        f"plain version's in {bf16_bit_equal} of {n_bf16}")


STACK_SEGMENTS = 258      # sealed segments x rows: the stacked launches


def flat_rows(local, cap):
    """(n_seg, nq, C) local slots -> (n_seg * nq, C) int32 rows of a stack
    of n_seg segments of ``cap`` rows (``core.index.flat_rows``, written
    out here so that the timings also run in a checkout without it)."""
    import torch
    base = (torch.arange(local.shape[0], device=local.device,
                         dtype=torch.int32) * cap)[:, None, None]
    return torch.where(local >= 0, local + base, -1).reshape(
        -1, local.shape[-1]).to(torch.int32).contiguous()


def stacked_inputs(gen, n_seg, nq, dtype, cap=1024, c=1024, n=64):
    """One stacked scorer launch's inputs: n_seg segments of ``cap`` rows
    (fp32, or int8/bf16 codes with one scale each, of other magnitudes),
    nq queries repeated per segment, and (n_seg * nq, c) flat candidate
    rows, a quarter of the slots valid, each block of nq rows within its
    segment's rows.  Returns (q, db, scale or None, ids, per-segment
    (codes, scale) list or None)."""
    import torch
    from repro_torch.kernels import quantize
    local = torch.randint(0, cap, (n_seg, nq, c), generator=gen,
                          dtype=torch.int32)
    local[torch.rand((n_seg, nq, c), generator=gen) >= 0.25] = -1
    ids = flat_rows(local.cuda(), cap)
    q = torch.randn((nq, n), generator=gen).cuda().repeat(n_seg, 1)
    if dtype == torch.float32:
        return q, torch.randn((n_seg * cap, n), generator=gen).cuda(), \
            None, ids, None
    tier = "int8" if dtype == torch.int8 else "bf16"
    segs = [quantize.encode(torch.randn((cap, n), generator=gen).cuda()
                            * (1 + s % 5), tier) for s in range(n_seg)]
    return (q, torch.cat([cd for cd, _ in segs]),
            torch.stack([sc for _, sc in segs]), ids, segs)


def check_stacked_scorers(gen, ps=(2.0, 1.0)):
    """K2 and K5 at the stacked launches' shapes (STACK_SEGMENTS segments
    x 32 and x 128 rows, C 1024, k 10 and 40) at each p of ``ps`` (p = 1:
    the l1-qmc tenant's sums of |x - y|, where ties are more frequent)
    against their plain versions: fp32 and bf16 distances rtol 1e-5 atol
    1e-6 with ids equal at distinct distances, int8 bit-identical; K5 with
    one scale per segment, and the first, middle and last segment's block
    of rows bit for bit equal to that segment's own launch."""
    import torch
    from repro_torch.kernels import fused_query, quantized_query, ref
    worst = {"fused_query": 0.0, "quantized_query": 0.0}
    for p, nq, dtype in [(p, nq, dt) for p in ps for nq in (32, 128)
                         for dt in (torch.float32, torch.int8,
                                    torch.bfloat16)]:
        q, db, scale, ids, segs = stacked_inputs(
            gen, STACK_SEGMENTS, nq, dtype)
        k = 10 if dtype == torch.float32 else 40
        plan = fused_query._plan(q.shape[0], 1024, 64,
                                 db.element_size())
        tag = (f"stacked {dtype} p {p} {STACK_SEGMENTS} x {nq} rows (G "
               f"{plan.cluster}, {plan.smem} bytes of shared memory)")
        if segs is None:
            d, i = fused_query.fused_query_topk(q, db, ids, k, p=p)
            dp, ip = ref.fused_query_topk_ref(q, db, ids, k, p=p)
            dfull, _ = ref.fused_query_topk_ref(q, db, ids, 1024, p=p)
        else:
            d, i = quantized_query.quantized_query_topk(q, db, scale,
                                                        ids, k, p=p)
            dp, ip = ref.quantized_topk_ref(q, db, scale, ids, k, p=p)
            dfull, _ = ref.quantized_topk_ref(q, db, scale, ids, 1024,
                                              p=p)
        torch.cuda.synchronize()
        fin = torch.isfinite(dp)
        if dtype == torch.int8:
            ok = torch.equal(bits(d), bits(dp)) and torch.equal(i, ip)
        else:
            tie = ~_distinct(dp, dfull, k) & fin
            ok = (torch.equal(fin, torch.isfinite(d))
                  and torch.allclose(d[fin], dp[fin], rtol=1e-5,
                                     atol=1e-6)
                  and not bool(((i != ip) & ~tie).sum())
                  and torch.equal(i[~fin], ip[~fin]))
        if not ok:
            raise AssertionError(f"{tag}: differs from the plain version")
        name = "fused_query" if segs is None else "quantized_query"
        worst[name] = max(worst[name],
                          float((d[fin] - dp[fin]).abs().max()))
        for s_ in sorted({0, STACK_SEGMENTS // 2, STACK_SEGMENTS - 1}):
            blk = slice(s_ * nq, (s_ + 1) * nq)
            loc = torch.where(ids[blk] >= 0, ids[blk] - s_ * 1024, -1)
            if segs is None:
                ds, is_ = fused_query.fused_query_topk(
                    q[blk].contiguous(), db[s_ * 1024:(s_ + 1) * 1024],
                    loc.contiguous(), k, p=p)
            else:
                ds, is_ = quantized_query.quantized_query_topk(
                    q[blk].contiguous(), *segs[s_], loc.contiguous(), k,
                    p=p)
            if not (torch.equal(bits(d[blk]), bits(ds)) and torch.equal(
                    i[blk], torch.where(is_ >= 0, is_ + s_ * 1024, -1))):
                raise AssertionError(f"{tag}: segment {s_}'s rows differ "
                                     "from its own launch")
        log(f"  {tag}: ok against the plain version, segments 0, "
            f"{STACK_SEGMENTS // 2} and {STACK_SEGMENTS - 1} bit-equal "
            "to their own launches")
        del q, db, scale, ids, segs, dfull
        torch.cuda.empty_cache()
    return worst


def check_rerank(gen, b, c, n=64, p=2.0, offset=0, invalid_rows=0,
                 quiet=False):
    """K6 against its plain version: rtol 1e-5 atol 1e-6, +inf exactly
    where the id is < 0 (rows [0, invalid_rows) all invalid; ``offset``
    floats past alignment takes the scalar path)."""
    import torch
    from repro_torch.kernels import ref, rerank
    q = on_card(torch.randn((b, n), generator=gen), offset)
    emb = on_card(torch.randn((b, c, n), generator=gen), offset)
    ids = torch.randint(-1, 10 * c, (b, c), generator=gen,
                        dtype=torch.int32)
    ids[:invalid_rows] = -1
    ids = ids.cuda()
    d = rerank.rerank_distances(q, emb, ids, p=p)
    want = ref.rerank_ref(q, emb, ids, p)
    torch.cuda.synchronize()
    if not torch.equal(torch.isinf(d), ids < 0):
        raise AssertionError(f"rerank {b}x{c}x{n} p={p}: inf pattern")
    fin = ids >= 0
    if not torch.allclose(d[fin], want[fin], rtol=1e-5, atol=1e-6):
        raise AssertionError(f"rerank {b}x{c}x{n} p={p}: max err "
                             f"{(d[fin] - want[fin]).abs().max().item()}")
    err = float((d[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    if not quiet:
        log(f"  rerank B={b} C={c} N={n} p={p}: ok (max err {err:.3g})")
    return err


def check_rerank_shapes(gen):
    """K6 at p in {1, 2, 1.5} x N in {3, 48, 64, 100, 200}, on aligned
    views and 1 float past alignment, two all-invalid rows each."""
    n_cases, worst = 0, 0.0
    for p in (1.0, 2.0, 1.5):
        for n in (3, 48, 64, 100, 200):
            for offset in (0, 1):
                worst = max(worst, check_rerank(
                    gen, 37, 40, n=n, p=p, offset=offset, invalid_rows=2,
                    quiet=True))
                n_cases += 1
    log(f"  rerank at p in (1, 2, 1.5) x N in (3, 48, 64, 100, 200), "
        f"aligned and offset by 1 float, 2 all-invalid rows: {n_cases} "
        f"cases ok (max err {worst:.3g})")


def check_simhash(gen, m, n, k, offset=0, quiet=False):
    """K7 against its plain version, every bit equal where |x @ A| >= 1e-5
    (a sum within 1e-5 of 0 may take either sign in another order), and
    bit for bit against its own arithmetic (``ref.simhash_pack_chain_ref``:
    one fmaf chain per output over the depth in order, as the SIMT kernel
    it replaced summed).  Row 0 is all +0.0 and row 1 all -0.0: every word
    -1.  ``offset`` floats past alignment takes the scalar path."""
    import torch
    from repro_torch.kernels import ref, simhash_pack
    x = torch.randn((m, n), generator=gen)
    x[0] = 0.0
    if m > 1:
        x[1] = -0.0
    x = on_card(x, offset)
    a = on_card(torch.randn((n, k), generator=gen), offset)
    sig = simhash_pack.simhash_pack(x, a)
    want = ref.simhash_pack_ref(x, a)
    chain = ref.simhash_pack_chain_ref(x, a)
    proj = (x.double() @ a.double()).abs()
    torch.cuda.synchronize()
    shifts = torch.arange(32, device=x.device)
    got_b = ((sig[..., None] >> shifts) & 1).reshape(m, k)
    want_b = ((want[..., None] >> shifts) & 1).reshape(m, k)
    near = proj < 1e-5
    bad = int(((got_b != want_b) & ~near).sum())
    tag = f"simhash_pack {m}x{n}x{k} offset {offset}"
    if bad:
        raise AssertionError(f"{tag}: {bad} bits differ away from |proj| < "
                             "1e-5")
    if not bool((sig[:min(m, 2)] == -1).all()):
        raise AssertionError(f"{tag}: a row of +0.0 or -0.0 is not all -1")
    if not torch.equal(sig, chain):
        raise AssertionError(f"{tag}: not bit-identical to its fmaf chain")
    flips = int((got_b != want_b).sum())
    if not quiet:
        log(f"  {tag}: ok, bit-identical to its fmaf chain ({int(near.sum())}"
            f" values within 1e-5 of 0, {flips} bits flipped against the "
            "plain version)")
    return float(flips > 0)        # max |bit - plain bit| over the bits


SIMHASH_SHAPES = ((SIMHASH_BATCH, 64, SIMHASH_BITS), (37, 50, 96), (1, 64, 32),
                  (513, 100, 160), (4096, 200, 2048))


def check_simhash_shapes(gen):
    """K7 at the benchmark's shape and the edges (one row, one word, a
    depth past 64, 4,096 rows), aligned and 1 float past alignment; the
    benchmark shape's error is returned."""
    err = 0.0
    for m, n, k in SIMHASH_SHAPES:
        for offset in (0, 1):
            e = check_simhash(gen, m, n, k, offset=offset)
            if (m, n, k, offset) == (SIMHASH_BATCH, 64, SIMHASH_BITS, 0):
                err = e
    return err


def check_simhash_batch_invariance(gen):
    """K7: the same rows in calls of 1, 37 and 512 rows give equal words."""
    import torch
    from repro_torch.kernels import simhash_pack
    x = torch.randn((SIMHASH_BATCH, 64), generator=gen).cuda()
    a = torch.randn((64, SIMHASH_BITS), generator=gen).cuda()
    full = simhash_pack.simhash_pack(x, a)
    for lo, hi in ((0, 1), (5, 42), (511, 512)):
        part = simhash_pack.simhash_pack(x[lo:hi], a)
        if not torch.equal(part, full[lo:hi]):
            raise AssertionError(f"simhash_pack: rows {lo}:{hi} of a 512-row "
                                 "call differ from the slice's own call")
    torch.cuda.synchronize()
    log("  simhash_pack: rows 0:1, 5:42 and 511:512 of a 512-row call "
        "bit-identical to the slices' own calls")


def check_merge(gen, rows, m, sorted_run=1, n_out=None, runs=None):
    import torch
    from repro_torch.kernels import merge, ref
    d = torch.rand((rows, m), generator=gen)
    d = torch.round(d * 50) / 50                     # many equal distances
    d[:, ::13] = torch.inf
    i = torch.randint(-1, 4 * m, (rows, m), generator=gen, dtype=torch.int32)
    if runs:
        d = d.reshape(rows, m // runs, runs).sort(dim=-1).values.reshape(
            rows, m)
    d, i = d.cuda(), i.cuda()
    dk, ik = merge.sort_pairs_kernel(d, i, sorted_run=sorted_run,
                                     n_out=n_out)
    dp, ip = ref.sort_pairs(d, i, sorted_run=sorted_run)
    n_out = m if n_out is None else n_out
    dp, ip = dp[:, :n_out], ip[:, :n_out]
    torch.cuda.synchronize()
    if not (torch.equal(bits(dk), bits(dp)) and torch.equal(ik, ip)):
        raise AssertionError(f"merge {rows}x{m} run={sorted_run}: not "
                             "bit-identical to the plain network")
    if sorted_run == 1:
        # the plain network is a lexicographic sort: stable by id, then
        # stable by distance
        o = torch.sort(i.long(), dim=-1, stable=True).indices
        d1, i1 = torch.gather(d, 1, o), torch.gather(i, 1, o)
        o2 = torch.sort(d1, dim=-1, stable=True).indices
        ds, is_ = torch.gather(d1, 1, o2), torch.gather(i1, 1, o2)
        if not (torch.equal(bits(ds[:, :n_out]), bits(dp))
                and torch.equal(is_[:, :n_out], ip)):
            raise AssertionError(f"merge {rows}x{m}: network != stable "
                                 "sorts")
    log(f"  merge rows={rows} M={m} run={sorted_run} n_out={n_out} "
        f"({merge.route(rows, m, n_out, sorted_run)} route): bit-identical")
    return 0.0


def merge_pairs(gen, rows, m, kind="ties"):
    """(d, i) on the CPU for the K3 checks: distances in steps of 1/50 (many
    ties), every 13th +inf, ids in [-1, 4M); or a duplicate-heavy kind:
    ``empty`` (every slot (+inf, -1)), ``equal`` (one distance, distinct
    ids), ``repeated`` (three pairs, each many times), ``padded`` (a third
    of the slots (+inf, -1)), ``negative`` (signed, -inf, no -0.0),
    ``signed_zero`` (half the distances +0.0 or -0.0)."""
    import torch
    d = torch.round(torch.rand((rows, m), generator=gen) * 50) / 50
    d[:, ::13] = torch.inf
    i = torch.randint(-1, 4 * m, (rows, m), generator=gen, dtype=torch.int32)
    if kind == "empty":
        d[:] = torch.inf
        i[:] = -1
    elif kind == "equal":
        d[:] = 0.5
        i = torch.argsort(torch.rand((rows, m), generator=gen), dim=1).to(
            torch.int32)
    elif kind == "repeated":
        pick = torch.randint(0, 3, (rows, m), generator=gen)
        d, i = torch.gather(d[:, :3], 1, pick), torch.gather(i[:, :3], 1, pick)
    elif kind == "padded":
        d[:, 1::3] = torch.inf
        i[:, 1::3] = -1
    elif kind == "negative":
        d = d - 0.5
        d[d == 0] = 0.25
        d[:, 5::29] = -torch.inf
    elif kind == "signed_zero":
        pick = torch.randint(0, 4, (rows, m), generator=gen)
        d = torch.where(pick == 0, -0.0, torch.where(pick == 1, 0.0, d))
    return d, i


def mixed_zero_slots(d, i, out_d, out_i):
    """Output slots holding a zero distance whose id the row pairs with
    both -0.0 and +0.0: the one case no selection reproduces (the network
    leaves such equal pairs where its compare pattern puts them); there
    the checks compare distances as values, elsewhere bit for bit."""
    import torch
    neg = (d == 0) & torch.signbit(d)
    pos = (d == 0) & ~torch.signbit(d)
    mixed = torch.zeros_like(out_i, dtype=torch.bool)
    for r in range(0, d.shape[0], 8):            # (8, n_out, M) at a time
        same = out_i[r:r + 8, :, None] == i[r:r + 8, None, :]
        mixed[r:r + 8] = ((same & neg[r:r + 8, None, :]).any(-1)
                          & (same & pos[r:r + 8, None, :]).any(-1))
    return mixed & (out_d == 0)


def merge_topk_plain(d, i, k):
    """ops.merge_topk's CPU route (mask, network, first k, -1 beside +inf),
    run on the tensors' own device."""
    import torch
    from repro_torch.kernels import ref
    sd, si = ref.sort_pairs(torch.where(i < 0, torch.inf, d), i)
    sd, si = sd[:, :k], si[:, :k]
    return sd, torch.where(torch.isinf(sd), -1, si)


def check_merge_select(gen):
    """K3's select route bit for bit against the plain network's first
    n_out columns, and ops.merge_topk against its CPU route (on the CPU up
    to 2^20 pairs, else the same code on the card), one launch each; on
    rows holding -0.0 too, signs of zero included, but where a row pairs
    one id with both signs (``mixed_zero_slots``)."""
    import torch
    from repro_torch.kernels import dispatch, merge, ops, ref

    def same(a, b, d, i):
        """Bit for bit, but at mixed_zero_slots (as values there)."""
        a = (a[0].to(b[0].device), a[1].to(b[1].device))
        if not torch.equal(a[1], b[1]):
            return False
        if not bool((d == 0).any()):
            return torch.equal(bits(a[0]), bits(b[0]))
        ex = mixed_zero_slots(d.to(b[0].device), i.to(b[1].device), *b)
        return (torch.equal(bits(a[0])[~ex], bits(b[0])[~ex])
                and torch.equal(a[0][ex], b[0][ex]))

    def one(d, i, ks, tag, topk=True):
        dc, ic = on_card(d, tag[1]), on_card(i, tag[2])
        sd, si = ref.sort_pairs(dc, ic)
        # the CPU route's answer at the largest k; a smaller k's is its
        # prefix
        if topk and d.numel() <= 2 ** 20:
            want = ops.merge_topk(d, i, max(ks))
        elif topk:
            want = merge_topk_plain(dc, ic, max(ks))
        dm = torch.where(i < 0, torch.inf, d)    # merge_topk's masking
        for k in ks:
            if not same(merge.sort_pairs_kernel(dc, ic, n_out=k),
                        (sd[:, :k], si[:, :k]), dc, ic):
                raise AssertionError(f"merge select {tag} n_out={k}: not "
                                     "bit-identical to the plain network")
            if not topk:
                continue
            before = dispatch.launches["merge"]
            got = ops.merge_topk(dc, ic, k)
            if dispatch.launches["merge"] != before + 1:
                raise AssertionError(f"merge_topk {tag}: not one launch")
            if not same(got, (want[0][:, :k], want[1][:, :k]), dm, i):
                raise AssertionError(f"merge_topk {tag} k={k}: not "
                                     "bit-identical to its CPU route")
        return 1
    n = 0
    for rows in (1, 32, 128, 300):
        for m in (1, 5, 40, 2570, 10320, 41280):
            ks = [k for k in (1, 10, 40, 128) if k <= m]
            n += len(ks) * one(*merge_pairs(gen, rows, m), ks, (rows, 0, 0))
    log(f"  merge select route, rows in (1, 32, 128, 300) x M in (1, 5, 40, "
        f"2570, 10320, 41280) x n_out in (1, 10, 40, 128): {n} cases "
        "bit-identical, merge_topk one launch and equal to its CPU route")
    n = 0
    for kind in ("empty", "equal", "repeated", "padded", "negative"):
        for rows, m, k in ((32, 2570, 10), (128, 10320, 40), (128, 40, 10),
                           (5, 300, 128), (128, 41280, 40),
                           (3, 41280, 128)):
            n += one(*merge_pairs(gen, rows, m, kind), [k], (rows, 0, 0),
                     topk=kind != "negative")
    for m in (37, 2570, 10320):
        for offs in ((1, 1), (3, 3), (1, 2), (0, 3)):
            n += one(*merge_pairs(gen, 7, m), [1, 10, 37], (7,) + offs)
    d, i = merge_pairs(gen, 1, 100_000, "padded")
    n += one(d, i, [10, 40, 128], (1, 0, 0))
    log(f"  merge select route on duplicate-heavy rows (all (+inf, -1), "
        f"equal distances, repeated pairs, a third empty), signed distances, "
        f"views 1-3 floats past alignment and a 100,000-pair row: {n} inputs "
        "bit-identical")
    n = 0
    for rows, m, k in ((32, 2570, 10), (128, 10320, 40), (128, 40, 10),
                       (5, 300, 128), (128, 41280, 40), (3, 41280, 128)):
        n += one(*merge_pairs(gen, rows, m, "signed_zero"), [k],
                 (rows, 0, 0))
    # a row where -0.0 sorted below +0.0 would change the ids: the network
    # calls them equal and takes ids 1, 3, 4, 5
    d = torch.tensor([[0.0, -0.0, 0.0, -0.0, 1.0, 2.0, -0.0, 0.0]])
    i = torch.tensor([[7, 3, 1, 5, 0, 2, 9, 4]], dtype=torch.int32)
    n += one(d, i, [4], (1, 0, 0))
    got = ops.merge_topk(d.cuda(), i.cuda(), 4)
    if got[1].tolist() != [[1, 3, 4, 5]] or torch.signbit(
            got[0]).tolist() != [[False, True, False, True]]:
        raise AssertionError(f"merge_topk on +-0.0: ids {got[1].tolist()}, "
                             f"distances {got[0].tolist()}")
    log(f"  merge select route on rows of mixed +0.0 and -0.0: {n} inputs, "
        "ids equal to the plain network's and distances bit-identical, "
        "signs of zero included (as values only where a row pairs one id "
        "with both signs); the mixed row [0, -0, 0, -0, 1, 2, -0, 0] gives "
        "ids [1, 3, 4, 5] and distances [0, -0, 0, -0]")


def fanin_rows(gen, rows, n_dev, k, replicas):
    """A replicated fan-in's input on the CPU: ``n_dev`` ranks' sorted
    (distance, gid) runs of ``k`` pairs a row, gids distinct within a row
    (an item lives in one segment) but where ``replicas`` lists (rank,
    source rank) pairs: that rank repeats the source's run bit for bit, as
    a replica does; the last rank's tail is empty (+inf, -1)."""
    import torch
    d = torch.sort(torch.round(torch.rand((rows, n_dev, k), generator=gen)
                               * 200) / 200, dim=-1).values
    g = torch.stack([torch.randperm(50 * n_dev * k, generator=gen)[:n_dev * k]
                     for _ in range(rows)]).view(rows, n_dev, k).to(
        torch.int32)
    for r, src in replicas:
        d[:, r], g[:, r] = d[:, src], g[:, src]
    d[:, -1, k - 3:], g[:, -1, k - 3:] = torch.inf, -1
    return d.reshape(rows, -1), g.reshape(rows, -1)


def check_merge_unique(gen):
    """``ops.merge_topk_unique`` (the sharded fan-in: K3's full sort, the
    adjacent-gid dedup, K3's first k) on the card bit for bit against its
    plain version on the same card tensors and on the CPU, at the fan-in
    shapes (32 and 128 rows x 8 ranks x k 10, and x k 40 at int8), on rows
    holding replica copies; two K3 launches a call; and on rows without a
    copy bit-equal to ``ops.merge_topk``."""
    import torch
    from repro_torch.kernels import dispatch, ops, ref
    n = 0
    for rows in (32, 128):
        for k in (10, 40):
            for replicas in (((3, 1), (6, 1), (7, 2)), ()):
                d, g = fanin_rows(gen, rows, 8, k, replicas)
                dc, gc_ = d.cuda(), g.cuda()
                before = dispatch.launches["merge"]
                got = ops.merge_topk_unique(dc, gc_, k)
                if dispatch.launches["merge"] != before + 2:
                    raise AssertionError("merge_topk_unique: not two K3 "
                                         "launches")
                for want in (ref.merge_topk_unique_ref(dc, gc_, k),
                             ref.merge_topk_unique_ref(d, g, k)):
                    if not (torch.equal(got[1].cpu(), want[1].cpu()) and
                            torch.equal(bits(got[0].cpu()),
                                        bits(want[0].cpu()))):
                        raise AssertionError(
                            f"merge_topk_unique ({rows}, 8 x {k}), "
                            f"replicas {replicas}: not bit-identical to its "
                            "plain version")
                real = got[1].cpu()
                for row in real:
                    kept = row[row >= 0]
                    if kept.numel() != torch.unique(kept).numel():
                        raise AssertionError("merge_topk_unique kept a "
                                             "replica copy")
                if not replicas:
                    plain = ops.merge_topk(dc, gc_, k)
                    if not (torch.equal(got[1], plain[1]) and
                            torch.equal(bits(got[0]), bits(plain[0]))):
                        raise AssertionError(
                            f"merge_topk_unique ({rows}, 8 x {k}) without "
                            "copies differs from merge_topk")
                n += 1
    log(f"  merge_topk_unique at (32, 128) rows x 8 ranks x k (10, 40), with "
        f"and without replica copies: {n} inputs bit-identical to the plain "
        "version (card and CPU), two K3 launches each, no copy kept, and "
        "equal to merge_topk where no row holds a copy")


NAN_ENTRY_POINTS = ("pstable_hash_proj", "fused_query_topk",
                    "quantized_query_topk", "candidate_distances",
                    "merge_topk")


def check_nan_queries(n_items=3000, rows=32):
    """Query rows holding a NaN, +inf or -inf (and one all-NaN row) at the
    demo's l2-basis config, fp32 / bf16 / int8, 1 and 4 probes, stacked
    query and per-segment fan-out: on the card each such row answers (-1,
    +inf) in every slot, bit-equal to the CPU's, and every other row keeps
    the card's bits for the batch with finite rows in their place; no
    kernel entry point (K1 hash, K2, K5, K6, K3 merge) receives a NaN.
    Returns the number of batches checked.  A checkout before the repair
    has no guard (``SegmentedIndex`` then zeroes nothing) and fails."""
    import torch
    from repro_torch import convert
    from repro_torch.kernels import ops
    from repro_torch.serve import SegmentedIndex

    spec = tenant_spec("l2-basis")
    cfg = spec.index_config()
    fam = parity_family(cfg, np.random.default_rng(4321))
    rng = np.random.default_rng(11)
    data = rng.normal(size=(n_items, cfg.n_dims)).astype(np.float32)
    q = (0.9 * rng.normal(size=(rows, cfg.n_dims))).astype(np.float32)
    clean = q.copy()
    bad_rows = [1, 4, 5, 6, 17, 31]
    for r, v in zip(bad_rows, (np.nan, np.inf, -np.inf, np.nan, np.inf,
                               np.nan)):
        q[r, (7 * r) % cfg.n_dims] = v
        clean[r] = rng.normal(size=cfg.n_dims).astype(np.float32)
    q[6, :] = np.nan
    good = np.setdiff1d(np.arange(rows), bad_rows)
    real = {n: getattr(ops, n) for n in NAN_ENTRY_POINTS}

    def guard(name):
        def checked(*args, **kw):
            for a in list(args) + list(kw.values()):
                if isinstance(a, torch.Tensor) and a.is_floating_point() \
                        and bool(torch.isnan(a).any()):
                    raise AssertionError(f"NaN rows: {name} received a NaN")
            return real[name](*args, **kw)
        return checked

    def host(pair):
        return (pair[0].cpu().numpy(), pair[1].cpu().numpy().view(np.int32))

    n_checked = 0
    for name in NAN_ENTRY_POINTS:
        setattr(ops, name, guard(name))
    try:
        for precision in ("fp32", "bf16", "int8"):
            idx = {}
            for dev in ("cpu", "cuda"):
                idx[dev] = SegmentedIndex(
                    cfg, segment_capacity=spec.segment_capacity,
                    insert_chunk=spec.insert_chunk,
                    family=convert.family_from_numpy(*fam, device=dev),
                    precision=precision, device=dev)
                g = idx[dev].insert(data)
                idx[dev].delete(g[::13])
            for n_probes in (1, 4):
                for how in ("query", "_query_fanout"):
                    call = {d: getattr(idx[d], how) for d in idx}
                    got = host(call["cuda"](q, 10, n_probes=n_probes))
                    ref = host(call["cuda"](clean, 10, n_probes=n_probes))
                    cpu = host(call["cpu"](q, 10, n_probes=n_probes))
                    inf_bits = np.float32(np.inf).view(np.int32)
                    if not ((got[0][bad_rows] == -1).all()
                            and (got[1][bad_rows] == inf_bits).all()):
                        raise AssertionError(
                            f"NaN rows ({precision}, {how}, {n_probes} "
                            "probes): the card's bad rows are not (-1, "
                            "+inf)")
                    if not (np.array_equal(got[0][bad_rows],
                                           cpu[0][bad_rows])
                            and np.array_equal(got[1][bad_rows],
                                               cpu[1][bad_rows])):
                        raise AssertionError(
                            f"NaN rows ({precision}, {how}): card and CPU "
                            "differ on the bad rows")
                    if not (np.array_equal(got[0][good], ref[0][good])
                            and np.array_equal(got[1][good], ref[1][good])):
                        raise AssertionError(
                            f"NaN rows ({precision}, {how}, {n_probes} "
                            "probes): a finite row changed")
                    if (got[0][good, 0] < 0).any():
                        raise AssertionError(f"NaN rows ({precision}): a "
                                             "finite row found nothing")
                    n_checked += 1
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    log(f"  NaN / +-inf query rows: {len(bad_rows)} of {rows} rows bad "
        f"(one all NaN), {n_items} items, fp32 / bf16 / int8 x 1, 4 probes "
        f"x stacked, fan-out: {n_checked} batches, bad rows (-1, +inf) on "
        "the card as on the CPU, finite rows bit-equal to the batch "
        "without the bad values, no kernel given a NaN")
    return n_checked


def check_query_batched(rows=5000, batch=1024, k=10, n_probes=4):
    """``core.index.query_index_batched``: ``rows`` queries in ``batch``-row
    chunks (the last zero-padded) on one 1,024-item segment, bit-equal
    (ids and distance bits) to one ``query_index`` call over the same rows,
    one K1 and one K2 launch a chunk, and equal to the plain path on the
    CPU under the parity contract: every row that differs explained by a
    bucket boundary (the row's or a differing id's projection within
    1e-4 + 1e-6 |p| of an integer), ids equal at distinct distances and
    distances rtol 1e-5 atol 1e-6 elsewhere.  A checkout without it skips."""
    import torch
    from repro_torch.core import index as lidx
    from repro_torch.kernels import dispatch, ref
    if not hasattr(lidx, "query_index_batched"):
        log("  query_index_batched: not in this checkout")
        return
    gen = torch.Generator().manual_seed(23)
    cfg = lidx.IndexConfig(n_dims=64, n_tables=8, n_hashes=4,
                           log2_buckets=10, bucket_capacity=32, r=4.0)
    x = torch.randn((1024, 64), generator=gen) * 0.3
    q = x[torch.randint(0, 1024, (rows,), generator=gen)] + 0.01 * \
        torch.randn((rows, 64), generator=gen)
    fam = lidx.make_family(gen, cfg)
    st = lidx.build_index(lidx.create_index(cfg, 1024, family=fam,
                                            device="cuda"), cfg, x.cuda())
    before = dict(dispatch.launches)
    bi, bd = lidx.query_index_batched(st, cfg, q, k, n_probes=n_probes,
                                      batch_size=batch)
    chunks = -(-rows // batch)
    got = {n: dispatch.launches[n] - before[n]
           for n in ("hash_mm", "fused_query")}
    if got != {"hash_mm": chunks, "fused_query": chunks}:
        raise AssertionError(f"query_index_batched launched {got} for "
                             f"{chunks} chunks")
    oi, od = lidx.query_index(st, cfg, q, k, n_probes=n_probes)
    if not (torch.equal(bi, oi) and torch.equal(bd.view(torch.int32),
                                                od.view(torch.int32))):
        raise AssertionError("query_index_batched differs from one "
                             "query_index call over the same rows")
    st_c = lidx.build_index(lidx.create_index(cfg, 1024, family=fam,
                                              device="cpu"), cfg, x)
    pi, pd = lidx.query_index(st_c, cfg, q, k, n_probes=n_probes)
    bi, bd = bi.cpu(), bd.cpu()
    near = lambda v: near_boundary(ref.hash_mm_proj_ref(  # noqa: E731
        v, fam[0], fam[1], cfg.r)[1]).any(dim=-1)
    near_item = near(x)
    ok = ~near(q)
    for r in torch.nonzero((bi != pi).any(dim=1)).flatten().tolist():
        diff = set(bi[r].tolist()) ^ set(pi[r].tolist())
        if ok[r] and any(i >= 0 and bool(near_item[i]) for i in diff):
            ok[r] = False
    fin = torch.isfinite(pd[ok])
    if not torch.equal(fin, torch.isfinite(bd[ok])) or not torch.allclose(
            bd[ok][fin], pd[ok][fin], rtol=1e-5, atol=1e-6):
        raise AssertionError("query_index_batched: distances differ from "
                             "the plain path's")
    close = torch.isclose(pd[ok][:, 1:], pd[ok][:, :-1], rtol=1e-5, atol=0)
    distinct = torch.ones_like(fin)
    distinct[:, 1:] &= ~close
    distinct[:, :-1] &= ~close
    if not torch.equal(bi[ok][distinct], pi[ok][distinct]):
        raise AssertionError("query_index_batched: ids differ from the "
                             "plain path's at distinct distances")
    log(f"  query_index_batched: {rows} rows in {chunks} chunks of {batch} "
        f"on one 1,024-item segment: bit-equal to one query_index call, "
        f"K1 and K2 {chunks} launches each; vs the plain path: "
        f"{int((~ok).sum())} rows near a bucket boundary set aside, the "
        f"other {int(ok.sum())} equal")


# -- phase 4: CPU vs card parity ----------------------------------------------


def has_telemetry() -> bool:
    """Does this checkout have the port's telemetry (``repro_torch.obs``)?"""
    return (ROOT / "src" / "repro_torch" / "obs").is_dir()


def has_tenants() -> bool:
    """Does this checkout serve the l1-qmc and w2-quantile tenants (an
    earlier one has l2-basis only)?"""
    from repro_torch.launch import serve
    return hasattr(serve, "default_specs")


def tenant_spec(name="l2-basis", precision="fp32"):
    """The demo's spec of tenant ``name``."""
    from repro_torch.launch import serve
    if name == "l2-basis" and not has_tenants():
        return serve.default_spec(precision=precision)
    return {sp.name: sp for sp in serve.default_specs(
        precision=precision)}[name]


def probe_inputs(sv, rng, n):
    """n fresh inputs for ``sv.embed``: the tenant's own ingest (raw
    Gaussian draws for the Wasserstein tenant, three-sine functions at
    the nodes otherwise; the same draws as ``sample_fvals`` for a function
    tenant)."""
    from repro_torch.launch import serve
    if hasattr(serve, "sample_inputs"):
        return serve.sample_inputs(sv, rng, n)[0]
    return serve.sample_fvals(rng, sv.nodes(), n)


def near_boundary(p):
    """Projections that may floor either way in another summation order:
    |p - round(p)| <= 1e-4 + 1e-6 |p| (relative: a heavy-tailed alpha's
    projections reach 1e4, where an f32 ulp passes 1e-4)."""
    import torch
    return (p - torch.round(p)).abs() <= 1e-4 + 1e-6 * p.abs()


def parity_family(cfg, rng):
    """One numpy-drawn family for both devices: alpha normal at p = 2,
    Cauchy at p = 1."""
    L, K = cfg.n_tables, cfg.n_hashes
    shape = (cfg.n_dims, L * K)
    alpha = (rng.normal(size=shape) if cfg.p == 2.0
             else rng.standard_cauchy(size=shape))
    return (alpha.astype(np.float32),
            rng.uniform(size=(L * K,)).astype(np.float32),
            (rng.integers(0, 2 ** 31 - 1, size=(L, K)) | 1).astype(np.uint32))


def parity_run(name="l2-basis"):
    """Tenant ``name``'s pipeline at PARITY_ITEMS items on the CPU (plain
    versions) and on the card (kernels) with one injected family: rows
    whose gids differ must be explained by a boundary or a tie, equal ids
    must have close distances, and recall within 0.01.  Returns, for
    the function tenants, the card's K2 inputs of a 32- and a 128-row
    batch against a full sealed segment (the timings' real inputs)."""
    import torch
    from repro_torch import convert
    from repro_torch.core import index as lidx
    from repro_torch.kernels import ref
    from repro_torch.serve import Servable, recall_proxy

    spec = tenant_spec(name)
    cfg = spec.index_config()
    fam = parity_family(cfg, np.random.default_rng(1234))
    out = {}
    for dev in ("cpu", "cuda"):
        sv = Servable(spec, device=dev,
                      family=convert.family_from_numpy(*fam, device=dev))
        drng = np.random.default_rng(99)
        fvals = probe_inputs(sv, drng, PARITY_ITEMS)
        qf = probe_inputs(sv, drng, 64)
        emb = sv.embed(fvals)
        gids = sv.insert(emb)
        sv.delete(gids[::17])
        q = sv.embed(qf)
        q = (q + 0.05 * torch.as_tensor(
            drng.normal(size=tuple(q.shape)).astype(np.float32),
            device=q.device)).cpu().numpy()
        g, d = sv.query(q, 10, 4)
        rec = recall_proxy(sv.index, q, 10, n_probes=4)
        _, proj_items = ref.hash_mm_proj_ref(emb.cpu(), torch.as_tensor(
            fam[0]), torch.as_tensor(fam[1]), cfg.r)
        _, proj_q = ref.hash_mm_proj_ref(torch.as_tensor(q), torch.as_tensor(
            fam[0]), torch.as_tensor(fam[1]), cfg.r)
        out[dev] = dict(g=g, d=d, recall=rec, gids=gids, emb=emb.cpu(),
                        proj_items=proj_items, proj_q=proj_q,
                        segments=len(sv.index.segments))
        if dev == "cuda":
            # realistic K2 inputs for the timings: the candidates of a
            # 32-row micro-batch (the profiled batch) and of a 128-row one
            # (the serve loop's chunk) against a full sealed segment
            seg = sv.index.segments[0]
            q128 = sv.embed(probe_inputs(sv, np.random.default_rng(7), 128))
            out["k2_inputs"] = {}
            for rows, qq in ((32, torch.as_tensor(q[:32], device=q128.device)),
                             (128, q128)):
                h, pj = lidx.hash_stage(seg.state.alpha, seg.state.b, cfg,
                                        qq)
                bk = lidx.probe_stage(seg.state.mix, cfg, h, pj, 4)
                cands = lidx.gather_stage(seg.state.table, bk, cfg,
                                          seg.capacity, live_mask=seg.live)
                out["k2_inputs"][rows] = (qq.contiguous(), seg.state.db,
                                          cands.contiguous())
    cpu, gpu = out["cpu"], out["cuda"]
    emb_equal = torch.equal(cpu["emb"], gpu["emb"])
    near = lambda p: near_boundary(p).any(dim=-1)
    boundary_gids = set(cpu["gids"][near(cpu["proj_items"]).numpy()]
                        .tolist()) | set(
        gpu["gids"][near(gpu["proj_items"]).numpy()].tolist())
    q_boundary = (near(cpu["proj_q"]) | near(gpu["proj_q"])).numpy()
    mism = np.nonzero((cpu["g"] != gpu["g"]).any(axis=1))[0]
    why = {"query_boundary": 0, "item_boundary": 0, "tie": 0}
    for r in mism:
        diff = set(cpu["g"][r].tolist()) ^ set(gpu["g"][r].tolist())
        if q_boundary[r]:
            why["query_boundary"] += 1
        elif diff & boundary_gids:
            why["item_boundary"] += 1
        elif np.allclose(cpu["d"][r], gpu["d"][r], rtol=1e-5, atol=1e-6):
            why["tie"] += 1
        else:
            raise AssertionError(
                f"parity ({name}): query {r} differs without a boundary or "
                f"tie: cpu {cpu['g'][r]} / cuda {gpu['g'][r]}")
    fin = np.isfinite(cpu["d"]) & (cpu["g"] == gpu["g"])
    if not np.allclose(cpu["d"][fin], gpu["d"][fin], rtol=1e-5, atol=1e-6):
        raise AssertionError(f"parity ({name}): distances of equal ids "
                             "differ")
    if abs(cpu["recall"] - gpu["recall"]) > 0.01:
        raise AssertionError(f"parity ({name}): recall cpu {cpu['recall']} "
                             f"vs cuda {gpu['recall']}")
    n_bound = int(near_boundary(gpu["proj_items"]).sum())
    log(f"  parity {name} (p {cfg.p}) at {PARITY_ITEMS} items "
        f"({gpu['segments']} segments), 64 queries: {len(mism)} rows differ "
        f"{why}; {n_bound} item projections near a boundary; embeddings "
        f"{'bit-equal' if emb_equal else 'not bit-equal'} across devices; "
        f"recall@10 cpu {cpu['recall']:.4f} cuda {gpu['recall']:.4f}")
    if spec.embedder != "basis" and not emb_equal:
        raise AssertionError(f"parity ({name}): the {spec.embedder} embed "
                             "differs between the CPU and the card")
    return out["k2_inputs"]


def int8_parity_run():
    """The int8 tier at 8,192 items on the CPU and on the card, from one
    set of embeddings (embedded once on the CPU, so K4 is not in the
    comparison: phase 4's fp32 run covers it).  The gids must be equal.
    Also captures, from the card's run, a real K5 input (the sealed
    segments against a 128-row micro-batch: one launch over all of them,
    or in an earlier checkout one segment's) and a real K6 input (the
    survivor rows of that batch)."""
    import torch
    from repro_torch import convert
    from repro_torch.kernels import ops, quantize
    from repro_torch.launch.serve import default_spec, sample_fvals
    from repro_torch.serve import Servable

    spec = default_spec(precision="int8")
    cfg = spec.index_config()
    rng = np.random.default_rng(4321)
    L, K = cfg.n_tables, cfg.n_hashes
    fam = (rng.normal(size=(cfg.n_dims, L * K)).astype(np.float32),
           rng.uniform(size=(L * K,)).astype(np.float32),
           (rng.integers(0, 2 ** 31 - 1, size=(L, K)) | 1).astype(np.uint32))
    cpu_sv = Servable(spec, device="cpu",
                      family=convert.family_from_numpy(*fam, device="cpu"))
    drng = np.random.default_rng(77)
    nodes = cpu_sv.nodes()
    emb = cpu_sv.embed(sample_fvals(drng, nodes, PARITY_ITEMS)).numpy()
    q = cpu_sv.embed(sample_fvals(drng, nodes, 128)).numpy()
    q = q + 0.05 * drng.normal(size=q.shape).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        sv = cpu_sv if dev == "cpu" else Servable(
            spec, device=dev,
            family=convert.family_from_numpy(*fam, device=dev))
        gids = sv.insert(emb)
        sv.delete(gids[::17])
        out[dev] = sv.query(q[:64], 10, 4)
        out[dev + "_segments"] = len(sv.index.segments)
    (g_c, d_c), (g_g, d_g) = out["cpu"], out["cuda"]
    if not np.array_equal(g_c, g_g):
        rows = np.nonzero((g_c != g_g).any(axis=1))[0]
        raise AssertionError(f"int8 parity: gids differ in {len(rows)} of 64 "
                             f"queries, first {rows[:5].tolist()}")
    fin = np.isfinite(d_c)
    if not (np.array_equal(fin, np.isfinite(d_g))
            and np.allclose(d_c[fin], d_g[fin], rtol=1e-5, atol=1e-6)):
        raise AssertionError("int8 parity: distances of equal gids differ")
    log(f"  int8 parity at {PARITY_ITEMS} items ({out['cuda_segments']} "
        "segments), 64 queries: gids equal, distances rtol 1e-5")

    # capture one real K5 and one real K6 input from a 128-row batch
    captured = {}
    real_q, real_rs = ops.quantized_query_topk, quantize.rerank_survivors

    def grab_q(*a, **kw):
        captured.setdefault("k5", (a, kw))
        return real_q(*a, **kw)

    def grab_rs(*a, **kw):
        captured.setdefault("k6", (a, kw))
        return real_rs(*a, **kw)
    ops.quantized_query_topk, quantize.rerank_survivors = grab_q, grab_rs
    try:
        sv.index.query(torch.as_tensor(q, device="cuda"), 10, 4)
    finally:
        ops.quantized_query_topk, quantize.rerank_survivors = real_q, real_rs
    torch.cuda.synchronize()
    return captured


# -- phase 5: timings ---------------------------------------------------------


FLOOR_SRC = ROOT / "tools" / "launch_floor.cu"


def start_floor_build():
    """Start nvcc on the launch floor (tools/launch_floor.cu, an empty
    kernel behind K1's C interface) beside the kernels' own builds; None
    in a checkout without it."""
    from repro_torch.kernels import _build
    if not FLOOR_SRC.exists():
        return None
    out = ROOT / "build" / "launch_floor" / "launch_floor.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", str(out), str(FLOOR_SRC)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def finish_floor_build(job):
    """The floor's launcher, once nvcc is done; None without a floor."""
    import ctypes
    if job is None:
        return None
    proc, out = job
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc launch_floor:\n{text}")
    fn = ctypes.CDLL(str(out)).launch_floor_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, ctypes.c_float, i, i, i, i, i, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def launch_floor(fn, x, a, b, r):
    """The route's floor: K1's launcher arguments (pointers from
    data_ptr(), the stream from dispatch.stream_handle) through ctypes to
    an empty kernel, the return code checked -- what any wrapper pays
    before its checks, allocations and the kernel's own work."""
    import torch
    from repro_torch.kernels import dispatch
    if fn is None:
        log("  timing launch_floor: not in this checkout")
        return None
    m, n = x.shape
    k = a.shape[1]
    h = torch.empty((m, k), dtype=torch.int32, device=x.device)
    p = torch.empty((m, k), device=x.device)

    def call():
        code = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), r, m, n, k, 1,
                  1, h.data_ptr(), p.data_ptr(), dispatch.stream_handle(x))
        if code != 0:
            raise RuntimeError(f"launch_floor: CUDA error {code}")
    return dict(shape="empty kernel, 1 block of 32 threads, K1's 12 "
                "arguments, launched as K1", ms=time_ms(call),
                **host_times(call),
                bytes=0, ops=0)


FEW = dict(warmup=1, reps=3, replays=3)  # plain and library calls that
                                         # materialise gigabytes


def _k2_record(q, db, cands, kk, big=False, p=2.0):
    """K2 at one shape and metric (p 2 or 1); ``big``: a stacked launch,
    whose plain version and library call materialise (rows, C, 64) floats
    -- timed with FEW calls, and the library call's host times left
    out."""
    import torch
    from repro_torch.kernels import fused_query, ref
    nq, c = cands.shape
    valid = (cands >= 0) & (cands < db.shape[0])
    rows_needed = int(torch.unique(cands[valid]).numel())
    n_valid = int(valid.sum())
    few = FEW if big else {}

    def lib_fused():
        emb = db[cands.clamp(min=0).long()]
        dist = torch.linalg.vector_norm(emb - q[:, None, :], ord=p, dim=-1)
        dist = torch.where(cands < 0, torch.inf, dist)
        return torch.topk(dist, kk, largest=False)
    kw = {} if p == 2.0 else {"p": p}
    return dict(
        shape=f"q ({nq}, 64), db {tuple(db.shape)}, ids ({nq}, {c}), "
              f"k={kk}, p={p}; {n_valid} valid candidates, {rows_needed} "
              "rows",
        ms=time_ms(lambda: fused_query.fused_query_topk(q, db, cands, kk,
                                                        **kw)),
        **host_times(lambda: fused_query.fused_query_topk(q, db, cands, kk,
                                                          **kw)),
        plain_ms=time_ms(lambda: ref.fused_query_topk_ref(q, db, cands, kk,
                                                          **kw), **few),
        library_ms=time_ms(lib_fused, **few),
        **({} if big else host_times(lib_fused, "library_")),
        bytes=4 * (nq * 64 + nq * c + rows_needed * 64 + 2 * nq * kk),
        ops=3 * 64 * n_valid)


def _k5_record(qq, codes, scale, qids, kq, kw, big=False):
    """K5 at one shape, ``scale`` one f32 or one per segment of a stacked
    launch (``big``: as in _k2_record).  A checkout whose K5 takes one
    scale only gets no record for a stacked shape."""
    import torch
    from repro_torch.kernels import quantized_query, ref
    nq, c = qids.shape
    qval = (qids >= 0) & (qids < codes.shape[0])
    rows_needed = int(torch.unique(qids[qval]).numel())
    n_valid = int(qval.sum())
    few = FEW if big else {}
    srow = (scale if scale.numel() == 1 else scale.repeat_interleave(
        nq // scale.numel())[:, None])
    try:
        quantized_query.quantized_query_topk(qq, codes, scale, qids, kq, **kw)
    except ValueError as e:
        log(f"  timing quantized_query at q {tuple(qq.shape)}: refused here "
            f"({e})")
        return None

    def lib_quantized():
        qc = torch.round(qq / srow)
        rows = codes[qids.clamp(min=0).long()].float()
        dist = torch.linalg.vector_norm(rows - qc[:, None, :],
                                        ord=kw.get("p", 2.0), dim=-1)
        dist = torch.where(qids < 0, torch.inf, dist)
        dv, iv = torch.topk(dist, kq, largest=False)
        return dv * srow, iv
    return dict(
        shape=f"q ({nq}, 64), codes {tuple(codes.shape)} {codes.dtype}, ids "
              f"({nq}, {c}), k={kq}, {scale.numel()} scale(s); {n_valid} "
              f"valid candidates, {rows_needed} rows",
        ms=time_ms(lambda: quantized_query.quantized_query_topk(
            qq, codes, scale, qids, kq, **kw)),
        **host_times(lambda: quantized_query.quantized_query_topk(
            qq, codes, scale, qids, kq, **kw)),
        plain_ms=time_ms(lambda: ref.quantized_topk_ref(qq, codes, scale,
                                                        qids, kq, **kw),
                         **few),
        library_ms=time_ms(lib_quantized, **few),
        **({} if big else host_times(lib_quantized, "library_")),
        bytes=4 * (nq * 64 + nq * c + scale.numel() + 2 * nq * kq)
        + rows_needed * 64 * codes.element_size(),
        ops=3 * 64 * n_valid)


def _stacked(q, table, ids, n_seg, scale=None):
    """A real one-segment scorer input tiled into a stack of n_seg
    segments: the queries repeated, the table's rows repeated (for int8,
    each copy with its own scale, 1 + s % 5 times the segment's), the
    candidate rows offset into each copy -- the stacked launch's shape
    with the path's own candidate pattern in every segment."""
    import torch
    cap = table.shape[0]
    local = ids[None].expand(n_seg, *ids.shape)
    out = (q.repeat(n_seg, 1).contiguous(), table.repeat(n_seg, 1),
           flat_rows(local, cap))
    if scale is None:
        return out
    mult = 1 + torch.arange(n_seg, device=q.device) % 5
    return out + ((scale.reshape(()) * mult).to(torch.float32),)


def _fan_in(gen, rows, runs, k):
    """A fan-in pool: ``runs`` segments' ascending lists of k distances a
    row, ids a permutation shared by the rows."""
    import torch
    m = runs * k
    d = torch.rand((rows, runs, k), generator=gen).sort(dim=-1).values
    i = torch.randperm(4 * m, generator=gen)[:m].to(torch.int32)
    return d.reshape(rows, m).cuda(), i.repeat(rows, 1).cuda()


def _order_keys(d, i):
    """int64 keys whose signed order is the (distance, id) order: the
    float's bits with the magnitude flipped when negative, above id + 2^31."""
    import torch
    b = d.contiguous().view(torch.int32).long()
    hi = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    return hi * 2 ** 32 + (i.long() + 2 ** 31)


def _k3_record(d, i, n_out):
    """K3 at one shape: the kernel (the select route in checkouts that have
    it), the plain network, the two stable sorts kept as the yardstick
    since the first timings (``library_ms``) and one ``torch.topk`` on
    pre-built int64 keys (``library_topk_ms``, the same order).  Bound: the
    function's work whatever computes it, each pair read once and n_out
    written (8 bytes each), one compare a pair.  A checkout whose kernel
    refuses the shape (the network held <= 16,384 pairs) gets no record."""
    import torch
    from repro_torch.kernels import merge, ref
    rows, m = d.shape
    keys = _order_keys(d, i)

    def lib_sort():
        o = torch.sort(i, dim=-1, stable=True).indices
        d1 = torch.gather(d, 1, o)
        o2 = torch.sort(d1, dim=-1, stable=True).indices
        return torch.gather(d1, 1, o2), torch.gather(i, 1, o2)
    big = rows * ref.next_pow2(m) > 2 ** 20   # the plain network: >10 ms
    rec = dict(shape=f"({rows}, {m}) pairs, top {n_out}",
               bytes=8 * rows * m + 8 * rows * n_out, ops=rows * m)
    try:
        merge.sort_pairs_kernel(d, i, n_out=n_out)
    except ValueError as e:
        if hasattr(merge, "route"):
            raise
        log(f"  timing merge {rec['shape']}: refused here ({e})")
        return None
    rec.update(
        route=(merge.route(rows, m, n_out, 1) if hasattr(merge, "route")
               else "network"),
        ms=time_ms(lambda: merge.sort_pairs_kernel(d, i, n_out=n_out)),
        **host_times(lambda: merge.sort_pairs_kernel(d, i, n_out=n_out)),
        plain_ms=time_ms(lambda: ref.sort_pairs(d, i),
                         **(dict(warmup=1, reps=3, replays=3) if big
                            else {})),
        library_ms=time_ms(lib_sort),
        **host_times(lib_sort, "library_"),
        library_topk_ms=time_ms(lambda: torch.topk(
            keys, n_out, dim=-1, largest=False, sorted=True)))
    return rec


def timings(gen, k2_inputs, k5_inputs, k6_inputs, errs, floor_fn,
            k2_p1_inputs=None):
    import torch
    from repro_torch.embedders.basis import cheb_kernel_constants
    from repro_torch.kernels import (dct_mm, hash_mm, ops, ref, rerank,
                                     simhash_pack)

    rec = {}
    # K1 at a 32-row query micro-batch (the profiled batch), at the loop's
    # 128-row chunk and at the 256-row insert chunk: X (m, 64), A (64, 32)
    n, k, r = 64, 32, 4.0
    a = torch.randn((n, k), generator=gen).cuda()
    b = torch.rand((k,), generator=gen).cuda()
    for m in (32, 128, 256):
        x = torch.randn((m, n), generator=gen).cuda() * 0.5

        def lib_hash(x=x):
            pj = torch.matmul(x, a) / r + b
            return torch.floor(pj).to(torch.int32), pj
        rec["hash_mm" if m == 32 else f"hash_mm@{m}"] = dict(
            shape=f"X ({m}, {n}) @ A ({n}, {k})",
            ms=time_ms(lambda x=x: hash_mm.hash_mm(x, a, b, r)),
            **host_times(lambda x=x: hash_mm.hash_mm(x, a, b, r)),
            plain_ms=time_ms(lambda x=x: ref.hash_mm_proj_ref(x, a, b, r)),
            library_ms=time_ms(lib_hash),
            **host_times(lib_hash, "library_"),
            bytes=4 * (m * n + n * k + k + 2 * m * k),
            ops=2 * m * n * k + 2 * m * k)
        if m == 32:
            floor = launch_floor(floor_fn, x, a, b, r)
            if floor:
                rec["launch_floor"] = floor

    # K4 at one embed chunk: F (128, 64), Mt (64, 64)
    m = 128
    pre, mat, scale = (torch.as_tensor(t).cuda() for t in
                       cheb_kernel_constants(64, (-1.0, 1.0), "lebesgue"))
    f = torch.randn((m, 64), generator=gen).cuda()
    rec["dct_mm"] = dict(
        shape=f"F ({m}, 64) @ Mt (64, 64)",
        ms=time_ms(lambda: dct_mm.dct_mm(f, mat, scale)),
        **host_times(lambda: dct_mm.dct_mm(f, mat, scale)),
        plain_ms=time_ms(lambda: ref.dct_mm_ref(f, mat, scale)),
        library_ms=time_ms(lambda: torch.matmul(f, mat) * scale),
        **host_times(lambda: torch.matmul(f, mat) * scale, "library_"),
        bytes=4 * (m * 64 + 64 * 64 + 64 + m * 64),
        ops=2 * m * 64 * 64 + m * 64)

    # K2 at one segment of a 32-row (profiled) and a 128-row (the loop's
    # chunk) micro-batch, real candidates: the delta's launch; and the same
    # candidates tiled over STACK_SEGMENTS segments, the stacked launch
    kk = 10
    for rows, (q, db, cands) in sorted(k2_inputs.items()):
        rec["fused_query" if rows == 32 else f"fused_query@{rows}"] = \
            _k2_record(q, db, cands, kk)
        rec[f"fused_query@{rows * STACK_SEGMENTS}"] = _k2_record(
            *_stacked(q, db, cands, STACK_SEGMENTS), kk, big=True)
    # and at p = 1: the l1-qmc tenant's 32-row batch (Cauchy family, QMC
    # embedding) tiled over STACK_SEGMENTS segments
    if k2_p1_inputs is not None:
        q, db, cands = k2_p1_inputs[32]
        rec[f"fused_query@{32 * STACK_SEGMENTS}_p1"] = _k2_record(
            *_stacked(q, db, cands, STACK_SEGMENTS), kk, big=True, p=1.0)

    # K3 at the fp32 fan-in (257 segments x k = 10, a 32-row batch)
    rec["merge"] = _k3_record(*_fan_in(gen, 32, 257, kk), kk)
    # K5 at one sealed int8 segment of a 128-row micro-batch (real
    # candidates, k = kq = 40), and at its first 32 rows: candidates are per
    # row, so they are what a 32-row batch would gather
    (qq, codes, scale, qids, kq), kw = k5_inputs
    if scale.numel() > 1:
        # captured from a stacked launch: its first segment's rows
        n_seg = scale.numel()
        nq, cap = qq.shape[0] // n_seg, codes.shape[0] // n_seg
        qq, codes, scale, qids = (qq[:nq].contiguous(), codes[:cap],
                                  scale[0], qids[:nq].contiguous())
    rec["quantized_query"] = _k5_record(qq, codes, scale, qids, kq, kw)
    rec["quantized_query@32"] = _k5_record(
        qq[:32].contiguous(), codes, scale, qids[:32].contiguous(), kq, kw)
    # and tiled over STACK_SEGMENTS segments, one scale each
    for rows in (32, 128):
        qs, cs, ids, ss = _stacked(qq[:rows], codes,
                                   qids[:rows].contiguous(), STACK_SEGMENTS,
                                   scale)
        rec[f"quantized_query@{rows * STACK_SEGMENTS}"] = _k5_record(
            qs, cs, ss, ids, kq, kw, big=True)

    # K6 at the survivor rescore of that 128-row batch: (128, 40, 64)
    (rq, rrows, rgids, _), rkw = k6_inputs
    rq = rq.float().contiguous()
    rrows = rrows.float().contiguous()
    rgids = rgids.to(torch.int32).contiguous()
    b, c = rgids.shape
    r_valid = int((rgids >= 0).sum())

    def lib_rerank():
        dist = torch.linalg.vector_norm(rrows - rq[:, None, :], dim=-1)
        return torch.where(rgids < 0, torch.inf, dist)
    rec["rerank"] = dict(
        shape=f"q ({b}, 64), emb ({b}, {c}, 64), ids ({b}, {c}); "
              f"{r_valid} valid",
        ms=time_ms(lambda: rerank.rerank_distances(rq, rrows, rgids)),
        **host_times(lambda: rerank.rerank_distances(rq, rrows, rgids)),
        plain_ms=time_ms(lambda: ref.rerank_ref(rq, rrows, rgids)),
        library_ms=time_ms(lib_rerank),
        **host_times(lib_rerank, "library_"),
        bytes=4 * (b * 64 + r_valid * 64 + b * c + b * c),
        ops=3 * 64 * r_valid)

    # K7 at bench_hash_throughput's shape: X (512, 64) @ A (64, 1024)
    m, n, k = SIMHASH_BATCH, 64, SIMHASH_BITS
    x = torch.randn((m, n), generator=gen).cuda()
    a = torch.randn((n, k), generator=gen).cuda()
    shifts = torch.arange(32, device="cuda", dtype=torch.int64)

    def lib_simhash():
        bits_ = (torch.matmul(x, a) >= 0).to(torch.int64)
        words = (bits_.view(m, k // 32, 32) << shifts).sum(-1)
        return (words & 0xFFFFFFFF).to(torch.int32)
    rec["simhash_pack"] = dict(
        shape=f"X ({m}, {n}) @ A ({n}, {k}) -> ({m}, {k // 32}) words",
        ms=time_ms(lambda: simhash_pack.simhash_pack(x, a)),
        **host_times(lambda: simhash_pack.simhash_pack(x, a)),
        plain_ms=time_ms(lambda: ref.simhash_pack_ref(x, a)),
        library_ms=time_ms(lib_simhash),
        **host_times(lib_simhash, "library_"),
        bytes=4 * (m * n + n * k + m * k // 32),
        ops=2 * m * n * k)

    # K3 at the int8 fan-in (258 segments x kq = 40, a 128-row batch), at
    # 1,032 segments (past the 16,384 pairs the network held), and at the
    # survivor sort (K6's distances and gids of the captured batch, k = 10)
    rec["merge@int8"] = _k3_record(*_fan_in(gen, 128, 258, 40), 40)
    rec["merge@1032seg"] = _k3_record(*_fan_in(gen, 128, 1032, 40), 40)
    rd = rerank.rerank_distances(rq, rrows, rgids)
    rec["merge@survivors"] = _k3_record(rd, rgids, 10)
    # ops.merge_topk's host route at the fp32 fan-in: the wrapper's masking
    # and the launch(es), as the path calls it
    d, i = _fan_in(gen, 32, 257, kk)
    log("  timing " + json.dumps({
        "name": "merge_topk (ops, fp32 fan-in)",
        "shape": f"({d.shape[0]}, {d.shape[1]}) pairs, k {kk}",
        "ms": time_ms(lambda: ops.merge_topk(d, i, kk)),
        **host_times(lambda: ops.merge_topk(d, i, kk))}))

    rec = {name: t for name, t in rec.items() if t is not None}
    for name, t in rec.items():
        bms, by = bound_ms(t["bytes"], t["ops"])
        t.update(bound_ms=bms, bound_by=by,
                 max_abs_err=errs.get(name.split("@")[0]))
        log("  timing " + json.dumps({"name": name, **t}))
    return rec


# -- phases 6-7: where a micro-batch's time goes -----------------------------


def profile_batches(sv, n_batches=2, rows=32):
    """Trace ``n_batches`` micro-batches of ``rows`` queries through the
    filled index with torch.profiler: wall time, summed kernel time on the
    card (its busy share), launches, and the kernels that take the most.
    The Chrome trace (tens of MB) is parsed from build/ and deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import dispatch
    rng = np.random.default_rng(5)
    q = sv.embed(probe_inputs(sv, rng, rows)).cpu().numpy()
    sv.index.query(q, 10, 4)[0].cpu()
    # the int8 tier's host survivor gather, timed on the host clock
    gather_s, gather_in = [], []
    real_gather = sv.index._survivor_rows

    def timed_gather(g_np):
        gather_in.append(g_np.copy())
        t = time.perf_counter()
        out = real_gather(g_np)
        gather_s.append(time.perf_counter() - t)
        return out
    sv.index._survivor_rows = timed_gather
    torch.cuda.synchronize()
    before = dict(dispatch.launches)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_batches):
                sv.index.query(q, 10, 4)[0].cpu()
            wall = (time.perf_counter() - t0) / n_batches
    finally:
        del sv.index._survivor_rows
    launches = {k: (dispatch.launches[k] - before[k]) / n_batches
                for k in ("hash_mm", "fused_query", "quantized_query",
                          "merge", "rerank")}
    # the gather again on the last batch's survivors, profiler off: the
    # median of 20 calls
    unprofiled = []
    for _ in range(20 if gather_in else 0):
        g_np = gather_in[-1].copy()
        t = time.perf_counter()
        real_gather(g_np)
        unprofiled.append(time.perf_counter() - t)
    path = ROOT / "build" / "main_batch_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()
    kern = [e for e in events if e.get("cat") == "kernel"]
    busy_us = sum(e.get("dur", 0) for e in kern) / n_batches
    by_name: dict = {}
    for e in kern:
        by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # K2 is row_topk_kernel<float, ...>, K5 the int8/bf16 instantiations
    scorer = {"fused_query": 0.0, "quantized_query": 0.0}
    for e in kern:
        if "row_topk_kernel" in e["name"]:
            which = ("fused_query" if "row_topk_kernel<float" in e["name"]
                     else "quantized_query")
            scorer[which] += e["dur"] / 1e3 / n_batches
    # K1 and K4 are small_gemm_kernel (or, before it, gemm_epilogue_kernel)
    # with the hash or the scale epilogue
    gemms = {"hash_mm": 0.0, "dct_mm": 0.0}
    for e in kern:
        for name, epi in (("hash_mm", "HashEpilogue"),
                          ("dct_mm", "ScaleEpilogue")):
            if epi in e["name"]:
                gemms[name] += e["dur"] / 1e3 / n_batches
    # K3 is select_kernel (its select route) or bitonic_kernel (the network,
    # the only K3 of earlier checkouts), K6 rerank_kernel
    tail = {"merge": 0.0, "rerank": 0.0}
    for e in kern:
        for name, tags in (("merge", ("select_kernel", "bitonic_kernel")),
                           ("rerank", ("rerank_kernel",))):
            if any(t in e["name"] for t in tags):
                tail[name] += e["dur"] / 1e3 / n_batches
    res = {"rows": rows, "segments": len(sv.index.segments),
           "wall_ms": wall * 1e3,
           "kernel_ms": busy_us / 1e3 if kern else "not measured",
           "kernels_per_batch": len(kern) / n_batches,
           "launches_per_batch": launches,
           "stack": (sv.index.layout() if hasattr(sv.index, "layout")
                     else None),
           "survivor_gather_ms_per_batch": (sum(gather_s) * 1e3 / n_batches
                                            if gather_s else None),
           "survivor_gather_ms_unprofiled": (
               statistics.median(unprofiled) * 1e3 if unprofiled else None),
           "busy_share": busy_us / 1e6 / wall if kern else "not measured",
           "scorer_ms_per_batch": scorer,
           "hash_dct_ms_per_batch": gemms,
           "merge_rerank_ms_per_batch": tail,
           "top_kernels_ms_per_batch": {k: v / 1e3 / n_batches
                                        for k, v in top}}
    log("  profile " + json.dumps(res))
    return res


# -- phases 6-7: the paths ---------------------------------------------------


def drive(fn, card, smi, path, what):
    """Run ``fn`` with every launch count set to 0 just before and read
    just after; raise unless each kernel of ``path`` launched."""
    import torch
    from repro_torch.kernels import dispatch
    torch.cuda.synchronize()
    dispatch.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(dispatch.launches)
    reports = (out if isinstance(out, dict) and all(
        isinstance(v, dict) and "qps" in v for v in out.values()) else {})
    for name, rep in reports.items():
        log(f"  [{card}, {smi.split(',')[-1].strip()}] {name} " + json.dumps(
            {k: rep[k] for k in (
                "ingest_rows_per_s", "qps", "p50_ms", "p95_ms",
                "recall_at_k", "self_hit_rate", "held_frac", "n_segments",
                "n_live", "store_bytes_per_item", "rerank_survivor_frac",
                "max_memory_allocated", "unique_shapes")}))
    log(f"  launches on the {what}: " + json.dumps(counts))
    missing = [k for k in path if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{what} never launched {missing}")
    return counts, out


def check_report(report, tier):
    if report["n_segments"] < MAIN_ITEMS // 1024 + 1:
        raise AssertionError(f"{tier}: expected >= {MAIN_ITEMS // 1024} "
                             f"sealed segments + the delta, got "
                             f"{report['n_segments']}")
    if report["self_hit_rate"] < 0.95:
        raise AssertionError(f"{tier}: self-hit rate "
                             f"{report['self_hit_rate']}")
    if not 0.0 <= report["recall_at_k"] <= 1.0:
        raise AssertionError(f"{tier}: recall {report['recall_at_k']}")


def compare_tiers(sv32, sv8, when, n_probe=64, k=10):
    """Both tenants hold the same items (one seed); the same 64 probes
    through each: recall@10 of the int8 answer against the fp32 answer,
    and the sealed store's bytes per item."""
    rng = np.random.default_rng(2024)
    probes = sv32.embed(probe_inputs(sv32, rng, n_probe)).cpu()
    probes = probes.numpy()
    g32, _ = sv32.query(probes, k, 4)
    g8, _ = sv8.query(probes, k, 4)
    hits = [len(set(a[a >= 0]) & set(b[b >= 0])) / max(1, (b >= 0).sum())
            for a, b in zip(g8, g32)]
    recall = float(np.mean(hits))
    b32 = sv32.index.store_bytes_per_item()
    b8 = sv8.index.store_bytes_per_item()
    ratio = b8 / b32
    log(f"  tiers ({when}) " + json.dumps({
        "int8_recall_at_10_vs_fp32": recall,
        "store_bytes_per_item_fp32": b32, "store_bytes_per_item_int8": b8,
        "store_ratio": ratio, "probes": n_probe}))
    if ratio > 1.0 / 3.0:
        raise AssertionError(f"int8 sealed store is {ratio:.3f} of fp32's "
                             f"({when})")
    if recall < 0.98:
        raise AssertionError(f"int8 recall@10 vs fp32 {recall:.4f} < 0.98 "
                             f"({when})")


def answer(idx, b):
    """One query of ``idx`` (k 10, 4 probes): (gids, distance bits) on the
    host."""
    g, d = idx.query(b, 10, 4)
    return g.cpu().numpy(), d.cpu().numpy().view(np.int32)


def same(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def fanout_equal(idx, probes, n_probe, tier):
    """The stacked query against the per-segment fan-out, bit for bit, on
    the first ``n_probe`` probes as 32-row batches and on 128 probes as
    one batch."""
    for rows, b in [(32, probes[s:s + 32]) for s in range(0, n_probe, 32)
                    ] + [(128, probes[:128])]:
        g, d = idx._query_fanout(b, 10, 4)
        if not same(answer(idx, b), (g.cpu().numpy(),
                                     d.cpu().numpy().view(np.int32))):
            raise AssertionError(f"stacked parity ({tier}, {rows} rows): "
                                 "the stacked query differs from the "
                                 "per-segment fan-out")


def stacked_parity(sv, prof, tier, n_probe=64):
    """The stacked query (``SegmentedIndex.query``) against the per-segment
    fan-out (``_query_fanout``) on the filled index, bit for bit (gids and
    distance bits): ``n_probe`` fresh probe functions as two 32-row
    batches, and one 128-row batch of those and ``n_probe`` more.  Then
    the profile's launches: K1 once a batch, K2 + K5 at most twice.  A
    checkout without the stacked engine (an earlier commit) skips both."""
    idx = sv.index
    if not hasattr(idx, "_query_fanout"):
        log(f"  stacked parity ({tier}): no stacked engine in this checkout")
        return
    rng = np.random.default_rng(31)
    probes = sv.embed(probe_inputs(sv, rng, 2 * n_probe)).cpu()
    fanout_equal(idx, probes.numpy(), n_probe, tier)
    per = prof["launches_per_batch"]
    if per["hash_mm"] != 1 or per["fused_query"] + per[
            "quantized_query"] > 2:
        raise AssertionError(f"stacked engine ({tier}): launches per batch "
                             f"{per}")
    log(f"  stacked parity ({tier}, {len(idx.segments)} segments): "
        f"{n_probe} probes in 32-row batches and {2 * n_probe} in a 128-row "
        "batch, gids and distance bits equal to the per-segment fan-out; "
        f"launches per profiled batch {per}")

# -- phase 11: telemetry -----------------------------------------------------


TELEMETRY_STAGES = ("hash", "probe", "gather", "rerank", "merge")
TELEMETRY_BATCHES = ((32, 20), (128, 5))     # (rows, batches), deep-traced
# catalog metrics only a multi-device serve emits (device wins per mesh
# device): the one required metric a one-device run cannot export
DEVICE_ONLY = {"serve_device_wins_total"}


def telemetry_phase(sv, card, smi):
    """Phase 11, on phase 6's fp32 tenant: ``configure(sample_rate=1.0,
    deep=True)`` (restored after), then the deep-traced batches of
    TELEMETRY_BATCHES through the tenant's batcher, each bit-equal (gids
    and distance bits) to ``_query_stacked`` on the same rows; the median
    microseconds of each stage span and of the batch span; the stage spans
    must cover >= 90% of their parent batch spans (summed over the phase's
    batches; each batch size's share is reported too);
    then a WAL-backed tenant's insert and snapshot, and an ``Exporter``
    flushed into a temporary directory, every line validated against the
    port's ``CATALOG`` (name, type, label keys) and every required metric
    present but the multi-device ones.  Returns the numbers."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.obs import CATALOG, Exporter, configure, tracer
    from repro_torch.serve import ServableRegistry
    idx = sv.index
    rng = np.random.default_rng(11)
    batches = [sv.embed(probe_inputs(sv, rng, rows)).cpu().numpy()
               for rows, n in TELEMETRY_BATCHES for _ in range(n)]
    tr = tracer()
    saved = (tr.sample_rate, tr.deep)
    tr.drain()
    answers = []
    try:
        configure(sample_rate=1.0, deep=True)
        for q in batches:
            fut = sv.submit_query(q, 10, 4)
            sv.batcher.flush_all()
            answers.append(fut.result())
    finally:
        configure(sample_rate=saved[0], deep=saved[1])
        spans = [x for x in tr.drain()
                 if x["attrs"].get("tenant") == sv.spec.name]
    for q, (g, d) in zip(batches, answers):
        with idx._lock:
            wg, wd = idx._query_stacked(torch.as_tensor(q, device="cuda"),
                                        10, 4)
        if not same((g, d.view(np.int32)), (wg.cpu().numpy(),
                                            wd.cpu().numpy().view(np.int32))):
            raise AssertionError(f"telemetry: a staged {q.shape[0]}-row "
                                 "batch differs from _query_stacked")
    dur = lambda x: (x["t1"] - x["t0"]) * 1e6  # noqa: E731  (us)
    kids: dict = {}
    for x in spans:
        if x["name"] in TELEMETRY_STAGES:
            kids.setdefault(x["parent_id"], []).append(x)
    res = {"tenant": sv.spec.name, "items": idx.n_live,
           "segments": len(idx.segments)}
    for rows, n in TELEMETRY_BATCHES:
        bs = [x for x in spans if x["name"] == "batch"
              and x["attrs"]["rows_real"] == rows]
        if len(bs) != n or any(sorted(c["name"] for c in kids.get(
                b["span_id"], ())) != sorted(TELEMETRY_STAGES) for b in bs):
            raise AssertionError(f"telemetry: {len(bs)} {rows}-row batch "
                                 f"spans, want {n} each with one span per "
                                 "stage")
        fracs = [sum(dur(c) for c in kids[b["span_id"]]) / dur(b)
                 for b in bs]
        first = lambda b: min(c["t0"] for c in kids[b["span_id"]])  # noqa
        last = lambda b: max(c["t1"] for c in kids[b["span_id"]])  # noqa
        cover = sum(sum(dur(c) for c in kids[b["span_id"]]) for b in bs) / \
            sum(dur(b) for b in bs)
        res[f"{rows}_rows"] = {
            "batches": n,
            "median_us": {
                **{st: statistics.median(
                    dur(c) for b in bs for c in kids[b["span_id"]]
                    if c["name"] == st) for st in TELEMETRY_STAGES},
                "batch": statistics.median(dur(b) for b in bs)},
            "stage_cover": cover, "stage_cover_min": min(fracs),
            "stage_cover_median": statistics.median(fracs),
            # the batch span's time outside its stages: before the first,
            # after the last
            "before_stages_us": statistics.median(
                (first(b) - b["t0"]) * 1e6 for b in bs),
            "after_stages_us": statistics.median(
                (b["t1"] - last(b)) * 1e6 for b in bs)}
    batch_spans = [x for x in spans if x["name"] == "batch"]
    res["stage_cover"] = sum(
        sum(dur(c) for c in kids[b["span_id"]]) for b in batch_spans) / \
        sum(dur(b) for b in batch_spans)
    log(f"  [{card}, {smi.split(',')[-1].strip()}] telemetry spans "
        + json.dumps(res))
    if res["stage_cover"] < 0.90:
        raise AssertionError(f"telemetry: stage spans cover "
                             f"{res['stage_cover']:.1%} of their batch "
                             "spans (< 90%)")
    with tempfile.TemporaryDirectory(prefix="telemetry-") as tmp:
        reg = ServableRegistry(device="cuda", wal_dir=f"{tmp}/wal")
        small = reg.register(dataclasses.replace(tenant_spec("l2-basis"),
                                                 name="telemetry-wal"))
        small.insert(small.embed(probe_inputs(small, rng, 512)))
        reg.snapshot(f"{tmp}/ckpt", step=1)
        exp = Exporter.for_directory(f"{tmp}/metrics")
        exp.flush()
        exp.close()
        lines = [json.loads(x) for x in
                 Path(f"{tmp}/metrics/metrics.jsonl").read_text()
                 .splitlines()]
    seen, bad = set(), []
    for x in lines:
        if x["kind"] != "metric":
            continue
        spec = CATALOG.get(x["name"])
        if spec is None or x["type"] != spec.type or sorted(
                x["labels"]) != sorted(spec.labels) or (
                ("count" not in x) if spec.type == "histogram"
                else ("value" not in x)):
            bad.append(x)
        seen.add(x["name"])
    missing = sorted(n for n, sp in CATALOG.items()
                     if sp.required and n not in seen | DEVICE_ONLY)
    if bad or missing:
        raise AssertionError(f"telemetry export: {len(bad)} lines off the "
                             f"catalog (first {bad[:1]}), required metrics "
                             f"missing {missing}")
    res["export"] = {"lines": len(lines), "metrics": len(seen),
                     "required_missing_device_only": sorted(DEVICE_ONLY)}
    log(f"  [{card}, {smi.split(',')[-1].strip()}] telemetry "
        + json.dumps(res))
    return res


# -- phase 8: compaction ------------------------------------------------------


COMPACT_DELETE_FRAC = 0.35    # above launch.serve's compact_at of 0.3
COMPACT_STREAM = 50           # 32-row batches timed before and after


def stream_batches(idx, batches, n):
    """``n`` queries, the 32-row batches in turn, each ending in its copy
    to the host: (answers, host-clock seconds of each)."""
    out, secs = [], []
    for i in range(n):
        t = time.perf_counter()
        out.append(answer(idx, batches[i % len(batches)]))
        secs.append(time.perf_counter() - t)
    return out, secs


def batch_rate(secs, rows=32) -> dict:
    return {"p50_ms": statistics.median(secs) * 1e3 if secs else None,
            "qps": rows * len(secs) / sum(secs) if secs else None,
            "batches": len(secs)}


def stacked_scorer_record(idx, b):
    """K2 (fp32) or K5 (int8) at the stacked launch that one query of
    ``b`` through ``idx`` makes, on the inputs that launch got (its p
    too): card,
    plain and library times and the bound, as phase 5's records.  The
    launches made to time it are taken back out of the counts."""
    from repro_torch.kernels import dispatch, ops
    name = ("fused_query_topk" if idx.precision == "fp32"
            else "quantized_query_topk")
    real, seen = getattr(ops, name), []

    def grab(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)
    setattr(ops, name, grab)
    try:
        idx.query(b, 10, 4)
    finally:
        setattr(ops, name, real)
    a, kw = max(seen, key=lambda s: s[0][0].shape[0])   # the most rows
    counts = dict(dispatch.launches)
    if idx.precision == "fp32":
        t = _k2_record(*a, big=True, p=kw.get("p", 2.0))
    else:
        t = _k5_record(*a, kw, big=True)
    for k, v in counts.items():          # (Counter.update would add)
        dispatch.launches[k] = v
    t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["ops"])
    return t


def pick_victims(sv):
    """``COMPACT_DELETE_FRAC`` of the tenant's live gids, drawn from a
    seeded numpy generator."""
    gids = sv.index.live_items()[1].cpu().numpy()
    rng = np.random.default_rng(18)
    return np.sort(rng.choice(gids, size=int(COMPACT_DELETE_FRAC *
                                             gids.size), replace=False))


def compaction_phase(reg, tier, victims, prof_before):
    """Delete ``victims`` from the registry's l2-basis tenant, seal, then
    compact it on a ``MaintenancePool`` worker while this thread streams
    32-row batches; check the answers during and after the job (see the
    module docstring, phase 8) and return the phase's numbers."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import sample_fvals, self_hit_rate
    from repro_torch.serve import MaintenancePool, SegmentedIndex
    from repro_torch.serve.stats import recall_proxy
    sv = reg.get("l2-basis")
    idx = sv.index
    n_deleted = sv.delete(victims)
    rng = np.random.default_rng(41)
    probes = sv.embed(sample_fvals(rng, sv.nodes(), 128)).cpu().numpy()
    batches = [probes[:32], probes[32:64]]
    # timed while the index still has a partial delta, as it has after
    _, before_s = stream_batches(idx, batches, COMPACT_STREAM)
    # the freeze's seal is then a no-op, so the job shows two states only
    sv.maintenance.seal()
    emb_pre, gid_pre = idx.live_items()
    n_live = gid_pre.shape[0]
    rows_pre = (idx._survivor_rows(gid_pre.cpu().numpy()[None].copy())
                if tier == "int8" else None)
    lay_pre, seg_pre = idx.layout(), len(idx.segments)
    pre = [answer(idx, b) for b in batches]
    scorer_pre = stacked_scorer_record(idx, batches[0])

    phase_s = {}

    def timed(name):
        fn = getattr(idx, name)

        def call(*a):
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            phase_s[name.removeprefix("_compact_")] = time.perf_counter() - t
            return out
        return call
    for name in ("_compact_freeze", "_compact_build", "_compact_swap"):
        setattr(idx, name, timed(name))
    torch.cuda.synchronize()
    mem_pre = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k1_pre = dispatch.launches["hash_mm"]
    during, during_s = [], []
    pool = MaintenancePool(reg, workers=1)
    try:
        job = pool.submit("l2-basis", "compact")
        while pool.status(job)["status"] in ("queued", "running"):
            t = time.perf_counter()
            during.append(answer(idx, batches[len(during) % 2]))
            during_s.append(time.perf_counter() - t)
        st = pool.wait(job, timeout_s=600.0)
    finally:
        pool.stop(timeout_s=600.0)
        for name in ("_compact_freeze", "_compact_build", "_compact_swap"):
            delattr(idx, name)
    if st["status"] != "done":
        raise AssertionError(f"compaction ({tier}) failed: {st['error']}\n"
                             f"{st['traceback']}")
    torch.cuda.synchronize()
    k1_build = dispatch.launches["hash_mm"] - k1_pre - len(during)
    peak, mem_post = torch.cuda.max_memory_allocated(), \
        torch.cuda.memory_allocated()
    post = [answer(idx, b) for b in batches]
    torn = [i for i, a in enumerate(during)
            if not (same(a, pre[i % 2]) or same(a, post[i % 2]))]
    if torn:
        raise AssertionError(f"compaction ({tier}): {len(torn)} of "
                             f"{len(during)} answers during the job equal "
                             "neither the answer before it nor after it")
    _, after_s = stream_batches(idx, batches, COMPACT_STREAM)

    lay = idx.layout()
    if not idx.n_items == idx.n_live == n_live:
        raise AssertionError(f"compaction ({tier}): n_items {idx.n_items}, "
                             f"n_live {idx.n_live}, want {n_live}")
    if len(idx.segments) != -(-n_live // idx.segment_capacity) or \
            lay["n_sealed"] != len(idx.segments) - 1:
        raise AssertionError(f"compaction ({tier}): {len(idx.segments)} "
                             f"segments, layout {lay}, for {n_live} items")
    fanout_equal(idx, probes, 64, f"{tier}, compacted")
    # an index filled with the same live items in gid order
    oracle = SegmentedIndex(idx.cfg, segment_capacity=idx.segment_capacity,
                            insert_chunk=idx.insert_chunk, family=idx.family,
                            precision=idx.precision,
                            survivor_k=idx.survivor_k, device=idx.device)
    order = torch.argsort(gid_pre, stable=True)
    oracle.insert(emb_pre[order], gids=gid_pre[order].cpu().numpy())
    for b in batches + [probes]:
        if not same(answer(idx, b), answer(oracle, b)):
            raise AssertionError(f"compaction ({tier}): answers differ from "
                                 "an index filled in gid order")
    del oracle
    if rows_pre is not None:
        g_np = gid_pre.cpu().numpy()[None].copy()
        rows_post = idx._survivor_rows(g_np)
        if not (np.array_equal(g_np[0], gid_pre.cpu().numpy()) and
                np.array_equal(rows_post.view(np.int32),
                               rows_pre.view(np.int32))):
            raise AssertionError(f"compaction ({tier}): the kept items' "
                                 "survivor rows changed")
    self_hit = self_hit_rate(sv, 10, 4, 64)
    if self_hit < 0.95:
        raise AssertionError(f"compaction ({tier}): self-hit {self_hit}")
    recall = recall_proxy(idx, probes[:64], 10, n_probes=4)
    prof = profile_batches(sv)
    scorer_post = stacked_scorer_record(idx, batches[0])
    res = {
        "tier": tier, "deleted": n_deleted, "n_live": n_live,
        "segments_before": seg_pre, "segments_after": len(idx.segments),
        "freeze_ms": phase_s["freeze"] * 1e3,
        "build_ms": phase_s["build"] * 1e3, "swap_ms": phase_s["swap"] * 1e3,
        "build_rows_per_s": n_live / phase_s["build"],
        "k1_launches_in_build": k1_build,
        "s_cap_before": lay_pre["s_cap"], "s_cap_after": lay["s_cap"],
        "stack_bytes_before": lay_pre["bytes"],
        "stack_bytes_after": lay["bytes"],
        "memory_before": mem_pre, "peak_memory": peak,
        "memory_after_swap": mem_post,
        "before": batch_rate(before_s), "during": batch_rate(during_s),
        "after": batch_rate(after_s),
        "stacked_rows_per_batch_before": lay_pre["n_sealed"] * 32,
        "stacked_rows_per_batch_after": lay["n_sealed"] * 32,
        "scorer_ms_per_batch_before": prof_before["scorer_ms_per_batch"],
        "scorer_ms_per_batch_after": prof["scorer_ms_per_batch"],
        "stacked_scorer_before": scorer_pre,
        "stacked_scorer_after": scorer_post,
        "pre_equals_post": all(same(a, b) for a, b in zip(pre, post)),
        "recall_at_10": recall, "self_hit_rate": self_hit}
    log("  compaction " + json.dumps(res))
    return res


def simhash_path(sv, batch=SIMHASH_BATCH, bits_=SIMHASH_BITS):
    """``SimHash.__call__`` (the family bench_hash_throughput hashes with),
    drawn on the card from seed 7, over every live item of the tenant in
    512-row batches, 1024 bits: one K7 launch a batch.  The first batch's
    words must equal the kernel's fmaf chain and, away from |proj| < 1e-5,
    the plain version's."""
    import torch
    from repro_torch.core.hashes import SimHash
    from repro_torch.kernels import ref
    emb, _ = sv.index.live_items()
    fam = SimHash.create(torch.Generator("cuda").manual_seed(7),
                         emb.shape[1], bits_)
    sigs = [fam(emb[s:s + batch]) for s in range(0, emb.shape[0], batch)]
    sig = torch.cat(sigs)
    first = emb[:batch].contiguous()
    want = ref.simhash_pack_ref(first, fam.alpha)
    near = ((first.double() @ fam.alpha.double()).abs() < 1e-5).any()
    if not torch.equal(sig[:batch], ref.simhash_pack_chain_ref(
            first, fam.alpha)):
        raise AssertionError("simhash path: first batch differs from the "
                             "kernel's fmaf chain")
    if not (torch.equal(sig[:batch], want) or bool(near)):
        raise AssertionError("simhash path: first batch differs from the "
                             "plain version")
    log(f"  simhash path: {emb.shape[0]} items -> {tuple(sig.shape)} words "
        f"in {len(sigs)} launches")
    return sig


def serve_run(tenants, **kw):
    """``launch.serve.run`` of ``tenants``, its report per tenant (a
    checkout before the three tenants serves l2-basis alone and reports
    it flat)."""
    import inspect

    from repro_torch.launch import serve
    if "tenants" in inspect.signature(serve.run).parameters:
        return serve.run(tenants=tenants, **kw)
    if tuple(tenants) != ("l2-basis",):
        raise AssertionError(f"this checkout serves l2-basis only, not "
                             f"{tenants}")
    return {"l2-basis": serve.run(**kw)}


# -- phase 12: the network front end ----------------------------------------


FE_STREAMS, FE_REQUESTS, FE_ROWS = 16, 64, 8   # the demo's request shape
FE_K, FE_PROBES = 10, 4
FE_INGEST, FE_FRAME = 65536, 1024             # the wire-loaded tenant
FE_MAINT_STREAMS = 4
FE_PALETTE = (8, 16, 64, 128)                 # the update's new palette
FE_OVERLOAD = (32, 16)                        # connections x requests
FE_DRAIN_ROWS, FE_DRAIN_STREAMS = 16384, 8
FE_SERIES = ("frontend_requests_total", "frontend_rejects_total",
             "frontend_inflight", "frontend_queue_depth",
             "frontend_request_latency_s", "frontend_connections_total",
             "tenant_lifecycle_transitions_total")


def has_frontend() -> bool:
    """Does this checkout have the port's network front end?"""
    return (ROOT / "src" / "repro_torch" / "serve" / "frontend.py").is_file()


def on_threads(n, work, timeout_s=600.0):
    """``work(i)`` for i < n, each on its own thread, all at once: (the
    results by i, the wall seconds); raises the first failure."""
    import threading
    out, errors = [None] * n, []

    def run(i):
        try:
            out[i] = work(i)
        except BaseException as e:     # noqa: BLE001 -- raised below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"front end: a stream ran past {timeout_s}s")
    if errors:
        raise errors[0]
    return out, wall


def latency(secs, wall, rows) -> dict:
    """Request rate, rows/s and p50 / p95 / p99 of per-request seconds."""
    cuts = statistics.quantiles(secs, n=100, method="inclusive")
    return {"requests": len(secs), "wall_s": wall,
            "requests_per_s": len(secs) / wall,
            "rows_per_s": len(secs) * rows / wall,
            "p50_ms": cuts[49] * 1e3, "p95_ms": cuts[94] * 1e3,
            "p99_ms": cuts[98] * 1e3}


def bits_of(g, d):
    return np.asarray(g), np.asarray(d, np.float32).view(np.int32)


def stacked_answer(idx, q):
    """The direct answer to rows ``q`` (k 10, 4 probes), (gids, distance
    bits) on the host: ``_query_stacked`` at fp32, as phase 11; on a
    quantized tier ``query`` itself, whose stage 1 is the stacked query
    and stage 2 the exact survivor rescore."""
    import torch
    if idx.precision != "fp32":
        g, d = idx.query(q, FE_K, FE_PROBES)
    else:
        with idx._lock:
            g, d = idx._query_stacked(torch.as_tensor(q, device=idx.device),
                                      FE_K, FE_PROBES)
    return g.cpu().numpy(), d.cpu().numpy().view(np.int32)


def sync_memory(dev):
    """Collect garbage, sync the card and read its allocated bytes (None
    on the CPU)."""
    import gc

    import torch
    gc.collect()
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev)


def kernels_in(dev, fn):
    """Kernels on the card during ``fn()``, counted from a profiled window
    that lost no kernel record (``repro_torch.launch.profiled``); None on
    the CPU or in a checkout without that module."""
    if dev.type != "cuda":
        fn()
        return None
    try:
        from repro_torch.launch.profiled import card_kernels
    except ImportError:
        fn()
        return None
    return card_kernels(fn, dev)


def wire_streams(host, port, tenant, reqs):
    """Each stream i sends its requests ``reqs[i]`` in turn on its own
    connection: (answers, per-request seconds on the client clock, wall)."""
    from repro_torch.serve import FrontendClient

    def work(i):
        answers, secs = [], []
        with FrontendClient(host, port, timeout_s=120.0) as c:
            for q in reqs[i]:
                t = time.perf_counter()
                g, d = c.query_arrays(tenant, q, k=FE_K, n_probes=FE_PROBES)
                secs.append(time.perf_counter() - t)
                answers.append(bits_of(g, d))
        return answers, secs
    out, wall = on_threads(len(reqs), work)
    return ([a for a, _ in out], [s for _, ss in out for s in ss], wall)


def wire_client(job: dict) -> int:
    """``chip_smoke.py --wire-client JOB``: the wire streams of
    ``job["rows"]`` (an .npy of (streams, requests, rows, N)) from a
    process of their own, answers and client-clock seconds saved to
    ``job["out"]``."""
    reqs = np.load(job["rows"])
    answers, secs, wall = wire_streams(job["host"], job["port"],
                                       job["tenant"], reqs)
    np.savez(job["out"], gids=np.array([[a[0] for a in s] for s in answers]),
             dist_bits=np.array([[a[1] for a in s] for s in answers]),
             secs=np.array(secs), wall=np.array(wall))
    return 0


def client_process_streams(srv, tenant, reqs):
    """:func:`wire_streams` run by a child process (``--wire-client``), so
    the clients' Python time shares no interpreter lock with the server's
    loop and pump threads: (answers, seconds, wall)."""
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="wire-client-",
                                     dir=ROOT / "build") as tmp:
        job = {"host": srv.host, "port": srv.port, "tenant": tenant,
               "rows": f"{tmp}/rows.npy", "out": f"{tmp}/out.npz"}
        np.save(job["rows"], reqs)
        p = run_child(job, "--wire-client")
        if p.returncode != 0:
            raise AssertionError(f"front end: the client process exited "
                                 f"{p.returncode}: {p.stderr[-2000:]}")
        z = np.load(job["out"])
        answers = [[(z["gids"][i, j], z["dist_bits"][i, j])
                    for j in range(reqs.shape[1])]
                   for i in range(reqs.shape[0])]
        return answers, z["secs"].tolist(), float(z["wall"])


def codec_us(q, g, d, reps=200) -> dict:
    """Host µs per request of the wire's JSON work for one request of rows
    ``q`` answered (g, d): the client's encode, the server's decode (with
    its float32 array), the server's encode of the answer, the client's
    decode of it; medians of ``reps`` calls."""
    from repro_torch.serve import protocol

    def med(fn):
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t)
        return statistics.median(ts) * 1e6
    req = protocol.encode({"id": 1, "op": "query", "tenant": "l2-basis",
                           "queries": np.asarray(q, np.float32).tolist(),
                           "k": FE_K, "n_probes": FE_PROBES})
    ans = protocol.encode(protocol.ok(1, gids=g.tolist(), dists=np.asarray(
        d, np.float64).tolist()))
    return {
        "request_bytes": len(req), "answer_bytes": len(ans),
        "client_encode": med(lambda: protocol.encode({
            "id": 1, "op": "query", "tenant": "l2-basis",
            "queries": np.asarray(q, np.float32).tolist(), "k": FE_K,
            "n_probes": FE_PROBES})),
        "server_decode": med(lambda: np.asarray(
            protocol.decode_line(req)["queries"], np.float32)),
        "server_encode": med(lambda: protocol.encode(protocol.ok(
            1, gids=g.tolist(), dists=np.asarray(d, np.float64).tolist()))),
        "client_decode": med(lambda: [np.asarray(v, t) for v, t in zip(
            (lambda m: (m["gids"], m["dists"]))(protocol.decode_line(ans)),
            (np.int32, np.float32))])}


def local_streams(sv, reqs):
    """The same streams through ``submit_query``, no sockets."""
    def work(i):
        answers, secs = [], []
        for q in reqs[i]:
            t = time.perf_counter()
            g, d = sv.submit_query(q, FE_K, FE_PROBES).result()
            secs.append(time.perf_counter() - t)
            answers.append(bits_of(g, d))
        return answers, secs
    out, wall = on_threads(len(reqs), work)
    return ([a for a, _ in out], [s for _, ss in out for s in ss], wall)


def wire_tenant_leg(srv, reg, tier, rng):
    """The wire-loaded tenant: ``load`` the l1-qmc spec under another name,
    ingest FE_INGEST rows in FE_FRAME-row frames, delete 35%, seal, then
    compact under FE_MAINT_STREAMS query streams (each answer equal to the
    one before or after the job), an unknown job id, ``unload``, and the
    card's memory back within 5% of its value before the ``load``."""
    import dataclasses
    import threading
    name = f"wire-l1-qmc-{tier}"
    dev = reg.device
    mem0 = sync_memory(dev)
    res = {"tenant": name}
    with srv.client() as c:
        r = c.load(dataclasses.asdict(dataclasses.replace(
            tenant_spec("l1-qmc", tier), name=name)))
        if r["state"] != "ready":
            raise AssertionError(f"front end ({tier}): load answered {r}")
        wsv = reg.get(name)
        emb = wsv.embed(probe_inputs(wsv, rng, FE_INGEST)).cpu().numpy()
        del wsv
        t0 = time.perf_counter()
        for s in range(0, FE_INGEST, FE_FRAME):
            gids = c.insert(name, emb[s:s + FE_FRAME])
            if gids[0] != s or gids.size != FE_FRAME:
                raise AssertionError(f"front end ({tier}): insert at {s} "
                                     f"answered gids from {gids[0]}")
        if dev.type == "cuda":
            import torch
            torch.cuda.synchronize(dev)
        res["ingest_rows_per_s"] = FE_INGEST / (time.perf_counter() - t0)
        mem_loaded = sync_memory(dev)
        victims = np.sort(rng.choice(FE_INGEST, size=int(
            COMPACT_DELETE_FRAC * FE_INGEST), replace=False))
        res["deleted"] = c.delete(name, victims)
        if res["deleted"] != victims.size:
            raise AssertionError(f"front end ({tier}): deleted "
                                 f"{res['deleted']} of {victims.size}")
        st = c.wait_job(c.maintenance(name, "seal"), timeout_s=300.0)
        res["segments_before"] = st["result"]["n_segments"]
        qs = [emb[rng.integers(0, FE_INGEST, size=FE_ROWS)] + rng.normal(
            scale=0.05, size=(FE_ROWS, emb.shape[1])).astype(np.float32)
            for _ in range(FE_MAINT_STREAMS)]
        pre = [bits_of(*c.query_arrays(name, q, k=FE_K, n_probes=FE_PROBES))
               for q in qs]
        stop = threading.Event()

        def stream(i):
            out = []
            with srv.client() as sc:
                while not stop.is_set() or not out:
                    out.append(bits_of(*sc.query_arrays(
                        name, qs[i], k=FE_K, n_probes=FE_PROBES)))
            return out
        box = {}
        runner = threading.Thread(target=lambda: box.update(
            out=on_threads(FE_MAINT_STREAMS, stream)))
        runner.start()
        try:
            t0 = time.perf_counter()
            job = c.maintenance(name, "compact")
            st = c.wait_job(job, timeout_s=300.0)
            res["compact_job_s"] = time.perf_counter() - t0
        finally:
            stop.set()
            runner.join(600.0)
        if "out" not in box:
            raise AssertionError(f"front end ({tier}): a query stream "
                                 "failed during the compaction")
        during = box["out"][0]
        post = [bits_of(*c.query_arrays(name, q, k=FE_K, n_probes=FE_PROBES))
                for q in qs]
        idx = reg.get(name).index
        for q, p in zip(qs, post):
            if not same(p, stacked_answer(idx, q)):
                raise AssertionError(f"front end ({tier}): a compacted "
                                     "answer differs from _query_stacked")
        del idx
        torn = sum(1 for i, outs in enumerate(during) for a in outs
                   if not (same(a, pre[i]) or same(a, post[i])))
        n_during = sum(len(o) for o in during)
        if torn:
            raise AssertionError(f"front end ({tier}): {torn} of {n_during} "
                                 "answers during the compaction equal "
                                 "neither the one before nor after")
        want_live = FE_INGEST - victims.size
        if st["status"] != "done" or st["result"]["n_live"] != want_live:
            raise AssertionError(f"front end ({tier}): compaction job {st}")
        res.update(segments_after=st["result"]["n_segments"],
                   answers_during_job=n_during, torn=torn,
                   pre_equals_post=all(same(a, b) for a, b in
                                       zip(pre, post)))
        r = c.request("job_status", job_id="mj-0")
        if r.get("code") != "unknown_job":
            raise AssertionError(f"front end ({tier}): unknown job id "
                                 f"answered {r}")
        r = c.unload(name)
        if r["state"] != "unloaded" or r["drained"] is not True:
            raise AssertionError(f"front end ({tier}): unload answered {r}")
        r = c.query(name, qs[0], k=FE_K)
        if r.get("code") != "unknown_tenant":
            raise AssertionError(f"front end ({tier}): an unloaded tenant "
                                 f"answered {r}")
    mem1 = sync_memory(dev)
    res.update(memory_before_load=mem0, memory_loaded=mem_loaded,
               memory_after_unload=mem1)
    if mem0 is not None:
        res["freed_share_of_load"] = ((mem_loaded - mem1)
                                      / max(mem_loaded - mem0, 1))
        if abs(mem1 - mem0) > 0.05 * mem0:
            raise AssertionError(f"front end ({tier}): {mem1} bytes "
                                 f"allocated after the unload, {mem0} "
                                 "before the load (> 5% apart)")
    return res


def frontend_phase(reg, tier, card, smi):
    """Phase 12 on one tier's l2-basis tenant (after its compaction): see
    the module docstring.  Returns the numbers."""
    import dataclasses
    import tempfile

    from repro_torch.obs import CATALOG, Exporter
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve import BackgroundServer
    sv = reg.get("l2-basis")
    idx, dev = sv.index, reg.device
    rng = np.random.default_rng(1200 + (tier == "int8"))
    n_req = FE_STREAMS * FE_REQUESTS
    rows = sv.embed(probe_inputs(sv, rng, n_req * FE_ROWS)).cpu().numpy()
    rows += rng.normal(scale=0.05, size=rows.shape).astype(np.float32)
    reqs = rows.reshape(FE_STREAMS, FE_REQUESTS, FE_ROWS, -1)
    res = {"tier": tier, "card": smi, "items": idx.n_live,
           "segments": len(idx.segments)}
    srv = BackgroundServer(reg)
    try:
        with srv.client() as c:                  # warm the connection path
            c.query_arrays("l2-basis", reqs[0, 0], k=FE_K,
                           n_probes=FE_PROBES)
        n0 = (sv.batcher.n_requests, sv.batcher.n_batches)
        wire, wire_s, wall = wire_streams(srv.host, srv.port, "l2-basis",
                                          reqs)
        n1 = (sv.batcher.n_requests, sv.batcher.n_batches)
        local, local_s, lwall = local_streams(sv, reqs)
        n2 = (sv.batcher.n_requests, sv.batcher.n_batches)
        ext, ext_s, ewall = client_process_streams(srv, "l2-basis", reqs)
        n3 = (sv.batcher.n_requests, sv.batcher.n_batches)
        want = [[stacked_answer(idx, q) for q in s] for s in reqs]
        bad = [(i, j) for i in range(FE_STREAMS) for j in range(FE_REQUESTS)
               if not (same(wire[i][j], want[i][j])
                       and same(local[i][j], want[i][j])
                       and same(ext[i][j], want[i][j]))]
        if bad:
            raise AssertionError(f"front end ({tier}): {len(bad)} of {n_req} "
                                 "answers differ from _query_stacked "
                                 f"(first {bad[0]})")
        res["wire"] = {**latency(wire_s, wall, FE_ROWS),
                       "n_requests": n1[0] - n0[0],
                       "n_batches": n1[1] - n0[1],
                       "rows_per_batch": FE_ROWS * (n1[0] - n0[0])
                       / max(n1[1] - n0[1], 1)}
        res["in_process"] = {**latency(local_s, lwall, FE_ROWS),
                             "n_requests": n2[0] - n1[0],
                             "n_batches": n2[1] - n1[1],
                             "rows_per_batch": FE_ROWS * (n2[0] - n1[0])
                             / max(n2[1] - n1[1], 1)}
        g0, d0 = want[0][0]
        res["wire_codec_us"] = codec_us(reqs[0, 0], g0, d0.view(np.float32))
        res["wire_client_process"] = {
            **latency(ext_s, ewall, FE_ROWS), "n_requests": n3[0] - n2[0],
            "n_batches": n3[1] - n2[1],
            "rows_per_batch": FE_ROWS * (n3[0] - n2[0])
            / max(n3[1] - n2[1], 1)}

        with srv.client() as c:
            # NaN and +-inf query rows: (-1, +inf), as the direct call
            for j, spots in enumerate(((1, 2, np.nan), (4, 0, np.inf),
                                       (6, 7, -np.inf))):
                q = reqs[0, j].copy()
                q[spots[0], spots[1]] = spots[2]
                g, d = bits_of(*c.query_arrays("l2-basis", q, k=FE_K,
                                               n_probes=FE_PROBES))
                wg, wd = idx.query(q, FE_K, FE_PROBES)
                r = spots[0]
                if not (same((g, d), bits_of(wg.cpu().numpy(),
                                             wd.cpu().numpy()))
                        and (g[r] == -1).all()
                        and np.isposinf(d[r].view(np.float32)).all()):
                    raise AssertionError(f"front end ({tier}): a query row "
                                         f"holding {spots[2]} did not "
                                         "answer (-1, +inf) as the direct "
                                         "call")
            # the embed verb (K4): bit-equal to Servable.embed
            fv = np.asarray(probe_inputs(sv, rng, 64), np.float64)
            e = c.embed("l2-basis", fv)
            if not np.array_equal(e, sv.embed(fv).cpu().numpy()):
                raise AssertionError(f"front end ({tier}): the embed verb "
                                     "differs from Servable.embed")
            # kernels a wire batch launches, beside a direct call's on the
            # same rows: the network layer adds none.  Each side is
            # profiled three times, in turns, each count from a window
            # that lost no kernel record (``kernels_in``), and all six
            # must be equal
            q32 = rows[:32]
            wire_ks, direct_ks, nbs = [], [], []

            def two_wire_batches(out):
                nb = sv.batcher.n_batches
                for _ in range(2):
                    c.query_arrays("l2-basis", q32, k=FE_K,
                                   n_probes=FE_PROBES)
                out[0] = sv.batcher.n_batches - nb
            for _ in range(3):
                nb = [None]                  # batches in the window kept
                wire_ks.append(kernels_in(dev, lambda: two_wire_batches(nb)))
                nbs.append(nb[0])
                direct_ks.append(kernels_in(dev, lambda: [
                    [t.cpu() for t in idx.query(q32, FE_K, FE_PROBES)]
                    for _ in range(2)]))
            if wire_ks[0] is not None:
                wire_k, direct_k = wire_ks[0], direct_ks[0]
                res["kernels_per_wire_batch"] = wire_k / 2
                res["kernels_per_direct_call"] = direct_k / 2
                res["kernels_profiled_wire_direct"] = [wire_ks, direct_ks]
                if nbs != [2, 2, 2] or len(set(wire_ks + direct_ks)) != 1:
                    raise AssertionError(
                        f"front end ({tier}): {wire_ks} kernels in {nbs} "
                        f"wire batches, {direct_ks} in 2 direct calls")
        res["wire_tenant"] = wire_tenant_leg(srv, reg, tier, rng)

        with srv.client() as c:
            # update: a new palette and deadline, answers unchanged
            spec = dataclasses.asdict(sv.spec)
            old_palette = tuple(spec["chunk_sizes"])
            spec.update(chunk_sizes=list(FE_PALETTE), max_delay_ms=4.0)
            r = c.update(spec)
            if r["changed"] != ["chunk_sizes", "max_delay_ms"]:
                raise AssertionError(f"front end ({tier}): update {r}")
            upd, _, _ = wire_streams(srv.host, srv.port, "l2-basis",
                                     reqs[:, :8])
            if not all(same(upd[i][j], want[i][j]) for i in range(FE_STREAMS)
                       for j in range(8)):
                raise AssertionError(f"front end ({tier}): answers after "
                                     "the update differ from "
                                     "_query_stacked")
            q12 = rows[:12]
            if not same(bits_of(*c.query_arrays("l2-basis", q12, k=FE_K,
                                                n_probes=FE_PROBES)),
                        stacked_answer(idx, q12)):
                raise AssertionError(f"front end ({tier}): a 12-row answer "
                                     "after the update differs")
            shapes = sorted({ch for ch, _k, _p in
                             sv.batcher.shape_counts})
            stats = c.stats("l2-basis")["report"]["batcher"]
            if not (set(shapes) <= set(FE_PALETTE) and 16 in shapes
                    and stats["unique_shapes"] == len(
                        sv.batcher.shape_counts)):
                raise AssertionError(f"front end ({tier}): shapes after the "
                                     f"update {shapes}, {stats}")
            # a malformed policy is refused; a replication update of this
            # unsharded tenant is accepted and places nothing (phase 13
            # re-places a sharded one over the wire)
            r = c.request("update", spec=dict(spec, replication="static:0"))
            if r.get("code") != "bad_request":
                raise AssertionError(f"front end ({tier}): a malformed "
                                     f"replication update answered {r}")
            r = c.request("update", spec=dict(spec, replication="static:2"))
            if not (r.get("ok") and r["changed"] == ["replication"]
                    and idx.shard_layout() is None):
                raise AssertionError(f"front end ({tier}): a replication "
                                     f"update answered {r}")
            if not same(bits_of(*c.query_arrays("l2-basis", q12, k=FE_K,
                                                n_probes=FE_PROBES)),
                        stacked_answer(idx, q12)):
                raise AssertionError(f"front end ({tier}): an answer after "
                                     "the replication update differs")
            c.update(spec)
            res["update"] = {"old_palette": list(old_palette),
                             "new_palette": list(FE_PALETTE),
                             "shapes": shapes,
                             "unique_shapes": stats["unique_shapes"]}
            # health and stats
            h = c.health()
            if not (h["tenants"]["l2-basis"]["state"] == "ready"
                    and h["totals"]["admitted"] == h["totals"]["settled"]
                    and h["tenants"]["l2-basis"]["inflight"] == 0):
                raise AssertionError(f"front end ({tier}): health {h}")
            st = c.stats()
            if st["catalog"] != sorted(CATALOG):
                raise AssertionError(f"front end ({tier}): the stats "
                                     "catalog is not the port's CATALOG")
            res["totals"] = h["totals"]
    finally:
        srv.stop()

    # overload: a second server with a tiny quota on the same registry
    srv = BackgroundServer(reg, max_inflight=2, queue_depth=2)
    try:
        conns, per = FE_OVERLOAD

        def blast(i):
            out = []
            with srv.client() as c:
                for j in range(per):
                    at = (i % FE_STREAMS, j % FE_REQUESTS)
                    r = c.query("l2-basis", reqs[at], k=FE_K,
                                n_probes=FE_PROBES)
                    out.append((*at, r))
            return out
        outs, wall = on_threads(conns, blast)
    finally:
        srv.stop()
    oks = [(i, j, r) for o in outs for i, j, r in o if r.get("ok")]
    rejects = [r for o in outs for _i, _j, r in o if not r.get("ok")]
    if not rejects or {r["code"] for r in rejects} - {"overloaded",
                                                      "queue_full"} \
            or not all(r.get("retry_after_ms", 0) > 0 for r in rejects):
        raise AssertionError(f"front end ({tier}): overload gave "
                             f"{len(rejects)} rejects, codes "
                             f"{sorted({r.get('code') for r in rejects})}")
    for i, j, r in oks:
        if not same(bits_of(np.asarray(r["gids"], np.int32),
                            np.asarray(r["dists"], np.float32)),
                    want[i][j]):
            raise AssertionError(f"front end ({tier}): an answer under "
                                 "overload differs from _query_stacked")
    res["overload"] = {
        "connections": conns, "requests": conns * per, "ok": len(oks),
        "rejects": len(rejects), "reject_share": len(rejects) / (conns * per),
        "codes": {code: sum(r["code"] == code for r in rejects)
                  for code in ("overloaded", "queue_full")},
        "wall_s": wall}

    # the export: every line on the catalog, every exercised series there
    exercised = {x["name"] for x in obs_metrics.registry().collect()
                 if x["name"].startswith(("frontend_", "tenant_lifecycle"))}
    with tempfile.TemporaryDirectory(prefix="frontend-") as tmp:
        exp = Exporter.for_directory(tmp)
        exp.flush()
        exp.close()
        lines = [json.loads(x) for x in
                 Path(tmp, "metrics.jsonl").read_text().splitlines()]
    seen, off = set(), []
    for x in lines:
        if x["kind"] != "metric":
            continue
        spec = CATALOG.get(x["name"])
        if spec is None or x["type"] != spec.type or sorted(
                x["labels"]) != sorted(spec.labels):
            off.append(x)
        seen.add(x["name"])
    missing = sorted((exercised | set(FE_SERIES)) - seen)
    if off or missing:
        raise AssertionError(f"front end ({tier}) export: {len(off)} lines "
                             f"off the catalog (first {off[:1]}), series "
                             f"missing {missing}")
    res["export"] = {"lines": len(lines), "frontend_series":
                     sorted(n for n in seen if n.startswith(
                         ("frontend_", "tenant_lifecycle")))}
    log(f"  [{smi}] frontend " + json.dumps(res))
    return res


def drain_leg(sv, card, smi):
    """The child server on the card: ``python -m repro_torch.launch.serve
    --listen 127.0.0.1:0 --tenants l2-basis`` (no ``--device``), at most
    CHILD_TIMEOUT_S: FE_DRAIN_ROWS rows inserted over the wire, then
    FE_DRAIN_STREAMS query streams and SIGTERM mid-traffic.  The child must
    exit 0 with ``settled == admitted`` and ``inflight=0``, and each
    stream's requests must be answered or refused ``shutting_down`` (one,
    its last), none cut off.  Returns the numbers."""
    import os
    import re
    import signal
    import threading

    from repro_torch.serve import FrontendClient, wait_ready
    rng = np.random.default_rng(1212)
    emb = sv.embed(probe_inputs(sv, rng, FE_DRAIN_ROWS)).cpu().numpy()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_")}
    env["PYTHONPATH"] = str(ROOT / "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--listen",
           "127.0.0.1:0", "--tenants", "l2-basis"]
    if sv.index.device.type == "cpu":
        cmd += ["--device", "cpu"]
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    lines, errs = [], []
    readers = [threading.Thread(target=lambda f=f, out=out: out.extend(
        ln.rstrip("\n") for ln in f), daemon=True)
        for f, out in ((proc.stdout, lines), (proc.stderr, errs))]
    for t in readers:
        t.start()
    try:
        port = None
        while port is None:
            m = next((re.search(r"listening on [\d.]+:(\d+)", ln)
                      for ln in list(lines) if "listening on" in ln), None)
            if m:
                port = int(m.group(1))
                t_up = time.perf_counter() - t_start
            elif proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError("front end drain: the child did not "
                                     f"listen: {lines} {errs[-20:]}")
            else:
                time.sleep(0.05)
        wait_ready("127.0.0.1", port, timeout_s=120.0)
        with FrontendClient("127.0.0.1", port, timeout_s=120.0) as c:
            t0 = time.perf_counter()
            for s in range(0, FE_DRAIN_ROWS, FE_FRAME):
                c.insert("l2-basis", emb[s:s + FE_FRAME])
            ingest_s = time.perf_counter() - t0
        counts = [0] * FE_DRAIN_STREAMS
        ends = [None] * FE_DRAIN_STREAMS

        def stream(i):
            r_ = np.random.default_rng(i)
            with FrontendClient("127.0.0.1", port, timeout_s=120.0) as c:
                while True:
                    q = emb[r_.integers(0, FE_DRAIN_ROWS, size=FE_ROWS)]
                    r = c.query("l2-basis", q, k=FE_K, n_probes=FE_PROBES)
                    if not r.get("ok"):
                        ends[i] = r.get("code")
                        return
                    if len(r["gids"]) != FE_ROWS:
                        raise AssertionError(f"drain: answer {r}")
                    counts[i] += 1
        box = {}
        runner = threading.Thread(target=lambda: box.update(
            out=on_threads(FE_DRAIN_STREAMS, stream)))
        runner.start()
        while min(counts) < 20 and runner.is_alive() \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        runner.join(max(deadline - time.monotonic(), 1.0))
        rc = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
        drain_s = time.perf_counter() - t_sig
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        for t in readers:
            t.join(60)
    drained = next((ln for ln in lines if "drained:" in ln), "")
    m = re.search(r"admitted=(\d+) settled=(\d+) rejected=(\d+) "
                  r"inflight=(\d+)", drained)
    if rc != 0 or "out" not in box or m is None or m.group(1) != \
            m.group(2) or m.group(4) != "0" or set(ends) != {
                "shutting_down"} or "[serve] OK" not in lines:
        raise AssertionError(f"front end drain: rc {rc}, streams "
                             f"{'ok' if 'out' in box else 'failed'}, ends "
                             f"{ends}, drain line {drained!r}, stderr "
                             f"{errs[-20:]}")
    res = {"card": smi, "child_up_s": t_up, "rows_inserted": FE_DRAIN_ROWS,
           "wire_ingest_rows_per_s": FE_DRAIN_ROWS / ingest_s,
           "streams": FE_DRAIN_STREAMS, "answered": sum(counts),
           "refused_shutting_down": ends.count("shutting_down"),
           "admitted": int(m.group(1)), "settled": int(m.group(2)),
           "rejected": int(m.group(3)), "drain_wall_s": drain_s}
    log(f"  [{smi}] frontend drain " + json.dumps(res))
    return res


def run_paths(card, smi):
    """Phases 6-17: the fp32 main path (with phase 11 on its tenant), the
    int8 path beside it (each with two profiled batches), the simhash
    path, the compaction of both tenants, the front end over both, the
    l1-qmc and w2-quantile tenants, durability, the sharded path, the pod
    index and the paper's cell, then the LM stack, its other families and
    training on a mesh;
    the launch counts of the runs summed, and the profiles and
    reports."""
    import gc

    import torch

    from repro_torch.serve import ServableRegistry
    log(f"[6/17] main path: repro_torch.launch.serve, l2-basis, "
        f"{MAIN_ITEMS} items then {MAIN_STEPS} steps")
    registry = ServableRegistry(device="cuda")
    counts, report = drive(lambda: serve_run(
        ("l2-basis",), registry=registry, n_items=MAIN_ITEMS,
        steps=MAIN_STEPS, log=log), card, smi, FP32_PATH, "main path")
    report = report["l2-basis"]
    prof = profile_batches(registry.get("l2-basis"))
    check_report(report, "fp32")
    stacked_parity(registry.get("l2-basis"), prof, "fp32")
    runs_extra, telemetry = [], None
    if has_telemetry():
        log(f"[11/17] telemetry, on phase 6's tenant at {MAIN_ITEMS} items "
            "(before phase 7): deep-traced staged batches, their stage "
            "spans, the export against the catalog")
        counts11, telemetry = drive(lambda: telemetry_phase(
            registry.get("l2-basis"), card, smi), card, smi, FP32_PATH,
            "telemetry")
        runs_extra.append(counts11)
    else:
        log("[11/17] telemetry: this checkout has no obs package")

    log(f"[7/17] int8 path: repro_torch.launch.serve --precision int8, "
        f"{MAIN_ITEMS} items then {MAIN_STEPS} steps, beside phase 6's "
        "tenant; then the simhash path")
    reg8 = ServableRegistry(device="cuda")
    counts8, report8 = drive(lambda: serve_run(
        ("l2-basis",), registry=reg8, n_items=MAIN_ITEMS, steps=MAIN_STEPS,
        precision="int8", log=log), card, smi, INT8_PATH, "int8 path")
    report8 = report8["l2-basis"]
    prof8 = profile_batches(reg8.get("l2-basis"))
    check_report(report8, "int8")
    stacked_parity(reg8.get("l2-basis"), prof8, "int8")
    sv32, sv8 = registry.get("l2-basis"), reg8.get("l2-basis")
    compare_tiers(sv32, sv8, "filled")
    counts7, _ = drive(lambda: simhash_path(sv8), card, smi,
                       ("simhash_pack",), "simhash path")

    log(f"[8/17] compaction: {COMPACT_DELETE_FRAC:.0%} of the live items "
        "deleted, then a background compact under streamed 32-row batches, "
        "fp32 tenant then int8")
    victims = pick_victims(sv32)
    if not np.array_equal(sv8.index.live_items()[1].cpu().numpy(),
                          sv32.index.live_items()[1].cpu().numpy()):
        raise AssertionError("the fp32 and int8 tenants hold other items")
    counts_c, comp = drive(lambda: compaction_phase(
        registry, "fp32", victims, prof), card, smi, FP32_PATH,
        "compaction (fp32)")
    counts_c8, comp8 = drive(lambda: compaction_phase(
        reg8, "int8", victims, prof8), card, smi, INT8_PATH,
        "compaction (int8)")
    compare_tiers(sv32, sv8, "compacted")
    frontend = {}
    if has_frontend():
        log(f"[12/17] front end: a Frontend in this process on each tier's "
            f"compacted tenant, {FE_STREAMS} connections x {FE_REQUESTS} "
            f"requests of {FE_ROWS} rows, NaN rows, embed, a wire-loaded "
            "l1-qmc tenant (ingest, compaction under queries, unload), "
            "update, overload, health, stats and the export; then a child "
            "server drained by SIGTERM")
        t0 = time.perf_counter()
        for tier, reg_, path in (("fp32", registry, FP32_PATH),
                                 ("int8", reg8, INT8_PATH)):
            c, frontend[f"frontend {tier}"] = drive(
                lambda: frontend_phase(reg_, tier, card, smi), card, smi,
                path, f"front end ({tier})")
            runs_extra.append(c)
        frontend["frontend drain"] = drain_leg(sv32, card, smi)
        log(f"  phase 12 wall {time.perf_counter() - t0:.1f}s")
    else:
        log("[12/17] front end: this checkout has no network front end")
    keep = ("ingest_rows_per_s", "qps", "p50_ms", "p95_ms", "recall_at_k",
            "self_hit_rate")
    paths = {
        "fp32": {"profile": prof, **{k: report[k] for k in keep},
                 "compaction": comp},
        "int8": {"profile": prof8, **{k: report8[k] for k in keep},
                 "compaction": comp8}}
    runs = [counts, counts8, counts7, counts_c, counts_c8] + runs_extra
    loop_rates = {t: r["query_rows"] / r["loop_s"] for t, r in
                  (("fp32", report), ("int8", report8))}
    if telemetry is not None:
        paths["telemetry"] = telemetry
    paths.update(frontend)
    # phase 9 holds two more 262,144-item tenants: let phases 6-8's go
    del registry, reg8, sv32, sv8
    gc.collect()
    torch.cuda.empty_cache()
    if has_tenants():
        counts9, paths["tenants"] = tenants_phase(card, smi)
        runs += counts9
    else:
        log("[9/17] tenants: this checkout serves l2-basis only")
    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(ServableRegistry, "recover"):
        log(f"[10/17] durability: l2-basis at {MAIN_ITEMS} items with a WAL, "
            f"a snapshot and a warm standby, then {DURABLE_STEPS} steps; "
            "kill -9 at wal.append and at compact.swap in children, each "
            "recovered in a fresh child; fp32 then int8")
        t0 = time.perf_counter()
        for tier, path in (("fp32", FP32_PATH), ("int8", INT8_PATH)):
            c, paths[f"durability {tier}"] = drive(
                lambda: durability_phase(card, smi, tier), card, smi, path,
                f"durability ({tier})")
            runs.append(c)
        log(f"  phase 10 wall {time.perf_counter() - t0:.1f}s")
    else:
        log("[10/17] durability: this checkout has no WAL")
    gc.collect()
    torch.cuda.empty_cache()
    if has_sharding():
        log(f"[13/17] sharded path ({smi}): repro_torch.launch.serve on "
            f"a {SHARD_RANKS}-rank serve mesh over the card, l2-basis at "
            f"{MAIN_ITEMS} items then {MAIN_STEPS} steps, fp32 (auto "
            "replication) then int8: answers unreplicated, static:2 routed "
            "and all-active against unshard(), layouts, a profiled batch, "
            "p50 beside unsharded; at fp32 a seal's placement diff, a "
            "skewed stream and a compaction under auto, set_replication "
            "and an update over the wire")
        t0 = time.perf_counter()
        counts13, sharded = sharded_phase(card, smi, loop_rates)
        runs += counts13
        paths.update(sharded)
        log(f"  phase 13 wall {time.perf_counter() - t0:.1f}s")
    else:
        log("[13/17] sharded path: this checkout has no serve mesh")
    gc.collect()
    torch.cuda.empty_cache()
    if has_pod():
        log(f"[14/17] pod index ({smi}): build, query and brute force on a "
            f"{POD_MESH[0]} x {POD_MESH[1]} mesh of cuda:0 ranks against "
            "cpu ranks; then the paper's cell through launch.lsh_cell at "
            "16,777,216 items on a 16 x 2 mesh, and its kernels at its shapes")
        t0 = time.perf_counter()
        counts14, paths["pod"] = pod_phase(card, smi)
        runs.append(counts14)
        log(f"  phase 14 wall {time.perf_counter() - t0:.1f}s")
    else:
        log("[14/17] pod index: this checkout has no pod index")
    gc.collect()
    torch.cuda.empty_cache()
    if has_lm():
        log(f"[15/17] LM stack ({smi}): {LM_ARCH} smoke on the card against "
            f"the CPU; then at full width {LM_TRAIN['steps']} train steps "
            f"(seq {LM_TRAIN['seq']}, batch {LM_TRAIN['batch']}, grad_accum "
            f"{LM_TRAIN['accum']}), launch.train --smoke stopped and resumed, "
            f"and the serve step with the W2-LSH signature (batch "
            f"{LM_SERVE['batch']}, cache {LM_SERVE['cache']})")
        counts15, paths["lm"], _ = lm_phase(card, smi)
        runs.append(counts15)
    else:
        log("[15/17] LM stack: this checkout has no LM stack")
    gc.collect()
    torch.cuda.empty_cache()
    if has_families():
        log(f"[16/17] LM families ({smi}): {', '.join(FAMILIES)} smoke on the "
            "card against the CPU; then at full width trained (seq "
            f"{FAM_TRAIN['seq']}, batch {FAM_TRAIN['batch']}, grad_accum "
            f"{FAM_TRAIN['accum']}, {FAM_TRAIN['steps']} steps) and served "
            f"with the W2-LSH signature (batch {FAM_SERVE['batch']}, cache "
            f"{FAM_SERVE['cache']})")
        counts16, paths["families"], _ = families_phase(card, smi)
        runs.append(counts16)
    else:
        log("[16/17] LM families: this checkout has no moe, ssm, hybrid or "
            "enc-dec family")
    gc.collect()
    torch.cuda.empty_cache()
    if has_mesh_train():
        archs = ", ".join(a for a, _ in MESH_CONFIGS)
        log(f"[17/17] training on a mesh ({smi}): {archs} smoke on a "
            f"{MESH_SHAPE[0]} x {MESH_SHAPE[1]} mesh "
            "of cuda:0 ranks against cpu ranks and the unsharded steps; "
            f"{LM_ARCH} at full width trained on the mesh (seq "
            f"{MESH_TRAIN['seq']}, batch {MESH_TRAIN['batch']}, grad_accum "
            f"{MESH_TRAIN['accum']}) and served (batch {MESH_SERVE['batch']}, "
            f"cache {MESH_SERVE['cache']}); restore onto (4, 2), launch.train "
            "--mesh-devices 8, ef_compress, the dry run")
        counts17, paths["mesh"], _ = mesh_phase(card, smi)
        runs.append(counts17)
    else:
        log("[17/17] training on a mesh: this checkout has no sharding rules")
    counts_all = {name: sum(c[name] for c in runs) for name in counts}
    return counts_all, paths


# -- phase 13: multi-device serving ------------------------------------------


SHARD_RANKS = 8
SHARD_STREAM = 50          # 32-row batches timed sharded, then unsharded
SHARD_HOT = 4              # sealed segments the skewed stream aims at


def has_sharding() -> bool:
    """Does this checkout serve over a serve mesh?"""
    return (ROOT / "src" / "repro_torch" / "launch" / "mesh.py").is_file()


def batch_answers(idx, probes):
    """64 probes as two 32-row batches and 128 as one batch, through
    ``idx.query``: [(gids, distance bits)] * 3."""
    return [answer(idx, probes[:32]), answer(idx, probes[32:64]),
            answer(idx, probes[:128])]


def all_active_answers(idx, probes):
    """:func:`batch_answers` with every replica answering: the sharded
    query with no route plan (the fan-in drops the copies), rescored on a
    quantized tier."""
    import torch
    from repro_torch.core import distributed
    out = []
    for b in (probes[:32], probes[32:64], probes[:128]):
        q = torch.as_tensor(b, device=idx.device)
        with idx._lock:
            pl = idx._current_placement()
            st = idx.delta.state
            g, d = distributed.query_segments_sharded(
                pl, (st.alpha, st.b, st.mix), idx.cfg, q,
                idx._survivor_width(10, 4), n_probes=4)
        if idx.precision != "fp32":
            g, d = idx._rescore(q, g, 10)
        out.append((g.cpu().numpy(), d.cpu().numpy().view(np.int32)))
    return out


def expect_layout(idx, n_dev, factor, what):
    """``shard_layout()`` against the round-robin rule at ``factor``
    replicas a sealed segment (the prediction: 257 sealed segments, per_dev
    33 unreplicated and 65 at static:2 on 8 ranks)."""
    lay = idx.shard_layout()
    n = lay["n_sealed"]
    want = (n_dev, -(-n * factor // n_dev), n * factor)
    got = (lay["n_dev"], lay["per_dev"], lay["n_instances"])
    if got != want or n != MAIN_ITEMS // 1024 + 1:
        raise AssertionError(f"sharded ({what}): layout n_dev, per_dev, "
                             f"n_instances {got} for {n} sealed, want {want}"
                             f" for {MAIN_ITEMS // 1024 + 1}")
    return {"n_dev": got[0], "per_dev": got[1], "n_instances": got[2],
            "n_sealed": n}


def sharded_answers_leg(sv, mesh, tier):
    """The 64 + 128 probes through the sharded tenant unreplicated, at
    static:2 routed (three rounds, so the router turns over the replicas)
    and at static:2 with every replica answering, each bit-equal to the
    same index after ``unshard()``; the layouts as predicted.  Leaves the
    tenant sharded afresh (stripe width = need), unreplicated."""
    idx = sv.index
    probes = sv.embed(probe_inputs(sv, np.random.default_rng(1300), 128)
                      ).cpu().numpy()
    idx.unshard()
    want = batch_answers(idx, probes)
    idx.shard(mesh)
    res = {"unreplicated": expect_layout(idx, len(mesh.devices), 1, tier)}
    got = {"unreplicated": batch_answers(idx, probes)}
    sv.maintenance.set_replication(2)
    res["static:2"] = expect_layout(idx, len(mesh.devices), 2, tier)
    for r in range(3):
        got[f"static:2 routed, round {r}"] = batch_answers(idx, probes)
    got["static:2 all-active"] = all_active_answers(idx, probes)
    bad = [k for k, v in got.items()
           if not all(same(a, b) for a, b in zip(v, want))]
    if bad:
        raise AssertionError(f"sharded ({tier}): {bad} differ from the "
                             "unsharded answer")
    sv.maintenance.set_replication(None)
    idx.unshard()
    idx.shard(mesh)
    idx.refresh_placement()
    res["placement_per_dev"] = idx._placement.per_dev
    res["checked"] = sorted(got)
    return res


def seal_diff_leg(sv, tier):
    """Fill the delta to one segment, seal it through the maintenance
    handle (which refreshes the placement): the placement diff must move
    at most two segments' bytes, against the restack counter's whole
    stack."""
    from repro_torch.launch.serve import sample_inputs
    from repro_torch.obs import metrics as obs_metrics
    idx, m = sv.index, obs_metrics.registry()
    names = ("placement_replaced_bytes_total",
             "placement_restack_bytes_total")
    before = [m.value(n, tenant=idx.tenant) or 0 for n in names]
    room = idx.delta.capacity - idx.delta.n_items
    x, _ = sample_inputs(sv, np.random.default_rng(1301), room)
    sv.insert(sv.embed(x))
    sv.maintenance.seal()
    pl = idx._placement
    moved, restack = [(m.value(n, tenant=idx.tenant) or 0) - b
                      for n, b in zip(names, before)]
    seg = idx.segments[-2]
    one = (seg.state.table.nbytes + seg.state.db.nbytes + seg.gids.nbytes
           + seg.live.nbytes)
    if not (pl.diffed and 0 < moved <= 2 * one and restack == pl.sealed_bytes
            and moved < restack):
        raise AssertionError(f"sharded ({tier}): a seal moved {moved} bytes "
                             f"(one segment {one}), restack {restack}, "
                             f"stack {pl.sealed_bytes}, diffed {pl.diffed}")
    return {"replaced_bytes": moved, "one_segment_bytes": one,
            "restack_bytes": restack, "n_sealed": pl.n_sealed}


def hot_queries(idx, n_rows=256):
    """``n_rows`` query rows near live items of the first ``SHARD_HOT``
    sealed segments (fp32 rows, a small perturbation): a skewed stream."""
    import torch
    rows = []
    for seg in idx.segments[:SHARD_HOT]:
        live = seg.live[:seg.n_items]
        rows.append(seg.state.db[:seg.n_items][live].float())
    emb = torch.cat(rows).cpu().numpy()
    pick = np.random.default_rng(1302).choice(emb.shape[0], n_rows,
                                              replace=False)
    return emb[pick] + np.float32(0.01)


def skewed_stream(sv, q):
    """The skewed rows through the batcher, 32 a request (the telemetry
    path); returns ``shard_balance()``."""
    for s in range(0, q.shape[0], 32):
        sv.query(q[s:s + 32], 10, 4)
    return sv.stats.shard_balance()


def auto_compaction_leg(reg, sv, tier):
    """Under ``replication="auto"``: a skewed stream (unrouted), 35% of
    the items deleted and the delta sealed, then a ``MaintenancePool``
    worker compacts while this thread streams 32-row batches (each answer
    equal to the one before or after the job); the factors the compaction
    set must exceed 1 on the hot segments; a routed skewed stream after;
    the tenant's answers equal to its unsharded ones."""
    from repro_torch.launch.serve import sample_fvals
    from repro_torch.serve import MaintenancePool
    idx = sv.index
    hot = hot_queries(idx)
    sv.stats.reset_fanout()
    unrouted = skewed_stream(sv, hot)
    sv.delete(pick_victims(sv))
    sv.maintenance.seal()
    probes = sv.embed(sample_fvals(np.random.default_rng(1303), sv.nodes(),
                                   128)).cpu().numpy()
    batches = [probes[:32], probes[32:64]]
    pre = [answer(idx, b) for b in batches]
    during = []
    t0 = time.perf_counter()
    pool = MaintenancePool(reg, workers=1)
    try:
        job = pool.submit("l2-basis", "compact")
        while pool.status(job)["status"] in ("queued", "running"):
            during.append(answer(idx, batches[len(during) % 2]))
        st = pool.wait(job, timeout_s=600.0)
    finally:
        pool.stop(timeout_s=600.0)
    job_s = time.perf_counter() - t0
    if st["status"] != "done":
        raise AssertionError(f"sharded compaction ({tier}) failed: "
                             f"{st['error']}\n{st['traceback']}")
    post = [answer(idx, b) for b in batches]
    torn = [i for i, a in enumerate(during)
            if not (same(a, pre[i % 2]) or same(a, post[i % 2]))]
    if torn:
        raise AssertionError(f"sharded compaction ({tier}): {len(torn)} of "
                             f"{len(during)} answers torn")
    fac = idx.replication()
    if not (isinstance(fac, tuple) and max(fac[:SHARD_HOT]) > 1):
        raise AssertionError(f"auto ({tier}): factors {fac} after a skewed "
                             "stream")
    routed = skewed_stream(sv, hot)
    got = batch_answers(idx, probes)
    idx.unshard()
    want = batch_answers(idx, probes)
    idx.shard(reg.mesh)
    if not all(same(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"auto ({tier}): replicated answers after the "
                             "compaction differ from the unsharded ones")
    lay = idx.shard_layout()
    return {"job_s": job_s, "answers_during": len(during), "torn": 0,
            "segments_after": len(idx.segments),
            "factors_hot": list(fac[:SHARD_HOT]),
            "factors_gt1": sum(f > 1 for f in fac),
            "n_instances": lay["n_instances"], "n_sealed": lay["n_sealed"],
            "device_imbalance_unrouted": unrouted["device_imbalance"],
            "device_imbalance_routed": routed["device_imbalance"],
            "device_load_imbalance_routed": routed["device_load_imbalance"],
            "per_device_load_routed": routed["per_device_load"]}


def wire_replication_leg(reg, sv, tier):
    """A ``maintenance`` frame of kind ``set_replication`` and an
    ``update`` of ``replication`` over the wire re-place the sharded
    tenant; 12-row wire answers bit-equal to the direct sharded call
    before and after each."""
    import dataclasses
    from repro_torch.serve import BackgroundServer
    idx = sv.index
    q = sv.embed(probe_inputs(sv, np.random.default_rng(1304), 12)
                 ).cpu().numpy()
    srv = BackgroundServer(reg)
    res = {}
    try:
        with srv.client() as c:
            def check(what):
                wire = bits_of(*c.query_arrays("l2-basis", q, k=FE_K,
                                               n_probes=FE_PROBES))
                if not same(wire, answer(idx, q)):
                    raise AssertionError(f"sharded wire ({tier}): {what}: "
                                         "the wire answer differs")
            check("before")
            job = c.maintenance("l2-basis", "set_replication",
                                replication=2)
            c.wait_job(job, timeout_s=600.0)
            lay = idx.shard_layout()
            if lay["n_instances"] != 2 * lay["n_sealed"]:
                raise AssertionError(f"sharded wire ({tier}): layout {lay}")
            res["set_replication"] = lay["n_instances"]
            check("after set_replication")
            r = c.update(dict(dataclasses.asdict(sv.spec),
                              replication="static:3"))
            lay = idx.shard_layout()
            if r["changed"] != ["replication"] or \
                    lay["n_instances"] != 3 * lay["n_sealed"]:
                raise AssertionError(f"sharded wire ({tier}): update {r}, "
                                     f"layout {lay}")
            res["update"] = lay["n_instances"]
            check("after the update")
    finally:
        srv.stop()
    return res


def shard_numbers(sv, mesh, tier):
    """p50 and rate of 32-row batches sharded, then the same index
    unsharded (re-sharded after), and card bytes of each rank's block."""
    rng = np.random.default_rng(1305)
    idx = sv.index
    probes = sv.embed(probe_inputs(sv, rng, 64)).cpu().numpy()
    batches = [probes[:32], probes[32:]]
    _, sh = stream_batches(idx, batches, SHARD_STREAM)
    idx.unshard()
    _, un = stream_batches(idx, batches, SHARD_STREAM)
    idx.shard(mesh)
    idx.refresh_placement()
    return {"sharded": batch_rate(sh), "unsharded": batch_rate(un),
            "rank_bytes": idx._placement.nbytes(),
            "stack_bytes": idx.layout()["bytes"]}


def sharded_phase(card, smi, loop_rates):
    """Phase 13 (see the module docstring): l2-basis through
    ``launch.serve.run`` on an 8-rank serve mesh over the card, fp32
    (``replicate="auto"``) then int8; returns (launch counts per tier,
    the numbers)."""
    import gc

    import torch
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve import ServableRegistry
    tag = f"[{card}, {smi.split(',')[-1].strip()}]"
    runs, out = [], {}
    for tier, path, replicate in (("fp32", FP32_PATH, "auto"),
                                  ("int8", INT8_PATH, "none")):
        t0 = time.perf_counter()
        mesh = make_serve_mesh(SHARD_RANKS, device="cuda")
        reg = ServableRegistry(device="cuda", mesh=mesh)
        res = {"tier": tier, "card": smi,
               "mesh": [str(d) for d in mesh.devices]}

        def leg():
            torch.cuda.reset_peak_memory_stats()
            rep = serve_run(("l2-basis",), registry=reg, n_items=MAIN_ITEMS,
                            steps=MAIN_STEPS, precision=tier,
                            replicate=replicate, log=log)["l2-basis"]
            sv = reg.get("l2-basis")
            check_report(rep, f"sharded {tier}")
            res["loop_rate_rows_per_s"] = rep["query_rows"] / rep["loop_s"]
            res["loop_rate_unsharded_rows_per_s"] = loop_rates.get(tier)
            res["qps"], res["p50_ms"] = rep["qps"], rep["p50_ms"]
            res["answers"] = sharded_answers_leg(sv, mesh, tier)
            prof = profile_batches(sv)
            per = prof["launches_per_batch"]
            want = {"hash_mm": 1, "scorer": SHARD_RANKS + 1,
                    "merge": SHARD_RANKS + 2 + (tier != "fp32")}
            got = {"hash_mm": per["hash_mm"],
                   "scorer": per["fused_query"] + per["quantized_query"],
                   "merge": per["merge"]}
            if got != want:
                raise AssertionError(f"sharded ({tier}): launches per "
                                     f"profiled batch {per}, want {want}")
            res["profile"] = {k: prof[k] for k in (
                "wall_ms", "kernel_ms", "kernels_per_batch",
                "launches_per_batch", "busy_share", "scorer_ms_per_batch",
                "merge_rerank_ms_per_batch")}
            res["numbers"] = shard_numbers(sv, mesh, tier)
            if tier == "fp32":
                res["seal_diff"] = seal_diff_leg(sv, tier)
                res["auto"] = auto_compaction_leg(reg, sv, tier)
                res["wire"] = wire_replication_leg(reg, sv, tier)
            torch.cuda.synchronize()
            res["peak_memory"] = torch.cuda.max_memory_allocated()
            res["memory"] = torch.cuda.memory_allocated()
            return res
        counts, _ = drive(leg, card, smi, path, f"sharded path ({tier})")
        runs.append(counts)
        res["launches"] = counts
        res["wall_s"] = time.perf_counter() - t0
        log(f"  {tag} sharded " + json.dumps(res))
        out[f"sharded {tier}"] = res
        del reg
        gc.collect()
        torch.cuda.empty_cache()
    return runs, out


# -- phase 14: the independent-family pod index and the paper's cell --------


POD_MESH = (2, 4)          # the CPU tests' mesh, items and width
POD_ITEMS, POD_DIMS, POD_QUERIES = 512, 32, 16
CELL_PATH = FP32_PATH      # K4 embeds the cell's items; K1, K2, K3 query


def has_pod() -> bool:
    try:
        from repro_torch.core.distributed import build_distributed  # noqa
        from repro_torch.launch import lsh_cell  # noqa: F401
    except ImportError:
        return False
    return True


def topk_agree(what, ids_a, d_a, ids_b, d_b, explained=None):
    """(ids, dists) of one call on two devices: distances allclose (rtol
    1e-5, atol 1e-6) where both have an id, ids equal wherever ``d_b``'s
    distances are distinct in their row, but in rows ``explained`` (a
    boundary flip).  Returns the number of differing rows."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    d_a, d_b = np.asarray(d_a), np.asarray(d_b)
    explained = (np.zeros(len(ids_a), bool) if explained is None
                 else explained)
    differ = 0
    for r in range(len(ids_a)):
        if (ids_a[r] == ids_b[r]).all():
            if not np.allclose(d_a[r], d_b[r], rtol=1e-5, atol=1e-6):
                raise AssertionError(f"{what}: row {r} distances differ "
                                     f"{d_a[r]} / {d_b[r]}")
            continue
        differ += 1
        if explained[r]:
            continue
        for c in range(ids_a.shape[1]):
            others = np.delete(d_b[r], c)
            if np.isfinite(d_b[r, c]) and not np.isclose(
                    others, d_b[r, c], rtol=1e-5, atol=1e-6).any() \
                    and ids_a[r, c] != ids_b[r, c]:
                raise AssertionError(f"{what}: row {r} ids differ at a "
                                     f"distinct distance: {ids_a[r]} / "
                                     f"{ids_b[r]}")
        if not np.allclose(d_a[r], d_b[r], rtol=1e-5, atol=1e-6):
            raise AssertionError(f"{what}: row {r} distances differ")
    return differ


def pod_parity():
    """Phase 14 (a): the pod index at the CPU tests' shape (512 items, N
    32, a 2 x 4 mesh) on ``cuda:0`` ranks against the same calls on
    ``cpu`` ranks with the same families: each rank's table and counts
    equal unless a block item's projection lies at a floor boundary
    (counted), the query's ids equal where distances are distinct (rows
    touched by a boundary item or query excepted, counted), brute force's
    ids and distances likewise."""
    import torch
    from repro_torch.core import distributed as dist
    from repro_torch.core import index as lidx
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_test_mesh
    cfg = lidx.IndexConfig(n_dims=POD_DIMS, n_tables=4, n_hashes=4,
                           log2_buckets=8, bucket_capacity=64, r=4.0)
    rng = np.random.default_rng(2828)
    db = rng.normal(size=(POD_ITEMS, POD_DIMS)).astype(np.float32)
    q = (db[:POD_QUERIES] + 0.3 * rng.normal(
        size=(POD_QUERIES, POD_DIMS))).astype(np.float32)
    d, m = POD_MESH
    fams = [[parity_family(cfg, rng) for _ in range(m)] for _ in range(d)]
    got = {}
    for dev in ("cpu", "cuda"):
        mesh = make_test_mesh(POD_MESH, device=dev)
        pod = dist.build_distributed(cfg, db, mesh, families=fams)
        ids, dd = dist.query_distributed(pod, cfg, q, 10, n_probes=6)
        eids, ed = dist.brute_force_distributed(db, q, 10, mesh)
        got[dev] = dict(
            tables=[[(st.table.cpu(), st.counts.cpu()) for st in row]
                    for row in pod],
            ids=ids.cpu().numpy(), d=dd.cpu().numpy(),
            eids=eids.cpu().numpy(), ed=ed.cpu().numpy(),
            on=str(ids.device))
    if got["cuda"]["on"] != "cuda:0":
        raise AssertionError(f"pod parity: the card's answer on "
                             f"{got['cuda']['on']}")
    n_local = POD_ITEMS // d
    flips, ranks_apart = 0, 0
    near_item = np.zeros(POD_ITEMS, bool)
    near_q = np.zeros(POD_QUERIES, bool)
    for di in range(d):
        block = torch.as_tensor(db[di * n_local:(di + 1) * n_local])
        for mi in range(m):
            a, b = (torch.as_tensor(t) for t in fams[di][mi][:2])
            hc, pj = ref.hash_mm_proj_ref(block, a, b, cfg.r)
            hg, _ = lidx.hash_stage(a.cuda(), b.cuda(), cfg, block.cuda())
            near = near_boundary(pj).any(dim=-1).numpy()
            near_item[di * n_local:(di + 1) * n_local] |= near
            _, pq = ref.hash_mm_proj_ref(torch.as_tensor(q), a, b, cfg.r)
            near_q |= near_boundary(pq).any(dim=-1).numpy()
            moved = (hg.reshape(n_local, -1).cpu() != hc).any(dim=-1).numpy()
            if (moved & ~near).any():
                raise AssertionError(f"pod parity: rank ({di}, {mi}) hashes "
                                     f"{np.nonzero(moved & ~near)[0]} apart "
                                     "away from a boundary")
            flips += int(moved.sum())
            (tc, cc), (tg, cg) = (got[dv]["tables"][di][mi]
                                  for dv in ("cpu", "cuda"))
            if not (torch.equal(tc, tg) and torch.equal(cc, cg)):
                ranks_apart += 1
                if not moved.any():
                    raise AssertionError(f"pod parity: rank ({di}, {mi})'s "
                                         "table differs with equal hashes")
    cpu, card = got["cpu"], got["cuda"]
    boundary_gids = set(np.nonzero(near_item)[0].tolist())
    explained = np.array([
        near_q[r] or bool((set(cpu["ids"][r].tolist())
                           ^ set(card["ids"][r].tolist())) & boundary_gids)
        for r in range(POD_QUERIES)])
    q_rows = topk_agree("pod query", card["ids"], card["d"], cpu["ids"],
                        cpu["d"], explained)
    bf_rows = topk_agree("pod brute force", card["eids"], card["ed"],
                         cpu["eids"], cpu["ed"])
    res = {"mesh": list(POD_MESH), "items": POD_ITEMS, "dims": POD_DIMS,
           "queries": POD_QUERIES, "ranks_with_table_flips": ranks_apart,
           "items_hashed_apart": flips, "query_rows_differ": q_rows,
           "brute_force_rows_differ": bf_rows,
           "near_boundary_items": int(near_item.sum())}
    log("  pod parity (cuda:0 ranks vs cpu ranks, one family a rank): "
        + json.dumps(res))
    return res


def cell_kernel_records(state, cfg, q):
    """K1 and K2 at the cell's shapes on rank (0, 0): K1 over its 1,048,576
    rows (one build's hash), K2 over the 4,096 queries' deduped candidates
    of its 16 tables x 4 probes x 128 slots; kernel (a CUDA graph of a few
    calls), plain version and library call (a few calls: they materialise
    gigabytes), bytes and operations for the bound, and the kernel's error
    against the plain version."""
    import torch
    from repro_torch.core import index as lidx
    from repro_torch.kernels import fused_query, hash_mm, ref
    x, a, b, r = state.db, state.alpha, state.b, cfg.r
    m, n = x.shape
    k = a.shape[1]

    def lib_hash():
        pj = torch.matmul(x, a) / r + b
        return torch.floor(pj).to(torch.int32), pj
    hk, pk = hash_mm.hash_mm(x, a, b, r)
    hp, pp = ref.hash_mm_proj_ref(x, a, b, r)
    err1 = float((pk - pp).abs().max())
    if not torch.allclose(pk, pp, rtol=1e-6, atol=1e-5):
        raise AssertionError(f"cell K1: projections off by {err1}")
    safe = ~near_boundary(pp)
    if not torch.equal(hk[safe], hp[safe]):
        raise AssertionError("cell K1: hashes differ away from a boundary")
    del hk, pk, hp, pp, safe
    k1 = dict(shape=f"X ({m}, {n}) @ A ({n}, {k})",
              ms=time_ms(lambda: hash_mm.hash_mm(x, a, b, r), warmup=2,
                         reps=5, replays=3),
              plain_ms=time_ms(lambda: ref.hash_mm_proj_ref(x, a, b, r),
                               **FEW),
              library_ms=time_ms(lib_hash, **FEW), max_abs_err=err1,
              bytes=4 * (m * n + n * k + k + 2 * m * k),
              ops=2 * m * n * k + 2 * m * k)
    cands = lidx._candidate_ids(state, cfg, q, 4, None)
    dk, ik = fused_query.fused_query_topk(q, x, cands, 10)
    dp, ip = ref.fused_query_topk_ref(q, x, cands, 10)
    fin = torch.isfinite(dp)
    err2 = float((dk[fin] - dp[fin]).abs().max()) if bool(fin.any()) else 0.0
    topk_agree("cell K2", ik.cpu(), dk.cpu(), ip.cpu(), dp.cpu())
    del dp, ip
    torch.cuda.empty_cache()
    k2 = _k2_record(q, x, cands, 10, big=True)
    k2["max_abs_err"] = err2
    for rec in (k1, k2):
        rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"], rec["ops"])
    return {"hash_mm@cell": k1, "fused_query@cell": k2}


def events_ms(fn, reps=3) -> float:
    """Median card ms of ``fn()`` between CUDA events, after one warm-up
    call (for calls too large, or with too many eager ops, to capture in a
    graph)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def same_pairs(what, got, want):
    """(dists, ids) of a merge bit for bit against its plain version's."""
    import torch
    if not (torch.equal(got[1].to(torch.int32), want[1].to(torch.int32))
            and torch.equal(bits(got[0]), bits(want[0]))):
        raise AssertionError(f"{what}: not bit-identical to the plain "
                             "version")


def cell_fan_in_record(pod, cfg, q):
    """K3 at the pod query's fan-in, on the cell's own lists: every rank's
    (4,096, 10) answer, (4,096, 320) pairs in all, through
    ``ops.merge_topk_unique`` (two K3 launches) bit for bit against
    ``ref.merge_topk_unique_ref`` on the card."""
    import torch
    from repro_torch.core import distributed as dist
    from repro_torch.kernels import dispatch, ops, ref
    from repro_torch.launch import lsh_cell
    pd, pg = dist.query_lists(pod, cfg, q, lsh_cell.K, lsh_cell.N_PROBES)
    d, g = torch.cat(pd, dim=1), torch.cat(pg, dim=1)
    del pd, pg
    rows, m = d.shape
    k = lsh_cell.K
    before = dispatch.launches["merge"]
    got = ops.merge_topk_unique(d, g, k)
    if dispatch.launches["merge"] != before + 2:
        raise AssertionError("cell fan-in: not two K3 launches")
    want = ref.merge_topk_unique_ref(d, g, k)
    same_pairs(f"cell fan-in ({rows}, {m})", got, want)
    kept = got[1][got[1] >= 0]
    rec = dict(shape=f"({rows}, {m}) pairs, {len(pod)} x {len(pod[0])} "
                     f"ranks' top {k}, gids once -> {k}",
               ms=events_ms(lambda: ops.merge_topk_unique(d, g, k)),
               plain_ms=events_ms(lambda: ref.merge_topk_unique_ref(d, g,
                                                                   k)),
               library_ms=None, max_abs_err=0.0,
               found=int(kept.numel()),
               bytes=8 * rows * m + 8 * rows * k, ops=rows * m)
    rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"], rec["ops"])
    return rec


def cell_brute_records(items, q, mesh_shape):
    """Brute force's kernels at the cell's shapes, on the cell's own items
    and queries: K2 over one 16,384-item chunk of data block 0 (every item
    a candidate of each of the 4,096 queries) against the plain version
    (``ref.fused_query_topk_ref``, 256 queries at a time) and ``torch.
    cdist`` without the matmul plus a top k (the library call), ids equal
    where distances are distinct and distances rtol 1e-5; then K3 at
    block 0's merge of its chunks' lists and at the merge of the data
    blocks' lists, each ``ops.merge_topk`` bit for bit against its plain
    route, and block 0's merged list the first k columns of the
    blocks'."""
    import torch
    from repro_torch.core import distributed as dist
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import lsh_cell
    from repro_torch.launch.mesh import make_pod_mesh
    k, nq = lsh_cell.K, q.shape[0]
    d_ranks = mesh_shape[0]
    n_local = items.shape[0] // d_ranks
    block = items[:n_local].to(torch.float32).contiguous()
    c = min(dist.BRUTE_CHUNK_MAX, n_local,
            max(k, dist.BRUTE_IDS_MAX_ELEMS // nq))
    rows = block[:c]
    slots = torch.arange(c, dtype=torch.int32, device=q.device).expand(
        nq, c).contiguous()

    def plain():
        parts = [ref.fused_query_topk_ref(q[s:s + 256], rows,
                                          slots[s:s + 256], k)
                 for s in range(0, nq, 256)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    def library():
        return torch.topk(torch.cdist(
            q, rows, compute_mode="donot_use_mm_for_euclid_dist"), k,
            largest=False)
    dk, ik = ops.fused_query_topk(q, rows, slots, k)
    dp, ip = plain()
    err = float((dk - dp).abs().max())
    rows_differ = topk_agree("brute chunk K2", ik.cpu(), dk.cpu(), ip.cpu(),
                             dp.cpu())
    k2 = dict(shape=f"q ({nq}, 64), db ({c}, 64) (block 0's first chunk), "
                    f"ids ({nq}, {c}), every item a candidate, k={k}",
              ms=time_ms(lambda: ops.fused_query_topk(q, rows, slots, k),
                         **FEW),
              plain_ms=events_ms(plain), library_ms=events_ms(library),
              max_abs_err=err, rows_differ=rows_differ,
              bytes=4 * (nq * 64 + nq * c + c * 64 + 2 * nq * k),
              ops=3 * 64 * nq * c)
    del dk, ik, dp, ip, slots
    bd, bi = dist.block_lists(block, q, k)
    got0 = ops.merge_topk(bd, bi, k)
    same_pairs(f"brute chunks' merge {tuple(bd.shape)}", got0,
               merge_topk_plain(bd, bi, k))
    chunks = _k3_record(bd, bi, k)
    chunks["shape"] += f" (block 0's {bd.shape[1] // k} chunks)"
    del bd, bi, block
    rd, rg = dist.brute_force_lists(items, q, k,
                                    make_pod_mesh(mesh_shape, "cuda"))
    if not (torch.equal(rg[:, :k], got0[1]) and
            torch.equal(bits(rd[:, :k]), bits(got0[0]))):
        raise AssertionError("brute force: block 0's list differs between "
                             "block_lists and brute_force_lists")
    same_pairs(f"brute blocks' merge {tuple(rd.shape)}",
               ops.merge_topk(rd, rg, k), merge_topk_plain(rd, rg, k))
    blocks = _k3_record(rd, rg, k)
    blocks["shape"] += f" ({d_ranks} data blocks)"
    for rec in (k2, chunks, blocks):
        rec.setdefault("max_abs_err", 0.0)
        rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"], rec["ops"])
    return {"fused_query@brute_chunk": k2, "merge@brute_chunks": chunks,
            "merge@brute_blocks": blocks}


def pod_phase(card, smi):
    """Phase 14 (see the module docstring): (a) :func:`pod_parity`; (b) the
    cell at full shape through ``lsh_cell.main``, then every kernel launch
    of its path at the cell's shapes against its plain version on the
    cell's own tensors.  Returns (the launches of the cell's embed and
    three timed calls, the numbers)."""
    import gc

    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch import lsh_cell
    t0 = time.perf_counter()
    parity = pod_parity()
    gc.collect()
    torch.cuda.empty_cache()
    kept = {}

    def hold(pod, cfg, queries, items):
        kept.update(pod=pod, cfg=cfg, q=queries, items=items)
    out = ROOT / "build" / "lsh_cell.json"
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    mesh = ",".join(map(str, lsh_cell.MESH))
    _, res = drive(lambda: lsh_cell.main(
        ["--mesh", mesh, "--out", str(out)], on_built=hold), card, smi,
        CELL_PATH, "pod cell")
    cell = res.pop("cell")
    counts = {name: cell["launches"].get(name, 0) for name in dispatch.KERNELS}
    missing = [name for name in CELL_PATH if counts[name] <= 0]
    if missing:
        raise AssertionError(f"pod cell: the timed calls never launched "
                             f"{missing}")
    if not cell["brute_force_finite"]:
        raise AssertionError("pod cell: brute force gave a non-finite "
                             "distance")
    if not 0.0 <= cell["recall_at_10"] <= 1.0:
        raise AssertionError(f"pod cell: recall {cell['recall_at_10']}")
    for name, e in res.items():
        if not (e["card_ms"] > 0 and e["bound_ms"] > 0):
            raise AssertionError(f"pod cell: {name} {e}")
    gc.collect()
    torch.cuda.empty_cache()
    pod, cfg, q = kept.pop("pod"), kept["cfg"], kept["q"]
    kernels = cell_kernel_records(pod[0][0], cfg, q)
    kernels["merge_unique@fan_in"] = cell_fan_in_record(pod, cfg, q)
    del pod
    gc.collect()
    torch.cuda.empty_cache()
    kernels.update(cell_brute_records(kept["items"], q, lsh_cell.MESH))
    kept.clear()
    gc.collect()
    torch.cuda.empty_cache()
    line = {"card": smi, "mesh": cell["mesh"], "cell": cell,
            "phases": {k: {f: e[f] for f in (
                "card_ms", "host_ms", "bound_ms", "bound_by", "bytes", "ops",
                "peak_bytes", "launches", "card_kernels") if f in e}
                for k, e in res.items()},
            "kernels_at_cell_shapes": kernels, "parity": parity,
            "launches": counts, "wall_s": time.perf_counter() - t0}
    log(f"  [{card}, {smi.split(',')[-1].strip()}] pod " + json.dumps(line))
    return counts, line


# -- phase 9: the l1-qmc and w2-quantile tenants -----------------------------


TENANT_PATH = ("hash_mm", "fused_query", "merge")   # no K4: no basis embed
W2_PROBES = 64


def w2_tenant_oracle(sv, params, n_probe=W2_PROBES, k=10):
    """The W^2 tenant's recall@10 against the closed-form W2 over its live
    items: ``n_probe`` fresh Gaussians (their 256 raw draws embedded and
    queried; their (mu, sigma) for the oracle), ``params`` the (mu, sigma)
    of every inserted gid."""
    from repro_torch.core.wasserstein import gaussian_w2
    from repro_torch.launch.serve import sample_gaussian_draws
    rng = np.random.default_rng(2026)
    draws, qmu, qsig = sample_gaussian_draws(rng, n_probe)
    g, _ = sv.query(sv.embed(draws).cpu().numpy(), k, 4)
    live = sv.index.live_items()[1].cpu().numpy()
    mu, sig = params[0][live], params[1][live]
    w2 = gaussian_w2(qmu[:, None].astype(np.float32),
                     qsig[:, None].astype(np.float32),
                     mu[None, :], sig[None, :]).numpy()
    exact = live[np.argsort(w2, axis=1, kind="stable")[:, :k]]
    return float(np.mean([len(set(a[a >= 0]) & set(b)) / k
                          for a, b in zip(g, exact)]))


def w2_embed_record(sv, rows=128):
    """The Wasserstein embed (``sort`` + gather + scale on the card, no
    kernel of ours) per ``rows``-row chunk of 256 raw draws: card time
    (CUDA graph), host time, and the bytes that bound it."""
    import torch
    from repro_torch.launch.serve import W2_DRAWS, sample_gaussian_draws
    x = torch.as_tensor(sample_gaussian_draws(np.random.default_rng(3),
                                              rows)[0],
                        dtype=torch.float32, device="cuda")
    emb = sv.embedder
    nbytes = 4 * (rows * W2_DRAWS + emb.n_dims + rows * emb.n_dims)
    bms, by = bound_ms(nbytes, 0)
    return {"shape": f"({rows}, {W2_DRAWS}) draws -> ({rows}, "
                     f"{emb.n_dims})",
            "ms": time_ms(lambda: emb.embed(x)),
            **host_times(lambda: emb.embed(x)),
            "bound_ms": bms, "bound_by": by}


def tenants_phase(card, smi):
    """Phase 9: ``launch.serve.run`` over l1-qmc and w2-quantile at
    MAIN_ITEMS items and MAIN_STEPS steps at fp32, then l1-qmc at int8;
    per tenant two profiled 32-row batches, the stacked query bit-equal to
    the fan-out, self-hit >= 0.95, the held share and recall@10; int8 vs
    fp32 recall >= 0.98 at <= 1/3 the bytes; the W2 oracle gate (the
    bench's full config) >= 0.9 and the big tenant's recall against the
    oracle; the Wasserstein embed's time per 128-row chunk."""
    from repro_torch.launch import w2_gate
    from repro_torch.serve import ServableRegistry
    names = ("l1-qmc", "w2-quantile")
    log(f"[9/17] tenants: repro_torch.launch.serve, {', '.join(names)}, "
        f"{MAIN_ITEMS} items each then {MAIN_STEPS} steps; then l1-qmc at "
        "int8")
    params = {"mu": np.zeros(0), "sig": np.zeros(0)}

    def keep_params(name, gids, p):
        if p is None:
            return
        end = int(gids.max()) + 1
        for key, v in zip(("mu", "sig"), p):
            if params[key].size < end:
                params[key] = np.resize(params[key], end)
            params[key][gids] = v.astype(np.float32)
    registry = ServableRegistry(device="cuda")
    counts, report = drive(lambda: serve_run(
        names, registry=registry, n_items=MAIN_ITEMS, steps=MAIN_STEPS,
        on_insert=keep_params, log=log), card, smi, TENANT_PATH,
        "tenants' path")
    reg8 = ServableRegistry(device="cuda")
    counts8, report8 = drive(lambda: serve_run(
        ("l1-qmc",), registry=reg8, n_items=MAIN_ITEMS, steps=MAIN_STEPS,
        precision="int8", log=log), card, smi,
        TENANT_PATH + ("quantized_query", "rerank"), "l1-qmc int8 path")
    for c, what in ((counts, "fp32"), (counts8, "int8")):
        if c["dct_mm"]:
            raise AssertionError(f"K4 launched {c['dct_mm']} times on the "
                                 f"{what} tenants, which embed without it")
    out = {}
    for name, reg, run_rep, tier in (
            ("l1-qmc", registry, report, "fp32"),
            ("w2-quantile", registry, report, "fp32"),
            ("l1-qmc", reg8, report8, "int8")):
        sv, rep = reg.get(name), run_rep[name]
        prof = profile_batches(sv)
        check_report(rep, f"{name} {tier}")
        stacked_parity(sv, prof, f"{name} {tier}")
        batch = sv.embed(probe_inputs(sv, np.random.default_rng(41), 32))
        scorer = stacked_scorer_record(sv.index, batch.cpu().numpy())
        log(f"  stacked scorer ({name} {tier}, p {sv.spec.p}) "
            + json.dumps(scorer))
        # A tenant's qps spans its first query to its report(), and the
        # fp32 run interleaves both tenants step by step, so that window
        # holds the other tenant's work too; the loop's rate, query rows of
        # every tenant of the run over the loop's wall, does not.
        loop_rate = (sum(r["query_rows"] for r in run_rep.values())
                     / rep["loop_s"])
        out[f"{name} {tier}"] = {
            "profile": prof, "stacked_scorer": scorer,
            "run_tenants": sorted(run_rep),
            "loop_query_rows_per_s": loop_rate, **{k: rep[k] for k in (
                "ingest_rows_per_s", "qps", "p50_ms", "p95_ms",
                "recall_at_k", "self_hit_rate", "held_frac", "n_segments",
                "n_live", "store_bytes_per_item", "max_memory_allocated")}}
    compare_tiers(registry.get("l1-qmc"), reg8.get("l1-qmc"), "l1-qmc")
    gate = w2_gate.run(device="cuda")
    log("  w2 oracle gate " + json.dumps(gate))
    if gate["best_recall_at_10"] < w2_gate.MIN_RECALL:
        raise AssertionError(f"W2 oracle gate: best recall@10 "
                             f"{gate['best_recall_at_10']} < "
                             f"{w2_gate.MIN_RECALL}")
    sv_w2 = registry.get("w2-quantile")
    oracle = w2_tenant_oracle(sv_w2, (params["mu"], params["sig"]))
    embed = w2_embed_record(sv_w2)
    res = {"w2_gate": gate, "w2_tenant_recall_at_10_vs_oracle": oracle,
           "w2_embed_per_128_rows": embed}
    log(f"  [{card}, {smi.split(',')[-1].strip()}] tenants " + json.dumps(
        {**{k: {kk: v[kk] for kk in ("recall_at_k", "self_hit_rate",
                                     "held_frac", "qps",
                                     "loop_query_rows_per_s", "p50_ms")}
            for k, v in out.items()}, **res}))
    out.update(res)
    return [counts, counts8], out


# -- phase 10: durability ------------------------------------------------------


DURABLE_SEED = 77
DURABLE_STEPS = 20
DURABLE_SEAL_STEP, DURABLE_COMPACT_STEP = 10, 15
DURABLE_FILL_BATCH = 8192
DURABLE_PROBES = 64
# wal.append events before the steps: REGISTER + one INSERT a fill batch;
# the kill lands at step 7's INSERT, with 14 step records durable
DURABLE_APPEND_KILL = 1 + MAIN_ITEMS // DURABLE_FILL_BATCH + 15
INGEST_BATCHES, INGEST_ROWS = 128, 64
CHILD_TIMEOUT_S = 300


def durable_workload(reg, precision, ckpt_dir, between_steps=None):
    """The phase's workload, the same in this process and in its children:
    register l2-basis at ``precision`` in ``reg``, fill MAIN_ITEMS items
    (embed + insert, 8,192 a batch), snapshot to ``ckpt_dir``, then
    DURABLE_STEPS demo steps (64 inserts and 3 deletes of filled items a
    step, an explicit seal at step 10, a compaction at step 15).  Returns
    the servable and the fill's and the snapshot's seconds."""
    import torch
    sv = reg.register(tenant_spec("l2-basis", precision))
    rng = np.random.default_rng(DURABLE_SEED)
    t0 = time.perf_counter()
    for start in range(0, MAIN_ITEMS, DURABLE_FILL_BATCH):
        sv.insert(sv.embed(probe_inputs(
            sv, rng, min(DURABLE_FILL_BATCH, MAIN_ITEMS - start))))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reg.snapshot(ckpt_dir, step=1)
    snapshot_s = time.perf_counter() - t0
    for step in range(DURABLE_STEPS):
        sv.insert(sv.embed(probe_inputs(sv, rng, 64)))
        sv.delete((np.arange(3 * step, 3 * step + 3) * 997) % MAIN_ITEMS)
        if step == DURABLE_SEAL_STEP:
            sv.index.maintenance.seal()
        if step == DURABLE_COMPACT_STEP:
            sv.maintenance.compact()
        if between_steps is not None:
            between_steps(step)
    return sv, fill_s, snapshot_s


DURABLE_COUNTERS = ("wal_appends_total", "wal_bytes_total", "wal_fsyncs_total",
                    "ckpt_saves_total", "ckpt_restores_total",
                    "recovery_replayed_records_total",
                    "recovery_restores_total",
                    "standby_replayed_records_total",
                    "standby_promotions_total")


def counters(tenant="l2-basis"):
    """The durability counters of ``tenant`` in this process's metrics
    registry ({} in a checkout without telemetry)."""
    try:
        from repro_torch.obs import metrics as obs_metrics
    except ImportError:
        return {}
    reg = obs_metrics.registry()
    return {n: reg.value(n, tenant=tenant) or 0.0 for n in DURABLE_COUNTERS}


def counter_delta(before, after):
    return {n: after[n] - before[n] for n in after}


def durable_probes(sv):
    """The phase's 64 probe rows (fresh functions, embedded)."""
    return sv.embed(probe_inputs(sv, np.random.default_rng(4242),
                                 DURABLE_PROBES)).cpu().numpy()


def durable_child(job: dict) -> int:
    """A child process of phase 10 on the card: ``crash`` runs the
    workload under a kill plan (and must not survive it); ``recover``
    recovers the crashed tenant, answers the probes, replays the whole log
    again (duplicates must drop, no bit may change) and saves the answers
    and its timings to ``job["out"]``."""
    import torch
    from repro_torch.serve import ServableRegistry, faults
    if job["mode"] == "crash":
        faults.install(faults.FaultPlan(
            faults.FaultSpec(job["site"], job["nth"], "kill")))
        durable_workload(ServableRegistry(device="cuda", wal_dir=job["wal"]),
                         job["precision"], job["ckpt"])
        print("SURVIVED", flush=True)
        return 3
    reg = ServableRegistry(device="cuda")
    before = counters()
    t0 = time.perf_counter()
    reports = reg.recover(ckpt_root=job["ckpt"], wal_dir=job["wal"])
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    rec_counters = counter_delta(before, counters())
    sv = reg.get("l2-basis")
    probes = durable_probes(sv)
    first = answer(sv.index, probes)
    again = sv.index.replay(str(Path(job["wal"]) / "l2-basis.wal"))
    second = answer(sv.index, probes)
    if again["dropped_duplicates"] <= 0 or not same(first, second):
        print(f"second replay changed the answers or dropped nothing: "
              f"{again}", flush=True)
        return 4
    rep = reports["l2-basis"]
    np.savez(job["out"], gids=first[0], dist_bits=first[1])
    Path(job["out"] + ".json").write_text(json.dumps({
        "recover_s": recover_s, "restored_step": rep["restored_step"],
        "replayed_records": rep.get("applied"),
        "tail_records": rep.get("n_records"),
        "counters": {n: v for n, v in rec_counters.items() if v},
        "truncated": rep.get("truncated"),
        "second_replay_dropped": again["dropped_duplicates"],
        "n_live": sv.index.n_live}))
    return 0


def run_child(job: dict, mode: str = "--durable-child"):
    """``chip_smoke.py --durable-child JOB`` (or another child ``mode``) in
    a fresh process, at most CHILD_TIMEOUT_S; returns the finished
    process."""
    return subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), mode,
         json.dumps(job)], capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S, cwd=ROOT)


def crash_and_recover(tmp, precision, site, nth):
    """A child runs the workload and is killed at ``site`` #``nth``; a
    fresh child recovers; this process replays the durable prefix into a
    fresh index (the uninterrupted run over it) and requires the
    recovered answers to equal its own bit for bit.  Returns the numbers."""
    import signal

    import torch
    from repro_torch.serve import ServableRegistry, wal
    from repro_torch.serve.registry import _spec_from_manifest
    d = Path(tmp) / f"{precision}-{site}"
    job = {"precision": precision, "wal": str(d / "wal"),
           "ckpt": str(d / "ckpt"), "site": site, "nth": nth,
           "out": str(d / "answers.npz")}
    crash = run_child(dict(job, mode="crash"))
    if crash.returncode != -signal.SIGKILL or "SURVIVED" in crash.stdout:
        raise AssertionError(f"durability ({precision}): the child was not "
                             f"killed at {site}#{nth} (rc "
                             f"{crash.returncode})\n{crash.stderr[-2000:]}")
    rec = run_child(dict(job, mode="recover"))
    if rec.returncode != 0:
        raise AssertionError(f"durability ({precision}): recovery after "
                             f"{site}#{nth} failed (rc {rec.returncode})\n"
                             f"{rec.stdout[-1000:]}{rec.stderr[-2000:]}")
    wpath = str(d / "wal" / "l2-basis.wal")
    ref = ServableRegistry(device="cuda").register(
        _spec_from_manifest(wal.read_spec(wpath)))
    t0 = time.perf_counter()
    rep = ref.index.replay(wpath)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    rows = sum(r.gids.size for r in wal.read_wal(wpath)[0]
               if r.op == wal.OP_INSERT)
    got = np.load(job["out"])
    want = answer(ref.index, durable_probes(ref))
    if not same((got["gids"], got["dist_bits"]), want):
        raise AssertionError(f"durability ({precision}): recovery after "
                             f"{site}#{nth} is not bit-equal to the "
                             "uninterrupted run over the durable prefix")
    child = json.loads(Path(job["out"] + ".json").read_text())
    if child["n_live"] != ref.index.n_live or (want[0] < 0).all():
        raise AssertionError(f"durability ({precision}): {child} vs "
                             f"{ref.index.n_live} live")
    got_c = child.get("counters")
    if got_c is not None and (
            got_c.get("recovery_replayed_records_total")
            != child["tail_records"]
            or got_c.get("recovery_restores_total") != 1
            or got_c.get("ckpt_restores_total") != 1):
        raise AssertionError(f"durability ({precision}): the recovery's "
                             f"counters {got_c} disagree with its report "
                             f"({child['tail_records']} tail records, one "
                             "restore)")
    return {"site": f"{site}#{nth}", **child,
            "durable_records": rep["n_records"],
            "reference_replay_s": replay_s,
            "replay_rows_per_s": rows / replay_s, "replayed_rows": rows}


def ingest_rates(tmp, precision):
    """Insert rows/s of INGEST_BATCHES 64-row batches (pre-embedded on the
    card) into an empty tenant with no WAL and with a WAL at fsync_every
    1, 8 and 0."""
    import torch
    from repro_torch.serve import ServableRegistry
    x = torch.randn((INGEST_BATCHES + 1) * INGEST_ROWS, 64,
                    generator=torch.Generator().manual_seed(3)).cuda()
    out = {}
    for fe in (None, 1, 8, 0):
        wal_dir = None if fe is None else str(Path(tmp) / f"ingest-{fe}")
        reg = ServableRegistry(device="cuda", wal_dir=wal_dir,
                               fsync_every=fe)
        sv = reg.register(tenant_spec("l2-basis", precision))
        sv.insert(x[:INGEST_ROWS])                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in range(1, INGEST_BATCHES + 1):
            sv.insert(x[b * INGEST_ROWS:(b + 1) * INGEST_ROWS])
        torch.cuda.synchronize()
        out["no_wal" if fe is None else f"fsync_every_{fe}"] = (
            INGEST_BATCHES * INGEST_ROWS / (time.perf_counter() - t0))
    return out


def durability_phase(card, smi, precision):
    """Phase 10 at one tier: the workload in this process with a WAL, a
    snapshot and a warm standby tailing the WAL (promoted at the end, it
    must answer bit-equal to the primary); the kill -9 at ``wal.append``
    and at ``compact.swap`` in children, each recovered in a fresh child
    and held bit for bit to a replay of its durable prefix; the ingest
    rates.  Returns the numbers."""
    import gc
    import tempfile

    import torch
    from repro_torch.serve import ServableRegistry, WalStandby, wal
    with tempfile.TemporaryDirectory(prefix="durability-") as tmp:
        wal_dir, ckpt_dir = Path(tmp) / "wal", Path(tmp) / "ckpt"
        reg = ServableRegistry(device="cuda", wal_dir=str(wal_dir))
        standby = WalStandby(str(wal_dir), device="cuda")
        lags, applied = [], []

        def tail(step):
            if step % 5 == 4:
                applied.append(standby.poll_once()["l2-basis"]["applied"])
                lags.append(standby.lag().get("l2-basis"))
        before = counters()
        sv, fill_s, snapshot_s = durable_workload(reg, precision,
                                                  str(ckpt_dir), tail)
        probes = durable_probes(sv)
        want = answer(sv.index, probes)
        t0 = time.perf_counter()
        promoted = standby.promote()["l2-basis"]
        promote_s = time.perf_counter() - t0
        if standby.running:
            raise AssertionError("durability: the standby's tailer lives")
        if not same(answer(standby.registry.get("l2-basis").index, probes),
                    want):
            raise AssertionError(f"durability ({precision}): the promoted "
                                 "standby differs from the primary")
        wal_bytes = (wal_dir / "l2-basis.wal").stat().st_size
        delta = counter_delta(before, counters())
        n_records = wal.read_wal(str(wal_dir / "l2-basis.wal"))[1][
            "n_records"]
        want_c = {"wal_bytes_total": wal_bytes,
                  "wal_appends_total": n_records, "ckpt_saves_total": 1,
                  "standby_replayed_records_total": sum(applied),
                  "standby_promotions_total": 1}
        if delta and any(delta[n] != v for n, v in want_c.items()):
            raise AssertionError(f"durability ({precision}): counters "
                                 f"{delta} disagree with the WAL's "
                                 f"{wal_bytes} bytes and {n_records} "
                                 f"records and the standby's {applied}")
        inserted = MAIN_ITEMS + DURABLE_STEPS * 64
        snap_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*")
                         if f.is_file())
        del reg, standby, sv
        gc.collect()
        torch.cuda.empty_cache()
        crashes = [crash_and_recover(tmp, precision, "wal.append",
                                     DURABLE_APPEND_KILL),
                   crash_and_recover(tmp, precision, "compact.swap", 1)]
        ingest = ingest_rates(tmp, precision)
    res = {"tier": precision, "items": MAIN_ITEMS, "steps": DURABLE_STEPS,
           "fill_rows_per_s_with_wal": MAIN_ITEMS / fill_s,
           "snapshot_bytes": snap_bytes, "snapshot_s": snapshot_s,
           "wal_bytes": wal_bytes,
           "wal_bytes_per_inserted_item": wal_bytes / inserted,
           "standby_lag_bytes_after_polls": lags,
           "standby_promote_s": promote_s,
           "standby_promote_applied": promoted["applied"],
           "standby_poll_applied": applied,
           "counters": {n: v for n, v in delta.items() if v},
           "crashes": crashes, "ingest_rows_per_s": ingest}
    log(f"  [{card}, {smi.split(',')[-1].strip()}] durability ({precision}) "
        + json.dumps(res))
    return res


# -- phase 15: the LM stack's dense transformer ------------------------------


LM_ARCH = "llama3.2-3b"
LM_TRAIN = dict(seq=2048, batch=4, accum=4, steps=4)   # (b) at full width
LM_SERVE = dict(batch=8, cache=2048, prompt=32, greedy=32,
                n_embed=64, n_hashes=16)               # (c) at full width
LM_SMOKE_STEPS = (40, 60)      # launch.train --smoke, then resumed


def has_lm() -> bool:
    try:
        from repro_torch.runtime import steps  # noqa: F401
    except ImportError:
        return False
    return True


def lm_pair(cfg, seed=0):
    """The model of ``cfg`` on the CPU and on the card, the card's loaded
    with the CPU's parameters through ``convert`` (the same bits)."""
    import torch
    from repro_torch import convert
    from repro_torch.models import get_model
    api = get_model(cfg)
    cpu = api.init(torch.Generator().manual_seed(seed))
    card = api.init(torch.Generator(device="cuda").manual_seed(seed))
    convert.lm_params_from_numpy(card, convert.lm_params_to_numpy(cpu))
    return api, cpu, card


def close(what, got, want, rtol, atol):
    """Raise unless card ``got`` is allclose to CPU ``want``; the max
    |difference|."""
    import torch
    got = got.detach().float().cpu()
    want = want.detach().float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"lm {what}: card vs CPU max err {err:.3g} "
                             f"(rtol {rtol}, atol {atol})")
    return err


def signature_apart(what, got, want, proj, margin=1e-4):
    """Signatures of one step on two devices: equal except where the
    reference projection lies within ``margin`` of an integer (counted).
    Returns that count."""
    near = (proj - proj.round()).abs() <= margin
    apart = (got.cpu() != want.cpu()) & ~near.cpu()
    if bool(apart.any()):
        raise AssertionError(f"lm {what}: {int(apart.sum())} hashes apart "
                             "off a floor boundary")
    return int(near.sum())


def cache_leaves(cache, prefix=""):
    """(name, tensor) of every leaf of a nested decode cache, in key
    order."""
    for key in sorted(cache):
        leaf = cache[key]
        if isinstance(leaf, dict):
            yield from cache_leaves(leaf, f"{prefix}{key}.")
        else:
            yield prefix + key, leaf


def smoke_batch(cfg, rng, b, s):
    """Tokens (B, S) and, for the enc-dec, frames (B, frontend_len, d)."""
    import torch
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                       dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor((rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)) * 0.1).astype(np.float32))
    return batch


def smoke_parity(cfg, seed, tag=""):
    """Phase 15 (a) and 16 (a): ``cfg`` (a smoke config, fp32) on the card
    against the CPU on the same parameters: forward, one accumulated train
    step's loss (aux included) and gradients, 16 decode steps through the
    serve step (logits, every cache leaf, signatures; the enc-dec's cross
    cache filled first), and the signature's K1 launch against its plain
    version."""
    import torch
    from repro_torch import convert
    from repro_torch.core import wasserstein
    from repro_torch.kernels import hash_mm, ref
    from repro_torch.runtime import steps as rt
    api, cpu, card = lm_pair(cfg)
    rng = np.random.default_rng(seed)
    batch = smoke_batch(cfg, rng, 8, 64)
    gbatch = {k: v.cuda() for k, v in batch.items()}
    out = {}
    with torch.no_grad():
        want, waux = api.forward(cpu, batch)
        got, gaux = api.forward(card, gbatch)
    out["forward_max_abs_err"] = close(f"{tag}forward", got, want, 1e-4, 1e-4)
    close(f"{tag}forward aux", gaux, waux, 1e-4, 1e-5)
    loss_fn = rt.make_loss_fn(api, cfg)
    lc, mc = rt.accumulate_grads(loss_fn, cpu, batch, cfg.grad_accum)
    lg, mg = rt.accumulate_grads(loss_fn, card, gbatch, cfg.grad_accum)
    out["loss_cpu"], out["loss_card"] = float(lc), float(lg)
    close(f"{tag}train loss", lg, lc, 1e-4, 1e-5)
    close(f"{tag}train aux", mg["aux"], mc["aux"], 1e-4, 1e-5)
    out["grad_max_abs_err"] = max(
        close(f"{tag}grad {n}", p.grad, q.grad, 1e-4, 1e-5)
        for (n, p), (_, q) in zip(card.named_parameters(),
                                  cpu.named_parameters()))
    for m in (cpu, card):
        m.zero_grad(set_to_none=True)
    lsh_cpu = rt.LshServeParams.create(torch.Generator().manual_seed(1), cfg)
    lsh_card = convert.lsh_serve_params_from_numpy(
        lsh_cpu.nodes, lsh_cpu.volume, lsh_cpu.support, lsh_cpu.alpha,
        lsh_cpu.b, lsh_cpu.r, device="cuda")
    serves = [rt.make_serve_step(api, cfg, lsh) for lsh in (lsh_cpu, lsh_card)]
    caches = [api.init_cache(8, 16, device=d) for d in ("cpu", "cuda")]
    if cfg.family == "encdec":
        with torch.no_grad():
            api.fill_cross_cache(cpu, caches[0], batch["frames"])
            api.fill_cross_cache(card, caches[1], gbatch["frames"])
    tok = batch["tokens"][:, :1]
    dec_err, boundary, k1, compared = 0.0, 0, 0.0, 0
    for pos in range(16):
        oc, caches[0] = serves[0](cpu, caches[0], tok, pos)
        og, caches[1] = serves[1](card, caches[1], tok.cuda(), pos)
        dec_err = max(dec_err, close(f"{tag}decode step {pos}", og["logits"],
                                     oc["logits"], 1e-4, 1e-4))
        emb_c = wasserstein.w2_embedding_logits(
            oc["logits"][:, 0], lsh_cpu.support, lsh_cpu.nodes,
            lsh_cpu.volume)
        emb_g = wasserstein.w2_embedding_logits(
            og["logits"][:, 0], lsh_card.support, lsh_card.nodes,
            lsh_card.volume)
        rows = (emb_g.cpu() == emb_c).all(dim=1)
        compared += int(rows.sum())
        _, proj = ref.hash_mm_proj_ref(emb_c, lsh_cpu.alpha, lsh_cpu.b,
                                       lsh_cpu.r)
        boundary += signature_apart(f"{tag}decode step {pos} signature",
                                    og["lsh_sig"][rows.cuda()],
                                    oc["lsh_sig"][rows], proj[rows])
        # K1 at the signature's launch against its plain version on the card
        h, p = hash_mm.hash_mm(emb_g.contiguous(), lsh_card.alpha,
                               lsh_card.b, lsh_card.r)
        hp, pp = ref.hash_mm_proj_ref(emb_g, lsh_card.alpha, lsh_card.b,
                                      lsh_card.r)
        k1 = max(k1, close(f"{tag}signature K1 projections", p, pp.cpu(),
                           1e-6, 1e-5))
        boundary += signature_apart(f"{tag}signature K1", h, hp, pp)
        tok = oc["next"]
    out["decode_max_abs_err"] = dec_err
    for (key, a), (_, b) in zip(cache_leaves(caches[1]),
                                cache_leaves(caches[0])):
        close(f"{tag}cache {key}", a, b, 1e-4, 1e-4)
    if compared < 16 * 8 - 8:
        raise AssertionError(f"lm {tag}: only {compared} of 128 decode rows "
                             "embed alike on both devices")
    out["signature_rows_compared"] = compared
    out["signature_boundary_values"] = boundary
    out["signature_k1_max_abs_err"] = k1
    return out


def lm_smoke_parity():
    """Phase 15 (a): the llama3.2-3b smoke config in fp32 on the card
    against the CPU on the same parameters (:func:`smoke_parity`), and the
    tiny setup's 30-step loss decrease."""
    import dataclasses

    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import BigramLM
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as rt
    out = smoke_parity(dataclasses.replace(smoke_config(LM_ARCH),
                                           grad_accum=4), 15)

    # the tiny setup of tests/test_train.py: 30 steps on the card
    tiny = dataclasses.replace(smoke_config(LM_ARCH), n_layers=2,
                               vocab_size=64)
    tapi = get_model(tiny)
    model = tapi.init(torch.Generator(device="cuda").manual_seed(0))
    ocfg = adamw.OptConfig(lr=3e-3, warmup_steps=5, total_steps=100,
                           weight_decay=0.0)
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    step = rt.make_train_step(tapi, tiny, ocfg)
    lm = BigramLM(tiny.vocab_size, seed=1, branch=4)
    losses = []
    for i in range(30):
        batch = {"tokens": torch.as_tensor(
            lm.sample(np.random.default_rng(i), 8, 32)).cuda()}
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0] - 0.3):
        raise AssertionError(f"lm: the tiny setup's loss did not fall on the "
                             f"card: {losses[::6]}")
    out["tiny_losses"] = [losses[0], losses[-1]]
    return out


def cuda_ms(fn):
    """``fn()``'s wall on the host clock, the card synchronised before and
    after (ms), and its result."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, res


LM_KERNEL_KINDS = (("gemm", ("gemm", "cutlass", "xmma", "sm90_", "cublas",
                             "nvjet")),
                   ("reduce", ("reduce",)),
                   ("copy", ("copy", "cat_", "CatArray", "Memcpy", "Memset",
                             "index", "gather", "scatter")),
                   ("elementwise", ("elementwise", "vectorized",
                                    "unrolled")))


def kernel_share(prof, ms):
    """The profiled call's kernel time over ``ms``, the same call's
    unprofiled wall (the profiler slows the host, not the kernels)."""
    k = prof["kernel_ms"]
    return k / ms if isinstance(k, float) else "not measured"


def lm_profile(fn):
    """Kernels of one call of ``fn()``, from the first profiled window that
    lost no kernel record of the call (``repro_torch.launch.profiled
    .kernel_records``; each window tried calls ``fn`` once): the call's
    wall on the host clock, the card's summed kernel time (busy share), the
    kernel count, the time by kind of kernel and the largest kernels.
    "not measured" where no window of ``profiled.ATTEMPTS`` was whole; the
    windows tried are reported either way."""
    import torch
    from repro_torch.launch import profiled
    kern, span_us, seen = profiled.kernel_records(fn, torch.device("cuda"))
    if kern is None:
        return {"windows": seen, "wall_ms": "not measured",
                "kernels": "not measured", "kernel_ms": "not measured",
                "busy_share": "not measured"}
    busy_us = sum(e.get("dur", 0) for e in kern)
    kinds = {k: 0.0 for k, _ in LM_KERNEL_KINDS}
    kinds["other"] = 0.0
    by_name: dict = {}
    for e in kern:
        name = e["name"]
        kind = next((k for k, tags in LM_KERNEL_KINDS
                     if any(t in name for t in tags)), "other")
        kinds[kind] += e["dur"] / 1e3
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"windows": seen, "wall_ms": span_us / 1e3, "kernels": len(kern),
            "kernel_ms": busy_us / 1e3, "busy_share": busy_us / span_us,
            "kernel_ms_by_kind": kinds, "top_kernels_ms": dict(top)}


def lm_train_full(api, model, smi):
    """Phase 15 (b): ``LM_TRAIN["steps"]`` steps of ``make_train_step`` at
    full width (seq 2,048, global batch 4, grad_accum 4, remat full, bf16
    compute, fp32 master weights and moments) on the synthetic stream;
    then ``launch.train`` with ``--smoke`` on the card, stopped and
    resumed."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch import roofline
    from repro_torch.launch import train as train_launch
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as rt
    tr = LM_TRAIN
    cfg = dataclasses.replace(api.cfg, grad_accum=tr["accum"])
    ocfg = adamw.OptConfig(warmup_steps=2, total_steps=tr["steps"])
    torch.cuda.reset_peak_memory_stats()
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    step = rt.make_train_step(api, cfg, ocfg)
    pipe = SyntheticPipeline(cfg, ShapeConfig("train", tr["seq"], tr["batch"],
                                              "train"), seed=0)
    times, losses, gnorms = [], [], []
    for i in range(tr["steps"]):
        batch = {k: torch.as_tensor(v).cuda()
                 for k, v in pipe.get_batch(i).items()}
        ms, (_, opt, m) = cuda_ms(lambda: step(model, opt, batch))
        times.append(ms)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        log(f"  lm train step {i}: {ms:.1f} ms, loss {losses[-1]:.4f}, "
            f"grad norm {gnorms[-1]:.4f}")
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        raise AssertionError(f"lm train: non-finite loss {losses} or grad "
                             f"norm {gnorms}")
    peak = torch.cuda.max_memory_allocated()
    # one more step in its two halves (forward + backward over the
    # micro-batches, then AdamW), each synchronised; then one profiled
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in pipe.get_batch(tr["steps"]).items()}
    named = dict(model.named_parameters())
    grads_ms, _ = cuda_ms(lambda: rt.accumulate_grads(
        rt.make_loss_fn(api, cfg), model, batch, tr["accum"]))
    adamw_ms, (_, opt, _) = cuda_ms(lambda: adamw.update(
        ocfg, {n: p.grad for n, p in named.items()}, opt, named))
    for p in named.values():
        p.grad = None
    prof = lm_profile(lambda: step(model, opt, batch))
    del opt, named
    step_s = statistics.median(times[1:]) / 1e3
    tokens = tr["batch"] * tr["seq"]
    flops = roofline.model_flops("train", cfg.active_param_count(),
                                 tr["batch"], tr["seq"])
    n_alloc = sum(p.numel() for p in model.parameters())
    res = {"arch": cfg.name, "params_allocated": n_alloc,
           "active_params": cfg.active_param_count(), **tr,
           "remat": cfg.remat, "dtype": cfg.dtype,
           "step_ms": step_s * 1e3, "step_ms_all": times,
           "tokens_per_s": tokens / step_s, "model_flops": flops,
           "model_flops_per_s": flops / step_s,
           "mfu": flops / step_s / roofline.BF16_TENSOR_OPS_PER_S,
           "max_memory_allocated": peak, "losses": losses,
           "grad_norms": gnorms, "grads_ms": grads_ms, "adamw_ms": adamw_ms,
           "adamw_bound_ms": 28 * n_alloc / roofline.HBM_BYTES_PER_S * 1e3,
           "profile": prof,
           "kernel_share_of_step": kernel_share(prof, step_s * 1e3)}

    # the launcher on the card: --smoke, stopped at 40 steps, resumed to 60
    with tempfile.TemporaryDirectory(prefix="lm-train-") as tmp:
        runs = []
        for n in LM_SMOKE_STEPS:
            ms, r = cuda_ms(lambda n=n: train_launch.main(
                ["--smoke", "--steps", str(n), "--ckpt", tmp]))
            runs.append((ms, r))
    (ms1, r1), (ms2, r2) = runs
    if r1.resumed_from is not None or r2.resumed_from != LM_SMOKE_STEPS[0]:
        raise AssertionError(f"lm launch.train: resumed_from "
                             f"{r1.resumed_from} then {r2.resumed_from}")
    if not (np.isfinite(r1.losses).all() and np.isfinite(r2.losses).all()
            and len(r2.losses) == LM_SMOKE_STEPS[1] - LM_SMOKE_STEPS[0]):
        raise AssertionError("lm launch.train: bad losses")
    res["launch_train_smoke"] = {
        "steps": list(LM_SMOKE_STEPS), "wall_ms": [ms1, ms2],
        "final_loss": [r1.losses[-1], r2.losses[-1]],
        "first_loss": r1.losses[0], "resumed_from": r2.resumed_from}
    return res


def lm_serve_full(api, model, smi):
    """Phase 15 (c): the serve step at full width with the W^2-LSH
    signature: batch 8, cache 2,048; rows 0-2 one 32-token prompt, rows 3-4
    another, fed token by token, then 32 greedy steps; the signature's
    dedup groups each step (rows 0-2 must share every signature); the
    greedy tokens against the teacher-forced forward's argmax."""
    import torch
    from repro_torch.launch import roofline
    from repro_torch.runtime import steps as rt
    sv = LM_SERVE
    cfg = api.cfg
    lsh = rt.LshServeParams.create(torch.Generator(device="cuda")
                                   .manual_seed(1), cfg,
                                   n_embed=sv["n_embed"],
                                   n_hashes=sv["n_hashes"])
    serve = rt.make_serve_step(api, cfg, lsh)
    b, t = sv["batch"], sv["prompt"] + sv["greedy"]
    rng = np.random.default_rng(29)
    prompts = rng.integers(0, cfg.vocab_size, (b, sv["prompt"]))
    prompts[1:3] = prompts[0]
    prompts[4] = prompts[3]
    prompts = torch.as_tensor(prompts, dtype=torch.int32).cuda()
    cache = api.init_cache(b, sv["cache"], device="cuda")
    fed, sigs, dec_logits, times = [], [], [], []
    tok = prompts[:, :1]
    for pos in range(t):
        ms, (out, cache) = cuda_ms(lambda: serve(model, cache, tok, pos))
        times.append(ms)
        fed.append(tok)
        sigs.append(out["lsh_sig"])
        dec_logits.append(out["logits"][:, 0])
        tok = (prompts[:, pos + 1:pos + 2] if pos + 1 < sv["prompt"]
               else out["next"])
    sigs = torch.stack(sigs, dim=1).cpu().numpy()        # (B, T, K)
    groups, shared_34 = [], 0
    for pos in range(t):
        rows = [tuple(r) for r in sigs[:, pos]]
        groups.append(len(set(rows)))
        if not rows[0] == rows[1] == rows[2]:
            raise AssertionError(f"lm serve: rows 0-2 signatures differ at "
                                 f"step {pos}")
        shared_34 += rows[3] == rows[4]
    seq = torch.cat(fed, dim=1)                           # (B, T)
    with torch.no_grad():
        full, _ = api.forward(model, {"tokens": seq})
    dec = torch.stack(dec_logits, dim=1)                  # (B, T, V)
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    scale = float(full.float().abs().max())
    delta = float((dec.float() - full.float()).abs().max()) / scale
    if not torch.isfinite(dec).all():
        raise AssertionError("lm serve: non-finite decode logits")
    step_s = statistics.median(times[1:]) / 1e3
    prof = lm_profile(lambda: serve(model, cache, tok, t))
    n_alloc = sum(p.numel() for p in model.parameters())
    cache_bytes = sum(c.numel() * c.element_size() for c in cache.values())
    nbytes = 4 * n_alloc + cache_bytes
    # the decode FLOPs are bf16 matrix products: the tensor cores' rate
    bound_s, by = roofline.bound_by(nbytes, roofline.model_flops(
        "decode", cfg.active_param_count(), b, 1),
        roofline.BF16_TENSOR_OPS_PER_S)
    return {"batch": b, "cache_len": sv["cache"], "steps": t,
            "decode_ms": step_s * 1e3, "tokens_per_s": b / step_s,
            "bound_ms": bound_s * 1e3, "bound_by": by,
            "bound_bytes": nbytes, "decode_ms_first": times[0],
            "dedup_groups": groups, "rows_3_4_shared_steps": shared_34,
            "greedy_vs_forward_argmax": agree,
            "max_abs_delta_over_scale": delta, "profile": prof,
            "kernel_share_of_step": kernel_share(prof, step_s * 1e3)}, lsh, out


def lm_k1_record(lsh, emb):
    """K1 at the signature's launch: X (B, 64) @ A (64, 16), timed as phase
    5 times K1, beside its plain version and the library's matmul."""
    import torch
    from repro_torch.kernels import hash_mm, ref
    a, bb, r = lsh.alpha, lsh.b, lsh.r
    m, n = emb.shape
    k = a.shape[1]
    h, p = hash_mm.hash_mm(emb, a, bb, r)
    hp, pp = ref.hash_mm_proj_ref(emb, a, bb, r)
    err = float((p - pp).abs().max())
    signature_apart("K1 record", h, hp, pp)

    def lib_hash():
        pj = torch.matmul(emb, a) / r + bb
        return torch.floor(pj).to(torch.int32), pj
    nbytes = 4 * (m * n + n * k + k + 2 * m * k)
    ops = 2 * m * n * k + 2 * m * k
    bound, by = bound_ms(nbytes, ops)
    return {"shape": f"X ({m}, {n}) @ A ({n}, {k})", "max_abs_err": err,
            "ms": time_ms(lambda: hash_mm.hash_mm(emb, a, bb, r)),
            "plain_ms": time_ms(lambda: ref.hash_mm_proj_ref(emb, a, bb, r)),
            "library_ms": time_ms(lib_hash), "bound_ms": bound,
            "bound_by": by, "bytes": nbytes, "ops": ops}


def lm_phase(card, smi):
    """Phase 15 (see the module docstring).  Returns (launch counts of the
    full-width serve, the numbers, the signature's K1 record)."""
    import gc
    import threading

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import wasserstein
    from repro_torch.models import get_model
    t0 = time.perf_counter()
    parity = lm_smoke_parity()
    log(f"  lm (a) {json.dumps(parity)}")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    api = get_model(cfg)
    ms, model = cuda_ms(lambda: api.init(
        torch.Generator(device="cuda").manual_seed(0)))
    train = lm_train_full(api, model, smi)
    train["init_ms"] = ms
    log(f"  [{card}, {smi.split(',')[-1].strip()}] lm train "
        + json.dumps(train))
    gc.collect()
    torch.cuda.empty_cache()
    kept = {}

    def serve():
        res, lsh, out = lm_serve_full(api, model, smi)
        kept.update(lsh=lsh, logits=out["logits"])
        return res
    counts, served = drive(serve, card, smi, ("hash_mm",), "lm serve")
    served["launches"] = counts
    log(f"  [{card}, {smi.split(',')[-1].strip()}] lm serve "
        + json.dumps(served))
    lsh = kept["lsh"]
    emb = wasserstein.w2_embedding_logits(
        kept["logits"][:, 0], lsh.support, lsh.nodes, lsh.volume).contiguous()
    k1 = lm_k1_record(lsh, emb)
    del model, kept
    gc.collect()
    torch.cuda.empty_cache()
    # host threads alive in this process (earlier phases' pumps and
    # workers share the interpreter lock with this phase's dispatch)
    line = {"card": smi, "parity": parity, "train": train, "serve": served,
            "k1_signature": k1, "host_threads": threading.active_count(),
            "wall_s": time.perf_counter() - t0}
    log(f"  phase 15 wall {line['wall_s']:.1f}s, {line['host_threads']} host "
        "threads")
    return counts, line, k1


# -- phase 16: the rest of the LM families ----------------------------------


FAMILIES = ("qwen2-moe-a2.7b", "arctic-480b", "mamba2-2.7b",
            "recurrentgemma-2b", "seamless-m4t-medium")
FAM_TRAIN = dict(seq=2048, batch=4, accum=4, steps=3)     # (b), phase 15's
FAM_SERVE = dict(batch=8, cache=2048, prompt=8, steps=16, frames=1024)
# (b) and (c) at full width; depth cut where one card cannot hold it
FAM_TRAIN_CUTS = {"qwen2-moe-a2.7b": (4, "n_layers 24 -> 4: 9.7 GB a layer of "
                                         "fp32 params, grads, m and v, the "
                                         "untied embeddings 10.0 GB; full "
                                         "depth ~242 GB")}
FAM_SERVE_CUTS = {"arctic-480b": (2, "n_layers 35 -> 2: ~27 GB a layer of "
                                     "bf16 weights; full depth ~940 GB")}
FAM_TRAINED = ("qwen2-moe-a2.7b", "mamba2-2.7b", "recurrentgemma-2b",
               "seamless-m4t-medium")


def has_families() -> bool:
    """Does this checkout build every family of the LM stack?"""
    return (ROOT / "src" / "repro_torch" / "models" / "moe.py").is_file()


def families_parity():
    """Phase 16 (a): each family's smoke config on the card against the
    CPU (:func:`smoke_parity`); mamba2 also trains a step at its config's
    SSD chunk of 256, whose gradients must be finite and agree."""
    import dataclasses

    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.runtime import steps as rt
    out = {}
    for i, arch in enumerate(FAMILIES):
        cfg = dataclasses.replace(smoke_config(arch), grad_accum=4)
        out[arch] = smoke_parity(cfg, 160 + i, tag=f"{arch} ")
    cfg = dataclasses.replace(smoke_config("mamba2-2.7b"), ssm_chunk=256)
    api, cpu, card = lm_pair(cfg)
    batch = smoke_batch(cfg, np.random.default_rng(169), 1, 256)
    loss_fn = rt.make_loss_fn(api, cfg)
    lc, _ = rt.accumulate_grads(loss_fn, cpu, batch, 1)
    lg, _ = rt.accumulate_grads(loss_fn, card, {k: v.cuda()
                                                for k, v in batch.items()}, 1)
    close("mamba2 chunk 256 loss", lg, lc, 1e-4, 1e-5)
    finite = all(bool(torch.isfinite(p.grad).all())
                 for p in card.parameters())
    if not finite:
        raise AssertionError("lm mamba2 chunk 256: non-finite gradients")
    out["mamba2_chunk256"] = {
        "loss": float(lg), "grads_finite": finite,
        "grad_max_abs_err": max(
            close(f"mamba2 chunk 256 grad {n}", p.grad, q.grad, 1e-4, 1e-5)
            for (n, p), (_, q) in zip(card.named_parameters(),
                                      cpu.named_parameters()))}
    return out


def family_config(arch, cuts):
    """The arch's own config, its depth cut where ``cuts`` says: (cfg, the
    cut's text or None)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch not in cuts:
        return cfg, None
    n, why = cuts[arch]
    return dataclasses.replace(cfg, n_layers=n), why


def family_train(api, model):
    """Phase 16 (b): ``FAM_TRAIN["steps"]`` steps of ``make_train_step`` at
    seq 2,048 x global batch 4, grad_accum 4, on the synthetic stream (the
    enc-dec's frames one a token)."""
    import dataclasses

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch import roofline
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as rt
    tr = FAM_TRAIN
    cfg = dataclasses.replace(api.cfg, grad_accum=tr["accum"])
    ocfg = adamw.OptConfig(warmup_steps=1, total_steps=tr["steps"])
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    step = rt.make_train_step(api, cfg, ocfg)
    pipe = SyntheticPipeline(cfg, ShapeConfig("train", tr["seq"], tr["batch"],
                                              "train"), seed=0)
    times, losses, gnorms = [], [], []
    for i in range(tr["steps"]):
        batch = {k: torch.as_tensor(v).cuda()
                 for k, v in pipe.get_batch(i).items()}
        ms, (_, opt, m) = cuda_ms(lambda: step(model, opt, batch))
        times.append(ms)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        log(f"  lm {cfg.name} train step {i}: {ms:.1f} ms, loss "
            f"{losses[-1]:.4f}, grad norm {gnorms[-1]:.4f}")
    del opt
    non_finite = sum(not (np.isfinite(a) and np.isfinite(b))
                     for a, b in zip(losses, gnorms))
    if non_finite:
        raise AssertionError(f"lm {cfg.name} train: {non_finite} non-finite "
                             f"steps: losses {losses}, grad norms {gnorms}")
    step_s = statistics.median(times[1:]) / 1e3
    tokens = tr["batch"] * tr["seq"]
    flops = roofline.model_flops("train", cfg.active_param_count(),
                                 tr["batch"], tr["seq"])
    return {"params_allocated": sum(p.numel() for p in model.parameters()),
            "active_params": cfg.active_param_count(), **tr,
            "remat": cfg.remat, "dtype": cfg.dtype,
            "param_dtype": cfg.param_dtype,
            "step_ms": step_s * 1e3, "step_ms_all": times,
            "tokens_per_s": tokens / step_s, "model_flops": flops,
            "mfu": flops / step_s / roofline.BF16_TENSOR_OPS_PER_S,
            "non_finite_steps": non_finite, "losses": losses,
            "grad_norms": gnorms}


def family_serve(api, model, arch_seed):
    """Phase 16 (c) and (d): the serve step with the W^2-LSH signature at
    batch 8, cache 2,048: rows 0-2 one prompt (and, for the enc-dec, one
    set of 1,024 frames, encoded into the cross cache first), rows 3-4
    another, ``FAM_SERVE["prompt"]`` prompt tokens then greedy, 16 steps in
    all; rows 0-2 must share every signature and K1 must launch once a
    step.  Then one decode step profiled."""
    import torch
    from repro_torch.core import wasserstein
    from repro_torch.kernels import dispatch
    from repro_torch.launch import roofline
    from repro_torch.runtime import steps as rt
    sv = FAM_SERVE
    cfg = api.cfg
    lsh = rt.LshServeParams.create(torch.Generator(device="cuda")
                                   .manual_seed(1), cfg)
    serve = rt.make_serve_step(api, cfg, lsh)
    b, t = sv["batch"], sv["steps"]
    rng = np.random.default_rng(arch_seed)
    prompts = rng.integers(0, cfg.vocab_size, (b, sv["prompt"]))
    prompts[1:3] = prompts[0]
    prompts[4] = prompts[3]
    prompts = torch.as_tensor(prompts, dtype=torch.int32).cuda()
    extra = {}
    if cfg.family == "encdec":
        frames = (rng.standard_normal((b, sv["frames"], cfg.d_model))
                  * 0.1).astype(np.float32)
        frames[1:3] = frames[0]
        frames[4] = frames[3]
        extra["enc_len"] = sv["frames"]
    cache = api.init_cache(b, sv["cache"], device="cuda", **extra)
    fill_ms = None
    if cfg.family == "encdec":
        fill_ms, _ = cuda_ms(lambda: api.fill_cross_cache(
            model, cache, torch.as_tensor(frames).cuda()))
    k1_before = dispatch.launches["hash_mm"]
    sigs, times = [], []
    tok = prompts[:, :1]
    for pos in range(t):
        ms, (out, cache) = cuda_ms(lambda: serve(model, cache, tok, pos))
        times.append(ms)
        if not bool(torch.isfinite(out["logits"]).all()):
            raise AssertionError(f"lm {cfg.name} serve: non-finite logits "
                                 f"at step {pos}")
        sigs.append(out["lsh_sig"])
        tok = (prompts[:, pos + 1:pos + 2] if pos + 1 < sv["prompt"]
               else out["next"])
    k1 = dispatch.launches["hash_mm"] - k1_before
    if k1 != t:
        raise AssertionError(f"lm {cfg.name} serve: K1 launched {k1} times "
                             f"in {t} steps")
    sigs = torch.stack(sigs, dim=1).cpu().numpy()        # (B, T, K)
    groups, shared_34 = [], 0
    for pos in range(t):
        rows = [tuple(r) for r in sigs[:, pos]]
        groups.append(len(set(rows)))
        if not rows[0] == rows[1] == rows[2]:
            raise AssertionError(f"lm {cfg.name} serve: rows 0-2 signatures "
                                 f"differ at step {pos}")
        shared_34 += rows[3] == rows[4]
    step_s = statistics.median(times[1:]) / 1e3
    prof = lm_profile(lambda: serve(model, cache, tok, t))
    cache_bytes = sum(c.numel() * c.element_size()
                      for _, c in cache_leaves(cache))
    nbytes = sum(p.numel() * p.element_size()
                 for p in model.parameters()) + cache_bytes
    bound_s, by = roofline.bound_by(nbytes, roofline.model_flops(
        "decode", cfg.active_param_count(), b, 1),
        roofline.BF16_TENSOR_OPS_PER_S)
    emb = wasserstein.w2_embedding_logits(
        out["logits"][:, 0], lsh.support, lsh.nodes, lsh.volume).contiguous()
    return {"batch": b, "cache_len": sv["cache"], "steps": t,
            "params_allocated": sum(p.numel() for p in model.parameters()),
            "param_dtype": cfg.param_dtype,
            "decode_ms": step_s * 1e3, "tokens_per_s": b / step_s,
            "decode_ms_first": times[0], "bound_ms": bound_s * 1e3,
            "bound_by": by, "bound_bytes": nbytes, "cache_bytes": cache_bytes,
            "fill_cross_cache_ms": fill_ms, "k1_launches": k1,
            "dedup_groups": groups, "rows_3_4_shared_steps": shared_34,
            "profile": prof,
            "kernel_share_of_step": kernel_share(prof, step_s * 1e3)
            }, lsh, emb


def families_phase(card, smi):
    """Phase 16 (see the module docstring).  Returns (launch counts of the
    serve runs (c), the numbers, the signature's K1 record)."""
    import gc
    import threading

    import torch
    from repro_torch.models import get_model
    t0 = time.perf_counter()
    tag = f"[{card}, {smi.split(',')[-1].strip()}]"
    line = {"card": smi, "parity": families_parity()}
    log(f"  lm families (a) {json.dumps(line['parity'])}")
    gc.collect()
    torch.cuda.empty_cache()
    train, served, kept = {}, {}, {}

    def fresh(cfg):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        api = get_model(cfg)
        ms, model = cuda_ms(lambda: api.init(
            torch.Generator(device="cuda").manual_seed(0)))
        return api, model, ms

    def serve_all():
        for i, arch in enumerate(FAMILIES):
            model = None
            if arch in FAM_TRAINED:
                cfg, cut = family_config(arch, FAM_TRAIN_CUTS)
                api, model, init_ms = fresh(cfg)
                res = family_train(api, model)
                res.update(arch=arch, cut=cut, init_ms=init_ms,
                           max_memory_allocated=torch.cuda
                           .max_memory_allocated())
                train[arch] = res
                log(f"  {tag} lm {arch} train " + json.dumps(res))
                if cut is not None:     # serve the uncut config
                    del api, model
                    model = None
            cfg, cut = family_config(arch, FAM_SERVE_CUTS)
            if model is None:
                api, model, init_ms = fresh(cfg)
            else:
                init_ms = None
                torch.cuda.reset_peak_memory_stats()
            res, lsh, emb = family_serve(api, model, 1600 + i)
            res.update(arch=arch, cut=cut, init_ms=init_ms,
                       max_memory_allocated=torch.cuda.max_memory_allocated())
            served[arch] = res
            kept.update(lsh=lsh, emb=emb)
            log(f"  {tag} lm {arch} serve " + json.dumps(res))
            del api, model
            gc.collect()
            torch.cuda.empty_cache()
        return served

    counts, _ = drive(serve_all, card, smi, ("hash_mm",), "lm families")
    k1 = lm_k1_record(kept["lsh"], kept["emb"])
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    line.update(train=train, serve=served, launches=counts, k1_signature=k1,
                cuts={"train": {a: c[1] for a, c in FAM_TRAIN_CUTS.items()},
                      "serve": {a: c[1] for a, c in FAM_SERVE_CUTS.items()}},
                host_threads=threading.active_count(),
                wall_s=time.perf_counter() - t0)
    log(f"  phase 16 wall {line['wall_s']:.1f}s, {line['host_threads']} host "
        "threads")
    return counts, line, k1


# -- phase 17: training on a mesh -----------------------------------------------


MESH_SHAPE = (2, 4)
MESH_CONFIGS = (("llama3.2-3b", {}), ("qwen2-moe-a2.7b", {}),
                ("internlm2-20b", {"fsdp_params": True}))
MESH_TRAIN = dict(seq=2048, batch=4, accum=4, steps=3)   # phase 15's shape
# (b) trains at full width on 8 ranks of the one card: each rank holds its
# blocks of the fp32 params and both moments (TP over model, a copy per data
# rank), and a step gathers the whole model and its fp32 gradient
MESH_TRAIN_CUT = (15, "n_layers 28 -> 15: on one card the 8 ranks hold 24 B "
                      "a parameter (fp32 params, m and v, one copy per data "
                      "rank), and a step adds the gathered fp32 model, the "
                      "reduced gradient and a data rank's gradient (12 B): "
                      "36 B x 2.0e9 params + ~5 GB of activations ~77 GB; "
                      "full depth ~127 GB")
MESH_SERVE = dict(batch=8, cache=2048, prompt=8, steps=16)
MESH_SMOKE_STEPS = (20, 30)    # launch.train --smoke --mesh-devices 8


def has_mesh_train() -> bool:
    """Does this checkout train on a mesh of ranks?"""
    return (ROOT / "src" / "repro_torch" / "sharding" / "rules.py").is_file()


def blocks_are_slices(what, s):
    """Raise unless every rank's block of ``s`` is its slice of the
    gathered tensor; the gathered tensor."""
    import torch
    from repro_torch.sharding import rules
    full = rules.gather(s)
    for r in s.ranks():
        if not torch.equal(s.block(*r), full[s.slices(*r)]):
            raise AssertionError(f"mesh {what}: rank {r}'s block is not its "
                                 "slice")
    return full


def mesh_sharded_step(api, cfg, model, mesh, ocfg, b, s):
    """The sharded train step of ``cfg`` on ``mesh`` and ``model``'s
    parameters laid out over it: (step, params, opt state)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import specs
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as rt
    shape = ShapeConfig("t", s, b, "train")
    step, pspec, _, _ = rt.shard_train_step(
        api, cfg, ocfg, mesh, shape, model, specs.batch_specs(cfg, shape))
    params = rt.shard_params(model, pspec, mesh)
    return step, params, adamw.init_sharded(ocfg, params)


def mesh_parity(arch, changes, seed):
    """Phase 17 (a): ``arch``'s smoke config (fp32, 4 micro-batches of 8 x
    64 tokens) trained 2 steps by ``shard_train_step`` on a (2, 4) mesh of
    ``cuda:0`` ranks, against the same on ``cpu`` ranks and against the
    unsharded ``make_train_step`` on the card: loss, every updated parameter
    and moment (phase 15 (a)'s bars), each rank's block its slice; then 16
    decode steps of ``shard_serve_step`` against ``make_serve_step`` on the
    card (logits, every cache leaf, signatures) and K1 against its plain
    version at the signature's launch."""
    import dataclasses

    import torch
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import wasserstein
    from repro_torch.kernels import hash_mm, ref
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as rt
    from repro_torch.sharding import rules
    cfg = dataclasses.replace(smoke_config(arch), grad_accum=4, **changes)
    api, cpu, card = lm_pair(cfg)
    init = convert.lm_params_to_numpy(cpu)
    ocfg = adamw.OptConfig()
    mesh_g = make_pod_mesh(MESH_SHAPE, "cuda")
    mesh_c = make_pod_mesh(MESH_SHAPE, "cpu")
    step_g, ps_g, os_g = mesh_sharded_step(api, cfg, card, mesh_g, ocfg, 8, 64)
    step_c, ps_c, os_c = mesh_sharded_step(api, cfg, cpu, mesh_c, ocfg, 8, 64)
    step1 = rt.make_train_step(api, cfg, ocfg)
    opt1 = adamw.init(ocfg, dict(card.named_parameters()))
    rng = np.random.default_rng(seed)
    out = {"arch": arch, "changes": changes, "losses": []}
    for i in range(2):
        batch = smoke_batch(cfg, rng, 8, 64)
        gbatch = {k: v.cuda() for k, v in batch.items()}
        ps_g, os_g, mg = step_g(ps_g, os_g, gbatch)
        ps_c, os_c, mc = step_c(ps_c, os_c, batch)
        _, opt1, m1 = step1(card, opt1, gbatch)
        for key in ("loss", "aux", "grad_norm"):
            close(f"{arch} mesh {key} (card vs cpu ranks)", mg[key], mc[key],
                  1e-4, 1e-5)
            close(f"{arch} mesh {key} (mesh vs unsharded)", mg[key],
                  m1[key].cpu(), 1e-4, 1e-5)
        out["losses"].append([float(mg["loss"]), float(mc["loss"]),
                              float(m1["loss"])])
    named = dict(card.named_parameters())
    errs = {"param": 0.0, "moment": 0.0}
    for n in named:
        full_g = blocks_are_slices(f"{arch} {n}", ps_g[n])
        full_c = blocks_are_slices(f"{arch} {n} (cpu)", ps_c[n])
        errs["param"] = max(errs["param"],
                            close(f"{arch} mesh param {n}", full_g, full_c,
                                  1e-4, 1e-5),
                            close(f"{arch} mesh param {n} vs unsharded",
                                  full_g, named[n].detach().cpu(), 1e-4,
                                  1e-5))
        for key in ("m", "v"):
            mom = blocks_are_slices(f"{arch} {key} {n}", os_g[key][n])
            errs["moment"] = max(errs["moment"], close(
                f"{arch} mesh {key} {n}", mom, opt1[key][n].cpu(), 1e-4,
                1e-5))
    out["param_max_abs_err"], out["moment_max_abs_err"] = (errs["param"],
                                                           errs["moment"])
    del ps_g, os_g, ps_c, os_c, opt1

    # serve: the untrained weights, sharded and not, on the card
    convert.lm_params_from_numpy(card, init)
    lsh = rt.LshServeParams.create(torch.Generator(device="cuda")
                                   .manual_seed(1), cfg)
    serve = rt.make_serve_step(api, cfg, lsh)
    cache = api.init_cache(8, 16, device="cuda")
    sstep, pspec, cspec = rt.shard_serve_step(
        api, cfg, mesh_g, ShapeConfig("d", 16, 8, "decode"), card, cache, lsh)
    sparams = rt.shard_params(card, pspec, mesh_g)
    scache = rules.shard_tree(cache, cspec, mesh_g)
    tok = smoke_batch(cfg, rng, 8, 1)["tokens"].cuda()
    dec_err, boundary, k1 = 0.0, 0, 0.0
    for pos in range(16):
        want, cache = serve(card, cache, tok, pos)
        got, scache = sstep(sparams, scache, tok, pos)
        dec_err = max(dec_err, close(f"{arch} mesh decode step {pos}",
                                     got["logits"], want["logits"].cpu(),
                                     1e-4, 1e-4))
        emb = wasserstein.w2_embedding_logits(
            want["logits"][:, 0], lsh.support, lsh.nodes, lsh.volume)
        _, proj = ref.hash_mm_proj_ref(emb, lsh.alpha, lsh.b, lsh.r)
        boundary += signature_apart(f"{arch} mesh signature {pos}",
                                    got["lsh_sig"], want["lsh_sig"], proj)
        emb_g = wasserstein.w2_embedding_logits(
            got["logits"][:, 0], lsh.support, lsh.nodes,
            lsh.volume).contiguous()
        h, p = hash_mm.hash_mm(emb_g, lsh.alpha, lsh.b, lsh.r)
        hp, pp = ref.hash_mm_proj_ref(emb_g, lsh.alpha, lsh.b, lsh.r)
        k1 = max(k1, close(f"{arch} mesh K1 projections", p, pp.cpu(), 1e-6,
                           1e-5))
        boundary += signature_apart(f"{arch} mesh K1", h, hp, pp)
        tok = want["next"]
    for (key, full), (_, s) in zip(cache_leaves(cache), cache_leaves(scache)):
        close(f"{arch} mesh cache {key}", blocks_are_slices(key, s),
              full.cpu(), 1e-4, 1e-4)
    out.update(cache_spec=cspec, decode_max_abs_err=dec_err,
               signature_boundary_values=boundary,
               signature_k1_max_abs_err=k1)
    return out


def mesh_train_full(smi):
    """Phase 17 (b), training: llama3.2-3b at full width, its depth cut to
    ``MESH_TRAIN_CUT``, on the (2, 4) mesh of ``cuda:0`` ranks:
    ``MESH_TRAIN["steps"]`` sharded steps at seq 2,048, global batch 4,
    grad_accum 4; each rank's parameter and moment bytes against the dry
    run's prediction for the cell, to the byte."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules
    tr = MESH_TRAIN
    cfg = dataclasses.replace(get_config(LM_ARCH), grad_accum=tr["accum"],
                              n_layers=MESH_TRAIN_CUT[0])
    shape = ShapeConfig("train", tr["seq"], tr["batch"], "train")
    api = get_model(cfg)
    mesh = make_pod_mesh(MESH_SHAPE, "cuda")
    ocfg = adamw.OptConfig(warmup_steps=1, total_steps=tr["steps"])
    torch.cuda.reset_peak_memory_stats()
    model = api.init(torch.Generator(device="cuda").manual_seed(0))
    step, params, opt = mesh_sharded_step(api, cfg, model, mesh, ocfg,
                                          tr["batch"], tr["seq"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    plan = dryrun.plan_cell(cfg, shape, make_pod_mesh(MESH_SHAPE, "meta"))
    per = plan["per_rank"]
    ranks = {}
    for r in rules.ranks(mesh):
        got = (rules.rank_bytes(params, *r),
               rules.rank_bytes({"m": opt["m"], "v": opt["v"]}, *r))
        if got != (per["param_bytes"], per["moment_bytes"]):
            raise AssertionError(f"mesh train: rank {r} holds {got} bytes "
                                 f"of params and moments, the dry run "
                                 f"predicts {per['param_bytes']}, "
                                 f"{per['moment_bytes']}")
        ranks[f"{r[0]},{r[1]}"] = got
    pipe = SyntheticPipeline(cfg, shape, seed=0)
    times, losses, gnorms = [], [], []
    for i in range(tr["steps"]):
        batch = {k: torch.as_tensor(v) for k, v in pipe.get_batch(i).items()}
        ms, (params, opt, m) = cuda_ms(lambda: step(params, opt, batch))
        times.append(ms)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        log(f"  mesh train step {i}: {ms:.1f} ms, loss {losses[-1]:.4f}, "
            f"grad norm {gnorms[-1]:.4f}")
    non_finite = sum(not (np.isfinite(a) and np.isfinite(b))
                     for a, b in zip(losses, gnorms))
    if non_finite:
        raise AssertionError(f"mesh train: {non_finite} non-finite steps: "
                             f"losses {losses}, grad norms {gnorms}")
    peak = torch.cuda.max_memory_allocated()
    prof = lm_profile(lambda: step(params, opt, batch))
    del params, opt
    step_s = statistics.median(times[1:]) / 1e3
    flops = roofline.model_flops("train", cfg.active_param_count(),
                                 tr["batch"], tr["seq"])
    return {"arch": cfg.name, "mesh": list(MESH_SHAPE), **tr,
            "profile": prof,
            "kernel_share_of_step": kernel_share(prof, step_s * 1e3),
            "n_layers": cfg.n_layers, "cut": MESH_TRAIN_CUT[1],
            "params": cfg.param_count(), "remat": cfg.remat,
            "dtype": cfg.dtype, "step_ms": step_s * 1e3, "step_ms_all": times,
            "tokens_per_s": tr["batch"] * tr["seq"] / step_s,
            "model_flops": flops,
            "mfu": flops / step_s / roofline.BF16_TENSOR_OPS_PER_S,
            "max_memory_allocated": peak, "non_finite_steps": non_finite,
            "losses": losses, "grad_norms": gnorms,
            "rank_param_moment_bytes": ranks,
            "dry_run_per_rank": per,
            "dry_run_peak_bytes": plan["roofline"]["memory_stats"][
                "peak_bytes"]}


def mesh_serve_full(card, smi):
    """Phase 17 (b), serving: llama3.2-3b at full width and depth, its
    parameters and a batch 8 x 2,048 cache sharded over the (2, 4) mesh,
    ``MESH_SERVE["steps"]`` steps of ``shard_serve_step`` (rows 0-2 one
    prompt, rows 3-4 another, ``MESH_SERVE["prompt"]`` tokens then greedy;
    launch counts read around them: K1 once a step), rows 0-2 sharing
    every signature; then the unsharded ``make_serve_step`` on the same
    weights, fed the same tokens: its decode ms beside the sharded step's,
    the logits' largest difference over their scale and the greedy
    tokens' agreement.  Returns (launch counts, numbers, the LSH params,
    the last logits)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models import get_model
    from repro_torch.runtime import steps as rt
    from repro_torch.sharding import rules
    sv = MESH_SERVE
    cfg = get_config(LM_ARCH)
    api = get_model(cfg)
    mesh = make_pod_mesh(MESH_SHAPE, "cuda")
    torch.cuda.reset_peak_memory_stats()
    model = api.init(torch.Generator(device="cuda").manual_seed(0))
    lsh = rt.LshServeParams.create(torch.Generator(device="cuda")
                                   .manual_seed(1), cfg)
    b, t = sv["batch"], sv["cache"]
    cache = api.init_cache(b, t, device="cuda")
    sstep, pspec, cspec = rt.shard_serve_step(
        api, cfg, mesh, ShapeConfig("d", t, b, "decode"), model, cache, lsh)
    sparams = rt.shard_params(model, pspec, mesh)
    scache = rules.shard_tree(cache, cspec, mesh)
    rng = np.random.default_rng(31)
    prompts = rng.integers(0, cfg.vocab_size, (b, sv["prompt"]))
    prompts[1:3] = prompts[0]
    prompts[4] = prompts[3]
    prompts = torch.as_tensor(prompts, dtype=torch.int32).cuda()
    fed, outs, times = [], [], []

    def sharded():
        nonlocal scache
        tok = prompts[:, :1]
        for pos in range(sv["steps"]):
            ms, (got, scache) = cuda_ms(lambda: sstep(sparams, scache, tok,
                                                      pos))
            times.append(ms)
            fed.append(tok)
            outs.append(got)
            tok = (prompts[:, pos + 1:pos + 2] if pos + 1 < sv["prompt"]
                   else got["next"])
        return {}
    counts, _ = drive(sharded, card, smi, ("hash_mm",), "mesh serve")
    if counts["hash_mm"] != sv["steps"]:
        raise AssertionError(f"mesh serve: K1 launched {counts['hash_mm']} "
                             f"times in {sv['steps']} steps")
    for pos, got in enumerate(outs):
        if not torch.isfinite(got["logits"]).all():
            raise AssertionError(f"mesh serve: non-finite logits, step {pos}")
        rows = [tuple(r) for r in got["lsh_sig"].cpu().numpy()]
        if not rows[0] == rows[1] == rows[2]:
            raise AssertionError(f"mesh serve: rows 0-2 signatures differ "
                                 f"at step {pos}")
    for key, s in cache_leaves(scache):
        blocks_are_slices(f"serve cache {key}", s)
    step_ms = statistics.median(times[1:])
    prof = lm_profile(lambda: sstep(sparams, scache, outs[-1]["next"],
                                    sv["steps"]))
    serve = rt.make_serve_step(api, cfg, lsh)
    t_u, delta, agree = [], 0.0, 0
    for pos, (tok, got) in enumerate(zip(fed, outs)):
        ms, (want, cache) = cuda_ms(lambda: serve(model, cache, tok, pos))
        t_u.append(ms)
        scale = float(want["logits"].float().abs().max())
        delta = max(delta, float((got["logits"].float()
                                  - want["logits"].float()).abs().max())
                    / scale)
        agree += int((got["next"] == want["next"]).sum())
    res = {"arch": cfg.name, "mesh": list(MESH_SHAPE), "batch": b,
           "cache_len": t, "steps": sv["steps"], "prompt": sv["prompt"],
           "cache_spec": cspec,
           "decode_ms": step_ms,
           "decode_ms_unsharded": statistics.median(t_u[1:]),
           "decode_ms_all": times, "tokens_per_s": b / step_ms * 1e3,
           "profile": prof, "kernel_share_of_step": kernel_share(prof,
                                                                 step_ms),
           "k1_launches": counts["hash_mm"],
           "greedy_next_agree_unsharded": agree / (b * sv["steps"]),
           "max_abs_delta_over_scale": delta,
           "rows_0_2_share_every_signature": True,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    logits = outs[-1]["logits"]
    del sparams, scache, cache, model, outs
    return counts, res, lsh, logits


def mesh_restore_and_launcher(smi):
    """Phase 17 (c): a checkpoint of the smoke llama's parameters sharded
    over (2, 4) ``cuda:0`` ranks restored onto (4, 2), each block on its new
    rank and bit-equal; then ``launch.train --smoke --mesh-devices 8`` on
    the card to ``MESH_SMOKE_STEPS[0]`` steps and again to
    ``MESH_SMOKE_STEPS[1]``, which must resume."""
    import tempfile

    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import smoke_config
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models import get_model
    from repro_torch.runtime import steps as rt
    from repro_torch.sharding import rules
    cfg = smoke_config(LM_ARCH)
    model = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(4))
    m1 = make_pod_mesh(MESH_SHAPE, "cuda")
    m2 = make_pod_mesh(MESH_SHAPE[::-1], "cuda")
    params = rt.shard_params(model, rules.param_specs(cfg, model, m1), m1)
    spec2 = rules.param_specs(cfg, model, m2)
    with tempfile.TemporaryDirectory(prefix="mesh-ckpt-") as tmp:
        ms_save, _ = cuda_ms(lambda: ckpt.save(tmp, 1, {"params": params}))
        target = {"params": {n: ckpt.ArraySpec(tuple(p.shape), p.dtype)
                             for n, p in model.named_parameters()}}
        ms_restore, back = cuda_ms(lambda: ckpt.restore(
            tmp, 1, target, shardings={"params": rules.named(m2, spec2)}))
    n_blocks = 0
    for n, p in model.named_parameters():
        s = back["params"][n]
        if s.mesh is not m2 or s.spec != spec2[n]:
            raise AssertionError(f"mesh restore: {n} on {s.spec}")
        for r in s.ranks():
            if not torch.equal(s.block(*r), p.detach()[s.slices(*r)]):
                raise AssertionError(f"mesh restore: {n} rank {r} differs")
            n_blocks += 1
    out = {"restore": {"from": list(MESH_SHAPE), "to": list(MESH_SHAPE[::-1]),
                       "blocks_bit_equal": n_blocks, "save_ms": ms_save,
                       "restore_ms": ms_restore}}
    with tempfile.TemporaryDirectory(prefix="mesh-train-") as tmp:
        runs = []
        for n in MESH_SMOKE_STEPS:
            ms, r = cuda_ms(lambda n=n: train_launch.main(
                ["--smoke", "--mesh-devices", "8", "--steps", str(n),
                 "--ckpt", tmp]))
            runs.append((ms, r))
    (ms1, r1), (ms2, r2) = runs
    if r1.resumed_from is not None or r2.resumed_from != MESH_SMOKE_STEPS[0]:
        raise AssertionError(f"mesh launch.train: resumed_from "
                             f"{r1.resumed_from} then {r2.resumed_from}")
    if not (np.isfinite(r1.losses).all() and np.isfinite(r2.losses).all()
            and len(r2.losses) == MESH_SMOKE_STEPS[1] - MESH_SMOKE_STEPS[0]):
        raise AssertionError("mesh launch.train: bad losses")
    out["launch_train_mesh"] = {
        "steps": list(MESH_SMOKE_STEPS), "wall_ms": [ms1, ms2],
        "first_loss": r1.losses[0],
        "final_loss": [r1.losses[-1], r2.losses[-1]],
        "resumed_from": r2.resumed_from}
    return out


def mesh_compress():
    """Phase 17 (d): ``ef_compress`` and ``compressed_psum`` over 8 ranks on
    the card against the CPU: codes and scales bit-equal, the means and the
    carried errors allclose."""
    import torch
    from repro_torch.optim import compress
    gen = torch.Generator().manual_seed(17)
    shapes = {"wq": (3072, 24, 128), "bias": (3072,), "tiny": (7, 5)}
    grads = [{k: torch.randn(s, generator=gen) * 1e-3 * (i + 1)
              for k, s in shapes.items()} for i in range(8)]
    errs = [{k: torch.randn(s, generator=gen) * 1e-6
             for k, s in shapes.items()} for _ in range(8)]
    card = lambda tree: {k: v.cuda() for k, v in tree.items()}  # noqa: E731
    n_codes = 0
    for g, e in zip(grads, errs):
        qc, sc, ec = compress.ef_compress(g, e)
        qg, sg, eg = compress.ef_compress(card(g), card(e))
        for k in shapes:
            if not (torch.equal(qg[k].cpu(), qc[k])
                    and torch.equal(bits(sg[k].cpu()), bits(sc[k]))):
                raise AssertionError(f"mesh compress: {k} codes or scale "
                                     "differ on the card")
            close(f"compress error {k}", eg[k], ec[k], 0, 1e-9)
            n_codes += qc[k].numel()
    mc, _ = compress.compressed_psum(grads, errs)
    mg, _ = compress.compressed_psum([card(g) for g in grads],
                                     [card(e) for e in errs])
    err = max(close(f"compressed_psum {k}", mg[i][k], mc[i][k], 1e-6, 1e-9)
              for i in range(8) for k in shapes)
    return {"ranks": 8, "codes_bit_equal": n_codes,
            "psum_mean_max_abs_err": err}


def mesh_dry_run():
    """Phase 17 (e): the dry run over every (arch x shape) cell of the
    production 16 x 16 mesh on ``meta``, and its table."""
    from repro_torch.launch import dryrun, report
    t0 = time.perf_counter()
    results = dryrun.run(log=lambda s: None)
    wall = time.perf_counter() - t0
    bad = {k: v for k, v in results.items()
           if v["status"] not in ("ok", "skipped")}
    if bad:
        raise AssertionError(f"mesh dry run: {sorted(bad)} failed")
    for line in report.table(results, "single"):
        log(f"  {line}")
    return {"cells": len(results),
            "ok": sum(v["status"] == "ok" for v in results.values()),
            "skipped": sum(v["status"] == "skipped"
                           for v in results.values()),
            "fits": sorted(k for k, v in results.items()
                           if v.get("fits")),
            "train_4k": {k.split("/")[1]: {
                "fits": v["fits"], "fits_state": v["fits_state"],
                "state_gb": v["roofline"]["memory_stats"]["state_bytes"] / 1e9,
                "step_peak_gb": v["roofline"]["memory_stats"]["peak_bytes"]
                / 1e9} for k, v in results.items()
                if k.endswith("/train_4k")}, "wall_s": wall}


def mesh_phase(card, smi):
    """Phase 17 (see the module docstring).  Returns (launch counts of the
    full-width serve, the numbers, the signature's K1 record)."""
    import gc
    import threading

    import torch
    t0 = time.perf_counter()
    tag = f"[{card}, {smi.split(',')[-1].strip()}]"
    line = {"card": smi, "parity": {}}
    for i, (arch, changes) in enumerate(MESH_CONFIGS):
        line["parity"][arch] = mesh_parity(arch, changes, 170 + i)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"  {tag} mesh (a) {json.dumps(line['parity'])}")
    line["train"] = mesh_train_full(smi)
    log(f"  {tag} mesh (b) train {json.dumps(line['train'])}")
    gc.collect()
    torch.cuda.empty_cache()
    counts, line["serve"], lsh, logits = mesh_serve_full(card, smi)
    line["serve"]["launches"] = counts
    log(f"  {tag} mesh (b) serve {json.dumps(line['serve'])}")
    from repro_torch.core import wasserstein
    emb = wasserstein.w2_embedding_logits(
        logits[:, 0], lsh.support, lsh.nodes, lsh.volume).contiguous()
    k1 = lm_k1_record(lsh, emb)
    del logits, emb
    gc.collect()
    torch.cuda.empty_cache()
    line["restore"] = mesh_restore_and_launcher(smi)
    log(f"  {tag} mesh (c) {json.dumps(line['restore'])}")
    line["compress"] = mesh_compress()
    log(f"  {tag} mesh (d) {json.dumps(line['compress'])}")
    line["dry_run"] = mesh_dry_run()
    log(f"  {tag} mesh (e) {json.dumps(line['dry_run'])}")
    line.update(k1_signature=k1, host_threads=threading.active_count(),
                wall_s=time.perf_counter() - t0)
    log(f"  phase 17 wall {line['wall_s']:.1f}s, {line['host_threads']} host "
        "threads")
    return counts, line, k1


# -- main ---------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timings-only", action="store_true",
                    help="phases 1, 2, 4 and 5 only: build, parity (which "
                    "captures the timed inputs) and the kernel timings, "
                    "then one JSON line of timing records; to time another "
                    "checkout's kernels, copy this script to its root")
    ap.add_argument("--paths-only", action="store_true",
                    help="phases 1, 2 and 6-17 only: build, then the fp32, "
                    "int8 and simhash paths with their profiled batches, "
                    "the telemetry, the compactions, the front end, the "
                    "l1-qmc and "
                    "w2-quantile tenants, durability, the sharded path "
                    "the pod index, the LM stack, its families and training "
                    "on a mesh, then one "
                    "JSON "
                    "line of profiles and reports; to profile another "
                    "checkout, copy this script to its root")
    ap.add_argument("--pod-only", action="store_true",
                    help="phases 1, 2 and 14 only: build, then the pod "
                    "index against the CPU and the paper's cell, then one "
                    "JSON line of its numbers")
    ap.add_argument("--lm-only", action="store_true",
                    help="phases 1, 2 and 15 only: build, then the LM "
                    "stack against the CPU and at full width, then one JSON "
                    "line of its numbers")
    ap.add_argument("--families-only", action="store_true",
                    help="phases 1, 2 and 16 only: build, then the moe, ssm, "
                    "hybrid and enc-dec families against the CPU and at full "
                    "width, then one JSON line of their numbers")
    ap.add_argument("--mesh-only", action="store_true",
                    help="phases 1, 2 and 17 only: build, then training on a "
                    "mesh of ranks against the CPU and the unsharded steps, "
                    "at full width, the restore, the launcher, ef_compress "
                    "and the dry run, then one JSON line of their numbers")
    ap.add_argument("--durable-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--wire-client", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.wire_client is not None:
        return wire_client(json.loads(args.wire_client))
    import torch
    if args.durable_child is not None:
        torch.backends.cuda.matmul.allow_tf32 = False
        return durable_child(json.loads(args.durable_child))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, dispatch

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: IEEE
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    card = torch.cuda.get_device_name(0)
    log(f"[1/17] device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    floor_job = start_floor_build()
    spent = _build.build()
    floor_fn = finish_floor_build(floor_job)
    log(f"[2/17] build: {time.perf_counter() - t0:.2f}s wall "
        + json.dumps({k: round(v, 2) for k, v in spent.items()}))
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    if args.pod_only:
        log(f"[14/17] pod index ({smi}), alone")
        counts14, pod = pod_phase(card, smi)
        print(smi)
        print(json.dumps({"pod": pod}))
        return 0
    if args.lm_only:
        log(f"[15/17] LM stack ({smi}), alone")
        lm = lm_phase(card, smi)[1]
        print(smi)
        print(json.dumps({"lm": lm}))
        return 0
    if args.families_only:
        log(f"[16/17] LM families ({smi}), alone")
        families = families_phase(card, smi)[1]
        print(smi)
        print(json.dumps({"families": families}))
        return 0
    if args.mesh_only:
        log(f"[17/17] training on a mesh ({smi}), alone")
        mesh = mesh_phase(card, smi)[1]
        print(smi)
        print(json.dumps({"mesh": mesh}))
        return 0
    if args.paths_only:
        paths = run_paths(card, smi)[1]
        print(smi)
        print(json.dumps({"paths": paths}))
        return 0
    if args.timings_only:
        log("[4/17] CPU (plain versions) vs card (kernels) parity")
        k2_inputs = parity_run()
        captured = int8_parity_run()
        k2_p1_inputs = parity_run("l1-qmc") if has_tenants() else None
        log(f"[5/17] timings, {smi}")
        rec = timings(gen, k2_inputs, captured["k5"], captured["k6"], {},
                      floor_fn, k2_p1_inputs)
        print(smi)
        print(json.dumps({"timings": rec}))
        return 0
    log("[3/17] kernel checks against the plain versions on the card: "
        "hash_mm proj rtol 1e-6 atol 1e-5 and hashes equal where "
        "|proj - round(proj)| > 1e-4, bit-equal across batch sizes, "
        "saturated / infinite / NaN projections bit-equal, and with a "
        "lazily grown p = 1.5 alpha and a p = 0.5 alpha equal where "
        "|proj - round(proj)| > 1e-4 + 1e-6 (|x| @ |alpha| / r + |b|); "
        "dct_mm "
        "rtol 1e-5 atol 1e-5, bit-equal across batch sizes; "
        "fused_query distances rtol 1e-5 atol 1e-6 and ids equal at "
        "distinct distances; merge bit-identical (signs of zero included, "
        "as values only where a row pairs one id with both signs); "
        "quantized_query int8 at p in {1, 2} bit-identical, else as "
        "fused_query, and with one scale per segment of a stacked launch; "
        "each stacked launch's segments bit-equal to their own launches, "
        "at p = 2 and p = 1; "
        "rerank rtol 1e-5 atol 1e-6; "
        "simhash_pack bits equal where |proj| >= 1e-5 and bit-identical to "
        "its fmaf chain")
    errs = {}
    errs["hash_mm"] = max(check_hash_mm(gen, m, 64, 32)
                          for m in (8, 32, 128, 256))
    check_hash_mm(gen, 33, 50, 17)
    check_hash_mm(gen, 1, 64, 32)
    check_hash_mm(gen, 300, 96, 40, r=1.0)
    # the saturating conversion and ALSH draw from their own generator, so
    # the checks after them keep their inputs
    gen19 = torch.Generator().manual_seed(19)
    check_hash_saturation(gen19)
    check_alsh(gen19)
    check_general_p_families(gen19)
    errs["dct_mm"] = check_dct_mm(gen, 128, 64)
    check_dct_mm(gen, 5, 64)
    check_dct_mm(gen, 130, 33)
    check_hash_mm(gen, 32, 64, 32, offset=1)        # unaligned: scalar path
    check_dct_mm(gen, 128, 64, offset=2)
    check_small_gemm_shapes(gen)
    check_batch_invariance(gen)
    errs["fused_query"] = check_fused_query(gen, 32, 64, 1024, 1024, 10)
    check_fused_query(gen, 128, 64, 1024, 1024, 10)
    check_fused_query(gen, 128, 64, 1024, 1024, 40)
    check_fused_query(gen, 5, 50, 300, 200, 10, invalid_rows=2)
    check_fused_query(gen, 7, 64, 1024, 1024, 1)
    check_fused_query(gen, 3, 64, 1024, 1024, 128)
    check_fused_query(gen, 8, 64, 1024, 512, 10, valid_items=600)
    check_fused_query(gen, 8, 64, 1024, 512, 10, p=1.0)
    check_fused_query(gen, 8, 40, 500, 256, 10, p=1.5)
    errs["merge"] = check_merge(gen, 32, 2570, n_out=10)
    check_merge(gen, 32, 2570)
    check_merge(gen, 128, 10320, n_out=40)     # the int8 fan-in, P 16,384
    check_merge(gen, 128, 40, n_out=10)        # the survivor rescore's sort
    check_merge(gen, 3, 5)
    check_merge(gen, 1, 1)
    check_merge(gen, 9, 100)
    check_merge(gen, 4, 4096)
    check_merge(gen, 4, 1024, sorted_run=16, runs=16)
    # the K3 select-route and K6 width checks draw from their own
    # generator, so the checks before them keep their inputs
    gen15 = torch.Generator().manual_seed(15)
    check_merge(gen15, 3, 300, n_out=200)       # the network past n_out 128
    check_merge_select(gen15)
    from repro_torch.kernels import ops as kops
    if hasattr(kops, "merge_topk_unique"):   # absent in older checkouts
        check_merge_unique(torch.Generator().manual_seed(25))
    i8, bf = torch.int8, torch.bfloat16
    errs["quantized_query"] = max(
        check_quantized_query(gen, 128, 1024, 1024, 40, i8, p=p)
        for p in (2.0, 1.0))
    for dt in (i8, bf):
        for p in (2.0, 1.0, 1.5):
            for k in (1, 40, 128):
                check_quantized_query(gen, 16, 1024, 1024, k, dt, p=p,
                                      invalid_rows=2)
        check_quantized_query(gen, 8, 1024, 512, 10, dt, valid_items=600)
        check_quantized_query(gen, 5, 300, 200, 10, dt, n=50)
    errs["quantized_query"] = max(
        errs["quantized_query"],
        *(check_quantized_query(gen, 32, 1024, 1024, 10, i8, p=p)
          for p in (2.0, 1.0)))
    # the cluster split's edges (csrc/topk.cuh): C not a multiple of G x S,
    # N = 50 on the scalar instantiation, k from 1 to 128, an all-invalid
    # row, a valid_items cut and a row with fewer valid candidates than k
    n_cases, worst = 0, 0.0
    for c in (200, 1000, 1023, 1024):
        for n in (48, 50, 64):
            for k in (1, 10, 40, 128):
                worst = max(worst, check_fused_query(
                    gen, 32, n, 1024, c, k, valid_items=900, invalid_rows=1,
                    sparse_rows=1, quiet=True))
                for dt in (i8, bf):
                    worst = max(worst, check_quantized_query(
                        gen, 32, 1024, c, k, dt, valid_items=900,
                        invalid_rows=1, n=n, sparse_rows=1, quiet=True))
                n_cases += 3
    log(f"  fused_query + quantized_query int8/bf16 at C in (200, 1000, "
        f"1023, 1024) x N in (48, 50, 64) x k in (1, 10, 40, 128), 32 rows, "
        f"valid 900, an all-invalid and a thin row: {n_cases} cases ok "
        f"(int8 bit-identical; max err {worst:.3g})")
    for nq in (32, 128):
        for dt in (torch.float32, i8, bf):
            check_query_ties(gen, nq, dt)
    check_query_ties_seeds()
    # the stacked launches draw from their own generator, so the checks
    # before them keep their inputs
    for name, err in check_stacked_scorers(
            torch.Generator().manual_seed(17)).items():
        errs[name] = max(errs[name], err)
    errs["rerank"] = check_rerank(gen, 128, 40)
    check_rerank(gen, 128, 40, p=1.0)
    check_rerank(gen, 9, 200, n=100, p=1.5)
    check_rerank(gen, 1, 1, n=3)
    check_rerank_shapes(gen15)
    errs["simhash_pack"] = check_simhash(gen, SIMHASH_BATCH, 64,
                                         SIMHASH_BITS)
    check_simhash(gen, 130, 64, 96)
    check_simhash(gen, 8, 16, 32)
    check_simhash(gen, 37, 100, 256)
    # the K7 edges draw from their own generator, so the checks before them
    # keep their inputs
    gen16 = torch.Generator().manual_seed(16)
    errs["simhash_pack"] = max(errs["simhash_pack"],
                               check_simhash_shapes(gen16))
    check_simhash_batch_invariance(gen16)
    check_nan_queries()
    check_query_batched()

    log("[4/17] CPU (plain versions) vs card (kernels) parity")
    k2_inputs = parity_run()
    captured = int8_parity_run()
    k2_p1_inputs = None
    if has_tenants():
        k2_p1_inputs = parity_run("l1-qmc")
        parity_run("w2-quantile")

    log("[5/17] timings (median of CUDA events over "
        f"{REPS} launches after {WARMUP} warm-up), {smi}")
    rec = timings(gen, k2_inputs, captured["k5"], captured["k6"], errs,
                  floor_fn, k2_p1_inputs)

    counts, paths = run_paths(card, smi)

    kernels = []
    for name in dispatch.KERNELS:
        # K2 and K5 at the stacked launch of a 32-row batch
        t = rec.get(f"{name}@{32 * STACK_SEGMENTS}", rec[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": counts[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    if "lm" in paths:
        # K1 at the LM serve step's signature, launched by phase 15's path
        t = paths["lm"]["k1_signature"]
        kernels.append({
            "name": "hash_mm@lm_signature", "route": "cuda",
            "source": "src/repro_torch/csrc/hash_mm.cu",
            "replaces": REPLACES["hash_mm"],
            "launches": paths["lm"]["serve"]["launches"]["hash_mm"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    if "families" in paths:
        # K1 at the other families' serve-step signatures (phase 16 (c))
        t = paths["families"]["k1_signature"]
        kernels.append({
            "name": "hash_mm@lm_families", "route": "cuda",
            "source": "src/repro_torch/csrc/hash_mm.cu",
            "replaces": REPLACES["hash_mm"],
            "launches": paths["families"]["launches"]["hash_mm"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    if "mesh" in paths:
        # K1 at the sharded serve step's signature (phase 17 (b))
        t = paths["mesh"]["k1_signature"]
        kernels.append({
            "name": "hash_mm@lm_mesh", "route": "cuda",
            "source": "src/repro_torch/csrc/hash_mm.cu",
            "replaces": REPLACES["hash_mm"],
            "launches": paths["mesh"]["serve"]["launches"]["hash_mm"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    log(f"smoke wall {time.perf_counter() - t_start:.1f}s (from the card "
        "check, the build included)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
