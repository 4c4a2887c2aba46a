#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and nvcc (``$CUDA_HOME`` or /usr/local/cuda).  Phases,
each of which raises on failure (the script then exits non-zero):

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every ``csrc/*.cu`` compiled by nvcc for sm_90a, in parallel;
3. kernel checks: each kernel against its plain PyTorch version on the
   card, at the main path's shapes and at edge shapes;
4. parity: the l2-basis pipeline at 8,192 items on the CPU (plain
   versions) and on the card (kernels) with one injected family;
5. timings: each kernel, its plain version and a PyTorch library call,
   CUDA-event medians, with the bytes and operations for the bound;
6. main path: ``repro_torch.launch.serve`` filled to 262,144 items
   (256 sealed segments), then 20 demo steps; launch counts read around it.

The last lines are the card's name and power limit, one JSON object with
a record per kernel, and ``{"ok": true, "device": {...}}``.
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
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores

REPLACES = {
    "hash_mm": "src/repro/kernels/hash_mm.py:25",
    "fused_query": "src/repro/kernels/fused_query.py:51",
    "merge": "src/repro/kernels/merge.py:123",
    "dct_mm": "src/repro/kernels/dct_mm.py:27",
}


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
    host-inclusive cost a caller sees, launch overhead and all."""
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
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bits(t):
    import torch
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


# -- phase 3: kernel checks ---------------------------------------------------


def check_hash_mm(gen, m, n, k, r=4.0):
    import torch
    from repro_torch.kernels import hash_mm, ref
    x = (torch.randn((m, n), generator=gen) * 0.5).cuda()
    a = torch.randn((n, k), generator=gen).cuda()
    b = torch.rand((k,), generator=gen).cuda()
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
    log(f"  hash_mm {m}x{n}x{k}: ok (max |proj err| "
        f"{(p - pp).abs().max().item():.3g}, {boundary} boundary values, "
        f"{flips} flipped)")
    return float((p - pp).abs().max())


def check_dct_mm(gen, m, n):
    import torch
    from repro_torch.embedders.basis import cheb_kernel_constants
    from repro_torch.kernels import dct_mm, ref
    pre, mat, scale = (torch.as_tensor(t).cuda() for t in
                       cheb_kernel_constants(n, (-1.0, 1.0), "lebesgue"))
    f = (torch.randn((m, n), generator=gen).cuda() * pre).contiguous()
    out = dct_mm.dct_mm(f, mat, scale)
    want = ref.dct_mm_ref(f, mat, scale)
    torch.cuda.synchronize()
    if not torch.allclose(out, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"dct_mm {m}x{n}: max err "
                             f"{(out - want).abs().max().item()}")
    err = float((out - want).abs().max())
    log(f"  dct_mm {m}x{n}: ok (max err {err:.3g})")
    return err


def check_fused_query(gen, nq, n, m, c, k, p=2.0, valid_items=None,
                      invalid_rows=0):
    import torch
    from repro_torch.kernels import fused_query, ref
    q = torch.randn((nq, n), generator=gen).cuda()
    db = torch.randn((m, n), generator=gen).cuda()
    db[1::7] = db[::7][:db[1::7].shape[0]]            # duplicate rows: ties
    ids = torch.randint(-1, m, (nq, c), generator=gen,
                        dtype=torch.int32).cuda()
    ids[:invalid_rows] = -1
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
    near = lambda a, b: (a - b).abs() <= 1e-5 * b.abs().clamp(min=1e-30)
    tie = torch.zeros_like(dp, dtype=torch.bool)
    tie[:, 1:] |= near(dfull[:, 1:k], dfull[:, :k - 1])
    nxt = dfull[:, 1:k + 1]
    tie[:, :nxt.shape[1]] |= near(dfull[:, :nxt.shape[1]], nxt)
    tie &= fin
    bad = int(((i != ip) & ~tie).sum())
    if bad:
        raise AssertionError(f"fused_query {nq}x{c} k={k}: {bad} ids differ "
                             "at distinct distances")
    err = float((d[fin] - dp[fin]).abs().max()) if fin.any() else 0.0
    log(f"  fused_query nq={nq} N={n} M={m} C={c} k={k} p={p} "
        f"valid={valid_items} invalid_rows={invalid_rows}: ok "
        f"(max err {err:.3g}, {int(tie.sum())} tied slots)")
    return err


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
    log(f"  merge rows={rows} M={m} run={sorted_run} n_out={n_out}: "
        "bit-identical")
    return 0.0


# -- phase 4: CPU vs card parity ----------------------------------------------


def parity_run():
    import torch
    from repro_torch import convert
    from repro_torch.core import index as lidx
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import default_spec, sample_fvals
    from repro_torch.serve import Servable, recall_proxy

    spec = default_spec()
    cfg = spec.index_config()
    rng = np.random.default_rng(1234)
    L, K = cfg.n_tables, cfg.n_hashes
    fam = (rng.normal(size=(cfg.n_dims, L * K)).astype(np.float32),
           rng.uniform(size=(L * K,)).astype(np.float32),
           (rng.integers(0, 2 ** 31 - 1, size=(L, K)) | 1).astype(np.uint32))
    out = {}
    for dev in ("cpu", "cuda"):
        sv = Servable(spec, device=dev,
                      family=convert.family_from_numpy(*fam, device=dev))
        nodes = sv.nodes()
        drng = np.random.default_rng(99)
        fvals = sample_fvals(drng, nodes, PARITY_ITEMS)
        qf = sample_fvals(drng, nodes, 64)
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
        out[dev] = dict(g=g, d=d, recall=rec, gids=gids,
                        proj_items=proj_items, proj_q=proj_q,
                        segments=len(sv.index.segments))
        if dev == "cuda":
            # a realistic K2 input for the timings: the candidates of one
            # 32-row micro-batch against a full sealed segment
            seg = sv.index.segments[0]
            qq = torch.as_tensor(q[:32], device=seg.state.db.device)
            h, pj = lidx.hash_stage(seg.state.alpha, seg.state.b, cfg, qq)
            bk = lidx.probe_stage(seg.state.mix, cfg, h, pj, 4)
            cands = lidx.gather_stage(seg.state.table, bk, cfg,
                                      seg.capacity, live_mask=seg.live)
            out["k2_inputs"] = (qq.contiguous(), seg.state.db,
                                cands.contiguous())
    cpu, gpu = out["cpu"], out["cuda"]
    near = lambda p: ((p - torch.round(p)).abs() < 1e-4).any(dim=-1)
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
                f"parity: query {r} differs without a boundary or tie: "
                f"cpu {cpu['g'][r]} / cuda {gpu['g'][r]}")
    fin = np.isfinite(cpu["d"]) & (cpu["g"] == gpu["g"])
    if not np.allclose(cpu["d"][fin], gpu["d"][fin], rtol=1e-5, atol=1e-6):
        raise AssertionError("parity: distances of equal ids differ")
    if abs(cpu["recall"] - gpu["recall"]) > 0.01:
        raise AssertionError(f"parity: recall cpu {cpu['recall']} vs cuda "
                             f"{gpu['recall']}")
    log(f"  parity at {PARITY_ITEMS} items ({gpu['segments']} segments), "
        f"64 queries: {len(mism)} rows differ {why}; recall@10 cpu "
        f"{cpu['recall']:.4f} cuda {gpu['recall']:.4f}")
    return out["k2_inputs"]


# -- phase 5: timings ---------------------------------------------------------


def timings(gen, k2_inputs, errs):
    import torch
    from repro_torch.embedders.basis import cheb_kernel_constants
    from repro_torch.kernels import dct_mm, fused_query, hash_mm, merge, ref

    rec = {}
    # K1 at a 32-row query micro-batch: X (32, 64), A (64, 32)
    m, n, k, r = 32, 64, 32, 4.0
    x = torch.randn((m, n), generator=gen).cuda() * 0.5
    a = torch.randn((n, k), generator=gen).cuda()
    b = torch.rand((k,), generator=gen).cuda()

    def lib_hash():
        pj = torch.matmul(x, a) / r + b
        return torch.floor(pj).to(torch.int32), pj
    rec["hash_mm"] = dict(
        shape=f"X ({m}, {n}) @ A ({n}, {k})",
        ms=time_ms(lambda: hash_mm.hash_mm(x, a, b, r)),
        host_ms=host_ms(lambda: hash_mm.hash_mm(x, a, b, r)),
        plain_ms=time_ms(lambda: ref.hash_mm_proj_ref(x, a, b, r)),
        library_ms=time_ms(lib_hash),
        bytes=4 * (m * n + n * k + k + 2 * m * k),
        ops=2 * m * n * k + 2 * m * k)

    # K4 at one embed chunk: F (128, 64), Mt (64, 64)
    m = 128
    pre, mat, scale = (torch.as_tensor(t).cuda() for t in
                       cheb_kernel_constants(64, (-1.0, 1.0), "lebesgue"))
    f = torch.randn((m, 64), generator=gen).cuda()
    rec["dct_mm"] = dict(
        shape=f"F ({m}, 64) @ Mt (64, 64)",
        ms=time_ms(lambda: dct_mm.dct_mm(f, mat, scale)),
        host_ms=host_ms(lambda: dct_mm.dct_mm(f, mat, scale)),
        plain_ms=time_ms(lambda: ref.dct_mm_ref(f, mat, scale)),
        library_ms=time_ms(lambda: torch.matmul(f, mat) * scale),
        bytes=4 * (m * 64 + 64 * 64 + 64 + m * 64),
        ops=2 * m * 64 * 64 + m * 64)

    # K2 at one segment of a 32-row micro-batch, real candidates
    q, db, cands = k2_inputs
    nq, c = cands.shape
    kk = 10
    valid = (cands >= 0) & (cands < db.shape[0])
    rows_needed = int(torch.unique(cands[valid]).numel())
    n_valid = int(valid.sum())

    def lib_fused():
        emb = db[cands.clamp(min=0).long()]
        dist = torch.linalg.vector_norm(emb - q[:, None, :], dim=-1)
        dist = torch.where(cands < 0, torch.inf, dist)
        return torch.topk(dist, kk, largest=False)
    rec["fused_query"] = dict(
        shape=f"q ({nq}, 64), db {tuple(db.shape)}, ids ({nq}, {c}), "
              f"k={kk}; {n_valid} valid candidates, {rows_needed} rows",
        ms=time_ms(lambda: fused_query.fused_query_topk(q, db, cands, kk)),
        host_ms=host_ms(lambda: fused_query.fused_query_topk(q, db, cands,
                                                              kk)),
        plain_ms=time_ms(lambda: ref.fused_query_topk_ref(q, db, cands, kk)),
        library_ms=time_ms(lib_fused),
        bytes=4 * (nq * 64 + nq * c + rows_needed * 64 + 2 * nq * kk),
        ops=3 * 64 * n_valid)

    # K3 at the fan-in of 257 segments x k=10 for a 32-row micro-batch
    rows, runs = 32, 257
    pm = runs * kk
    d = torch.rand((rows, runs, kk), generator=gen).sort(dim=-1).values
    d = d.reshape(rows, pm).cuda()
    i = torch.randperm(4 * pm, generator=gen)[:pm].to(torch.int32)
    i = i.repeat(rows, 1).cuda()
    pw = 1
    while pw < pm:
        pw *= 2
    stages = pw.bit_length() - 1
    cmp_ops = rows * (pw // 2) * stages * (stages + 1) // 2

    def lib_sort():
        o = torch.sort(i, dim=-1, stable=True).indices
        d1 = torch.gather(d, 1, o)
        o2 = torch.sort(d1, dim=-1, stable=True).indices
        return torch.gather(d1, 1, o2), torch.gather(i, 1, o2)
    rec["merge"] = dict(
        shape=f"({rows}, {pm}) pairs -> P={pw}, top {kk}",
        ms=time_ms(lambda: merge.sort_pairs_kernel(d, i, n_out=kk)),
        host_ms=host_ms(lambda: merge.sort_pairs_kernel(d, i, n_out=kk)),
        plain_ms=time_ms(lambda: ref.sort_pairs(d, i)),
        library_ms=time_ms(lib_sort),
        bytes=8 * rows * pm + 8 * rows * kk,
        ops=cmp_ops)

    for name, t in rec.items():
        bms, by = bound_ms(t["bytes"], t["ops"])
        t.update(bound_ms=bms, bound_by=by, max_abs_err=errs[name])
        log("  timing " + json.dumps({"name": name, **t}))
    return rec


# -- phase 6: where a micro-batch's time goes ----------------------------------


def profile_batches(sv, n_batches=2, rows=32):
    """Trace ``n_batches`` micro-batches of ``rows`` queries through the
    filled index with torch.profiler: wall time, summed kernel time on the
    card (its busy share), launches, and the kernels that take the most.
    The Chrome trace (tens of MB) is parsed from build/ and deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import sample_fvals
    rng = np.random.default_rng(5)
    q = sv.embed(sample_fvals(rng, sv.nodes(), rows)).cpu().numpy()
    sv.index.query(q, 10, 4)[0].cpu()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_batches):
            sv.index.query(q, 10, 4)[0].cpu()
        wall = (time.perf_counter() - t0) / n_batches
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
    res = {"rows": rows, "segments": len(sv.index.segments),
           "wall_ms": wall * 1e3,
           "kernel_ms": busy_us / 1e3 if kern else "not measured",
           "kernels_per_batch": len(kern) / n_batches,
           "busy_share": busy_us / 1e6 / wall if kern else "not measured",
           "top_kernels_ms_per_batch": {k: v / 1e3 / n_batches
                                        for k, v in top}}
    log("  profile " + json.dumps(res))
    return res


# -- main ---------------------------------------------------------------------


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, dispatch
    from repro_torch.launch import serve
    from repro_torch.serve import ServableRegistry

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: IEEE
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    card = torch.cuda.get_device_name(0)
    log(f"[1/6] device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    spent = _build.build()
    log(f"[2/6] build: {time.perf_counter() - t0:.2f}s wall "
        + json.dumps({k: round(v, 2) for k, v in spent.items()}))
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    log("[3/6] kernel checks against the plain versions on the card: "
        "hash_mm proj rtol 1e-6 atol 1e-5 and hashes equal where "
        "|proj - round(proj)| > 1e-4; dct_mm rtol 1e-5 atol 1e-5; "
        "fused_query distances rtol 1e-5 atol 1e-6 and ids equal at "
        "distinct distances; merge bit-identical")
    errs = {}
    errs["hash_mm"] = max(check_hash_mm(gen, m, 64, 32)
                          for m in (8, 32, 128, 256))
    check_hash_mm(gen, 33, 50, 17)
    check_hash_mm(gen, 1, 64, 32)
    check_hash_mm(gen, 300, 96, 40, r=1.0)
    errs["dct_mm"] = check_dct_mm(gen, 128, 64)
    check_dct_mm(gen, 5, 64)
    check_dct_mm(gen, 130, 33)
    errs["fused_query"] = check_fused_query(gen, 32, 64, 1024, 1024, 10)
    check_fused_query(gen, 128, 64, 1024, 1024, 10)
    check_fused_query(gen, 5, 50, 300, 200, 10, invalid_rows=2)
    check_fused_query(gen, 7, 64, 1024, 1024, 1)
    check_fused_query(gen, 3, 64, 1024, 1024, 128)
    check_fused_query(gen, 8, 64, 1024, 512, 10, valid_items=600)
    check_fused_query(gen, 8, 64, 1024, 512, 10, p=1.0)
    check_fused_query(gen, 8, 40, 500, 256, 10, p=1.5)
    errs["merge"] = check_merge(gen, 32, 2570, n_out=10)
    check_merge(gen, 32, 2570)
    check_merge(gen, 3, 5)
    check_merge(gen, 1, 1)
    check_merge(gen, 9, 100)
    check_merge(gen, 4, 4096)
    check_merge(gen, 4, 1024, sorted_run=16, runs=16)

    log("[4/6] CPU (plain versions) vs card (kernels) parity")
    k2_inputs = parity_run()

    log("[5/6] timings (median of CUDA events over "
        f"{REPS} launches after {WARMUP} warm-up), {smi}")
    rec = timings(gen, k2_inputs, errs)

    log(f"[6/6] main path: repro_torch.launch.serve, l2-basis, "
        f"{MAIN_ITEMS} items then {MAIN_STEPS} steps")
    registry = ServableRegistry(device="cuda")
    torch.cuda.synchronize()
    dispatch.reset_launches()
    report = serve.run(registry=registry, n_items=MAIN_ITEMS,
                       steps=MAIN_STEPS, log=log)
    torch.cuda.synchronize()
    counts = dict(dispatch.launches)
    log(f"  [{card}, {smi.split(',')[-1].strip()}] " + json.dumps(
        {k: report[k] for k in ("ingest_rows_per_s", "qps", "p50_ms",
                                "p95_ms", "recall_at_k", "self_hit_rate",
                                "held_frac", "n_segments", "n_live",
                                "max_memory_allocated", "unique_shapes")}))
    log("  launches on the main path: " + json.dumps(counts))
    profile_batches(registry.get("l2-basis"))
    missing = [k for k in dispatch.KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    if report["n_segments"] < MAIN_ITEMS // 1024 + 1:
        raise AssertionError(f"expected >= {MAIN_ITEMS // 1024} sealed "
                             f"segments + the delta, got "
                             f"{report['n_segments']}")
    if report["self_hit_rate"] < 0.95:
        raise AssertionError(f"self-hit rate {report['self_hit_rate']}")
    if not 0.0 <= report["recall_at_k"] <= 1.0:
        raise AssertionError(f"recall {report['recall_at_k']}")

    kernels = []
    for name in dispatch.KERNELS:
        t = rec[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
