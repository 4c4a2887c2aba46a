#!/usr/bin/env python3
"""K3 merge (``src/repro_torch/csrc/merge.cu``) and K6 rerank on one CUDA
card: bit identity against another checkout, and the select route's
cluster size and bucket threshold swept at the path's shapes.

    python3 tools/bench_merge.py [--parent DIR]

Run it from the root of the checkout; it builds under
``build/bench_merge/``.  Prints one JSON line per reading:

- ``identity`` (with ``--parent``): K3 of the checkout at DIR (built from
  its own ``csrc/merge.cu``, called through its ``merge_launch``, the
  bitonic network in earlier checkouts) against this checkout's
  ``sort_pairs_kernel`` and ``ops.merge_topk`` (the parent's masking done
  around its kernel, as its ``ops.merge_topk`` did), bit for bit, at the
  path's shapes and on duplicate-heavy rows (``chip_smoke.merge_pairs``);
  and K6 of both checkouts on one input (rtol 1e-5, atol 1e-6 of each
  other: the summation order changed);
- ``sweep``: device time per call (``chip_smoke.time_ms``) of the select
  route called through ctypes with preallocated outputs, at G = 1, 2, 4
  and 8 blocks a row (the plan's marked), for this build (a bucket of
  <= 64 keys placed by counting, 2 chunks a thread in flight at load) and
  for copies of it built with 32 and 128 and with 4 and 8 chunks, each
  checked bit for bit against the wrapper; with ``--parent`` the parent's
  kernel beside them, in the order parent, builds, reversed; and K6 at
  (128, 40, 64) over rows a block x lanes a pair, and copies of it built
  without PDL, reading the query from device memory, with 128 or 64
  threads a block and with four pairs a sub-warp in flight
  (``RERANK_VARIANTS``), the parent's beside them;
- ``trace``: a copy of the select kernel in which thread 0 of every block
  records ``clock64()`` after each step (load, radix, lists, place, push,
  merge) and ``%globaltimer`` at its start and end: the median step over
  rank-0 blocks in ns at each path shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from chip_smoke import time_ms  # noqa: E402
from repro_torch.kernels import (_build, dispatch, merge, ops,  # noqa: E402
                                 rerank)

OUT = ROOT / "build" / "bench_merge"
SHAPES = ((32, 257, 10), (128, 258, 40), (128, 1032, 40))   # runs x k
SMALL = "constexpr int kSmall = 64;"


def log(rec):
    print(json.dumps(rec), flush=True)


def nvcc(src: Path, include: Path, name: str) -> ctypes.CDLL:
    out = OUT / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(include), "-o",
           str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {name}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(out))


LOAD_UNROLL = ("  return vec ? select_launch<true, 2>(a, rows, st)\n"
               "             : select_launch<false, 2>(a, rows, st);")
MERGE_VARIANTS = {
    # buckets of <= 32 / 128 keys placed by counting (this build: 64)
    "small32": [(SMALL, SMALL.replace("64", "32"))],
    "small128": [(SMALL, SMALL.replace("64", "128"))],
    # a one-tile share read with 4 / 8 chunks a thread in flight (this
    # build: 2)
    "unroll4": [(LOAD_UNROLL, LOAD_UNROLL.replace(", 2>", ", 4>"))],
    "unroll8": [(LOAD_UNROLL, LOAD_UNROLL.replace(", 2>", ", 8>"))],
}


def variant(name: str, file: str = "merge.cu", edits=None) -> Path:
    """A copy of this checkout's csrc/ with ``edits`` (default
    ``MERGE_VARIANTS[name]``), each (old, new) found once, applied to
    ``file``."""
    dst = OUT / name
    dst.mkdir(parents=True, exist_ok=True)
    for p in _build.CSRC.iterdir():
        if p.suffix in (".cu", ".cuh"):
            text = p.read_text()
            if p.name == file:
                for old, new in (edits or MERGE_VARIANTS[name]):
                    if text.count(old) != 1:
                        raise RuntimeError(f"{file}: expected one {old!r}")
                    text = text.replace(old, new)
            (dst / p.name).write_text(text)
    return dst


MAX_BLOCKS = 8192
STEPS = ("load", "radix", "lists", "place", "push", "merge")
TRACE_DECL = ("__device__ long long g_trace[%d * 8];\n"
              "__device__ long long g_gt[%d * 2];\n" % (MAX_BLOCKS,
                                                       MAX_BLOCKS))
MARK = ("if (threadIdx.x == 0) { g_trace[blockIdx.x * 8 + %d] = clock64(); }")
CLOCK = ('if (threadIdx.x == 0) { long long t_; asm volatile('
         '"mov.u64 %%0, %%%%globaltimer;" : "=l"(t_)); '
         'g_gt[blockIdx.x * 2 + %d] = t_; }')
READ = r'''
REPRO_EXPORT int read_trace(long long* t, long long* gt) {
  cudaMemcpyFromSymbol(t, g_trace, sizeof(long long) * %d * 8);
  return cudaMemcpyFromSymbol(gt, g_gt, sizeof(long long) * %d * 2);
}
''' % (MAX_BLOCKS, MAX_BLOCKS)


def traced(src: Path) -> Path:
    """A copy of csrc/ whose select kernel has thread 0 of every block
    record clock64() after each step (``STEPS``: the tile's load, the
    radix passes, the placement lists, the placement, the push to rank 0
    and cluster barrier, rank 0's merge; within a rank the last tile's) and
    %globaltimer at its start and end."""
    dst = OUT / "traced"
    dst.mkdir(parents=True, exist_ok=True)
    for p in _build.CSRC.iterdir():
        if p.suffix in (".cu", ".cuh"):
            (dst / p.name).write_text(p.read_text())
    text = (src / "merge.cu").read_text()

    def before(anchor, code, last=False):
        nonlocal text
        i = text.rindex(anchor) if last else text.index(anchor)
        text = text[:i] + "  " + code + "\n" + text[i:]
    text = text.replace("namespace {", TRACE_DECL + "namespace {", 1)
    lead = 'asm volatile("griddepcontrol.launch_dependents;\\n" ::);\n'
    i = text.index(lead, text.index("select_kernel(const SelectArgs a)"))
    i += len(lead)
    text = text[:i] + "  " + MARK % 0 + " " + CLOCK % 0 + "\n" + text[i:]
    before("    const int n = thr != kNone", MARK % 1)
    before("  if (mask == 0) {", MARK % 2)
    before("    // no pass ran (n <= kSmall", MARK % 3)
    before("  const int na = s.na;", MARK % 3)
    before("  const size_t out0", MARK % 4)
    before("  if (rank != 0) return;", MARK % 5)
    end_mark = MARK % 6 + " " + CLOCK % 1
    before("    return;\n  }\n  cg::cluster_group", end_mark)
    end = text.rindex("}", 0, text.index("template <bool kVec, int "
                                          "kLoadUnroll>\nint select_launch"))
    text = text[:end] + "  " + end_mark + "\n" + text[end:]
    (dst / "merge.cu").write_text(text + READ)
    return dst


def trace(lib, fn, inputs):
    """The median over rank-0 blocks of each step, in ns, and the span
    from the first block's start to the last rank-0 block's end."""
    read = lib.read_trace
    read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for (name, (dd, ii, k)), g in [
            (item, g) for item in inputs.items()
            for g in sorted({merge.plan(*item[1][0].shape).cluster, 1})]:
        rows, m = dd.shape
        call, _ = select_call(fn, dd, ii, k, g)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        t = torch.zeros(MAX_BLOCKS * 8, dtype=torch.int64)
        gt = torch.zeros(MAX_BLOCKS * 2, dtype=torch.int64)
        read(t.data_ptr(), gt.data_ptr())
        nb = rows * g
        t, gt = t[:nb * 8].reshape(nb, 8), gt[:nb * 2].reshape(nb, 2)
        r0 = torch.arange(0, nb, g)
        ns = ((gt[r0, 1] - gt[r0, 0]).double()
              / (t[r0, 6] - t[r0, 0]).double()).median().item()
        rec = {"trace": "merge", "shape": name, "G": g, "ns_per_cycle": ns}
        for s_, step in enumerate(STEPS):
            if g == 1 and step in ("push", "merge"):
                continue
            b = s_ + 1 if not (g == 1 and step == "place") else 6
            rec[f"{step}_ns"] = float((t[r0, b] - t[r0, s_]).double()
                                      .median() * ns)
        rec["block_ns"] = float((t[r0, 6] - t[r0, 0]).double().median() * ns)
        rec["span_us"] = float(gt[r0, 1].max() - gt[:, 0].min()) / 1e3
        rec["start_spread_us"] = float(gt[:, 0].max() - gt[:, 0].min()) / 1e3
        log(rec)


RERANK_VARIANTS = {
    # four pairs a sub-warp in flight (this build: 2)
    "u4": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")],
    # blocks of 128 / 64 threads (this build: 256)
    "t128": [("constexpr int kThreads = 256;",
              "constexpr int kThreads = 128;")],
    "t64": [("constexpr int kThreads = 256;", "constexpr int kThreads = 64;")],
    # launched without programmatic dependent launch
    "nopdl": [("programmaticStreamSerializationAllowed = 1;",
               "programmaticStreamSerializationAllowed = 0;")],
    # the query read by each sub-warp from device memory (L1), no copy into
    # shared memory and no barrier
    "qglobal": [("  for (int i = tid; i < nrows * a.n; i += kThreads) {",
                 "  for (int i = tid; i < 0; i += kThreads) {"),
                ("      __syncthreads();\n", ""),
                ("      qr[u] = sq + (e[u] < pairs ? e[u] / a.c : 0) * ldq;",
                 "      qr[u] = a.q + (static_cast<size_t>(row0) + (e[u] < "
                 "pairs ? e[u] / a.c : 0)) * a.n;")],
}


def rerank_sweep(parent_fn, gen):
    """K6 at the survivor shape (128, 40, 64), rows a block in {1, 2} x
    lanes a pair in {4, 8, 16} through this build's launcher (the
    plan's marked), and the parent's kernel, in turns."""
    lib = _build.library("rerank")
    fn = lib.rerank_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, i, i, i, p, p]
    fn.restype = i
    q = torch.randn((128, 64), generator=gen).cuda()
    emb = torch.randn((128, 40, 64), generator=gen).cuda()
    ids = torch.randint(-1, 5000, (128, 40), generator=gen,
                        dtype=torch.int32).cuda()
    want = rerank.rerank_distances(q, emb, ids)
    plan = rerank.plan(128, 64)
    rec = {"sweep": "rerank", "shape": "(128, 40, 64)",
           "plan": [plan.rows, plan.lanes]}
    out = q.new_empty((128, 40))

    fns = {"this": fn}
    for name in RERANK_VARIANTS:
        src = variant(f"rerank_{name}", "rerank.cu", RERANK_VARIANTS[name])
        vf = nvcc(src / "rerank.cu", src, f"rerank_{name}").rerank_launch
        vf.argtypes, vf.restype = fn.argtypes, fn.restype
        fns[name] = vf

    def call_for(rows, lanes, who="this"):
        def call():
            code = fns[who](q.data_ptr(), emb.data_ptr(), ids.data_ptr(),
                            128, 40, 64, 2, 2.0, rows,
                            lanes.bit_length() - 1, 1, out.data_ptr(),
                            dispatch.stream_handle(q))
            if code:
                raise RuntimeError(f"rerank_launch: CUDA error {code}")
        return call
    for rnd in range(4):
        for who in RERANK_VARIANTS:
            for lanes in (8, 16):
                call = call_for(1, lanes, who)
                call()
                torch.cuda.synchronize()
                fin = ids >= 0
                if not (torch.equal(torch.isinf(out), ~fin) and
                        torch.allclose(out[fin], want[fin], rtol=1e-5,
                                       atol=1e-6)):
                    raise AssertionError(f"rerank {who} L={lanes}")
                rec.setdefault(f"{who}_R1_L{lanes}_us", []).append(
                    1e3 * time_ms(call))
        if parent_fn is not None:
            out_p = q.new_empty((128, 40))
            rec.setdefault("parent_us", []).append(1e3 * time_ms(
                lambda: parent_fn(q.data_ptr(), emb.data_ptr(),
                                  ids.data_ptr(), 128, 40, 64, 2, 2.0,
                                  out_p.data_ptr(),
                                  dispatch.stream_handle(q))))
        for rows in (1, 2):
            for lanes in (4, 8, 16):
                call = call_for(rows, lanes)
                call()
                torch.cuda.synchronize()
                fin = ids >= 0
                if not (torch.equal(torch.isinf(out), ~fin) and
                        torch.allclose(out[fin], want[fin], rtol=1e-5,
                                       atol=1e-6)):
                    raise AssertionError(f"rerank rows={rows} L={lanes}")
                rec.setdefault(f"R{rows}_L{lanes}_us", []).append(
                    1e3 * time_ms(call))
    log(rec)


def bind_select(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.merge_select_launch
    fn.argtypes = [p, p, i, i, i, i, i, i, i, i, p, p, p]
    fn.restype = i
    return fn


def bind_network(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.merge_launch
    fn.argtypes = [p, p, i, i, i, i, i, p, p, p]
    fn.restype = i
    return fn


def parent_sort(fn, d, i, n_out):
    rows, m = d.shape
    od = d.new_empty((rows, n_out))
    oi = i.new_empty((rows, n_out))
    code = fn(d.data_ptr(), i.data_ptr(), rows, m, merge.next_pow2(m), 1,
              n_out, od.data_ptr(), oi.data_ptr(), dispatch.stream_handle(d))
    if code:
        raise RuntimeError(f"parent merge_launch: CUDA error {code}")
    return od, oi


def select_call(fn, d, i, n_out, g):
    """A call of the select route at G = g (the share and tile as the plan
    computes them for that G), outputs preallocated."""
    rows, m = d.shape
    share = -(-max(1, -(-m // g)) // 4) * 4
    if (g - 1) * share >= m:
        return None                      # a rank would own nothing
    tile = -(-min(merge.MAX_TILE, share + 4) // 4) * 4
    od = d.new_empty((rows, n_out))
    oi = i.new_empty((rows, n_out))
    args = (d.data_ptr(), i.data_ptr(), rows, m, n_out, g, share, tile, 1, 1,
            od.data_ptr(), oi.data_ptr())

    def call():     # the stream read per call: time_ms captures on its own
        code = fn(*args, dispatch.stream_handle(d))
        if code:
            raise RuntimeError(f"merge_select_launch G={g}: CUDA error "
                               f"{code}")
    return call, (od, oi)


def same(a, b):
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of another checkout "
                    "whose K3 and K6 kernels to compare with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_merge: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    _build.build(["merge", "rerank"])
    own = bind_select(_build.library("merge"))
    builds = {"this": own}
    for name in MERGE_VARIANTS:
        src = variant(name)
        builds[name] = bind_select(nvcc(src / "merge.cu", src,
                                        f"merge_{name}"))
    parent = parent_rerank = None
    gen = torch.Generator().manual_seed(0)
    inputs = {f"({r}, {n * k}) -> {k}": (*chip_smoke._fan_in(gen, r, n, k),
                                          k) for r, n, k in SHAPES}
    d, i = inputs["(128, 10320) -> 40"][:2]
    rgids = i[:, :40].contiguous()
    rgids[::5, 30:] = -1
    rd = rerank.rerank_distances(torch.randn((128, 64), generator=gen).cuda(),
                                 torch.randn((128, 40, 64),
                                             generator=gen).cuda(), rgids)
    inputs["(128, 40) -> 10"] = (rd, rgids, 10)

    if args.parent:
        psrc = args.parent / "src" / "repro_torch" / "csrc"
        plib = nvcc(psrc / "merge.cu", psrc, "parent_merge")
        parent = bind_network(plib)
        cases = dict(inputs)
        for kind in ("empty", "equal", "repeated", "padded"):
            dd, ii = chip_smoke.merge_pairs(gen, 32, 2570, kind)
            cases[f"{kind} (32, 2570) -> 10"] = (dd.cuda(), ii.cuda(), 10)
        for name, (dd, ii, k) in cases.items():
            if dd.shape[1] > 16384:
                continue                  # the parent's network refuses it
            sort_ok = same(parent_sort(parent, dd, ii, k),
                           merge.sort_pairs_kernel(dd, ii, n_out=k))
            pd, pi = parent_sort(parent, torch.where(ii < 0, torch.inf, dd),
                                 ii, k)
            topk_ok = same((pd, torch.where(torch.isinf(pd), -1, pi)),
                           ops.merge_topk(dd, ii, k))
            log({"identity": "merge", "case": name, "sort_pairs": sort_ok,
                 "merge_topk": topk_ok})
        rlib = nvcc(psrc / "rerank.cu", psrc, "parent_rerank")
        q = torch.randn((128, 64), generator=gen).cuda()
        emb = torch.randn((128, 40, 64), generator=gen).cuda()
        out_p = q.new_empty((128, 40))
        fn = rlib.rerank_launch
        p_, i_ = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p_, p_, p_, i_, i_, i_, i_, ctypes.c_float, p_, p_]
        fn.restype = i_
        parent_rerank = fn
        code = fn(q.data_ptr(), emb.data_ptr(), rgids.data_ptr(), 128, 40,
                  64, 2, 2.0, out_p.data_ptr(), dispatch.stream_handle(q))
        if code:
            raise RuntimeError(f"parent rerank_launch: CUDA error {code}")
        out = rerank.rerank_distances(q, emb, rgids)
        fin = rgids >= 0
        log({"identity": "rerank", "inf_equal": bool(torch.equal(
            torch.isinf(out), torch.isinf(out_p))),
             "allclose": bool(torch.allclose(out[fin], out_p[fin],
                                             rtol=1e-5, atol=1e-6)),
             "max_abs_diff": float((out[fin] - out_p[fin]).abs().max()),
             "bit_equal_share": float((out[fin].view(torch.int32)
                                       == out_p[fin].view(torch.int32))
                                      .float().mean())})

    for name, (dd, ii, k) in inputs.items():
        rows, m = dd.shape
        want = merge.merge_topk_kernel(dd, ii, k)
        plan_g = merge.plan(rows, m).cluster
        rec = {"sweep": "merge", "shape": name, "plan_G": plan_g}
        order = list(builds)
        order = order + order[::-1]
        if parent is not None and m <= 16384:
            dm = torch.where(ii < 0, torch.inf, dd)
            order = ["parent"] + order + ["parent"]
        for who in order:
            if who == "parent":
                rec.setdefault("parent_us", []).append(1e3 * time_ms(
                    lambda: parent_sort(parent, dm, ii, k)))
                continue
            for g in (1, 2, 4, 8):
                made = select_call(builds[who], dd, ii, k, g)
                if made is None:
                    continue
                call, got = made
                call()
                torch.cuda.synchronize()
                if not same(got, want):
                    raise AssertionError(f"{who} G={g} {name}: not "
                                         "bit-identical to the wrapper")
                rec.setdefault(f"{who}_G{g}_us", []).append(
                    1e3 * time_ms(call))
        log(rec)
    rerank_sweep(parent_rerank, gen)
    tsrc = traced(_build.CSRC)
    tlib = nvcc(tsrc / "merge.cu", tsrc, "merge_traced")
    trace(tlib, bind_select(tlib), inputs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
