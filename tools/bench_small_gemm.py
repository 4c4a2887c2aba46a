#!/usr/bin/env python3
"""K1 hash_mm and K4 dct_mm (``src/repro_torch/csrc/small_gemm.cuh``) on
one CUDA card: rows-per-block sweep, programmatic dependent launch against
a plain launch, bit identity against another checkout, where a wrapper's
host time goes, and what the launch mode does on the serve path.

    python3 tools/bench_small_gemm.py [--parent DIR] [--skip-path]

Run it from the root of the checkout; it builds under
``build/bench_small_gemm/``.  Besides this checkout's kernels, which launch
with programmatic dependent launch (PDL: ``cudaLaunchKernelEx`` with
programmatic stream serialization), it builds a copy of their sources
whose launch leaves that attribute off (``plain``).  Prints one JSON line
per reading:

- ``identity``: the outputs of this checkout's K1 and K4 at the serve
  path's shapes and at edge shapes (aligned and unaligned), bit for bit
  against the plain copy and, with ``--parent``, against the kernels of
  the checkout at DIR (built from its own ``csrc/``, called through its
  own C interface, which is detected from its wrapper);
- ``sweep``: device time per call (``chip_smoke.time_ms``: 50 launches in
  a CUDA graph, median replay) of the launcher called through ctypes with
  preallocated outputs, at 1, 2, 4 and 8 rows per block (the plan's
  marked), for this build, the plain copy and the parent's kernel (at its
  own layout), in the order parent, pdl, plain, plain, pdl, parent;
- ``host``: host time per call (host clock; 7 rounds over all steps in
  turn, 3,000 calls a step a round, the median round; the card idle but
  for the launches) of each step a wrapper takes: the argument
  check, the stream handle, the output allocation, the ctypes call alone
  (``tools/launch_floor.cu``, no launch) and with the kernel's launch,
  and the whole wrapper, with the earlier forms ("before") beside them;
- ``path``: the l2-basis tenant filled to ``chip_smoke.MAIN_ITEMS`` items,
  then ``chip_smoke.profile_batches`` (two profiled 32-row query
  micro-batches) with K1 launched by this build and by the plain copy in
  turn (pdl, plain, plain, pdl): K1's card time per batch, all kernels'
  time per batch and the batch's wall time, each as the profiler sees it.
"""


from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from chip_smoke import time_ms  # noqa: E402
from repro_torch.kernels import _build, dispatch, hash_mm, dct_mm  # noqa: E402
from repro_torch.kernels.small_gemm import plan as _plan  # noqa: E402

OUT = ROOT / "build" / "bench_small_gemm"
K1_ROWS = (8, 32, 128, 256)
K4_ROWS = (128,)


def log(rec):
    print(json.dumps(rec), flush=True)


def nvcc_all(jobs):
    """jobs: name -> (source, include dir, extra flags); all in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, inc, extra) in jobs.items():
        out = OUT / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I", str(inc),
               "-o", str(out), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{text}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def bind(lib, kernel, with_plan):
    """The launcher of ``kernel`` in ``lib`` as a Python function
    (x, a, v, m, k, n, rows, vec, outs, stream); ``with_plan`` False for
    the C interface before the plan arguments (rows, vec) were added."""
    fn = getattr(lib, f"{kernel}_launch")
    fn.restype = I
    head = [P, P, P] + ([F] if kernel == "hash_mm" else [])
    tail = [P, P, P] if kernel == "hash_mm" else [P, P]
    fn.argtypes = head + [I, I, I] + ([I, I] if with_plan else []) + tail

    def call(x, a, v, m, k, n, rows, vec, outs, stream, r=4.0):
        args = [x, a, v] + ([r] if kernel == "hash_mm" else []) + [m, k, n]
        if with_plan:
            args += [rows, int(vec)]
        code = fn(*args, *outs, stream)
        if code:
            raise RuntimeError(f"{kernel} launch: CUDA error {code}")
    return call


def operands(gen, kernel, m, k, n, offset=0):
    """fp32 inputs on the card; ``offset`` floats past an aligned base."""
    def mk(shape, fn):
        flat = torch.empty(offset + int(torch.tensor(shape).prod()),
                           device="cuda")
        view = flat[offset:].view(shape)
        view.copy_(fn(shape, generator=gen))
        return view
    x = mk((m, k), torch.randn)
    a = mk((k, n), torch.randn)
    v = mk((n,), torch.rand)
    return x, a, v


def outputs(kernel, m, n):
    if kernel == "hash_mm":
        return (torch.empty((m, n), dtype=torch.int32, device="cuda"),
                torch.empty((m, n), device="cuda"))
    return (torch.empty((m, n), device="cuda"),)


def run(call, kernel, ops, rows, vec):
    x, a, v = ops
    m, k = x.shape
    n = a.shape[1]
    outs = outputs(kernel, m, n)
    call(x.data_ptr(), a.data_ptr(), v.data_ptr(), m, k, n, rows, vec,
         [o.data_ptr() for o in outs], dispatch.stream_handle(x))
    torch.cuda.synchronize()
    return outs


def identity(launchers, gen):
    shapes = [("hash_mm", m, 64, 32, 0) for m in K1_ROWS] + [
        ("dct_mm", m, 64, 64, 0) for m in K4_ROWS] + [
        ("hash_mm", 33, 50, 17, 0), ("hash_mm", 300, 200, 40, 0),
        ("hash_mm", 32, 64, 32, 1), ("dct_mm", 130, 33, 33, 0),
        ("dct_mm", 128, 64, 64, 3), ("dct_mm", 77, 96, 64, 0)]
    for kernel, m, k, n, off in shapes:
        ops = operands(gen, kernel, m, k, n, off)
        aligned = all(t.data_ptr() % 16 == 0 for t in ops)
        plan = _plan(m, k, n, aligned)
        mine = run(launchers[kernel], kernel, ops, plan.rows, plan.vec)
        rec = {"identity": kernel, "shape": [m, k, n], "offset": off,
               "rows": plan.rows, "vec": plan.vec}
        for other in ("plain", "parent"):
            key = f"{other}:{kernel}"
            if key in launchers:
                theirs = run(launchers[key], kernel, ops, plan.rows,
                             plan.vec)
                rec[other] = all(
                    torch.equal(o.view(torch.int32), t.view(torch.int32))
                    for o, t in zip(mine, theirs))
        log(rec)


def sweep(launchers, gen):
    shapes = [("hash_mm", m, 64, 32) for m in K1_ROWS] + [
        ("dct_mm", m, 64, 64) for m in K4_ROWS]
    for kernel, m, k, n in shapes:
        x, a, v = operands(gen, kernel, m, k, n)
        outs = [o.data_ptr() for o in outputs(kernel, m, n)]
        plan = _plan(m, k, n)

        def timed(call, rows):
            return time_ms(lambda: call(
                x.data_ptr(), a.data_ptr(), v.data_ptr(), m, k, n, rows,
                True, outs, dispatch.stream_handle(x))) * 1e3
        rec = {"sweep": kernel, "shape": [m, k, n], "plan_rows": plan.rows}
        for who in ("parent", "pdl", "plain", "plain", "pdl", "parent"):
            key = kernel if who == "pdl" else f"{who}:{kernel}"
            if key not in launchers:
                continue
            for rows in ((1, 2, 4, 8) if who != "parent" else (None,)):
                tag = "" if rows is None else f"@{rows}"
                rec.setdefault(f"{who}_us{tag}", []).append(
                    timed(launchers[key], rows))
        log(rec)


def host_steps(gen, floor_lib):
    """Host time per call of each step of K1's wrapper, 32 rows."""
    x, a, b = operands(gen, "hash_mm", 32, 64, 32)
    f32 = torch.float32
    dev = x.device
    _, fn = hash_mm._launcher()
    h, p = outputs("hash_mm", 32, 32)
    plan = _plan(32, 64, 32)
    args = (x.data_ptr(), a.data_ptr(), b.data_ptr(), 4.0, 32, 64, 32,
            plan.rows, plan.vec, h.data_ptr(), p.data_ptr())
    noop = floor_lib.launch_floor_call
    noop.argtypes = [P, P, P, F, I, I, I, I, I, P, P, P]
    noop.restype = I
    stream = dispatch.stream_handle(x)
    h2 = torch.empty((2, 32, 32), dtype=torch.int32, device=dev)
    mt, scale = torch.randn((64, 64), device=dev), torch.rand((64,),
                                                              device=dev)

    def one_alloc():
        hh, pp = torch.empty((2, 32, 32), dtype=torch.int32,
                             device=dev).unbind()
        return hh, pp.view(f32)

    steps = {
        "check": lambda: dispatch.check_cuda_args(
            "hash_mm", x, a, b, dtypes=(f32, f32, f32)),
        "stream handle (before)": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "stream handle": lambda: dispatch.stream_handle(x),
        "two torch.empty (before)": lambda: (
            torch.empty((32, 32), dtype=torch.int32, device=dev),
            torch.empty((32, 32), dtype=f32, device=dev)),
        "two x.new_empty (K1's wrapper)": lambda: (
            x.new_empty((32, 32), dtype=torch.int32), x.new_empty((32, 32))),
        "one torch.empty + unbind + view": one_alloc,
        "one x.new_empty + unbind + view": lambda: (
            lambda hh, pp: (hh, pp.view(f32)))(*x.new_empty(
                (2, 32, 32), dtype=torch.int32).unbind()),
        "torch.empty (2, 32, 32) int32": lambda: torch.empty(
            (2, 32, 32), dtype=torch.int32, device=dev),
        "x.new_empty (2, 32, 32) int32": lambda: x.new_empty(
            (2, 32, 32), dtype=torch.int32),
        "torch.empty (32, 32) f32": lambda: torch.empty(
            (32, 32), dtype=f32, device=dev),
        "x.new_empty (32, 32)": lambda: x.new_empty((32, 32)),
        "x.new_empty (32, 32) int32": lambda: x.new_empty(
            (32, 32), dtype=torch.int32),
        "unbind + view": lambda: (lambda hh, pp: (hh, pp.view(f32)))(
            *h2.unbind()),
        "index [0], [1] + view": lambda: (h2[0], h2[1].view(f32)),
        "data_ptr x 5": lambda: (x.data_ptr(), a.data_ptr(), b.data_ptr(),
                                 h.data_ptr(), p.data_ptr()),
        "plan (cached)": lambda: _plan(32, 64, 32, True),
        "ctypes call, no launch": lambda: noop(*args, stream),
        "ctypes launch, constant args": lambda: fn(*args, stream),
        "hash_mm wrapper": lambda: hash_mm.hash_mm(x, a, b, 4.0),
        "dct_mm wrapper": lambda: dct_mm.dct_mm(x, mt, scale),
    }
    rounds, reps = 7, 3000
    times = {name: [] for name in steps}
    for step in steps.values():
        for _ in range(200):
            step()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for name, step in steps.items():
            t0 = time.perf_counter()
            for _ in range(reps):
                step()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / reps * 1e6)
    log({"host": "per call, us: median of rounds", "rounds": rounds,
         "reps": reps, **{k: statistics.median(v) for k, v in times.items()},
         "spread": {k: [min(v), max(v)] for k, v in times.items()}})


def path(plain_lib):
    """K1 on the serve path, launched with PDL (this build) and plainly
    (``plain_lib``, the plain copy's hash_mm library)."""
    from repro_torch.launch import serve
    from repro_torch.serve import ServableRegistry
    own = hash_mm._launcher
    fn = plain_lib.hash_mm_launch
    fn.argtypes, fn.restype = own()[1].argtypes, I
    registry = ServableRegistry(device="cuda")
    serve.run(registry=registry, tenants=("l2-basis",),
              n_items=chip_smoke.MAIN_ITEMS, steps=0, log=lambda *a: None)
    sv = registry.get("l2-basis")
    rec = {"path": "l2-basis", "items": chip_smoke.MAIN_ITEMS,
           "segments": len(sv.index.segments)}
    try:
        for who in ("pdl", "plain", "plain", "pdl"):
            hash_mm._launcher = own if who == "pdl" else (
                lambda: (plain_lib, fn))
            res = chip_smoke.profile_batches(sv)
            for key, val in (("k1_ms", res["hash_dct_ms_per_batch"]
                              ["hash_mm"]), ("kernel_ms", res["kernel_ms"]),
                             ("wall_ms", res["wall_ms"])):
                rec.setdefault(f"{who}_{key}", []).append(val)
    finally:
        hash_mm._launcher = own
    log(rec)


def plain_sources():
    """A copy of K1's and K4's sources whose launch leaves programmatic
    stream serialization off: the same kernels, launched plainly."""
    src = OUT / "plain_src"
    src.mkdir(parents=True, exist_ok=True)
    on = "programmaticStreamSerializationAllowed = 1;"
    for name in ("small_gemm.cuh", "hash_mm.cu", "dct_mm.cu"):
        text = (_build.CSRC / name).read_text()
        if name == "small_gemm.cuh":
            if text.count(on) != 1:
                raise RuntimeError(f"{name}: expected one '{on}'")
            text = text.replace(on, on.replace("1", "0"))
        (src / name).write_text(text)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of another checkout "
                    "whose K1/K4 kernels to compare with")
    ap.add_argument("--skip-path", action="store_true",
                    help="leave out the serve path reading")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_small_gemm: no CUDA device", file=sys.stderr)
        return 2
    _build.build(["hash_mm", "dct_mm"])
    csrc = _build.CSRC
    psrc = plain_sources()
    jobs = {f"plain_{k}": (psrc / f"{k}.cu", csrc, [])
            for k in ("hash_mm", "dct_mm")}
    jobs["floor"] = (ROOT / "tools" / "launch_floor.cu", csrc, [])
    parent_plan = False
    if args.parent:
        pcsrc = args.parent / "src" / "repro_torch" / "csrc"
        parent_plan = "plan.rows" in (
            args.parent / "src" / "repro_torch" / "kernels" /
            "hash_mm.py").read_text()
        jobs.update({f"parent_{k}": (pcsrc / f"{k}.cu", pcsrc, [])
                     for k in ("hash_mm", "dct_mm")})
    libs = nvcc_all(jobs)
    launchers = {}
    for k in ("hash_mm", "dct_mm"):
        launchers[k] = bind(_build.library(k), k, True)
        launchers[f"plain:{k}"] = bind(libs[f"plain_{k}"], k, True)
        if args.parent:
            launchers[f"parent:{k}"] = bind(libs[f"parent_{k}"], k,
                                            parent_plan)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log({"device": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda})
    gen = torch.Generator().manual_seed(0)
    identity(launchers, gen)
    sweep(launchers, gen)
    host_steps(gen, libs["floor"])
    if not args.skip_path:
        path(libs["plain_hash_mm"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
