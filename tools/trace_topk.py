#!/usr/bin/env python3
"""Phase breakdown and cluster-size sweep of the port's K2/K5 kernel
(``src/repro_torch/csrc/topk.cuh``) on one CUDA card.

    python3 tools/trace_topk.py [NAME=HEADER ...]

With no arguments it traces the checkout's ``csrc/topk.cuh``; each
``NAME=HEADER`` argument names another copy of the header (an earlier
version, say) to compare in the same run.  For every header it builds two
libraries with nvcc: the kernel as it is, and a copy in which thread 0 of
every block records ``clock64()`` at the kernel's numbered steps (the
``// 1.`` .. ``// 4.`` comments) and ``%globaltimer`` at its start and end.
Inputs are synthetic at the serve path's shapes: C = 1024 candidate slots
a row, a quarter of them valid, over a (1024, 64) table, fp32 at k = 10
and int8 at k = 40, 32 and 128 rows.  Prints one JSON line per (header,
shape, G) with the device time per call (``chip_smoke.time_ms``: 50
launches in a CUDA graph, median replay), G the plan's choice and
G in {1, 2, 4, 8}; then one JSON line per (header, shape) with the median
over rank-0 blocks of each step, in ns:

    compact   step 1: the ids read and compacted
    score     step 2: the rows gathered and scored
    rank_push step 3: ranked, pushed to rank 0, cluster barrier
    merge     step 4: rank 0 merges and writes the row (to the kernel's end)

and the span from the first block's start to the last rank-0 block's end.
Run it from the root of the checkout; it writes under build/trace_topk/.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fused_query import _plan  # noqa: E402

OUT = ROOT / "build" / "trace_topk"
MAX_BLOCKS = 8192
LAUNCHER = r'''
#include "topk.cuh"
REPRO_EXPORT int launch(int is_i8, const float* q, const void* rows,
                        const float* scale, const int* ids, int nq, int n,
                        int c, int k, int valid, int g, int slots, int lg,
                        float* od, int* oi, void* stream) {
  namespace topk = repro_torch::topk;
  const topk::Args a{q, rows, scale, ids, n, c, k, valid, 2, 2.0f, g, slots,
                     lg, od, oi};
  return is_i8 ? topk::launch<int8_t, true>(a, nq, stream)
               : topk::launch<float, true>(a, nq, stream);
}
REPRO_EXPORT int read_trace(long long* t, long long* gt) {
  cudaMemcpyFromSymbol(t, g_trace, sizeof(long long) * %(n)d * 8);
  return cudaMemcpyFromSymbol(gt, g_gt, sizeof(long long) * %(n)d * 2);
}
'''
MARK = "if (threadIdx.x == 0) { g_trace[blockIdx.x * 8 + %d] = clock64(); }"
CLOCK = ('if (threadIdx.x == 0) { long long t_; asm volatile('
         '"mov.u64 %%0, %%%%globaltimer;" : "=l"(t_)); '
         'g_gt[blockIdx.x * 2 + %d] = t_; }')
# mark index -> the line it goes in front of
ANCHORS = {1: "  // 2. ", 2: "  // 3. ", 3: "    if (rank != 0) return;"}


def instrument(src: str, traced: bool) -> str:
    n = MAX_BLOCKS if traced else 1
    src = src.replace(
        "namespace repro_torch {",
        f"__device__ long long g_trace[{n} * 8];\n"
        f"__device__ long long g_gt[{n} * 2];\nnamespace repro_torch {{", 1)
    if not traced:
        return src

    def before(anchor, code):
        i = src.index(anchor)
        return src[:i] + "  " + code + "\n" + src[i:]
    src = before("  const float qs = kInt8", MARK % 0 + " " + CLOCK % 0)
    for mark, anchor in ANCHORS.items():
        src = before(anchor, MARK % mark)
    end = src.rindex("}", 0, src.index("// Launch one row_topk_kernel"))
    return src[:end] + "  " + MARK % 4 + " " + CLOCK % 1 + "\n" + src[end:]


def build(name: str, header: Path, traced: bool):
    d = OUT / f"{name}-{'traced' if traced else 'plain'}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "topk.cuh").write_text(instrument(header.read_text(), traced))
    (d / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
    n = MAX_BLOCKS if traced else 1
    (d / "launch.cu").write_text(LAUNCHER % {"n": n})
    so = d / "launch.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d),
                          "-o", str(so), str(d / "launch.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                           + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3)
    lib.read_trace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def inputs(nq: int, dtype: torch.dtype, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    db = torch.randn((1024, 64), generator=g)
    q = (db[torch.randint(0, 1024, (nq,), generator=g)]
         + 0.3 * torch.randn((nq, 64), generator=g))
    ids = torch.randint(0, 1024, (nq, 1024), generator=g, dtype=torch.int32)
    ids[torch.rand((nq, 1024), generator=g) < 0.75] = -1
    scale = db.abs().max() / 127
    rows = torch.round(db / scale).to(torch.int8) if dtype == torch.int8 \
        else db
    return q.cuda(), rows.cuda(), scale.reshape(1).cuda(), ids.cuda()


def launcher(lib, nq, dtype, k, q, rows, scale, ids, g=None):
    plan = _plan(nq, 1024, 64, rows.element_size())
    if g:
        plan = plan._replace(cluster=g, slots=-(-1024 // g))
    od = torch.empty((nq, k), device="cuda")
    oi = torch.empty((nq, k), dtype=torch.int32, device="cuda")

    def call():
        code = lib.launch(int(dtype == torch.int8), q.data_ptr(),
                          rows.data_ptr(), scale.data_ptr(), ids.data_ptr(),
                          nq, 64, 1024, k, 1024, plan.cluster, plan.slots,
                          plan.lanes.bit_length() - 1, od.data_ptr(),
                          oi.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")
    return call, plan


SHAPES = [(32, torch.float32, 10), (128, torch.float32, 10),
          (128, torch.int8, 40), (32, torch.int8, 40)]


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("trace_topk: no CUDA device", file=sys.stderr)
        return 2
    headers = [("current", _build.CSRC / "topk.cuh")]
    headers += [(a.split("=", 1)[0], ROOT / a.split("=", 1)[1]) for a in argv]
    libs = {(name, traced): build(name, h, traced)
            for name, h in headers for traced in (False, True)}
    for name, _ in headers:
        for nq, dt, k in SHAPES:
            data = inputs(nq, dt)
            for g in (None, 1, 2, 4, 8):
                call, plan = launcher(libs[(name, False)], nq, dt, k, *data,
                                      g=g)
                print(json.dumps({"header": name, "nq": nq,
                                  "dtype": str(dt), "k": k,
                                  "G": plan.cluster, "plan": g is None,
                                  "us": time_ms(call) * 1e3}), flush=True)
    for name, _ in headers:
        lib = libs[(name, True)]
        for nq, dt, k in SHAPES:
            call, plan = launcher(lib, nq, dt, k, *inputs(nq, dt))
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            t = torch.zeros(MAX_BLOCKS * 8, dtype=torch.int64)
            gt = torch.zeros(MAX_BLOCKS * 2, dtype=torch.int64)
            lib.read_trace(t.data_ptr(), gt.data_ptr())
            nb = nq * plan.cluster
            t, gt = t[:nb * 8].reshape(nb, 8), gt[:nb * 2].reshape(nb, 2)
            r0 = torch.arange(0, nb, plan.cluster)   # rank-0 blocks
            ns = ((gt[r0, 1] - gt[r0, 0]).double()
                  / (t[r0, 4] - t[r0, 0]).double()).median().item()

            def step(a, b):
                return float((t[r0, b] - t[r0, a]).double().median() * ns)
            print(json.dumps({
                "header": name, "nq": nq, "dtype": str(dt), "k": k,
                "G": plan.cluster, "ns_per_cycle": ns,
                "compact_ns": step(0, 1), "score_ns": step(1, 2),
                "rank_push_ns": step(2, 3), "merge_ns": step(3, 4),
                "block_ns": step(0, 4),
                "span_us": float(gt[r0, 1].max() - gt[:, 0].min()) / 1e3,
                "start_spread_us": float(gt[:, 0].max() - gt[:, 0].min())
                / 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
