#!/usr/bin/env python3
"""K7 simhash_pack (``src/repro_torch/csrc/simhash_pack.cu``) on one CUDA
card: bit identity against another checkout's kernel, and a sweep of
tile shapes, copy groups and launch modes.

    python3 tools/bench_simhash.py [--parent DIR]

Run it from the root of the checkout; it builds under
``build/bench_simhash/``.  Besides this checkout's kernel it builds copies
of ``simhash_pack.cu`` changed by text patches (``VARIANTS``): rows a
thread holds (4 or 16), warps a block (8: twice the row groups at 4 rows a
thread, or two column groups), a tile's copies in 2 or 4 commit groups
with 1-3 in flight, a lane's columns 32 apart (``strided``), the depth
loop's unrolling, the multiply-adds columns outer, and the launch without
programmatic dependent launch (``nopdl``).  Prints one JSON line per reading:

- ``identity``: the words of this checkout's kernel at the benchmark's
  shape and at edge shapes (aligned and one float past alignment), bit for
  bit against every variant and, with ``--parent``, against the kernel of
  the checkout at DIR (built from its own ``csrc/``, called through its
  own C interface, which is detected from its wrapper); and the bits
  against the plain version away from |x @ A| < 1e-5;
- ``sweep``: device time per call (``chip_smoke.time_ms``: 50 launches in
  a CUDA graph, median replay) of each launcher called through ctypes
  with a preallocated output, at 1, 2 and 4 words a block (the plan's
  marked), in the order parent, this, variants, variants reversed, this,
  parent;
- ``trace``: copies of this checkout's kernel (and of a variant) in which
  thread 0 of every block records ``clock64()`` and ``%globaltimer`` at
  five marks, run once at the benchmark's shape: the median over blocks of
  each step (waiting for the previous kernel, the first copies landing,
  the sums, the stores) in SM cycles, and the spread of the blocks' starts
  and the launch's span in ns.
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

from chip_smoke import time_ms  # noqa: E402
from repro_torch.kernels import _build, dispatch, ref  # noqa: E402
from repro_torch.kernels.simhash_pack import plan as _plan  # noqa: E402

OUT = ROOT / "build" / "bench_simhash"
# the depth loop of sum_tile, unrolled twice (8 depth steps) as it stands
UNROLL = "#pragma unroll 2\n    for (int t = 0; t < kDepth; t += 4) {"
# the multiply-adds of one depth step, rows outer, and the same with
# columns outer
ROWS_OUTER = """#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float xi = s == 0 ? xv[i].x
                           : s == 1 ? xv[i].y
                           : s == 2 ? xv[i].z
                                    : xv[i].w;
#pragma unroll
          for (int j = 0; j < kWords; ++j) {
            acc[i][j] = fmaf(xi, av[j], acc[i][j]);
          }
        }"""
COLS_OUTER = """#pragma unroll
        for (int j = 0; j < kWords; ++j) {
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const float xi = s == 0 ? xv[i].x
                             : s == 1 ? xv[i].y
                             : s == 2 ? xv[i].z
                                      : xv[i].w;
            acc[i][j] = fmaf(xi, av[j], acc[i][j]);
          }
        }"""
# The issue's layout: a lane's kWords columns 32 apart (four 4-byte shared
# loads of A a depth step), so that each ballot is a whole word.
STRIDED = [
    ("one 4-, 8- or 16-byte load.\ntemplate <int kWords>\n"
     "__device__ __forceinline__ void load_cols(const float* p,\n"
     "                                          float (&av)[kWords]) {\n",
     "32 columns apart.\ntemplate <int kWords>\n"
     "__device__ __forceinline__ void load_cols(const float* p,\n"
     "                                          float (&av)[kWords]) {\n"
     "#pragma unroll\n  for (int j = 0; j < kWords; ++j) av[j] = p[32 * j];\n"
     "}\ntemplate <int kWords>\n"
     "__device__ __forceinline__ void load_cols_unused(const float* p,\n"
     "                                          float (&av)[kWords]) {\n"),
    ("st + kRows * kDepth + kWords * lane,", "st + kRows * kDepth + lane,"),
    ("if (lane / kWords == i - base / kWords) mine[j] = w;",
     "if (lane == e - base) mine[0] = w;"),
    ("interleave(mine, lane % kWords)", "mine[0]"),
]
# Eight warps a block in two column groups: a block owns 32 rows x 64 *
# kWords columns.
WARPS_N2 = [
    ("constexpr int kThreads = 32 * kWarps;",
     "constexpr int kThreads = 64 * kWarps;"),
    ("{ return 32 * words; }", "{ return 64 * words; }"),
    ("  const int wm = threadIdx.x / 32;\n",
     "  const int wm = threadIdx.x / 32 % kWarps;\n"
     "  const int wn = threadIdx.x / 32 / kWarps;\n"),
    ("st + kRows * kDepth + kWords * lane,",
     "st + kRows * kDepth + 32 * kWords * wn + kWords * lane,"),
    ("const int col = col0 + 32 * (e % kWords);",
     "const int col = col0 + 32 * (wn * kWords + e % kWords);"),
]
# A tile's copies in kSlices commit groups with kAhead in flight: slice s
# of a tile is summed while later ones land.  Each entry replaces the text
# from its first string up to (not including) its second.
SLICED_COPY = """constexpr int kSlices = %(s)d;                    // copy groups a tile
constexpr int kAhead = %(h)d;                     // copy groups in flight
constexpr int kSliceDepth = kDepth / kSlices;
static_assert(kSliceDepth %% 4 == 0, "a slice is whole 16-byte chunks");
static_assert(1 <= kAhead && kAhead <= 2 * kSlices - 1 && kAhead <= 4,
              "kAhead chunks fit the two stages");

__device__ __forceinline__ void wait_pending(int pending) {
  switch (pending) {
    case 0: repro_torch::wait<0>(); break;
    case 1: repro_torch::wait<1>(); break;
    case 2: repro_torch::wait<2>(); break;
    default: repro_torch::wait<3>(); break;
  }
}

// Depth [s0, s1) of the tile that starts at depth t0, one commit group.
template <int kWords, bool kVec>
__device__ __forceinline__ void copy_slice(float* xs, float* as,
                                           const float* x, const float* a,
                                           int m, int k, int n, int row0,
                                           int col0, int t0, int s0,
                                           int s1) {
  constexpr int kW = kVec ? 4 : 1;
  constexpr int kCols = block_cols(kWords);
  constexpr int x_per = kSliceDepth / kW;
  constexpr int a_per = kCols / kW;
  for (int q = threadIdx.x; q < kRows * x_per; q += kThreads) {
    const int i = q / x_per;
    const int t = s0 + (q %% x_per) * kW;
    if (row0 + i < m && t < s1) {
      repro_torch::copy<kVec>(
          xs + i * kDepth + t,
          x + static_cast<size_t>(row0 + i) * k + t0 + t);
    }
  }
  for (int q = threadIdx.x; q < kSliceDepth * a_per; q += kThreads) {
    const int t = s0 + q / a_per;
    const int c = (q %% a_per) * kW;
    if (t < s1 && col0 + c < n) {
      repro_torch::copy<kVec>(
          as + t * kCols + c,
          a + static_cast<size_t>(t0 + t) * n + col0 + c);
    }
  }
  repro_torch::commit();
}

"""
SLICED_SUM = """// acc over depth [s0, s1) of the stage, t in order.
template <int kWords>
__device__ __forceinline__ void sum_slice(const float* xs, const float* as,
                                          int s0, int s1,
                                          float (&acc)[kRowsPerWarp][kWords]) {
  constexpr int kCols = block_cols(kWords);
  if (s1 - s0 == kSliceDepth) {
#pragma unroll 2
    for (int t = 0; t < kSliceDepth; t += 4) {
      float4 xv[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        xv[i] = *reinterpret_cast<const float4*>(xs + i * kDepth + s0 + t);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float av[kWords];
        load_cols<kWords>(as + (s0 + t + s) * kCols, av);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float xi = s == 0 ? xv[i].x
                           : s == 1 ? xv[i].y
                           : s == 2 ? xv[i].z
                                    : xv[i].w;
#pragma unroll
          for (int j = 0; j < kWords; ++j) {
            acc[i][j] = fmaf(xi, av[j], acc[i][j]);
          }
        }
      }
    }
  } else {
    for (int t = s0; t < s1; ++t) {
      float av[kWords];
      load_cols<kWords>(as + t * kCols, av);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float xi = xs[i * kDepth + t];
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          acc[i][j] = fmaf(xi, av[j], acc[i][j]);
        }
      }
    }
  }
}

"""
SLICED_LOOP = """  // Chunk c is slice c %% kSlices of tile c / kSlices, tiles alternating
  // between the two stages; chunk c + kAhead is asked for once chunk c
  // has landed.
  const auto ask = [&](int c) {
    const int tile = c / kSlices;
    const int s0 = c %% kSlices * kSliceDepth;
    float* st = smem + (tile & 1) * kStage;
    copy_slice<kWords, kVec>(st, st + kRows * kDepth, x, a, m, k, n, row0,
                             col0, tile * kDepth, s0,
                             min(k - tile * kDepth, s0 + kSliceDepth));
  };
  const int chunks = tiles * kSlices;
#pragma unroll
  for (int c = 0; c < kAhead; ++c) {
    if (c < chunks) ask(c);
  }

  float acc[kRowsPerWarp][kWords];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
    for (int j = 0; j < kWords; ++j) acc[i][j] = 0.0f;
  }
  for (int c = 0; c < chunks; ++c) {
    wait_pending(min(kAhead - 1, chunks - 1 - c));
    __syncthreads();
    if (c + kAhead < chunks) ask(c + kAhead);
    asm volatile("" ::: "memory");
    const int tile = c / kSlices;
    const int s0 = c %% kSlices * kSliceDepth;
    const float* st = smem + (tile & 1) * kStage;
    const int s1 = min(k - tile * kDepth, s0 + kSliceDepth);
    if (s0 < s1) {
      sum_slice<kWords>(st + wm * kRowsPerWarp * kDepth,
                        st + kRows * kDepth + kWords * lane, s0, s1, acc);
    }
  }

"""


def sliced(s, h):
    return [
        (("// Ask for depth [0, depth) of the tile",
          "// The kWords neighbouring values of A"),
         SLICED_COPY % {"s": s, "h": h}),
        (("// acc[i][j] += x[i, t] * a[t, j] over depth [0, depth)",
          "// Bit r of x at bit"), SLICED_SUM),
        (("  // Tile c of the depth lives in stage",
          "  // Row i's kWords ballots"), SLICED_LOOP % {}),
    ]


# name -> [(text in simhash_pack.cu, or (from, up to), its replacement)]
VARIANTS = {
    **{f"slices{s}_ahead{h}": sliced(s, h)
       for s, h in ((2, 1), (2, 2), (2, 3), (4, 1), (4, 2), (4, 3))},
    "rows4": [("constexpr int kRowsPerWarp = 8;",
               "constexpr int kRowsPerWarp = 4;")],
    "rows16": [("constexpr int kRowsPerWarp = 8;",
                "constexpr int kRowsPerWarp = 16;")],
    "w8_rows4": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
                 ("constexpr int kRowsPerWarp = 8;",
                  "constexpr int kRowsPerWarp = 4;")],
    "w8_n2": WARPS_N2,
    "strided": STRIDED,
    **{f"unroll{u}": [(UNROLL, UNROLL.replace("unroll 2", f"unroll {u}"))]
       for u in (1, 4)},
    "unroll_full": [(UNROLL, UNROLL.replace("unroll 2", "unroll"))],
    "cols_outer": [(ROWS_OUTER, COLS_OUTER)],
    "nopdl": [("programmaticStreamSerializationAllowed = 1;",
               "programmaticStreamSerializationAllowed = 0;")],
}
# Diagnostic copies, wrong by design and left out of the identity check:
# the depth loop's shared loads of A, of X or of both read one address
# (hoisted out of the loop by the compiler), so their traces time the
# multiply-adds without those loads.
ONE_A = ("load_cols<kWords>(as + (t + s) * kCols, av);",
         "load_cols<kWords>(as, av);")
ONE_X = ("xv[i] = *reinterpret_cast<const float4*>(xs + i * kDepth + t);",
         "xv[i] = *reinterpret_cast<const float4*>(xs + i * kDepth);")
DIAGNOSTICS = {"diag_no_a": [ONE_A], "diag_no_x": [ONE_X],
               "diag_no_ax": [ONE_A, ONE_X]}
VARIANTS.update(DIAGNOSTICS)
# A traced copy: thread 0 of every block records clock64() and
# %globaltimer at five marks -- 0 entry, 1 past griddepcontrol.wait, 2 the
# first copies landed (past the first barrier), 3 the sums done, 4 the
# words stored.
TRACE_BLOCKS = 8192
TRACE_HEAD = r"""
__device__ unsigned long long simhash_trace[TRACE_BLOCKS * 10];
#define TRACE_MARK(i)                                                   \
  if (threadIdx.x == 0 && blockIdx.x < TRACE_BLOCKS) {                  \
    unsigned long long ns_;                                            \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));             \
    simhash_trace[(blockIdx.x * 5 + (i)) * 2] = clock64();              \
    simhash_trace[(blockIdx.x * 5 + (i)) * 2 + 1] = ns_;                \
  }
""".replace("TRACE_BLOCKS", str(TRACE_BLOCKS))
TRACE_TAIL = r"""
REPRO_EXPORT int simhash_trace_read(unsigned long long* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, simhash_trace, n * sizeof(unsigned long long)));
}
"""
TRACE_MARKS = [  # (anchor in simhash_pack.cu, its text with the mark)
    ("#include \"common.cuh\"\n", "#include \"common.cuh\"\n" + TRACE_HEAD),
    ("  const int row0 = (blockIdx.x / col_tiles) * kRows;\n",
     "  const int row0 = (blockIdx.x / col_tiles) * kRows;\n"
     "  TRACE_MARK(0)\n"),
    ("  asm volatile(\"griddepcontrol.launch_dependents;\\n\" ::);\n",
     "  asm volatile(\"griddepcontrol.launch_dependents;\\n\" ::);\n"
     "  TRACE_MARK(1)\n  bool trace_first_ = true;\n"),
    ("    __syncthreads();\n",
     "    __syncthreads();\n    if (trace_first_) {\n      TRACE_MARK(2)\n"
     "      trace_first_ = false;\n    }\n"),
    ("  // Row i's kWords ballots", "  TRACE_MARK(3)\n  // Row i's kWords ballots"),
    ("  }\n}\n\ntemplate <int kWords, bool kVec, int kK>\n",
     "  }\n  TRACE_MARK(4)\n}\n\ntemplate <int kWords, bool kVec, int kK>\n"),
]
# traced copies: name -> (the variant it marks, or None, and the words a
# thread holds, so that a block owns 32 rows x 128 columns)
TRACED = {"trace": (None, 4), "trace_strided": ("strided", 4),
          "trace_cols_outer": ("cols_outer", 4),
          "trace_slices2_ahead1": ("slices2_ahead1", 4),
          "trace_slices2_ahead2": ("slices2_ahead2", 4),
          "trace_slices4_ahead2": ("slices4_ahead2", 4),
          "trace_slices4_ahead3": ("slices4_ahead3", 4),
          "trace_w8_n2": ("w8_n2", 2),
          **{f"trace_{d}": (d, 4) for d in DIAGNOSTICS}}
SHAPES = [(512, 64, 1024), (37, 50, 96), (1, 64, 32), (513, 100, 160),
          (4096, 200, 2048)]
SWEEP_SHAPES = [(512, 64, 1024), (4096, 200, 2048)]
P, I = ctypes.c_void_p, ctypes.c_int


def log(rec):
    print(json.dumps(rec), flush=True)


def patch(text, old, new):
    """``text`` with ``old`` -- a string, or a (from, up to) pair naming the
    region from the first up to the second -- replaced by ``new``; each
    must occur once."""
    if isinstance(old, tuple):
        first, upto = old
        if text.count(first) != 1 or text.count(upto) != 1:
            raise RuntimeError(f"simhash_pack.cu: expected one {old!r}")
        i, j = text.index(first), text.index(upto)
        return text[:i] + new + text[j:]
    if text.count(old) != 1:
        raise RuntimeError(f"simhash_pack.cu: expected one {old!r}")
    return text.replace(old, new)


def traced(text):
    """``text`` (a simhash_pack.cu) with the trace marks put in."""
    for anchor, marked in TRACE_MARKS:
        text = patch(text, anchor, marked)
    return text + TRACE_TAIL


def variant_sources():
    """One directory per variant holding its copy of simhash_pack.cu (the
    headers come from this checkout's csrc/ through -I)."""
    text = (_build.CSRC / "simhash_pack.cu").read_text()

    def variant(name):
        out = text
        for old, new in VARIANTS[name] if name else ():
            out = patch(out, old, new)
        return out
    texts = {name: variant(name) for name in VARIANTS}
    texts.update({name: traced(variant(base))
                  for name, (base, _) in TRACED.items()})
    srcs = {}
    for name, body in texts.items():
        d = OUT / "src" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "simhash_pack.cu").write_text(body)
        srcs[name] = d / "simhash_pack.cu"
    return srcs


def nvcc_all(jobs):
    """jobs: name -> (source, include dir); all compiled in parallel."""
    procs = {}
    for name, (src, inc) in jobs.items():
        out = OUT / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(inc), "-o",
               str(out), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log({"ptxas": name, "line": line.strip()})
        libs[name] = ctypes.CDLL(str(out))
    return libs


def bind(lib, with_plan):
    """The launcher as (x, a, m, n, k, words, vec, sig, stream); the
    parent's interface before the plan (``with_plan`` False) ignores
    words and vec."""
    fn = lib.simhash_pack_launch
    fn.restype = I
    fn.argtypes = ([P, P, I, I, I, I, I, P, P] if with_plan
                   else [P, P, I, I, I, P, P])

    def call(x, a, m, n, k, words, vec, sig, stream):
        args = (x, a, m, n, k) + ((words, int(vec)) if with_plan else ())
        code = fn(*args, sig, stream)
        if code:
            raise RuntimeError(f"simhash_pack launch: CUDA error {code}")
    return call


def operands(gen, m, n, k, offset=0):
    """x (m, n) and A (n, k) on the card, ``offset`` floats past an
    aligned base; x's row 0 all zero, row 1 all -0.0 (every word -1)."""
    def mk(t):
        flat = torch.empty(offset + t.numel(), device="cuda")
        view = flat[offset:].view(t.shape)
        view.copy_(t)
        return view
    x = torch.randn((m, n), generator=gen)
    x[0] = 0.0
    if m > 1:
        x[1] = -0.0
    return mk(x), mk(torch.randn((n, k), generator=gen))


def run(call, x, a, words, vec):
    m, n = x.shape
    k = a.shape[1]
    sig = torch.empty((m, k // 32), dtype=torch.int32, device="cuda")
    call(x.data_ptr(), a.data_ptr(), m, n, k, words, vec, sig.data_ptr(),
         dispatch.stream_handle(x))
    torch.cuda.synchronize()
    return sig


def identity(launchers, gen):
    for m, n, k in SHAPES:
        for offset in (0, 1):
            x, a = operands(gen, m, n, k, offset)
            pl = _plan(m, n, k, (x.data_ptr() | a.data_ptr()) % 16 == 0)
            mine = run(launchers["this"], x, a, pl.words, pl.vec)
            want = ref.simhash_pack_ref(x, a)
            shifts = torch.arange(32, device="cuda")
            unpack = lambda s: ((s[..., None] >> shifts) & 1).reshape(m, k)
            near = (x.double() @ a.double()).abs() < 1e-5
            flips = unpack(mine) != unpack(want)
            rec = {"identity": [m, n, k], "offset": offset,
                   "words": pl.words, "vec": pl.vec,
                   "plain_bits_away_from_0": not bool(flips[~near].any()),
                   "near_0": int(near.sum()), "flipped": int(flips.sum()),
                   "zero_rows_all_set": bool((mine[:min(m, 2)] == -1).all())}
            for name, call in launchers.items():
                if name != "this" and "diag" not in name:
                    rec[name] = torch.equal(run(call, x, a, pl.words,
                                                pl.vec), mine)
            log(rec)


def sweep(launchers, gen):
    order = ["parent", "this", *VARIANTS]
    order = [w for w in order + order[::-1] if w in launchers]
    for m, n, k in SWEEP_SHAPES:
        x, a = operands(gen, m, n, k)
        sig = torch.empty((m, k // 32), dtype=torch.int32, device="cuda")
        pl = _plan(m, n, k)
        rec = {"sweep": [m, n, k], "plan_words": pl.words}
        for who in order:
            for words in ((None,) if who == "parent" else (4, 2, 1)):
                us = time_ms(lambda: launchers[who](
                    x.data_ptr(), a.data_ptr(), m, n, k, words, True,
                    sig.data_ptr(), dispatch.stream_handle(x))) * 1e3
                tag = "" if words is None else f"@{words}"
                rec.setdefault(f"{who}_us{tag}", []).append(us)
        log(rec)


def trace(libs, launchers, gen):
    """Each traced copy at the benchmark's shape: medians over blocks of
    each step in SM cycles, the SM clock they imply, and the spread of the
    blocks' starts and the span of the launch on the global timer (ns)."""
    m, n, k = SWEEP_SHAPES[0]
    x, a = operands(gen, m, n, k)
    pl = _plan(m, n, k)
    blocks = -(-m // 32) * -(-k // 128)     # 32 x 128 a block (TRACED)
    for name, (_, words) in TRACED.items():
        call = launchers[name]
        run(call, x, a, words, pl.vec)             # warm
        run(call, x, a, words, pl.vec)
        buf = (ctypes.c_ulonglong * (blocks * 10))()
        fn = libs[name].simhash_trace_read
        fn.argtypes, fn.restype = [P, I], I
        if fn(ctypes.addressof(buf), blocks * 10):
            raise RuntimeError(f"{name}: reading the trace failed")
        v = torch.tensor(list(buf), dtype=torch.float64).view(blocks, 5, 2)
        cyc, ns = v[..., 0], v[..., 1]
        med = lambda t: float(t.median())
        log({"trace": name, "words": words, "shape": [m, n, k],
             "blocks": blocks,
             "cycles": {"wait": med(cyc[:, 1] - cyc[:, 0]),
                        "copies": med(cyc[:, 2] - cyc[:, 1]),
                        "sums": med(cyc[:, 3] - cyc[:, 2]),
                        "store": med(cyc[:, 4] - cyc[:, 3]),
                        "block": med(cyc[:, 4] - cyc[:, 0])},
             "sm_ghz": med((cyc[:, 4] - cyc[:, 0]) / (ns[:, 4] - ns[:, 0])),
             "ns": {"start_spread": float(ns[:, 0].max() - ns[:, 0].min()),
                    "span": float(ns[:, 4].max() - ns[:, 0].min()),
                    "block": med(ns[:, 4] - ns[:, 0])}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of another checkout "
                    "whose K7 kernel to compare with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_simhash: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {name: (src, _build.CSRC)
            for name, src in variant_sources().items()}
    with_plan = True
    if args.parent:
        pcsrc = args.parent / "src" / "repro_torch" / "csrc"
        jobs["parent"] = (pcsrc / "simhash_pack.cu", pcsrc)
        with_plan = "plan(" in (args.parent / "src" / "repro_torch" /
                                "kernels" / "simhash_pack.py").read_text()
    _build.build(["simhash_pack"])
    libs = nvcc_all(jobs)
    launchers = {"this": bind(_build.library("simhash_pack"), True)}
    for name, lib in libs.items():
        launchers[name] = bind(lib, with_plan if name == "parent" else True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log({"device": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda})
    for line in _build.build_log("simhash_pack").splitlines():
        if "registers" in line or "spill" in line:
            log({"ptxas": "this", "line": line.strip()})
    gen = torch.Generator().manual_seed(0)
    identity(launchers, gen)
    sweep(launchers, gen)
    trace(libs, launchers, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
