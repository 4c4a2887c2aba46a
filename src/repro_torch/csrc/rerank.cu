// K6 rerank: masked L^p distances between each query row and its
// pre-gathered candidate rows, d[b, c] = || q_b - e_{b,c} ||_p, +inf where
// the candidate id is < 0.
//
// Replaces: src/repro/kernels/rerank.py, _rerank_kernel (the
// rerank_distances pallas_call behind ops.candidate_distances; in the port
// it is the exact fp32 survivor rescore of the quantized tier,
// quantize.rerank_survivors, once per query micro-batch).
//
// Bound on the H100: bytes.  Every valid (b, c) pair reads one N-float row
// (256 B at N = 64) for 3N flops and writes one float: 0.41 us at (128,
// 40, 64).  What a call waits on is latency: the query rows, then the ids,
// then the rows the ids let it read, on a grid of ~128 blocks.
//
// Design, as topk.cuh's score loop: the subtract, power, reduce and mask in
// one pass, so the (B, C, N) difference tensor never exists.
// - A block owns `rows` query rows (the wrapper's plan: 1 at the path's 128
//   rows) and all their C candidates; it copies its query rows into shared
//   memory once (cp.async, in flight with the ids of its first pairs), and
//   waits for them only after it has asked for its first candidate rows,
//   so the barrier adds no round trip to the ids -> rows chain.
// - One sub-warp of L lanes per (b, c) pair, L = row bytes / 32 (8 at
//   N = 64: four pairs a warp), each lane two 16-byte loads of the row at
//   once, two pairs a sub-warp in flight (64 pairs a block: a 40-candidate
//   row in one round; four measured 0.35 us slower at (128, 40, 64),
//   tools/bench_merge.py), then a log2(L)-step shuffle sum.
//   N % 4 != 0 or an unaligned pointer takes the scalar instantiation (L
//   lanes stride the row one float at a time, two at once).
// - The metric (p = 2, p = 1, general p) is a template argument, so the
//   inner loop carries no branch and never evaluates powf for p in {1, 2}.
// - A pair whose id is < 0 writes +inf without reading its row, which is
//   garbage by contract.
// - Launched with programmatic dependent launch (cudaLaunchKernelEx), as
//   K1 and K4: griddepcontrol.wait before the first load.
#include "topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;     // pairs a sub-warp has in flight
constexpr int kPre = 2;        // units of a row a lane asks for at once

struct Args {
  const float* q;      // (b, n)
  const float* emb;    // (b, c, n)
  const int* ids;      // (b, c)
  int b, c, n;
  float p;
  int rows;            // query rows a block owns
  int lanes_log2;      // log2 of L, lanes per pair
  float* out;          // (b, c)
};

template <bool kVec, int kMode>
__global__ void __launch_bounds__(kThreads) rerank_kernel(const Args a) {
  namespace topk = repro_torch::topk;
  extern __shared__ __align__(16) float sq[];   // rows x ldq
  const int ldq = (a.n + 3) / 4 * 4;    // 16-byte aligned query rows
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int lg = a.lanes_log2;
  const int lanes = 1 << lg;
  const int subs = 32 >> lg;           // sub-warps per warp
  const int sub = lane >> lg;
  const int sl = lane & (lanes - 1);
  const int stride = kWarps * subs;    // sub-warps per block
  const int row0 = blockIdx.x * a.rows;
  const int nrows = min(a.rows, a.b - row0);
  const int pairs = nrows * a.c;
  const size_t pair0 = static_cast<size_t>(row0) * a.c;

  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::);

  int e[kUnroll], id[kUnroll];
  auto load_ids = [&](int base) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      e[u] = base + u * stride + warp * subs + sub;
      id[u] = e[u] < pairs ? __ldg(a.ids + pair0 + e[u]) : -1;
    }
  };
  load_ids(0);
  // The query rows go to shared memory by cp.async, in flight with the ids;
  // the block waits for them only once its first rows are in flight too.
  for (int i = tid; i < nrows * a.n; i += kThreads) {
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(sq + (i / a.n) * ldq + i % a.n));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(a.q + static_cast<size_t>(row0) * a.n + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // kW floats a lane reads at a time: one 16-byte chunk, or one float
  constexpr int kW = kVec ? 4 : 1;
  const int units = a.n / kW;
  for (int base = 0; base < pairs; base += kUnroll * stride) {
    if (base > 0) load_ids(base);
    float acc[kUnroll];
    const float* x[kUnroll];
    const float* qr[kUnroll];
    float v[kPre][kUnroll][kW];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc[u] = 0.0f;
      x[u] = a.emb + (pair0 + max(e[u], 0)) * a.n;
      qr[u] = sq + (e[u] < pairs ? e[u] / a.c : 0) * ldq;
    }
    // units j0, j0 + L, ..., kPre of them, of every pair's row
    auto fetch = [&](int j0) {
#pragma unroll
      for (int t = 0; t < kPre; ++t) {
        const int j = j0 + t * lanes;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (id[u] >= 0 && j < units) {
            if constexpr (kVec) {
              const float4 f =
                  __ldg(reinterpret_cast<const float4*>(x[u]) + j);
              v[t][u][0] = f.x;
              v[t][u][1] = f.y;
              v[t][u][2] = f.z;
              v[t][u][3] = f.w;
            } else {
              v[t][u][0] = __ldg(x[u] + j);
            }
          }
        }
      }
    };
    // every lane has a first unit (L <= units): its rows are asked for
    // before the block waits for the query
    int j0 = sl;
    fetch(j0);
    if (base == 0) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    while (true) {
#pragma unroll
      for (int t = 0; t < kPre; ++t) {
        const int j = j0 + t * lanes;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (id[u] >= 0 && j < units) {
#pragma unroll
            for (int w = 0; w < kW; ++w) {
              acc[u] += topk::term<kMode>(v[t][u][w] - qr[u][j * kW + w],
                                          a.p);
            }
          }
        }
      }
      j0 += kPre * lanes;
      if (j0 >= units) break;
      fetch(j0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      for (int off = lanes >> 1; off > 0; off >>= 1) {
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      }
      if (e[u] < pairs && sl == 0) {
        a.out[pair0 + e[u]] =
            id[u] >= 0 ? topk::finish<kMode>(acc[u], a.p) : INFINITY;
      }
    }
  }
}

template <bool kVec>
int launch_as(const Args& a, int pmode, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((a.b + a.rows - 1) / a.rows));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (pmode == 2) {
    err = cudaLaunchKernelEx(&cfg, rerank_kernel<kVec, 2>, a);
  } else if (pmode == 1) {
    err = cudaLaunchKernelEx(&cfg, rerank_kernel<kVec, 1>, a);
  } else {
    err = cudaLaunchKernelEx(&cfg, rerank_kernel<kVec, 0>, a);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_DEFINE_ERROR_STRING(rerank)

// q: (b, n); emb: (b, c, n); ids: (b, c) int32; out: (b, c) fp32.
// pmode 2 / 1 select the p = 2 / p = 1 forms, 0 the general power p.  rows
// (query rows a block), lanes_log2 and vec come from the wrapper's plan;
// vec needs q and emb 16-byte aligned and n % 4 == 0; L = 1 << lanes_log2
// must not exceed the row's 16-byte chunks (vec) or floats.  The query
// rows take rows x n (padded to 4) floats of shared memory, at most 48 KB.
REPRO_EXPORT int rerank_launch(const float* q, const float* emb,
                               const int* ids, int b, int c, int n, int pmode,
                               float p, int rows, int lanes_log2, int vec,
                               float* out, void* stream) {
  const size_t smem = static_cast<size_t>(rows) * ((n + 3) / 4 * 4) * 4;
  const int units = vec ? n / 4 : n;    // a lane reads >= 1 of a row's
  if (rows < 1 || lanes_log2 < 0 || (1 << lanes_log2) > units ||
      lanes_log2 > 5 || smem > 48 * 1024 || (vec && n % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, emb, ids, b, c, n, p, rows, lanes_log2, out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch_as<true>(a, pmode, smem, st)
             : launch_as<false>(a, pmode, smem, st);
}
