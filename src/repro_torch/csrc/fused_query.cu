// K2 fused_query: candidate gather + masked L^p distance + top-k, per query
// row, without materialising the (nq, C, N) candidate tensor.
//
// Replaces: src/repro/kernels/fused_query.py, _fused_query_kernel (reached
// through ops.fused_query_topk from core.index.query_index, once per
// segment per query micro-batch).
//
// Bound on the H100: bytes.  Each valid candidate costs one N-float row read
// (256 B at N = 64) for 3N flops; the gather is random-access, so the rows
// come in 32-byte sectors rather than full lines.
//
// Design: one block per query row.  The block loads its own candidate ids
// (the TPU version had them scalar-prefetched) and its query into shared
// memory; each warp takes candidate slots in turn, its lanes stride the row
// and a shuffle reduction finishes the distance (p = 2, p = 1, general p).
// Slots with id < 0 or id >= valid score +inf.  The C distances and ids stay
// in shared memory (C * 8 bytes), and k rounds of block-wide argmin pick
// the winners, the lower slot winning ties (topk.cuh, shared with K5).
#include "topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
fused_query_kernel(const float* __restrict__ q, const float* __restrict__ db,
                   const int* __restrict__ ids, int n, int c, int k,
                   int valid, int pmode, float p, float* __restrict__ out_d,
                   int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sd = reinterpret_cast<float*>(smem);     // (c,) distances
  int* si = reinterpret_cast<int*>(sd + c);       // (c,) candidate ids
  float* sq = reinterpret_cast<float*>(si + c);   // (n,) the query row
  __shared__ float wbest[kWarps];
  __shared__ int wslot[kWarps];

  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int* rid = ids + static_cast<size_t>(row) * c;

  for (int j = threadIdx.x; j < n; j += kThreads) {
    sq[j] = q[static_cast<size_t>(row) * n + j];
  }
  __syncthreads();

  for (int s = warp; s < c; s += kWarps) {
    const int id = rid[s];
    float d = INFINITY;
    if (id >= 0 && id < valid) {
      const float* x = db + static_cast<size_t>(id) * n;
      float acc = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const float diff = x[j] - sq[j];
        if (pmode == 2) {
          acc += diff * diff;
        } else if (pmode == 1) {
          acc += fabsf(diff);
        } else {
          acc += powf(fabsf(diff), p);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      d = pmode == 2 ? sqrtf(acc)
                     : (pmode == 1 ? acc : powf(acc, 1.0f / p));
    }
    if (lane == 0) {
      sd[s] = d;
      si[s] = id;
    }
  }
  __syncthreads();

  repro_torch::block_select_topk<kThreads>(sd, si, c, k, 1.0f, wbest, wslot,
                                          out_d, out_i, row);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING(fused_query)

// q: (nq, n); db: (m, n); ids: (nq, c) int32; outputs (nq, k) distances and
// ids.  pmode 2 / 1 select the p = 2 / p = 1 forms, 0 the general power p.
REPRO_EXPORT int fused_query_launch(const float* q, const float* db,
                                    const int* ids, int nq, int n, int c,
                                    int k, int valid, int pmode, float p,
                                    float* out_d, int* out_i, void* stream) {
  const size_t smem = static_cast<size_t>(c) * 8 + static_cast<size_t>(n) * 4;
  cudaError_t err = repro_torch::allow_dynamic_smem(fused_query_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_query_kernel<<<nq, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, db, ids, n, c, k, valid, pmode, p, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}
