// K6 rerank: masked L^p distances between each query row and its
// pre-gathered candidate rows, d[b, c] = || q_b - e_{b,c} ||_p, +inf where
// the candidate id is < 0.
//
// Replaces: src/repro/kernels/rerank.py, _rerank_kernel (the
// rerank_distances pallas_call behind ops.candidate_distances; in the port
// it is the exact fp32 survivor rescore of the quantized tier,
// quantize.rerank_survivors, once per query micro-batch).
//
// Bound on the H100: bytes.  Every (b, c) pair reads one N-float row (256 B
// at N = 64) for 3N flops and writes one float.
//
// Design: the subtract, power, reduce and mask in one pass, so the
// (B, C, N) difference tensor never exists.  One warp per (b, c) pair, its
// lanes striding the row (coalesced: the rows of a query are contiguous)
// and a shuffle reduction finishing the sum (p = 2, p = 1, general p, as
// K2).  A pair whose id is < 0 writes +inf without reading its row, which
// is garbage by contract.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
rerank_kernel(const float* __restrict__ q, const float* __restrict__ emb,
              const int* __restrict__ ids, int b, int c, int n, int pmode,
              float p, float* __restrict__ out) {
  const long long pair =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= static_cast<long long>(b) * c) return;
  const long long row = pair / c;
  float d = INFINITY;
  if (ids[pair] >= 0) {
    const float* x = emb + pair * n;
    const float* qr = q + row * n;
    float acc = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float diff = x[j] - qr[j];
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
    d = pmode == 2 ? sqrtf(acc) : (pmode == 1 ? acc : powf(acc, 1.0f / p));
  }
  if (lane == 0) out[pair] = d;
}

}  // namespace

REPRO_DEFINE_ERROR_STRING(rerank)

// q: (b, n); emb: (b, c, n); ids: (b, c) int32; out: (b, c) fp32.
// pmode 2 / 1 select the p = 2 / p = 1 forms, 0 the general power p.
REPRO_EXPORT int rerank_launch(const float* q, const float* emb,
                               const int* ids, int b, int c, int n, int pmode,
                               float p, float* out, void* stream) {
  const long long pairs = static_cast<long long>(b) * c;
  const unsigned blocks =
      static_cast<unsigned>((pairs + kWarps - 1) / kWarps);
  rerank_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, emb, ids, b, c, n, pmode, p, out);
  return static_cast<int>(cudaGetLastError());
}
