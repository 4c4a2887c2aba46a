// K3 merge: the bitonic (distance, id) compare-exchange network that sorts
// the cross-segment top-k pool.
//
// Replaces: src/repro/kernels/merge.py, _bitonic_kernel / sort_pairs_pallas
// (the fan-in of ops.merge_topk after SegmentedIndex.query).
//
// Bound on the H100: bytes by the roofline -- a row of P pairs makes one
// trip to device memory, and its P/2 * log2(P) * (log2(P)+1)/2
// compare-exchanges (P = 4096 at 256 segments x k = 10) cost less at the
// fp32 rate.  What a block really waits on is the ~90 barriers between
// the network's passes.
//
// Design: one block per row; the power-of-two pool lives in shared memory
// (P * 8 bytes) and every stage of merge._network runs there between
// barriers: the reversal of the odd run of each pair, then the half-cleaner
// passes.  Stages below `sorted_run` are skipped exactly as in the
// reference.  It only compares and selects, so it is bit-identical to the
// plain network, (+inf, INT32_MAX) padding included.  Only the first
// `n_out` columns are written back (the merge needs k of P).
#include <climits>

#include "common.cuh"

namespace {

__global__ void bitonic_kernel(const float* __restrict__ d_in,
                               const int* __restrict__ i_in, int m, int pw,
                               int sorted_run, int n_out,
                               float* __restrict__ d_out,
                               int* __restrict__ i_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sd = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sd + pw);
  const float* drow = d_in + static_cast<size_t>(blockIdx.x) * m;
  const int* irow = i_in + static_cast<size_t>(blockIdx.x) * m;

  for (int t = threadIdx.x; t < pw; t += blockDim.x) {
    sd[t] = t < m ? drow[t] : INFINITY;
    si[t] = t < m ? irow[t] : INT_MAX;
  }
  __syncthreads();

  for (int run = sorted_run; run < pw; run *= 2) {
    // Reverse the second run of every 2*run chunk: each chunk is then
    // bitonic (merge._network's concatenate of dr[..., 1:, ::-1]).
    const int half = run / 2;
    if (half > 0) {
      const int swaps = (pw / (2 * run)) * half;
      for (int t = threadIdx.x; t < swaps; t += blockDim.x) {
        const int chunk = t / half;
        const int j = t % half;
        const int lo = chunk * 2 * run + run + j;
        const int hi = chunk * 2 * run + 2 * run - 1 - j;
        const float td = sd[lo];
        sd[lo] = sd[hi];
        sd[hi] = td;
        const int ti = si[lo];
        si[lo] = si[hi];
        si[hi] = ti;
      }
      __syncthreads();
    }
    for (int span = 2 * run; span >= 2; span /= 2) {
      const int hs = span / 2;
      for (int t = threadIdx.x; t < pw / 2; t += blockDim.x) {
        const int a = (t / hs) * span + (t % hs);
        const int b = a + hs;
        const float d0 = sd[a];
        const float d1 = sd[b];
        const int i0 = si[a];
        const int i1 = si[b];
        if (d1 < d0 || (d1 == d0 && i1 < i0)) {
          sd[a] = d1;
          sd[b] = d0;
          si[a] = i1;
          si[b] = i0;
        }
      }
      __syncthreads();
    }
  }

  float* dro = d_out + static_cast<size_t>(blockIdx.x) * n_out;
  int* iro = i_out + static_cast<size_t>(blockIdx.x) * n_out;
  for (int t = threadIdx.x; t < n_out; t += blockDim.x) {
    dro[t] = sd[t];
    iro[t] = si[t];
  }
}

}  // namespace

REPRO_DEFINE_ERROR_STRING(merge)

// d, ids: (rows, m); pw: the power of two >= m; outputs (rows, n_out).
REPRO_EXPORT int merge_launch(const float* d, const int* ids, int rows, int m,
                              int pw, int sorted_run, int n_out, float* d_out,
                              int* i_out, void* stream) {
  const size_t smem = static_cast<size_t>(pw) * 8;
  cudaError_t err = repro_torch::allow_dynamic_smem(bitonic_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = pw / 2;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  bitonic_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      d, ids, m, pw, sorted_run, n_out, d_out, i_out);
  return static_cast<int>(cudaGetLastError());
}
