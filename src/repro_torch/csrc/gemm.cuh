// Tiled fp32 SIMT GEMM skeleton of K7 (simhash_pack.cu), the only kernel
// that uses it: C[i, j] = epilogue(i, j, sum_t A[i, t] * B[t, j]); K1 and K4
// use small_gemm.cuh.  The 32 lanes of a warp hold 32 consecutive
// columns of one row, and a warp calls the epilogue together or not at all
// when n % 32 == 0 (K7 relies on it for a warp-wide ballot).
//
// Every output element is one thread's sequential fmaf chain over
// t = 0 .. K-1 in order (no split-K, no tensor cores, no TF32), so a row's
// result does not depend on how many rows share the launch.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int kTileM = 32;     // rows of C per block
constexpr int kTileN = 32;     // columns of C per block (one per thread x)
constexpr int kTileK = 32;     // depth staged in shared memory per step
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kRowsPerThread = kTileM / kThreadsY;

// a: (m, k) row-major; b: (k, n) row-major; both contiguous fp32.
template <class Epilogue>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
gemm_epilogue_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     int m, int n, int k, Epilogue epi) {
  // A is staged transposed (depth-major) with one pad column so the
  // coalesced row loads do not collide on a bank.
  __shared__ float as[kTileK][kTileM + 1];
  __shared__ float bs[kTileK][kTileN];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row0 = blockIdx.y * kTileM;
  const int col = blockIdx.x * kTileN + tx;

  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kTileK) {
    for (int i = ty; i < kTileM; i += kThreadsY) {
      const int r = row0 + i;
      const int t = k0 + tx;
      as[tx][i] = (r < m && t < k) ? a[static_cast<size_t>(r) * k + t] : 0.0f;
    }
    for (int i = ty; i < kTileK; i += kThreadsY) {
      const int t = k0 + i;
      bs[i][tx] = (t < k && col < n) ? b[static_cast<size_t>(t) * n + col]
                                     : 0.0f;
    }
    __syncthreads();
    // Only the real depth is summed: padding never enters the chain.
    const int depth = min(kTileK, k - k0);
    for (int t = 0; t < depth; ++t) {
      const float bv = bs[t][tx];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        acc[i] = fmaf(as[t][ty + i * kThreadsY], bv, acc[i]);
      }
    }
    __syncthreads();
  }

  if (col >= n) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = row0 + ty + i * kThreadsY;
    if (r < m) epi(r, col, acc[i]);
  }
}

template <class Epilogue>
inline cudaError_t launch_gemm(const float* a, const float* b, int m, int n,
                               int k, Epilogue epi, cudaStream_t stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
  gemm_epilogue_kernel<Epilogue><<<grid, block, 0, stream>>>(a, b, m, n, k,
                                                             epi);
  return cudaGetLastError();
}

}  // namespace repro_torch
