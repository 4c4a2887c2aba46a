// Latency-bound small fp32 GEMM shared by K1 (hash_mm.cu) and K4
// (dct_mm.cu): C[i, j] = epilogue(i, j, sum_t X[i, t] * A[t, j], v[j]).
//
// At the serve path's shapes (X of 32..256 rows and K = 64 columns, A of
// 64 x 32 or 64 x 64) the product is 131 kFLOP to 1 MFLOP over 17-82 KB, a
// few nanoseconds of the card's rates: what a call costs is the launch and
// the chain of dependent steps inside it, not bytes or operations.  So:
//
// - One round trip.  A block issues every copy it needs -- its X rows, its
//   32-column tile of A and the tile's 32 entries of v -- as cp.async
//   requests (16 bytes each on the vector path), waits once and meets at
//   one barrier.  At K = 64 that is the whole depth; a deeper K is tiled
//   64 at a time, double-buffered, the next tile's copies in flight while
//   this one is summed.
// - Parallel copies, few outputs a thread.  A block is 8 warps; all of them
//   issue its copies (a block of one warp spends longer issuing them than
//   the product takes), and the first `rows` (1..8, the wrapper's plan)
//   compute one row each, one output per thread, so the path's shapes
//   spread over 32-64 SMs in one wave where one 32 x 32 tile a block kept
//   1-8 busy.
// - An unrolled depth loop.  K = 64 is an instantiation of its own; the
//   row's values are read as float4 broadcasts, A's column one value per
//   lane, conflict-free.
// - Programmatic dependent launch (launch_as): the launch of the next
//   kernel overlaps the tail of this one.
//
// Arithmetic is that of the reference, and of the earlier kernel bit for
// bit: each output is one fmaf chain over t = 0 .. K-1 in order, from 0.0f,
// no split-K, no tensor cores, no TF32.  A row's result therefore does not
// depend on the batch it arrives in, and build and query hash alike.
//
// Vector path: every pointer 16-byte aligned and both row lengths (K for X,
// N for A and v) multiples of 4 floats; anything else takes the scalar
// instantiation (4-byte copies, the same single round trip).
#pragma once

#include "common.cuh"

namespace repro_torch {
namespace small_gemm {

constexpr int kCols = 32;       // columns of C per block, one per lane
constexpr int kDepth = 64;      // depth per round: the path's whole K
constexpr int kMaxWarps = 8;    // warps per block, all copying; each of
                                // the first `rows` computes one row of C
constexpr int kThreads = kCols * kMaxWarps;

// Dynamic shared bytes of a block: per stage its rows x kDepth values of X
// and kDepth x kCols of A, then kCols entries of v.
__host__ __device__ constexpr int smem_bytes(int rows, int stages) {
  return 4 * (stages * (rows * kDepth + kDepth * kCols) + kCols);
}

// Copies one depth tile [t0, t0 + dk) of A's column tile into `as`
// (kDepth x kCols), or of the block's rows of X into `xs` (rows x kDepth).
// On the vector path one request moves 4 floats; t0, dk and N are then
// multiples of 4, so a request never straddles the matrix's edge.
// Every warp of the block copies, including those that compute no row.
template <bool kVec>
__device__ __forceinline__ void copy_a(float* as, const float* a, int n,
                                       int col0, int t0, int dk) {
  constexpr int w = kVec ? 4 : 1;
  constexpr int per_row = kCols / w;
  for (int q = threadIdx.x + threadIdx.y * kCols; q < kDepth * per_row;
       q += kThreads) {
    const int t = q / per_row;
    const int c = (q % per_row) * w;
    if (t < dk && col0 + c < n) {
      copy<kVec>(as + t * kCols + c,
                 a + static_cast<size_t>(t0 + t) * n + col0 + c);
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void copy_x(float* xs, const float* x, int m,
                                       int k, int rows, int row0, int t0,
                                       int dk) {
  constexpr int w = kVec ? 4 : 1;
  constexpr int per_row = kDepth / w;
  for (int q = threadIdx.x + threadIdx.y * kCols; q < rows * per_row;
       q += kThreads) {
    const int i = q / per_row;
    const int t = (q % per_row) * w;
    if (row0 + i < m && t < dk) {
      copy<kVec>(xs + i * kDepth + t,
                 x + static_cast<size_t>(row0 + i) * k + t0 + t);
    }
  }
}

// kK: the depth when known at compile time (the path's 64), else 0.
// x: (m, k); a: (k, n); v: (n,); all fp32, row-major.  The grid is 1-D:
// block b owns rows [(b / col_tiles) * rows, +rows) and columns
// [(b % col_tiles) * kCols, +kCols); thread (lane, y < rows) the output
// at row y and column lane of that tile.  All kMaxWarps warps share the
// copies.
template <int kK, bool kVec, class Epilogue>
__global__ void __launch_bounds__(kThreads)
small_gemm_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ v, int m, int n, int k_arg,
                  int rows, int col_tiles, Epilogue epi) {
  extern __shared__ __align__(16) float smem[];
  const int k = kK ? kK : k_arg;
  const int tiles = (k + kDepth - 1) / kDepth;
  const int stage_floats = rows * kDepth + kDepth * kCols;
  float* vs = smem + (tiles > 1 ? 2 : 1) * stage_floats;
  const int lane = threadIdx.x;
  const int y = threadIdx.y;
  const int col0 = (blockIdx.x % col_tiles) * kCols;
  const int row0 = (blockIdx.x / col_tiles) * rows;

  // Programmatic dependent launch: wait for the kernels before this one
  // (their writes to x, a and v visible), then let the next one launch.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  {
    const int tid = lane + y * kCols;
    constexpr int w = kVec ? 4 : 1;
    if (tid * w < kCols && col0 + tid * w < n) {
      copy<kVec>(vs + tid * w, v + col0 + tid * w);
    }
  }
  if (tiles > 0) {
    copy_a<kVec>(smem + rows * kDepth, a, n, col0, 0, min(kDepth, k));
    copy_x<kVec>(smem, x, m, k, rows, row0, 0, min(kDepth, k));
  }
  commit();

  float acc = 0.0f;
  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      float* next = smem + ((tile + 1) & 1) * stage_floats;
      const int t0 = (tile + 1) * kDepth;
      const int dk = min(kDepth, k - t0);
      copy_x<kVec>(next, x, m, k, rows, row0, t0, dk);
      copy_a<kVec>(next + rows * kDepth, a, n, col0, t0, dk);
      commit();
      wait<1>();
    } else {
      wait<0>();
    }
    __syncthreads();
    const float* xs = smem + (tile & 1) * stage_floats + y * kDepth;
    const float* as = smem + (tile & 1) * stage_floats + rows * kDepth + lane;
    const int dk = min(kDepth, k - tile * kDepth);
    if (y >= rows) {
      // a copy-only warp
    } else if (dk == kDepth) {
#pragma unroll
      for (int t = 0; t < kDepth; t += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + t);
        acc = fmaf(xv.x, as[(t + 0) * kCols], acc);
        acc = fmaf(xv.y, as[(t + 1) * kCols], acc);
        acc = fmaf(xv.z, as[(t + 2) * kCols], acc);
        acc = fmaf(xv.w, as[(t + 3) * kCols], acc);
      }
    } else {
      // Only the real depth is summed: padding never enters the chain.
      for (int t = 0; t < dk; ++t) acc = fmaf(xs[t], as[t * kCols], acc);
    }
    // The buffer just read is refilled by the next iteration's copies.
    if (tile + 2 < tiles) __syncthreads();
  }
  if (tiles == 0) {
    wait<0>();
    __syncthreads();
  }

  const int row = row0 + y;
  const int col = col0 + lane;
  if (y < rows && row < m && col < n) epi(row, col, acc, vs[lane]);
}

// Launched with programmatic stream serialization (programmatic dependent
// launch), so that the next kernel's launch overlaps this one's tail.
template <int kK, bool kVec, class Epilogue>
inline cudaError_t launch_as(const float* x, const float* a, const float* v,
                             int m, int n, int k, int rows, Epilogue epi,
                             cudaStream_t stream) {
  const long long col_tiles = (n + kCols - 1) / kCols;
  const long long blocks = col_tiles * ((m + rows - 1) / rows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kCols, kMaxWarps);
  cfg.dynamicSmemBytes = smem_bytes(rows, k > kDepth ? 2 : 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, small_gemm_kernel<kK, kVec, Epilogue>, x, a,
                         v, m, n, k, rows, static_cast<int>(col_tiles), epi);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// rows (1 .. kMaxWarps) and vec come from the wrapper's plan
// (kernels/small_gemm.plan); vec requires 16-byte aligned x, a and v and
// k, n multiples of 4 (the wrapper checks).
template <class Epilogue>
inline cudaError_t launch(const float* x, const float* a, const float* v,
                          int m, int n, int k, int rows, bool vec,
                          Epilogue epi, cudaStream_t stream) {
  if (rows < 1 || rows > kMaxWarps) return cudaErrorInvalidValue;
  if (k == kDepth) {
    return vec ? launch_as<kDepth, true>(x, a, v, m, n, k, rows, epi, stream)
               : launch_as<kDepth, false>(x, a, v, m, n, k, rows, epi,
                                          stream);
  }
  return vec ? launch_as<0, true>(x, a, v, m, n, k, rows, epi, stream)
             : launch_as<0, false>(x, a, v, m, n, k, rows, epi, stream);
}

}  // namespace small_gemm
}  // namespace repro_torch
