// K5 quantized_query: candidate gather from int8 or bf16 codes + masked
// L^p distance in code space + top-k, per query row, then one multiply of
// the k winners by the segment's dequant scale.
//
// Replaces: src/repro/kernels/quantize.py, _quantized_query_kernel (the
// quantized_query_topk pallas_call, reached through
// ops.quantized_query_topk from core.index.query_index_quantized once per
// sealed int8/bf16 segment per query micro-batch).
//
// Bound on the H100: bytes.  Each valid candidate costs one code row read
// (64 B int8 / 128 B bf16 at N = 64) for 3N flops; the gather is random
// access, so rows arrive in 32-byte sectors.  The codes are the point of
// the tier: a quarter (int8) or half (bf16) of K2's gather bytes.
//
// Design: K2's structure (fused_query.cu), templated on the row type.  One
// block per query row loads its candidate ids and maps its query into code
// space once (int8: rint(q / scale), round half to even as torch.round and
// jnp.round; bf16: the fp32 query as is).  Each warp takes candidate slots
// in turn and widens every code to fp32 in registers -- no fp32 copy of the
// codes exists in device memory.  Slots with id < 0 or id >= valid score
// +inf.  The selection runs on the unscaled code-space distances (topk.cuh,
// the lower slot winning ties); only the k winners are multiplied by the
// scale, so scaling never merges two distinct distances before the choice.
// For int8 at N = 64 and p in {1, 2}, every partial sum is an integer below
// 2^24, so the result equals the plain version bit for bit in any order.
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float widen(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
quantized_query_kernel(const float* __restrict__ q, const T* __restrict__ codes,
                       const float* __restrict__ scale,
                       const int* __restrict__ ids, int n, int c, int k,
                       int valid, int pmode, float p,
                       float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sd = reinterpret_cast<float*>(smem);     // (c,) distances
  int* si = reinterpret_cast<int*>(sd + c);       // (c,) candidate ids
  float* sq = reinterpret_cast<float*>(si + c);   // (n,) the code-space query
  __shared__ float wbest[kWarps];
  __shared__ int wslot[kWarps];

  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int* rid = ids + static_cast<size_t>(row) * c;
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  const float s = *scale;

  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float v = q[static_cast<size_t>(row) * n + j];
    sq[j] = kInt8 ? rintf(__fdiv_rn(v, s)) : v;
  }
  __syncthreads();

  for (int slot = warp; slot < c; slot += kWarps) {
    const int id = rid[slot];
    float d = INFINITY;
    if (id >= 0 && id < valid) {
      const T* x = codes + static_cast<size_t>(id) * n;
      float acc = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const float diff = widen(x[j]) - sq[j];
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
      sd[slot] = d;
      si[slot] = id;
    }
  }
  __syncthreads();

  // int8 distances leave in the fp32 metric; bf16 codes are the values
  // themselves (quantize._code_query: post-scale 1).
  repro_torch::block_select_topk<kThreads>(sd, si, c, k, kInt8 ? s : 1.0f,
                                          wbest, wslot, out_d, out_i, row);
}

template <class T>
int launch(const float* q, const void* codes, const float* scale,
           const int* ids, int nq, int n, int c, int k, int valid, int pmode,
           float p, float* out_d, int* out_i, void* stream) {
  const size_t smem = static_cast<size_t>(c) * 8 + static_cast<size_t>(n) * 4;
  cudaError_t err =
      repro_torch::allow_dynamic_smem(quantized_query_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  quantized_query_kernel<T>
      <<<nq, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          q, static_cast<const T*>(codes), scale, ids, n, c, k, valid, pmode,
          p, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_DEFINE_ERROR_STRING(quantized_query)

// q: (nq, n) fp32; codes: (m, n) int8 (is_int8 = 1) or bf16 (is_int8 = 0);
// scale: one fp32 on the device; ids: (nq, c) int32; outputs (nq, k)
// distances (scaled) and ids.  pmode 2 / 1 select the p = 2 / p = 1 forms,
// 0 the general power p.
REPRO_EXPORT int quantized_query_launch(const float* q, const void* codes,
                                        int is_int8, const float* scale,
                                        const int* ids, int nq, int n, int c,
                                        int k, int valid, int pmode, float p,
                                        float* out_d, int* out_i,
                                        void* stream) {
  return is_int8
             ? launch<int8_t>(q, codes, scale, ids, nq, n, c, k, valid, pmode,
                              p, out_d, out_i, stream)
             : launch<__nv_bfloat16>(q, codes, scale, ids, nq, n, c, k, valid,
                                     pmode, p, out_d, out_i, stream);
}
