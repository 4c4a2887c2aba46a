// Block-wide top-k selection shared by K2 (fused_query.cu) and K5
// (quantized_query.cu): a block has scored its row's C candidate slots into
// shared memory and now writes the k smallest in ascending order.
//
// k rounds of block-wide argmin under the (distance, slot) order, the lower
// slot winning ties -- the order a stable ascending sort of the distances
// gives, which is lax.top_k's tie order.  A taken slot re-enters as +inf:
// once only +inf is left every further pick reports (+inf, -1) whichever
// slot wins.
#pragma once

#include <climits>

#include "common.cuh"

namespace repro_torch {

// (distance, slot) lexicographic min: the lower slot wins ties.
__device__ __forceinline__ bool topk_better(float d, int s, float bd, int bs) {
  return d < bd || (d == bd && s < bs);
}

// sd/si: (c,) distances and ids in shared memory (sd is consumed);
// wbest/wslot: kThreads / 32 entries of shared scratch.  Row `row` of
// out_d/out_i (k columns) gets the picks, each distance multiplied by
// `post` after the selection (1 for K2, the int8 scale for K5).
template <int kThreads>
__device__ void block_select_topk(float* sd, const int* si, int c, int k,
                                  float post, float* wbest, int* wslot,
                                  float* __restrict__ out_d,
                                  int* __restrict__ out_i, int row) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int t = 0; t < k; ++t) {
    float best = INFINITY;
    int slot = INT_MAX;
    for (int s = threadIdx.x; s < c; s += kThreads) {
      const float v = sd[s];
      if (topk_better(v, s, best, slot)) {
        best = v;
        slot = s;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int os = __shfl_xor_sync(0xffffffffu, slot, off);
      if (topk_better(ob, os, best, slot)) {
        best = ob;
        slot = os;
      }
    }
    if (lane == 0) {
      wbest[warp] = best;
      wslot[warp] = slot;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      best = wbest[0];
      slot = wslot[0];
      for (int w = 1; w < kWarps; ++w) {
        if (topk_better(wbest[w], wslot[w], best, slot)) {
          best = wbest[w];
          slot = wslot[w];
        }
      }
      const size_t at = static_cast<size_t>(row) * k + t;
      out_d[at] = best * post;
      out_i[at] = isinf(best) ? -1 : si[slot];
      sd[slot] = INFINITY;
    }
    __syncthreads();
  }
}

}  // namespace repro_torch
