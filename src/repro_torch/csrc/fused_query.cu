// K2 fused_query: candidate gather + masked L^p distance + top-k per query
// row, without materialising the (nq, C, N) candidate tensor.
//
// Replaces: src/repro/kernels/fused_query.py, _fused_query_kernel (the
// pallas_call at line 131, reached through ops.fused_query_topk from
// core.distributed.query_segments_stacked, once over every sealed segment
// of a query micro-batch and once over the delta).
//
// Bound on the H100: bytes.  Per call, the queries (nq x N x 4), the ids
// (nq x C x 4), each distinct valid row once (N x 4 = 256 B at N = 64) and
// the (nq, k) outputs: 0.25 MB at 32 rows x C = 1024 against a 1,024-row
// segment, 0.075 us at 3.35 TB/s.  What holds the kernel is latency, not
// bandwidth: the id load and the dependent row load, then the selection,
// the cluster barrier and the merge, on a grid of ~128-256 blocks.
//
// Design (topk.cuh, shared with K5): a row is split across a cluster of G
// blocks that deal its slots round-robin, so that 32 rows keep 128 SMs
// busy where one block a row kept 32; each block compacts its slots' valid
// ids with a warp ballot and reads every valid row with L = N / 4 lanes of
// one float4 load each (16 at N = 64), four rows in flight per sub-warp;
// it places its (distance bits << 32 | slot) keys by counting smaller
// keys, writes its sorted k into rank 0's shared memory, and rank 0 merges
// the G lists by binary search.  Ties go to the lower slot, exactly, as in
// the stable sort of the plain version.  N % 4 != 0 (or an unaligned
// table) takes the scalar instantiation.
#include "topk.cuh"

REPRO_DEFINE_ERROR_STRING(fused_query)

// q: (nq, n); db: (m, n); ids: (nq, c) int32; outputs (nq, k) distances and
// ids.  pmode 2 / 1 select the p = 2 / p = 1 forms, 0 the general power p.
// cluster (G), slots (S), lanes_log2 and vec come from the wrapper's plan.
REPRO_EXPORT int fused_query_launch(const float* q, const float* db,
                                    const int* ids, int nq, int n, int c,
                                    int k, int valid, int pmode, float p,
                                    int cluster, int slots, int lanes_log2,
                                    int vec, float* out_d, int* out_i,
                                    void* stream) {
  namespace topk = repro_torch::topk;
  const topk::Args a{q,     db,    nullptr, 1,       ids,   n,
                     c,     k,     valid,   pmode,   p,     cluster,
                     slots, lanes_log2, out_d, out_i};
  return vec ? topk::launch<float, true>(a, nq, stream)
             : topk::launch<float, false>(a, nq, stream);
}
