// K5 quantized_query: candidate gather from int8 or bf16 codes + masked
// L^p distance in code space + top-k per query row, then one multiply of
// the k winners by the segment's dequant scale.
//
// Replaces: src/repro/kernels/quantize.py, _quantized_query_kernel (the
// quantized_query_topk pallas_call at line 228, reached through
// ops.quantized_query_topk from core.distributed.query_segments_stacked
// once per query micro-batch, over the rows of every sealed int8/bf16
// segment, each block reading its own segment's scale).
//
// Bound on the H100: bytes.  Per call, the queries (nq x N x 4), the ids
// (nq x C x 4), each distinct valid code row once (64 B int8 / 128 B bf16
// at N = 64) and the (nq, k) outputs: 0.63 MB at 128 rows x C = 1024,
// 0.19 us at 3.35 TB/s -- ids dominate; the codes are a quarter (int8) or
// half (bf16) of K2's row bytes.  What holds the kernel is latency: the id
// load, the dependent code-row load, the selection, the cluster barrier
// and the merge.
//
// Design: K2's kernel (topk.cuh), templated on the row type.  Each block
// maps the query into code space once (int8: rint(q / scale), true
// division, round half to even as torch.round and jnp.round; bf16: the
// fp32 query as is), reads each valid code row with one 16-byte load per
// lane (int8: 4 lanes, bf16: 8 lanes at N = 64) and widens the codes in
// registers -- no fp32 copy of the codes exists in device memory.  The
// selection runs on the unscaled code-space distances ((distance bits << 32
// | slot) keys placed by counting, lower slot first on ties, the cluster's
// rank 0 merging the G sorted lists); only the k winners are multiplied by
// the scale, so scaling never merges two distinct distances before the
// choice.
// For int8 at N = 64 and p in {1, 2}, every partial sum is an integer below
// 2^24, so the result equals the plain version bit for bit in any order of
// summation.
#include "topk.cuh"

REPRO_DEFINE_ERROR_STRING(quantized_query)

// q: (nq, n) fp32; codes: (m, n) int8 (is_int8 = 1) or bf16 (is_int8 = 0);
// scale: fp32 on the device, row r reading scale[r / rows_per_scale] (one
// scale with rows_per_scale = nq; one per segment of a stacked launch with
// rows_per_scale = the batch's query rows); ids: (nq, c) int32; outputs
// (nq, k) distances (scaled) and ids.  pmode 2 / 1 select the p = 2 / p = 1
// forms, 0 the general power p.  cluster (G), slots (S), lanes_log2 and vec
// come from the wrapper's plan.
REPRO_EXPORT int quantized_query_launch(const float* q, const void* codes,
                                        int is_int8, const float* scale,
                                        int rows_per_scale, const int* ids,
                                        int nq, int n, int c, int k,
                                        int valid, int pmode, float p,
                                        int cluster, int slots,
                                        int lanes_log2, int vec, float* out_d,
                                        int* out_i, void* stream) {
  namespace topk = repro_torch::topk;
  const topk::Args a{q,     codes, scale, rows_per_scale, ids,   n,
                     c,     k,     valid, pmode,          p,     cluster,
                     slots, lanes_log2, out_d, out_i};
  if (is_int8) {
    return vec ? topk::launch<int8_t, true>(a, nq, stream)
               : topk::launch<int8_t, false>(a, nq, stream);
  }
  return vec ? topk::launch<__nv_bfloat16, true>(a, nq, stream)
             : topk::launch<__nv_bfloat16, false>(a, nq, stream);
}
