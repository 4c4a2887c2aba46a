// K4 dct_mm: Chebyshev coefficients by DCT-II matmul with the orthonormal
// scale fused in,   out = (F @ Mt) * scale.
//
// Replaces: src/repro/kernels/dct_mm.py, _dct_kernel (reached through
// ops.cheb_embed from the basis embedder on ingest and on query).
//
// Bound on the H100: launch latency, not bytes or operations.  On the main
// path F is (128, 64) and Mt is (64, 64): 1 MFLOP over 82 KB, 24 ns at the
// card's memory rate, against a launch of about 2 us, once per 128-row
// embed chunk.
//
// Design: the same small GEMM as K1 (small_gemm.cuh): one round trip for
// the block's rows of F, its 32-column tile of Mt and of scale, issued by
// all 8 warps of the block, one barrier, one output per thread, and at 128
// rows x 64 columns a grid of 64 blocks of 4 rows by 32 columns (the
// wrapper's plan) instead of 8 tiles of 32 x 32; programmatic dependent
// launch, as K1.  The unscaled product never reaches device memory.
// fp32 FMA only, one chain per output in depth order; rows are independent
// of the batch they arrive in.
#include "small_gemm.cuh"

namespace {

struct ScaleEpilogue {
  int n;
  float* out;

  __device__ void operator()(int row, int col, float acc, float scale) const {
    out[static_cast<size_t>(row) * n + col] = __fmul_rn(acc, scale);
  }
};

}  // namespace

REPRO_DEFINE_ERROR_STRING(dct_mm)

// f: (m, k); mt: (k, n); scale: (n,); out: (m, n).  rows and vec come
// from the wrapper's plan (kernels/small_gemm.plan).
REPRO_EXPORT int dct_mm_launch(const float* f, const float* mt,
                               const float* scale, int m, int k, int n,
                               int rows, int vec, float* out, void* stream) {
  ScaleEpilogue epi{n, out};
  return static_cast<int>(repro_torch::small_gemm::launch(
      f, mt, scale, m, n, k, rows, vec != 0, epi,
      static_cast<cudaStream_t>(stream)));
}
