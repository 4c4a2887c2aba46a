// K4 dct_mm: Chebyshev coefficients by DCT-II matmul with the orthonormal
// scale fused in,   out = (F @ Mt) * scale.
//
// Replaces: src/repro/kernels/dct_mm.py, _dct_kernel (reached through
// ops.cheb_embed from the basis embedder on ingest and on query).
//
// Bound on the H100: bytes.  On the main path F is (128, 64) and Mt is
// (64, 64): 1 MFLOP against ~80 KB, below the fp32 ridge, and at this size
// the launch dominates.
//
// Design: the same tiled SIMT GEMM as K1 (gemm.cuh) with a multiply-by-
// scale epilogue, so the unscaled product never reaches device memory.
// fp32 FMA only; rows are independent of the batch they arrive in.
#include "gemm.cuh"

namespace {

struct ScaleEpilogue {
  const float* scale;
  int n;
  float* out;

  __device__ void operator()(int row, int col, float acc) const {
    out[static_cast<size_t>(row) * n + col] = __fmul_rn(acc, scale[col]);
  }
};

}  // namespace

REPRO_DEFINE_ERROR_STRING(dct_mm)

// f: (m, k); mt: (k, n); scale: (n,); out: (m, n).
REPRO_EXPORT int dct_mm_launch(const float* f, const float* mt,
                               const float* scale, int m, int k, int n,
                               float* out, void* stream) {
  ScaleEpilogue epi{scale, n, out};
  return static_cast<int>(repro_torch::launch_gemm(
      f, mt, m, n, k, epi, static_cast<cudaStream_t>(stream)));
}
