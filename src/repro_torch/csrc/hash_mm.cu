// K1 hash_mm: p-stable hash with its pre-floor projections,
//   proj = (X @ A) / r + b,   h = floor(proj) as int32.
//
// Replaces: src/repro/kernels/hash_mm.py, _hash_mm_kernel (the
// return_proj=True form that ops.pstable_hash_proj runs for build, insert
// and query).
//
// Bound on the H100: bytes.  On the main path X is (8..256, 64), A is
// (64, 32): at most 2 * 256 * 64 * 32 = 1 MFLOP against ~100 KB moved, far
// below the fp32 ridge; at these sizes the launch itself dominates.
//
// Design: the shared tiled SIMT GEMM (gemm.cuh) with the scale, offset and
// floor fused into the epilogue, so the projections leave the SM once,
// already final.  The epilogue keeps true IEEE division by r (not a
// multiply by 1/r), matching the reference's arithmetic; no TF32 anywhere.
// Build and query hash through this one kernel, and each row's result is
// independent of the batch it came in, so bucket ids agree inside the port.
#include "gemm.cuh"

namespace {

struct HashEpilogue {
  const float* b;
  float r;
  int n;
  int* h;
  float* proj;

  __device__ void operator()(int row, int col, float acc) const {
    const float p = __fadd_rn(__fdiv_rn(acc, r), b[col]);
    const size_t at = static_cast<size_t>(row) * n + col;
    proj[at] = p;
    h[at] = static_cast<int>(floorf(p));
  }
};

}  // namespace

REPRO_DEFINE_ERROR_STRING(hash_mm)

// x: (m, k); alpha: (k, n); b: (n,); outputs h (m, n) int32, proj (m, n).
REPRO_EXPORT int hash_mm_launch(const float* x, const float* alpha,
                                const float* b, float r, int m, int k, int n,
                                int* h, float* proj, void* stream) {
  HashEpilogue epi{b, r, n, h, proj};
  return static_cast<int>(repro_torch::launch_gemm(
      x, alpha, m, n, k, epi, static_cast<cudaStream_t>(stream)));
}
