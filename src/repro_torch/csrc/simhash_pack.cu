// K7 simhash_pack: sign-random-projection signature, bit-packed,
//   sig[i, w] bit j = (X @ A)[i, 32 w + j] >= 0,  as int32 words.
//
// Replaces: src/repro/kernels/simhash_pack.py, _simhash_kernel (reached
// through ops.simhash_signature; no serving path calls it in either
// package).
//
// Bound on the H100: at the benchmark's shape, X (512, 64) @ A (64, 1024),
// 67 MFLOP against ~0.5 MB moved -- operations by the fp32 roofline, though
// at this size the launch dominates.
//
// Design: the shared SIMT GEMM (gemm.cuh) in IEEE fp32 (no TF32, one fmaf
// chain per output) with a packing epilogue.  A block's 32-column tile is
// exactly one output word and the 32 lanes of a warp hold its 32 columns
// for one row, so one __ballot_sync of `acc >= 0` (true for -0.0, false for
// NaN, as the reference's `>=`) is the word: lane j's vote is bit j.  K must
// be a multiple of 32 (the wrapper checks), so no warp is ever partly past
// the last column and every lane reaches the ballot.
#include "gemm.cuh"

namespace {

struct PackEpilogue {
  int words;     // K / 32 words per row
  int* sig;

  __device__ void operator()(int row, int col, float acc) const {
    const unsigned word = __ballot_sync(0xffffffffu, acc >= 0.0f);
    if ((col & 31) == 0) {
      sig[static_cast<size_t>(row) * words + (col >> 5)] =
          static_cast<int>(word);
    }
  }
};

}  // namespace

REPRO_DEFINE_ERROR_STRING(simhash_pack)

// x: (m, k) fp32; alpha: (k, n) fp32 with n % 32 == 0; sig: (m, n / 32).
REPRO_EXPORT int simhash_pack_launch(const float* x, const float* alpha,
                                     int m, int k, int n, int* sig,
                                     void* stream) {
  PackEpilogue epi{n / 32, sig};
  return static_cast<int>(repro_torch::launch_gemm(
      x, alpha, m, n, k, epi, static_cast<cudaStream_t>(stream)));
}
