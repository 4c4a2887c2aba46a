// K1 hash_mm: p-stable hash with its pre-floor projections,
//   proj = (X @ A) / r + b,   h = floor(proj) as int32.
//
// Replaces: src/repro/kernels/hash_mm.py, _hash_mm_kernel (the
// return_proj=True form that ops.pstable_hash_proj runs for build, insert
// and query).
//
// Bound on the H100: launch latency, not bytes or operations.  On the main
// path X is (32 | 128 | 256, 64) and A is (64, 32): 131 kFLOP to 1 MFLOP
// over 17-74 KB, 5-22 ns at the card's memory rate, against a launch of
// about 2 us.  The kernel is launched once per sealed segment per query
// micro-batch and once per insert chunk, thousands of times a run, so what
// it costs is the launch plus the chain of dependent steps inside it.
//
// Design (small_gemm.cuh, shared with K4): one round trip -- a block asks
// for its X rows, its 32-column tile of A and of b at once, 16-byte
// cp.async requests where aligned, issued by all 8 of its warps, and meets
// at one barrier; one output per thread, the wrapper's plan choosing 1-8
// rows a block so that 32 to 256 rows spread over 32-64 SMs; the K = 64
// depth loop unrolled over float4 broadcasts of the row; launched with
// programmatic dependent launch, so that the next launch overlaps this
// one's tail.  b arrives with the operands, so the epilogue reads it from
// shared memory.  Arithmetic unchanged: one
// fmaf chain per output from 0.0f over t = 0 .. K-1 in order, then true
// IEEE division by r (not a multiply by 1/r) and the add of b, as the
// reference; no TF32.  Build and query hash through this one kernel and a
// row's result does not depend on its batch, so bucket ids agree.
#include "small_gemm.cuh"

namespace {

struct HashEpilogue {
  float r;
  int n;
  int* h;
  float* proj;

  __device__ void operator()(int row, int col, float acc, float b) const {
    const float p = __fadd_rn(__fdiv_rn(acc, r), b);
    const size_t at = static_cast<size_t>(row) * n + col;
    proj[at] = p;
    h[at] = static_cast<int>(floorf(p));
  }
};

}  // namespace

REPRO_DEFINE_ERROR_STRING(hash_mm)

// x: (m, k); alpha: (k, n); b: (n,); outputs h (m, n) int32, proj (m, n).
// rows (output rows per block) and vec (the 16-byte path) come from the
// wrapper's plan (kernels/small_gemm.plan).
REPRO_EXPORT int hash_mm_launch(const float* x, const float* alpha,
                                const float* b, float r, int m, int k, int n,
                                int rows, int vec, int* h, float* proj,
                                void* stream) {
  HashEpilogue epi{r, n, h, proj};
  return static_cast<int>(repro_torch::small_gemm::launch(
      x, alpha, b, m, n, k, rows, vec != 0, epi,
      static_cast<cudaStream_t>(stream)));
}
