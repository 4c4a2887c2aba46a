// K7 simhash_pack: sign-random-projection signature, bit-packed,
//   sig[i, w] bit j = (X @ A)[i, 32 w + j] >= 0,  as int32 words.
//
// Replaces: src/repro/kernels/simhash_pack.py, _simhash_kernel (reached
// through ops.simhash_signature, which SimHash.__call__ calls; no serving
// path calls it in either package).
//
// Bound on the H100: operations.  At the benchmark's shape, X (512, 64) @
// A (64, 1024), the product is 67 MFLOP (1.0 us at 67 TFLOP/s fp32)
// against ~0.4 MB moved (0.12 us at 3.35 TB/s).  So the fp32 pipes have
// to be fed: a plain SIMT tile of one column a thread spends 5 shared
// loads on 4 FFMAs and is bound by the loads, not the pipes.
//
// Design (the variants that measured slower live in tools/bench_simhash.py
// as text patches of this file):
// - Register tiles that keep the ballot.  A block is 4 warps and owns 32
//   rows x 32 * kWords columns (32 x 128 at the benchmark's shape: 16 x 8
//   = 128 blocks, one wave on 132 SMs).  A thread holds 8 rows x kWords
//   columns of its warp's 32 * kWords, side by side, so that one 16-byte
//   shared load a depth step brings its 4 values of A; with the 8 rows'
//   16-byte broadcasts of X (row-major in shared memory) that is 12 shared
//   loads per 128 FFMAs.  A ballot per (row, column of a lane) then holds
//   bit q of 4 neighbouring columns of every lane, and a word is the
//   kWords ballots' bits interleaved (interleave below).
// - One round of copies.  The block asks for its whole depth of 64 (X
//   8 KB + A 32 KB) as 16-byte cp.async requests, waits once and meets at
//   one barrier.  A deeper N is a chain of 64-deep tiles in two stages,
//   the next tile's copies in flight while this one is summed.
// - A 4-byte scalar instantiation when X or A is not 16-byte aligned or N
//   is not a multiple of 4, and one with the depth (64) known at compile
//   time.
// - Programmatic dependent launch: griddepcontrol.wait before the first
//   copy, and the next kernel's launch overlaps this one's tail.
//
// Arithmetic: each output is one fmaf chain from 0.0f over t = 0 .. N-1 in
// order, fmaf(x[i, t], a[t, j], acc) -- IEEE fp32, no TF32, no tensor
// cores, no split of the depth -- so a row's signature does not depend on
// how many rows share the launch, and the words are those of the SIMT
// kernel this one replaced, bit for bit.  The epilogue is the reference's
// `acc >= 0` (true for -0.0, false for NaN).  K must be a multiple of 32
// (the wrapper checks), so every lane reaches each ballot and no word is
// partly past the last column.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;                     // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;               // rows a thread holds
constexpr int kRows = kWarps * kRowsPerWarp;  // rows a block owns
constexpr int kDepth = 64;                    // depth a tile holds

// Columns a block owns when a thread holds `words` of them.
__host__ __device__ constexpr int block_cols(int words) { return 32 * words; }

// Floats of one stage: the block's rows of X (kRows x kDepth), then its
// columns of A (kDepth x block_cols).
__host__ __device__ constexpr int stage_floats(int words) {
  return kRows * kDepth + kDepth * block_cols(words);
}

// Dynamic shared bytes: one stage when the depth is one tile, else two.
__host__ __device__ constexpr int smem_bytes(int words, int depth) {
  return 4 * (depth > kDepth ? 2 : 1) * stage_floats(words);
}

// Ask for depth [0, depth) of the tile that starts at depth t0: the
// block's X rows into xs (kRows x kDepth) and A columns into as (kDepth x
// block_cols), as one commit group.  On the vector path t0, depth and N
// are multiples of 4 and K of 32, so a request never straddles an edge.
template <int kWords, bool kVec>
__device__ __forceinline__ void copy_tile(float* xs, float* as,
                                          const float* x, const float* a,
                                          int m, int k, int n, int row0,
                                          int col0, int t0, int depth) {
  constexpr int kW = kVec ? 4 : 1;
  constexpr int kCols = block_cols(kWords);
  constexpr int x_per = kDepth / kW;         // requests a row
  constexpr int a_per = kCols / kW;          // requests a depth step
  for (int q = threadIdx.x; q < kRows * x_per; q += kThreads) {
    const int i = q / x_per;
    const int t = (q % x_per) * kW;
    if (row0 + i < m && t < depth) {
      repro_torch::copy<kVec>(
          xs + i * kDepth + t,
          x + static_cast<size_t>(row0 + i) * k + t0 + t);
    }
  }
  for (int q = threadIdx.x; q < kDepth * a_per; q += kThreads) {
    const int t = q / a_per;
    const int c = (q % a_per) * kW;
    if (t < depth && col0 + c < n) {
      repro_torch::copy<kVec>(
          as + t * kCols + c,
          a + static_cast<size_t>(t0 + t) * n + col0 + c);
    }
  }
  repro_torch::commit();
}

// The kWords neighbouring values of A at one depth that a lane multiplies:
// one 4-, 8- or 16-byte load.
template <int kWords>
__device__ __forceinline__ void load_cols(const float* p,
                                          float (&av)[kWords]) {
  if constexpr (kWords == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    av[0] = v.x;
    av[1] = v.y;
    av[2] = v.z;
    av[3] = v.w;
  } else if constexpr (kWords == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    av[0] = v.x;
    av[1] = v.y;
  } else {
    av[0] = p[0];
  }
}

// acc[i][j] += x[i, t] * a[t, j] over depth [0, depth) of the stage, t in
// order.  xs: this warp's first row; as: this lane's first column.
template <int kWords>
__device__ __forceinline__ void sum_tile(const float* xs, const float* as,
                                         int depth,
                                         float (&acc)[kRowsPerWarp][kWords]) {
  constexpr int kCols = block_cols(kWords);
  if (depth == kDepth) {
#pragma unroll 2
    for (int t = 0; t < kDepth; t += 4) {
      float4 xv[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        xv[i] = *reinterpret_cast<const float4*>(xs + i * kDepth + t);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float av[kWords];
        load_cols<kWords>(as + (t + s) * kCols, av);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float xi = s == 0 ? xv[i].x
                           : s == 1 ? xv[i].y
                           : s == 2 ? xv[i].z
                                    : xv[i].w;
#pragma unroll
          for (int j = 0; j < kWords; ++j) {
            acc[i][j] = fmaf(xi, av[j], acc[i][j]);
          }
        }
      }
    }
  } else {
    // Only the real depth is summed: padding never enters the chain.
    for (int t = 0; t < depth; ++t) {
      float av[kWords];
      load_cols<kWords>(as + t * kCols, av);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float xi = xs[i * kDepth + t];
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          acc[i][j] = fmaf(xi, av[j], acc[i][j]);
        }
      }
    }
  }
}

// Bit r of x at bit kWords * r (r < 32 / kWords).
template <int kWords>
__device__ __forceinline__ unsigned spread(unsigned x) {
  if constexpr (kWords == 2) {
    x = (x | (x << 8)) & 0x00FF00FFu;
    x = (x | (x << 4)) & 0x0F0F0F0Fu;
    x = (x | (x << 2)) & 0x33333333u;
    x = (x | (x << 1)) & 0x55555555u;
  } else if constexpr (kWords == 4) {
    x = (x | (x << 12)) & 0x000F000Fu;
    x = (x | (x << 6)) & 0x03030303u;
    x = (x | (x << 3)) & 0x11111111u;
  }
  return x;
}

// Word w of a row from its kWords ballots: ballot q's bit l is column
// kWords * l + q, so word w (columns 32 w .. 32 w + 31) is lanes w * 32 /
// kWords onwards of every ballot, interleaved.
template <int kWords>
__device__ __forceinline__ unsigned interleave(const unsigned (&b)[kWords],
                                               int w) {
  constexpr int kLanes = 32 / kWords;     // lanes a word spans
  if constexpr (kWords == 1) {
    return b[0];
  } else {
    unsigned word = 0;
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const unsigned part = (b[q] >> (w * kLanes)) & ((1u << kLanes) - 1u);
      word |= spread<kWords>(part) << q;
    }
    return word;
  }
}

// kK: the depth when known at compile time (the path's 64), else 0.
// x: (m, k); a: (k, n) with n % 32 == 0; sig: (m, n / 32).  Block b owns
// rows [(b / col_tiles) * kRows, +kRows) and columns [(b % col_tiles) *
// block_cols, +block_cols); warp w the kRowsPerWarp rows from w *
// kRowsPerWarp of those.
template <int kWords, bool kVec, int kK>
__global__ void __launch_bounds__(kThreads)
simhash_kernel(const float* __restrict__ x, const float* __restrict__ a,
               int m, int k_arg, int n, int col_tiles,
               int* __restrict__ sig) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = stage_floats(kWords);
  const int k = kK ? kK : k_arg;
  const int tiles = (k + kDepth - 1) / kDepth;
  const int lane = threadIdx.x % 32;
  const int wm = threadIdx.x / 32;
  const int col0 = (blockIdx.x % col_tiles) * block_cols(kWords);
  const int row0 = (blockIdx.x / col_tiles) * kRows;

  // Programmatic dependent launch: wait for the kernels before this one
  // (their writes to x and a visible), then let the next one launch.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::);

  // Tile c of the depth lives in stage c % 2.  Tile c + 1 is asked for
  // once tile c has landed, and lands while c is summed; it overwrites
  // tile c - 1, which every thread finished before the barrier that
  // precedes the request.
  const auto ask = [&](int tile) {
    float* st = smem + (tile & 1) * kStage;
    copy_tile<kWords, kVec>(st, st + kRows * kDepth, x, a, m, k, n, row0,
                            col0, tile * kDepth,
                            min(k - tile * kDepth, kDepth));
  };
  ask(0);

  float acc[kRowsPerWarp][kWords];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
    for (int j = 0; j < kWords; ++j) acc[i][j] = 0.0f;
  }
  for (int tile = 0; tile < tiles; ++tile) {
    repro_torch::wait<0>();
    __syncthreads();
    if (tile + 1 < tiles) ask(tile + 1);
    // the requests go out before the sums (no shared load moves above)
    asm volatile("" ::: "memory");
    const float* st = smem + (tile & 1) * kStage;
    sum_tile<kWords>(st + wm * kRowsPerWarp * kDepth,
                     st + kRows * kDepth + kWords * lane,
                     min(k - tile * kDepth, kDepth), acc);
  }

  // Row i's kWords ballots hold its 32 * kWords columns.  Lane l stores
  // word e % kWords of the warp's row e / kWords (e = base + l), so a
  // warp's words go out 32 to an instruction, each row's kWords words
  // contiguous.
  constexpr int kWordsPerWarp = kRowsPerWarp * kWords;
#pragma unroll
  for (int base = 0; base < kWordsPerWarp; base += 32) {
    unsigned mine[kWords] = {};   // the ballots of my word's row
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const int e = i * kWords + j;
        if (e >= base && e < base + 32) {
          const unsigned w = __ballot_sync(0xffffffffu, acc[i][j] >= 0.0f);
          if (lane / kWords == i - base / kWords) mine[j] = w;
        }
      }
    }
    const int word = static_cast<int>(interleave(mine, lane % kWords));
    const int e = base + lane;
    if (e < kWordsPerWarp) {
      const int row = row0 + wm * kRowsPerWarp + e / kWords;
      const int col = col0 + 32 * (e % kWords);
      if (row < m && col < n) {
        sig[static_cast<size_t>(row) * (n / 32) + col / 32] = word;
      }
    }
  }
}

template <int kWords, bool kVec, int kK>
cudaError_t launch_as(const float* x, const float* a, int m, int k, int n,
                      int* sig, cudaStream_t stream) {
  cudaError_t err = repro_torch::allow_dynamic_smem_once<
      simhash_kernel<kWords, kVec, kK>>(smem_bytes(kWords, 2 * kDepth));
  if (err != cudaSuccess) return err;
  const long long col_tiles =
      (n + block_cols(kWords) - 1) / block_cols(kWords);
  const long long blocks = col_tiles * ((m + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(kWords, k);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, simhash_kernel<kWords, kVec, kK>, x, a, m,
                           k, n, static_cast<int>(col_tiles), sig);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kWords>
cudaError_t launch_words(const float* x, const float* a, int m, int k, int n,
                         bool vec, int* sig, cudaStream_t stream) {
  if (k == kDepth) {
    return vec ? launch_as<kWords, true, kDepth>(x, a, m, k, n, sig, stream)
               : launch_as<kWords, false, kDepth>(x, a, m, k, n, sig,
                                                  stream);
  }
  return vec ? launch_as<kWords, true, 0>(x, a, m, k, n, sig, stream)
             : launch_as<kWords, false, 0>(x, a, m, k, n, sig, stream);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING(simhash_pack)

// x: (m, k) fp32; alpha: (k, n) fp32 with n % 32 == 0; sig: (m, n / 32).
// words (a block owns 32 rows x 32 * words columns: 1, 2 or 4) and vec
// (the 16-byte path: x and alpha 16-byte aligned, k % 4 == 0) come from
// the wrapper's plan (kernels/simhash_pack.plan).
REPRO_EXPORT int simhash_pack_launch(const float* x, const float* alpha,
                                     int m, int k, int n, int words, int vec,
                                     int* sig, void* stream) {
  if (n % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (words) {
    case 1: err = launch_words<1>(x, alpha, m, k, n, vec != 0, sig, st); break;
    case 2: err = launch_words<2>(x, alpha, m, k, n, vec != 0, sig, st); break;
    case 4: err = launch_words<4>(x, alpha, m, k, n, vec != 0, sig, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
