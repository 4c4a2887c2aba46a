// Gather + masked L^p + top-k for one query row split across a thread-block
// cluster, shared by K2 (fused_query.cu, fp32 rows) and K5
// (quantized_query.cu, int8/bf16 codes), so both tiers order ties alike.
// Through them it replaces the TPU kernels _fused_query_kernel
// (src/repro/kernels/fused_query.py) and _quantized_query_kernel
// (src/repro/kernels/quantize.py).
//
// What bounds it.  Per row the work is C candidate ids (4 B each), the
// valid candidates' rows (N x itemsize each, gathered at random) and k
// outputs: 0.25-0.68 MB per call at the path's shapes, 0.05-0.2 us of HBM
// time.  The real floor is latency: an id load, then the load of the row it
// names, then a selection, a cluster barrier and a merge.  The design
// spends its effort on keeping many of those chains in flight and on
// selecting without barrier-bound passes.
//
// 1. Cluster split.  The grid is nq x G blocks in clusters of G <= 8
//    (cudaLaunchKernelEx with the cluster-dimension attribute); rank r of a
//    row's cluster owns slots r, r + G, r + 2G, ...  A gathered row fills
//    each bucket's first slots, so dealing slots round-robin spreads the
//    valid ones evenly, where contiguous ranges left rank 0 the most.  The
//    wrapper picks G (`_plan` in kernels/fused_query.py): 4 at 32 rows, 2
//    at 128, the grid within one wave of two blocks per SM.
// 2. Compaction, then a sub-warp per candidate.  A block reads its slots'
//    ids once, two chunks of 256 in flight, and compacts the valid ones
//    (0 <= id < valid; ~75% of slots are not) with __ballot_sync/__popc
//    into a shared list of (id << 32 | slot).  Each valid row is then read
//    by L lanes with one 16-byte load each (L = row bytes / 16: fp32 16,
//    bf16 8, int8 4 at N = 64), four candidates per sub-warp and candidates
//    dealt over all warps, and a log2(L)-step shuffle sum finishes each
//    distance.  The metric (p = 2, p = 1, general p) is a template argument
//    of that loop: as a runtime branch, the compiler evaluated powf for
//    every element.  Rows whose bytes are not a multiple of 16, or a table
//    not 16-byte aligned, take the scalar instantiation of the same kernel
//    (kVec = false): L lanes stride the row one element at a time.
// 3. Selection by counting.  A candidate's key is (bits of its distance) <<
//    32 | global slot.  Distances are >= +0, so the float bits order like
//    the floats and +inf (0x7f800000) sorts after every finite distance;
//    every key is distinct, so key order is exactly (distance, lower slot
//    first), the order of a stable ascending sort.  A block's keys (<= 256
//    valid ones at the path's shapes) are placed by counting: a key's place
//    is the number of smaller keys, one thread per key and one pass with no
//    barrier, which selects and sorts at once.  Past 256 keys (large C on
//    few blocks), an MSB-first radix select (8-bit digit histograms in
//    shared memory, starting below the digits the smallest and largest key
//    share) first keeps the k smallest.  Each rank writes its sorted
//    min(k, count) keys and their ids straight into rank 0's shared memory
//    (distributed shared memory, after a split cluster barrier whose
//    arrive was issued at the start), then one cluster.sync().
// 4. Rank 0 merges the G sorted lists: an entry's place is its index plus
//    a binary search in each other list; each entry writes its own output
//    slot, and a place past the valid candidates reports (+inf, -1), as
//    does a pick of +inf.
//
// Why counting, not radix select or a bitonic network, on the path: traced
// on the H100 (tools/trace_topk.py, PERF.md), every radix pass cost two
// block barriers and a warp scan, and 3-4 passes in each rank plus a radix
// merge in rank 0 took more time than the gather; with <= 256 keys a
// block, one counting pass is cheaper and needs no barrier.  A bitonic
// network in one warp holds 128 keys, fewer than a rank scores at 128
// rows.  G = 8 measured slower than G = 4 at 32 rows: rank 0's merge grows
// with G x k.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace topk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;     // the largest k the wrappers accept
constexpr int kRounds = 2;     // id chunks of kThreads loaded per round

constexpr int kMaxCluster = 8;
constexpr int kRankMax = kThreads;  // keys placed by counting, one per
                                    // thread; more go through radix first

// Shared scratch (static shared memory).
struct Scratch {
  unsigned hist[2][256];       // radix select: one digit's counts; the
                               // next pass's, zeroed meanwhile
  unsigned long long lo[kWarps], hi[kWarps];
  unsigned long long prefix, mask;
  int need, done, nout;
  int warp_count[kRounds][kWarps];
  int counts[kMaxCluster];     // rank 0: the length of each rank's list
};

// Block-wide radix select: copy into out[] the kk smallest of the count
// distinct keys in keys[] (any order), 0 < kk < count.  Every thread of
// the block calls it.
__device__ inline void select_smallest(const unsigned long long* keys,
                                       int count, int kk,
                                       unsigned long long* out, Scratch& s) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // The digits above the first bit where the smallest and the largest key
  // differ are common to every key: start below them.
  unsigned long long lo = ~0ull, hi = 0;
  for (int i = tid; i < count; i += kThreads) {
    lo = min(lo, keys[i]);
    hi = max(hi, keys[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) {
    s.lo[warp] = lo;
    s.hi[warp] = hi;
  }
  for (int i = tid; i < 256; i += kThreads) s.hist[0][i] = 0;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo = min(lo, s.lo[w]);
    hi = max(hi, s.hi[w]);
  }
  // lo != hi: count > 1 distinct keys
  int shift = (63 - __clzll(lo ^ hi)) / 8 * 8;
  unsigned long long mask = shift == 56 ? 0ull : ~0ull << (shift + 8);
  unsigned long long prefix = lo & mask;
  int need = kk;
  // MSB-first 8-bit digits; two barriers a pass: the counts, then the
  // bucket that holds the kk-th key (found by warp 0 while the others
  // zero the next pass's counts).
  for (int b = 0; shift >= 0; shift -= 8, b ^= 1) {
    for (int i = tid; i < count; i += kThreads) {
      const unsigned long long key = keys[i];
      if ((key & mask) == prefix) {
        atomicAdd(&s.hist[b][(key >> shift) & 255u], 1u);
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 8l .. 8l+7; an exclusive warp scan of the lane
      // sums gives each lane the count of keys in lower bins
      unsigned c[8], sum = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        c[e] = s.hist[b][lane * 8 + e];
        sum += c[e];
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      unsigned below = incl - sum;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (below < static_cast<unsigned>(need) &&
            static_cast<unsigned>(need) <= below + c[e]) {
          const unsigned long long d = lane * 8 + e;
          s.prefix = prefix | (d << shift);
          s.mask = mask | (255ull << shift);
          s.need = need - static_cast<int>(below);
          s.done = c[e] == static_cast<unsigned>(need) - below;
        }
        below += c[e];
      }
    } else {
      for (int i = tid - 32; i < 256; i += kThreads - 32) s.hist[b ^ 1][i] = 0;
    }
    __syncthreads();
    prefix = s.prefix;
    mask = s.mask;
    need = s.need;
    if (s.done) break;    // the bucket is taken whole: prefix settles it
  }
  // Keys whose masked top digits are below the prefix, and the whole
  // bucket at it: exactly kk keys.
  if (tid == 0) s.nout = 0;
  __syncthreads();
  for (int i = tid; i < count; i += kThreads) {
    const unsigned long long key = keys[i];
    if ((key & mask) <= prefix) out[atomicAdd(&s.nout, 1)] = key;
  }
  __syncthreads();
}

// The split cluster barrier: arrive early (relaxed: it orders nothing, it
// only says the block has started), wait late, so that the wait costs
// nothing when every block has long arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One diff's share of a row's distance, and the distance from the sum:
// kMode 2 (p = 2), 1 (p = 1), 0 (general p).  A template argument, so the
// inner loop carries no branch and never evaluates powf for p in {1, 2}.
template <int kMode>
__device__ __forceinline__ float term(float diff, float p) {
  if constexpr (kMode == 2) return diff * diff;
  if constexpr (kMode == 1) return fabsf(diff);
  return powf(fabsf(diff), p);
}

template <int kMode>
__device__ __forceinline__ float finish(float acc, float p) {
  if constexpr (kMode == 2) return sqrtf(acc);
  if constexpr (kMode == 1) return acc;
  return powf(acc, 1.0f / p);
}

// Widen one 16-byte chunk of a row into fp32 values (exact for all three
// types: bf16 is the top half of a float, int8 a sign-extended byte).
template <class T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kPer = 4;
  __device__ static void widen(uint4 v, float* out) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
  __device__ static float scalar(float x) { return x; }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kPer = 8;
  __device__ static void widen(uint4 v, float* out) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float scalar(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

template <>
struct Chunk<int8_t> {
  static constexpr int kPer = 16;
  __device__ static void widen(uint4 v, float* out) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        out[4 * i + b] = static_cast<float>(
            static_cast<int>(w[i] << (24 - 8 * b)) >> 24);
      }
    }
  }
  __device__ static float scalar(int8_t x) { return static_cast<float>(x); }
};

// The number of keys in list[0, n) below key.  Unrolled by 8 with four
// partial counts, so that eight independent shared loads are in flight
// (one after another, each would wait out the load latency); within a
// warp every lane reads the same address: one broadcast.
__device__ __forceinline__ int count_below(const unsigned long long* list,
                                           int n, unsigned long long key) {
  int c[4] = {0, 0, 0, 0};
  int j = 0;
  for (; j + 8 <= n; j += 8) {
    unsigned long long v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = list[j + u];
#pragma unroll
    for (int u = 0; u < 8; ++u) c[u & 3] += v[u] < key;
  }
  for (; j < n; ++j) c[0] += list[j] < key;
  return c[0] + c[1] + c[2] + c[3];
}

// Write the pick at `place` of a row: its distance times `post`, and its
// id, or -1 for a distance of +inf.
__device__ __forceinline__ void emit(unsigned long long key, int id,
                                     int place, float post, float* out_d,
                                     int* out_i) {
  const float d = __uint_as_float(static_cast<unsigned>(key >> 32));
  out_d[place] = d * post;
  out_i[place] = isinf(d) ? -1 : id;
}

// Arguments of one launch (by value: the kernel reads them from the
// constant bank).
struct Args {
  const float* q;          // (nq, n) fp32 queries
  const void* rows;        // (m, n) rows of type T
  const float* scale;      // int8: fp32 scales on the device, one per
                           // rows_per_scale rows; else unused
  int rows_per_scale;      // row r reads scale[r / rows_per_scale]
  const int* ids;          // (nq, c) candidate ids
  int n, c, k, valid, pmode;
  float p;
  int cluster;             // G: blocks per row
  int slots;               // S: slots per block
  int lanes_log2;          // log2 of L, lanes per candidate
  float* out_d;            // (nq, k)
  int* out_i;              // (nq, k)
};

// Score the count compacted candidates in keys[] ((id << 32 | slot) in,
// (distance bits << 32 | slot) out): a sub-warp of L lanes per candidate,
// kUnroll = 4 candidates each, so a block keeps 64 (fp32) to 256 (int8)
// rows in flight.  Candidate e goes to sub-warp e mod (warps x
// sub-warps), so a block's few valid rows spread over all its warps; the
// loop bound is uniform over the block, so every lane reaches the shuffles.
template <class T, bool kVec, int kMode>
__device__ __forceinline__ void score(const Args& a, const float* sq,
                                      unsigned long long* keys, int count) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int lg = a.lanes_log2;
  const int lanes = 1 << lg;
  const int subs = 32 >> lg;          // sub-warps per warp
  const int sub = lane >> lg;
  const int sl = lane & (lanes - 1);
  const int stride = kWarps * subs;   // sub-warps per block
  const T* rows = static_cast<const T*>(a.rows);
  constexpr int kUnroll = 4;
  for (int base = 0; base < count; base += kUnroll * stride) {
    int e[kUnroll];
    unsigned slot[kUnroll];
    const T* x[kUnroll];
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      e[u] = base + u * stride + warp * subs + sub;
      const unsigned long long key = e[u] < count ? keys[e[u]] : 0ull;
      slot[u] = static_cast<unsigned>(key);
      x[u] = rows + static_cast<size_t>(key >> 32) * a.n;
      acc[u] = 0.0f;
    }
    if (kVec) {
      constexpr int kPer = Chunk<T>::kPer;
      const int chunks = a.n / kPer;
      for (int j = sl; j < chunks; j += lanes) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (e[u] < count) {
            v[u] = __ldg(reinterpret_cast<const uint4*>(x[u]) + j);
          }
        }
        float qv[kPer];
#pragma unroll
        for (int t = 0; t < kPer; t += 4) {
          const float4 f =
              reinterpret_cast<const float4*>(sq)[(j * kPer + t) / 4];
          qv[t] = f.x;
          qv[t + 1] = f.y;
          qv[t + 2] = f.z;
          qv[t + 3] = f.w;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (e[u] < count) {
            float w[kPer];
            Chunk<T>::widen(v[u], w);
#pragma unroll
            for (int t = 0; t < kPer; ++t) {
              acc[u] += term<kMode>(w[t] - qv[t], a.p);
            }
          }
        }
      }
    } else {
      for (int j = sl; j < a.n; j += lanes) {
        float w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          w[u] = e[u] < count ? Chunk<T>::scalar(x[u][j]) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (e[u] < count) acc[u] += term<kMode>(w[u] - sq[j], a.p);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      for (int off = lanes >> 1; off > 0; off >>= 1) {
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      }
      if (e[u] < count && sl == 0) {
        const float d = finish<kMode>(acc[u], a.p);
        keys[e[u]] =
            (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
            slot[u];
      }
    }
  }
}

// Dynamic shared memory layout: the query (n floats, padded to 16 bytes),
// the block's candidate list (S keys), its radix winners (kMaxK keys) and,
// on a cluster, rank 0's pool of every rank's sorted list (G x kMaxK keys,
// then their G x kMaxK ids).  The Python `_plan` computes the same sum.
__host__ __device__ inline size_t smem_bytes(int n, int slots, int cluster) {
  const size_t sq = (static_cast<size_t>(n) * 4 + 15) / 16 * 16;
  const size_t pool = cluster > 1 ? static_cast<size_t>(cluster) * kMaxK : 0;
  return sq + 8 * (static_cast<size_t>(slots) + kMaxK + pool) + 4 * pool;
}

template <class T, bool kVec>
__global__ void __launch_bounds__(kThreads) row_topk_kernel(const Args a) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch s;
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;

  float* sq = reinterpret_cast<float*>(smem);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(
      smem + (static_cast<size_t>(a.n) * 4 + 15) / 16 * 16);
  unsigned long long* win = keys + a.slots;
  unsigned long long* pool = win + kMaxK;
  int* pool_ids = reinterpret_cast<int*>(pool + a.cluster * kMaxK);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row = blockIdx.x / a.cluster;
  const int rank = blockIdx.x % a.cluster;
  // rank r owns slots r, r + G, r + 2G, ...: candidate gathers fill each
  // bucket's first slots, so interleaving spreads the valid ones evenly
  const int nslots = (a.c - rank + a.cluster - 1) / a.cluster;
  const int* rid = a.ids + static_cast<size_t>(row) * a.c;
  // the row's segment's scale: one launch scores a stack of segments
  const float qs = kInt8 ? a.scale[row / a.rows_per_scale] : 1.0f;
  if (a.cluster > 1) cluster_arrive();   // waited for before the push

  for (int j = tid; j < a.n; j += kThreads) {
    const float v = a.q[static_cast<size_t>(row) * a.n + j];
    sq[j] = kInt8 ? rintf(__fdiv_rn(v, qs)) : v;
  }

  // 1. ids of this block's slots, read once (kRounds chunks of kThreads
  //    in flight at a time); valid ones compacted as (id << 32 | slot)
  int count = 0;
  for (int base = 0; base < nslots; base += kRounds * kThreads) {
    int id[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int l = base + r * kThreads + tid;
      id[r] = l < nslots ? rid[rank + l * a.cluster] : -1;
    }
    unsigned ballot[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      ballot[r] = __ballot_sync(0xffffffffu, id[r] >= 0 && id[r] < a.valid);
      if (lane == 0) s.warp_count[r][warp] = __popc(ballot[r]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      int off = count;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        off += w < warp ? s.warp_count[r][w] : 0;
        count += s.warp_count[r][w];
      }
      if ((ballot[r] >> lane) & 1u) {
        keys[off + __popc(ballot[r] & ((1u << lane) - 1u))] =
            (static_cast<unsigned long long>(static_cast<unsigned>(id[r]))
             << 32) |
            static_cast<unsigned>(rank + (base + r * kThreads + tid) *
                                                 a.cluster);
      }
    }
    __syncthreads();
  }

  // 2. a sub-warp of L lanes per valid candidate (score<>, above)
  if (a.pmode == 2) {
    score<T, kVec, 2>(a, sq, keys, count);
  } else if (a.pmode == 1) {
    score<T, kVec, 1>(a, sq, keys, count);
  } else {
    score<T, kVec, 0>(a, sq, keys, count);
  }
  __syncthreads();

  // 3. Order this block's keys by counting: a key's place is the number of
  //    smaller keys (all distinct), so one pass sorts and selects.  Past
  //    kRankMax keys, radix select keeps the k smallest first.  Alone
  //    (G = 1) the block writes its first k places as the row; on a
  //    cluster each rank writes its sorted list into rank 0's pool.
  const unsigned long long* cand = keys;
  int n = count;
  if (count > kRankMax) {
    n = a.k;
    select_smallest(keys, count, n, win, s);
    cand = win;
  }
  const int mine = min(a.k, n);
  const float post = kInt8 ? qs : 1.0f;
  float* out_d = a.out_d + static_cast<size_t>(row) * a.k;
  int* out_i = a.out_i + static_cast<size_t>(row) * a.k;
  unsigned long long* dst = pool;
  int* dst_ids = pool_ids;
  cg::cluster_group cluster = cg::this_cluster();
  if (a.cluster > 1) {
    cluster_wait();              // every block has started: rank 0's
                                 // shared memory may be written
    const size_t at = static_cast<size_t>(rank) * kMaxK;
    dst = cluster.map_shared_rank(pool, 0) + at;
    dst_ids = cluster.map_shared_rank(pool_ids, 0) + at;
    if (tid == 0) *cluster.map_shared_rank(&s.counts[rank], 0) = mine;
  }
  for (int t = tid; t < n; t += kThreads) {
    const unsigned long long key = cand[t];
    const int place = count_below(cand, n, key);
    if (place < mine) {
      // this block read the id in step 1: likely still in its L1
      const int id = rid[static_cast<unsigned>(key)];
      if (a.cluster > 1) {
        dst[place] = key;
        dst_ids[place] = id;
      } else {
        emit(key, id, place, post, out_d, out_i);
      }
    }
  }
  int total = mine;
  if (a.cluster > 1) {
    cluster.sync();              // every rank's list is in rank 0's pool
    if (rank != 0) return;
    // 4. Rank 0 merges the G sorted lists: the place of entry i of list r
    //    is i plus, in every other list, the number of smaller keys (a
    //    binary search).  No barrier: each entry writes its own place.
    total = 0;
    for (int r = 0; r < a.cluster; ++r) total += s.counts[r];
    for (int e = tid; e < total; e += kThreads) {
      int r = 0, i = e;
      while (i >= s.counts[r]) i -= s.counts[r++];
      const unsigned long long key = pool[r * kMaxK + i];
      int place = i;
      for (int r2 = 0; r2 < a.cluster; ++r2) {
        if (r2 == r) continue;
        const unsigned long long* list = pool + r2 * kMaxK;
        int first = 0, last = s.counts[r2];
        while (first < last) {
          const int mid = (first + last) / 2;
          if (list[mid] < key) {
            first = mid + 1;
          } else {
            last = mid;
          }
        }
        place += first;
      }
      if (place < a.k) {
        emit(key, pool_ids[r * kMaxK + i], place, post, out_d, out_i);
      }
    }
    total = min(a.k, total);
  }
  for (int t = total + tid; t < a.k; t += kThreads) {
    out_d[t] = INFINITY * post;  // past the valid candidates
    out_i[t] = -1;
  }
}

// Launch one row_topk_kernel<T, kVec> on `stream`: nq x G blocks in
// clusters of G.  Returns the launch's cudaError_t (a refused cluster
// launch included).
template <class T, bool kVec>
int launch(const Args& a, int nq, void* stream) {
  const size_t smem = smem_bytes(a.n, a.slots, a.cluster);
  cudaError_t err = allow_dynamic_smem(row_topk_kernel<T, kVec>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nq) * a.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, row_topk_kernel<T, kVec>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace topk
}  // namespace repro_torch
