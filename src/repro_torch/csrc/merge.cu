// K3 merge: the first n_out pairs of each row under the total (distance,
// id) order -- the cross-segment fan-in of every query.
//
// Replaces: src/repro/kernels/merge.py, _bitonic_kernel / sort_pairs_pallas
// (the fan-in of ops.merge_topk after SegmentedIndex.query).
//
// Two routes; the wrapper (kernels/merge.py, `route`) picks one from the
// shapes alone and neither falls back to the other.
//
// 1. Selection (n_out <= 128, sorted_run == 1: every call ops.merge_topk
//    makes).  What the path asks is k = 10 or 40 of M = 2,570 .. 41,280
//    pairs a row.  Bound on the H100: bytes, each pair read once (8 B) and
//    n_out written: 0.2 us at (32, 2570), 3.2 us at (128, 10,320).
//
//    Keys.  A pair becomes one 64-bit key whose unsigned order is the
//    network's order: the high word is the float's order-preserving bits
//    (the bits negated, two's complement, when the sign is set, else the
//    sign bit set), the low word id ^ 0x80000000 (so -1 < 0 < INT32_MAX).
//    Negation sends -0.0 to +0.0's word: the network calls the two equal
//    and orders them by id, and so does the key, at no cost over a bitwise
//    not.  On NaN-free pairs decoding a key gives back the pair's bits, but
//    for the sign of zero, which the block that writes a row's outputs
//    restores when a merged list may hold a zero (restore_negative_zeros:
//    each picked (0, id) takes the sign of the row's pair of that id).  So
//    the output is bit-identical to the network's first n_out columns
//    wherever no id of a row is paired with both -0.0 and +0.0.  That one
//    case cannot be reproduced: the network leaves such equal pairs (say
//    (-0.0, 5) and (+0.0, 5)) where its compare pattern puts them, which no
//    selection does.  The path's distances are sums of non-negative terms
//    from +0.0, and masked slots +inf, so they never hold -0.0.
//
//    Design.  A row is split over a cluster of G <= 4 blocks (the plan in
//    kernels/merge.py: one wave of at most 264 blocks), rank r owning the
//    contiguous pairs [r * share, (r + 1) * share).  A rank reads its share
//    once, 16-byte loads of d and ids (from the 16-byte chunks that cover
//    it, at any row offset, when d and ids share their alignment) or 4-byte
//    loads, two chunks a thread in flight (eight when the share streams
//    in tiles), and writes each key to its place in shared memory,
//    tracking the smallest and largest.  A share
//    larger than a tile (8,192 keys) streams tile by tile, keeping the best
//    n_out so far; from the second tile on a key not below the current
//    n_out-th is dropped at load (the survivors appended by warp: a warp
//    scan and one atomic).  Per tile the rank selects its n_out smallest
//    keys:
//      - radix narrowing, MSB-first 8-bit digits from the first bit where
//        the smallest and largest key differ, histograms in shared memory
//        with one atomic per distinct digit per warp (rows hold hundreds of
//        identical (+inf, -1) keys), until the bucket holding the n_out-th
//        key has <= 64 keys, is taken whole, or is one repeated key;
//      - placement by counting: a key strictly below the bucket (< n_out
//        of them) and a bucket key are placed by the number of smaller keys
//        plus the equal keys at a lower position in its list, so duplicates
//        take distinct places; a bucket of one repeated key fills the
//        missing places with copies.
//    Each rank writes its sorted list into rank 0's shared memory
//    (distributed shared memory), and rank 0 merges the G lists by binary
//    search, equal keys ordered by rank.  Launched with cudaLaunchKernelEx:
//    the cluster dimension and programmatic dependent launch.
//    ops.merge_topk's masking is folded in (mask_invalid): a pair whose id
//    is < 0 is read as +inf, and a picked +inf distance is written with
//    id -1.
//
// 2. The network (n_out > 128 or sorted_run > 1; only the checks call it):
//    the bitonic compare-exchange network the TPU kernel runs, one block per
//    row, the power-of-two pool in shared memory (P * 8 bytes, so P <=
//    16,384), stages below `sorted_run` skipped exactly as in the reference;
//    it only compares and selects, so it is bit-identical to the plain
//    network, (+inf, INT32_MAX) padding included.
#include <climits>
#include <cstdint>

#include "topk.cuh"

namespace {

// -- route 2: the network -----------------------------------------------------

constexpr int kNetworkSmemMax = 232448;   // 227 KB: a block's most

__global__ void bitonic_kernel(const float* __restrict__ d_in,
                               const int* __restrict__ i_in, int m, int pw,
                               int sorted_run, int n_out,
                               float* __restrict__ d_out,
                               int* __restrict__ i_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sd = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sd + pw);
  const float* drow = d_in + static_cast<size_t>(blockIdx.x) * m;
  const int* irow = i_in + static_cast<size_t>(blockIdx.x) * m;

  for (int t = threadIdx.x; t < pw; t += blockDim.x) {
    sd[t] = t < m ? drow[t] : INFINITY;
    si[t] = t < m ? irow[t] : INT_MAX;
  }
  __syncthreads();

  for (int run = sorted_run; run < pw; run *= 2) {
    // Reverse the second run of every 2*run chunk: each chunk is then
    // bitonic (merge._network's concatenate of dr[..., 1:, ::-1]).
    const int half = run / 2;
    if (half > 0) {
      const int swaps = (pw / (2 * run)) * half;
      for (int t = threadIdx.x; t < swaps; t += blockDim.x) {
        const int chunk = t / half;
        const int j = t % half;
        const int lo = chunk * 2 * run + run + j;
        const int hi = chunk * 2 * run + 2 * run - 1 - j;
        const float td = sd[lo];
        sd[lo] = sd[hi];
        sd[hi] = td;
        const int ti = si[lo];
        si[lo] = si[hi];
        si[hi] = ti;
      }
      __syncthreads();
    }
    for (int span = 2 * run; span >= 2; span /= 2) {
      const int hs = span / 2;
      for (int t = threadIdx.x; t < pw / 2; t += blockDim.x) {
        const int a = (t / hs) * span + (t % hs);
        const int b = a + hs;
        const float d0 = sd[a];
        const float d1 = sd[b];
        const int i0 = si[a];
        const int i1 = si[b];
        if (d1 < d0 || (d1 == d0 && i1 < i0)) {
          sd[a] = d1;
          sd[b] = d0;
          si[a] = i1;
          si[b] = i0;
        }
      }
      __syncthreads();
    }
  }

  float* dro = d_out + static_cast<size_t>(blockIdx.x) * n_out;
  int* iro = i_out + static_cast<size_t>(blockIdx.x) * n_out;
  for (int t = threadIdx.x; t < n_out; t += blockDim.x) {
    dro[t] = sd[t];
    iro[t] = si[t];
  }
}

// -- route 1: the selection ---------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;          // the largest n_out of the route
constexpr int kSmall = 64;          // a bucket this small is placed by counting
constexpr int kMaxCluster = 8;
constexpr int kMaxTile = 8192;      // keys a tile holds at most
constexpr int kUnroll = 4;          // keys a thread reads a step of a scan
constexpr unsigned long long kNone = ~0ull;   // above every NaN-free key

// Dynamic shared memory: the pool (the best n_out so far, then a tile's
// keys), the rank's sorted list, the two lists of the placement and, on a
// cluster, rank 0's G lists.  The Python plan computes the same sum.
__host__ __device__ constexpr int select_smem_bytes(int tile, int cluster) {
  return 8 * (kMaxK + tile + 3 * kMaxK + (cluster > 1 ? cluster * kMaxK : 0));
}

struct Scratch {
  unsigned hist[2][256];            // one digit's counts; the next pass's
  unsigned long long lo[kWarps], hi[kWarps];
  unsigned long long prefix, mask;
  int need, bucket;
  int n;                            // keys in the pool
  int na, nb;                       // lengths of the placement lists
  int counts[kMaxCluster];          // rank 0: each rank's list length
  int zero;                         // rank 0: a rank's list may hold a
                                    // zero distance
};

struct SelectArgs {
  const float* d;         // moved back by `off` elements to a 16-byte
  const int* ids;         // boundary on the vector path
  int m, n_out;
  int off;
  int cluster, share, tile;
  int mask_invalid;
  float* out_d;           // (rows, n_out)
  int* out_i;
};

__device__ __forceinline__ unsigned long long encode(float d, int id) {
  // -0.0 (0x80000000) negates to itself, +0.0's word: equal, ties by id
  unsigned b = __float_as_uint(d);
  b = (b & 0x80000000u) ? 0u - b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) |
         (static_cast<unsigned>(id) ^ 0x80000000u);
}

__device__ __forceinline__ void emit(const SelectArgs& a, size_t at,
                                     unsigned long long key) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  const float d = __uint_as_float((hi & 0x80000000u) ? (hi ^ 0x80000000u)
                                                     : 0u - hi);
  const int id = static_cast<int>(static_cast<unsigned>(key) ^ 0x80000000u);
  a.out_d[at] = d;
  a.out_i[at] = (a.mask_invalid && isinf(d)) ? -1 : id;
}

// True when a sorted list whose smallest key is `smallest` may hold a zero
// distance (its word is at most +-0.0's).  On the path, whose distances
// are sums of non-negative terms from +0.0, only an exact match does.
__device__ __forceinline__ bool may_hold_zero(unsigned long long smallest) {
  return static_cast<unsigned>(smallest >> 32) <= 0x80000000u;
}

// The key sends -0.0 to +0.0's word, so emit wrote every zero distance as
// +0.0.  Give each back its own pair's sign: after a barrier (every output
// of the row written), a thread per pair of the row that holds -0.0 (with
// a valid id, under mask_invalid) writes -0.0 into every output slot of
// the row holding (0, that id).  Run by the block that wrote the row, and
// only when a list it merged may hold a zero (a branch uniform over the
// block, so a row without one pays no barrier).  The row is read through
// the non-coherent cache, as at load (coherent loads here slowed the whole
// kernel; tools/ab_merge.py).  Exact wherever an id is not paired with both
// -0.0 and +0.0 in one row; where it is, the network leaves the two equal
// pairs where its compare pattern puts them, which no selection
// reproduces, and each picked zero of that id is written -0.0.
__device__ void restore_negative_zeros(const SelectArgs& a, long long row0,
                                       size_t out0) {
  __syncthreads();
  for (int j = threadIdx.x; j < a.m; j += kThreads) {
    if (__float_as_uint(__ldg(a.d + row0 + j)) != 0x80000000u) continue;
    const int id = __ldg(a.ids + row0 + j);
    if (a.mask_invalid && id < 0) continue;
    for (int t = 0; t < a.n_out; ++t) {
      if (a.out_i[out0 + t] == id && a.out_d[out0 + t] == 0.0f) {
        a.out_d[out0 + t] = -0.0f;
      }
    }
  }
}

// The split cluster barrier's arrive with release semantics (PTX's
// default), where topk::cluster_arrive is relaxed: rank 0's zeroed
// s.zero, written before it, is visible to every rank once it has waited.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

// Append the keys of this lane whose bit is set in `keep` to list[] at a
// place taken by its warp: a warp scan of the counts and one atomic on
// `*len`.  Every lane of the warp calls it.  (Each key keeps its register:
// a key's place is found from `keep`, never by a runtime index.)
template <int kMax>
__device__ __forceinline__ void append(const unsigned long long (&keys)[kMax],
                                       unsigned keep, unsigned long long* list,
                                       int* len) {
  const int lane = threadIdx.x % 32;
  const int n = __popc(keep);
  int incl = n;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  int base = 0;
  if (lane == 0 && total > 0) base = atomicAdd(len, total);
  base = __shfl_sync(0xffffffffu, base, 0) + incl - n;
#pragma unroll
  for (int j = 0; j < kMax; ++j) {
    if ((keep >> j) & 1u) {
      list[base + __popc(keep & ((1u << j) - 1u))] = keys[j];
    }
  }
}

// The place of list[e] among list[0, n): the smaller keys plus the equal
// keys at a lower position, so equal keys take distinct places.  Unrolled
// by 8 with four partial counts (eight shared loads in flight, each a
// broadcast within a warp when the lanes agree on j).
__device__ __forceinline__ int place_of(const unsigned long long* list, int n,
                                        int e) {
  const unsigned long long key = list[e];
  int c[4] = {0, 0, 0, 0};
  int j = 0;
  for (; j + 8 <= n; j += 8) {
    unsigned long long v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = list[j + u];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      c[u & 3] += v[u] < key || (v[u] == key && j + u < e);
    }
  }
  for (; j < n; ++j) c[0] += list[j] < key || (list[j] == key && j < e);
  return c[0] + c[1] + c[2] + c[3];
}

// Append `key` to list[] where `pred` holds: one ballot per warp, and one
// atomic on `*len` by a warp with any key to append.  Every lane of the
// warp calls it.
__device__ __forceinline__ void append_one(unsigned long long key, bool pred,
                                           unsigned long long* list,
                                           int* len) {
  const int lane = threadIdx.x % 32;
  const unsigned ballot = __ballot_sync(0xffffffffu, pred);
  if (ballot == 0) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(len, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (pred) list[base + __popc(ballot & ((1u << lane) - 1u))] = key;
}

// Write the kk smallest keys of pool[0, n) to out[0, kk) in ascending
// order (0 < kk <= n, kk <= kMaxK), given the smallest and largest key (lo,
// hi) and s.hist[0] zeroed.  la and lb are lists of kMaxK keys.  Every
// thread of the block calls it; it ends at a barrier.
__device__ void select_sorted(const unsigned long long* pool, int n, int kk,
                              unsigned long long lo, unsigned long long hi,
                              unsigned long long* out, unsigned long long* la,
                              unsigned long long* lb, Scratch& s) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // The bucket: the keys whose masked bits equal prefix; need of its keys
  // belong to the answer, after every key below it.  At first: all keys.
  unsigned long long prefix = 0, mask = 0;
  int need = kk, bucket = n;
  if (n > kSmall && kk < n) {
    if (lo == hi) {
      prefix = lo;                  // one repeated key
      mask = kNone;
    } else {
      // The digits above the first bit where lo and hi differ are common
      // to every key: start below them.
      int shift = (63 - __clzll(lo ^ hi)) / 8 * 8;
      mask = shift == 56 ? 0ull : kNone << (shift + 8);
      prefix = lo & mask;
      for (int b = 0; shift >= 0 && bucket > kSmall && bucket != need;
           shift -= 8, b ^= 1) {
        // the bucket's keys counted by digit: a warp's lanes with one digit
        // add once (__match_any_sync), since rows hold many equal keys
        for (int base = 0; base < n; base += kUnroll * kThreads) {
          unsigned long long key[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int i = base + u * kThreads + tid;
            key[u] = i < n ? pool[i] : 0ull;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const bool in = base + u * kThreads + tid < n &&
                            (key[u] & mask) == prefix;
            const unsigned ballot = __ballot_sync(0xffffffffu, in);
            if (in) {
              const unsigned dg = static_cast<unsigned>(key[u] >> shift) &
                                  255u;
              const unsigned peers = __match_any_sync(ballot, dg);
              if ((peers & ((1u << lane) - 1u)) == 0) {
                atomicAdd(&s.hist[b][dg], static_cast<unsigned>(
                                              __popc(peers)));
              }
            }
          }
        }
        __syncthreads();
        if (warp == 0) {
          // lane l holds bins 8l .. 8l+7; an exclusive warp scan of the
          // lane sums gives each lane the count of keys in lower bins
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
              s.prefix = prefix | (static_cast<unsigned long long>(
                                       lane * 8 + e) << shift);
              s.mask = mask | (255ull << shift);
              s.need = need - static_cast<int>(below);
              s.bucket = static_cast<int>(c[e]);
            }
            below += c[e];
          }
        } else {
          for (int i = tid - 32; i < 256; i += kThreads - 32) {
            s.hist[b ^ 1][i] = 0;
          }
        }
        __syncthreads();
        prefix = s.prefix;
        mask = s.mask;
        need = s.need;
        bucket = s.bucket;
      }
    }
  }
  if (mask == 0) {
    // no pass ran (n <= kSmall or kk == n): place the pool's keys as they
    // lie, every one in the bucket
    for (int e = tid; e < n; e += kThreads) {
      const int r = place_of(pool, n, e);
      if (r < kk) out[r] = pool[e];
    }
    __syncthreads();
    return;
  }
  const bool repeated = mask == kNone;   // the bucket is one key, `prefix`

  // The keys below the bucket (kk - need of them) into la, the bucket's
  // keys into lb (unless it is one repeated key).
  if (tid == 0) {
    s.na = 0;
    s.nb = 0;
  }
  __syncthreads();
  for (int base = 0; base < n; base += kUnroll * kThreads) {
    unsigned long long key[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + tid;
      key[u] = i < n ? pool[i] : kNone;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = base + u * kThreads + tid < n;
      const unsigned long long mk = key[u] & mask;
      append_one(key[u], ok && mk < prefix, la, &s.na);
      if (!repeated) append_one(key[u], ok && mk == prefix, lb, &s.nb);
    }
  }
  __syncthreads();
  const int na = s.na;
  for (int e = tid; e < na; e += kThreads) out[place_of(la, na, e)] = la[e];
  if (repeated) {
    for (int t = tid; t < need; t += kThreads) out[na + t] = prefix;
  } else {
    const int nb = s.nb;
    for (int e = tid; e < nb; e += kThreads) {
      const int r = place_of(lb, nb, e);
      if (r < need) out[na + r] = lb[e];
    }
  }
  __syncthreads();
}

// Read one tile -- chunks [c0, c1) of kW elements, kept where the flat
// element index lies in [lo, hi), e0 = max(lo, c0 * kW) the first -- into
// the pool after its first nb keys.  Unfiltered (thr == kNone), key e goes
// to pool[nb + e - e0]; filtered, the keys below thr are appended at
// s.n by warp.  Folds the keys into this thread's kmin / kmax.
template <bool kVec, int kLoadUnroll>
__device__ __forceinline__ void load_tile(const SelectArgs& a, long long lo,
                                          long long hi, long long c0,
                                          long long c1, int nb,
                                          unsigned long long thr,
                                          unsigned long long* pool,
                                          unsigned long long& kmin,
                                          unsigned long long& kmax,
                                          Scratch& s) {
  constexpr int kW = kVec ? 4 : 1;
  const long long e0 = max(lo, c0 * kW);
  for (long long base = c0; base < c1; base += kThreads * kLoadUnroll) {
    float dv[kLoadUnroll][kW] = {};
    int iv[kLoadUnroll][kW] = {};
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const long long c = base + u * kThreads + threadIdx.x;
      if (c < c1) {
        if constexpr (kVec) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(a.d) + c);
          const int4 g = __ldg(reinterpret_cast<const int4*>(a.ids) + c);
          dv[u][0] = f.x;
          dv[u][1] = f.y;
          dv[u][2] = f.z;
          dv[u][3] = f.w;
          iv[u][0] = g.x;
          iv[u][1] = g.y;
          iv[u][2] = g.z;
          iv[u][3] = g.w;
        } else {
          dv[u][0] = __ldg(a.d + c);
          iv[u][0] = __ldg(a.ids + c);
        }
      }
    }
    unsigned long long keys[kLoadUnroll * kW];
    unsigned keep = 0;
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const long long c = base + u * kThreads + threadIdx.x;
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const long long e = c * kW + w;
        const float d = (a.mask_invalid && iv[u][w] < 0) ? INFINITY
                                                         : dv[u][w];
        const unsigned long long key = encode(d, iv[u][w]);
        keys[u * kW + w] = key;
        if (c < c1 && e >= lo && e < hi && key < thr) {
          keep |= 1u << (u * kW + w);
          kmin = min(kmin, key);
          kmax = max(kmax, key);
          if (thr == kNone) pool[nb + (e - e0)] = key;
        }
      }
    }
    if (thr != kNone && __any_sync(0xffffffffu, keep != 0)) {
      append(keys, keep, pool, &s.n);
    }
  }
}

// One block per (row, rank): blockIdx.x = row * G + rank.  kLoadUnroll:
// chunks a thread has in flight at load -- 2 when the share is one tile
// (the least fixed cost), 8 when it streams several (the most bytes in
// flight; measured, tools/bench_merge.py).
template <bool kVec, int kLoadUnroll>
__global__ void __launch_bounds__(kThreads) select_kernel(const SelectArgs a) {
  namespace cg = cooperative_groups;
  namespace topk = repro_torch::topk;
  constexpr int kW = kVec ? 4 : 1;
  extern __shared__ __align__(16) unsigned long long sm[];
  __shared__ Scratch s;
  unsigned long long* pool = sm;                    // kMaxK + tile
  unsigned long long* win = pool + kMaxK + a.tile;  // kMaxK
  unsigned long long* la = win + kMaxK;
  unsigned long long* lb = la + kMaxK;
  unsigned long long* lists = lb + kMaxK;           // G x kMaxK (rank 0)

  const int tid = threadIdx.x;
  const int row = blockIdx.x / a.cluster;
  const int rank = blockIdx.x % a.cluster;
  if (a.cluster > 1) {               // waited for before the push
    if (tid == 0) s.zero = 0;
    cluster_arrive_release();
  }
  // Programmatic dependent launch: wait for the kernels before this one
  // (their writes to d and ids visible), then let the next one launch.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::);

  const long long row0 = static_cast<long long>(row) * a.m + a.off;
  const long long hi = row0 + min(static_cast<long long>(a.m),
                                  static_cast<long long>(rank + 1) * a.share);
  const long long lo =
      min(hi, row0 + static_cast<long long>(rank) * a.share);
  const long long c1 = (hi + kW - 1) / kW;
  const int tile_chunks = a.tile / kW;
  int nb = 0;                        // keys in win, sorted
  unsigned long long thr = kNone;
  for (long long c0 = lo / kW; c0 < c1; c0 += tile_chunks) {
    const long long t1 = min(c1, c0 + tile_chunks);
    unsigned long long kmin = kNone, kmax = 0;
    for (int i = tid; i < nb; i += kThreads) {
      pool[i] = win[i];
      kmin = min(kmin, win[i]);
      kmax = max(kmax, win[i]);
    }
    if (thr != kNone) {
      if (tid == 0) s.n = nb;
      __syncthreads();
    }
    load_tile<kVec, kLoadUnroll>(a, lo, hi, c0, t1, nb, thr, pool, kmin,
                                 kmax, s);
    // the tile's smallest and largest key, and the first radix pass's
    // counts zeroed, at the barrier that ends the load
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
    }
    if (tid % 32 == 0) {
      s.lo[tid / 32] = kmin;
      s.hi[tid / 32] = kmax;
    }
    for (int i = tid; i < 256; i += kThreads) s.hist[0][i] = 0;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      kmin = min(kmin, s.lo[w]);
      kmax = max(kmax, s.hi[w]);
    }
    const int n = thr != kNone
                      ? s.n
                      : nb + static_cast<int>(min(hi, t1 * kW) -
                                              max(lo, c0 * kW));
    const int kk = min(a.n_out, n);
    select_sorted(pool, n, kk, kmin, kmax, win, la, lb, s);
    nb = kk;
    if (kk == a.n_out) thr = win[kk - 1];
  }

  const size_t out0 = static_cast<size_t>(row) * a.n_out;
  if (a.cluster == 1) {
    for (int t = tid; t < a.n_out; t += kThreads) emit(a, out0 + t, win[t]);
    if (may_hold_zero(win[0])) restore_negative_zeros(a, row0, out0);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  topk::cluster_wait();              // every block has started: rank 0's
                                     // shared memory may be written
  unsigned long long* dst =
      cluster.map_shared_rank(lists, 0) + static_cast<size_t>(rank) * kMaxK;
  for (int t = tid; t < nb; t += kThreads) dst[t] = win[t];
  if (tid == 0) {
    *cluster.map_shared_rank(&s.counts[rank], 0) = nb;
    if (nb && may_hold_zero(win[0])) {
      atomicOr(cluster.map_shared_rank(&s.zero, 0), 1);
    }
  }
  cluster.sync();                    // every rank's list is in rank 0's
  if (rank != 0) return;
  // Rank 0 merges the G sorted lists: the place of entry i of list r is i
  // plus, in each list before r, the keys <= it and, in each list after r,
  // the keys < it (binary searches); equal keys go in rank order.
  int total = 0;
  for (int r = 0; r < a.cluster; ++r) total += s.counts[r];
  const bool zero = s.zero;          // read beside the counts
  for (int e = tid; e < total; e += kThreads) {
    int r = 0, i = e;
    while (i >= s.counts[r]) i -= s.counts[r++];
    const unsigned long long key = lists[r * kMaxK + i];
    int place = i;
    for (int r2 = 0; r2 < a.cluster; ++r2) {
      if (r2 == r) continue;
      const unsigned long long* list = lists + r2 * kMaxK;
      int first = 0, last = s.counts[r2];
      while (first < last) {
        const int mid = (first + last) / 2;
        if (list[mid] < key || (r2 < r && list[mid] == key)) {
          first = mid + 1;
        } else {
          last = mid;
        }
      }
      place += first;
    }
    if (place < a.n_out) emit(a, out0 + place, key);
  }
  if (zero) restore_negative_zeros(a, row0, out0);
}

template <bool kVec, int kLoadUnroll>
int select_launch(const SelectArgs& a, int rows, cudaStream_t stream) {
  cudaError_t err = repro_torch::allow_dynamic_smem_once<
      select_kernel<kVec, kLoadUnroll>>(
      select_smem_bytes(kMaxTile, kMaxCluster));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * a.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = select_smem_bytes(a.tile, a.cluster);
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = a.cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cluster > 1 ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, select_kernel<kVec, kLoadUnroll>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_DEFINE_ERROR_STRING(merge)

// Route 2.  d, ids: (rows, m); pw: the power of two >= m; outputs (rows,
// n_out).
REPRO_EXPORT int merge_launch(const float* d, const int* ids, int rows, int m,
                              int pw, int sorted_run, int n_out, float* d_out,
                              int* i_out, void* stream) {
  const size_t smem = static_cast<size_t>(pw) * 8;
  if (smem > kNetworkSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      repro_torch::allow_dynamic_smem_once<bitonic_kernel>(kNetworkSmemMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = pw / 2;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  bitonic_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      d, ids, m, pw, sorted_run, n_out, d_out, i_out);
  return static_cast<int>(cudaGetLastError());
}

// Route 1.  d, ids: (rows, m); outputs (rows, n_out), 1 <= n_out <= min(m,
// 128).  cluster (G), share (pairs a rank owns, a multiple of 4), tile
// (keys a tile holds, a multiple of 4, <= 8192) and vec come from the
// wrapper's plan; vec needs d and ids at the same offset from a 16-byte
// boundary.  mask_invalid: read a pair whose id is < 0 as +inf, and write
// id -1 beside a picked +inf distance (ops.merge_topk).
REPRO_EXPORT int merge_select_launch(const float* d, const int* ids, int rows,
                                     int m, int n_out, int cluster, int share,
                                     int tile, int vec, int mask_invalid,
                                     float* d_out, int* i_out, void* stream) {
  if (n_out < 1 || n_out > kMaxK || n_out > m || cluster < 1 ||
      cluster > kMaxCluster || tile < 4 || tile > kMaxTile || tile % 4 ||
      share < 1 || static_cast<long long>(share) * cluster < m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t pd = reinterpret_cast<uintptr_t>(d);
  const uintptr_t pi = reinterpret_cast<uintptr_t>(ids);
  int off = 0;
  if (vec) {
    if (pd % 16 != pi % 16 || pd % 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    off = static_cast<int>(pd % 16 / 4);
  }
  const SelectArgs a{d - off, ids - off, m,     n_out, off,  cluster,
                     share,   tile,      mask_invalid, d_out, i_out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (share > tile) {
    return vec ? select_launch<true, 8>(a, rows, st)
               : select_launch<false, 8>(a, rows, st);
  }
  return vec ? select_launch<true, 2>(a, rows, st)
             : select_launch<false, 2>(a, rows, st);
}
