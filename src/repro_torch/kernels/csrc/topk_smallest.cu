// Survivor ordering: the first `keep` indices of the stable ascending order
// of C keys, in one launch, by one of two paths.
//
// Replaces the TPU kernel pair topk_smallest in
// src/repro/kernels/pairwise_distance.py: _topk_rank_kernel and
// _topk_select_kernel, which either path computes in one launch. The keys
// are int32 IEEE-totalorder keys, or (the fp32 mode) the float estimates
// themselves, which the kernel maps to the same order in registers: a
// non-negative float's bits b become b | 2^31, a negative one's ~b. Integer
// comparison then orders them like lax.top_k, -0.0 < +0.0 and NaNs of both
// signs included, and the caller (repro_torch/kernels/ops.py) needs no
// launches of its own to make the keys.
//
// Both paths order the composite keys u_i = (v_i + 2^31) << 32 | i, distinct
// uint64s, so the stable order of the keys is the order of the u_i, and
// nothing depends on the order of any atomic.
//
// Sort path (topk_rank_plan in pairwise_distance.py; the halving's keep = C
// and the rank-only mode). A tiled sort gives each key its stable rank
//   r_i = #{j : v[j] < v[i] or (v[j] == v[i] and j < i)} = #{j : u_j < u_i}.
// Each thread-block cluster owns a tile of at most `tile` keys (a power of
// two, 64-8192; 512 on the main path) and sorts it in shared memory with a
// bitonic network: a key's position there is its rank within the tile.
// Every block of the cluster then takes a share of the keys outside the
// tile from device memory, coalesced, finds p = lower_bound(sorted tile, u)
// by a binary search in shared memory and adds one to hist[p] (integer
// shared-memory atomics, aggregated over the lanes of a warp that share p:
// integer sums do not depend on their order). Rank 0 adds the other ranks'
// counts through distributed shared memory, and an inclusive scan gives each
// position the number of smaller foreign keys: rank = position + that
// count. C <= tile takes one block and no foreign phase. Where the rank is
// known, in registers, rank 0 writes the select at once: out[r_i] = i for
// r_i < keep. Where the caller passes a rank buffer (tests, the rank-only
// wrapper topk_rank) the kernel writes rank[i] = r_i as well; either output
// may be null, not both. Its work is O(C^2 / tile * log tile) whatever
// keep is.
//
// Select path (topk_plan; Med-dit's keep 64 of C = n). A radix select,
// most significant digit first, over 8-bit digits of the key and then of
// the index (ties), by one thread-block cluster of up to 8 blocks of 1024
// threads, the keys in registers (up to 16 a thread; past that each block
// reads its share again from device memory every full-width pass). One SM
// issues 64 integer operations a cycle and a full-width pass costs some 20
// a key (counted from this source), so one block's passes over C = 20000
// keys take microseconds each: the cluster divides them (chip_smoke.py
// times one block beside the cluster). Each pass counts the digit of the
// keys still matching the digits chosen so far into a 256-bin shared
// histogram: a thread counts its keys' digits in registers (its two latest
// digits), since the leading digits of estimates crowd into a few bins,
// and warps add those counts together. The blocks merge their histograms
// through distributed shared memory into the same totals, and every warp
// scans them for the digit holding the keep-th key itself, so no barrier
// hands the choice on. Once that digit holds at most 2048 keys, one sweep
// moves the keys below the prefix to a wanted list and those at it to a
// candidate list, both in rank 0's shared memory, and rank 0 finishes
// alone. The radix stops once the chosen digit holds exactly the keys
// still wanted or at most 256 keys: the keys at or below the prefix, at
// most keep + 255, then each find their place by counting the smaller
// ones, and the first `keep` are written in order, without ranking every
// key. Random estimates stop after one or two passes; all-equal keys
// decide on the index bytes.
//
// Bound on an H100: the function moves 4 C + 8 keep bytes (keys in,
// indices out), under 0.1 us at C = 20000, far below the ~3 us a launch
// takes, so latency bounds every call, and both designs keep the chain of
// barriers short. The result equals torch.argsort(keys,
// stable=True)[:keep] bit for bit on both paths.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int RANK_MAX_CLUSTER = 8;

// Key i as an unsigned 32-bit value in the keys' order: an int32 key plus
// 2^31, or (F32) the float's bits under the sign flip that totalorder_keys
// (pairwise_distance.py) makes, plus 2^31.
template <bool F32>
__device__ __forceinline__ uint32_t ukey(const int32_t* __restrict__ keys, int64_t i) {
  const uint32_t b = (uint32_t)keys[i];
  if (F32) return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return b ^ 0x80000000u;
}

__device__ __forceinline__ uint64_t compose(uint32_t u, int64_t i) {
  return ((uint64_t)u << 32) | (uint64_t)(uint32_t)i;
}

// Key i has stable rank r: the rank-only output and the select.
__device__ __forceinline__ void emit(int32_t* rank, int64_t* out, int64_t keep, uint32_t i,
                                     int64_t r) {
  if (rank != nullptr) rank[i] = (int32_t)r;
  if (r < keep) out[r] = (int64_t)i;
}

// threads a block of a T-key tile
#define RANK_THREADS(T) ((T) / 2 < 1024 ? ((T) / 2 > 32 ? (T) / 2 : 32) : 1024)

// Bitonic sort of s[0, T) ascending in shared memory, NT threads each
// taking T / 2 / NT compare-exchanges a step and a barrier after each step:
// log2(T) (log2(T) + 1) / 2 steps, each moving the tile through shared
// memory. Keeping 8 keys a thread in registers, moved through shared
// memory only when a step leaves the thread or between lanes by warp
// shuffles, was slower on an H100 at every tile up to 2048 keys.
template <int T, int NT>
__device__ __forceinline__ void sort_shared(uint64_t* s) {
  for (int k = 2; k <= T; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int e = 0; e < T / 2 / NT; ++e) {
        const int t = (int)threadIdx.x + e * NT;
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo + j;
        const uint64_t a = s[lo];
        const uint64_t b = s[hi];
        if ((b < a) == ((lo & k) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Dynamic shared memory: the T sorted keys, then T counts.
template <int T>
constexpr int rank_smem() {
  return T * (int)(sizeof(uint64_t) + sizeof(int32_t));
}

template <int T, bool F32>
__global__ void __launch_bounds__(RANK_THREADS(T))
topk_rank_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ rank,
                 int64_t* __restrict__ out, int64_t n, int64_t keep) {
  constexpr int NT = RANK_THREADS(T);
  constexpr int ES = T / NT;   // positions a thread scans
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s = reinterpret_cast<uint64_t*>(smem);   // the sorted tile
  int32_t* hist = reinterpret_cast<int32_t*>(s + T);
  __shared__ int32_t warp_tot[32];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned q = cluster.block_rank();
  const unsigned Q = cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t t0 = (int64_t)(blockIdx.x / Q) * T;
  const int m = (int)(n - t0 < T ? n - t0 : T);

  // the tile's composite keys, coalesced; positions past m sort last
  for (int i = tid; i < T; i += NT) {
    s[i] = i < m ? compose(ukey<F32>(keys, t0 + i), t0 + i) : ~0ull;
    hist[i] = 0;
  }
  __syncthreads();
  sort_shared<T, NT>(s);

  if (m == n) {   // one tile: its positions are the ranks
    if (q == 0) {
      for (int pos = tid; pos < m; pos += NT) emit(rank, out, keep, (uint32_t)s[pos], pos);
    }
    return;
  }
  {   // count the keys outside the tile below each position;
      // warp-uniform trips: every lane reaches the match below
    for (int64_t j0 = (int64_t)q * NT; j0 < n; j0 += (int64_t)NT * Q) {
      const int64_t j = j0 + tid;
      const bool valid = j < n && (j < t0 || j >= t0 + m);
      int p = -1;
      if (valid) {
        const uint64_t u = compose(ukey<F32>(keys, j), j);
        p = 0;
#pragma unroll
        for (int step = T / 2; step >= 1; step >>= 1)
          if (s[p + step - 1] < u) p += step;
        p += s[p] < u;    // p = #{tile keys < u}, 0..m
        if (p >= m) p = -1;     // above every key of the tile: counts nowhere
      }
      const unsigned peers = __match_any_sync(0xffffffffu, p);
      if (p >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[p], __popc(peers));
    }
  }
  cluster.sync();   // every rank's counts are in its shared memory
  if (q == 0 && Q > 1) {
    for (int i = tid; i < m; i += NT) {
      int32_t h = hist[i];
      for (unsigned r = 1; r < Q; ++r) h += cluster.map_shared_rank(hist, r)[i];
      hist[i] = h;
    }
  }
  cluster.sync();   // rank 0 has read the others' counts
  if (q != 0) return;
  __syncthreads();

  // inclusive scan of hist over positions, ES consecutive positions a thread
  int32_t v[ES];
  int32_t run = 0;
#pragma unroll
  for (int e = 0; e < ES; ++e) {
    run += hist[tid * ES + e];
    v[e] = run;
  }
  int32_t incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_tot[tid >> 5] = incl;
  __syncthreads();
  if (tid < 32) {
    int32_t wt = tid < NT / 32 ? warp_tot[tid] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t o = __shfl_up_sync(0xffffffffu, wt, off);
      if (tid >= off) wt += o;
    }
    if (tid < NT / 32) warp_tot[tid] = wt;   // inclusive over warps
  }
  __syncthreads();
  const int32_t before = (incl - run) + ((tid >> 5) > 0 ? warp_tot[(tid >> 5) - 1] : 0);
#pragma unroll
  for (int e = 0; e < ES; ++e) {
    const int pos = tid * ES + e;
    if (pos < m) emit(rank, out, keep, (uint32_t)s[pos], pos + before + v[e]);
  }
}

template <int T, bool F32>
int launch_rank(const int32_t* keys, int32_t* rank, int64_t* out, int64_t n, int64_t keep,
                int cluster, cudaStream_t stream) {
  const int smem = rank_smem<T>();
  {   // dynamic and static shared memory above 48 KB (from T = 4096) only
      // after an opt-in, made once per kernel
    static const cudaError_t err = cudaFuncSetAttribute(
        topk_rank_kernel<T, F32>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t grid = (n + T - 1) / T * cluster;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(RANK_THREADS(T));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, topk_rank_kernel<T, F32>, keys, rank, out, n, keep);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ select path

constexpr int SEL_THREADS = 1024;
constexpr int SEL_MAX_KEEP = 1024;   // the wanted keys, placed by counting
constexpr int SEL_CAND = 2048;       // candidates rank 0 holds in shared memory
constexpr int SEL_TAIL = 256;        // keys at the prefix placed by counting
constexpr int SEL_BINS = 256;        // 8-bit digits
constexpr int SEL_BATCH = 8;         // keys a thread loads at once (ITEMS 0)
constexpr int SEL_MAX_CLUSTER = 8;

// The digits of the composite key u << 32 | i chosen so far: the prefix
// (ph, pl) under the masks (mh, ml) of its high (key) and low (index) word.
struct Prefix {
  uint32_t ph, mh, pl, ml;
  __device__ __forceinline__ bool match(uint32_t v, uint32_t i) const {
    return (v & mh) == ph && (i & ml) == pl;
  }
  // the key's chosen digits against the prefix: -1 below, 0 at it, 1 above
  __device__ __forceinline__ int side(uint32_t v, uint32_t i) const {
    const uint32_t a = v & mh, b = i & ml;
    return a != ph ? (a < ph ? -1 : 1) : (b != pl ? (b < pl ? -1 : 1) : 0);
  }
};

// The lanes of a warp holding count c > 0 of digit d add them to hist[d]:
// those sharing the first such lane's digit in one atomic, the rest one
// each. Called by all 32 lanes of a warp together.
__device__ __forceinline__ void flush(uint32_t* hist, uint32_t d, uint32_t c, int lane) {
  const unsigned act = __ballot_sync(0xffffffffu, c > 0);
  if (act == 0) return;
  const int first = __ffs(act) - 1;
  const uint32_t fd = __shfl_sync(0xffffffffu, d, first);
  const bool same = c > 0 && d == fd;
  const uint32_t sum = __reduce_add_sync(0xffffffffu, same ? c : 0u);
  if (lane == first) {
    atomicAdd(&hist[fd], sum);
  } else if (c > 0 && !same) {
    atomicAdd(&hist[d], c);
  }
}

// A thread's votes over many keys: the counts of its two latest digits in
// registers, a third digit evicting the smaller count to the histogram.
// The leading digits of estimates crowd into a few bins, so a full-width
// pass reaches shared memory a few times a thread, not once a key.
struct Tally {
  uint32_t d0 = 0, c0 = 0, d1 = 0, c1 = 0;
  __device__ __forceinline__ void add(uint32_t* hist, uint32_t d) {
    if (d == d0 && c0 > 0) {
      ++c0;
    } else if (d == d1 && c1 > 0) {
      ++c1;
    } else if (c0 <= c1) {
      if (c0 > 0) atomicAdd(&hist[d0], c0);
      d0 = d;
      c0 = 1;
    } else {
      if (c1 > 0) atomicAdd(&hist[d1], c1);
      d1 = d;
      c1 = 1;
    }
  }
  __device__ __forceinline__ void done(uint32_t* hist, int lane) {
    flush(hist, d0, c0, lane);
    flush(hist, d1, c1, lane);
  }
};

__device__ __forceinline__ uint32_t digit_of(uint32_t v, uint32_t i, bool lo, int shift) {
  return ((lo ? i : v) >> shift) & 0xffu;
}

// v[j] = key base + j * SEL_THREADS + tid (0 at or past end)
template <int R, bool F32>
__device__ __forceinline__ void load_keys(uint32_t (&v)[R], const int32_t* __restrict__ keys,
                                          uint32_t base, uint32_t end) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const uint32_t i = base + j * SEL_THREADS + threadIdx.x;
    v[j] = i < end ? ukey<F32>(keys, i) : 0u;
  }
}

// Tally the digit of each key v[j] (index base + j * SEL_THREADS + tid,
// below end) that matches the prefix; FIRST: the first pass, where every
// key does.
template <bool FIRST, int R>
__device__ __forceinline__ void tally_keys(Tally& t, uint32_t* hist, const uint32_t (&v)[R],
                                           uint32_t base, uint32_t end, const Prefix& P,
                                           bool lo, int shift) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const uint32_t i = base + j * SEL_THREADS + threadIdx.x;
    if (i < end && (FIRST || P.match(v[j], i)))
      t.add(hist, FIRST ? v[j] >> 24 : digit_of(v[j], i, lo, shift));
  }
}

// Move the keys v[j] below the prefix (and, where `all`, those at it) to
// sure[], the others at it to cand[], both in cluster rank 0's shared
// memory: the slots from one atomic a warp on rank 0's packed counter (sure
// count | candidate count << 16) and a warp scan. Called by all 32 lanes of
// a warp together.
template <int R>
__device__ __forceinline__ void compact_keys(uint64_t* sure, uint64_t* cand, uint32_t* counter,
                                             const uint32_t (&v)[R], uint32_t base,
                                             uint32_t end, const Prefix& P, bool all,
                                             int lane) {
  uint32_t ms = 0, mc = 0;   // bit j: key j is sure / a candidate
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const uint32_t i = base + j * SEL_THREADS + threadIdx.x;
    const int sd = P.side(v[j], i);
    if (i < end && (sd < 0 || (all && sd == 0))) ms |= 1u << j;
    else if (i < end && sd == 0) mc |= 1u << j;
  }
  const uint32_t mine = __popc(ms) | ((uint32_t)__popc(mc) << 16);
  uint32_t incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const uint32_t warp_tot = __shfl_sync(0xffffffffu, incl, 31);
  if (warp_tot == 0) return;
  uint32_t at = 0;
  if (lane == 31) at = atomicAdd(counter, warp_tot);
  at = __shfl_sync(0xffffffffu, at, 31) + (incl - mine);
  uint32_t s = at & 0xffffu;
  uint32_t c = at >> 16;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const uint32_t i = base + j * SEL_THREADS + threadIdx.x;
    if ((ms >> j) & 1u) {
      if (s < SEL_MAX_KEEP + SEL_TAIL) sure[s] = compose(v[j], i);
      ++s;
    } else if ((mc >> j) & 1u) {
      if (c < SEL_CAND) cand[c] = compose(v[j], i);
      ++c;
    }
  }
}

struct Choice {
  uint32_t digit, below, in_bin;
};

// The digit holding the k-th counted key in hist, found by one warp (8
// bins a lane) and known to all its lanes: every warp finds it itself, so
// no barrier hands it on.
__device__ __forceinline__ Choice choose(const uint32_t* hist, uint32_t k, int lane) {
  const uint4 a = reinterpret_cast<const uint4*>(hist)[2 * lane];
  const uint4 b = reinterpret_cast<const uint4*>(hist)[2 * lane + 1];
  const uint32_t c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t tot = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) tot += c[e];
  uint32_t incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  uint32_t below = incl - tot;
  Choice mine = {0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (below < k && k <= below + c[e]) mine = {8u * lane + e, below, c[e]};   // one bin
    below += c[e];
  }
  const int src = __ffs(__ballot_sync(0xffffffffu, mine.in_bin > 0)) - 1;
  return {__shfl_sync(0xffffffffu, mine.digit, src), __shfl_sync(0xffffffffu, mine.below, src),
          __shfl_sync(0xffffffffu, mine.in_bin, src)};
}

// The blocks' barrier: the cluster's, or the block's where it is alone.
__device__ __forceinline__ void sync_blocks(cg::cluster_group& cluster, unsigned Q) {
  if (Q > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
}

// A cluster of Q blocks of SEL_THREADS threads. Block q holds keys
// [q * span, (q + 1) * span) of the n: with ITEMS > 0, span = ITEMS *
// SEL_THREADS keys in registers (key q * span + tid + j * SEL_THREADS in
// slot j); with ITEMS == 0 each full-width pass reads its span again from
// device memory, SEL_BATCH keys a thread at a time. The full-width passes
// run on every block, each merging the Q histograms through distributed
// shared memory into the same totals and so the same choice. Once the
// chosen digit holds at most SEL_CAND keys, one sweep moves the wanted keys
// and the candidates into rank 0's shared memory, and rank 0 finishes
// alone. The radix stops once the chosen digit holds exactly the keys still
// wanted or at most SEL_TAIL keys: every key at or below the prefix then
// joins the wanted list, and counting places its first keep. The select's
// state (the prefix and k, the keys still wanted among those at it) is the
// same in every thread of the cluster. Pass p counts into hist[p % 3] and
// clears hist[(p + 1) % 3], which every warp of every block last read two
// barriers before.
template <int ITEMS, bool F32>
__global__ void __launch_bounds__(SEL_THREADS, 1)
topk_select_kernel(const int32_t* __restrict__ keys, int64_t* __restrict__ out, int64_t n64,
                   int64_t keep, int64_t span64) {
  __shared__ __align__(16) uint32_t hist[3][SEL_BINS];
  __shared__ __align__(16) uint32_t tot[SEL_BINS];
  __shared__ uint32_t counter;         // wanted | candidates << 16 (rank 0)
  __shared__ uint32_t ntail;
  __shared__ uint64_t sure[SEL_MAX_KEEP + SEL_TAIL];
  __shared__ uint64_t cand[SEL_CAND];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned q = cluster.block_rank();
  const unsigned Q = cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const uint32_t n = (uint32_t)n64;
  const uint32_t span = (uint32_t)span64;
  const uint32_t lo_i = q * span;
  // this block's keys: [lo_i, hi_i)
  const uint32_t hi_i = lo_i >= n ? lo_i : (n - lo_i < span ? n : lo_i + span);
  constexpr int R = ITEMS > 0 ? ITEMS : SEL_BATCH;
  uint32_t u[R];

  if (tid < SEL_BINS) hist[0][tid] = 0;
  if (tid == 0) counter = 0;   // rank 0's: first read past a cluster barrier
  if (ITEMS > 0) load_keys<R, F32>(u, keys, lo_i, hi_i);
  __syncthreads();

  // the index bytes that can differ: those of n - 1 (n >= 2 reaches them)
  const int top_lo = n > 1 ? (31 - __clz(n - 1)) / 8 : 0;
  Prefix P = {0u, 0u, 0u, 0u};
  uint32_t k = (uint32_t)keep;
  bool compact = false;   // rank 0 alone, on the candidates
  uint32_t ncand = 0;
  uint64_t* const sure0 = Q > 1 ? cluster.map_shared_rank(sure, 0) : sure;
  uint32_t* const ctr0 = Q > 1 ? cluster.map_shared_rank(&counter, 0) : &counter;
  uint64_t* const cand0 = Q > 1 ? cluster.map_shared_rank(cand, 0) : cand;
  for (int p = 0;; ++p) {
    const bool lo = p >= 4;              // a digit of the index (ties)
    const int shift = lo ? 8 * (top_lo - (p - 4)) : 8 * (3 - p);
    uint32_t* h = hist[p % 3];
    if (tid >= SEL_THREADS - SEL_BINS) hist[(p + 1) % 3][tid - (SEL_THREADS - SEL_BINS)] = 0;
    Choice ch;
    if (compact) {   // block-uniform trips: every lane reaches the flush
      for (uint32_t c0 = 0; c0 < ncand; c0 += SEL_THREADS) {
        const uint32_t c = c0 + tid;
        const uint64_t x = c < ncand ? cand[c] : 0ull;
        const uint32_t v = (uint32_t)(x >> 32), i = (uint32_t)x;
        const bool m = c < ncand && P.match(v, i);
        flush(h, digit_of(v, i, lo, shift), m ? 1u : 0u, lane);
      }
      __syncthreads();
      ch = choose(h, k, lane);
    } else {
      Tally t;
      if (ITEMS > 0) {
        if (p == 0) tally_keys<true>(t, h, u, lo_i, hi_i, P, lo, shift);
        else tally_keys<false>(t, h, u, lo_i, hi_i, P, lo, shift);
      } else {
        for (uint32_t j0 = lo_i; j0 < hi_i; j0 += R * SEL_THREADS) {
          load_keys<R, F32>(u, keys, j0, hi_i);
          if (p == 0) tally_keys<true>(t, h, u, j0, hi_i, P, lo, shift);
          else tally_keys<false>(t, h, u, j0, hi_i, P, lo, shift);
        }
      }
      t.done(h, lane);
      sync_blocks(cluster, Q);   // every block's histogram is complete
      if (Q > 1) {
        if (tid < SEL_BINS) {   // the cluster's totals, summed in rank order
          uint32_t s = 0;
#pragma unroll
          for (unsigned r = 0; r < SEL_MAX_CLUSTER; ++r)
            if (r < Q) s += cluster.map_shared_rank(h, r)[tid];
          tot[tid] = s;
        }
        __syncthreads();
        ch = choose(tot, k, lane);
      } else {
        ch = choose(h, k, lane);
      }
    }
    k -= ch.below;
    if (lo) {
      P.pl |= ch.digit << shift;
      P.ml |= 0xffu << shift;
    } else {
      P.ph |= ch.digit << shift;
      P.mh |= 0xffu << shift;
    }
    // stop: the wanted keys are the first keep of those at or below the
    // prefix, few enough to place by counting (distinct composite keys get
    // there by the last index byte)
    const bool stop = ch.in_bin == k || ch.in_bin <= SEL_TAIL || p == 4 + top_lo;
    if (!compact && (stop || ch.in_bin <= SEL_CAND)) {
      // one sweep over all keys: below the prefix to sure[], at it to
      // sure[] (stop) or to the candidates, in rank 0
      if (ITEMS > 0) {
        compact_keys(sure0, cand0, ctr0, u, lo_i, hi_i, P, stop, lane);
      } else {
        for (uint32_t j0 = lo_i; j0 < hi_i; j0 += R * SEL_THREADS) {
          load_keys<R, F32>(u, keys, j0, hi_i);
          compact_keys(sure0, cand0, ctr0, u, j0, hi_i, P, stop, lane);
        }
      }
      sync_blocks(cluster, Q);   // rank 0 holds them all; no block reads another's
      if (q != 0) return;
      compact = true;
      ncand = counter >> 16;
    }
    if (stop) break;
  }

  // the candidates at or below the final prefix join the wanted list
  const uint32_t nsure = counter & 0xffffu;
  if (tid == 0) ntail = 0;
  __syncthreads();
  for (uint32_t c0 = 0; c0 < ncand; c0 += SEL_THREADS) {
    const uint32_t c = c0 + tid;
    const uint64_t x = c < ncand ? cand[c] : 0ull;
    const bool m = c < ncand && P.side((uint32_t)(x >> 32), (uint32_t)x) <= 0;
    const unsigned act = __ballot_sync(0xffffffffu, m);
    if (act == 0) continue;
    uint32_t at = 0;
    if (lane == __ffs(act) - 1) at = atomicAdd(&ntail, (uint32_t)__popc(act));
    at = nsure + __shfl_sync(0xffffffffu, at, __ffs(act) - 1) + __popc(act & ((1u << lane) - 1u));
    if (m && at < SEL_MAX_KEEP + SEL_TAIL) sure[at] = x;
  }
  __syncthreads();

  // each listed key's place: the listed keys below it, counted by a group
  // of g lanes of one warp, m / g keys a lane (g * m <= 1024, or one lane
  // for each of several keys); the first keep are the output
  const int m = (int)(nsure + ntail);
  int g = 32;
  while (g > 1 && m * g > SEL_THREADS) g >>= 1;
  const int r = tid % g;
  for (int e0 = 0; e0 < m; e0 += SEL_THREADS / g) {   // block-uniform trips
    const int e = e0 + tid / g;
    const uint64_t me = e < m ? sure[e] : 0ull;
    uint32_t cnt = 0;
    if (e < m) {
      for (int f = r; f < m; f += g) cnt += sure[f] < me;
    }
    for (int off = g / 2; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    if (r == 0 && e < m && cnt < keep) out[cnt] = (int64_t)(uint32_t)me;
  }
}

template <int ITEMS, bool F32>
int launch_select(const int32_t* keys, int64_t* out, int64_t n, int64_t keep, int cluster,
                  cudaStream_t stream) {
  const int64_t span = ITEMS > 0 ? (int64_t)ITEMS * SEL_THREADS : (n + cluster - 1) / cluster;
  if ((int64_t)cluster * span < n) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3(SEL_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, topk_select_kernel<ITEMS, F32>, keys, out, n, keep, span);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool F32>
int dispatch(const int32_t* keys, int32_t* rank, int64_t* out, int64_t n, int64_t keep,
             int path, int tile, int cluster, cudaStream_t stream) {
  if (path == 1) {   // select: tile is the keys a thread holds (0: none)
    if (rank != nullptr || cluster < 1 || cluster > SEL_MAX_CLUSTER || keep < 1 ||
        keep > SEL_MAX_KEEP)
      return (int)cudaErrorInvalidValue;
    switch (tile) {
      case 0: return launch_select<0, F32>(keys, out, n, keep, cluster, stream);
      case 1: return launch_select<1, F32>(keys, out, n, keep, cluster, stream);
      case 2: return launch_select<2, F32>(keys, out, n, keep, cluster, stream);
      case 3: return launch_select<3, F32>(keys, out, n, keep, cluster, stream);
      case 4: return launch_select<4, F32>(keys, out, n, keep, cluster, stream);
      case 6: return launch_select<6, F32>(keys, out, n, keep, cluster, stream);
      case 8: return launch_select<8, F32>(keys, out, n, keep, cluster, stream);
      case 12: return launch_select<12, F32>(keys, out, n, keep, cluster, stream);
      case 16: return launch_select<16, F32>(keys, out, n, keep, cluster, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (path != 0 || cluster < 1 || cluster > RANK_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 64: return launch_rank<64, F32>(keys, rank, out, n, keep, cluster, stream);
    case 128: return launch_rank<128, F32>(keys, rank, out, n, keep, cluster, stream);
    case 256: return launch_rank<256, F32>(keys, rank, out, n, keep, cluster, stream);
    case 512: return launch_rank<512, F32>(keys, rank, out, n, keep, cluster, stream);
    case 1024: return launch_rank<1024, F32>(keys, rank, out, n, keep, cluster, stream);
    case 2048: return launch_rank<2048, F32>(keys, rank, out, n, keep, cluster, stream);
    case 4096: return launch_rank<4096, F32>(keys, rank, out, n, keep, cluster, stream);
    case 8192: return launch_rank<8192, F32>(keys, rank, out, n, keep, cluster, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// (path, tile, cluster) come from topk_plan (pairwise_distance.py).
// path 0, the sort: tile a power of two in [64, 8192], cluster in [1, 8],
// grid ceil(n / tile) * cluster blocks of min(tile / 2, 1024) threads; `out`
// takes the first `keep` indices of the stable order (null where keep is
// 0), `rank` the ranks of all n keys (or null). path 1, the select: one
// cluster of `cluster` (1-8) blocks of 1024 threads; tile the keys a thread
// holds in registers (1, 2, 3, 4, 6, 8, 12 or 16, with n <= cluster * 1024
// tile), or 0 for none (any n, each block reading its share again every
// full-width pass); 1 <= keep <= 1024, no rank. f32: the keys are float32
// estimates.
extern "C" int topk_smallest_launch(const int32_t* keys, int32_t* rank, int64_t* out,
                                    long long n, long long keep, int path, int tile,
                                    int cluster, int f32, cudaStream_t stream) {
  if (n < 1 || n > 0x7fffffffLL || keep < 0 || keep > n ||
      (keep > 0) != (out != nullptr) || (rank == nullptr && out == nullptr))
    return (int)cudaErrorInvalidValue;
  return f32 ? dispatch<true>(keys, rank, out, n, keep, path, tile, cluster, stream)
             : dispatch<false>(keys, rank, out, n, keep, path, tile, cluster, stream);
}
