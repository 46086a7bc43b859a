// Survivor ordering: the first `keep` indices of the stable ascending order
// of C int32 total-order keys, in one launch.
//
// Replaces the TPU kernel pair topk_smallest in
// src/repro/kernels/pairwise_distance.py: _topk_rank_kernel and
// _topk_select_kernel, which this one kernel computes together. The caller
// (repro_torch/kernels/ops.py) bitcasts the float estimates to
// IEEE-totalorder int32 keys, so integer comparison orders them like
// lax.top_k, -0.0 < +0.0 and +inf included.
//
// A tiled sort gives each key its stable rank
//   r_i = #{j : v[j] < v[i] or (v[j] == v[i] and j < i)}.
// The composite keys u_i = (v_i + 2^31) << 32 | i are distinct uint64s, so
// the stable rank is #{j : u_j < u_i}, which any sorting network gives. Each
// thread-block cluster owns a tile of at most `tile` keys (a power of two,
// 64-8192; 512 on the main path) and sorts it in shared memory with a
// bitonic network: a key's position there is its rank within the tile.
// Every block of the cluster then takes a share of the keys outside the
// tile from device memory, coalesced, finds p = lower_bound(sorted tile, u)
// by a binary search in shared memory and adds one to hist[p] (integer
// shared-memory atomics, aggregated over the lanes of a warp that share p:
// integer sums do not depend on their order). Rank 0 adds the other ranks'
// counts through distributed shared memory, and an inclusive scan gives each
// position the number of smaller foreign keys: rank = position + that
// count. C <= tile takes one block and no foreign phase. The strict total
// order makes the ranks a permutation of [0, C).
//
// Where the rank is known, in registers, rank 0 writes the select at once:
// out[r_i] = i for r_i < keep. So the rank never reaches device memory on
// the main path (ops.kernel_topk_smallest, keep = C every round), and one
// launch does what the TPU kernels' two did. Where the caller passes a rank
// buffer (tests, the rank-only wrapper topk_rank) the kernel writes
// rank[i] = r_i as well; either output may be null, not both.
//
// Bound on an H100: the function moves 4 C + 8 keep bytes (keys in,
// indices out), under 0.1 us at C = 20000, far below the ~3 us a launch
// takes, so latency bounds every call. The design keeps that latency short:
// the work is O(C^2 / tile * log tile) in all, spread over tiles x cluster
// blocks (topk_rank_plan in pairwise_distance.py), and the tile's sort sets
// the time of a call. The result equals torch.argsort(keys,
// stable=True)[:keep] bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int RANK_MAX_CLUSTER = 8;

__device__ __forceinline__ uint64_t compose(int32_t key, int64_t i) {
  return ((uint64_t)((uint32_t)key ^ 0x80000000u) << 32) | (uint64_t)(uint32_t)i;
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

template <int T>
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
    s[i] = i < m ? compose(keys[t0 + i], t0 + i) : ~0ull;
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
        const uint64_t u = compose(keys[j], j);
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

template <int T>
int launch_rank(const int32_t* keys, int32_t* rank, int64_t* out, int64_t n, int64_t keep,
                int cluster, cudaStream_t stream) {
  const int smem = rank_smem<T>();
  {   // dynamic and static shared memory above 48 KB (from T = 4096) only
      // after an opt-in, made once per kernel
    static const cudaError_t err = cudaFuncSetAttribute(
        topk_rank_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, topk_rank_kernel<T>, keys, rank, out, n, keep);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// tile and cluster come from topk_rank_plan (pairwise_distance.py): tile a
// power of two in [64, 8192], cluster in [1, 8], grid ceil(n / tile) *
// cluster blocks of min(tile / 2, 1024) threads. `out` takes the first
// `keep` indices of the stable order (null where keep is 0), `rank` the
// ranks of all n keys (or null).
extern "C" int topk_smallest_launch(const int32_t* keys, int32_t* rank, int64_t* out,
                                    long long n, long long keep, int tile, int cluster,
                                    cudaStream_t stream) {
  if (n < 1 || cluster < 1 || cluster > RANK_MAX_CLUSTER || keep < 0 || keep > n ||
      (keep > 0) != (out != nullptr) || (rank == nullptr && out == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 64: return launch_rank<64>(keys, rank, out, n, keep, cluster, stream);
    case 128: return launch_rank<128>(keys, rank, out, n, keep, cluster, stream);
    case 256: return launch_rank<256>(keys, rank, out, n, keep, cluster, stream);
    case 512: return launch_rank<512>(keys, rank, out, n, keep, cluster, stream);
    case 1024: return launch_rank<1024>(keys, rank, out, n, keep, cluster, stream);
    case 2048: return launch_rank<2048>(keys, rank, out, n, keep, cluster, stream);
    case 4096: return launch_rank<4096>(keys, rank, out, n, keep, cluster, stream);
    case 8192: return launch_rank<8192>(keys, rank, out, n, keep, cluster, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
