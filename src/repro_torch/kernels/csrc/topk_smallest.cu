// Survivor ordering: the stable ascending order of C int32 total-order keys.
//
// Replaces the TPU kernel pair topk_smallest in
// src/repro/kernels/pairwise_distance.py: _topk_rank_kernel and
// _topk_select_kernel. The caller (repro_torch/kernels/ops.py) bitcasts the
// float estimates to IEEE-totalorder int32 keys, so integer comparison
// orders them like lax.top_k, -0.0 < +0.0 and +inf included.
//
//  * rank:   rank[i] = #{j : v[j] < v[i] or (v[j] == v[i] and j < i)}.
//            One thread per i; key tiles of RANK_TILE are staged in shared
//            memory and every thread compares against all of them. O(C^2)
//            work, about 4e8 comparisons at C = 20000. The strict total order
//            makes rank a permutation of [0, C).
//  * select: out[rank[i]] = i for rank[i] < keep, a scatter.
//
// Bound on an H100: the bytes are tiny (4 C in, 4 C + 8 keep out), so the
// C^2 comparisons bound it. The result equals torch.argsort(keys,
// stable=True)[:keep] bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RANK_THREADS = 128;
constexpr int RANK_TILE = 1024;
constexpr int SELECT_THREADS = 256;

__global__ void __launch_bounds__(RANK_THREADS)
topk_rank_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ rank,
                 int32_t n) {
  __shared__ int32_t tile[RANK_TILE];
  const int32_t i = blockIdx.x * RANK_THREADS + threadIdx.x;
  const int32_t vi = i < n ? keys[i] : 0;
  int32_t count = 0;
  for (int32_t j0 = 0; j0 < n; j0 += RANK_TILE) {
    const int32_t m = min(RANK_TILE, n - j0);
    for (int t = threadIdx.x; t < m; t += RANK_THREADS) tile[t] = keys[j0 + t];
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < m; ++t) {
      const int32_t vj = tile[t];
      count += (vj < vi) | ((vj == vi) & (j0 + t < i));
    }
    __syncthreads();
  }
  if (i < n) rank[i] = count;
}

__global__ void topk_select_kernel(const int32_t* __restrict__ rank,
                                   int64_t* __restrict__ out, int32_t n,
                                   int32_t keep) {
  const int32_t i = blockIdx.x * SELECT_THREADS + threadIdx.x;
  if (i >= n) return;
  const int32_t r = rank[i];
  if (r < keep) out[r] = i;
}

}  // namespace

extern "C" int topk_rank_launch(const int32_t* keys, int32_t* rank, int n,
                                cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + RANK_THREADS - 1) / RANK_THREADS);
  topk_rank_kernel<<<blocks, RANK_THREADS, 0, stream>>>(keys, rank, n);
  return (int)cudaGetLastError();
}

extern "C" int topk_select_launch(const int32_t* rank, int64_t* out, int n,
                                  int keep, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + SELECT_THREADS - 1) / SELECT_THREADS);
  topk_select_kernel<<<blocks, SELECT_THREADS, 0, stream>>>(rank, out, n, keep);
  return (int)cudaGetLastError();
}
