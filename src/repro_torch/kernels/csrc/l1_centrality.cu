// Fused l1 centrality: S[c] = sum_{r valid} w[r] * sum_k |x[c,k] - y[r,k]|.
//
// Replaces the TPU kernel l1_centrality / _l1_centrality_kernel in
// src/repro/kernels/pairwise_distance.py. l1 has no matmul form, so this is
// CUDA-core work: one subtract, one absolute value and one add per (c, r, k)
// element, with the reference weight multiplied in before the row sum. The
// (C, R) block never reaches device memory.
//
// Bound on an H100: each round moves (C + R) * d * 4 bytes and does
// 3 * C * R * d operations. Every round holds ~40k pulls, so the bytes bound
// the early and late rounds (C or R near n: 328 MB at n = 20000,
// d = 4096), which hold most of a run's bound, and the operations bound the
// middle rounds. The tiling and the deterministic split over R are shared
// with dot_centrality.cu (centrality_tile.cuh).
#include "centrality_tile.cuh"

namespace {

struct L1Op {
  static __device__ __forceinline__ float pair(float acc, float a, float b) {
    return acc + fabsf(a - b);
  }
  static __device__ __forceinline__ float finish(float s, float, float) {
    return s;
  }
};

}  // namespace

extern "C" int l1_centrality_launch(const float* x, const float* y,
                                    const float* w, float* partial,
                                    float* out, long long C, long long R,
                                    long long d, int splits,
                                    cudaStream_t stream) {
  return centrality::launch<L1Op>(x, y, nullptr, nullptr, w, partial, out, C, R, d, splits, stream);
}
