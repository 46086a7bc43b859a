// Pairwise l1 distances: D[c, r] = sum_k |x[c,k] - y[r,k]|, a (C, R) fp32
// block.
//
// Replaces the TPU kernel l1_pairwise / _l1_pairwise_kernel in
// src/repro/kernels/pairwise_distance.py. l1 has no matmul form: one
// subtract, one absolute value and one add per (c, r, k) element on the CUDA
// cores.
//
// Bound on an H100: the call moves 4 * (C d + R d + C R) bytes and does
// 3 C R d operations. The k-medoids shapes are skinny ((n, 1-2) to
// (2-3, n) rounds, the (n, k) assignment cache, (1, n) rows), so the bytes
// of the long operand bound every one of them. The tile, the grouped d sum
// and the one-dimensional grid are those of centrality_tile.cuh; the tile
// is written to the output instead of reduced. A 64 x 64 tile wastes up to
// 64x of its arithmetic on a (1, n) row.
#include "centrality_tile.cuh"

extern "C" int l1_pairwise_launch(const float* x, const float* y, float* out,
                                  long long C, long long R, long long d,
                                  cudaStream_t stream) {
  return centrality::launch_pairwise<centrality::L1Pair>(x, y, out, C, R, d, stream);
}
