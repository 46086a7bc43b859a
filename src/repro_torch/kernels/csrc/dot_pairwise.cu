// Pairwise inner products: G[c, r] = sum_k x[c,k] * y[r,k], a (C, R) fp32
// block.
//
// Replaces the TPU kernel dot_pairwise / _dot_kernel in
// src/repro/kernels/pairwise_distance.py. The metric epilogues (sql2, l2,
// cosine) stay outside, in repro_torch/kernels/ops.py, as in
// repro/kernels/ops.py.
//
// Bound on an H100: the call moves 4 * (C d + R d + C R) bytes and does
// 2 C R d flops. On the k-medoids path every shape is skinny: the BUILD and
// SWAP rounds run from (n, 1-2) to (2-3, n), the assignment cache is (n, k)
// with k <= 10, and each BUILD d1 row and SWAP verification is (1, n). All
// of them are bound by the bytes of the long operand. This first version
// keeps the 64 x 64 FFMA tile of centrality_tile.cuh (full fp32, no TF32: a
// TF32 Gram keeps about three decimal digits, and the d sum in groups of 256
// columns for the accuracy the centrality kernels needed) and writes the
// tile instead of reducing it. On a (1, n) row it wastes 63 of every 64
// multiply-adds; a shape-adaptive tile is later work.
#include "centrality_tile.cuh"

extern "C" int dot_pairwise_launch(const float* x, const float* y, float* out,
                                   long long C, long long R, long long d,
                                   cudaStream_t stream) {
  return centrality::launch_pairwise<centrality::GramPair>(x, y, out, C, R, d, stream);
}
