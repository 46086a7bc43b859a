// Pairwise inner products: G[c, r] = sum_k x[c,k] * y[r,k], a (C, R) fp32
// block.
//
// Replaces the TPU kernel dot_pairwise / _dot_kernel in
// src/repro/kernels/pairwise_distance.py. The metric epilogues (sql2, l2,
// cosine) stay outside, in repro_torch/kernels/ops.py, as in
// repro/kernels/ops.py.
//
// Bound on an H100: the call moves 4 * (C d + R d + C R) bytes and does
// 2 C R d flops. On the k-medoids path the bytes or the launch latency bound
// every shape; on the live corpora's bootstrap the flops do:
//  * (n, k <= 10) assignment caches, (1, n) BUILD d1 rows and SWAP
//    verifications, and the outer halving rounds, (n, 1) to (n / 16, 17)
//    and (20, ~n / 20) to (2, n) at 16 pulls per arm: the bytes of the
//    long operand (62.7 MB, 18.7 us, for a (1, 20000) row at d = 784). The
//    stream path of pairwise_tile.cuh reads them once, 16 bytes a lane,
//    against short rows held in shared memory.
//  * the middle rounds, (625, 34) to (40, 533) at 16 pulls per arm:
//    a few MB each, so latency. The tile path splits d across a cluster of
//    blocks to put 100-160 blocks on the 132 SMs and sums the partial
//    tiles through distributed shared memory.
//  * the bootstrap square of a live corpus, (32768, 32768, 784): 1.68
//    TFLOP, 25.1 ms at the fp32 rate, against 0.21 GB of operands and 4.3 GB
//    of block (1.3 ms). The gemm path (where the shape fills GEMM_FILL of
//    its tile slots, pairwise_distance.py) sums 128 x 128 tiles with 8 x 8
//    FFMA a thread.
//  * the embedding rows of the LM scaffold, (C, R, d = 32000-92544) at the
//    k-medoids shapes: bytes, but the unsplit plan gives their rounds 3-32
//    blocks. The d split of the stream and tile paths (fp32 only, where the
//    unsplit plan leaves SMs idle) puts ranks of blocks along d, each
//    writing its partial Gram to a (ranks, C, R) scratch that a second
//    launch sums in rank order.
// Full fp32 FFMA on every path: a TF32 Gram keeps about three decimal
// digits, which the fp32 mode's contract (and the sql2 and l2 epilogues'
// cancellation at near pairs) does not allow, so even the flop-bound gemm
// path stays off the tensor cores.
//
// dtype 1 is the TPU kernel's compute_dtype=bfloat16 mode: both operands
// rounded to bf16 once where they are staged (pairwise::Bf16GramPair), fp32
// sums; the stream path does the fp32 mode's FFMAs on the rounded values,
// the tile path multiplies on the tensor cores (see dot_centrality.cu); it
// has no gemm path. No path of the JAX package or of the port calls it.
#include "pairwise_tile.cuh"

// `scratch`: the d split's (splits, C, R) partial Grams, or null.
extern "C" int dot_pairwise_launch(const float* x, const float* y, float* out,
                                   float* scratch, long long C, long long R,
                                   long long d, int dtype, int path, int grid,
                                   int splits, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return pairwise::launch<pairwise::GramPair>(x, y, out, scratch, C, R, d, path, grid,
                                                  splits, stream);
    case 1:
      return pairwise::launch<pairwise::Bf16GramPair>(x, y, out, scratch, C, R, d, path, grid,
                                                      splits, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
