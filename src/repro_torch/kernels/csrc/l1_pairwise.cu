// Pairwise l1 distances: D[c, r] = sum_k |x[c,k] - y[r,k]|, a (C, R) fp32
// block.
//
// Replaces the TPU kernel l1_pairwise / _l1_pairwise_kernel in
// src/repro/kernels/pairwise_distance.py. l1 has no matmul form: one
// subtract, one absolute value and one add per (c, r, k) element on the CUDA
// cores, which nvcc issues as two FADDs (a - b, then acc + |t|: the absolute
// value is an operand modifier), as cuobjdump -sass of the tile path shows.
//
// Bound on an H100: the call moves 4 * (C d + R d + C R) bytes and issues
// 2 C R d fp32 instructions, 4 C R d operations at the fp32 rate that
// counts an FFMA as 2. The k-medoids shapes are skinny, and the bytes or the
// launch latency bound each class:
//  * (n, k <= 10) caches, (1, n) rows and the outer halving rounds: the
//    bytes of the long operand (81.9 MB, 24.5 us, for a (1, 20000) row at
//    d = 1024). The stream path of pairwise_tile.cuh reads them once,
//    16 bytes a lane, against short rows held in shared memory.
//  * the middle rounds, where both sides exceed the crossover S: latency.
//    The tile path splits d across a thread-block cluster so that a round
//    of 25 output tiles still runs on 100-160 SMs, and sums the partial
//    tiles through distributed shared memory in rank order.
#include "pairwise_tile.cuh"

extern "C" int l1_pairwise_launch(const float* x, const float* y, float* out,
                                  long long C, long long R, long long d,
                                  int path, int grid, int splits,
                                  cudaStream_t stream) {
  return pairwise::launch<pairwise::L1Pair>(x, y, out, nullptr, C, R, d, path, grid, splits,
                                            stream);
}
