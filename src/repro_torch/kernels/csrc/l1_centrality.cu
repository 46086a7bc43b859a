// Fused l1 centrality: S[c] = sum_r w[r] * sum_k |x[c,k] - y[r,k]|.
//
// Replaces the TPU kernel l1_centrality / _l1_centrality_kernel in
// src/repro/kernels/pairwise_distance.py. l1 has no matmul form, so this is
// CUDA-core work: one subtract, one absolute value and one add per (c, r, k)
// element, which nvcc issues as two FADDs (a - b, then acc + |t|: the
// absolute value is an operand modifier; cuobjdump -sass of the tile path),
// with the reference weight multiplied in before the row sum. The (C, R)
// block never reaches device memory.
//
// Bound on an H100: each round moves (C + R) * d * 4 bytes and issues
// 2 * C * R * d fp32 instructions, 4 * C * R * d operations at the fp32 rate
// that counts an FFMA as 2. One correlated-SH run goes from (n, 2) to (2, n)
// with ~20k-40k pairs a round, so the bytes of the long operand bound the
// skinny rounds at either end (328 MB, 98 us, for a (20000, 2) round at
// d = 4096), which hold most of a run's bound, and latency the middle ones.
// A fixed square tile wastes up to 63/64 of its work on the skinny rounds
// and leaves most SMs idle on the middle ones, so the wrapper picks one of
// the two paths of pairwise_tile.cuh (centrality_plan in
// pairwise_distance.py; S_c = its crossover) with a centrality epilogue:
//
//  * stream path, min(C, R) <= S_c: the short rows sit in shared memory and
//    warps stream the long operand once, 16 bytes a lane. With R short the
//    lanes weight their row's distances and a shuffle tree writes S[c]; with
//    C short each lane keeps its candidate's weighted sum over the warp's
//    rows, the block sums its warps in order into a (grid, C) partial, and
//    a second pass sums the grid in a fixed order.
//  * tile path, both sides > S_c: the cluster-split 32 x 32 tile; rank 0
//    weights the complete tile, sums its rows into an (r-tiles, C) partial,
//    and the second pass sums the r-tiles.
//
// Full fp32, d summed in groups of at most 256 columns, no atomics: two
// launches are bit-equal. The arguments (path, grid, splits) come from
// centrality_plan; `scratch` (C * R floats) holds the running d sums where
// the stream path takes several d slabs, `partial` the rows of the second
// pass (pairwise::centrality_rows); either may be null where unused.
#include "pairwise_tile.cuh"

namespace {

struct L1Op : pairwise::L1Pair {
  static __device__ __forceinline__ float finish(float s, float, float) {
    return s;
  }
};

}  // namespace

extern "C" int l1_centrality_launch(const float* x, const float* y,
                                    const float* w, float* scratch,
                                    float* partial, float* out, long long C,
                                    long long R, long long d, int path,
                                    int grid, int splits,
                                    cudaStream_t stream) {
  return pairwise::launch_centrality<L1Op>(x, y, nullptr, nullptr, w, scratch, partial, out, C,
                                           R, d, path, grid, splits, stream);
}
