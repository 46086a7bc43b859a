// Fused Gram-metric centrality: S[c] = sum_r w[r] * f(x_c . y_r).
//
// Replaces the TPU kernel dot_centrality / _dot_centrality_kernel in
// src/repro/kernels/pairwise_distance.py. The finish f is applied to the
// complete fp32 dot over d (a sqrt does not commute with the d sum):
//   sql2:   max(|x|^2 + |y|^2 - 2 g, 0)
//   l2:     sqrt of sql2
//   cosine: 1 - g, on rows the caller normalised to unit length.
// Squared norms and the unit-row normalisation stay outside the kernel, as
// in repro/kernels/ops.py, and reach the finish as the Sink's xaux / yaux
// (null for cosine). The (C, R) block never reaches device memory.
//
// Bound on an H100: each round moves (C + R) * d * 4 bytes and does
// 2 * C * R * d flops. One correlated-SH run goes from (n, 2) to (2, n)
// with ~20k-40k pairs a round, so the bytes of the long operand bound the
// skinny rounds at either end (62.7 MB, 18.7 us, for a (20000, 2) round at
// d = 784), which hold most of a run's bound, and latency the middle ones;
// the k-medoids refinement's masked rounds (buckets of 1024-8192 rows)
// move a few MB and are bound by latency. The live corpora's exact re-runs
// are the other kind: a masked (32768, 32768, 784) square is 1.68 TFLOP,
// 25.1 ms at the fp32 rate, and its 0.21 GB of rows take 63 us. A fixed
// square tile wastes up to 63/64 of its FMAs on the skinny rounds and
// leaves most SMs idle on the small ones, and the latency tile runs the
// squares at a quarter of the fp32 rate, so the wrapper picks one of the
// three paths of pairwise_tile.cuh (centrality_plan in pairwise_distance.py;
// S_c = its crossover, F = GEMM_FILL, the fill of gemm_fill) with a
// centrality epilogue:
//
//  * stream path, min(C, R) <= S_c: the short rows sit in shared memory and
//    warps stream the long operand once, 16 bytes a lane. Where the short
//    rows exceed the block's 112 KB (netflix's 16 and 20 rows at d = 2048)
//    they are staged in d slabs, the running d sums kept in a C x R scratch
//    and f applied at the last slab only. With R short the lanes weight
//    their row's distances and a shuffle tree writes S[c]; with C short each
//    lane keeps its candidate's weighted sum over the warp's rows, the block
//    sums its warps in order into a (grid, C) partial, and a second pass
//    sums the grid in a fixed order.
//  * tile path, both sides > S_c and a fill below F: the cluster-split 32 x 32
//    tile; rank 0 applies f to the complete tile the cluster has summed,
//    weights it, sums its rows into an (r-tiles, C) partial, and the second
//    pass sums the r-tiles.
//  * gemm path, dtype 0 only, both sides > S_c, fill >= F: a persistent
//    grid of 128 x 128 tiles, 8 x 8 FFMA sums a thread over all of d; each
//    thread applies f to its complete sums, weights them and sums its
//    columns, a shuffle tree and a second warp sum each row's 128 columns
//    in a fixed order into an (r-tiles, C) partial, and the second pass
//    sums the r-tiles. Bound: the flops at the fp32 rate.
//  * the d split, dtype 0 only, where the stream or tile plan leaves SMs
//    idle on rows tens of thousands wide (the LM embeddings' d = 32000-
//    92544, whose rounds got 3-32 blocks): ranks of blocks along d write
//    their partial Grams to a (ranks, C, R) scratch; a second launch sums
//    each pair's partials in rank order, applies f to the complete sum and
//    sums the weighted rows in a fixed order, a block a row. Bound: the
//    operands' bytes.
//
// The fp32 mode's Gram is plain fp32 FFMA on the CUDA cores on every path,
// the flop-bound gemm path too: a TF32 Gram keeps about three decimal digits
// and can flip the halving on near-ties. d is summed in groups of at most
// 256 columns, no atomics: two launches are bit-equal. The arguments (path,
// grid, splits) come from centrality_plan; `scratch` (C * R floats) holds
// the running d sums where the stream path takes several d slabs (splits *
// C * R partial Grams with the d split), `partial`
// the rows of the second pass (pairwise::centrality_rows); either may be
// null where unused.
//
// dtype 1 is the TPU kernel's compute_dtype=bfloat16 mode, the centrality
// of the quantized path (quant_bf16_fused): the same kernels with
// pairwise::Bf16GramPair. The rows are read as fp32, the norms of the
// unrounded rows reach the finish, and the sums and the finish stay fp32.
// Each operand value is rounded to bf16 once, where it is staged, never at
// a product:
//  * stream path: the short rows in shared memory after each slab lands,
//    each long value in registers right after its load. The path then does
//    the fp32 mode's FFMAs in the fp32 mode's order on rounded values, so it
//    is bit-equal to dtype 0 on rows rounded beforehand, and as fast.
//  * tile path: each slab that lands is rounded into bf16 slabs in shared
//    memory, and the 32 x 32 tile's Gram runs on the tensor cores
//    (mma.sync m16n8k16, bf16 in, fp32 out; the product of two bf16 values
//    is exact in fp32), one fragment a warp, each 16-column product added to
//    fp32 group sums of at most 256 columns. It beats the stream path from
//    about 12 short rows on, so the bf16 mode crosses over there
//    (DOT_CENTRALITY_BF16_S in pairwise_distance.py; 24 for dtype 0). The
//    bf16 mode has no gemm path.
// What bounds it is what bounds dtype 0: the bytes of the fp32 rows it reads
// on the skinny rounds, latency on the middle ones; the function's bytes
// and bound are those of dtype 0. Left: storing the long operand as bf16
// (half the bytes of the skinny rounds), which needs the rows gathered in
// the kernel, since the caller reads the fp32 rows for the norms every round
// anyway (ops.kernel_centrality_sums).
#include "pairwise_tile.cuh"

namespace {

enum Metric { kSql2 = 0, kL2 = 1, kCosine = 2 };
enum Dtype { kFloat32 = 0, kBfloat16 = 1 };

template <int M, class Pair>
struct DotOp : Pair {
  static __device__ __forceinline__ float finish(float g, float xn2, float yn2) {
    if (M == kCosine) return 1.f - g;
    const float sq = fmaxf(xn2 + yn2 - 2.f * g, 0.f);
    return M == kL2 ? sqrtf(sq) : sq;
  }
};

template <class Pair>
int launch_metric(const float* x, const float* y, const float* xn2, const float* yn2,
                  const float* w, float* scratch, float* partial, float* out, long long C,
                  long long R, long long d, int metric, int path, int grid, int splits,
                  cudaStream_t stream) {
  switch (metric) {
    case kSql2:
      return pairwise::launch_centrality<DotOp<kSql2, Pair>>(x, y, xn2, yn2, w, scratch, partial,
                                                             out, C, R, d, path, grid, splits,
                                                             stream);
    case kL2:
      return pairwise::launch_centrality<DotOp<kL2, Pair>>(x, y, xn2, yn2, w, scratch, partial,
                                                           out, C, R, d, path, grid, splits,
                                                           stream);
    case kCosine:
      return pairwise::launch_centrality<DotOp<kCosine, Pair>>(x, y, nullptr, nullptr, w,
                                                               scratch, partial, out, C, R, d,
                                                               path, grid, splits, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dot_centrality_launch(const float* x, const float* y,
                                     const float* xn2, const float* yn2,
                                     const float* w, float* scratch,
                                     float* partial, float* out, long long C,
                                     long long R, long long d, int metric,
                                     int dtype, int path, int grid,
                                     int splits, cudaStream_t stream) {
  switch (dtype) {
    case kFloat32:
      return launch_metric<pairwise::GramPair>(x, y, xn2, yn2, w, scratch, partial, out, C, R,
                                               d, metric, path, grid, splits, stream);
    case kBfloat16:
      return launch_metric<pairwise::Bf16GramPair>(x, y, xn2, yn2, w, scratch, partial, out, C,
                                                   R, d, metric, path, grid, splits, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
