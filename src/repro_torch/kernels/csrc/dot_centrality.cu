// Fused Gram-metric centrality: S[c] = sum_{r valid} w[r] * f(x_c . y_r).
//
// Replaces the TPU kernel dot_centrality / _dot_centrality_kernel in
// src/repro/kernels/pairwise_distance.py. The epilogue f is applied to the
// complete fp32 dot over d (sqrt does not commute with the d sum):
//   sql2:   max(|x|^2 + |y|^2 - 2 g, 0)
//   l2:     sqrt of sql2
//   cosine: 1 - g, on rows the caller normalised to unit length.
// Squared norms and the unit-row normalisation stay outside the kernel, as
// in repro/kernels/ops.py. The (C, R) block never reaches device memory.
//
// Bound on an H100: each round moves (C + R) * d * 4 bytes and does
// 2 * C * R * d flops. Early rounds (R = 2..64) are bound by the bytes of x,
// late rounds (C = 2..40, R up to n) by the bytes of y, and only the middle
// rounds (C and R near sqrt(40k pulls)) by the flops. The FMA stage is
// plain fp32 on the CUDA cores: a TF32 Gram keeps about three decimal digits
// and can flip the halving on near-ties. See centrality_tile.cuh for the
// tiling and the deterministic split over R.
#include "centrality_tile.cuh"

namespace {

enum Metric { kSql2 = 0, kL2 = 1, kCosine = 2 };

template <int M>
struct DotOp {
  static __device__ __forceinline__ float pair(float acc, float a, float b) {
    return fmaf(a, b, acc);
  }
  static __device__ __forceinline__ float finish(float g, float xn2, float yn2) {
    if (M == kCosine) return 1.f - g;
    const float sq = fmaxf(xn2 + yn2 - 2.f * g, 0.f);
    return M == kL2 ? sqrtf(sq) : sq;
  }
};

}  // namespace

extern "C" int dot_centrality_launch(const float* x, const float* y,
                                     const float* xn2, const float* yn2,
                                     const float* w, float* partial,
                                     float* out, long long C, long long R,
                                     long long d, int metric, int splits,
                                     cudaStream_t stream) {
  switch (metric) {
    case kSql2:
      return centrality::launch<DotOp<kSql2>>(x, y, xn2, yn2, w, partial, out, C, R, d, splits, stream);
    case kL2:
      return centrality::launch<DotOp<kL2>>(x, y, xn2, yn2, w, partial, out, C, R, d, splits, stream);
    case kCosine:
      return centrality::launch<DotOp<kCosine>>(x, y, xn2, yn2, w, partial, out, C, R, d, splits, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
