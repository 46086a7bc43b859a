// Shared tiling of the two fused centrality kernels (dot_centrality.cu and
// l1_centrality.cu): S[c] = sum_{r valid} w[r] * f(sum_k op(x[c,k], y[r,k])).
//
// Shapes on the main path decide the design. One correlated-SH round scores
// C surviving arms against R drawn references, and over a run (C, R) goes
// from (n, 2) to (2, n): huge C with tiny R early, tiny C with huge R late.
// A kernel that only parallelises over C would run one or two blocks on the
// card's 132 SMs in the late rounds, so R is split across blocks as well:
//
//  * grid (ceil(C / BC), splits); block (cx, s) owns candidate tile cx and
//    reference tiles s, s + splits, s + 2 * splits, ...;
//  * each block stages BK-wide d slabs of its x and y tiles in shared memory
//    and keeps a TM x TN register tile of complete d sums per thread, so the
//    epilogue f (sqrt for l2) sees the full sum, then folds w[r] * f(.) into
//    per-row register partials;
//  * a block writes its row partials to a (splits, C) scratch, and a second
//    pass sums the splits in a fixed order. No atomics: results are the same
//    run to run. With one split the first pass writes the output directly.
//
// Long fp32 sums are taken in two levels: the d sum in groups of 256
// columns, then the group sums (one running sum over d = 4096 terms of
// simplex rows drifted 6e-5 from the plain version on the card, beyond the
// 1e-5 tolerance); the split sum likewise in groups of 16 splits.
//
// Rows past C or R and d columns past d load as zeros and are never
// written or counted, so no caller pads to tile multiples. Offsets are
// 64-bit (an n = 100k, d = 28k matrix exceeds 2^31 elements).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace centrality {

constexpr int BC = 64;        // candidate rows per block
constexpr int BR = 64;        // reference rows per tile
constexpr int BK = 16;        // d slab staged in shared memory
constexpr int TX = 16;        // threads along r
constexpr int TY = 16;        // threads along c
constexpr int TM = BC / TY;   // candidate rows per thread
constexpr int TN = BR / TX;   // reference rows per thread
constexpr int NT = TX * TY;   // threads per block
constexpr int GROUP_SLABS = 16;  // GROUP = 256 d columns per partial sum
constexpr int SPLIT_GROUP = 16;
static_assert(BC == BR, "one loop stages both tiles");
static_assert(BC * BK % NT == 0, "staging loop has no remainder");

// Op::pair(acc, a, b) accumulates one d column; Op::finish(s, xa, yb) maps a
// complete d sum to the pair's distance, given per-row and per-reference
// auxiliaries (squared norms for the Gram metrics, unused by l1).
template <class Op>
__global__ void __launch_bounds__(NT)
partial_sums_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ xaux,
                    const float* __restrict__ yaux,
                    const float* __restrict__ w, float* __restrict__ partial,
                    int64_t C, int64_t R, int64_t d) {
  // +1 column: the staging stores walk k fastest, which would otherwise put
  // a warp's 16 stores of one row into a single bank.
  __shared__ float xs[BK][BC + 1];
  __shared__ float ys[BK][BR + 1];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int64_t c0 = (int64_t)blockIdx.x * BC;
  const int64_t splits = gridDim.y;
  const int64_t n_rtiles = (R + BR - 1) / BR;

  float xa[TM];
  float rowsum[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t c = c0 + ty + TY * i;
    xa[i] = (xaux != nullptr && c < C) ? xaux[c] : 0.f;
    rowsum[i] = 0.f;
  }

  for (int64_t rt = blockIdx.y; rt < n_rtiles; rt += splits) {
    const int64_t r0 = rt * BR;
    float acc[TM][TN], grp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = grp[i][j] = 0.f;

    int64_t slab = 0;
    for (int64_t k0 = 0; k0 < d; k0 += BK, ++slab) {
#pragma unroll
      for (int s = 0; s < BC * BK / NT; ++s) {
        const int e = tid + s * NT;
        const int row = e / BK;
        const int kk = e % BK;
        const int64_t k = k0 + kk;
        const int64_t c = c0 + row;
        const int64_t r = r0 + row;
        xs[kk][row] = (c < C && k < d) ? x[c * d + k] : 0.f;
        ys[kk][row] = (r < R && k < d) ? y[r * d + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + TY * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ys[kk][tx + TX * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) grp[i][j] = Op::pair(grp[i][j], a[i], b[j]);
      }
      __syncthreads();
      if (slab % GROUP_SLABS == GROUP_SLABS - 1) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] += grp[i][j];
            grp[i][j] = 0.f;
          }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += grp[i][j];

#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t r = r0 + tx + TX * j;
      if (r < R) {
        const float wr = (w != nullptr) ? w[r] : 1.f;
        const float yb = (yaux != nullptr) ? yaux[r] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) rowsum[i] += Op::finish(acc[i][j], xa[i], yb) * wr;
      }
    }
  }

  // The TX threads that share a ty are 16 adjacent lanes of one warp.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v = rowsum[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off, TX);
    const int64_t c = c0 + ty + TY * i;
    if (tx == 0 && c < C) partial[(int64_t)blockIdx.y * C + c] = v;
  }
}

// out[c] = sum over s of partial[s, c] in a fixed order: groups of
// SPLIT_GROUP consecutive splits, then the group sums.
__global__ void reduce_splits_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int64_t C,
                                     int splits) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int k0 = 0; k0 < splits; k0 += SPLIT_GROUP) {
    float g = 0.f;
    for (int k = k0; k < min(k0 + SPLIT_GROUP, splits); ++k) g += partial[(int64_t)k * C + c];
    s += g;
  }
  out[c] = s;
}

// Launches both passes on `stream` and returns cudaGetLastError() as an int.
// `partial` must hold splits * C floats when splits > 1 (unused otherwise).
template <class Op>
inline int launch(const float* x, const float* y, const float* xaux,
                  const float* yaux, const float* w, float* partial,
                  float* out, int64_t C, int64_t R, int64_t d, int splits,
                  cudaStream_t stream) {
  const dim3 grid((unsigned)((C + BC - 1) / BC), (unsigned)splits);
  float* first = splits == 1 ? out : partial;
  partial_sums_kernel<Op><<<grid, NT, 0, stream>>>(x, y, xaux, yaux, w, first, C, R, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  reduce_splits_kernel<<<(unsigned)((C + 255) / 256), 256, 0, stream>>>(partial, out, C, splits);
  return (int)cudaGetLastError();
}

}  // namespace centrality
