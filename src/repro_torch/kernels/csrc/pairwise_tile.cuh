// The two pairwise kernels (dot_pairwise.cu, l1_pairwise.cu): the (C, R)
// block of d sums D[c, r] = sum_k op(x[c,k], y[r,k]), op a GramPair,
// Bf16GramPair or L1Pair (below), written to out[c * R + r]. The same paths
// carry the two centrality kernels (dot_centrality.cu, l1_centrality.cu)
// with a centrality epilogue (Sink below): the weighted row sums of the
// block after a finish of each complete d sum, and the block never reaches
// device memory.
//
// The shapes decide the design, and they come in two kinds. The k-medoids
// BUILD and SWAP halvings and find_medoid run rounds from (n, 1) to (2, n)
// with about 20k-40k pairs each; the assignment caches are (n, k <= 10) and
// the BUILD d1 rows and SWAP verifications (1, n). Every one of them is
// bound by bytes or by latency, never by arithmetic (the largest middle
// round, (157, 135, 784), is 33 MFLOP: half a microsecond of fp32 FFMA). The
// live corpora's bootstrap and exact re-runs are squares, (32768, 32768,
// 784): 1.68 TFLOP, bound by arithmetic. A fixed square tile wastes up to
// 63/64 of its work on the skinny shapes and leaves most SMs idle on the
// middle ones, and a tile built for latency runs the squares at a quarter of
// the fp32 rate, so the wrapper picks one of three paths from (C, R, d)
// (pairwise_plan in pairwise_distance.py; S = its crossover, and F =
// GEMM_FILL, the share of the gemm launch's tile slots that the tile path's
// 32-row-padded outputs must fill, gemm_fill):
//
//  * stream path, min(C, R) <= S. The M = min(C, R) rows of the short
//    operand stay in shared memory (in d slabs when M * d * 4 bytes exceed
//    the block's budget); each warp takes rows of the long operand with a
//    grid stride and reads each byte of it once, 16 bytes a lane
//    (ld.global.nc.L1::no_allocate, 32 values of a row in flight per
//    lane), keeping one accumulator per short row. A shuffle tree that
//    halves the live values at each step leaves the complete sum for short
//    row m in lane m. Bound: the long operand's bytes.
//  * tile path, both C and R > S (and a fill below F where the kernel has
//    a gemm path). One 32 x 32 output tile per thread-block cluster; the
//    cluster's blocks (2-8, along d) each own a contiguous run of d
//    columns, streamed through a ring of cp.async slabs so that later
//    slabs' loads overlap the current slab's FFMA. The partial tiles are summed through
//    distributed shared memory in rank order and rank 0 writes the tile.
//    The d split is what fills the card: a (157, 135, 784) round has 25
//    tiles, run as 125 blocks in 5-block clusters. Each of its FFMAs needs
//    one shared-memory read, which caps it near a quarter of the fp32 rate.
//    Bound: latency, then the bytes of both operands.
//  * gemm path, GramPair (the fp32 Gram) only, both C and R > S, fill >= F.
//    A register-blocked SGEMM tile: 128 x 128 outputs a block of 256
//    threads, each summing an 8 x 8 micro-tile with FFMA from float4 reads
//    of shared memory, 4 shared-memory reads per 64 FFMAs. A persistent
//    grid of one block an SM walks the tiles in groups of 8 tile rows, so
//    that the blocks in flight share operand rows in L2, and one block owns
//    a tile over all of d: no d split, no cluster. Slabs of 32 columns
//    arrive by TMA, one tensor copy an operand a slab (4-byte cp.async
//    where rows are not 16-byte aligned). Bound: 2 C R d operations at the
//    fp32 rate (the squares' bytes take a fiftieth of that).
//  * the d split of the stream and tile paths, GramPair only
//    (PATH_STREAM_SPLIT, PATH_TILE_SPLIT), for rows so wide that the
//    unsplit plan leaves most SMs idle: the vocabulary-wide embeddings
//    (d = 32000-92544), whose rounds give the stream path 3-16 blocks (its
//    grid follows the long rows) and the tile path a few tiles of at most
//    8-block clusters. The
//    grid's y index is a rank q of `ranks` independent blocks along d, each
//    summing a run of whole SPLIT_GROUP-column groups (the last rank the
//    rest of d) into its own (C, R) slice of a (ranks, C, R) scratch; a
//    second launch sums the slices in rank order (split_sum_kernel) or, for
//    the centrality kernels, sums them per pair, applies the finish and
//    sums the weighted rows in a fixed order (split_centrality_kernel): the
//    l2 finish is nonlinear, so the partial Grams meet before it. The stream path's split double-buffers the short
//    rows' slabs (the next slab's cp.async copies in flight while warps
//    stream the current one), so a block never waits on a refill but its
//    first. Bound: the operands' bytes; the scratch is the split's own cost.
//
// All paths: full fp32 FFMA on the CUDA cores (no TF32: the fp32 mode keeps
// the fp32 Gram's precision, which a TF32 product would cut to about three
// decimal digits, so the gemm path stays off the tensor cores), except the
// tile path of the bf16 mode (Bf16GramPair below), whose products of bf16
// values run on the tensor cores; no running sum spans more than 256 d
// terms before it joins a sum of group sums (one running sum over d = 4096
// terms of simplex rows drifted 6e-5 from the plain version on an H100,
// beyond the 1e-5 tolerance); no atomics and a fixed summation order, so
// two launches on the same input are bit-equal; 64-bit offsets (an
// n = 100k, d = 28k matrix exceeds 2^31 elements); rows past C or R and
// columns past d are zeros or guarded, never written. 16-byte loads need
// d % 4 == 0 and 16-byte-aligned bases (a contiguous view may start at any
// element), else every path loads 4 bytes at a time.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Internal linkage: every library that includes this header keeps its own
// copy of each function. The launchers' function-local statics (each
// kernel's one-time shared-memory opt-in) would otherwise be unique
// symbols shared by every library that instantiates the same launcher, and
// a library would skip the opt-in of its own kernel after another library
// had made that of its copy.
namespace {
namespace pairwise {

namespace cg = cooperative_groups;

// The d-sum operations: pair(acc, a, b) accumulates one d column of two
// operand values as stage() left them, once, where they were staged (in
// shared memory or in registers after the load). kBf16: stage() rounds to
// bf16, and the tile path multiplies on the tensor cores. A centrality Op
// adds finish(s, xa, yb), which maps a complete d sum to the pair's distance
// given per-row and per-reference inputs (squared norms for the Gram
// metrics, unused by l1). kGemm: the gemm path takes this Op; kSplit: the
// d split does.
struct GramPair {
  static constexpr bool kBf16 = false;
  static constexpr bool kGemm = true;
  static constexpr bool kSplit = true;
  static __device__ __forceinline__ float stage(float a) { return a; }
  static __device__ __forceinline__ float pair(float acc, float a, float b) {
    return fmaf(a, b, acc);
  }
};

// The bf16 mode of the Gram (the TPU kernels' compute_dtype=bfloat16): both
// operands rounded to bf16, nearest even as astype rounds; the product of
// two bf16 values is exact in fp32, so only the fp32 sum rounds. The rows
// stay fp32 in memory, as the TPU kernel reads fp32 blocks and casts them in
// VMEM. Each value is rounded once where it is staged, so the stream path
// does the fp32 mode's operations, in its order, on the rounded values: it
// is bit-equal to the fp32 mode on rows rounded beforehand.
struct Bf16GramPair : GramPair {
  static constexpr bool kBf16 = true;
  static constexpr bool kGemm = false;
  static constexpr bool kSplit = false;
  static __device__ __forceinline__ float stage(float a) {
    return __bfloat162float(__float2bfloat16_rn(a));
  }
};

struct L1Pair {
  static constexpr bool kBf16 = false;
  static constexpr bool kGemm = false;
  static constexpr bool kSplit = false;
  static __device__ __forceinline__ float stage(float a) { return a; }
  static __device__ __forceinline__ float pair(float acc, float a, float b) {
    return acc + fabsf(a - b);
  }
};

constexpr int PATH_STREAM = 0;
constexpr int PATH_TILE = 1;
constexpr int PATH_GEMM = 2;
constexpr int PATH_STREAM_SPLIT = 3;
constexpr int PATH_TILE_SPLIT = 4;

// the d split: a rank's run is whole groups of SPLIT_GROUP columns (no
// running sum spans more than 256 terms), its ranks are gridDim.y
constexpr int SPLIT_GROUP = 256;
constexpr int SPLIT_MAX_RANKS = 65535;

// stream path
constexpr int S_WARPS = 8;                 // warps per block
constexpr int S_THREADS = 32 * S_WARPS;
constexpr int S_ROWS_WIDE = 4;             // rows a warp pass: MS 8-16, long N
constexpr int S_CHUNK = 1024;              // values a warp loads a pass, 32 a lane
constexpr int S_MAX_SHORT = 32;            // the largest S the plan may take
constexpr int S_SMEM = 112 * 1024;         // short-row bytes per block (2 a SM)
constexpr int S_SLAB_ALIGN = 128;          // 32 lanes x 4 columns

// tile path
constexpr int T_TILE = 32;                 // output tile, C and R
constexpr int T_BK = 32;                   // d columns per slab
constexpr int T_STAGES = 8;                // cp.async ring depth
constexpr int T_PAD = T_BK + 4;            // row stride (floats) in shared
constexpr int T_THREADS = 256;             // 16 x 16 threads, 2 x 2 each
constexpr int T_GROUP_SLABS = 256 / T_BK;  // 256 d columns per group sum
constexpr int T_MAX_CLUSTER = 8;
constexpr int T_SMEM = 2 * T_STAGES * T_TILE * T_PAD * (int)sizeof(float);
constexpr int T_BPAD = T_BK + 8;           // bf16 slab row stride: 80 bytes, so
                                           // an ldmatrix phase's 8 rows of 16
                                           // bytes fall in distinct banks

// gemm path (slabs of T_BK columns at a row stride of T_PAD floats, so the
// float4 at one column of 8 consecutive rows falls in distinct banks)
constexpr int G_TILE = 128;                // output tile, C and R
constexpr int G_MICRO = 8;                 // a thread's rows and columns
constexpr int G_THREADS = 256;             // 16 x 16 threads, 8 x 8 each
constexpr int G_STAGES = 4;                // ring depth
constexpr int G_GROUP_M = 8;               // tile rows a swizzle group
// the 4-byte copies' padded ring, which also holds the TMA ring of unpadded
// rows and its 1024-byte alignment
constexpr int G_SMEM = 2 * G_STAGES * G_TILE * T_PAD * (int)sizeof(float);
static_assert(2 * G_STAGES * G_TILE * T_BK * (int)sizeof(float) + 1023 <= G_SMEM,
              "the TMA ring fits");

template <int VW>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

// Read-only streaming loads that do not allocate in L1: each byte of the
// long operand is read once.
__device__ __forceinline__ float4 load_stream(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ float load_stream(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

template <class Op>
__device__ __forceinline__ float pair_vec(float acc, float4 a, float4 b) {
  acc = Op::pair(acc, a.x, b.x);
  acc = Op::pair(acc, a.y, b.y);
  acc = Op::pair(acc, a.z, b.z);
  return Op::pair(acc, a.w, b.w);
}
template <class Op>
__device__ __forceinline__ float pair_vec(float acc, float a, float b) {
  return Op::pair(acc, a, b);
}

// Op::stage on each value; the bf16 round of a float4 as two packed
// conversions (cvt.rn.bf16x2.f32), the same values as four single ones.
template <class Op>
__device__ __forceinline__ float4 stage_vec(float4 a) {
  if constexpr (Op::kBf16) {
    const float2 lo = __bfloat1622float2(__floats2bfloat162_rn(a.x, a.y));
    const float2 hi = __bfloat1622float2(__floats2bfloat162_rn(a.z, a.w));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  } else {
    return a;
  }
}
template <class Op>
__device__ __forceinline__ float stage_vec(float a) {
  return Op::stage(a);
}

__device__ __forceinline__ float4 vzero(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float vzero(float) { return 0.f; }

// Reduce v[0..MS) over the warp's 32 lanes: butterfly sums while the offset
// is at least MS, then steps that each halve the values a lane keeps
// (31 shuffles for MS = 32 instead of 160). Every index is a compile-time
// constant, so v stays in registers. Afterwards lane l holds the total of
// v[l % MS] in v[0]. The order of every addition is fixed.
template <int MS, int OFF>
__device__ __forceinline__ void warp_sums(float (&v)[MS], int lane) {
  if constexpr (OFF >= 1) {
    if constexpr (OFF >= MS) {
#pragma unroll
      for (int i = 0; i < MS; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], OFF);
    } else {
      const bool upper = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < OFF; ++i) {
        const float send = upper ? v[i] : v[i + OFF];
        const float keep = upper ? v[i + OFF] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
    }
    warp_sums<MS, OFF / 2>(v, lane);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The gemm path's TMA loads: a tensor copy of a 2-D box of rows into shared
// memory, completing on an mbarrier that counts the bytes.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// The tensor-core Gram of the bf16 tile path: ldmatrix fragments of bf16
// slabs in shared memory and one m16n8k16 product (bf16 in, fp32 out).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}
// d = a b + d over one 16-column step: A 16 x 16 row-major, B 16 x 8 as
// 8 rows of 16 (the y rows themselves), D 16 x 8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// Four fp32 values to bf16, nearest even, into 8 bytes of shared memory.
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// Where the d sums D[c, r] go. The pairwise kernels (CEN false) write the
// (C, R) block to `out`. The centrality kernels (CEN true) write the
// weighted row sums S[c] = sum_r w[r] * Op::finish(D[c, r], xaux[c], yaux[r])
// instead: the block never reaches device memory.
struct Sink {
  float* out;            // the (C, R) block, or the (C,) sums
  float* scratch;        // CEN, stream path over several d slabs: running d sums
  float* partial;        // CEN: (rows, C) row sums for a second pass, or `out`
  const float* w;        // CEN: (R,) weights, or null for all 1
  const float* xaux;     // CEN: (C,) and (R,) inputs of finish, or null (0)
  const float* yaux;
};

__device__ __forceinline__ float aux(const float* a, int64_t i) { return a != nullptr ? a[i] : 0.f; }
__device__ __forceinline__ float weight(const float* w, int64_t i) { return w != nullptr ? w[i] : 1.f; }

// Stream path. short_x: x (C rows) is the short operand, else y (R rows).
// Op::stage rounds each short value once per slab, in shared memory, and
// each long value once, before its M products.
// MS: the short row count rounded up to a power of two. VW: 4 for float4
// loads, 1 for scalar ones. A warp takes L long rows a pass, so each
// shared-memory read of a short value feeds L rows (registers about
// L * (MS + 8)); 4 rows pay off only where every warp still gets whole
// passes. `slab` d columns of the short rows sit in shared memory at a time;
// a later slab adds its sums to what the same lane wrote for the earlier
// ones (a sum of slab sums, in slab order). Within a slab a lane sums at
// most 256 d terms per pair before the warp reduces them into `total`.
//
// Centrality epilogue, at the last slab, when lane m holds D for short row m
// and the warp's long row n: with R short (n a candidate) the lanes weight
// their D and a shuffle tree sums them into S[n]; with C short (lane m a
// candidate) lane m adds w[n] * D into a register sum over the warp's long
// rows (in groups of 256 rows), the block sums its warps in warp order and
// writes one row of `partial`, which a second pass sums over the grid.
//
// stream_totals: one warp's pass over L long rows n0.. of the slab of kv
// vectors at column k0 against the M short rows in shv: total[l] of lane
// m < M is the slab's d sum of short row m and long row n0 + l.
template <class Op, int MS, int L, int VW>
__device__ __forceinline__ void stream_totals(const float* __restrict__ lp,
                                              const typename Vec<VW>::T* shv, int M,
                                              int64_t N, int64_t n0, int64_t d, int64_t k0,
                                              int kv, int lane, float (&total)[L]) {
  using V = typename Vec<VW>::T;
  constexpr int U = S_CHUNK / (32 * VW * L);   // loads per row per lane
  constexpr int FOLD = 256 / (U * VW);         // chunks per group sum
  float acc[L][MS];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    total[l] = 0.f;
#pragma unroll
    for (int m = 0; m < MS; ++m) acc[l][m] = 0.f;
  }
  for (int j0 = 0, ch = 1; j0 < kv; j0 += 32 * U, ++ch) {
    V v[L][U];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const V* row = reinterpret_cast<const V*>(lp + (n0 + l) * d + k0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * 32 + lane;
        v[l][u] = n0 + l < N && j < kv ? load_stream(row + j) : vzero(V());
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * 32 + lane;
      if (j < kv) {
        // the long values rounded here, where they are consumed: rounded
        // right after their loads, ptxas reused each load's registers
        // for the next load and so issued the L * U loads of a pass one
        // after another, which cost the bf16 mode a third of the fp32
        // mode's time at (20000, 2, 784) on an H100
        V vs[L];
#pragma unroll
        for (int l = 0; l < L; ++l) vs[l] = stage_vec<Op>(v[l][u]);
#pragma unroll
        for (int m = 0; m < MS; ++m) {
          if (m >= M) break;   // a uniform branch, not MS - M idle steps
          const V sv = shv[m * kv + j];
#pragma unroll
          for (int l = 0; l < L; ++l) acc[l][m] = pair_vec<Op>(acc[l][m], vs[l], sv);
        }
      }
    }
    if (ch % FOLD == 0 && j0 + 32 * U < kv) {   // d > 8192: a group is full
#pragma unroll
      for (int l = 0; l < L; ++l) {
        warp_sums<MS, 16>(acc[l], lane);
        total[l] += acc[l][0];
#pragma unroll
        for (int m = 0; m < MS; ++m) acc[l][m] = 0.f;
      }
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    warp_sums<MS, 16>(acc[l], lane);
    total[l] += acc[l][0];
  }
}

template <class Op, bool CEN, int MS, int L, int VW>
__global__ void __launch_bounds__(S_THREADS, 2)
stream_kernel(const float* __restrict__ x, const float* __restrict__ y, Sink sink,
              int64_t C, int64_t R, int64_t d, int64_t slab, bool short_x) {
  using V = typename Vec<VW>::T;
  extern __shared__ __align__(16) float sh[];
  const float* __restrict__ sp = short_x ? x : y;
  const float* __restrict__ lp = short_x ? y : x;
  float* __restrict__ out = sink.out;
  const int M = (int)(short_x ? C : R);
  const int64_t N = short_x ? R : C;
  const int lane = threadIdx.x & 31;
  const int64_t warp0 = (int64_t)blockIdx.x * S_WARPS + (threadIdx.x >> 5);
  const int64_t nwarps = (int64_t)gridDim.x * S_WARPS;
  // CEN: this lane's short row's weight (R short) and finish input
  const float w_lane = CEN && !short_x && lane < M ? weight(sink.w, lane) : 0.f;
  const float a_lane = CEN && lane < M ? aux(short_x ? sink.xaux : sink.yaux, lane) : 0.f;
  float csum = 0.f, cgrp = 0.f;   // CEN, C short: this lane's weighted sum
  int crows = 0;

  // d == 0 runs one empty slab, which writes zeros.
  for (int64_t k0 = 0; k0 == 0 || k0 < d; k0 += slab) {
    const int kw = (int)(d - k0 < slab ? d - k0 : slab);
    const int kv = kw / VW;
    const bool last = k0 + slab >= d;
    __syncthreads();   // the previous slab's readers are done
    // every copy of the slab in flight at once, then one wait
    for (int e = threadIdx.x; e < M * kv; e += S_THREADS) {
      const int m = e / kv;
      const int j = e - m * kv;
      const float* g = sp + (int64_t)m * d + k0 + (int64_t)j * VW;
      if (VW == 4)
        cp_async16(sh + (m * kv + j) * VW, g, true);
      else
        cp_async4(sh + (m * kv + j) * VW, g, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (Op::kBf16) {   // round each short value once, in place
      V* shw = reinterpret_cast<V*>(sh);
      for (int e = threadIdx.x; e < M * kv; e += S_THREADS) shw[e] = stage_vec<Op>(shw[e]);
      __syncthreads();
    }
    const V* shv = reinterpret_cast<const V*>(sh);

    for (int64_t n0 = warp0 * L; n0 < N; n0 += nwarps * L) {
      float total[L];
      stream_totals<Op, MS, L, VW>(lp, shv, M, N, n0, d, k0, kv, lane, total);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int64_t n = n0 + l;
        const int64_t idx = short_x ? (int64_t)lane * N + n : n * M + lane;
        if constexpr (!CEN) {
          if (lane < M && n < N) out[idx] = k0 == 0 ? total[l] : out[idx] + total[l];
        } else {
          const bool valid = lane < M && n < N;
          const float dsum = valid && k0 != 0 ? sink.scratch[idx] + total[l] : total[l];
          if (!last) {
            if (valid) sink.scratch[idx] = dsum;
          } else if (!short_x) {   // R short: S[n] over the lanes
            float v = valid ? Op::finish(dsum, aux(sink.xaux, n), a_lane) * w_lane : 0.f;
#pragma unroll
            for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
            if (lane == 0 && n < N) out[n] = v;
          } else if (valid) {      // C short: lane m's sum over long rows
            cgrp += Op::finish(dsum, a_lane, aux(sink.yaux, n)) * weight(sink.w, n);
            if (++crows == 256) {
              csum += cgrp;
              cgrp = 0.f;
              crows = 0;
            }
          }
        }
      }
    }
  }
  if constexpr (CEN) {
    if (short_x) {   // the block's warps in warp order: one row of partial
      __syncthreads();   // the last slab's readers are done with sh
      sh[threadIdx.x] = csum + cgrp;
      __syncthreads();
      if (threadIdx.x < M) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < S_WARPS; ++w) s += sh[w * 32 + threadIdx.x];
        sink.partial[(int64_t)blockIdx.x * C + threadIdx.x] = s;
      }
    }
  }
}

// The stream path's d split (GramPair): block (b, q) of the (gridDim.x,
// ranks) grid sums d columns [q run, min(d, (q + 1) run)) of its warps'
// long rows into slice q of the (ranks, C, R) scratch `part`, as
// stream_kernel sums a slab (a later slab adds to what the same lane wrote
// for the earlier ones). The short rows' slabs of `slab` columns alternate
// between two buffers of shared memory (one where the run is one slab):
// slab s + 1's copies are issued before slab s is summed, so only the
// first slab's copies are waited for with nothing to do.
template <int MS, int L, int VW>
__global__ void __launch_bounds__(S_THREADS, 2)
stream_split_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ part, int64_t C, int64_t R, int64_t d, int64_t run,
                    int64_t slab, bool short_x) {
  using V = typename Vec<VW>::T;
  extern __shared__ __align__(16) float sh[];
  const float* __restrict__ sp = short_x ? x : y;
  const float* __restrict__ lp = short_x ? y : x;
  const int M = (int)(short_x ? C : R);
  const int64_t N = short_x ? R : C;
  const int lane = threadIdx.x & 31;
  const int64_t warp0 = (int64_t)blockIdx.x * S_WARPS + (threadIdx.x >> 5);
  const int64_t nwarps = (int64_t)gridDim.x * S_WARPS;
  const int64_t kbeg = (int64_t)blockIdx.y * run;
  const int64_t kend = kbeg + run < d ? kbeg + run : d;
  const int nsl = (int)((kend - kbeg + slab - 1) / slab);   // >= 1: no empty rank
  float* __restrict__ out = part + (int64_t)blockIdx.y * C * R;
  auto width = [&](int s) {   // vectors of slab s
    const int64_t k0 = kbeg + (int64_t)s * slab;
    return (int)((kend - k0 < slab ? kend - k0 : slab) / VW);
  };
  auto issue = [&](int s) {   // slab s's copies into buffer s % 2
    const int64_t k0 = kbeg + (int64_t)s * slab;
    const int kv = width(s);
    float* buf = sh + (s & 1) * M * slab;
    for (int e = threadIdx.x; e < M * kv; e += S_THREADS) {
      const int m = e / kv;
      const int j = e - m * kv;
      const float* g = sp + (int64_t)m * d + k0 + (int64_t)j * VW;
      if (VW == 4)
        cp_async16(buf + (m * kv + j) * VW, g, true);
      else
        cp_async4(buf + (m * kv + j) * VW, g, true);
    }
    cp_async_commit();
  };

  issue(0);
  for (int s = 0; s < nsl; ++s) {
    if (s + 1 < nsl) {   // buffer (s + 1) % 2's readers left it at s - 1
      issue(s + 1);
      cp_async_wait<1>();   // slab s has landed for this thread
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // ... for all
    const int64_t k0 = kbeg + (int64_t)s * slab;
    const int kv = width(s);
    const V* shv = reinterpret_cast<const V*>(sh + (s & 1) * M * slab);
    for (int64_t n0 = warp0 * L; n0 < N; n0 += nwarps * L) {
      float total[L];
      stream_totals<GramPair, MS, L, VW>(lp, shv, M, N, n0, d, k0, kv, lane, total);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int64_t n = n0 + l;
        const int64_t idx = short_x ? (int64_t)lane * N + n : n * M + lane;
        if (lane < M && n < N) out[idx] = s == 0 ? total[l] : out[idx] + total[l];
      }
    }
    __syncthreads();   // slab s's readers are done before slab s + 2's copies
  }
}

// Copy one T_TILE x T_BK slab of rows [row0, row0 + T_TILE) x columns
// [k, k + T_BK) of a (rows, d) matrix into dst; rows past `rows` and
// columns past `kend` are zero-filled.
template <int VW>
__device__ __forceinline__ void load_slab(float (*dst)[T_PAD], const float* __restrict__ src,
                                          int64_t row0, int64_t rows, int64_t d,
                                          int64_t k, int64_t kend) {
  constexpr int PER_ROW = T_BK / VW;
  constexpr int N = T_TILE * PER_ROW;
  static_assert(N % T_THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int s = 0; s < N / T_THREADS; ++s) {
    const int e = (int)threadIdx.x + s * T_THREADS;
    const int row = e / PER_ROW;
    const int col = (e % PER_ROW) * VW;
    const int64_t r = row0 + row;
    const int64_t kk = k + col;
    const bool valid = r < rows && kk < kend;
    const float* g = valid ? src + r * d + kk : src;
    if (VW == 4)
      cp_async16(&dst[row][col], g, valid);
    else
      cp_async4(&dst[row][col], g, valid);
  }
}

// Tile path. A cluster of `splits` consecutive blocks shares one output
// tile; block rank q sums d columns [q * run, min(d, (q + 1) * run)).
// fp32: each of the 16 x 16 threads sums a 2 x 2 block with FFMA. bf16
// (Op::kBf16): a slab that lands is rounded once into bf16 slabs beside the
// ring, and each of the 8 warps takes one 16 x 8 fragment of the tile (warp
// w: rows 16 (w % 2), columns 8 (w / 2)) with one m16n8k16 tensor-core
// product per 16 d columns. Each product starts from zero and its four
// values are added to the group sums in d order, so no tensor-core sum spans
// more than 16 columns (its alignment truncates) and the fp32 sums round as
// the FFMA path's do.
// Centrality epilogue: rank 0 weights the complete tile, sums each row's 32
// columns (its own two, then a shuffle tree over the 16 lanes of the row)
// and writes row r-tile of `partial`, which a second pass sums over the
// r-tiles.
// SPLIT (the d split, GramPair): no cluster; block (t, q) of the (tiles,
// ranks) grid sums tile t over rank q's run of d and writes it to slice q
// of the (ranks, C, R) scratch `sink.scratch`.
template <class Op, bool CEN, int VW, bool SPLIT = false>
__global__ void __launch_bounds__(T_THREADS)
tile_kernel(const float* __restrict__ x, const float* __restrict__ y, Sink sink,
            int64_t C, int64_t R, int64_t d, int64_t n_rtiles, int64_t run) {
  static_assert(!SPLIT || (Op::kSplit && !CEN), "the d split's first pass is the fp32 Gram");
  extern __shared__ __align__(16) float ring[];   // T_SMEM bytes
  auto xs = reinterpret_cast<float (*)[T_TILE][T_PAD]>(ring);
  auto ys = reinterpret_cast<float (*)[T_TILE][T_PAD]>(ring + T_STAGES * T_TILE * T_PAD);
  __shared__ float part[SPLIT ? 1 : T_TILE][T_TILE + 1];
  constexpr bool MMA = Op::kBf16;
  __shared__ __align__(16) __nv_bfloat16 xb[MMA ? T_TILE : 1][T_BPAD];   // MMA: the slab in bf16
  __shared__ __align__(16) __nv_bfloat16 yb[MMA ? T_TILE : 1][T_BPAD];
  unsigned rank, splits;
  if constexpr (SPLIT) {
    rank = blockIdx.y;
    splits = 1;
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    rank = cluster.block_rank();
    splits = cluster.num_blocks();
  }
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t tile = (int64_t)(blockIdx.x / splits);
  const int64_t c0 = (tile / n_rtiles) * T_TILE;
  const int64_t r0 = (tile % n_rtiles) * T_TILE;
  const int64_t kbeg = (int64_t)rank * run;
  const int64_t kend = kbeg + run < d ? kbeg + run : d;
  const int nslabs = kend > kbeg ? (int)((kend - kbeg + T_BK - 1) / T_BK) : 0;

  float acc[2][2], grp[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j] = grp[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < T_STAGES - 1; ++s) {
    if (s < nslabs) {
      load_slab<VW>(xs[s], x, c0, C, d, kbeg + s * T_BK, kend);
      load_slab<VW>(ys[s], y, r0, R, d, kbeg + s * T_BK, kend);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nslabs; ++i) {
    cp_async_wait<T_STAGES - 2>();   // slab i has landed for this thread
    __syncthreads();                 // ... for all; slab i - 1 is consumed
    const int nxt = i + T_STAGES - 1;
    if (nxt < nslabs) {
      load_slab<VW>(xs[nxt % T_STAGES], x, c0, C, d, kbeg + (int64_t)nxt * T_BK, kend);
      load_slab<VW>(ys[nxt % T_STAGES], y, r0, R, d, kbeg + (int64_t)nxt * T_BK, kend);
    }
    cp_async_commit();
    const int st = i % T_STAGES;
    if constexpr (MMA) {
      {   // each thread rounds 4 values of row t / 8 of either slab
        const int row = threadIdx.x >> 3;
        const int col = (threadIdx.x & 7) * 4;
        store_bf16x4(&xb[row][col], *reinterpret_cast<const float4*>(&xs[st][row][col]));
        store_bf16x4(&yb[row][col], *reinterpret_cast<const float4*>(&ys[st][row][col]));
      }
      __syncthreads();
      const int lane = threadIdx.x & 31;
      const int m0 = (threadIdx.x >> 5 & 1) * 16;
      const int n0 = (threadIdx.x >> 6) * 8;
#pragma unroll
      for (int k = 0; k < T_BK; k += 16) {
        unsigned a[4], b[2];
        ldmatrix_x4(a, &xb[m0 + (lane & 15)][k + (lane >> 4) * 8]);
        ldmatrix_x2(b, &yb[n0 + (lane & 7)][k + (lane >> 3 & 1) * 8]);
        float dk[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(dk, a, b);
#pragma unroll
        for (int e = 0; e < 4; ++e) grp[e >> 1][e & 1] += dk[e];
      }
    } else {
#pragma unroll
      for (int k = 0; k < T_BK; k += 4) {
        float4 a[2], b[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          a[t] = *reinterpret_cast<const float4*>(&xs[st][ty + 16 * t][k]);
          b[t] = *reinterpret_cast<const float4*>(&ys[st][tx + 16 * t][k]);
        }
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) grp[ii][jj] = pair_vec<Op>(grp[ii][jj], a[ii], b[jj]);
      }
    }
    if (i % T_GROUP_SLABS == T_GROUP_SLABS - 1) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          acc[ii][jj] += grp[ii][jj];
          grp[ii][jj] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int ii = 0; ii < 2; ++ii)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      acc[ii][jj] += grp[ii][jj];
      if constexpr (SPLIT) {   // this rank's slice of the scratch
        const int64_t c = c0 + ty + 16 * ii;
        const int64_t r = r0 + tx + 16 * jj;
        if (c < C && r < R) sink.scratch[(int64_t)rank * C * R + c * R + r] = acc[ii][jj];
      } else if constexpr (MMA) {   // fragment value e = 2 ii + jj of warp w
        const int lane = threadIdx.x & 31;
        part[(threadIdx.x >> 5 & 1) * 16 + (lane >> 2) + 8 * ii]
            [(threadIdx.x >> 6) * 8 + (lane & 3) * 2 + jj] = acc[ii][jj];
      } else {
        part[ty + 16 * ii][tx + 16 * jj] = acc[ii][jj];
      }
    }
  if constexpr (!SPLIT) {   // the cluster's epilogue
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();   // every rank's partial tile is in its shared memory
    if (rank == 0) {
      if constexpr (MMA) {   // this rank's tile in the epilogue's 2 x 2 layout
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) acc[ii][jj] = part[ty + 16 * ii][tx + 16 * jj];
      }
      for (unsigned q = 1; q < splits; ++q) {
        const float* rp = cluster.map_shared_rank(&part[0][0], q);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            acc[ii][jj] += rp[(ty + 16 * ii) * (T_TILE + 1) + tx + 16 * jj];
      }
      if constexpr (!CEN) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int64_t c = c0 + ty + 16 * ii;
          if (c >= C) continue;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int64_t r = r0 + tx + 16 * jj;
            if (r < R) sink.out[c * R + r] = acc[ii][jj];
          }
        }
      } else {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int64_t c = c0 + ty + 16 * ii;
          const float xa = c < C ? aux(sink.xaux, c) : 0.f;
          float v = 0.f;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int64_t r = r0 + tx + 16 * jj;
            if (r < R) v += Op::finish(acc[ii][jj], xa, aux(sink.yaux, r)) * weight(sink.w, r);
          }
#pragma unroll
          for (int off = 8; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off, 16);
          if (tx == 0 && c < C) sink.partial[(r0 / T_TILE) * C + c] = v;
        }
      }
    }
    cluster.sync();   // no block leaves while rank 0 may read its tile
  }
}

// The gemm path's 4-byte loads (rows not 16-byte aligned or d % 4 != 0; TMA
// takes the rest). One operand's share of a slab for this thread: copy s
// (< NS) moves one float of row r + s * RS of the tile at column col of the
// slab (r, col from the thread index), so each copy's source is a fixed
// offset from one pointer set once a tile (at() below) and advanced by the
// slab's column. Rows past `rows` and columns past d are zero-filled.
struct GemmSlabLoader {
  static constexpr int RS = G_THREADS / T_BK;
  static constexpr int NS = G_TILE * T_BK / G_THREADS;
  static_assert(G_TILE * T_BK % G_THREADS == 0 && NS <= 32, "whole copies per thread");
  const float* base;   // row r, column col of the tile's first slab
  int64_t step;        // RS rows
  unsigned rows_in;    // bit s: row r + s * RS lies before `rows`
  int col;

  __device__ __forceinline__ void at(const float* src, int64_t row0, int64_t rows, int64_t d) {
    const int r = (int)threadIdx.x / T_BK;
    col = (int)threadIdx.x % T_BK;
    step = (int64_t)RS * d;
    base = src + (row0 + r) * d + col;
    rows_in = 0;
#pragma unroll
    for (int s = 0; s < NS; ++s) rows_in |= (row0 + r + s * RS < rows ? 1u : 0u) << s;
  }

  __device__ __forceinline__ void load(float (*dst)[T_PAD], const float* src, int64_t k,
                                       int64_t d) const {
    const int r = (int)threadIdx.x / T_BK;
    const bool k_in = k + col < d;
    const float* p = base + k;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const bool valid = k_in && (rows_in >> s & 1u);
      cp_async4(&dst[r + s * RS][col], valid ? p : src, valid);
      p += step;
    }
  }
};

// The gemm path's tile order: tile t of the (mt, nt) grid of G_TILE x G_TILE
// tiles, in groups of G_GROUP_M tile rows walked down each column of the
// group, so that consecutive tiles (the blocks in flight) share the x rows
// of G_GROUP_M tiles and the y rows of a few dozen in L2. Returns the
// tile's first row of x (c0) and of y (r0).
__device__ __forceinline__ void gemm_tile(int64_t t, int64_t mt, int64_t nt, int64_t& c0,
                                          int64_t& r0) {
  const int64_t per_group = (int64_t)G_GROUP_M * nt;
  const int64_t g = t / per_group;
  const int64_t first = g * G_GROUP_M;
  const int64_t rows = mt - first < G_GROUP_M ? mt - first : G_GROUP_M;
  const int64_t in = t - g * per_group;
  c0 = (first + in % rows) * G_TILE;
  r0 = (in / rows) * G_TILE;
}

// Gemm path (Op::kGemm: the fp32 Gram). Block b owns tiles b, b + grid, ...
// of the gemm_tile order, each over all of d, as one stream of (tile, slab)
// steps through a ring of G_STAGES slabs: the next tile's first slabs load
// while this tile's last ones are summed and its epilogue runs. TMA (VW 4:
// 16-byte aligned rows, d % 4 == 0, d > 0): thread 0 copies each operand's
// 128 x 32 slab with one tensor copy (the maps mx, my), which zero-fills rows
// past C or R and columns past d and swizzles each 128-byte row by 16-byte
// chunks (chunk ^ row % 8), so that a float4 at one column of 8 consecutive
// rows falls in distinct banks; an mbarrier a stage says when it has landed.
// VW 1: every thread issues 4-byte cp.async copies (GemmSlabLoader) into
// rows padded to T_PAD floats. Either way a block barrier a slab frees the
// stage that the next copy refills.
// Thread (warp w, lane l) sums rows tr + 16 i and columns tc + 16 j of the
// tile (i, j < 8; tr = 4 (w / 2) + l / 8, tc = 8 (w % 2) + l % 8): per 4 d
// columns it reads one float4 of each of its 8 x rows and 8 y rows for 256
// FFMAs, and a warp's reads of one float4 fall on 4 or 8 consecutive rows,
// in distinct banks. Each sum of a group of at most 256 columns
// (T_GROUP_SLABS slabs) joins the thread's totals in d order.
// Epilogue: the tile of the (C, R) block, or with CEN the finish of each
// complete sum, weighted and summed over the thread's 8 columns in column
// order, over the 8 lanes of the warp that share its rows (a shuffle tree,
// lanes 1, 2, then 4 apart), then over the two warps that share them (warp
// 2 m, then warp 2 m + 1), into row r-tile of `partial`, which a second pass
// sums over the r-tiles.
template <class Op, bool CEN, int VW>
__global__ void __launch_bounds__(G_THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap my,
            const float* __restrict__ x, const float* __restrict__ y, Sink sink, int64_t C,
            int64_t R, int64_t d) {
  constexpr bool TMA = VW == 4;
  constexpr int ROW = TMA ? T_BK : T_PAD;   // a slab row's floats in shared memory
  constexpr int SLAB = G_TILE * ROW;
  extern __shared__ __align__(16) unsigned char raw[];   // G_SMEM bytes
  // the swizzle needs 1024-byte aligned slabs; an offset into the array (not
  // a cast of its address) keeps the reads shared-memory loads
  float* xs =
      reinterpret_cast<float*>(raw + (TMA ? (1024u - (smem_u32(raw) & 1023u)) & 1023u : 0u));
  float* ys = xs + G_STAGES * SLAB;
  __shared__ uint64_t full[G_STAGES];   // TMA: stage s has landed
  __shared__ float red[2][G_TILE];      // CEN: the row sums of either warp's columns
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tr = (warp >> 1) * 4 + (lane >> 3);
  const int tc = (warp & 1) * 8 + (lane & 7);
  const int64_t mt = (C + G_TILE - 1) / G_TILE;
  const int64_t nt = (R + G_TILE - 1) / G_TILE;
  const int64_t tiles = mt * nt;
  // d == 0 runs one slab of zeros, which writes zeros
  const int nsl = d > 0 ? (int)((d + T_BK - 1) / T_BK) : 1;
  const int64_t mine =
      (int64_t)blockIdx.x < tiles ? (tiles - 1 - (int64_t)blockIdx.x) / gridDim.x + 1 : 0;
  if (TMA && threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < G_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the producer's next slab: slab lk of this block's tile lq, into stage lst
  int64_t lq = 0, lc0 = 0, lr0 = 0;
  int lk = 0, lst = 0;
  GemmSlabLoader lx, ly;   // VW 1
  auto load_tile = [&](int64_t t) {
    gemm_tile(t, mt, nt, lc0, lr0);
    if constexpr (!TMA) {
      lx.at(x, lc0, C, d);
      ly.at(y, lr0, R, d);
    }
  };
  if (mine > 0) load_tile(blockIdx.x);
  auto issue = [&]() {   // TMA: thread 0 alone
    if (lq < mine) {
      if constexpr (TMA) {
        mbar_expect_tx(&full[lst], 2 * SLAB * (unsigned)sizeof(float));
        tma_load_2d(xs + lst * SLAB, &mx, &full[lst], lk * T_BK, (int)lc0);
        tma_load_2d(ys + lst * SLAB, &my, &full[lst], lk * T_BK, (int)lr0);
      } else {
        const int64_t k = (int64_t)lk * T_BK;
        lx.load(reinterpret_cast<float (*)[T_PAD]>(xs + lst * SLAB), x, k, d);
        ly.load(reinterpret_cast<float (*)[T_PAD]>(ys + lst * SLAB), y, k, d);
      }
      lst = lst + 1 == G_STAGES ? 0 : lst + 1;
      if (++lk == nsl) {
        lk = 0;
        if (++lq < mine) load_tile(blockIdx.x + lq * gridDim.x);
      }
    }
    if constexpr (!TMA) cp_async_commit();
  };
  if (!TMA || threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < G_STAGES - 1; ++s) issue();
  }

  float acc[G_MICRO][G_MICRO], tot[G_MICRO][G_MICRO];
#pragma unroll
  for (int i = 0; i < G_MICRO; ++i)
#pragma unroll
    for (int j = 0; j < G_MICRO; ++j) acc[i][j] = tot[i][j] = 0.f;
  int64_t q = 0, c0 = 0, r0 = 0;
  int kk = 0, st = 0;
  unsigned phase = 0;   // TMA: bit s, the parity stage s waits for next
  if (mine > 0) gemm_tile(blockIdx.x, mt, nt, c0, r0);
  // TMA: the 16-byte chunk of column 4 k4 in this thread's rows is k4 ^ row % 8
  const int sx = TMA ? tr & 7 : 0;
  const int sy = TMA ? tc & 7 : 0;
  const int64_t steps = mine * nsl;
  for (int64_t s = 0; s < steps; ++s) {
    if constexpr (TMA) {
      mbar_wait(&full[st], phase >> st & 1u);   // slab s has landed
      phase ^= 1u << st;
    } else {
      cp_async_wait<G_STAGES - 2>();   // slab s has landed for this thread
    }
    __syncthreads();   // ... for all; slab s - 1 is consumed
    if (!TMA || threadIdx.x == 0) issue();
    const float* xa = xs + st * SLAB + tr * ROW;
    const float* yb = ys + st * SLAB + tc * ROW;
#pragma unroll
    for (int k4 = 0; k4 < T_BK / 4; ++k4) {
      float4 b[G_MICRO];
#pragma unroll
      for (int j = 0; j < G_MICRO; ++j)
        b[j] = *reinterpret_cast<const float4*>(yb + 16 * j * ROW + ((k4 ^ sy) << 2));
#pragma unroll
      for (int i = 0; i < G_MICRO; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(xa + 16 * i * ROW + ((k4 ^ sx) << 2));
#pragma unroll
        for (int j = 0; j < G_MICRO; ++j) acc[i][j] = pair_vec<Op>(acc[i][j], a, b[j]);
      }
    }
    st = st + 1 == G_STAGES ? 0 : st + 1;
    const bool last = kk == nsl - 1;
    if (last || kk % T_GROUP_SLABS == T_GROUP_SLABS - 1) {
#pragma unroll
      for (int i = 0; i < G_MICRO; ++i)
#pragma unroll
        for (int j = 0; j < G_MICRO; ++j) {
          tot[i][j] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
    if (!last) {
      ++kk;
      continue;
    }
    if constexpr (!CEN) {
#pragma unroll
      for (int i = 0; i < G_MICRO; ++i) {
        const int64_t c = c0 + tr + 16 * i;
        if (c >= C) continue;
#pragma unroll
        for (int j = 0; j < G_MICRO; ++j) {
          const int64_t r = r0 + tc + 16 * j;
          if (r < R) sink.out[c * R + r] = tot[i][j];
        }
      }
    } else {
      float ya[G_MICRO], wr[G_MICRO];   // this thread's columns' inputs, read once
#pragma unroll
      for (int j = 0; j < G_MICRO; ++j) {
        const int64_t r = r0 + tc + 16 * j;
        ya[j] = r < R ? aux(sink.yaux, r) : 0.f;
        wr[j] = r < R ? weight(sink.w, r) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < G_MICRO; ++i) {
        const int64_t c = c0 + tr + 16 * i;
        const float xa = c < C ? aux(sink.xaux, c) : 0.f;
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < G_MICRO; ++j)
          if (r0 + tc + 16 * j < R) v += Op::finish(tot[i][j], xa, ya[j]) * wr[j];
#pragma unroll
        for (int off = 1; off < 8; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
        if ((lane & 7) == 0) red[warp & 1][tr + 16 * i] = v;
      }
      __syncthreads();   // red is read before the next step's barrier
      if (threadIdx.x < G_TILE && c0 + threadIdx.x < C)
        sink.partial[(r0 / G_TILE) * C + c0 + threadIdx.x] =
            red[0][threadIdx.x] + red[1][threadIdx.x];
    }
#pragma unroll
    for (int i = 0; i < G_MICRO; ++i)
#pragma unroll
      for (int j = 0; j < G_MICRO; ++j) tot[i][j] = 0.f;
    kk = 0;
    if (++q < mine) gemm_tile(blockIdx.x + q * gridDim.x, mt, nt, c0, r0);
  }
  if constexpr (!TMA) cp_async_wait<0>();
}

// One stream-path launch's geometry: `grid` blocks (each rank's, with the d
// split) holding `slab` columns of the short rows in shared memory at a
// time; with the split (SPLIT below), `ranks` ranks (gridDim.y) of `run`
// columns, else ranks 1 and run 0.
struct StreamGeom {
  int64_t slab;
  int64_t run;
  int grid;
  int ranks;
};

// SPLIT: the d split's first pass (GramPair), into sink.scratch.
template <class Op, bool CEN, int MS, int L, int VW, bool SPLIT>
inline cudaError_t launch_stream_kernel(const float* x, const float* y, const Sink& sink,
                                        int64_t C, int64_t R, int64_t d, const StreamGeom& g,
                                        bool short_x, cudaStream_t stream) {
  const int64_t M = short_x ? C : R;
  if constexpr (SPLIT) {
    static_assert(Op::kSplit && !CEN, "the d split's first pass is the fp32 Gram");
    const size_t smem = (size_t)((g.slab < g.run ? 2 : 1) * M * g.slab) * sizeof(float);
    if (smem > 48 * 1024) {
      static const cudaError_t err = cudaFuncSetAttribute(
          stream_split_kernel<MS, L, VW>, cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM);
      if (err != cudaSuccess) return err;
    }
    stream_split_kernel<MS, L, VW><<<dim3((unsigned)g.grid, (unsigned)g.ranks), S_THREADS, smem,
                                     stream>>>(x, y, sink.scratch, C, R, d, g.run, g.slab,
                                               short_x);
  } else {
    size_t smem = (size_t)(M * (g.slab < d ? g.slab : d)) * sizeof(float);
    if (CEN && short_x && smem < S_THREADS * sizeof(float))
      smem = S_THREADS * sizeof(float);   // the block's sum over its warps
    if (smem > 48 * 1024) {
      // Above 48 KB only after an opt-in, made once per kernel (and so never
      // inside a CUDA-graph capture that follows an eager first call).
      static const cudaError_t err = cudaFuncSetAttribute(
          stream_kernel<Op, CEN, MS, L, VW>, cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM);
      if (err != cudaSuccess) return err;
    }
    stream_kernel<Op, CEN, MS, L, VW><<<g.grid, S_THREADS, smem, stream>>>(x, y, sink, C, R, d,
                                                                           g.slab, short_x);
  }
  return cudaGetLastError();
}

// 4 long rows a pass for MS 8 and 16 with 16-byte loads, where the long
// side gives every warp of the grid (of a rank) at least one such pass;
// else 2.
template <class Op, bool CEN, int MS, bool SPLIT>
inline cudaError_t launch_stream_ms(const float* x, const float* y, const Sink& sink, int64_t C,
                                    int64_t R, int64_t d, const StreamGeom& g, bool vec,
                                    bool short_x, cudaStream_t stream) {
  if (!vec)
    return launch_stream_kernel<Op, CEN, MS, 2, 1, SPLIT>(x, y, sink, C, R, d, g, short_x,
                                                          stream);
  if constexpr (MS == 8 || MS == 16) {
    const int64_t N = short_x ? R : C;
    if (N >= (int64_t)S_ROWS_WIDE * S_WARPS * g.grid)
      return launch_stream_kernel<Op, CEN, MS, S_ROWS_WIDE, 4, SPLIT>(x, y, sink, C, R, d, g,
                                                                      short_x, stream);
  }
  return launch_stream_kernel<Op, CEN, MS, 2, 4, SPLIT>(x, y, sink, C, R, d, g, short_x, stream);
}

template <class Op, bool CEN, bool SPLIT = false>
inline cudaError_t launch_stream(const float* x, const float* y, const Sink& sink, int64_t C,
                                 int64_t R, int64_t d, const StreamGeom& g, bool vec,
                                 cudaStream_t stream) {
  const bool short_x = C <= R;
  const int64_t M = short_x ? C : R;
  auto go = [&](auto ms) {   // MS = the short row count's power of two
    return launch_stream_ms<Op, CEN, decltype(ms)::value, SPLIT>(x, y, sink, C, R, d, g, vec,
                                                                 short_x, stream);
  };
  if (M <= 1) return go(std::integral_constant<int, 1>{});
  if (M <= 2) return go(std::integral_constant<int, 2>{});
  if (M <= 4) return go(std::integral_constant<int, 4>{});
  if (M <= 8) return go(std::integral_constant<int, 8>{});
  if (M <= 16) return go(std::integral_constant<int, 16>{});
  return go(std::integral_constant<int, 32>{});
}

// The stream path's slab width from `splits`: ceil(d / splits) rounded up
// to whole lane passes of 4 columns (at least one, so that the slab loop
// advances when d == 0); 0 where the short rows' slab exceeds the budget.
inline int64_t stream_slab(int64_t M, int64_t d, int splits) {
  int64_t slab = (d + splits - 1) / splits;
  slab = (slab + S_SLAB_ALIGN - 1) / S_SLAB_ALIGN * S_SLAB_ALIGN;
  if (slab < S_SLAB_ALIGN) slab = S_SLAB_ALIGN;
  if (M * (slab < d ? slab : d) * (int64_t)sizeof(float) > S_SMEM) return 0;
  return slab;
}

// The d split's run: ceil(d / ranks) in whole SPLIT_GROUP-column groups;
// rank q sums columns [q run, min(d, (q + 1) run)).
inline int64_t split_run(int64_t d, int ranks) {
  const int64_t groups = (d + SPLIT_GROUP - 1) / SPLIT_GROUP;
  return (groups + ranks - 1) / ranks * SPLIT_GROUP;
}

// The stream split's slab: a rank's whole run where its short rows fit
// S_SMEM (one buffer), else the most whole lane passes of 4 columns that
// each of two buffers of S_SMEM / 2 holds.
inline int64_t split_slab(int64_t M, int64_t run) {
  if (M * run * (int64_t)sizeof(float) <= S_SMEM) return run;
  return S_SMEM / 2 / (M * (int64_t)sizeof(float) * S_SLAB_ALIGN) * S_SLAB_ALIGN;
}

inline bool is_split(int path) { return path == PATH_STREAM_SPLIT || path == PATH_TILE_SPLIT; }

// The TMA map of a (rows, d) fp32 matrix at p (16-byte aligned, d % 4 == 0,
// d > 0) for the gemm path: boxes of 32 columns by G_TILE rows, 128-byte
// swizzle, zeros past the matrix. The driver's encoder is reached through the
// runtime, so the libraries need no link to the driver.
typedef CUresult (*TensorMapEncoder)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave,
                                     CUtensorMapSwizzle, CUtensorMapL2promotion,
                                     CUtensorMapFloatOOBfill);

inline cudaError_t gemm_tensor_map(CUtensorMap* map, const float* p, int64_t rows, int64_t d) {
  static TensorMapEncoder encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                                    reinterpret_cast<void**>(&encode),
                                                    cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)T_BK, (cuuint32_t)G_TILE};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The d split's first pass (the fp32 Gram) for C, R, d >= 1: `splits` ranks
// of the stream path's blocks (`grid` / splits a rank) or of the tiles
// (`grid` = tiles * splits), rank q's partial Gram into slice q of the
// (splits, C, R) scratch `part`. Pair: GramPair (a template, so that only
// the sources that launch it build its kernels).
template <class Pair>
inline cudaError_t launch_split_pass(const float* x, const float* y, float* part, int64_t C,
                                     int64_t R, int64_t d, int path, int grid, int splits,
                                     bool vec, cudaStream_t stream) {
  static_assert(Pair::kSplit && !Pair::kBf16, "the d split's first pass is the fp32 Gram");
  if (d < 1 || splits < 2 || splits > SPLIT_MAX_RANKS || part == nullptr)
    return cudaErrorInvalidValue;
  const int64_t run = split_run(d, splits);
  if ((int64_t)(splits - 1) * run >= d) return cudaErrorInvalidValue;   // an empty rank
  const Sink sink = {nullptr, part, nullptr, nullptr, nullptr, nullptr};
  if (path == PATH_STREAM_SPLIT) {
    const int64_t M = C <= R ? C : R;
    if (M > S_MAX_SHORT || grid % splits != 0) return cudaErrorInvalidValue;
    return launch_stream<Pair, false, true>(
        x, y, sink, C, R, d, StreamGeom{split_slab(M, run), run, grid / splits, splits}, vec,
        stream);
  }
  const int64_t n_rtiles = (R + T_TILE - 1) / T_TILE;
  const int64_t tiles = ((C + T_TILE - 1) / T_TILE) * n_rtiles;
  if (tiles * splits != (int64_t)grid) return cudaErrorInvalidValue;
  // the ring's dynamic shared memory, opted into once per kernel
  static const cudaError_t e4 = cudaFuncSetAttribute(
      tile_kernel<Pair, false, 4, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
  static const cudaError_t e1 = cudaFuncSetAttribute(
      tile_kernel<Pair, false, 1, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
  const cudaError_t err = vec ? e4 : e1;
  if (err != cudaSuccess) return err;
  const dim3 blocks((unsigned)tiles, (unsigned)splits);
  if (vec)
    tile_kernel<Pair, false, 4, true><<<blocks, T_THREADS, T_SMEM, stream>>>(
        x, y, sink, C, R, d, n_rtiles, run);
  else
    tile_kernel<Pair, false, 1, true><<<blocks, T_THREADS, T_SMEM, stream>>>(
        x, y, sink, C, R, d, n_rtiles, run);
  return cudaGetLastError();
}

// One launch of either path's first pass for C, R >= 1, with the checks of
// `launch` below; returns the launch's error code.
template <class Op, bool CEN>
inline cudaError_t launch_path(const float* x, const float* y, const Sink& sink, int64_t C,
                               int64_t R, int64_t d, int path, int grid, int splits,
                               cudaStream_t stream) {
  const bool vec = d % 4 == 0 && ((uintptr_t)x % 16) == 0 && ((uintptr_t)y % 16) == 0;
  if (C < 1 || R < 1 || d < 0 || grid < 1 || splits < 1) return cudaErrorInvalidValue;
  if (path == PATH_STREAM) {
    const int64_t M = C <= R ? C : R;
    if (M > S_MAX_SHORT) return cudaErrorInvalidValue;
    const int64_t slab = stream_slab(M, d, splits);
    if (slab == 0) return cudaErrorInvalidValue;
    return launch_stream<Op, CEN>(x, y, sink, C, R, d, StreamGeom{slab, 0, grid, 1}, vec,
                                  stream);
  }
  if (is_split(path)) {
    if constexpr (Op::kSplit && !CEN) {
      return launch_split_pass<Op>(x, y, sink.scratch, C, R, d, path, grid, splits, vec, stream);
    } else {
      return cudaErrorInvalidValue;   // no d split for this Op
    }
  }
  if (path == PATH_GEMM) {
    if constexpr (Op::kGemm) {
      const int64_t tiles = ((C + G_TILE - 1) / G_TILE) * ((R + G_TILE - 1) / G_TILE);
      if (splits != 1 || (int64_t)grid > tiles) return cudaErrorInvalidValue;
      const bool tma = vec && d > 0;
      CUtensorMap mx = {}, my = {};
      if (tma) {
        const cudaError_t e = gemm_tensor_map(&mx, x, C, d);
        if (e != cudaSuccess) return e;
        const cudaError_t f = gemm_tensor_map(&my, y, R, d);
        if (f != cudaSuccess) return f;
      }
      // the ring's dynamic shared memory, opted into once per kernel
      static const cudaError_t e4 = cudaFuncSetAttribute(
          gemm_kernel<Op, CEN, 4>, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
      static const cudaError_t e1 = cudaFuncSetAttribute(
          gemm_kernel<Op, CEN, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
      const cudaError_t err = tma ? e4 : e1;
      if (err != cudaSuccess) return err;
      if (tma)
        gemm_kernel<Op, CEN, 4><<<grid, G_THREADS, G_SMEM, stream>>>(mx, my, x, y, sink, C, R, d);
      else
        gemm_kernel<Op, CEN, 1><<<grid, G_THREADS, G_SMEM, stream>>>(mx, my, x, y, sink, C, R, d);
      return cudaGetLastError();
    } else {
      return cudaErrorInvalidValue;   // no gemm path for this Op
    }
  }
  if (path != PATH_TILE || splits > T_MAX_CLUSTER) return cudaErrorInvalidValue;
  const int64_t n_rtiles = (R + T_TILE - 1) / T_TILE;
  const int64_t tiles = ((C + T_TILE - 1) / T_TILE) * n_rtiles;
  if (tiles * splits != (int64_t)grid) return cudaErrorInvalidValue;
  const int64_t nsl = (d + T_BK - 1) / T_BK;
  const int64_t run = (nsl + splits - 1) / splits * T_BK;
  {   // the ring's dynamic shared memory, opted into once per kernel
    static const cudaError_t e4 = cudaFuncSetAttribute(
        tile_kernel<Op, CEN, 4>, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
    static const cudaError_t e1 = cudaFuncSetAttribute(
        tile_kernel<Op, CEN, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
    const cudaError_t err = vec ? e4 : e1;
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(T_THREADS);
  cfg.dynamicSmemBytes = T_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = vec ? cudaLaunchKernelEx(&cfg, tile_kernel<Op, CEN, 4>, x, y, sink, C, R, d,
                                             n_rtiles, run)
                        : cudaLaunchKernelEx(&cfg, tile_kernel<Op, CEN, 1>, x, y, sink, C, R, d,
                                             n_rtiles, run);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The sum over `ranks` ranks of p[q * stride], in rank order (in groups of
// 256 ranks): the d split's complete d sum of one pair.
__device__ __forceinline__ float rank_sum(const float* __restrict__ p, int64_t stride, int ranks) {
  float s = 0.f, g = 0.f;
  for (int q = 0; q < ranks; ++q) {
    g += p[(int64_t)q * stride];
    if ((q & 255) == 255) {
      s += g;
      g = 0.f;
    }
  }
  return s + g;
}

// The pairwise kernels' second pass of the d split: out[i] = the rank sum
// of the (ranks, C, R) scratch at i < n = C R.
__global__ void split_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int64_t n, int ranks) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = rank_sum(part + i, n, ranks);
}

// Launches one path on `stream` for C, R >= 1 and returns the launch's
// error code as an int. path, grid and splits come from pairwise_plan:
// stream path, `grid` blocks and `splits` d slabs; tile path, `grid` =
// tiles * splits blocks in clusters of `splits` along d; gemm path (Op::kGemm
// only), a persistent `grid` of at most one block a 128 x 128 tile, splits 1;
// the d split (Op::kSplit only), `splits` ranks of the stream path's blocks
// (`grid` / splits a rank) or of the tiles (`grid` = tiles * splits), into
// `scratch` (splits * C * R floats; null otherwise), then split_sum_kernel.
template <class Op>
inline int launch(const float* x, const float* y, float* out, float* scratch, int64_t C,
                  int64_t R, int64_t d, int path, int grid, int splits, cudaStream_t stream) {
  const Sink sink = {out, scratch, nullptr, nullptr, nullptr, nullptr};
  const cudaError_t err = launch_path<Op, false>(x, y, sink, C, R, d, path, grid, splits, stream);
  if (err != cudaSuccess || !is_split(path)) return (int)err;
  const int64_t n = C * R;
  split_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(scratch, out, n, splits);
  return (int)cudaGetLastError();
}

// out[c] = sum over rows k of partial[k, c]: one warp a column, lane l
// taking rows l, l + 32, ... in groups of 256 rows, then a shuffle tree.
// The order of every addition is fixed.
__global__ void reduce_rows_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                   int64_t C, int64_t rows) {
  const int64_t c = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= C) return;   // a warp-uniform exit
  float s = 0.f, g = 0.f;
  int count = 0;
  for (int64_t k = lane; k < rows; k += 32) {
    g += partial[k * C + c];
    if (++count == 256) {
      s += g;
      g = 0.f;
      count = 0;
    }
  }
  s += g;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[c] = s;
}

// The centrality kernels' second pass of the d split: S[c] = sum_r w[r] *
// Op::finish(the rank sum of the (ranks, C, R) scratch at (c, r), xaux[c],
// yaux[r]), one block of 32-256 threads a row c (split_centrality_threads):
// thread t takes r = t, t + blockDim.x, ... in groups of 256, then a
// shuffle tree in each warp and the warps' sums in warp order. A warp a row
// would leave the C-short rounds' thousands of references to a few warps.
constexpr int SPLIT_CEN_THREADS = 256;

inline int split_centrality_threads(int64_t R) {
  const int64_t warps = (R + 31) / 32;
  return 32 * (int)(warps < SPLIT_CEN_THREADS / 32 ? warps : SPLIT_CEN_THREADS / 32);
}

template <class Op>
__global__ void __launch_bounds__(SPLIT_CEN_THREADS)
split_centrality_kernel(const float* __restrict__ part, const Sink sink, int64_t R, int ranks) {
  __shared__ float warp_sums[SPLIT_CEN_THREADS / 32];
  const int64_t c = blockIdx.x;
  const int64_t CR = (int64_t)gridDim.x * R;
  const int lane = threadIdx.x & 31;
  const float xa = aux(sink.xaux, c);
  float s = 0.f, g = 0.f;
  int count = 0;
  for (int64_t r = threadIdx.x; r < R; r += blockDim.x) {
    const float dsum = rank_sum(part + c * R + r, CR, ranks);
    g += Op::finish(dsum, xa, aux(sink.yaux, r)) * weight(sink.w, r);
    if (++count == 256) {
      s += g;
      g = 0.f;
      count = 0;
    }
  }
  s += g;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += warp_sums[w];
    sink.out[c] = t;
  }
}

// The rows of partial one centrality launch writes for its second pass, or
// 1 when the first pass writes out directly: the grid of a C-short stream
// launch, the r-tiles of a tile or gemm launch.
inline int64_t centrality_rows(int64_t C, int64_t R, int path, int grid) {
  if (path == PATH_STREAM) return C <= R ? grid : 1;
  const int64_t tile = path == PATH_GEMM ? G_TILE : T_TILE;
  return (R + tile - 1) / tile;
}

// Fused centrality on the three paths: S[c] = sum_r w[r] *
// Op::finish(D[c, r], xaux[c], yaux[r]) for C, R >= 1 (Op: a Pair above plus
// a finish). path, grid and splits as for `launch` (centrality_plan in
// pairwise_distance.py). `scratch` holds C * R floats where the stream path
// takes several d slabs, `partial` centrality_rows * C floats where that
// exceeds 1; either may be null otherwise. Launches the first pass and, with
// several rows of partial, reduce_rows_kernel. The d split (Op::kSplit):
// `scratch` holds splits * C * R floats of partial Grams, summed by
// split_centrality_kernel; `partial` is unused.
template <class Op>
inline int launch_centrality(const float* x, const float* y, const float* xaux,
                             const float* yaux, const float* w, float* scratch, float* partial,
                             float* out, int64_t C, int64_t R, int64_t d, int path, int grid,
                             int splits, cudaStream_t stream) {
  if (C < 1 || R < 1 || d < 0 || grid < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  if (is_split(path)) {
    if constexpr (Op::kSplit) {
      const bool vec = d % 4 == 0 && ((uintptr_t)x % 16) == 0 && ((uintptr_t)y % 16) == 0;
      const cudaError_t err =
          launch_split_pass<GramPair>(x, y, scratch, C, R, d, path, grid, splits, vec, stream);
      if (err != cudaSuccess) return (int)err;
      const Sink sink = {out, nullptr, nullptr, w, xaux, yaux};
      split_centrality_kernel<Op><<<(unsigned)C, split_centrality_threads(R), 0, stream>>>(
          scratch, sink, R, splits);
      return (int)cudaGetLastError();
    } else {
      return (int)cudaErrorInvalidValue;   // no d split for this Op
    }
  }
  const int64_t rows = centrality_rows(C, R, path, grid);
  if (rows > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  if (path == PATH_STREAM) {
    const int64_t slab = stream_slab(C <= R ? C : R, d, splits);
    if (slab != 0 && slab < d && scratch == nullptr) return (int)cudaErrorInvalidValue;
  }
  const Sink sink = {out, scratch, rows > 1 ? partial : out, w, xaux, yaux};
  cudaError_t err = launch_path<Op, true>(x, y, sink, C, R, d, path, grid, splits, stream);
  if (err != cudaSuccess || rows == 1) return (int)err;
  const int64_t blocks = (C * 32 + 255) / 256;
  reduce_rows_kernel<<<(unsigned)blocks, 256, 0, stream>>>(partial, out, C, rows);
  return (int)cudaGetLastError();
}

}  // namespace pairwise
}  // namespace
