// Med-dit's draws for one chunk of K steps, in one launch.
//
// No TPU kernel corresponds: in the JAX package (src/repro/core/meddit.py)
// XLA fuses each step's draws into the body of the lax.while_loop. Step k
// of that loop splits the key, key, sub_k = split(key), and draws the
// step's B references, randint(sub_k, (B,), 0, n). The port runs the loop
// in chunks of K masked steps (a captured CUDA graph) and makes all of a
// chunk's draws here first: the K subs, the key after the chunk and the
// (K, B) int32 references, bit-equal to jax.random's threefry2x32 stream
// (impl threefry2x32, jax_threefry_partitionable=True):
//
//   split(key)[i]     = threefry2x32(key, (0, i))
//   bits(key, B)[b]   = hi ^ lo of threefry2x32(key, (0, b))
//   randint(key, ...) : k1, k2 = split(key); hi = bits(k1), lo = bits(k2);
//                       mult = (2^16 % n)^2 % n and
//                       ref = ((hi % n) * mult + lo % n) % n,
//                       every product and sum wrapping at 2^32 (uint32).
//
// The key chain is sequential: sub_k needs the key after k splits, so no
// amount of parallelism computes it faster than one thread walking it. Each
// block of 256 threads owns 256 consecutive references (steps k_lo..k_hi);
// its thread 0 walks the chain from the chunk's key up to k_hi and keeps
// the subs of its steps in shared memory, then every thread draws its
// reference (four hashes: k1, k2, then hi and lo). Blocks walk their
// prefixes of the chain at once, so the launch takes about one walk of K
// steps and one draw; the redundant walks cost O(K^2 B / 256) hashes in
// all, nothing against the card's integer rate. The block that owns a
// step's first reference writes its sub, and the last block writes the key
// after the chunk.
//
// Bound on an H100: the launch writes 4 K B + 16 K + 16 bytes (under a
// microsecond at K B = 64000); the chain's K sequential hashes bound it
// (each split hashes two counters, which run side by side). A hash is
// twenty rounds whose add and rotate-xor depend on each other, about two
// dependent integer instructions a round.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// threefry2x32 with 20 rounds: (k0, k1) the key, (x0, x1) the counter in
// and the hash out (jax._src.prng.threefry2x32, the same rotations and key
// schedule).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ PARITY;
  x0 += k0; x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
}

// Child i of split(key): threefry2x32(key, (0, i)).
__device__ __forceinline__ void child(uint32_t k0, uint32_t k1, uint32_t i, uint32_t& c0,
                                      uint32_t& c1) {
  c0 = 0u; c1 = i;
  threefry(k0, k1, c0, c1);
}

// bits(key, .)[b]: hi ^ lo of threefry2x32(key, (0, b)).
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1, uint32_t b) {
  uint32_t x0 = 0u, x1 = b;
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

__global__ void __launch_bounds__(THREADS)
draws_kernel(const int64_t* __restrict__ key, int64_t* __restrict__ subs,
             int64_t* __restrict__ next_key, int32_t* __restrict__ refs, long long K,
             long long B, uint32_t span) {
  // steps k_lo..k_hi hold this block's references; at most THREADS + 1 of
  // them (B = 1 gives THREADS)
  __shared__ uint32_t sub_words[THREADS + 1][2];
  const long long total = K * B;
  const long long lo = (long long)blockIdx.x * THREADS;
  const long long hi = min(lo + THREADS, total);   // exclusive
  const long long k_lo = lo / B, k_hi = (hi - 1) / B;
  if (threadIdx.x == 0) {
    uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
    for (long long k = 0; k <= k_hi; ++k) {
      uint32_t n0, n1, s0, s1;
      child(k0, k1, 0u, n0, n1);   // the key after this step
      child(k0, k1, 1u, s0, s1);   // the step's sub
      if (k >= k_lo) {
        sub_words[k - k_lo][0] = s0;
        sub_words[k - k_lo][1] = s1;
        if (k * B >= lo) {           // this block owns the step's first draw
          subs[2 * k] = s0;
          subs[2 * k + 1] = s1;
        }
      }
      k0 = n0; k1 = n1;
    }
    if (hi == total) {
      next_key[0] = k0;
      next_key[1] = k1;
    }
  }
  __syncthreads();
  const long long i = lo + threadIdx.x;
  if (i >= hi) return;
  const long long k = i / B;
  const uint32_t b = (uint32_t)(i - k * B);
  const uint32_t s0 = sub_words[k - k_lo][0], s1 = sub_words[k - k_lo][1];
  uint32_t a0, a1, c0, c1;
  child(s0, s1, 0u, a0, a1);   // k1 of randint
  child(s0, s1, 1u, c0, c1);   // k2 of randint
  const uint32_t hbits = bits_at(a0, a1, b), lbits = bits_at(c0, c1, b);
  uint32_t mult = (65536u % span);
  mult = (mult * mult) % span;                     // wraps at 2^32, as uint32
  const uint32_t off = ((hbits % span) * mult + lbits % span) % span;
  refs[i] = (int32_t)off;
}

}  // namespace

// key: (2,) int64 words of the chunk's first key (low 32 bits used); subs:
// (K, 2) int64; next_key: (2,) int64; refs: (K, B) int32 in [0, n).
extern "C" int threefry_draws_launch(const int64_t* key, int64_t* subs, int64_t* next_key,
                                     int32_t* refs, long long K, long long B, long long n,
                                     cudaStream_t stream) {
  if (K < 1 || B < 1 || n < 1 || n > 0x7FFFFFFFLL || K > 0x7FFFFFFFLL / B)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (K * B + THREADS - 1) / THREADS;
  draws_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(key, subs, next_key, refs, K, B,
                                                         (uint32_t)n);
  return (int)cudaGetLastError();
}
