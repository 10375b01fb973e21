// Shared device helpers of the repro_torch kernels: 32-bit Montgomery
// arithmetic for word32 RNS (odd moduli q < 2^32; radix R = 2^32) and
// the NTT butterfly stages the keyswitch kernels are built from.
//
// Replaces repro/kernels/common.py. The TPU composed its 32x32->64
// product from four 16-bit parts because its lanes are 32-bit; Hopper
// has a native 64-bit product, and the Montgomery result in [0, q) is
// unique, so outputs equal the reference's u64 library arithmetic.
// Moduli reach 2^32 (paper_params_bootstrap draws the special prime
// 3221225473 = 3*2^30 + 1), so sums of two residues and the REDC sum are
// formed in 64 bits.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

// Largest row chunk a block keeps in shared memory (u32 elements). A
// full row at N = 65536 is 256 KB, above the 227 KB a block may use, so
// an NTT at that size runs its cross-chunk stages on registers and its
// local stages on one 64 KB chunk in shared memory.
constexpr int kChunk = 16384;
constexpr int kMaxThreads = 1024;

// a*b*2^-32 mod q for a, b < q < 2^32, qi = -q^-1 mod 2^32. The low
// words of t and m*q sum to 0 or exactly 2^32 (carry iff t's low word is
// not 0), so (t + m*q) / 2^32 is formed from the high words without a
// 65-bit sum; it is < 2q < 2^33.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t q, uint32_t qi) {
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(t) * qi;
  const uint64_t mq = static_cast<uint64_t>(m) * q;
  const uint64_t u = (t >> 32) + (mq >> 32) +
                     (static_cast<uint32_t>(t) != 0u ? 1u : 0u);
  return static_cast<uint32_t>(u >= q ? u - q : u);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint64_t r = static_cast<uint64_t>(a) + b;  // < 2q < 2^33
  return static_cast<uint32_t>(r >= q ? r - q : r);
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return a >= b ? a - b : a + (q - b);
}

// Number of chunks a row of n = 2^log_n splits into (1, 2 or 4); 0 if
// the row is larger than the kernels support.
inline int n_chunks(int log_n) {
  const int n = 1 << log_n;
  if (n <= kChunk) return 1;
  if (n == 2 * kChunk) return 2;
  if (n == 4 * kChunk) return 4;
  return 0;
}

inline int block_threads(int chunk) {
  const int half = chunk / 2;
  return half < 32 ? 32 : (half > kMaxThreads ? kMaxThreads : half);
}

// Forward Harvey CT NTT (core/ntt.py::ntt_forward, natural in ->
// bit-reversed out, Montgomery twiddles rp in the same layout), computing
// only chunk c (positions [c*C, (c+1)*C), C = n/NCH) of the output into
// shared `buf`. src(p) yields input element p. The first log2(NCH)
// stages mix the NCH positions i + s*C; each thread runs them in
// registers for its i, keeping the value that lands in chunk c. The
// remaining stages stay inside the chunk and run in shared memory.
// Ends with __syncthreads().
template <int NCH, class Src>
__device__ __forceinline__ void ntt_fwd_chunk(uint32_t* buf, Src src,
                                              const uint32_t* rp,
                                              uint32_t q, uint32_t qi,
                                              int n, int c) {
  const int C = n / NCH;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    uint32_t y[NCH];
#pragma unroll
    for (int s = 0; s < NCH; ++s) y[s] = src(i + s * C);
#pragma unroll
    for (int m = 1; m < NCH; m <<= 1) {
      const int tt = NCH / (2 * m);
#pragma unroll
      for (int g = 0; g < m; ++g) {
        const uint32_t w = rp[m + g];
#pragma unroll
        for (int k = 0; k < tt; ++k) {
          const int s0 = g * 2 * tt + k;
          const uint32_t u = y[s0];
          const uint32_t v = mont_mul(y[s0 + tt], w, q, qi);
          y[s0] = add_mod(u, v, q);
          y[s0 + tt] = sub_mod(u, v, q);
        }
      }
    }
    uint32_t o = y[0];
#pragma unroll
    for (int s = 1; s < NCH; ++s) o = (s == c) ? y[s] : o;
    buf[i] = o;
  }
  __syncthreads();
  for (int m = NCH; m < n; m <<= 1) {
    const int t = n / (2 * m);
    const int lt = __ffs(t) - 1;  // t is a power of two
    const int gbase = m + c * (C / (2 * t));
    for (int b = threadIdx.x; b < C / 2; b += blockDim.x) {
      const int g = b >> lt;
      const int p0 = (g << (lt + 1)) + (b & (t - 1));
      const uint32_t u = buf[p0];
      const uint32_t v = mont_mul(buf[p0 + t], rp[gbase + g], q, qi);
      buf[p0] = add_mod(u, v, q);
      buf[p0 + t] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
}

}  // namespace rt
