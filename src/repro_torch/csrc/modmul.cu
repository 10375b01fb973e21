// K4 (modular product) and K5 (modular multiply-accumulate) for Hopper
// (sm_90a), plain C entries loaded with ctypes by
// repro_torch/kernels/modmul.py.
//
// K4 replaces repro/kernels/modmul.py::_modmul_kernel (modmul.py:37). The
// wrapper puts b into Montgomery form, so mont_mul(a, b_mont) = a*b mod q.
// Row r of a (R, N) pairs with row r mod Rb of b (Rb, N): the engine's
// plaintext multiply hands the (B, 2, L) ciphertext rows with one (L, N)
// plaintext, which the reference tiled 2B times in device memory.
//
// What bounds it: bytes. Per element it reads 8 (a, int64) + 4 (b) and
// writes 8, for one Montgomery multiply, far below the card's
// operations-per-byte balance. Its design reads b once per row from L2
// (the plaintext is small and shared by all 2B rows), uses 64-bit
// accesses for a and out, and handles a ragged N by a bounds check
// instead of padding.
//
// K5 replaces repro/kernels/modmul.py::_mulacc_kernel (modmul.py:43):
// out = (a*b + c) mod q with the same row pairing, the evk
// multiply-accumulate of the staged keyswitch. Bound by bytes too (8 + 4
// + 8 read, 8 written per element); one thread an element, 64-bit loads
// of a and c, and the sum formed in 64 bits because q reaches 2^32.

#include "common.cuh"

__global__ void modmul_kernel(const int64_t* __restrict__ a,
                              const uint32_t* __restrict__ bm,
                              const uint32_t* __restrict__ qv,
                              const uint32_t* __restrict__ qiv,
                              int64_t* __restrict__ out, int Rb, int n) {
  const int r = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int rb = r % Rb;
  const size_t k = static_cast<size_t>(r) * n + col;
  out[k] = rt::mont_mul(static_cast<uint32_t>(a[k]),
                        bm[static_cast<size_t>(rb) * n + col], qv[rb],
                        qiv[rb]);
}

extern "C" int rt_modmul(const void* a, const void* bm, const void* q,
                         const void* qi, void* out, int R, int Rb, int n,
                         void* stream) {
  constexpr int kThreads = 256;
  const dim3 grid((n + kThreads - 1) / kThreads, R);
  modmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const uint32_t*>(bm),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(qi),
      static_cast<int64_t*>(out), Rb, n);
  return cudaGetLastError();
}

__global__ void mulacc_kernel(const int64_t* __restrict__ a,
                              const uint32_t* __restrict__ bm,
                              const int64_t* __restrict__ c,
                              const uint32_t* __restrict__ qv,
                              const uint32_t* __restrict__ qiv,
                              int64_t* __restrict__ out, int Rb, int n) {
  const int r = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int rb = r % Rb;
  const size_t k = static_cast<size_t>(r) * n + col;
  const uint32_t q = qv[rb];
  const uint32_t p = rt::mont_mul(static_cast<uint32_t>(a[k]),
                                  bm[static_cast<size_t>(rb) * n + col], q,
                                  qiv[rb]);
  out[k] = rt::add_mod(p, static_cast<uint32_t>(c[k]), q);
}

extern "C" int rt_mulacc(const void* a, const void* bm, const void* c,
                         const void* q, const void* qi, void* out, int R,
                         int Rb, int n, void* stream) {
  constexpr int kThreads = 256;
  const dim3 grid((n + kThreads - 1) / kThreads, R);
  mulacc_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const uint32_t*>(bm),
      static_cast<const int64_t*>(c), static_cast<const uint32_t*>(q),
      static_cast<const uint32_t*>(qi), static_cast<int64_t*>(out), Rb, n);
  return cudaGetLastError();
}
