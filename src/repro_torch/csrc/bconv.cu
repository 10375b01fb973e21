// K6: the BConv accumulation for Hopper (sm_90a), plain C entry loaded
// with ctypes by repro_torch/kernels/bconv.py.
//
//   out[d, n] = sum_j v[j, n] * w[j, d]  (mod p_d)
//
// Replaces repro/kernels/bconv.py::_bconv_kernel (bconv.py:27, eager) and
// ::_bconv_kernel_lazy (bconv.py:39), as one template with a LAZY flag.
// Eager reduces every product and adds it mod p; lazy adds two reduced
// products in 64 bits, folds the pair once, then adds it mod p (what the
// reference code does; its docstring's "(hi, lo) pairs, fold every 4"
// does not). Both are exact, so both give the same output.
//
// v[j] is reduced mod its own source prime, which may exceed p_d (ModDown
// converts from P, which holds the 32-bit prime 3221225473). v < 2^32 and
// w < p_d keep the REDC input below p_d * 2^32, so mont_mul still returns
// a value below p_d. The pair and every sum are formed in 64 bits: p_d
// reaches 2^32 (the staged keyswitch converts into the 32-bit prime).
//
// What bounds it: bytes. It reads S int64 rows and writes D int64 rows,
// for S*D Montgomery products per column, about 0.2 operations a byte at
// S = 6, D = 21, far below the card's balance. The TPU grid was
// (D, N/512), reading v once per output prime. Here a block owns a run of
// columns for all D outputs: it reads its S x 256 tile of v once into
// shared memory, with the (D, S) weights beside it, and every thread
// walks the D outputs of its column, so each output store is coalesced
// and v is read from device memory once. A ragged N is a bounds check.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool LAZY>
__global__ void __launch_bounds__(kThreads)
bconv_kernel(const int64_t* __restrict__ v, const uint32_t* __restrict__ w,
             const uint32_t* __restrict__ pv, const uint32_t* __restrict__ piv,
             int64_t* __restrict__ out, int S, int D, int n) {
  extern __shared__ uint32_t sm[];
  uint32_t* ws = sm;               // (D, S) Montgomery weights
  uint32_t* vs = sm + D * S;       // (S, kThreads) source tile
  const int t = threadIdx.x;
  for (int i = t; i < D * S; i += kThreads) ws[i] = w[i];
  const int col = blockIdx.x * kThreads + t;
  const bool live = col < n;
  for (int j = 0; j < S; ++j)
    vs[j * kThreads + t] =
        live ? static_cast<uint32_t>(v[static_cast<size_t>(j) * n + col]) : 0u;
  __syncthreads();
  if (!live) return;
  for (int d = 0; d < D; ++d) {
    const uint32_t p = pv[d], pi = piv[d];
    const uint32_t* wd = ws + d * S;
    uint32_t acc = 0;
    int j = 0;
    if (LAZY) {
      for (; j + 1 < S; j += 2) {
        const uint64_t pair =
            static_cast<uint64_t>(rt::mont_mul(vs[j * kThreads + t], wd[j], p, pi)) +
            rt::mont_mul(vs[(j + 1) * kThreads + t], wd[j + 1], p, pi);
        // pair < 2p: one fold reduces it
        acc = rt::add_mod(acc, static_cast<uint32_t>(pair >= p ? pair - p : pair), p);
      }
    }
    for (; j < S; ++j)
      acc = rt::add_mod(acc, rt::mont_mul(vs[j * kThreads + t], wd[j], p, pi), p);
    out[static_cast<size_t>(d) * n + col] = acc;
  }
}

template <bool LAZY>
int launch(const void* v, const void* w, const void* p, const void* pi,
           void* out, int S, int D, int n, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * (static_cast<size_t>(D) * S +
                                          static_cast<size_t>(S) * kThreads);
  cudaError_t err = cudaFuncSetAttribute(
      bconv_kernel<LAZY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kThreads - 1) / kThreads);
  bconv_kernel<LAZY><<<grid, kThreads, smem, stream>>>(
      static_cast<const int64_t*>(v), static_cast<const uint32_t*>(w),
      static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(pi),
      static_cast<int64_t*>(out), S, D, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_bconv(const void* v, const void* w, const void* p,
                        const void* pi, void* out, int S, int D, int n,
                        int lazy, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return lazy ? launch<true>(v, w, p, pi, out, S, D, n, s)
              : launch<false>(v, w, p, pi, out, S, D, n, s);
}
