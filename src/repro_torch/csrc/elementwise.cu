// The engine's modular elementwise passes for Hopper (sm_90a), plain C
// entries loaded with ctypes by repro_torch/kernels/elementwise.py:
//
//  * tensor:  the HMul tensor product (b0 b1, a0 b1 + a1 b0, a0 a1) of two
//             (B, 2, l, N) ciphertexts, equal to core/ops.tensor;
//  * combine: a keyswitch's result added back, written as one (B, 2, l, N)
//             ciphertext: [x0 + e0, x1 + e1] mod q (HMul) or [x0 + e0, e1]
//             (rotation), equal to torch.stack of core/modarith.addmod;
//  * addsub:  (a + b) mod q or (a - b) mod q of two (B, 2, l, N)
//             ciphertexts, equal to core/modarith.addmod / submod.
//
// They replace what the reference jits as one XLA fusion each
// (repro/compiler/engine.py: the tensor product and the combine of
// _hmul_fused and _galois_fused, and _addsub), where eager PyTorch runs a
// chain of int64 passes: 8 for each mulmod, 4 for each addmod, and a
// stack copy.
//
// What bounds them: bytes. Per element of a (B, l, N) plane the tensor
// product reads 4 int64 words and writes 3 (56 B) for 7 Montgomery
// products; the combine reads 4 and writes 2; addsub reads 2 and writes 1
// per element of (B, 2, l, N). So each thread handles two adjacent
// coefficients with 16-byte loads and stores where every operand row is
// 16-byte aligned, and one with 8-byte accesses otherwise; a block covers
// 256 threads of one row, so a row's modulus constants are read once per
// block. Operands may be views: each is given by its batch (and
// component) stride in elements, with limbs N apart and coefficients
// contiguous, so the engine's limb slices and the rotated ciphertext's
// b component are read in place, without a copy.
//
// Arithmetic: both factors of each product vary, so the exact product
// a*b mod q is mont_mul(mont_mul(a, b), R^2 mod q): a*b*R^-1 in [0, q),
// then times R^2 * R^-1; the Montgomery result in [0, q) is unique, so it
// equals core/modarith.mulmod's for any a, b < q. The middle term adds
// the two Montgomery products before the one conversion. Sums and
// differences are formed in signed 64 bits exactly as core/modarith's
// (q reaches 2^32: 3221225473 and 4293918721 are among the primes).

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// V consecutive int64 words (V = 1, or 2 from a 16-byte aligned address)
template <int V>
__device__ __forceinline__ void ld(const int64_t* p, int64_t* v) {
  if constexpr (V == 2) {
    const longlong2 x = *reinterpret_cast<const longlong2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void st(int64_t* p, const int64_t* v) {
  if constexpr (V == 2) {
    *reinterpret_cast<longlong2*>(p) = make_longlong2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// core/modarith.addmod and submod, on int64 as PyTorch forms them
__device__ __forceinline__ int64_t add64(int64_t a, int64_t b, int64_t q) {
  const int64_t r = a + b;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ int64_t sub64(int64_t a, int64_t b, int64_t q) {
  return a >= b ? a - b : a + (q - b);
}

// a*b mod q for a, b < q: both Montgomery conversions in one
__device__ __forceinline__ uint32_t mul_exact(uint32_t a, uint32_t b,
                                              uint32_t q, uint32_t qi,
                                              uint32_t r2) {
  return rt::mont_mul(rt::mont_mul(a, b, q, qi), r2, q, qi);
}

template <int V>
__global__ void tensor_kernel(const int64_t* __restrict__ d0,
                              const int64_t* __restrict__ d1,
                              const uint32_t* __restrict__ qv,
                              const uint32_t* __restrict__ qiv,
                              const uint32_t* __restrict__ r2v,
                              int64_t* __restrict__ t0,
                              int64_t* __restrict__ t1,
                              int64_t* __restrict__ d2, int l, int n,
                              int sb0, int sc0, int sb1, int sc1) {
  const int r = blockIdx.y;  // batch row b, limb j: r = b * l + j
  const int col = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (col >= n) return;
  const int b = r / l, j = r - b * l;
  const uint32_t q = qv[j], qi = qiv[j], r2 = r2v[j];
  const size_t row = static_cast<size_t>(j) * n + col;
  const int64_t* p0 = d0 + static_cast<size_t>(b) * sb0 + row;
  const int64_t* p1 = d1 + static_cast<size_t>(b) * sb1 + row;
  int64_t b0[V], a0[V], b1[V], a1[V], o0[V], o1[V], o2[V];
  ld<V>(p0, b0);
  ld<V>(p0 + sc0, a0);
  ld<V>(p1, b1);
  ld<V>(p1 + sc1, a1);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const uint32_t xb0 = static_cast<uint32_t>(b0[k]);
    const uint32_t xa0 = static_cast<uint32_t>(a0[k]);
    const uint32_t xb1 = static_cast<uint32_t>(b1[k]);
    const uint32_t xa1 = static_cast<uint32_t>(a1[k]);
    o0[k] = mul_exact(xb0, xb1, q, qi, r2);
    const uint32_t mid = rt::add_mod(rt::mont_mul(xa0, xb1, q, qi),
                                     rt::mont_mul(xa1, xb0, q, qi), q);
    o1[k] = rt::mont_mul(mid, r2, q, qi);
    o2[k] = mul_exact(xa0, xa1, q, qi, r2);
  }
  const size_t o = static_cast<size_t>(r) * n + col;
  st<V>(t0 + o, o0);
  st<V>(t1 + o, o1);
  st<V>(d2 + o, o2);
}

template <int V>
__global__ void combine_kernel(const int64_t* __restrict__ x0,
                               const int64_t* __restrict__ x1,
                               const int64_t* __restrict__ e0,
                               const int64_t* __restrict__ e1,
                               const uint32_t* __restrict__ qv,
                               int64_t* __restrict__ out, int l, int n,
                               int sx0, int sx1, int se0, int se1) {
  const int r = blockIdx.y;  // r = b * l + j
  const int col = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (col >= n) return;
  const int b = r / l, j = r - b * l;
  const int64_t q = qv[j];
  const size_t row = static_cast<size_t>(j) * n + col;
  int64_t u[V], e[V], y0[V], y1[V];
  ld<V>(x0 + static_cast<size_t>(b) * sx0 + row, u);
  ld<V>(e0 + static_cast<size_t>(b) * se0 + row, e);
#pragma unroll
  for (int k = 0; k < V; ++k) y0[k] = add64(u[k], e[k], q);
  ld<V>(e1 + static_cast<size_t>(b) * se1 + row, e);
  if (x1 != nullptr) {
    ld<V>(x1 + static_cast<size_t>(b) * sx1 + row, u);
#pragma unroll
    for (int k = 0; k < V; ++k) y1[k] = add64(u[k], e[k], q);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) y1[k] = e[k];
  }
  // out is (B, 2, l, N): component 0 of batch b, then component 1
  const size_t o = (static_cast<size_t>(b) * 2 * l + j) * n + col;
  st<V>(out + o, y0);
  st<V>(out + o + static_cast<size_t>(l) * n, y1);
}

template <int V>
__global__ void addsub_kernel(const int64_t* __restrict__ a,
                              const int64_t* __restrict__ b,
                              const uint32_t* __restrict__ qv,
                              int64_t* __restrict__ out, int l, int n,
                              int sba, int sca, int sbb, int scb, int sub) {
  const int r = blockIdx.y;  // batch row i, component c, limb j
  const int col = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (col >= n) return;
  const int i = r / (2 * l), c = (r / l) & 1, j = r % l;
  const int64_t q = qv[j];
  const size_t row = static_cast<size_t>(j) * n + col;
  int64_t x[V], y[V], z[V];
  ld<V>(a + static_cast<size_t>(i) * sba + static_cast<size_t>(c) * sca +
            row, x);
  ld<V>(b + static_cast<size_t>(i) * sbb + static_cast<size_t>(c) * scb +
            row, y);
  if (sub) {
#pragma unroll
    for (int k = 0; k < V; ++k) z[k] = sub64(x[k], y[k], q);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) z[k] = add64(x[k], y[k], q);
  }
  st<V>(out + static_cast<size_t>(r) * n + col, z);
}

// 16-byte accesses need every row of every operand 16-byte aligned: N
// and the strides even, each base address a multiple of 16
bool aligned16(std::initializer_list<const void*> ptrs, int n,
               std::initializer_list<int> strides) {
  if (n % 2) return false;
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int s : strides)
    if (s % 2) return false;
  return true;
}

template <int V>
dim3 grid(int n, int rows) {
  return dim3((n + V * kThreads - 1) / (V * kThreads), rows);
}

template <int V>
void tensor_launch(const void* d0, const void* d1, const void* q,
                   const void* qi, const void* r2, void* t0, void* t1,
                   void* d2, int B, int l, int n, int sb0, int sc0, int sb1,
                   int sc1, cudaStream_t s) {
  tensor_kernel<V><<<grid<V>(n, B * l), kThreads, 0, s>>>(
      static_cast<const int64_t*>(d0), static_cast<const int64_t*>(d1),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(qi),
      static_cast<const uint32_t*>(r2), static_cast<int64_t*>(t0),
      static_cast<int64_t*>(t1), static_cast<int64_t*>(d2), l, n, sb0, sc0,
      sb1, sc1);
}

template <int V>
void combine_launch(const void* x0, const void* x1, const void* e0,
                    const void* e1, const void* q, void* out, int B, int l,
                    int n, int sx0, int sx1, int se0, int se1,
                    cudaStream_t s) {
  combine_kernel<V><<<grid<V>(n, B * l), kThreads, 0, s>>>(
      static_cast<const int64_t*>(x0), static_cast<const int64_t*>(x1),
      static_cast<const int64_t*>(e0), static_cast<const int64_t*>(e1),
      static_cast<const uint32_t*>(q), static_cast<int64_t*>(out), l, n, sx0,
      sx1, se0, se1);
}

template <int V>
void addsub_launch(const void* a, const void* b, const void* q, void* out,
                   int B, int l, int n, int sba, int sca, int sbb, int scb,
                   int sub, cudaStream_t s) {
  addsub_kernel<V><<<grid<V>(n, B * 2 * l), kThreads, 0, s>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b),
      static_cast<const uint32_t*>(q), static_cast<int64_t*>(out), l, n, sba,
      sca, sbb, scb, sub);
}

}  // namespace

extern "C" int rt_tensor(const void* d0, const void* d1, const void* q,
                         const void* qi, const void* r2, void* t0, void* t1,
                         void* d2, int B, int l, int n, int sb0, int sc0,
                         int sb1, int sc1, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (aligned16({d0, d1, t0, t1, d2}, n, {sb0, sc0, sb1, sc1})) {
    tensor_launch<2>(d0, d1, q, qi, r2, t0, t1, d2, B, l, n, sb0, sc0, sb1,
                     sc1, s);
  } else {
    tensor_launch<1>(d0, d1, q, qi, r2, t0, t1, d2, B, l, n, sb0, sc0, sb1,
                     sc1, s);
  }
  return cudaGetLastError();
}

extern "C" int rt_combine(const void* x0, const void* x1, const void* e0,
                          const void* e1, const void* q, void* out, int B,
                          int l, int n, int sx0, int sx1, int se0, int se1,
                          void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (aligned16({x0, x1, e0, e1, out}, n, {sx0, sx1, se0, se1})) {
    combine_launch<2>(x0, x1, e0, e1, q, out, B, l, n, sx0, sx1, se0, se1,
                      s);
  } else {
    combine_launch<1>(x0, x1, e0, e1, q, out, B, l, n, sx0, sx1, se0, se1,
                      s);
  }
  return cudaGetLastError();
}

extern "C" int rt_addsub(const void* a, const void* b, const void* q,
                         void* out, int B, int l, int n, int sba, int sca,
                         int sbb, int scb, int sub, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (aligned16({a, b, out}, n, {sba, sca, sbb, scb})) {
    addsub_launch<2>(a, b, q, out, B, l, n, sba, sca, sbb, scb, sub, s);
  } else {
    addsub_launch<1>(a, b, q, out, B, l, n, sba, sca, sbb, scb, sub, s);
  }
  return cudaGetLastError();
}
