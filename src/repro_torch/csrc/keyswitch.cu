// Fused CKKS keyswitch kernels K1-K3 for Hopper (sm_90a), plain C entries
// loaded with ctypes by repro_torch/kernels/keyswitch.py.
//
// Replace the Pallas kernels of repro/kernels/keyswitch.py:
//   K1 intt_scale        <- _intt_scale_kernel       (keyswitch.py:103)
//   K2 bconv_ntt_mulacc  <- _bconv_ntt_mulacc_kernel (keyswitch.py:113)
//   K3 moddown           <- _moddown_kernel          (keyswitch.py:144)
//
// What bounds them: each is a pass over u32 limb rows whose compulsory
// traffic is small (every input read once, every output written once)
// next to the NTT work done on it, and the NTT butterflies are integer
// multiply-adds with a dependent chain per stage; so they sit between
// the memory rate and the integer-multiply rate. Their design keeps NTT
// work out of device memory: the local stages of a row run on one chunk
// in shared memory (at most 16384 u32 = 64 KB), the few stages that
// cross chunks run in registers, and K2 keeps its two evk accumulators
// in shared memory across the whole digit loop, so a row is written to
// device memory once. Blocks never depend on one another: where a chunk
// needs values that belong to other chunks (the first stages of a
// forward NTT), the block recomputes them instead of synchronising.
//
// All tensors are u32 residues in int32 storage, row-major, contiguous.

#include "common.cuh"

using rt::add_mod;
using rt::mont_mul;
using rt::sub_mod;

// K1: per (batch r, limb j) row, GS inverse NTT without n^-1, then one
// Montgomery multiply by the limb's scale. Rows [row0, row0 + n_rows) of
// x (R, S, N) -> out (R, n_rows, N). grid (n_rows, R), one block a row.
// Local GS stages (strides < C) run chunk by chunk in shared memory and
// land in `out`; the cross-chunk stages then run in registers over out.
template <int NCH>
__global__ void __launch_bounds__(rt::kMaxThreads)
intt_scale_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                  const uint32_t* __restrict__ irp,
                  const uint32_t* __restrict__ qv,
                  const uint32_t* __restrict__ qiv,
                  const uint32_t* __restrict__ scv, int S, int row0,
                  int n_rows, int log_n) {
  extern __shared__ uint32_t buf[];
  const int j = blockIdx.x;
  const int r = blockIdx.y;
  const int n = 1 << log_n;
  const int C = n / NCH;
  const uint32_t q = qv[j], qi = qiv[j], sc = scv[j];
  const uint32_t* src = x + (static_cast<size_t>(r) * S + row0 + j) * n;
  uint32_t* dst = out + (static_cast<size_t>(r) * n_rows + j) * n;
  const uint32_t* w = irp + static_cast<size_t>(j) * n;

  for (int c = 0; c < NCH; ++c) {
    for (int i = threadIdx.x; i < C; i += blockDim.x) buf[i] = src[c * C + i];
    __syncthreads();
    for (int t = 1; t < C; t <<= 1) {
      const int lt = __ffs(t) - 1;
      const int gbase = n / (2 * t) + c * (C / (2 * t));
      for (int b = threadIdx.x; b < C / 2; b += blockDim.x) {
        const int g = b >> lt;
        const int p0 = (g << (lt + 1)) + (b & (t - 1));
        const uint32_t u = buf[p0], v = buf[p0 + t];
        buf[p0] = add_mod(u, v, q);
        buf[p0 + t] = mont_mul(sub_mod(u, v, q), w[gbase + g], q, qi);
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < C; i += blockDim.x)
      dst[c * C + i] = NCH == 1 ? mont_mul(buf[i], sc, q, qi) : buf[i];
    __syncthreads();
  }
  if (NCH == 1) return;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    uint32_t y[NCH];
#pragma unroll
    for (int s = 0; s < NCH; ++s) y[s] = dst[i + s * C];
#pragma unroll
    for (int m = NCH / 2; m >= 1; m >>= 1) {
      const int tt = NCH / (2 * m);
#pragma unroll
      for (int g = 0; g < m; ++g) {
        const uint32_t wg = w[m + g];
#pragma unroll
        for (int k = 0; k < tt; ++k) {
          const int s0 = g * 2 * tt + k;
          const uint32_t u = y[s0], v = y[s0 + tt];
          y[s0] = add_mod(u, v, q);
          y[s0 + tt] = mont_mul(sub_mod(u, v, q), wg, q, qi);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NCH; ++s) dst[i + s * C] = mont_mul(y[s], sc, q, qi);
  }
}

// K2: per (batch b, target limb t, chunk c): for every digit d, the BConv
// sum over the digit's source rows, the forward NTT, and the evk
// multiply-accumulate of both key components, with the digit loop inside
// the block and both accumulators resident in shared memory throughout.
// v (B, l, N); w (D, alpha, T); rp (T, N); ksk (D, 2, T, N) ->
// out (2, B, T, N). grid (NCH, T, B). Shared: 3 * C u32.
// Rows past l in the tail digit are skipped: the reference pads them with
// w = 0, which adds mont_mul(0, 0) = 0, so the sum is bit-equal.
template <int NCH>
__global__ void __launch_bounds__(rt::kMaxThreads)
bconv_ntt_mulacc_kernel(const uint32_t* __restrict__ v,
                        const uint32_t* __restrict__ wm,
                        const uint32_t* __restrict__ rp,
                        const uint32_t* __restrict__ qv,
                        const uint32_t* __restrict__ qiv,
                        const uint32_t* __restrict__ ksk,
                        uint32_t* __restrict__ out, int B, int l, int T,
                        int D, int alpha, int log_n) {
  extern __shared__ uint32_t sh[];
  const int c = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int n = 1 << log_n;
  const int C = n / NCH;
  uint32_t* buf = sh;
  uint32_t* a0 = sh + C;
  uint32_t* a1 = sh + 2 * C;
  const uint32_t q = qv[t], qi = qiv[t];
  const uint32_t* rpt = rp + static_cast<size_t>(t) * n;
  for (int d = 0; d < D; ++d) {
    const int j0 = d * alpha;
    const int j1 = min(j0 + alpha, l);
    const uint32_t* vd = v + (static_cast<size_t>(b) * l + j0) * n;
    const uint32_t* wd = wm + static_cast<size_t>(d) * alpha * T + t;
    auto bconv = [&](int p) {
      uint32_t acc = 0;
      for (int j = 0; j < j1 - j0; ++j)
        acc = add_mod(acc, mont_mul(vd[static_cast<size_t>(j) * n + p],
                                    wd[j * T], q, qi), q);
      return acc;
    };
    rt::ntt_fwd_chunk<NCH>(buf, bconv, rpt, q, qi, n, c);
    const uint32_t* k0 =
        ksk + (static_cast<size_t>(2 * d) * T + t) * n + c * C;
    const uint32_t* k1 =
        ksk + (static_cast<size_t>(2 * d + 1) * T + t) * n + c * C;
    for (int i = threadIdx.x; i < C; i += blockDim.x) {
      const uint32_t p0 = mont_mul(buf[i], k0[i], q, qi);
      const uint32_t p1 = mont_mul(buf[i], k1[i], q, qi);
      a0[i] = d == 0 ? p0 : add_mod(a0[i], p0, q);
      a1[i] = d == 0 ? p1 : add_mod(a1[i], p1, q);
    }
    __syncthreads();
  }
  const size_t row = (static_cast<size_t>(b) * T + t) * n + c * C;
  const size_t half = static_cast<size_t>(B) * T * n;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    out[row + i] = a0[i];
    out[half + row + i] = a1[i];
  }
}

// K3: per (batch b', Q-limb i, chunk c): BConv P->Q of the special limbs,
// forward NTT, subtraction from the Q-limb, times P^-1.
// g (2B, T, N); vp (2B, n_p, N); wpq (n_p, l); rp (T, N) (row i used);
// pinv (l) -> out (2B, l, N). grid (NCH, l, 2B). Shared: C u32.
template <int NCH>
__global__ void __launch_bounds__(rt::kMaxThreads)
moddown_kernel(const uint32_t* __restrict__ g,
               const uint32_t* __restrict__ vp,
               const uint32_t* __restrict__ wpq,
               const uint32_t* __restrict__ rp,
               const uint32_t* __restrict__ qv,
               const uint32_t* __restrict__ qiv,
               const uint32_t* __restrict__ pinv, uint32_t* __restrict__ out,
               int l, int T, int n_p, int log_n) {
  extern __shared__ uint32_t buf[];
  const int c = blockIdx.x, i = blockIdx.y, bb = blockIdx.z;
  const int n = 1 << log_n;
  const int C = n / NCH;
  const uint32_t q = qv[i], qi = qiv[i], pi = pinv[i];
  const uint32_t* vb = vp + static_cast<size_t>(bb) * n_p * n;
  auto bconv = [&](int p) {
    uint32_t acc = 0;
    for (int j = 0; j < n_p; ++j)
      acc = add_mod(acc, mont_mul(vb[static_cast<size_t>(j) * n + p],
                                  wpq[j * l + i], q, qi), q);
    return acc;
  };
  rt::ntt_fwd_chunk<NCH>(buf, bconv, rp + static_cast<size_t>(i) * n, q, qi,
                         n, c);
  const uint32_t* aq = g + (static_cast<size_t>(bb) * T + i) * n + c * C;
  uint32_t* o = out + (static_cast<size_t>(bb) * l + i) * n + c * C;
  for (int k = threadIdx.x; k < C; k += blockDim.x)
    o[k] = mont_mul(sub_mod(aq[k], buf[k], q), pi, q, qi);
}

// ---------------------------------------------------------------------------
// C entries: return the launch's cudaGetLastError() (0 on success)
// ---------------------------------------------------------------------------

// Opt the kernel into SMEM bytes of dynamic shared memory (above 48 KB it
// must ask), then launch it; a refused attribute is returned at once.
#define RT_LAUNCH(KERNEL, NCH, GRID, SMEM, STREAM, ...)                      \
  do {                                                                       \
    const int C_ = (1 << log_n) / (NCH);                                     \
    cudaError_t e_ = cudaFuncSetAttribute(                                   \
        KERNEL<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,            \
        static_cast<int>(SMEM));                                             \
    if (e_ != cudaSuccess) return e_;                                        \
    KERNEL<NCH><<<GRID, rt::block_threads(C_), SMEM, STREAM>>>(__VA_ARGS__); \
  } while (0)

extern "C" int rt_intt_scale(const void* x, void* out, const void* irp,
                             const void* q, const void* qi, const void* sc,
                             int R, int S, int row0, int n_rows, int log_n,
                             void* stream) {
  const int nch = rt::n_chunks(log_n);
  const dim3 grid(n_rows, R);
  const size_t smem = sizeof(uint32_t) * ((1 << log_n) / (nch ? nch : 1));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xu = static_cast<const uint32_t*>(x);
  auto* ou = static_cast<uint32_t*>(out);
  const auto* wu = static_cast<const uint32_t*>(irp);
  const auto* qu = static_cast<const uint32_t*>(q);
  const auto* qiu = static_cast<const uint32_t*>(qi);
  const auto* su = static_cast<const uint32_t*>(sc);
  switch (nch) {
    case 1: RT_LAUNCH(intt_scale_kernel, 1, grid, smem, st, xu, ou, wu, qu,
                      qiu, su, S, row0, n_rows, log_n); break;
    case 2: RT_LAUNCH(intt_scale_kernel, 2, grid, smem, st, xu, ou, wu, qu,
                      qiu, su, S, row0, n_rows, log_n); break;
    case 4: RT_LAUNCH(intt_scale_kernel, 4, grid, smem, st, xu, ou, wu, qu,
                      qiu, su, S, row0, n_rows, log_n); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int rt_bconv_ntt_mulacc(const void* v, const void* w,
                                   const void* rp, const void* q,
                                   const void* qi, const void* ksk,
                                   void* out, int B, int l, int T, int D,
                                   int alpha, int log_n, void* stream) {
  const int nch = rt::n_chunks(log_n);
  const dim3 grid(nch, T, B);
  const size_t smem =
      3 * sizeof(uint32_t) * ((1 << log_n) / (nch ? nch : 1));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* vu = static_cast<const uint32_t*>(v);
  const auto* wu = static_cast<const uint32_t*>(w);
  const auto* ru = static_cast<const uint32_t*>(rp);
  const auto* qu = static_cast<const uint32_t*>(q);
  const auto* qiu = static_cast<const uint32_t*>(qi);
  const auto* ku = static_cast<const uint32_t*>(ksk);
  auto* ou = static_cast<uint32_t*>(out);
  switch (nch) {
    case 1: RT_LAUNCH(bconv_ntt_mulacc_kernel, 1, grid, smem, st, vu, wu, ru,
                      qu, qiu, ku, ou, B, l, T, D, alpha, log_n); break;
    case 2: RT_LAUNCH(bconv_ntt_mulacc_kernel, 2, grid, smem, st, vu, wu, ru,
                      qu, qiu, ku, ou, B, l, T, D, alpha, log_n); break;
    case 4: RT_LAUNCH(bconv_ntt_mulacc_kernel, 4, grid, smem, st, vu, wu, ru,
                      qu, qiu, ku, ou, B, l, T, D, alpha, log_n); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int rt_moddown(const void* g, const void* vp, const void* wpq,
                          const void* rp, const void* q, const void* qi,
                          const void* pinv, void* out, int B2, int l, int T,
                          int n_p, int log_n, void* stream) {
  const int nch = rt::n_chunks(log_n);
  const dim3 grid(nch, l, B2);
  const size_t smem = sizeof(uint32_t) * ((1 << log_n) / (nch ? nch : 1));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* gu = static_cast<const uint32_t*>(g);
  const auto* vu = static_cast<const uint32_t*>(vp);
  const auto* wu = static_cast<const uint32_t*>(wpq);
  const auto* ru = static_cast<const uint32_t*>(rp);
  const auto* qu = static_cast<const uint32_t*>(q);
  const auto* qiu = static_cast<const uint32_t*>(qi);
  const auto* pu = static_cast<const uint32_t*>(pinv);
  auto* ou = static_cast<uint32_t*>(out);
  switch (nch) {
    case 1: RT_LAUNCH(moddown_kernel, 1, grid, smem, st, gu, vu, wu, ru, qu,
                      qiu, pu, ou, l, T, n_p, log_n); break;
    case 2: RT_LAUNCH(moddown_kernel, 2, grid, smem, st, gu, vu, wu, ru, qu,
                      qiu, pu, ou, l, T, n_p, log_n); break;
    case 4: RT_LAUNCH(moddown_kernel, 4, grid, smem, st, gu, vu, wu, ru, qu,
                      qiu, pu, ou, l, T, n_p, log_n); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
