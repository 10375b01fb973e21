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
// device memory once.
//
// K1's blocks never depend on one another: each owns a whole row. K2 and
// K3 run a row's forward NTT as one thread-block cluster of its chunk
// blocks (rt::ntt_fwd_cluster, common.cuh), so each BConv output is
// formed once in the grid and reaches the other chunks through
// distributed shared memory; their butterflies run as radix-16 passes in
// registers with 3 block barriers at C = 16384 instead of one a stage.
// They need sm_90's cluster launch (cudaLaunchKernelEx).
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

// K2: per (batch b, target limb t) row, one cluster of NCH chunk blocks:
// for every digit d, the BConv sum over the digit's source rows, the
// forward NTT (rt::ntt_fwd_cluster) and the evk multiply-accumulate of
// both key components in the last pass's registers, with the digit loop
// inside the block. The accumulators of digits before the last live in
// shared memory at the thread's own output positions; the last digit
// writes them to out.
// v (B, l, N); w (D, alpha, T); rp (T, N); ksk (D, 2, T, N) ->
// out (2, B, T, N). grid (NCH, B, T): the B rows that share one tile of
// ksk run together. Shared: Sched::kSmem + 2 * C u32.
// Rows past l in the tail digit are skipped: the reference pads them with
// w = 0, which adds mont_mul(0, 0) = 0, so the sum is bit-equal.
template <int NCH, int LOGC>
__global__ void __launch_bounds__(rt::Sched<NCH, LOGC>::kThreads, 1)
bconv_ntt_mulacc_kernel(const uint32_t* __restrict__ v,
                        const uint32_t* __restrict__ wm,
                        const uint32_t* __restrict__ rp,
                        const uint32_t* __restrict__ qv,
                        const uint32_t* __restrict__ qiv,
                        const uint32_t* __restrict__ ksk,
                        uint32_t* __restrict__ out, int B, int l, int T,
                        int D, int alpha) {
  using S = rt::Sched<NCH, LOGC>;
  constexpr int V = S::kLast >= 2 ? 4 : 2;  // contiguous outputs a run
  extern __shared__ __align__(16) uint32_t sh[];
  const int c = blockIdx.x, b = blockIdx.y, t = blockIdx.z;
  const int n = NCH * S::C;
  uint32_t* buf = sh;
  uint32_t* a0 = sh + S::kSmem;
  uint32_t* a1 = a0 + S::C;
  const uint32_t q = qv[t], qi = qiv[t];
  const uint32_t* rpt = rp + static_cast<size_t>(t) * n;
  const size_t row = (static_cast<size_t>(b) * T + t) * n + c * S::C;
  const size_t half = static_cast<size_t>(B) * T * n;
  for (int d = 0; d < D; ++d) {
    const int j0 = d * alpha;
    const int nj = min(alpha, l - j0);
    const uint32_t* vd = v + (static_cast<size_t>(b) * l + j0) * n + c * S::C;
    const uint32_t* wd = wm + static_cast<size_t>(d) * alpha * T + t;
    auto conv = [&](int p, uint32_t* o) {
      o[0] = o[1] = o[2] = o[3] = 0;
      for (int j = 0; j < nj; ++j) {
        const uint32_t w = wd[j * T];
        uint32_t x[4];
        rt::ldv<4>(vd + static_cast<size_t>(j) * n + p, x);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = add_mod(o[e], mont_mul(x[e], w, q, qi), q);
      }
    };
    const uint32_t* k0 =
        ksk + (static_cast<size_t>(2 * d) * T + t) * n + c * S::C;
    const uint32_t* k1 = k0 + static_cast<size_t>(T) * n;
    auto epi = [&](const uint32_t* y) {
#pragma unroll
      for (int r = 0; r < rt::kVals / V; ++r) {
        const int p = S::last_pos(threadIdx.x, r * V);
        uint32_t x0[V], x1[V], p0[V], p1[V];
        rt::ldv<V>(k0 + p, x0);
        rt::ldv<V>(k1 + p, x1);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          p0[e] = mont_mul(y[r * V + e], x0[e], q, qi);
          p1[e] = mont_mul(y[r * V + e], x1[e], q, qi);
        }
        if (d > 0) {
          rt::ldv<V>(a0 + p, x0);
          rt::ldv<V>(a1 + p, x1);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            p0[e] = add_mod(x0[e], p0[e], q);
            p1[e] = add_mod(x1[e], p1[e], q);
          }
        }
        if (d == D - 1) {
          rt::stv<V>(out + row + p, p0);
          rt::stv<V>(out + half + row + p, p1);
        } else {
          rt::stv<V>(a0 + p, p0);
          rt::stv<V>(a1 + p, p1);
        }
      }
    };
    rt::ntt_fwd_cluster<NCH, LOGC>(buf, conv, epi, rpt, q, qi, c);
    // the next digit's BConv writes the runs of 4 this thread just read,
    // unless the last pass read other positions
    if (S::kLast != 2) __syncthreads();
  }
}

// K3: per (batch b', Q-limb i) row, one cluster of NCH chunk blocks:
// BConv P->Q of the special limbs, forward NTT (rt::ntt_fwd_cluster), and
// in the last pass's registers the subtraction from the Q-limb and the
// product by P^-1.
// g (2B, T, N); vp (2B, n_p, N); wpq (n_p, l); rp (T, N) (row i used);
// pinv (l) -> out (2B, l, N). grid (NCH, l, 2B). Shared: Sched::kSmem u32.
template <int NCH, int LOGC>
__global__ void __launch_bounds__(rt::Sched<NCH, LOGC>::kThreads, 1)
moddown_kernel(const uint32_t* __restrict__ g,
               const uint32_t* __restrict__ vp,
               const uint32_t* __restrict__ wpq,
               const uint32_t* __restrict__ rp,
               const uint32_t* __restrict__ qv,
               const uint32_t* __restrict__ qiv,
               const uint32_t* __restrict__ pinv, uint32_t* __restrict__ out,
               int l, int T, int n_p) {
  using S = rt::Sched<NCH, LOGC>;
  constexpr int V = S::kLast >= 2 ? 4 : 2;
  extern __shared__ __align__(16) uint32_t sh[];
  const int c = blockIdx.x, i = blockIdx.y, bb = blockIdx.z;
  const int n = NCH * S::C;
  const uint32_t q = qv[i], qi = qiv[i], pi = pinv[i];
  const uint32_t* vb = vp + static_cast<size_t>(bb) * n_p * n + c * S::C;
  auto conv = [&](int p, uint32_t* o) {
    o[0] = o[1] = o[2] = o[3] = 0;
    for (int j = 0; j < n_p; ++j) {
      const uint32_t w = wpq[j * l + i];
      uint32_t x[4];
      rt::ldv<4>(vb + static_cast<size_t>(j) * n + p, x);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = add_mod(o[e], mont_mul(x[e], w, q, qi), q);
    }
  };
  const uint32_t* aq = g + (static_cast<size_t>(bb) * T + i) * n + c * S::C;
  uint32_t* o = out + (static_cast<size_t>(bb) * l + i) * n + c * S::C;
  auto epi = [&](const uint32_t* y) {
#pragma unroll
    for (int r = 0; r < rt::kVals / V; ++r) {
      const int p = S::last_pos(threadIdx.x, r * V);
      uint32_t x[V];
      rt::ldv<V>(aq + p, x);
#pragma unroll
      for (int e = 0; e < V; ++e)
        x[e] = mont_mul(sub_mod(x[e], y[r * V + e], q), pi, q, qi);
      rt::stv<V>(o + p, x);
    }
  };
  rt::ntt_fwd_cluster<NCH, LOGC>(sh, conv, epi,
                                 rp + static_cast<size_t>(i) * n, q, qi, c);
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

// One launch of a cluster kernel (K2, K3): grid (NCH, y, z) in clusters of
// (NCH, 1, 1), none for NCH = 1. With `info` set, nothing is launched: the
// launch's shape, cudaOccupancyMaxActiveClusters (blocks per SM times SMs
// for NCH = 1), registers and local memory per thread are written there.
struct ClusterLaunch {
  dim3 grid;
  int threads;
  size_t smem;
  int nch;
  cudaStream_t stream;
  int* info;  // [grid x, y, z, cluster, threads, smem, active clusters,
              //  registers, local bytes]
};

template <class... P, class... A>
static int cluster_launch(const ClusterLaunch& L, void (*kernel)(P...),
                          A... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.nch;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = L.grid;
  cfg.blockDim = dim3(L.threads);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = L.stream;
  cfg.attrs = attr;
  cfg.numAttrs = L.nch > 1 ? 1 : 0;
  if (L.info == nullptr) {
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }
  int active = 0;
  if (L.nch > 1) {
    e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  } else {
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&active, kernel,
                                                        L.threads, L.smem);
    active *= sms;
  }
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  const int vals[9] = {static_cast<int>(L.grid.x), static_cast<int>(L.grid.y),
                       static_cast<int>(L.grid.z), L.nch, L.threads,
                       static_cast<int>(L.smem), active, fa.numRegs,
                       static_cast<int>(fa.localSizeBytes)};
  for (int k = 0; k < 9; ++k) L.info[k] = vals[k];
  return cudaSuccess;
}

// (NCH, LOGC) of a row of 2^log_n: one chunk up to rt::kChunk words, then
// clusters of 2 and 4 chunks of rt::kChunk.
#define RT_BY_LOG_N(FN, ...)                                   \
  switch (log_n) {                                             \
    case 5: return FN<1, 5>(__VA_ARGS__);                      \
    case 6: return FN<1, 6>(__VA_ARGS__);                      \
    case 7: return FN<1, 7>(__VA_ARGS__);                      \
    case 8: return FN<1, 8>(__VA_ARGS__);                      \
    case 9: return FN<1, 9>(__VA_ARGS__);                      \
    case 10: return FN<1, 10>(__VA_ARGS__);                    \
    case 11: return FN<1, 11>(__VA_ARGS__);                    \
    case 12: return FN<1, 12>(__VA_ARGS__);                    \
    case 13: return FN<1, 13>(__VA_ARGS__);                    \
    case 14: return FN<1, 14>(__VA_ARGS__);                    \
    case 15: return FN<2, 14>(__VA_ARGS__);                    \
    case 16: return FN<4, 14>(__VA_ARGS__);                    \
    default: return cudaErrorInvalidValue;                     \
  }
static_assert(rt::kChunk == 1 << 14, "RT_BY_LOG_N assumes 16384-word chunks");

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

static const uint32_t* U(const void* p) {
  return static_cast<const uint32_t*>(p);
}

template <int NCH, int LOGC>
static int k2_launch(int* info, cudaStream_t st, const uint32_t* v,
                     const uint32_t* w, const uint32_t* rp,
                     const uint32_t* q, const uint32_t* qi,
                     const uint32_t* ksk, uint32_t* out, int B, int l, int T,
                     int D, int alpha) {
  using S = rt::Sched<NCH, LOGC>;
  const ClusterLaunch L{dim3(NCH, B, T), S::kThreads,
                        sizeof(uint32_t) * (S::kSmem + 2 * S::C), NCH, st,
                        info};
  return cluster_launch(L, bconv_ntt_mulacc_kernel<NCH, LOGC>, v, w, rp, q,
                        qi, ksk, out, B, l, T, D, alpha);
}

template <int NCH, int LOGC>
static int k3_launch(int* info, cudaStream_t st, const uint32_t* g,
                     const uint32_t* vp, const uint32_t* wpq,
                     const uint32_t* rp, const uint32_t* q,
                     const uint32_t* qi, const uint32_t* pinv, uint32_t* out,
                     int B2, int l, int T, int n_p) {
  using S = rt::Sched<NCH, LOGC>;
  const ClusterLaunch L{dim3(NCH, l, B2), S::kThreads,
                        sizeof(uint32_t) * S::kSmem, NCH, st, info};
  return cluster_launch(L, moddown_kernel<NCH, LOGC>, g, vp, wpq, rp, q, qi,
                        pinv, out, l, T, n_p);
}

extern "C" int rt_bconv_ntt_mulacc(const void* v, const void* w,
                                   const void* rp, const void* q,
                                   const void* qi, const void* ksk,
                                   void* out, int B, int l, int T, int D,
                                   int alpha, int log_n, void* stream) {
  RT_BY_LOG_N(k2_launch, nullptr, static_cast<cudaStream_t>(stream), U(v),
              U(w), U(rp), U(q), U(qi), U(ksk), static_cast<uint32_t*>(out),
              B, l, T, D, alpha)
}

extern "C" int rt_moddown(const void* g, const void* vp, const void* wpq,
                          const void* rp, const void* q, const void* qi,
                          const void* pinv, void* out, int B2, int l, int T,
                          int n_p, int log_n, void* stream) {
  RT_BY_LOG_N(k3_launch, nullptr, static_cast<cudaStream_t>(stream), U(g),
              U(vp), U(wpq), U(rp), U(q), U(qi), U(pinv),
              static_cast<uint32_t*>(out), B2, l, T, n_p)
}

// The launch rt_bconv_ntt_mulacc / rt_moddown would make at these sizes,
// written to info[9] (see ClusterLaunch); nothing runs.
extern "C" int rt_bconv_ntt_mulacc_info(int* info, int B, int l, int T,
                                        int D, int alpha, int log_n) {
  RT_BY_LOG_N(k2_launch, info, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr, nullptr, nullptr, B, l, T, D, alpha)
}

extern "C" int rt_moddown_info(int* info, int B2, int l, int T, int n_p,
                               int log_n) {
  RT_BY_LOG_N(k3_launch, info, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr, nullptr, nullptr, nullptr, B2, l, T, n_p)
}
