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
// The three run a row's NTT as one thread-block cluster of its chunk
// blocks: the inverse (K1, rt::intt_cluster) and the forward (K2, K3,
// rt::ntt_fwd_cluster, common.cuh). A row crosses device memory once: the
// values of the cross-chunk stages reach the other chunks through
// distributed shared memory, so K2 and K3 form each BConv output once in
// the grid and K1 reads and writes each word once. The in-chunk
// butterflies run as radix-16 passes in registers with 3 block barriers at
// C = 16384 instead of one a stage. They need sm_90's cluster launch
// (cudaLaunchKernelEx).
//
// All tensors are u32 residues in int32 storage, row-major, contiguous.

#include "common.cuh"

using rt::add_mod;
using rt::cluster_launch;
using rt::ClusterLaunch;
using rt::mont_mul;
using rt::sub_mod;

// K1: per (batch r, limb j) row, one cluster of NCH chunk blocks: GS
// inverse NTT without n^-1 (rt::intt_cluster), then one Montgomery
// multiply by the limb's scale. Rows [row0, row0 + n_rows) of x (R, S, N)
// -> out (R, n_rows, N). grid (NCH, n_rows, R). Shared: Sched::kSmem u32.
template <int NCH, int LOGC>
__global__ void __launch_bounds__(rt::Sched<NCH, LOGC>::kThreads, 1)
intt_scale_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                  const uint32_t* __restrict__ irp,
                  const uint32_t* __restrict__ qv,
                  const uint32_t* __restrict__ qiv,
                  const uint32_t* __restrict__ scv, int S, int row0,
                  int n_rows) {
  using Sc = rt::Sched<NCH, LOGC>;
  extern __shared__ __align__(16) uint32_t sh[];
  const int c = blockIdx.x, j = blockIdx.y, r = blockIdx.z;
  const int n = NCH * Sc::C;
  const uint32_t q = qv[j], qi = qiv[j], sc = scv[j];
  const uint32_t* src =
      x + (static_cast<size_t>(r) * S + row0 + j) * n + c * Sc::C;
  uint32_t* dst = out + (static_cast<size_t>(r) * n_rows + j) * n + c * Sc::C;
  uint32_t y[rt::kVals];
  rt::intt_cluster<NCH, LOGC>(sh, src, y, irp + static_cast<size_t>(j) * n,
                              q, qi, c);
#pragma unroll
  for (int k = 0; k < rt::kVals; ++k)
    dst[Sc::mid_pos(threadIdx.x, 0, k)] = mont_mul(y[k], sc, q, qi);
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

static const uint32_t* U(const void* p) {
  return static_cast<const uint32_t*>(p);
}

template <int NCH, int LOGC>
static int k1_launch(int* info, cudaStream_t st, const uint32_t* x,
                     uint32_t* out, const uint32_t* irp, const uint32_t* q,
                     const uint32_t* qi, const uint32_t* sc, int R, int S,
                     int row0, int n_rows) {
  using Sc = rt::Sched<NCH, LOGC>;
  const ClusterLaunch L{dim3(NCH, n_rows, R), Sc::kThreads,
                        sizeof(uint32_t) * Sc::kSmem, NCH, st, info};
  return cluster_launch(L, intt_scale_kernel<NCH, LOGC>, x, out, irp, q, qi,
                        sc, S, row0, n_rows);
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

extern "C" int rt_intt_scale(const void* x, void* out, const void* irp,
                             const void* q, const void* qi, const void* sc,
                             int R, int S, int row0, int n_rows, int log_n,
                             void* stream) {
  RT_BY_LOG_N(k1_launch, nullptr, static_cast<cudaStream_t>(stream), U(x),
              static_cast<uint32_t*>(out), U(irp), U(q), U(qi), U(sc), R, S,
              row0, n_rows)
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

// The launch rt_intt_scale / rt_bconv_ntt_mulacc / rt_moddown would make
// at these sizes, written to info[9] (see rt::ClusterLaunch); nothing runs.
extern "C" int rt_intt_scale_info(int* info, int R, int S, int n_rows,
                                  int log_n) {
  RT_BY_LOG_N(k1_launch, info, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr, nullptr, R, S, 0, n_rows)
}

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
