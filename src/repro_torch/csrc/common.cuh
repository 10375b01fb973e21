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

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

namespace rt {

// Largest row chunk a block keeps in shared memory (u32 elements). A
// full row at N = 65536 is 256 KB, above the 227 KB a block may use, so
// an NTT at that size runs as a cluster of chunk blocks (below).
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

// ---------------------------------------------------------------------------
// forward NTT of one row in a thread-block cluster (K2, K3)
// ---------------------------------------------------------------------------
// Forward Harvey CT NTT (core/ntt.py::ntt_forward: natural in, bit-reversed
// out, Montgomery twiddles rp in the same layout) of a row of n = NCH * C,
// C = 2^LOGC, run by the NCH blocks of one cluster: block c owns positions
// [c*C, (c+1)*C) and its C / 16 threads hold kVals = 16 values each.
//  1. The block forms its chunk of the input once (the caller's BConv sum,
//     `conv`), four runs of 4 words a thread, into its padded buffer.
//  2. Cluster barrier. Every thread reads, for each of its 16 positions i,
//     the NCH values i + s*C from the peers' buffers (distributed shared
//     memory) and runs the log2(NCH) cross-chunk stages in registers,
//     keeping the half that lands in its own chunk.
//  3. Cluster barrier: no block writes its buffer while a peer still reads
//     it, and no block reads a peer after it, so any block may exit later.
//  4. The LOGC in-chunk stages as radix passes in registers: radix-16
//     passes from the top (the first right after the gather), the last
//     pass of the remaining 1-4 stages, one block barrier between two
//     passes (3 at C = 16384). Each thread reads and writes the same
//     positions within a pass, so no barrier is needed inside one.
//  5. The last pass leaves each thread 16 / 2^kLast sets of 2^kLast
//     contiguous outputs, handed in registers to the caller's epilogue
//     `epi`, which finds them at Sched::last_pos.
// kernels/keyswitch.py::ntt_fwd_sched models this schedule on the CPU with
// the same index formulas. Every sum is formed in 64 bits (q < 2^32); no
// butterfly is lazy.

constexpr int kVals = 16;

// Padded shared-memory word of chunk position p: 4 pad words after every
// 64 keep every access pattern below free of bank conflicts.
__device__ __forceinline__ int phys(int p) { return p + ((p >> 6) << 2); }

template <int NCH, int LOGC>
struct Sched {
  static_assert(LOGC >= 5, "a chunk holds at least 32 words");
  static constexpr int C = 1 << LOGC;
  static constexpr int kThreads = C / kVals;
  static constexpr int kLast = (LOGC - 1) % 4 + 1;  // radix log, last pass
  static constexpr int kSmem = C + ((C >> 6) << 2);  // padded buffer words
  // value j of thread tid in the BConv phase: runs of 4 words
  __device__ static int run_pos(int tid, int j) {
    return ((tid + kThreads * (j >> 2)) << 2) + (j & 3);
  }
  // a radix-16 pass above the last one, from local stage st: one set of
  // 16 values at the stride of the pass's last stage
  __device__ static int mid_blk(int tid, int st) {
    return tid >> (LOGC - st - 4);
  }
  __device__ static int mid_pos(int tid, int st, int j) {
    return (mid_blk(tid, st) << (LOGC - st)) +
           (tid & ((1 << (LOGC - st - 4)) - 1)) + (j << (LOGC - st - 4));
  }
  // the last pass: sets of 2^kLast contiguous values
  __device__ static int last_blk(int tid, int j) {
    return tid + kThreads * (j >> kLast);
  }
  __device__ static int last_pos(int tid, int j) {
    return (last_blk(tid, j) << kLast) + (j & ((1 << kLast) - 1));
  }
};

// V contiguous words (V = 2 or 4, 8- or 16-byte aligned) to and from
// registers
template <int V>
__device__ __forceinline__ void ldv(const uint32_t* p, uint32_t* v) {
  if constexpr (V == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
}

template <int V>
__device__ __forceinline__ void stv(uint32_t* p, const uint32_t* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  }
}

// Butterfly stage S of a radix-2^LR set of values in registers, the set
// starting at local stage st: set blk of chunk c takes twiddle
// rp[(NCH << (st+S)) + (c << (st+S)) + (blk << S) + h] for subgroup h.
// Forward (INV false): Harvey CT, (u, v) -> (u + w v, u - w v). Inverse:
// Gentleman-Sande, (u, v) -> (u + v, (u - v) w), the inverse twiddles in
// the same layout (core/ntt.py), so a GS stage of stride t uses the
// twiddle of the CT stage of that stride.
// Stages are template arguments so that every loop bound is a constant
// and the values stay in registers (a loop bound that depends on an
// outer loop's counter leaves the array indexed at run time, in local
// memory).
template <int NCH, int LR, int S, bool INV>
__device__ __forceinline__ void radix_stage(uint32_t* y, const uint32_t* rp,
                                            int st, int blk, int c,
                                            uint32_t q, uint32_t qi) {
  constexpr int half = (1 << LR) >> (S + 1);
  const uint32_t* tw = rp + (NCH << (st + S)) + (c << (st + S)) +
                       (blk << S);
#pragma unroll
  for (int h = 0; h < (1 << S); ++h) {
    const uint32_t w = __ldg(tw + h);
#pragma unroll
    for (int k = 0; k < half; ++k) {
      uint32_t& u = y[2 * half * h + k];
      uint32_t& v = y[2 * half * h + k + half];
      if constexpr (INV) {
        const uint32_t d = sub_mod(u, v, q);
        u = add_mod(u, v, q);
        v = mont_mul(d, w, q, qi);
      } else {
        const uint32_t t = mont_mul(v, w, q, qi);
        v = sub_mod(u, t, q);
        u = add_mod(u, t, q);
      }
    }
  }
}

// The forward runs the set's stages from the largest stride down, the
// inverse from the smallest up.
template <int NCH, int LR, bool INV, int... S>
__device__ __forceinline__ void radix_stages(uint32_t* y, const uint32_t* rp,
                                             int st, int blk, int c,
                                             uint32_t q, uint32_t qi,
                                             std::integer_sequence<int, S...>) {
  (radix_stage<NCH, LR, INV ? LR - 1 - S : S, INV>(y, rp, st, blk, c, q, qi),
   ...);
}

// All LR stages of one set.
template <int NCH, int LR, bool INV = false>
__device__ __forceinline__ void radix_set(uint32_t* y, const uint32_t* rp,
                                          int st, int blk, int c,
                                          uint32_t q, uint32_t qi) {
  radix_stages<NCH, LR, INV>(y, rp, st, blk, c, q, qi,
                             std::make_integer_sequence<int, LR>{});
}

// conv(p, o): o[0..3] = input at chunk positions p..p+3 (p % 4 == 0).
// epi(y): y[j] is output position Sched::last_pos(threadIdx.x, j).
// buf: Sched::kSmem words of shared memory.
template <int NCH, int LOGC, class Conv, class Epi>
__device__ __forceinline__ void ntt_fwd_cluster(uint32_t* buf, Conv conv,
                                                Epi epi, const uint32_t* rp,
                                                uint32_t q, uint32_t qi,
                                                int c) {
  using S = Sched<NCH, LOGC>;
  const int tid = threadIdx.x;
  uint32_t y[kVals];
#pragma unroll
  for (int r = 0; r < kVals / 4; ++r) {
    const int p = S::run_pos(tid, 4 * r);
    uint32_t o[4];
    conv(p, o);
    stv<4>(buf + phys(p), o);
  }
  if constexpr (NCH > 1) {
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    cl.sync();
    // The cross-chunk stages in registers, each keeping only the half
    // that holds chunk c (NCH - 1 products a position). Stage m (= 1, 2)
    // pairs s with s + NCH/(2m) under twiddle rp[m + c / (NCH/m)].
    static_assert(NCH == 2 || NCH == 4, "clusters of 2 or 4 chunks");
    const uint32_t* z0 = cl.map_shared_rank(buf, 0);
    const uint32_t* z1 = cl.map_shared_rank(buf, 1);
    const uint32_t w1 = __ldg(rp + 1);
    if constexpr (NCH == 2) {
      const bool up = c & 1;
#pragma unroll
      for (int j = 0; j < kVals; ++j) {
        const int p = phys(S::mid_pos(tid, 0, j));
        const uint32_t t = mont_mul(z1[p], w1, q, qi);
        y[j] = up ? sub_mod(z0[p], t, q) : add_mod(z0[p], t, q);
      }
    } else {
      const uint32_t* z2 = cl.map_shared_rank(buf, 2);
      const uint32_t* z3 = cl.map_shared_rank(buf, 3);
      const uint32_t w2 = __ldg(rp + 2 + (c >> 1));
      const bool up1 = c >> 1, up2 = c & 1;
#pragma unroll
      for (int j = 0; j < kVals; ++j) {
        const int p = phys(S::mid_pos(tid, 0, j));
        const uint32_t a0 = z0[p], a1 = z1[p];
        const uint32_t t0 = mont_mul(z2[p], w1, q, qi);
        const uint32_t t1 = mont_mul(z3[p], w1, q, qi);
        const uint32_t b0 = up1 ? sub_mod(a0, t0, q) : add_mod(a0, t0, q);
        const uint32_t b1 = up1 ? sub_mod(a1, t1, q) : add_mod(a1, t1, q);
        const uint32_t t2 = mont_mul(b1, w2, q, qi);
        y[j] = up2 ? sub_mod(b0, t2, q) : add_mod(b0, t2, q);
      }
    }
    cl.sync();
  } else {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kVals; ++j) y[j] = buf[phys(S::mid_pos(tid, 0, j))];
  }
  radix_set<NCH, 4>(y, rp, 0, S::mid_blk(tid, 0), c, q, qi);
  constexpr int kStLast = LOGC - S::kLast;
#pragma unroll
  for (int st = 4; st < kStLast; st += 4) {
#pragma unroll
    for (int j = 0; j < kVals; ++j)
      buf[phys(S::mid_pos(tid, st - 4, j))] = y[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kVals; ++j) y[j] = buf[phys(S::mid_pos(tid, st, j))];
    radix_set<NCH, 4>(y, rp, st, S::mid_blk(tid, st), c, q, qi);
  }
#pragma unroll
  for (int j = 0; j < kVals; ++j)
    buf[phys(S::mid_pos(tid, kStLast - 4, j))] = y[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kVals; ++j) y[j] = buf[phys(S::last_pos(tid, j))];
#pragma unroll
  for (int r = 0; r < (kVals >> S::kLast); ++r)
    radix_set<NCH, S::kLast>(y + (r << S::kLast), rp, kStLast,
                             S::last_blk(tid, r << S::kLast), c, q, qi);
  epi(y);
}

// ---------------------------------------------------------------------------
// inverse NTT of one row in a thread-block cluster (K1)
// ---------------------------------------------------------------------------
// Gentleman-Sande inverse NTT without n^-1 (kernels/keyswitch.py::_gs_stages:
// bit-reversed in, natural out, Montgomery twiddles irp in the layout of
// core/ntt.py) of a row of n = NCH * C, C = 2^LOGC: the mirror image of
// ntt_fwd_cluster, with the same Sched. Block c of the cluster owns
// positions [c*C, (c+1)*C); its C / 16 threads hold kVals = 16 values each.
//  1. GS runs the small strides first. Each thread loads its 16 / 2^kLast
//     sets of 2^kLast contiguous values (Sched::last_pos) straight from
//     device memory in 8- or 16-byte words and runs their kLast stages in
//     registers.
//  2. The other in-chunk stages as radix-16 passes (Sched::mid_pos), from
//     local stage LOGC - kLast - 4 down to 0, through the padded buffer,
//     one block barrier between two passes (3 at C = 16384). Each thread
//     reads and writes the same positions within a pass.
//  3. NCH > 1: the block writes its chunk to its buffer; cluster barrier;
//     every thread reads, for each of its 16 positions i, the NCH values
//     i + s*C from the peers' buffers (distributed shared memory) and runs
//     the log2(NCH) cross-chunk stages in registers, keeping only its own
//     chunk's output; a second cluster barrier, so that no block exits
//     while a peer still reads its buffer.
// On return y[j] is output position Sched::mid_pos(threadIdx.x, 0, j) =
// threadIdx.x + j * C / 16 of chunk c: a warp's stores are coalesced.
// src: the chunk's first input word (16-byte aligned); buf: Sched::kSmem
// words of shared memory. kernels/keyswitch.py::intt_sched models this
// schedule on the CPU with the same index formulas. Every sum is formed
// in 64 bits (q < 2^32); no butterfly is lazy.
template <int NCH, int LOGC>
__device__ __forceinline__ void intt_cluster(uint32_t* buf,
                                             const uint32_t* src, uint32_t* y,
                                             const uint32_t* irp, uint32_t q,
                                             uint32_t qi, int c) {
  using S = Sched<NCH, LOGC>;
  constexpr int L = S::kLast;
  constexpr int V = L >= 2 ? 4 : 2;       // contiguous words a load
  constexpr int kStLast = LOGC - L;
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kVals / V; ++r)
    ldv<V>(src + S::last_pos(tid, r * V), y + r * V);
#pragma unroll
  for (int r = 0; r < (kVals >> L); ++r)
    radix_set<NCH, L, true>(y + (r << L), irp, kStLast,
                            S::last_blk(tid, r << L), c, q, qi);
#pragma unroll
  for (int r = 0; r < kVals / V; ++r)
    stv<V>(buf + phys(S::last_pos(tid, r * V)), y + r * V);
  __syncthreads();
#pragma unroll
  for (int st = kStLast - 4; st >= 0; st -= 4) {
#pragma unroll
    for (int j = 0; j < kVals; ++j) y[j] = buf[phys(S::mid_pos(tid, st, j))];
    radix_set<NCH, 4, true>(y, irp, st, S::mid_blk(tid, st), c, q, qi);
    if (st > 0) {
#pragma unroll
      for (int j = 0; j < kVals; ++j)
        buf[phys(S::mid_pos(tid, st, j))] = y[j];
      __syncthreads();
    }
  }
  if constexpr (NCH > 1) {
    static_assert(NCH == 2 || NCH == 4, "clusters of 2 or 4 chunks");
#pragma unroll
    for (int j = 0; j < kVals; ++j) buf[phys(S::mid_pos(tid, 0, j))] = y[j];
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    cl.sync();
    // GS stage of chunk stride t pairs chunks s and s + t under twiddle
    // irp[NCH / (2t) + s / (2t)]; block c keeps the sum where bit log2(t)
    // of c is 0, else the twiddled difference.
    const uint32_t* z0 = cl.map_shared_rank(buf, 0);
    const uint32_t* z1 = cl.map_shared_rank(buf, 1);
    const uint32_t w1 = __ldg(irp + 1);
    if constexpr (NCH == 2) {
#pragma unroll
      for (int j = 0; j < kVals; ++j) {
        const int p = phys(S::mid_pos(tid, 0, j));
        const uint32_t a0 = z0[p], a1 = z1[p];
        y[j] = c ? mont_mul(sub_mod(a0, a1, q), w1, q, qi)
                 : add_mod(a0, a1, q);
      }
    } else {
      const uint32_t* z2 = cl.map_shared_rank(buf, 2);
      const uint32_t* z3 = cl.map_shared_rank(buf, 3);
      const uint32_t w2 = __ldg(irp + 2), w3 = __ldg(irp + 3);
      const bool odd = c & 1, up = c >> 1;
#pragma unroll
      for (int j = 0; j < kVals; ++j) {
        const int p = phys(S::mid_pos(tid, 0, j));
        const uint32_t a0 = z0[p], a1 = z1[p], a2 = z2[p], a3 = z3[p];
        const uint32_t b0 = odd ? mont_mul(sub_mod(a0, a1, q), w2, q, qi)
                                : add_mod(a0, a1, q);
        const uint32_t b1 = odd ? mont_mul(sub_mod(a2, a3, q), w3, q, qi)
                                : add_mod(a2, a3, q);
        y[j] = up ? mont_mul(sub_mod(b0, b1, q), w1, q, qi)
                  : add_mod(b0, b1, q);
      }
    }
    cl.sync();
  }
}

// ---------------------------------------------------------------------------
// launching a kernel, or reporting the launch it would make
// ---------------------------------------------------------------------------

// One launch of a kernel in clusters of (NCH, 1, 1), none for NCH = 1
// (K1, K2 and K3 with NCH blocks a row; ntt_col with NCH = 1). With
// `info` set, nothing is launched: the launch's shape,
// cudaOccupancyMaxActiveClusters (blocks per SM times SMs for NCH = 1),
// registers and local memory per thread are written there.
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
inline int cluster_launch(const ClusterLaunch& L, void (*kernel)(P...),
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

}  // namespace rt
