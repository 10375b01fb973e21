// K7: the four-step negacyclic NTT for Hopper (sm_90a), plain C entries
// loaded with ctypes by repro_torch/kernels/ntt.py.
//
// Replaces repro/kernels/ntt.py::_ntt_col_kernel (ntt.py:52) and
// ::_ntt_row_kernel (ntt.py:59). One length-N row, viewed as (R, C):
//   ntt_col  grid (C / bc): a block takes bc = 8 adjacent columns (fewer
//            when C < 8 or R > 2048) and runs the R-point Harvey CT NTT
//            down each of them (twiddle index depends on the row only);
//   ntt_row  grid (R / br): a block holds a (br, C) tile, multiplies it
//            by the fused correction table t2 (phase 2) and runs the
//            C-point CT stages along its rows (phase 3).
// Output in kernel order: out[u*C + v] = hat a[brv_R(u) + R*brv_C(v)]
// (repro/kernels/ref.py:103-110). Twiddles and t2 are in Montgomery form,
// so each product is one REDC; sums are formed in 64 bits (q < 2^32).
//
// What bounds it: at one row of N = 2^16 neither bytes (1.3 MB) nor
// operations bound it; the launch and the dependent chain of log R (log
// C) stages do. The column kernel therefore does not keep the TPU's
// (R, 128) tile (2 blocks at R = C = 256, a block barrier a stage): a
// column's NTT belongs to R / 16 threads holding 16 values each in
// registers (one thread holding all R values where R <= 16), its stages
// run as the radix passes of rt::Sched<1, log R> (two radix-16 passes and
// one exchange through shared memory at R = 256), and 8 adjacent columns
// a block keep the int64 loads in whole 32-byte sectors while giving 32
// blocks at R = C = 256. Above R = 2048 a column takes more than 128
// threads, so a block takes fewer columns (one of 1024 threads at R =
// 16384, the largest R). The row kernel keeps the TPU's (8, C) tile.
//
// Tensors: a and out int64 (N,) residues < q; the (R, C) intermediate,
// tables and constants are u32 in int32 storage, contiguous.

#include "common.cuh"

using rt::add_mod;
using rt::mont_mul;
using rt::sub_mod;

namespace {

constexpr int kColBlock = 8;    // adjacent columns a block of ntt_col takes

// Exchange-buffer word of (row, column) in ntt_col: columns innermost, one
// pad row after every 16 rows, so that at R = 256 neither the pass-0
// writes (rows tid + 16 j) nor the pass-1 reads (rows 16 tid + j) of a
// warp (4 tids x 8 columns) hit a bank twice.
__device__ __forceinline__ int col_word(int row, int col, int bc) {
  return (row + (row >> 4)) * bc + col;
}

// Thread t of a block takes column t % bc and, within that column's
// NTT, thread index t / bc of rt::Sched<1, LOGR> (whose "chunk" is the
// column). Shared: (R + R / 16) * bc u32 for LOGR >= 5, none below.
template <int LOGR>
__global__ void __launch_bounds__(rt::kMaxThreads)
ntt_col_kernel(const int64_t* __restrict__ a, uint32_t* __restrict__ y,
               const uint32_t* __restrict__ rp,
               const uint32_t* __restrict__ qv,
               const uint32_t* __restrict__ qiv, int C, int bc) {
  const int col = threadIdx.x % bc, tid = threadIdx.x / bc;
  const int c0 = blockIdx.x * bc + col;
  const uint32_t q = qv[0], qi = qiv[0];
  uint32_t v[rt::kVals];
  if constexpr (LOGR < 5) {
    constexpr int R = 1 << LOGR;
#pragma unroll
    for (int j = 0; j < R; ++j)
      v[j] = static_cast<uint32_t>(a[static_cast<size_t>(j) * C + c0]);
    rt::radix_set<1, LOGR>(v, rp, 0, 0, 0, q, qi);
#pragma unroll
    for (int j = 0; j < R; ++j) y[static_cast<size_t>(j) * C + c0] = v[j];
  } else {
    using S = rt::Sched<1, LOGR>;
    constexpr int kStLast = LOGR - S::kLast;
    extern __shared__ uint32_t tile[];
#pragma unroll
    for (int j = 0; j < rt::kVals; ++j)
      v[j] = static_cast<uint32_t>(
          a[static_cast<size_t>(S::mid_pos(tid, 0, j)) * C + c0]);
    rt::radix_set<1, 4>(v, rp, 0, S::mid_blk(tid, 0), 0, q, qi);
#pragma unroll
    for (int st = 4; st < kStLast; st += 4) {
#pragma unroll
      for (int j = 0; j < rt::kVals; ++j)
        tile[col_word(S::mid_pos(tid, st - 4, j), col, bc)] = v[j];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < rt::kVals; ++j)
        v[j] = tile[col_word(S::mid_pos(tid, st, j), col, bc)];
      rt::radix_set<1, 4>(v, rp, st, S::mid_blk(tid, st), 0, q, qi);
    }
#pragma unroll
    for (int j = 0; j < rt::kVals; ++j)
      tile[col_word(S::mid_pos(tid, kStLast - 4, j), col, bc)] = v[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < rt::kVals; ++j)
      v[j] = tile[col_word(S::last_pos(tid, j), col, bc)];
#pragma unroll
    for (int r = 0; r < (rt::kVals >> S::kLast); ++r)
      rt::radix_set<1, S::kLast>(v + (r << S::kLast), rp, kStLast,
                                 S::last_blk(tid, r << S::kLast), 0, q, qi);
#pragma unroll
    for (int j = 0; j < rt::kVals; ++j)
      y[static_cast<size_t>(S::last_pos(tid, j)) * C + c0] = v[j];
  }
}

__global__ void __launch_bounds__(rt::kMaxThreads)
ntt_row_kernel(const uint32_t* __restrict__ y, const uint32_t* __restrict__ t2,
               const uint32_t* __restrict__ rp,
               const uint32_t* __restrict__ qv,
               const uint32_t* __restrict__ qiv, int64_t* __restrict__ out,
               int log_c, int br) {
  extern __shared__ uint32_t tile[];          // (br, C)
  const int C = 1 << log_c;
  const size_t base = static_cast<size_t>(blockIdx.x) * br * C;
  const uint32_t q = qv[0], qi = qiv[0];
  for (int i = threadIdx.x; i < br * C; i += blockDim.x)
    tile[i] = mont_mul(y[base + i], t2[base + i], q, qi);
  __syncthreads();
  const int hc = C / 2;
  for (int m = 1; m < C; m <<= 1) {
    const int t = C / (2 * m);
    for (int b = threadIdx.x; b < br * hc; b += blockDim.x) {
      const int k = b % hc;                   // butterfly index in the row
      const int g = k / t;
      const int p0 = (b / hc) * C + 2 * g * t + k % t;
      const int p1 = p0 + t;
      const uint32_t u = tile[p0];
      const uint32_t v = mont_mul(tile[p1], rp[m + g], q, qi);
      tile[p0] = add_mod(u, v, q);
      tile[p1] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < br * C; i += blockDim.x) out[base + i] = tile[i];
}

int threads_for(int butterflies) {
  int t = butterflies < 32 ? 32 : butterflies;
  return t > rt::kMaxThreads ? rt::kMaxThreads : t;
}

}  // namespace

// Columns a block of ntt_col takes: kColBlock adjacent ones, fewer when
// C < kColBlock or when R / 16 threads a column would pass rt::kMaxThreads
// (R > 2048; one column a block at R = 16384).
template <int LOGR>
static int col_block(int C) {
  int bc = C < kColBlock ? C : kColBlock;
  if constexpr (LOGR > 4) {
    const int per_block = rt::kMaxThreads >> (LOGR - 4);
    if (bc > per_block) bc = per_block;
  }
  return bc;
}

template <int LOGR>
static int col_launch(int* info, const int64_t* a, uint32_t* y,
                      const uint32_t* rp, const uint32_t* q,
                      const uint32_t* qi, int C, cudaStream_t stream) {
  static_assert(LOGR <= 14, "R / 16 threads a column: R <= 16384");
  const int bc = col_block<LOGR>(C);
  const int threads = LOGR < 5 ? bc : bc << (LOGR - 4);
  const size_t smem = LOGR < 5 ? 0 : sizeof(uint32_t) * bc *
                                         ((1 << LOGR) + (1 << LOGR) / 16);
  const rt::ClusterLaunch L{dim3(C / bc), threads, smem, 1, stream, info};
  return rt::cluster_launch(L, ntt_col_kernel<LOGR>, a, y, rp, q, qi, C, bc);
}

#define RT_BY_LOG_R(FN, ...)                                               \
  switch (log_r) {                                                         \
    case 0: return FN<0>(__VA_ARGS__);                                     \
    case 1: return FN<1>(__VA_ARGS__);                                     \
    case 2: return FN<2>(__VA_ARGS__);                                     \
    case 3: return FN<3>(__VA_ARGS__);                                     \
    case 4: return FN<4>(__VA_ARGS__);                                     \
    case 5: return FN<5>(__VA_ARGS__);                                     \
    case 6: return FN<6>(__VA_ARGS__);                                     \
    case 7: return FN<7>(__VA_ARGS__);                                     \
    case 8: return FN<8>(__VA_ARGS__);                                     \
    case 9: return FN<9>(__VA_ARGS__);                                     \
    case 10: return FN<10>(__VA_ARGS__);                                   \
    case 11: return FN<11>(__VA_ARGS__);                                   \
    case 12: return FN<12>(__VA_ARGS__);                                   \
    case 13: return FN<13>(__VA_ARGS__);                                   \
    case 14: return FN<14>(__VA_ARGS__);                                   \
    default: return cudaErrorInvalidValue;                                 \
  }

// log_r at most 14: R / 16 threads a column fill a block of 1024.
extern "C" int rt_ntt_col(const void* a, void* y, const void* rp,
                          const void* q, const void* qi, int log_r, int C,
                          void* stream) {
  RT_BY_LOG_R(col_launch, nullptr, static_cast<const int64_t*>(a),
              static_cast<uint32_t*>(y), static_cast<const uint32_t*>(rp),
              static_cast<const uint32_t*>(q),
              static_cast<const uint32_t*>(qi), C,
              static_cast<cudaStream_t>(stream))
}

// The launch rt_ntt_col would make for (R, C) = (2^log_r, C), written to
// info[9] as rt::ClusterLaunch does (cluster 1); nothing runs.
extern "C" int rt_ntt_col_info(int* info, int log_r, int C) {
  RT_BY_LOG_R(col_launch, info, nullptr, nullptr, nullptr, nullptr, nullptr,
              C, nullptr)
}

extern "C" int rt_ntt_row(const void* y, const void* t2, const void* rp,
                          const void* q, const void* qi, void* out, int R,
                          int log_c, int br, void* stream) {
  const int C = 1 << log_c;
  const int smem = static_cast<int>(sizeof(uint32_t)) * br * C;
  cudaError_t err = cudaFuncSetAttribute(
      ntt_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ntt_row_kernel<<<R / br, threads_for(br * C / 2), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(y), static_cast<const uint32_t*>(t2),
      static_cast<const uint32_t*>(rp), static_cast<const uint32_t*>(q),
      static_cast<const uint32_t*>(qi), static_cast<int64_t*>(out), log_c,
      br);
  return cudaGetLastError();
}
