// K7: the four-step negacyclic NTT for Hopper (sm_90a), plain C entries
// loaded with ctypes by repro_torch/kernels/ntt.py.
//
// Replaces repro/kernels/ntt.py::_ntt_col_kernel (ntt.py:52) and
// ::_ntt_row_kernel (ntt.py:59). One length-N row, viewed as (R, C):
//   ntt_col  grid (C / bc): a block takes bc = 8 adjacent columns (fewer
//            when C < 8 or R > 2048) and runs the R-point Harvey CT NTT
//            down each of them (twiddle index depends on the row only);
//   ntt_row  grid (R / rows): a block takes `rows` whole rows, multiplies
//            each by the fused correction table t2 as it loads it (phase
//            2) and runs the C-point CT NTT along it (phase 3).
// Output in kernel order: out[u*C + v] = hat a[brv_R(u) + R*brv_C(v)]
// (repro/kernels/ref.py:103-110). Twiddles and t2 are in Montgomery form,
// so each product is one REDC; sums are formed in 64 bits (q < 2^32).
//
// What bounds them: at one row of N = 2^16 neither bytes (0.8 and 1.0 MB)
// nor operations bound them; the launch and the dependent chain of log R
// (log C) stages do. So neither keeps the TPU's tile ((R, 128) columns,
// (8, C) rows: 2 and 32 blocks at R = C = 256, a block barrier a stage).
// A column's (row's) NTT belongs to R / 16 (C / 16) threads holding 16
// values each in registers (one thread holding all of them where R (C)
// <= 16), and its stages run as the radix passes of rt::Sched<1, log R>
// (<1, log C>): two radix-16 passes and one exchange through shared
// memory at 256 points. 8 adjacent columns a block keep ntt_col's int64
// loads in whole 32-byte sectors while giving 32 blocks at R = C = 256;
// above R = 2048 a column takes more than 128 threads, so a block takes
// fewer columns (one of 1024 threads at R = 16384, the largest R).
// ntt_row loads a row at Sched's first-pass positions (for each value,
// the row's threads read neighbouring words), forms the t2 product there,
// and takes as many rows a block as 16 threads hold (kernels/ntt.py::
// row_block: one at C = 256, so 256 blocks; four at C = 64), which timed
// within 0.0001 ms of 32 or 64 threads a block. A thread issues all 32 of its
// loads (y and t2) before the first product, which takes more than the
// 64 registers a block of 1024 threads leaves it: so a block holds at
// most 64 threads where a row takes fewer. While a row's threads fit in
// one warp (C <= 512) its exchanges need only a barrier of that row's
// lanes. It stores int64 in 16-byte words (two values), straight from the
// last pass's runs of 2^kLast contiguous values (staging them through the
// buffer so that a warp's stores are contiguous timed 9-20 % slower).
// Rows of up to 16384 points: a longer row would take more than 1024
// threads.
//
// Tensors: a and out int64 (N,) residues < q; the (R, C) intermediate,
// tables and constants are u32 in int32 storage, contiguous.

#include "common.cuh"

using rt::mont_mul;

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

// Exchange-buffer word of row position p in ntt_row: one pad word after
// every 16, rows C + C / 16 words apart, so that at C = 256 (16 threads a
// row) neither the first pass's stores (positions
// tid + 16 j) nor the last pass's loads (16 tid + j) of a warp hit a bank
// twice.
__device__ __forceinline__ int row_word(int p) { return p + (p >> 4); }

// Barrier of one row's T threads: the row's own lanes while they lie in
// one warp, the block above that.
template <int T>
__device__ __forceinline__ void row_sync() {
  if constexpr (T <= 32) {
    const unsigned lane = threadIdx.x & 31u;
    __syncwarp(T == 32 ? 0xffffffffu
                       : ((1u << T) - 1u) << (lane & ~(T - 1u)));
  } else {
    __syncthreads();
  }
}

// Two int64 outputs at o (16-byte aligned) from two u32 values.
__device__ __forceinline__ void st_pair(int64_t* o, uint32_t a, uint32_t b) {
  *reinterpret_cast<longlong2*>(o) = make_longlong2(a, b);
}

// Threads that take one row of C = 2^LOGC points (C / 16, one where C <=
// 16), and the threads a block of ntt_row may hold: one row's, or
// kRowMaxThreads where that is more. A bound below 1024 leaves ptxas the
// registers to keep a thread's 32 loads (y and t2) in flight at once.
constexpr int kRowMaxThreads = 64;

template <int LOGC>
struct RowShape {
  static constexpr int kThreads = LOGC < 5 ? 1 : (1 << LOGC) / rt::kVals;
  static constexpr int kBlock =
      kThreads > kRowMaxThreads ? kThreads : kRowMaxThreads;
};

// Thread t of a block takes row t / T of the block's `rows` and, within
// that row's NTT, thread index t % T of rt::Sched<1, LOGC> (whose "chunk"
// is the row), T = RowShape<LOGC>::kThreads. Shared: rows * (C + C / 16)
// u32 for LOGC >= 5, none below.
template <int LOGC>
__global__ void __launch_bounds__(RowShape<LOGC>::kBlock)
ntt_row_kernel(const uint32_t* __restrict__ y, const uint32_t* __restrict__ t2,
               const uint32_t* __restrict__ rp,
               const uint32_t* __restrict__ qv,
               const uint32_t* __restrict__ qiv, int64_t* __restrict__ out,
               int rows) {
  constexpr int C = 1 << LOGC;
  constexpr int T = RowShape<LOGC>::kThreads;
  const int lrow = threadIdx.x / T, tid = threadIdx.x % T;
  const size_t base = (static_cast<size_t>(blockIdx.x) * rows + lrow) * C;
  const uint32_t* yr = y + base;
  const uint32_t* tr = t2 + base;
  int64_t* o = out + base;
  const uint32_t q = qv[0], qi = qiv[0];
  uint32_t v[rt::kVals];
  if constexpr (LOGC < 5) {
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = mont_mul(yr[j], tr[j], q, qi);
    rt::radix_set<1, LOGC>(v, rp, 0, 0, 0, q, qi);
    if constexpr (C == 1) {
      o[0] = v[0];
    } else {
#pragma unroll
      for (int j = 0; j < C; j += 2) st_pair(o + j, v[j], v[j + 1]);
    }
  } else {
    using S = rt::Sched<1, LOGC>;
    constexpr int kStLast = LOGC - S::kLast;
    constexpr int kRowWords = C + C / 16;
    extern __shared__ uint32_t smem[];
    uint32_t* buf = smem + lrow * kRowWords;
    uint32_t w[rt::kVals];
#pragma unroll
    for (int j = 0; j < rt::kVals; ++j) {
      const int p = S::mid_pos(tid, 0, j);
      v[j] = yr[p];
      w[j] = tr[p];
    }
#pragma unroll
    for (int j = 0; j < rt::kVals; ++j) v[j] = mont_mul(v[j], w[j], q, qi);
    rt::radix_set<1, 4>(v, rp, 0, S::mid_blk(tid, 0), 0, q, qi);
#pragma unroll
    for (int st = 4; st < kStLast; st += 4) {
#pragma unroll
      for (int j = 0; j < rt::kVals; ++j)
        buf[row_word(S::mid_pos(tid, st - 4, j))] = v[j];
      row_sync<T>();
#pragma unroll
      for (int j = 0; j < rt::kVals; ++j)
        v[j] = buf[row_word(S::mid_pos(tid, st, j))];
      rt::radix_set<1, 4>(v, rp, st, S::mid_blk(tid, st), 0, q, qi);
    }
#pragma unroll
    for (int j = 0; j < rt::kVals; ++j)
      buf[row_word(S::mid_pos(tid, kStLast - 4, j))] = v[j];
    row_sync<T>();
#pragma unroll
    for (int j = 0; j < rt::kVals; ++j)
      v[j] = buf[row_word(S::last_pos(tid, j))];
#pragma unroll
    for (int r = 0; r < (rt::kVals >> S::kLast); ++r)
      rt::radix_set<1, S::kLast>(v + (r << S::kLast), rp, kStLast,
                                 S::last_blk(tid, r << S::kLast), 0, q, qi);
#pragma unroll
    for (int j = 0; j < rt::kVals; j += 2)
      st_pair(o + S::last_pos(tid, j), v[j], v[j + 1]);
  }
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

#define RT_BY_LOG(LOG, FN, ...)                                            \
  switch (LOG) {                                                           \
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
  RT_BY_LOG(log_r, col_launch, nullptr, static_cast<const int64_t*>(a),
            static_cast<uint32_t*>(y), static_cast<const uint32_t*>(rp),
            static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(qi),
            C, static_cast<cudaStream_t>(stream))
}

// The launch rt_ntt_col would make for (R, C) = (2^log_r, C), written to
// info[9] as rt::ClusterLaunch does (cluster 1); nothing runs.
extern "C" int rt_ntt_col_info(int* info, int log_r, int C) {
  RT_BY_LOG(log_r, col_launch, info, nullptr, nullptr, nullptr, nullptr,
            nullptr, C, nullptr)
}

// A block of ntt_row: `rows` whole rows of C = 2^LOGC points; rows must
// divide R and keep the block within RowShape<LOGC>::kBlock threads
// (kernels/ntt.py::row_block picks them).
template <int LOGC>
static int row_launch(int* info, const uint32_t* y, const uint32_t* t2,
                      const uint32_t* rp, const uint32_t* q,
                      const uint32_t* qi, int64_t* out, int R, int rows,
                      cudaStream_t stream) {
  static_assert(RowShape<LOGC>::kBlock <= rt::kMaxThreads,
                "C / 16 threads a row: C <= 16384");
  constexpr int T = RowShape<LOGC>::kThreads;
  if (rows < 1 || R % rows != 0 || rows * T > RowShape<LOGC>::kBlock)
    return cudaErrorInvalidValue;
  const size_t smem = LOGC < 5 ? 0 : sizeof(uint32_t) * rows *
                                         ((1 << LOGC) + (1 << LOGC) / 16);
  const rt::ClusterLaunch L{dim3(R / rows), rows * T, smem, 1, stream, info};
  return rt::cluster_launch(L, ntt_row_kernel<LOGC>, y, t2, rp, q, qi, out,
                            rows);
}

// log_c at most 14: C / 16 threads a row fill a block of 1024.
extern "C" int rt_ntt_row(const void* y, const void* t2, const void* rp,
                          const void* q, const void* qi, void* out, int R,
                          int log_c, int rows, void* stream) {
  RT_BY_LOG(log_c, row_launch, nullptr, static_cast<const uint32_t*>(y),
            static_cast<const uint32_t*>(t2),
            static_cast<const uint32_t*>(rp), static_cast<const uint32_t*>(q),
            static_cast<const uint32_t*>(qi), static_cast<int64_t*>(out), R,
            rows, static_cast<cudaStream_t>(stream))
}

// The launch rt_ntt_row would make for (R, C) = (R, 2^log_c), written to
// info[9] as rt::ClusterLaunch does (cluster 1); nothing runs.
extern "C" int rt_ntt_row_info(int* info, int R, int log_c, int rows) {
  RT_BY_LOG(log_c, row_launch, info, nullptr, nullptr, nullptr, nullptr,
            nullptr, nullptr, R, rows, nullptr)
}
