// K6: the BConv accumulation for Hopper (sm_90a), plain C entries loaded
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
// w < p_d keep the REDC input below p_d * 2^32, so the product still
// comes out below p_d. p_d reaches 2^32 (the staged keyswitch converts
// into the 32-bit prime), so a sum of two residues may pass 2^32: where
// p_d > 2^31 its carry is kept, and only where p_d < 2^31 is a sum held
// in one 32-bit word.
//
// What bounds it: bytes. It reads S int64 rows and writes D: 8 (S + D) N
// bytes, 14.2 MB at S = 6, D = 21, N = 65536 (0.0042 ms at 3.35 TB/s),
// against S D N Montgomery products and adds (33 Mop, about 0.0005 ms at
// 67 TOP/s). But a product and its add take a dozen or more integer
// instructions, so at S = 6 their issue takes about as long as the bytes.
//
// Why the first design left the card idle: a block of 256 threads took
// 256 columns for all D outputs, so N = 65536 made 256 blocks (two an SM,
// a quarter of the warps an SM holds) and fig14's N = 1024 made 4. Each
// thread staged its column of v in a shared tile that only it read, met a
// barrier, then ran D dependent chains of S products (S and D were
// run-time loop bounds) and D stores of 8 bytes, with nothing beside it to
// overlap.
//
// The design now:
//  * the grid is (column tiles, groups of kGroup = 8 destination primes,
//    the last group ragged), so at N = 65536 and D = 21 it holds 128 x 3
//    blocks; a group re-reads its tile of v, from L2 (v is 3 MB at S = 6),
//    so device memory still sees each byte of v once. kGroup = 8 rather
//    than fewer keeps that L2 traffic (v once a group) under the bytes the
//    outputs put through L2. Where the grid would hold fewer than kSpread
//    blocks a block halves its threads, down to one warp (fig14's N = 1024,
//    D = 4: 16 blocks of 32 threads instead of 2 of 256);
//  * thread t of tile x takes the VEC adjacent columns (x * threads + t) *
//    VEC: VEC = 2 when n is even and v and out are 16-byte aligned, loaded
//    as one longlong2 a row and stored as one a output, a warp covering 512
//    contiguous bytes; VEC = 1 otherwise (an odd n leaves every other row
//    8-byte aligned). A thread is live when its first column is below n;
//    with VEC = 2, n is even, so its second is too;
//  * the S source values stay in registers, loaded straight from device
//    memory before the block's barrier, so the loads are in flight while
//    the block stages its kGroup x S Montgomery weights and 2 kGroup prime
//    constants in shared memory (read as broadcasts);
//  * S is a template argument (1 to kMaxS, the digit and special-basis
//    sizes of the port's parameter sets), so the loops unroll and the S
//    products of an output are independent; a thread finishes and stores
//    one output (all its columns) before the next, which keeps few values
//    live and spreads the stores through the block's run;
//  * the arithmetic is in 32-bit words: the REDC's and the sums' carries
//    ride in the carry flag (add.cc / addc) rather than in 64-bit sums
//    and compares, and an output whose prime is below 2^31 (all but the
//    32-bit prime) takes a path where every value fits one word and each
//    conditional subtract is one min. The branch is on the block's own
//    prime, so a warp never diverges on it.
// kernels/bconv.py::bconv_sched models this grid and mapping on the CPU.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // threads of a block where the grid is full
constexpr int kMinThreads = 32;
constexpr int kGroup = 8;       // destination primes a block takes
constexpr int kMaxS = 7;        // largest source basis instantiated
constexpr int kSpread = 128;    // fewer blocks than this: halve the block

// a*b*2^-32 mod p for a < 2^32, b < p, pi = -p^-1 mod 2^32 (the REDC of
// rt::mont_mul in 32-bit words): lo + m*p is 0 or 2^32, a carry iff lo is
// not 0, so the result before its subtract is hi + mh + carry < 2p. Where
// p < 2^31 (SMALL) that fits 32 bits and the subtract is a min of the
// wrapped difference; otherwise the sum's own carry is kept (addc).
template <bool SMALL>
__device__ __forceinline__ uint32_t mont(uint32_t a, uint32_t b, uint32_t p,
                                         uint32_t pi) {
  const uint32_t lo = a * b, hi = __umulhi(a, b);
  const uint32_t mh = __umulhi(lo * pi, p);
  uint32_t u, scratch;
  if constexpr (SMALL) {
    asm("add.cc.u32 %1, %2, -1;\n\t"
        "addc.u32 %0, %3, %4;"
        : "=r"(u), "=r"(scratch) : "r"(lo), "r"(hi), "r"(mh));
    return min(u, u - p);
  } else {
    uint32_t c;
    asm("add.cc.u32 %2, %3, -1;\n\t"
        "addc.cc.u32 %0, %4, %5;\n\t"
        "addc.u32 %1, 0, 0;"
        : "=r"(u), "=r"(c), "=r"(scratch) : "r"(lo), "r"(hi), "r"(mh));
    return c != 0 || u >= p ? u - p : u;
  }
}

// a + b mod p for a, b < p: the sum is below 2p, so one subtract folds it.
// Where p < 2^31 the sum fits 32 bits (a min of the wrapped difference);
// otherwise a + b >= p is tested as a >= p - b, which cannot wrap.
template <bool SMALL>
__device__ __forceinline__ uint32_t add_fold(uint32_t a, uint32_t b,
                                             uint32_t p) {
  if constexpr (SMALL) {
    const uint32_t s = a + b;
    return min(s, s - p);
  } else {
    const uint32_t t = p - b;
    return a >= t ? a - t : a + b;
  }
}

// One output row's VEC columns of a thread, summed in the variant's
// schedule and stored as one VEC x 8-byte word.
template <int S, bool LAZY, int VEC, bool SMALL>
__device__ __forceinline__ void output(const uint32_t (&x)[S][VEC],
                                       const uint32_t* wg, uint32_t p,
                                       uint32_t pi, int64_t* dst) {
  uint32_t acc[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    acc[c] = 0;
    int j = 0;
    if constexpr (LAZY) {
#pragma unroll
      for (; j + 1 < S; j += 2) {
        // the pair of reduced products, folded once, then added mod p
        const uint32_t pair =
            add_fold<SMALL>(mont<SMALL>(x[j][c], wg[j], p, pi),
                            mont<SMALL>(x[j + 1][c], wg[j + 1], p, pi), p);
        acc[c] = add_fold<SMALL>(acc[c], pair, p);
      }
    }
#pragma unroll
    for (; j < S; ++j)
      acc[c] = add_fold<SMALL>(acc[c], mont<SMALL>(x[j][c], wg[j], p, pi), p);
  }
  if constexpr (VEC == 2) {
    *reinterpret_cast<longlong2*>(dst) = make_longlong2(acc[0], acc[1]);
  } else {
    *dst = acc[0];
  }
}

template <int S, bool LAZY, int VEC>
__global__ void __launch_bounds__(kThreads)
bconv_kernel(const int64_t* __restrict__ v, const uint32_t* __restrict__ w,
             const uint32_t* __restrict__ pv, const uint32_t* __restrict__ piv,
             int64_t* __restrict__ out, int D, int n) {
  extern __shared__ uint32_t sm[];
  uint32_t* ws = sm;                 // (group slot, source) weights
  uint32_t* ps = sm + kGroup * S;    // kGroup p, then kGroup -p^-1 mod 2^32
  const int d0 = blockIdx.y * kGroup;
  const int gn = min(kGroup, D - d0);
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const bool live = col < n;
  uint32_t x[S][VEC];
  if (live) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int64_t* src = v + static_cast<size_t>(j) * n + col;
      if constexpr (VEC == 2) {
        const longlong2 t = *reinterpret_cast<const longlong2*>(src);
        x[j][0] = static_cast<uint32_t>(t.x);
        x[j][1] = static_cast<uint32_t>(t.y);
      } else {
        x[j][0] = static_cast<uint32_t>(*src);
      }
    }
  }
  for (int i = threadIdx.x; i < gn * S; i += blockDim.x)
    ws[i] = w[static_cast<size_t>(d0) * S + i];
  for (int i = threadIdx.x; i < gn; i += blockDim.x) {
    ps[i] = pv[d0 + i];
    ps[kGroup + i] = piv[d0 + i];
  }
  __syncthreads();
  if (!live) return;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    if (g < gn) {
      // p is the block's own: the branch is uniform
      const uint32_t p = ps[g], pi = ps[kGroup + g];
      int64_t* dst = out + static_cast<size_t>(d0 + g) * n + col;
      if (p < 0x80000000u)
        output<S, LAZY, VEC, true>(x, ws + g * S, p, pi, dst);
      else
        output<S, LAZY, VEC, false>(x, ws + g * S, p, pi, dst);
    }
  }
}

struct Args {
  const int64_t* v;
  const uint32_t* w;
  const uint32_t* p;
  const uint32_t* pi;
  int64_t* out;
  int D, n;
  bool lazy;
  int vec;
  cudaStream_t stream;
  int* info;
};

// Threads a block and grid (column tiles, output groups) for D outputs
// over n columns taken VEC at a time.
rt::ClusterLaunch shape(const Args& a, size_t smem) {
  const int pairs = (a.n + a.vec - 1) / a.vec;
  const int groups = (a.D + kGroup - 1) / kGroup;
  int threads = kThreads;
  while (threads > kMinThreads &&
         (pairs + threads - 1) / threads * groups < kSpread)
    threads /= 2;
  return rt::ClusterLaunch{dim3((pairs + threads - 1) / threads, groups),
                           threads, smem, 1, a.stream, a.info};
}

template <int S, bool LAZY, int VEC>
int launch(const Args& a) {
  constexpr size_t smem = sizeof(uint32_t) * kGroup * (S + 2);
  return rt::cluster_launch(shape(a, smem), bconv_kernel<S, LAZY, VEC>, a.v,
                            a.w, a.p, a.pi, a.out, a.D, a.n);
}

template <int S>
int by_flags(const Args& a) {
  if (a.lazy)
    return a.vec == 2 ? launch<S, true, 2>(a) : launch<S, true, 1>(a);
  return a.vec == 2 ? launch<S, false, 2>(a) : launch<S, false, 1>(a);
}

int by_s(int S, const Args& a) {
  static_assert(kMaxS == 7, "one case per instantiated S");
  switch (S) {
    case 1: return by_flags<1>(a);
    case 2: return by_flags<2>(a);
    case 3: return by_flags<3>(a);
    case 4: return by_flags<4>(a);
    case 5: return by_flags<5>(a);
    case 6: return by_flags<6>(a);
    case 7: return by_flags<7>(a);
    default: return cudaErrorInvalidValue;
  }
}

// 16-byte words when n is even and both row bases allow them
int vec_for(const void* v, const void* out, int n) {
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  return n % 2 == 0 && aligned(v) && aligned(out) ? 2 : 1;
}

}  // namespace

// v (S, n) int64, w (D, S) u32 Montgomery weights, p and -p^-1 (D,) u32
// -> out (D, n) int64; S from 1 to kMaxS (cudaErrorInvalidValue above).
extern "C" int rt_bconv(const void* v, const void* w, const void* p,
                        const void* pi, void* out, int S, int D, int n,
                        int lazy, void* stream) {
  const Args a{static_cast<const int64_t*>(v), static_cast<const uint32_t*>(w),
               static_cast<const uint32_t*>(p),
               static_cast<const uint32_t*>(pi), static_cast<int64_t*>(out),
               D, n, lazy != 0, vec_for(v, out, n),
               static_cast<cudaStream_t>(stream), nullptr};
  return by_s(S, a);
}

// The launch rt_bconv would make for (S, D, n) with 16-byte aligned rows,
// written to info[9] as rt::ClusterLaunch does (cluster 1); nothing runs.
extern "C" int rt_bconv_info(int* info, int S, int D, int n, int lazy) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, D, n, lazy != 0,
               vec_for(nullptr, nullptr, n), nullptr, info};
  return by_s(S, a);
}
