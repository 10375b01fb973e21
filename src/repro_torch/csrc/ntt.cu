// K7: the four-step negacyclic NTT for Hopper (sm_90a), plain C entries
// loaded with ctypes by repro_torch/kernels/ntt.py.
//
// Replaces repro/kernels/ntt.py::_ntt_col_kernel (ntt.py:52) and
// ::_ntt_row_kernel (ntt.py:59). One length-N row, viewed as (R, C):
//   ntt_col  grid (C / bc): a block holds an (R, bc) tile in shared
//            memory and runs the R-point Harvey CT stages down its
//            columns (twiddle index depends on the row only);
//   ntt_row  grid (R / br): a block holds a (br, C) tile, multiplies it
//            by the fused correction table t2 (phase 2) and runs the
//            C-point CT stages along its rows (phase 3).
// Output in kernel order: out[u*C + v] = hat a[brv_R(u) + R*brv_C(v)]
// (repro/kernels/ref.py:103-110). Twiddles and t2 are in Montgomery form,
// so each product is one REDC; sums are formed in 64 bits (q < 2^32).
//
// What bounds it: at one row of N = 2^16 neither bytes (1.3 MB) nor
// operations bound it; the launch and the dependent chain of log R (log
// C) stages, each ending in __syncthreads, do. The TPU's blocks (R, 128)
// and (8, C) are kept as the tiles, so at R = C = 256 the column kernel
// runs 2 blocks of 128 KB of shared memory (dynamic, above the 48 KB
// default) and the row kernel 32 blocks; every thread of a block takes
// butterflies with neighbouring columns (column kernel) so shared-memory
// accesses of a warp fall in distinct banks.
//
// Tensors: a and out int64 (N,) residues < q; the (R, C) intermediate,
// tables and constants are u32 in int32 storage, contiguous.

#include "common.cuh"

using rt::add_mod;
using rt::mont_mul;
using rt::sub_mod;

namespace {

__global__ void __launch_bounds__(rt::kMaxThreads)
ntt_col_kernel(const int64_t* __restrict__ a, uint32_t* __restrict__ y,
               const uint32_t* __restrict__ rp,
               const uint32_t* __restrict__ qv,
               const uint32_t* __restrict__ qiv, int log_r, int C, int bc) {
  extern __shared__ uint32_t tile[];          // (R, bc)
  const int R = 1 << log_r;
  const int c0 = blockIdx.x * bc;
  const uint32_t q = qv[0], qi = qiv[0];
  for (int i = threadIdx.x; i < R * bc; i += blockDim.x)
    tile[i] = static_cast<uint32_t>(
        a[static_cast<size_t>(i / bc) * C + c0 + i % bc]);
  __syncthreads();
  const int half = (R / 2) * bc;
  for (int m = 1; m < R; m <<= 1) {
    const int t = R / (2 * m);
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int col = b % bc;
      const int k = b / bc;                   // butterfly row, < R/2
      const int g = k / t;
      const int p0 = (2 * g * t + k % t) * bc + col;
      const int p1 = p0 + t * bc;
      const uint32_t u = tile[p0];
      const uint32_t v = mont_mul(tile[p1], rp[m + g], q, qi);
      tile[p0] = add_mod(u, v, q);
      tile[p1] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < R * bc; i += blockDim.x)
    y[static_cast<size_t>(i / bc) * C + c0 + i % bc] = tile[i];
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

extern "C" int rt_ntt_col(const void* a, void* y, const void* rp,
                          const void* q, const void* qi, int log_r, int C,
                          int bc, void* stream) {
  const int R = 1 << log_r;
  const int smem = static_cast<int>(sizeof(uint32_t)) * R * bc;
  cudaError_t err = cudaFuncSetAttribute(
      ntt_col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ntt_col_kernel<<<C / bc, threads_for(R / 2 * bc), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(rp), static_cast<const uint32_t*>(q),
      static_cast<const uint32_t*>(qi), log_r, C, bc);
  return cudaGetLastError();
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
