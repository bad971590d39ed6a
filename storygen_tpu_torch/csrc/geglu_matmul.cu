// Fused GEGLU -> output GEMM for Hopper (sm_90a):
//   out (M, E) = (value * gelu(gate)) @ W^T + bias,  [value | gate] = proj.
//
// Replaces _geglu_kernel in storygen_tpu/ops/pallas_geglu.py (called
// through geglu_matmul). The Abramowitz & Stegun erf of the TPU kernel is a
// Mosaic workaround; this kernel uses the true erff.
//
// What bounds it on the H100: the feed-forward's packed projection is the
// largest activation of a transformer block ((3*4096, 2*1280) bf16 = 63 MB
// at the first level for a 3-row CFG batch). Unfused, the gated product is
// written to HBM and read back by the GEMM; this kernel reads value and gate
// once per output-column tile and never writes the gated product, so HBM
// traffic is the projection plus the output. The GEMM itself (2*M*N*E
// flops) is tensor-core work.
//
// Design: one block of 4 warps computes a 64 x 64 output tile and walks the
// inner dimension N in 32-wide steps. Each step reads the value and gate
// tiles from the one packed (M, 2N) array (gate at column offset N),
// computes v * gelu(g) in fp32, rounds it to bf16 into shared memory as the
// A operand, and reads the matching (64 x 32) slice of W, stored as the
// nn.Linear weight (E, N), as a column-major B operand. Each warp owns a
// 32 x 32 quarter of the tile (2 x 2 WMMA fragments, fp32 accumulation).
// The bias is added in fp32 in the epilogue. Rows past M and columns past E
// are masked, so any M works; N must be a multiple of 32.
// Simple first: no cp.async double buffering, wgmma or TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int GM = 64, GE = 64, GK = 32;
constexpr int LDA = GK + 8;  // padded shared row (bf16), keeps 32 B alignment
constexpr int LDC = GE + 4;  // padded fp32 staging row
constexpr int NTHREADS = 128;

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

__global__ void __launch_bounds__(NTHREADS)
geglu_matmul_kernel(const bf16* __restrict__ proj, const bf16* __restrict__ w,
                    const float* __restrict__ bias, bf16* __restrict__ out,
                    int M, int N, int E) {
  __shared__ __align__(128) bf16 As[GM * LDA];
  __shared__ __align__(128) bf16 Ws[GE * LDA];
  __shared__ __align__(128) float Cs[GM * LDC];

  const int m0 = blockIdx.x * GM, e0 = blockIdx.y * GE;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, we = (warp % 2) * 32;
  const long long prs = 2LL * N;  // row stride of proj

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int n0 = 0; n0 < N; n0 += GK) {
    // A tile: bf16(value * gelu(gate)), 8 columns per thread-step
    for (int idx = threadIdx.x; idx < GM * GK / 8; idx += NTHREADS) {
      const int r = idx / (GK / 8), c = (idx % (GK / 8)) * 8;
      const int gr = m0 + r;
      __align__(16) bf16 a8[8];
      if (gr < M) {
        const bf16* row = proj + gr * prs + n0 + c;
        __align__(16) bf16 v8[8];
        __align__(16) bf16 g8[8];
        *reinterpret_cast<uint4*>(v8) = *reinterpret_cast<const uint4*>(row);
        *reinterpret_cast<uint4*>(g8) =
            *reinterpret_cast<const uint4*>(row + N);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          a8[t] = __float2bfloat16(__bfloat162float(v8[t]) *
                                   gelu_erf(__bfloat162float(g8[t])));
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) a8[t] = __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(As + r * LDA + c) =
          *reinterpret_cast<const uint4*>(a8);
    }
    // W tile: rows e0..e0+63 of the (E, N) weight, columns n0..n0+31
    for (int idx = threadIdx.x; idx < GE * GK / 8; idx += NTHREADS) {
      const int r = idx / (GK / 8), c = (idx % (GK / 8)) * 8;
      const int ge = e0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (ge < E)
        val = *reinterpret_cast<const uint4*>(w + (long long)ge * N + n0 + c);
      *reinterpret_cast<uint4*>(Ws + r * LDA + c) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + i * 16) * LDA + kk * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bw[j], Ws + (we + j * 16) * LDA + kk * 16, LDA);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + we + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < GM * GE; idx += NTHREADS) {
    const int r = idx / GE, c = idx % GE;
    const int gr = m0 + r, ge = e0 + c;
    if (gr < M && ge < E)
      out[(long long)gr * E + ge] = __float2bfloat16(Cs[r * LDC + c] + bias[ge]);
  }
}

}  // namespace

extern "C" int sg_geglu_matmul(const void* proj, const void* w,
                               const void* bias, void* out, int M, int N,
                               int E, void* stream) {
  if (N % GK != 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((M + GM - 1) / GM, (E + GE - 1) / GE);
  geglu_matmul_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(proj), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), M, N, E);
  return static_cast<int>(cudaGetLastError());
}
