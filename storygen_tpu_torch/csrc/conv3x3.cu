// 3x3 stride-1 SAME convolution over NHWC for Hopper (sm_90a):
//   out[b, y, x, co] = bias[b?, co] + sum_{dy, dx, ci}
//       x[b, y+dy-1, x+dx-1, ci] * w9[3*dy+dx, ci, co]   (+ residual)
//
// Replaces _kernel (fused=False) in storygen_tpu/ops/pallas_conv.py, called
// through halo_conv / conv3x3: fp32 accumulation, a (Cout) or per-batch
// (B, Cout) bias (the resnet's time-embedding add folded into the output
// write) and an optional residual added in the epilogue.
//
// What bounds it on the H100: at the UNet's 64x64 sites (320-960 -> 320
// channels) and the VAE decoder's 256-512 px sites the convolution is
// tensor-core work (9*Cin MACs per output) as long as the input is read
// about once; an im2col or 9-tap-GEMM formulation reads it nine times. The
// design reads each input tile once into shared memory, with its one-pixel
// halo, and runs the nine taps from there (implicit GEMM).
//
// Design: one block of 8 warps computes an 8-row x 16-column tile of output
// pixels for 64 output channels. It walks Cin in 32-channel chunks; per
// chunk it loads the (8+2) x (16+2) x 32 halo slab, zero outside the image
// (the SAME padding), and the (9, 32, 64) slice of the weights packed once
// as (9, Cin, Cout) bf16. Warp w owns output row w: for each tap its A
// operand is 16 consecutive slab pixels shifted by (dy, dx), read in place
// from the slab, and it accumulates 16 pixels x 64 channels in four fp32
// WMMA fragments. Narrow channel counts (Cin 3/4 at conv_in, Cout 3/4 at
// conv_out) are zero-padded inside shared memory; the epilogue masks the
// image and channel edges. Simple first: no cp.async pipelining, wgmma or
// TMA yet, and weights are re-read from L2 by every pixel tile.
//
// Kernel P, the instantiation with PRO = true, replaces the same _kernel with
// fused=True (reached through gnconv3x3 / gnconvres3x3): the folded
// GroupNorm affine and SiLU of the resnet, act = bf16(silu(x * a[b, ci] +
// s[b, ci])) with a and s fp32 (B, Cin), is applied where the halo slab is
// loaded, so the normalised tensor never exists in device memory. Only
// elements inside the image and below Cin get the prologue: the SAME border
// and the channel padding stay exactly 0, since silu(s) != 0 (the JAX kernel
// masks its border for the same reason). x * a and + s round separately and
// silu is z / (1 + exp(-z)), as PyTorch computes them, so act rounds to bf16
// at the point the unfused GroupNorm casts its result. Each of the grid's
// Cout blocks recomputes the prologue of its slab.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8, TW = 16;       // output tile: rows x columns
constexpr int SH = TH + 2, SW = TW + 2;
constexpr int CK = 32;               // input channels per chunk
constexpr int CKS = 48;              // slab pixel stride (bf16), 32 B aligned
constexpr int CBN = 64;              // output channels per block
constexpr int LDB = CBN + 8;         // weight tile row stride (bf16)
constexpr int LDC = CBN + 4;         // fp32 staging row stride
constexpr int NWARPS = TH;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SLAB_BYTES = SH * SW * CKS * 2;           // 17280
constexpr int W_BYTES = 9 * CK * LDB * 2;               // 41472
constexpr int SMEM_BYTES = SLAB_BYTES + W_BYTES;        // 58752
static_assert(NWARPS * 16 * LDC * 4 <= W_BYTES, "staging must fit");
static_assert(SLAB_BYTES % 128 == 0, "weight tile alignment");

// silu(v * a + s) in fp32, each step rounded as PyTorch's eager ops round it
__device__ __forceinline__ float silu_affine(float v, float a, float s) {
  const float z = __fadd_rn(__fmul_rn(v, a), s);
  return z / (1.f + expf(-z));
}

// the prologue of 8 consecutive channels held as one 16-byte load
__device__ __forceinline__ uint4 prologue8(uint4 v, const float* a,
                                           const float* s) {
  union {
    uint4 u;
    __nv_bfloat162 h[4];
  } p;
  p.u = v;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p.h[i]);
    p.h[i] = __floats2bfloat162_rn(silu_affine(f.x, a[2 * i], s[2 * i]),
                                   silu_affine(f.y, a[2 * i + 1],
                                               s[2 * i + 1]));
  }
  return p.u;
}

template <bool PRO>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w9,
               const float* __restrict__ bias, long long bias_bstride,
               const float* __restrict__ pa, const float* __restrict__ ps,
               const bf16* __restrict__ res, bf16* __restrict__ out, int H,
               int W, int Cin, int Cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* slab = reinterpret_cast<bf16*>(smem);
  bf16* Ws = reinterpret_cast<bf16*>(smem + SLAB_BYTES);

  const int ntw = (W + TW - 1) / TW;
  const int x0 = (blockIdx.x % ntw) * TW, y0 = (blockIdx.x / ntw) * TH;
  const int co0 = blockIdx.y * CBN;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* xb = x + (long long)b * H * W * Cin;
  const float* ab = PRO ? pa + (long long)b * Cin : nullptr;
  const float* sb = PRO ? ps + (long long)b * Cin : nullptr;
  const bool cin_vec = (Cin % 8) == 0;
  const bool cout_vec = (Cout % 8) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CBN / 16];
#pragma unroll
  for (int j = 0; j < CBN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    // halo slab: rows y0-1 .. y0+TH, columns x0-1 .. x0+TW, channels c0..c0+31
    if (cin_vec) {
      for (int idx = threadIdx.x; idx < SH * SW * (CK / 8); idx += NTHREADS) {
        const int p = idx / (CK / 8), cc = (idx % (CK / 8)) * 8;
        const int gy = y0 - 1 + p / SW, gx = x0 - 1 + p % SW, ci = c0 + cc;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Cin) {
          val = *reinterpret_cast<const uint4*>(
              xb + ((long long)gy * W + gx) * Cin + ci);
          if (PRO) val = prologue8(val, ab + ci, sb + ci);
        }
        *reinterpret_cast<uint4*>(slab + p * CKS + cc) = val;
      }
    } else {
      for (int idx = threadIdx.x; idx < SH * SW * CK; idx += NTHREADS) {
        const int p = idx / CK, cc = idx % CK;
        const int gy = y0 - 1 + p / SW, gx = x0 - 1 + p % SW, ci = c0 + cc;
        bf16 val = __float2bfloat16(0.f);
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Cin) {
          val = xb[((long long)gy * W + gx) * Cin + ci];
          if (PRO)
            val = __float2bfloat16(
                silu_affine(__bfloat162float(val), ab[ci], sb[ci]));
        }
        slab[p * CKS + cc] = val;
      }
    }
    // weights: Ws[tap][ci][co] for ci in the chunk, co in the block's range
    if (cout_vec) {
      for (int idx = threadIdx.x; idx < 9 * CK * (CBN / 8); idx += NTHREADS) {
        const int r = idx / (CBN / 8), cc = (idx % (CBN / 8)) * 8;
        const int tap = r / CK, ci = c0 + r % CK, co = co0 + cc;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (ci < Cin && co < Cout)
          val = *reinterpret_cast<const uint4*>(
              w9 + ((long long)tap * Cin + ci) * Cout + co);
        *reinterpret_cast<uint4*>(Ws + r * LDB + cc) = val;
      }
    } else {
      for (int idx = threadIdx.x; idx < 9 * CK * CBN; idx += NTHREADS) {
        const int r = idx / CBN, cc = idx % CBN;
        const int tap = r / CK, ci = c0 + r % CK, co = co0 + cc;
        bf16 val = __float2bfloat16(0.f);
        if (ci < Cin && co < Cout)
          val = w9[((long long)tap * Cin + ci) * Cout + co];
        Ws[r * LDB + cc] = val;
      }
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(
            a, slab + ((warp + dy) * SW + dx) * CKS + kk * 16, CKS);
#pragma unroll
        for (int j = 0; j < CBN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
          wmma::load_matrix_sync(bw, Ws + (tap * CK + kk * 16) * LDB + j * 16,
                                 LDB);
          wmma::mma_sync(acc[j], a, bw, acc[j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: stage the warp's 16 x 64 tile (aliasing the weight tile),
  // add bias and residual in fp32, write bf16
  float* Cs = reinterpret_cast<float*>(smem + SLAB_BYTES) + warp * 16 * LDC;
#pragma unroll
  for (int j = 0; j < CBN / 16; ++j)
    wmma::store_matrix_sync(Cs + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncwarp();
  const int gy = y0 + warp;
  if (gy >= H) return;
  const float* bb = bias + (long long)b * bias_bstride;
  for (int idx = lane; idx < 16 * CBN; idx += 32) {
    const int i = idx / CBN, c = idx % CBN;
    const int gx = x0 + i, co = co0 + c;
    if (gx < W && co < Cout) {
      const long long o = (((long long)b * H + gy) * W + gx) * Cout + co;
      float val = Cs[i * LDC + c] + bb[co];
      if (res != nullptr) val += __bfloat162float(res[o]);
      out[o] = __float2bfloat16(val);
    }
  }
}

template <bool PRO>
int launch(const void* x, const void* w9, const void* bias,
           long long bias_bstride, const void* a, const void* s,
           const void* residual, void* out, int B, int H, int W, int Cin,
           int Cout, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<PRO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
  dim3 grid(tiles, (Cout + CBN - 1) / CBN, B);
  conv3x3_kernel<PRO><<<grid, NTHREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w9),
      static_cast<const float*>(bias), bias_bstride,
      static_cast<const float*>(a), static_cast<const float*>(s),
      static_cast<const bf16*>(residual), static_cast<bf16*>(out), H, W, Cin,
      Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kernel C
extern "C" int sg_conv3x3(const void* x, const void* w9, const void* bias,
                          long long bias_bstride, const void* residual,
                          void* out, int B, int H, int W, int Cin, int Cout,
                          void* stream) {
  return launch<false>(x, w9, bias, bias_bstride, nullptr, nullptr, residual,
                       out, B, H, W, Cin, Cout, stream);
}

// kernel P: a and s are fp32 (B, Cin)
extern "C" int sg_gnconv3x3(const void* x, const void* w9, const void* bias,
                            long long bias_bstride, const void* a,
                            const void* s, const void* residual, void* out,
                            int B, int H, int W, int Cin, int Cout,
                            void* stream) {
  return launch<true>(x, w9, bias, bias_bstride, a, s, residual, out, B, H, W,
                      Cin, Cout, stream);
}
