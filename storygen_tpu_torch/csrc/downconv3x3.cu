// 3x3 stride-2 convolution over NHWC with explicit zero padding, for Hopper
// (sm_90a):
//   out[b, oy, ox, co] = bias[co] + sum_{dy, dx, ci}
//       x[b, 2*oy+dy-pt, 2*ox+dx-pl, ci] * w9[3*dy+dx, ci, co]
// where an input index outside the image reads 0. The caller gives the top
// and left padding and the output size, Ho = (H + pt + pb - 3) / 2 + 1 and
// Wo likewise; the bottom and right padding is then the zero read past the
// image's last row and column. The UNet's Downsample2D pads (1, 1, 1, 1),
// the VAE encoder's (0, 1, 0, 1): both take 64 rows to 32, 512 to 256.
//
// Replaces _down_kernel in storygen_tpu/ops/pallas_conv.py (reached through
// halo_downconv / downconv3x3): fp32 accumulation and a (Cout) bias.
//
// What bounds it on the H100: at the UNet's 64x64 -> 32x32 site and the VAE
// encoder's 128 px site the work is tensor-core work (9*Cin MACs per output
// pixel); at the VAE encoder's 512 px site (Cin 128) it is bound by the
// bytes of its input, read once if each input tile goes to shared memory
// once. The JAX kernel splits the padded input into four parity phases
// outside the kernel only to avoid strided VMEM reads; here the taps read
// the strided pixels in place from shared memory, so there is no phase pass
// through device memory.
//
// Design (kernel C's, with the slab twice as tall and wide): one block of 8
// warps computes an 8-row x 16-column tile of output pixels for 64 output
// channels. It walks Cin in 32-channel chunks; per chunk it loads the
// (2*8+1) x (2*16+1) x 32 input slab, zero outside the image, and the
// (9, 32, 64) slice of the weights packed as (9, Cin, Cout) bf16. Warp w
// owns output row w: for tap (dy, dx) its A operand is slab row 2w+dy,
// columns dx, dx+2, ..., dx+30, a WMMA operand with a leading dimension of
// twice the slab's pixel stride. Simple first: no cp.async pipelining,
// wgmma or TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8, TW = 16;          // output tile: rows x columns
constexpr int SH = 2 * TH + 1, SW = 2 * TW + 1;
constexpr int CK = 32;                  // input channels per chunk
constexpr int CKS = 48;                 // slab pixel stride (bf16), 32 B aligned
constexpr int CBN = 64;                 // output channels per block
constexpr int LDB = CBN + 8;            // weight tile row stride (bf16)
constexpr int LDC = CBN + 4;            // fp32 staging row stride
constexpr int NWARPS = TH;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SLAB_BYTES = (SH * SW * CKS * 2 + 127) / 128 * 128;  // 53888
constexpr int W_BYTES = 9 * CK * LDB * 2;                           // 41472
constexpr int SMEM_BYTES = SLAB_BYTES + W_BYTES;                    // 95360
static_assert(NWARPS * 16 * LDC * 4 <= W_BYTES, "staging must fit");

__global__ void __launch_bounds__(NTHREADS)
downconv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w9,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   int H, int W, int Cin, int Cout, int Ho, int Wo, int pt,
                   int pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* slab = reinterpret_cast<bf16*>(smem);
  bf16* Ws = reinterpret_cast<bf16*>(smem + SLAB_BYTES);

  const int ntw = (Wo + TW - 1) / TW;
  const int ox0 = (blockIdx.x % ntw) * TW, oy0 = (blockIdx.x / ntw) * TH;
  const int iy0 = 2 * oy0 - pt, ix0 = 2 * ox0 - pl;  // the slab's origin
  const int co0 = blockIdx.y * CBN;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* xb = x + (long long)b * H * W * Cin;
  const bool cin_vec = (Cin % 8) == 0;
  const bool cout_vec = (Cout % 8) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CBN / 16];
#pragma unroll
  for (int j = 0; j < CBN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    // input slab: rows iy0 .. iy0+2*TH, columns ix0 .. ix0+2*TW
    if (cin_vec) {
      for (int idx = threadIdx.x; idx < SH * SW * (CK / 8); idx += NTHREADS) {
        const int p = idx / (CK / 8), cc = (idx % (CK / 8)) * 8;
        const int gy = iy0 + p / SW, gx = ix0 + p % SW, ci = c0 + cc;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Cin)
          val = *reinterpret_cast<const uint4*>(
              xb + ((long long)gy * W + gx) * Cin + ci);
        *reinterpret_cast<uint4*>(slab + p * CKS + cc) = val;
      }
    } else {
      for (int idx = threadIdx.x; idx < SH * SW * CK; idx += NTHREADS) {
        const int p = idx / CK, cc = idx % CK;
        const int gy = iy0 + p / SW, gx = ix0 + p % SW, ci = c0 + cc;
        bf16 val = __float2bfloat16(0.f);
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Cin)
          val = xb[((long long)gy * W + gx) * Cin + ci];
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
        // 16 output columns: slab columns dx, dx+2, ..., dx+30 of row 2w+dy
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(
            a, slab + ((2 * warp + dy) * SW + dx) * CKS + kk * 16, 2 * CKS);
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

  // epilogue: stage the warp's 16 x 64 tile (aliasing the weight tile), add
  // the bias in fp32, write bf16
  float* Cs = reinterpret_cast<float*>(smem + SLAB_BYTES) + warp * 16 * LDC;
#pragma unroll
  for (int j = 0; j < CBN / 16; ++j)
    wmma::store_matrix_sync(Cs + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncwarp();
  const int oy = oy0 + warp;
  if (oy >= Ho) return;
  for (int idx = lane; idx < 16 * CBN; idx += 32) {
    const int i = idx / CBN, c = idx % CBN;
    const int ox = ox0 + i, co = co0 + c;
    if (ox < Wo && co < Cout) {
      const long long o = (((long long)b * Ho + oy) * Wo + ox) * Cout + co;
      out[o] = __float2bfloat16(Cs[i * LDC + c] + bias[co]);
    }
  }
}

}  // namespace

// kernel D
extern "C" int sg_downconv3x3(const void* x, const void* w9, const void* bias,
                              void* out, int B, int H, int W, int Cin,
                              int Cout, int Ho, int Wo, int pt, int pl,
                              void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      downconv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((Wo + TW - 1) / TW) * ((Ho + TH - 1) / TH);
  dim3 grid(tiles, (Cout + CBN - 1) / CBN, B);
  downconv3x3_kernel<<<grid, NTHREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w9),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W, Cin,
      Cout, Ho, Wo, pt, pl);
  return static_cast<int>(cudaGetLastError());
}
