// The implicit-GEMM 3x3 stride-1 SAME convolution over NHWC for sm_90a on
// mma.sync that kernel C (conv3x3.cu) instantiates at the keys that
// conv_wgmma.cuh does not take (Cin % 8 != 0, the conv_in; Cout <= 16, the
// conv_out), where the card is bound by bytes; the tile study also times
// it, P's prologue included, at every stride-1 key:
//   out[b, y, x, co] = bias[b?, co] + sum_{dy, dx, ci}
//       act(x[b, y+dy-1, x+dx-1, ci]) * w9[3*dy+dx, ci, co]
//       (+ residual[b, y, x, co])
// with an input index outside the image reading 0, act the identity or P's
// prologue bf16(silu(x * a[b, ci] + s[b, ci])), fp32 accumulation and a
// bf16 result.
//
// The GEMM view: M is a tile of TH x TW output pixels (rows of 8, 16 or
// 32 columns), N a block of BN output channels, K = 9 Cin, walked in chunks
// of CK input channels, each chunk nine taps deep. Per chunk a block holds
// the tile's halo slab ((TH+2) x (TW+2) pixels x CK channels)
// and the (9, CK, BN) slice of the weights packed as (9, Cin, Cout) bf16.
//
// - Tensor cores through mma.sync m16n8k16 (bf16 in, fp32 accumulators in
//   registers). A warp owns MT 16-pixel row tiles by NTN 8-channel column
//   tiles; WM x WN warps cover the block.
// - A fragments straight from the slab with ldmatrix: each lane gives the
//   address of its own pixel (y + dy, x + dx) at the k step's channel
//   offset, so a tap shift costs an address, not a copy; no im2col exists
//   in device or shared memory. A slab pixel is an odd number of 16-byte
//   units wide (pitch_bytes), so the eight rows of an ldmatrix fall in
//   eight bank groups.
// - B fragments from the weight chunk (k rows by n columns) with the
//   transposing ldmatrix, two n tiles per x4, as the flash forward reads V.
// - A ring of STAGES shared buffers, each the slab and the weight chunk,
//   filled by cp.async 16-byte copies: chunk i + STAGES - 1 is issued
//   before chunk i's products, behind one barrier per chunk. A halo pixel
//   outside the image, a channel past Cin and a column past Cout are
//   zero-filled by the copy's src-size operand, never read. Cin % 8 != 0
//   (the conv_in's 3 or 4 channels) has no 16-byte rows: VEC = false loads
//   its slab with plain loads and stores, and Cout % 8 != 0 (conv_out's 3)
//   its weights likewise.
// - P's prologue in shared memory: once its own copies of a chunk have
//   landed, each thread applies silu(x * a + s) in place to those of its
//   16-byte pieces that lie inside the image (channels below Cin), halfway
//   through the previous chunk's taps, so that the arithmetic overlaps
//   other warps' products and the chunk's barrier publishes it; every
//   other element stays 0, as the SAME border must. x * a and + s round separately and silu is z / (1 + exp(-z)), as
//   PyTorch computes them, so act rounds to bf16 where the unfused
//   GroupNorm casts its result.
// - The epilogue from registers: each lane adds the fp32 bias ((Cout) or
//   per batch (B, Cout)) and residual to its accumulator pairs and stores
//   bf16 pairs straight into (B, H, W, Cout). No fp32 staging tile.
#pragma once
#include "study_mma.cuh"

namespace sg_conv {

using namespace sg_study;

// silu(v * a + s) in fp32, each step rounded as PyTorch's eager ops round it
__device__ __forceinline__ float silu_affine(float v, float a, float s) {
  const float z = __fadd_rn(__fmul_rn(v, a), s);
  return z / (1.f + expf(-z));
}

// the prologue of 8 consecutive channels held as one 16-byte piece
__device__ __forceinline__ uint4 prologue8(uint4 v, const float (&a)[8],
                                           const float (&s)[8]) {
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

// The W class of an output width, shared by every conv key (mirrored by
// ops/conv.py's tile_key; conv_wgmma.cuh's conv_cout_class gives the Cout
// class): W <= 8, W <= 16 or wider.
__host__ __device__ inline int w_class(int wo) {
  return wo <= 8 ? 0 : (wo <= 16 ? 1 : 2);
}

struct ConvArgs {
  const bf16* x;          // (B, H, W, Cin)
  const bf16* w9;         // (9, Cin, Cout)
  const float* bias;      // (Cout) or (B, Cout)
  long long bias_bstride; // 0 or Cout
  const float* pa;        // P: (B, Cin) fp32, else null
  const float* ps;
  const bf16* res;        // (B, H, W, Cout) or null
  bf16* out;              // (B, H, W, Cout)
  int H, W, Cin, Cout;
};

template <int TH, int TW, int BN, int WM, int WN, int CK, int STAGES>
struct ConvCfg {
  static constexpr int NT = 32 * WM * WN;      // threads
  static constexpr int MT = TH * TW / (16 * WM);  // 16-pixel tiles a warp
  static constexpr int NTN = BN / (8 * WN);    // 8-channel tiles a warp
  static constexpr int SH = TH + 2, SW = TW + 2;  // slab rows, columns
  static constexpr int CPP = CK / 8;           // 16-byte pieces a pixel
  static constexpr int PITCH = pitch_bytes(CK * 2);   // a slab pixel
  static constexpr int WPITCH = pitch_bytes(BN * 2);  // a weight row
  static constexpr int SLAB = align128(SH * SW * PITCH);
  static constexpr int WBYTES = align128(9 * CK * WPITCH);
  static constexpr int STAGE = SLAB + WBYTES;
  static constexpr int BYTES = STAGES * STAGE;
  static_assert(TW % 8 == 0 && (TH * TW) % (16 * WM) == 0,
                "whole 16-pixel tiles per warp, 8-pixel rows");
  static_assert(BN % (16 * WN) == 0, "pairs of 8-channel tiles per warp");
  static_assert(CK % 16 == 0 && STAGES >= 2, "16-deep k steps, a ring");
  static_assert(NT % CPP == 0, "a thread copies one channel group");
};

template <bool PRO, bool VEC, int TH, int TW, int BN, int WM, int WN,
          int CK, int STAGES, int MINB>
__global__ void __launch_bounds__(32 * WM * WN, MINB)
conv_mma_kernel(const ConvArgs a) {
  using C = ConvCfg<TH, TW, BN, WM, WN, CK, STAGES>;
  constexpr int MT = C::MT, NTN = C::NTN;
  static_assert(VEC || !PRO, "P's prologue works on 16-byte pieces");
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % WM, wn = warp / WM;
  const int ntw = (a.W + TW - 1) / TW;
  const int ox0 = (blockIdx.x % ntw) * TW, oy0 = (blockIdx.x / ntw) * TH;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int iy0 = oy0 - 1, ix0 = ox0 - 1;  // slab origin
  const bf16* xb = a.x + (long long)b * a.H * a.W * a.Cin;
  const float* pab = PRO ? a.pa + (long long)b * a.Cin : nullptr;
  const float* psb = PRO ? a.ps + (long long)b * a.Cin : nullptr;
  const int nchunks = (a.Cin + CK - 1) / CK;
  const bool wvec = a.Cout % 8 == 0;

  // slab piece idx of a chunk starting at channel c0: its stored offset,
  // and whether it lies inside the image and below Cin (else it is 0)
  auto piece = [&](int idx, int c0, int& off, const bf16*& src) {
    const int p = idx / C::CPP, c = idx % C::CPP;
    const int sy = p / C::SW, sx = p % C::SW;
    const int gy = iy0 + sy, gx = ix0 + sx, ci = c0 + 8 * c;
    off = (sy * C::SW + sx) * C::PITCH + 16 * c;
    const bool in =
        gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && ci < a.Cin;
    src = in ? xb + ((long long)gy * a.W + gx) * a.Cin + ci : nullptr;
  };

  auto fetch = [&](int chunk, int stage) {
    unsigned char* sl = smem + stage * C::STAGE;
    unsigned char* ws = sl + C::SLAB;
    const int c0 = chunk * CK;
    if constexpr (VEC) {
      constexpr int N = C::SH * C::SW * C::CPP;
      for (int idx = tid; idx < N; idx += C::NT) {
        int off;
        const bf16* src;
        piece(idx, c0, off, src);
        cp_async16(sl + off, src ? src : xb, src ? 16 : 0);
      }
    } else {
      constexpr int N = C::SH * C::SW * CK;
      for (int idx = tid; idx < N; idx += C::NT) {
        const int p = idx / CK, c = idx % CK;
        const int sy = p / C::SW, sx = p % C::SW;
        const int gy = iy0 + sy, gx = ix0 + sx, ci = c0 + c;
        bf16 v = __float2bfloat16(0.f);
        if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && ci < a.Cin)
          v = xb[((long long)gy * a.W + gx) * a.Cin + ci];
        *reinterpret_cast<bf16*>(sl + (sy * C::SW + sx) * C::PITCH +
                                 2 * c) = v;
      }
    }
    // weights: row (tap, ci) of the chunk, columns co0 .. co0 + BN - 1
    if (wvec) {
      constexpr int CPR = BN / 8;
      constexpr int N = 9 * CK * CPR;
      for (int idx = tid; idx < N; idx += C::NT) {
        const int r = idx / CPR, c = idx % CPR;
        const int tap = r / CK, ci = c0 + r % CK, co = co0 + 8 * c;
        const bool in = ci < a.Cin && co < a.Cout;
        cp_async16(ws + r * C::WPITCH + 16 * c,
                   in ? a.w9 + ((long long)tap * a.Cin + ci) * a.Cout + co
                      : a.w9,
                   in ? 16 : 0);
      }
    } else {
      constexpr int N = 9 * CK * BN;
      for (int idx = tid; idx < N; idx += C::NT) {
        const int r = idx / BN, c = idx % BN;
        const int tap = r / CK, ci = c0 + r % CK, co = co0 + c;
        bf16 v = __float2bfloat16(0.f);
        if (ci < a.Cin && co < a.Cout)
          v = a.w9[((long long)tap * a.Cin + ci) * a.Cout + co];
        *reinterpret_cast<bf16*>(ws + r * C::WPITCH + 2 * c) = v;
      }
    }
  };

  // P: the prologue, in place, on this thread's own landed slab pieces;
  // they all hold the same 8 channels (NT % CPP == 0), whose a and s are
  // loaded once per chunk
  auto prologue = [&](int chunk, int stage) {
    unsigned char* sl = smem + stage * C::STAGE;
    const int c0 = chunk * CK, ci = c0 + 8 * (tid % C::CPP);
    if (ci >= a.Cin) return;
    float av[8], sv[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a4 = *reinterpret_cast<const float4*>(pab + ci + 4 * h);
      const float4 s4 = *reinterpret_cast<const float4*>(psb + ci + 4 * h);
      av[4 * h] = a4.x, av[4 * h + 1] = a4.y, av[4 * h + 2] = a4.z,
      av[4 * h + 3] = a4.w;
      sv[4 * h] = s4.x, sv[4 * h + 1] = s4.y, sv[4 * h + 2] = s4.z,
      sv[4 * h + 3] = s4.w;
    }
    constexpr int N = C::SH * C::SW * C::CPP;
    for (int idx = tid; idx < N; idx += C::NT) {
      int off;
      const bf16* src;
      piece(idx, c0, off, src);
      if (src) {
        uint4* q = reinterpret_cast<uint4*>(sl + off);
        *q = prologue8(*q, av, sv);
      }
    }
  };

  // this lane's ldmatrix row of each of its 16-pixel tiles: the stored
  // offset of its pixel's tap (0, 0); a tap adds a constant
  int arow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = (wm * MT + mt) * 16 + lane % 8 + 8 * ((lane / 8) % 2);
    arow[mt] = (p / TW * C::SW + p % TW) * C::PITCH +
               16 * (lane / 16);
  }
  // and of the transposing ldmatrix of the weight chunk
  const int brow = (lane % 8 + 8 * ((lane / 8) % 2)) * C::WPITCH +
                   16 * (lane / 16) + wn * NTN * 16;

  float acc[MT][NTN][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) fetch(s, s);
    cp_async_commit();
  }
  if constexpr (PRO) {  // chunk 0's prologue; later ones mid-loop
    cp_async_wait<STAGES - 2>();
    prologue(0, 0);
  }
  int cs = 0, ls = STAGES - 1;  // ring stages of the chunk in use / to fill
  for (int i = 0; i < nchunks; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk i
    // every piece of chunk i has landed (and had its prologue), and every
    // warp is done with the stage that the copies below overwrite
    __syncthreads();
    if (i + STAGES - 1 < nchunks) fetch(i + STAGES - 1, ls);
    cp_async_commit();
    ls = ls + 1 == STAGES ? 0 : ls + 1;
    const unsigned char* sl = smem + cs * C::STAGE;
    const unsigned char* ws = sl + C::SLAB + brow;
    cs = cs + 1 == STAGES ? 0 : cs + 1;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      if constexpr (PRO) {
        // P: halfway through chunk i's taps, the prologue of chunk i + 1
        // (stage cs now), once this thread's copies of it have landed, so
        // that its arithmetic overlaps other warps' products rather than
        // holding the next barrier
        if (tap == 4 && i + 1 < nchunks) {
          cp_async_wait<STAGES - 2>();
          prologue(i + 1, cs);
        }
      }
      // stored offset of tap (dy, dx) from the pixel's tap (0, 0)
      const int toff = (tap / 3 * C::SW + tap % 3) * C::PITCH;
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(af[mt], sl + arow[mt] + toff + 32 * kk);
#pragma unroll
        for (int nt = 0; nt < NTN; nt += 2) {
          uint32_t bf[4];
          ldsm_x4_t(bf, ws + (tap * CK + 16 * kk) * C::WPITCH + 16 * nt);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][nt], af[mt], bf[0], bf[1]);
            mma_bf16(acc[mt][nt + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
  }

  // epilogue: bias and residual in fp32, bf16 pairs into (B, H, W, Cout)
  const int grp = lane / 4, tq = lane % 4;
  const float* bb = a.bias + (long long)b * a.bias_bstride;
  const bool pairs = a.Cout % 2 == 0;
  float bz[NTN][2];
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) {
    const int co = co0 + (wn * NTN + nt) * 8 + 2 * tq;
    bz[nt][0] = co < a.Cout ? bb[co] : 0.f;
    bz[nt][1] = co + 1 < a.Cout ? bb[co + 1] : 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (wm * MT + mt) * 16 + grp + 8 * h;
      const int oy = oy0 + p / TW, ox = ox0 + p % TW;
      if (oy >= a.H || ox >= a.W) continue;
      const long long o =
          (((long long)b * a.H + oy) * a.W + ox) * a.Cout;
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt) {
        const int co = co0 + (wn * NTN + nt) * 8 + 2 * tq;
        float v0 = acc[mt][nt][2 * h] + bz[nt][0];
        float v1 = acc[mt][nt][2 * h + 1] + bz[nt][1];
        if (pairs) {
          if (co < a.Cout) {
            if (a.res != nullptr) {
              const float2 r = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(a.res + o + co));
              v0 += r.x;
              v1 += r.y;
            }
            *reinterpret_cast<uint32_t*>(a.out + o + co) = pack_bf16(v0, v1);
          }
        } else {
          if (co < a.Cout) {
            if (a.res != nullptr) v0 += __bfloat162float(a.res[o + co]);
            a.out[o + co] = __float2bfloat16(v0);
          }
          if (co + 1 < a.Cout) {
            if (a.res != nullptr) v1 += __bfloat162float(a.res[o + co + 1]);
            a.out[o + co + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
}

// One launch of an instantiation on the grid (ceil(H/TH) ceil(W/TW),
// ceil(Cout/BN), B); returns the launch's cudaError_t.
template <bool PRO, bool VEC, int TH, int TW, int BN, int WM, int WN,
          int CK, int STAGES, int MINB>
cudaError_t conv_launch(const ConvArgs& a, int B, cudaStream_t stream) {
  using C = ConvCfg<TH, TW, BN, WM, WN, CK, STAGES>;
  static_assert(MINB * (C::BYTES + 1024) <= 233472,
                "MINB blocks' shared memory fits an SM");
  auto kern = conv_mma_kernel<PRO, VEC, TH, TW, BN, WM, WN, CK, STAGES,
                              MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  const int tiles = ((a.W + TW - 1) / TW) * ((a.H + TH - 1) / TH);
  dim3 grid(tiles, (a.Cout + BN - 1) / BN, B);
  kern<<<grid, C::NT, C::BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace sg_conv
