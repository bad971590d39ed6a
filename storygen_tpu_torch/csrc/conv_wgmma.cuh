// The 3x3 convolution over NHWC on Hopper's own instructions (sm_90a),
// with stride S = 1 (SAME, instantiated by kernels C and P, conv3x3.cu, at
// every key with Cin % 8 == 0 and Cout > 16) or S = 2 (explicit zero
// padding, kernel D, downconv3x3.cu):
//   out[b, y, x, co] = bias[b?, co] + sum_{dy, dx, ci}
//       act(x[b, S*y+dy-pt, S*x+dx-pl, ci]) * w9[3*dy+dx, ci, co]
//       (+ residual)
// an input index outside the image reading 0, pt = pl = 1 at S = 1, act
// the identity (C, D) or P's prologue bf16(silu(x * a[b, ci] + s[b, ci])).
// It replaces _kernel of storygen_tpu/ops/pallas_conv.py:61 (fused=False
// and fused=True), reached through the pallas_call at :295, and
// _down_kernel :312 of the same file (D), reached through :423.
// In its phase mode (MODE PHASES, kernel U, upconv3x3.cu) it computes the
// 3x3 SAME conv of x's nearest 2x upsampling as four 2x2 convs on x's own
// grid, one per output phase (pa, pb):
//   out[b, 2y+pa, 2x+pb, co] = bias[co] + sum_{r, c, ci}
//       x[b, y-1+pa+r, x-1+pb+c, ci] * w16[4*(2*pa+pb) + 2*r+c, ci, co]
// with w16 the phase weights (sums of the 3x3 taps that land on one
// source pixel; ops/upconv.py::phase_weight), the counterpart of
// storygen_tpu/models/layers.py:220 (_UpsampleConv, XLA's convolutions).
//
// What bounds it on the H100, by site class:
// - Wide images (64x64 latents, the VAE's 128-512 px): tensor-core work,
//   2 pixels 9 Cin Cout operations, as long as a block's pixels share each
//   weight they read; the weights (9 Cin x Cout) then come from L2 once per
//   256-pixel block.
// - Few-pixel images (16x16 and 8x8 latents at 1280-2560 channels, M =
//   768 and 192 at batch 3): the weights' bytes. Up block 1's weights are
//   9 x 2560 x 1280 bf16 = 59 MB, 18 us at 3.35 TB/s, against 11 us of its
//   products; a tiling that re-reads them per M tile multiplies that time.
// - Stride 2 (D) likewise, by its output: tensor-core work at the UNet's
//   and the VAE encoder's 128 and 256 px sites; the input's bytes at the
//   VAE encoder's 512 px one (201 MB at batch 3); the weights' at UNet L3
//   (16 -> 8 columns, 1280 channels: 29.5 MB).
// - The phases (U): 2 pixels 16 Cin Cout operations a source pixel (36 on
//   the upsampled grid), tensor-core work at every site but the UNet's
//   first up block (8x8 -> 16x16, 1280 channels), where the phase weights'
//   16 Cin Cout bf16 (52 MB) bind.
//
// What the design does:
// - Products by wgmma.mma_async m64nNk16 (bf16 in, fp32 accumulators in
//   registers), N = BN, the block's whole Cout tile (64-160 here). A,
//   the pixels, lives in registers: each warp loads its 16 rows with
//   ldmatrix from the halo slab, so a tap shift stays an address and no
//   im2col exists anywhere; wgmma's register-A form consumes the fragments
//   as mma.sync's (the same m16k16 layout per warp). B, the weights, is
//   read by wgmma from shared memory through a matrix descriptor.
// - Copies by TMA, one producer thread, a ring of STAGES stages signalled by
//   mbarriers (full: the copies' bytes landed; empty: every consumer
//   thread is done with the stage). A stage holds one chunk of CK input
//   channels: the halo slab, one 4-D box (CK, TW+2, TH+2, IB) at (c0,
//   x0-1, y0-1, b0) of x seen as (Cin, W, H, B), whose out-of-range
//   coordinates TMA fills with zeros, which is exactly the SAME border (and
//   the channels past Cin); at stride 2 two boxes (CK, TW+1, 2TH+1, IB),
//   one of x's even input columns and one of its odd ones, each seen as
//   (Cin, half-columns, H, B) with a half-column 2 Cin elements on (below);
//   and the chunk's weights, BN / 32 boxes (32, CK, 9) of w9 seen as
//   (Cout, Cin, 9), each a 32-column panel of the (9 CK) x BN operand in
//   the canonical N-major 64-byte-swizzled layout (8 K rows of 64 bytes a
//   swizzle atom, the next 8 K rows 512 bytes on, the next panel 9 CK 64
//   bytes on). The slab's pixel rows are 2 CK bytes, swizzled
//   by TMA over 2 CK bytes, so the eight pixels of one ldmatrix fall in
//   eight bank groups. A block's warps share the SM's four register files,
//   512 registers a lane each: with the producer warpgroup, 2 / 3 / 4
//   consumer warpgroups launch at 168 / 128 / 96 registers a thread; the
//   producer then drops to 40 by setmaxnreg and the consumers rise to 232
//   / 152 / 104, which the accumulators (MT BN / 2) and P's prologue fit.
// - Stride 2: tap dx of output column ox reads input column 2 ox + dx - pl,
//   which lies in plane (dx + pl) % 2 at half-column ox + floor((dx - pl) /
//   2). The two planes land side by side, each starting at half-column x0 -
//   ceil(pl / 2), so the eight neighbouring output pixels of one ldmatrix
//   read eight neighbouring half-columns of one plane at every tap, and
//   tap dx is the plane (dx + pl % 2) % 2 at half-column offset (dx + pl %
//   2) / 2: the stride costs an address, as the tap does. TMA's zero fill
//   of out-of-range coordinates is the padding on every side (pad 1: the
//   left pad is half-column -1 of the odd plane; the VAE's (0, 1): the
//   right pad lies past the end of the even plane), and the planes need
//   no even W: the odd plane of a W-column row has floor(W / 2)
//   half-columns (W >= 2).
// - Work split to the site, never to the batch: a block takes IB images'
//   TH x TW tiles (IB = 3 whole 8x8 images at the 8-column sites, so the
//   weights are read once per call at batch 3) by BN output channels, and
//   where that leaves the card short of blocks the 9 Cin reduction is split
//   into `splits` runs of whole chunks (blockIdx.z). The number of splits
//   is a function of the output's (H, W), Cin and Cout alone
//   (ops/conv.py::split_count, for C, P and D), so every output sums its
//   chunks in one order at any batch. Each split
//   writes fp32 partials to a workspace that the wrapper allocates; a second
//   kernel adds them in split order, then the bias and the residual, and
//   stores bf16 once. No float atomics.
// - U's phases: C's stride-1 slab, (CK, TW+2, TH+2, IB) at (c0, x0-1,
//   y0-1, b0) of the source, holds every pixel that the four phases of
//   its TH x TW source pixels read, TMA's zero fill the border; phase (pa,
//   pb)'s tap (r, c) is slab offset (pa + r, pb + c), an address as C's
//   taps are. A block computes one phase (the lowest digit of blockIdx.x,
//   so the four blocks of one tile run side by side and share the slab in
//   L2), with its weights' 4 CK rows a panel (w16 seen as (Cout, Cin,
//   16), box (32, CK, 4) at tap 4 * phase), and writes pixel (2y + pa, 2x
//   + pb) of the (2H, 2W) output. The tiles, the split of the 4 Cin
//   reduction (with the phases' four blocks a tile counted) and the
//   epilogue are C's.
// - P's prologue in place on the landed slab: after a stage's full barrier
//   the consumer threads apply silu(x * a + s) to its pieces inside the
//   image and below Cin (the border and the channel padding stay 0), fence
//   the generic writes against the stage's next TMA write, and meet at a
//   named barrier before the stage's ldmatrix. P takes C's instantiation
//   at every key, so both sum in one order (split, chunk, tap, 16-channel
//   step).
// - The epilogue from the accumulators: bias ((Cout) or per batch (B,
//   Cout)) and residual in fp32, bf16 pairs straight into (B, Ho, Wo,
//   Cout).
#pragma once
#include "conv_mma.cuh"
#include "hopper.cuh"

namespace sg_conv {

using namespace sg_hopper;

// What a block does with its slab, the kernel's second template argument:
// the plain taps (C, D), P's prologue applied first, or U's phases.
constexpr int PLAIN = 0, PROLOGUE = 1, PHASES = 2;

// The Cout class of the keys of C, P and D (mirrored by ops/conv.py's
// tile_key; the W class of the output width is conv_mma.cuh's w_class): 0
// for Cout <= 16; 2 where Cin % 8 == 0 and 128 does not divide Cout > 16
// (320, 960, 160: 160-column tiles); else 1 (128-1280 on the wgmma lines,
// any wider Cout at Cin % 8 != 0).
__host__ __device__ inline int conv_cout_class(int cin, int cout) {
  if (cout <= 16) return 0;
  return cin % 8 == 0 && cout % 128 != 0 ? 2 : 1;
}

struct WgArgs {
  const bf16* x;           // (B, H, W, Cin)
  const bf16* w9;          // (9, Cin, Cout)
  const float* bias;       // (Cout) or (B, Cout)
  long long bias_bstride;  // 0 or Cout
  const float* pa;         // P: (B, Cin) fp32, else null
  const float* ps;
  const bf16* res;         // (B, Ho, Wo, Cout) or null
  bf16* out;               // (B, Ho, Wo, Cout)
  float* ws;               // (splits, B Ho Wo, Cout) fp32 where splits > 1
  int B, H, W, Cin, Cout, splits;
  int Ho, Wo, pt, pl;      // the output's size, the top and left padding
};

template <int S, int MODE, int TH, int TW, int IB, int WGM, int MT, int BN,
          int CK, int STAGES>
struct WgCfg {
  // the taps a block walks: 9, or U's 4 of its phase
  static constexpr int TAPS = MODE == PHASES ? 4 : 9;
  static constexpr int NTC = 128 * WGM;   // consumer threads
  static constexpr int NT = NTC + 128;    // and the producer warpgroup
  // Registers a thread: at launch, what the block's warps leave each (an
  // SM's four register files hold 512 a lane, and each takes WGM + 1 of
  // the block's warps); after setmaxnreg, 40 for the producer, whose
  // release is the pool that the consumers' increase draws on
  static constexpr int REGS = 512 / (WGM + 1) / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int RISE = (REGS + (REGS - PRODUCER_REGS) / WGM) / 8 * 8;
  static constexpr int CONSUMER_REGS = RISE > 240 ? 240 : RISE;
  // a slab's rows and its columns (stride 2: half-columns of each of its
  // two planes, the even and the odd input columns)
  static constexpr int SH = S * (TH - 1) + 3, SW = S == 1 ? TW + 2 : TW + 1;
  static constexpr int PB = 2 * CK;       // a slab pixel's bytes = swizzle
  static constexpr int PLANE_TX = IB * SH * SW * PB;  // one plane's box
  static constexpr int PLANE = (PLANE_TX + 1023) / 1024 * 1024;
  static constexpr int PLANE_ROWS = PLANE / PB;  // its pixels, padded
  static constexpr int SLAB = S * PLANE, SLAB_TX = S * PLANE_TX;
  static constexpr int PANEL = TAPS * CK * 64;  // 32 columns x TAPS CK rows
  static constexpr int WBYTES = BN / 32 * PANEL;
  static constexpr int STAGE = SLAB + WBYTES;
  static constexpr int TX = SLAB_TX + WBYTES;  // bytes a stage's copies land
  // the ring, 1 KB to align it to the 1024-byte swizzle period, and the
  // full and empty barriers
  static constexpr int BYTES = STAGES * STAGE + 1024 + 16 * STAGES;
  static_assert(S == 1 || S == 2, "stride 1 or 2");
  static_assert(S == 1 || MODE == PLAIN, "P's prologue, U's phases: stride 1");
  static_assert(64 * WGM * MT == IB * TH * TW,
                "a block's pixels fill its 64-row wgmma tiles");
  static_assert(TW % 8 == 0, "8-pixel ldmatrix rows inside a tile row");
  static_assert(CK == 16 || CK == 32 || CK == 64, "a swizzle span");
  static_assert(BN % 32 == 0 && BN <= 256, "whole 32-column panels, N <= 256");
  static_assert(SW <= 256 && SH <= 256 && IB <= 256, "TMA box dimensions");
  static_assert(STAGES >= 2, "a ring");
  static_assert(NTC % (CK / 8) == 0, "a prologue thread keeps its unit");
  static_assert(WGM * CONSUMER_REGS + PRODUCER_REGS <= 512 &&
                    REGS - PRODUCER_REGS >= WGM * (CONSUMER_REGS - REGS),
                "the consumers' increase fits the producer's release");
  static_assert(BYTES <= 232448, "a block's shared memory");
};

// One block: IB images' TH x TW output tiles (U: source tiles, in one
// phase) by BN output channels, over the chunks of split blockIdx.z; WGM
// consumer warpgroups of MT 64-row tiles each, then the producer
// warpgroup. tmx is x (stride 2: its even columns, and tmx2 its odd ones).
template <int S, int MODE, int TH, int TW, int IB, int WGM, int MT, int BN,
          int CK, int STAGES>
__global__ void __launch_bounds__(128 * WGM + 128, 1)
    wg_conv_kernel(const __grid_constant__ CUtensorMap tmx,
                   const __grid_constant__ CUtensorMap tmx2,
                   const __grid_constant__ CUtensorMap tmw, const WgArgs a) {
  using C = WgCfg<S, MODE, TH, TW, IB, WGM, MT, BN, CK, STAGES>;
  constexpr bool PRO = MODE == PROLOGUE, UP = MODE == PHASES;
  constexpr int PB = C::PB, KS = CK / 16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // full: the stage's copies landed; empty: every consumer is done with it
  const uint32_t full = base + STAGES * C::STAGE, empty = full + 8 * STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // U: the phase (pa, pb) = (ph / 2, ph % 2), and tiles of the source grid
  const int ph = UP ? blockIdx.x % 4 : 0, pa = ph / 2, pb = ph % 2;
  const int bx = UP ? blockIdx.x / 4 : blockIdx.x;
  const int gh = UP ? a.H : a.Ho, gw = UP ? a.W : a.Wo;
  const int ntw = (gw + TW - 1) / TW, tiles = ntw * ((gh + TH - 1) / TH);
  const int t = bx % tiles, b0 = bx / tiles * IB;
  const int y0 = t / ntw * TH, x0 = t % ntw * TW, co0 = blockIdx.y * BN;
  // the slab's first input row and column (stride 2: half-column)
  const int sy0 = S * y0 - a.pt;
  const int sx0 = S == 1 ? x0 - a.pl : x0 - (a.pl + 1) / 2;
  const int nc = (a.Cin + CK - 1) / CK;  // chunks; this split's run:
  const int k0 = blockIdx.z * nc / a.splits;
  const int nmy = (blockIdx.z + 1) * nc / a.splits - k0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, C::NTC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WGM) {  // the producer: one thread issues every copy
    // the warpgroup gives its registers to the consumers; warps 1-3 leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        C::PRODUCER_REGS));
    if (warp == 4 * WGM && lane == 0) {
      for (int i = 0; i < nmy; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES + 1) & 1);
        const uint32_t bar = full + 8 * s, slab = base + s * C::STAGE;
        const int c0 = (k0 + i) * CK;
        mbar_expect_tx(bar, C::TX);
        tma_load_4d(slab, &tmx, bar, c0, sx0, sy0, b0);
        if constexpr (S == 2)
          tma_load_4d(slab + C::PLANE, &tmx2, bar, c0, sx0, sy0, b0);
#pragma unroll
        for (int p = 0; p < BN / 32; ++p)
          tma_load_3d(slab + C::SLAB + p * C::PANEL, &tmw, bar, co0 + 32 * p,
                      c0, C::TAPS * ph);
      }
    }
    return;
  }

  // the consumers: warp w of warpgroup g owns rows 16 w .. 16 w + 15 of
  // each of the group's MT 64-row tiles
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      C::CONSUMER_REGS));
  const int g = warp / 4, w = warp % 4;
  // this lane's ldmatrix row: its slab row at tap (0, 0), per tile
  int r0[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = (g * MT + mt) * 64 + 16 * w + lane % 8 + 8 * ((lane / 8) % 2);
    const int q = p % (TH * TW);
    r0[mt] = (p / (TH * TW) * C::SH + S * (q / TW)) * C::SW + q % TW;
  }
  const int half = lane / 16;  // the fragment's 8-channel half
  // tap (dy, dx)'s slab row from tap (0, 0)'s; stride 2: in plane
  // (dx + pl % 2) % 2 at half-column offset (dx + pl % 2) / 2; U: phase
  // (pa, pb)'s tap (r, c) at (pa + r, pb + c)
  const int podd = a.pl & 1;
  auto tap_row = [&](int tap) {
    if constexpr (UP) return (pa + tap / 2) * C::SW + pb + tap % 2;
    if constexpr (S == 1) return (tap / 3) * C::SW + tap % 3;
    const int u = tap % 3 + podd;
    return (tap / 3) * C::SW + (u >> 1) + (u & 1) * C::PLANE_ROWS;
  };

  // P: silu(x * a + s) in place on a landed slab, inside the image and
  // below Cin (the border and the channel padding stay 0). A consumer
  // thread keeps one logical 8-channel unit of the chunk (NTC % CK/8 == 0)
  // over every NTC / (CK / 8)-th slab row and reads a and s a channel pair
  // at a time; the slab by 32-bit shared addresses, so that little state
  // sits beside the accumulators.
  auto prologue = [&](uint32_t sl, int c0) {
    constexpr int CPP = CK / 8, ROWS = IB * C::SH * C::SW;
    const int u = tid % CPP, ci = c0 + 8 * u;
    if (ci >= a.Cin) return;
    // one piece, and one channel pair's a and s, live at a time
#pragma unroll 1
    for (int R = tid / CPP; R < ROWS; R += C::NTC / CPP) {
      const int ib = R / (C::SH * C::SW), rr = R % (C::SH * C::SW);
      const int gy = y0 - 1 + rr / C::SW, gx = x0 - 1 + rr % C::SW;
      if (b0 + ib >= a.B || gy < 0 || gy >= a.H || gx < 0 || gx >= a.W)
        continue;
      const long long off = (long long)(b0 + ib) * a.Cin + ci;
      const uint32_t q = sl + R * PB + 16 * swz_unit<PB>(R, u);
      uint32_t v[4];
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                   : "r"(q)
                   : "memory");
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 av = *reinterpret_cast<const float2*>(a.pa + off + 2 * k);
        const float2 sv = *reinterpret_cast<const float2*>(a.ps + off + 2 * k);
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&v[k]));
        v[k] = pack_bf16(silu_affine(f.x, av.x, sv.x),
                         silu_affine(f.y, av.y, sv.y));
        asm volatile("" ::: "memory");  // the next pair's loads stay here
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(q),
                   "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                   : "memory");
    }
  };

  float acc[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
  uint32_t frag[2][MT][4];  // A of this k step and of the one in flight

  for (int i = 0; i < nmy; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    const uint32_t slab = base + s * C::STAGE, wts = slab + C::SLAB;
    if constexpr (PRO) {
      prologue(slab, (k0 + i) * CK);
      // the generic writes come before the next TMA write of the stage,
      // and every consumer's before any ldmatrix of the slab
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_bar_sync(1, C::NTC);
    }
#pragma unroll
    for (int tap = 0; tap < C::TAPS; ++tap) {
      const int toff = tap_row(tap);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t(&af)[MT][4] = frag[(tap * KS + kk) & 1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int R = r0[mt] + toff;
          ldsm_x4_at(af[mt], slab + R * PB + 16 * swz_unit<PB>(R, 2 * kk + half));
        }
        wg_fence();
        // N-major, 64-byte rows: LBO the 32-column panel stride, SBO 8 K
        // rows of 64 bytes
        const uint64_t desc =
            smem_desc(wts + (tap * CK + 16 * kk) * 64, C::PANEL, 512, 64);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) WgMma<BN>::run(acc[mt], af[mt], desc);
        wg_commit();
        wg_wait<1>();  // the step before is done: its fragments are free
      }
    }
    wg_wait<0>();  // the stage's weights are read
    mbar_arrive(empty + 8 * s);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);

  // epilogue: acc[mt][4 j + 2 h + e] is row 16 w + lane / 4 + 8 h, column
  // 8 j + 2 (lane % 4) + e of tile mt
  const int grp = lane / 4, tq = lane % 4;
  const long long mtot = (long long)a.B * a.Ho * a.Wo;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (g * MT + mt) * 64 + 16 * w + grp + 8 * h;
      const int q = p % (TH * TW), b = b0 + p / (TH * TW);
      const int y = y0 + q / TW, x = x0 + q % TW;
      if (b >= a.B || y >= gh || x >= gw) continue;
      const long long pix = ((long long)b * a.Ho + (UP ? 2 * y + pa : y)) *
                                a.Wo +
                            (UP ? 2 * x + pb : x);
      if (a.splits == 1) {
        const float* bb = a.bias + b * a.bias_bstride;
        bf16* o = a.out + pix * a.Cout;
        const bf16* rp = a.res == nullptr ? nullptr : a.res + pix * a.Cout;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int co = co0 + 8 * j + 2 * tq;
          if (co >= a.Cout) continue;
          const float2 bz = *reinterpret_cast<const float2*>(bb + co);
          float v0 = acc[mt][4 * j + 2 * h] + bz.x;
          float v1 = acc[mt][4 * j + 2 * h + 1] + bz.y;
          if (rp != nullptr) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(rp + co));
            v0 += r.x;
            v1 += r.y;
          }
          *reinterpret_cast<uint32_t*>(o + co) = pack_bf16(v0, v1);
        }
      } else {
        float* o = a.ws + ((long long)blockIdx.z * mtot + pix) * a.Cout;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int co = co0 + 8 * j + 2 * tq;
          if (co >= a.Cout) continue;
          *reinterpret_cast<float2*>(o + co) =
              make_float2(acc[mt][4 * j + 2 * h], acc[mt][4 * j + 2 * h + 1]);
        }
      }
    }
}

// The split reduction: out = (sum over s in order of ws[s]) + bias
// (+ residual), four channels a thread; static, so that C's, D's and U's
// sources each keep their own copy, and named by the stride and mode of
// the kernel it completes, so that a trace tells C's, P's, D's and U's
// apart.
template <int S, int MODE>
static __global__ void __launch_bounds__(256)
    wg_splitk_reduce(const WgArgs a) {
  const long long mtot = (long long)a.B * a.Ho * a.Wo;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mtot * a.Cout / 4) return;
  const long long e = 4 * i, pix = e / a.Cout;
  const int co = static_cast<int>(e - pix * a.Cout);
  float4 v = *reinterpret_cast<const float4*>(a.ws + e);
  for (int s = 1; s < a.splits; ++s) {
    const float4 u =
        *reinterpret_cast<const float4*>(a.ws + s * mtot * a.Cout + e);
    v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
  }
  const float4 bz = *reinterpret_cast<const float4*>(
      a.bias + pix / ((long long)a.Ho * a.Wo) * a.bias_bstride + co);
  v.x += bz.x, v.y += bz.y, v.z += bz.z, v.w += bz.w;
  if (a.res != nullptr) {
    const uint2 r = *reinterpret_cast<const uint2*>(a.res + e);
    const float2 r0 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 r1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&r.y));
    v.x += r0.x, v.y += r0.y, v.z += r1.x, v.w += r1.y;
  }
  *reinterpret_cast<uint2*>(a.out + e) =
      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// ---- host side

// The tensor maps of one call: x as (Cin, W, H, B) in (CK, TW+2, TH+2, IB)
// boxes (stride 2: plane p of x's columns p, p + 2, ..., as (Cin,
// half-columns, H, B) in (CK, TW+1, 2TH+1, IB) boxes), swizzled over 2 CK
// bytes; w9 as (Cout, Cin, 9) in (32, CK, 9) boxes (U: w16 as (Cout, Cin,
// 16) in (32, CK, 4) boxes) swizzled over 64 bytes; out-of-range elements
// read as zero.
inline bool encode_x(const WgArgs& a, int s, int plane, int ck, int th,
                     int tw, int ib, CUtensorMap* m) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t e = sizeof(bf16);
  const int cols = s == 1 ? a.W : (a.W + 1 - plane) / 2;
  const cuuint64_t dim[4] = {(cuuint64_t)a.Cin, (cuuint64_t)cols,
                             (cuuint64_t)a.H, (cuuint64_t)a.B};
  const cuuint64_t str[3] = {e * a.Cin * s, e * a.Cin * a.W,
                             e * a.Cin * a.W * a.H};
  const cuuint32_t box[4] = {(cuuint32_t)ck,
                             (cuuint32_t)(s == 1 ? tw + 2 : tw + 1),
                             (cuuint32_t)(s * (th - 1) + 3), (cuuint32_t)ib};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<bf16*>(a.x + (long long)plane * a.Cin), dim, str, box,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(2 * ck),
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool encode_w(const WgArgs& a, int ck, int taps, int box_taps,
                     CUtensorMap* m) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t dim[3] = {(cuuint64_t)a.Cout, (cuuint64_t)a.Cin,
                             (cuuint64_t)taps};
  const cuuint64_t str[2] = {e * a.Cout, e * a.Cout * a.Cin};
  const cuuint32_t box[3] = {32, (cuuint32_t)ck, (cuuint32_t)box_taps};
  const cuuint32_t ones[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<bf16*>(a.w9), dim, str, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One call of an instantiation: the grid (ceil(B / IB) output tiles (U:
// source tiles, times the four phases), ceil(Cout / BN), splits), then the
// split reduction where splits > 1; returns the launches' cudaError_t
// (cudaErrorInvalidValue for operands it does not take: Cin or Cout not a
// multiple of 8, more splits than chunks, no workspace; at stride 2 a
// single input column; U's output other than (2H, 2W)).
template <int S, int MODE, int TH, int TW, int IB, int WGM, int MT, int BN,
          int CK, int STAGES>
cudaError_t wg_launch(const WgArgs& a, cudaStream_t stream) {
  using C = WgCfg<S, MODE, TH, TW, IB, WGM, MT, BN, CK, STAGES>;
  constexpr bool UP = MODE == PHASES;
  if (a.Cin % 8 != 0 || a.Cout % 8 != 0 || a.splits < 1 ||
      a.splits > (a.Cin + CK - 1) / CK || (a.splits > 1 && a.ws == nullptr) ||
      (S == 2 && a.W < 2) || (UP && (a.Ho != 2 * a.H || a.Wo != 2 * a.W)))
    return cudaErrorInvalidValue;
  CUtensorMap tmx, tmx2, tmw;  // tmx2: stride 2's odd plane
  if (!encode_x(a, S, 0, CK, TH, TW, IB, &tmx) ||
      !encode_w(a, CK, UP ? 16 : 9, C::TAPS, &tmw) ||
      (S == 2 && !encode_x(a, S, 1, CK, TH, TW, IB, &tmx2)))
    return cudaErrorInvalidValue;
  constexpr auto kern =
      wg_conv_kernel<S, MODE, TH, TW, IB, WGM, MT, BN, CK, STAGES>;
  cudaError_t err = smem_limit_once<kern>(C::BYTES);
  if (err != cudaSuccess) return err;
  const int gh = UP ? a.H : a.Ho, gw = UP ? a.W : a.Wo;
  const int tiles = ((gw + TW - 1) / TW) * ((gh + TH - 1) / TH);
  dim3 grid(tiles * ((a.B + IB - 1) / IB) * (UP ? 4 : 1),
            (a.Cout + BN - 1) / BN, a.splits);
  kern<<<grid, C::NT, C::BYTES, stream>>>(tmx, S == 2 ? tmx2 : tmx, tmw, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long n4 = (long long)a.B * a.Ho * a.Wo * a.Cout / 4;
  wg_splitk_reduce<S, MODE>
      <<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace sg_conv
