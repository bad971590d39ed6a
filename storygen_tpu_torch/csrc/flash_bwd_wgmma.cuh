// Kernels DQ and DKV (flash_bwd.cu) on Hopper's own instructions (sm_90a).
// With P = exp(scale q.k - lse) and dS = P * (dO V^T - delta):
//
//   DQ   dQ = scale * dS K, one block per 64 WGM Q rows of one head, over
//        the K/V tiles; replaces _dq_kernel of storygen_tpu/ops/
//        pallas_attention.py (:558, its pallas_call :685);
//   DKV  dV = P^T dO and dK = scale * dS^T Q, one block per 64 WGM K/V
//        rows, over the Q tiles, in the transposed form the TPU kernel uses
//        (s_t); replaces _dkv_kernel (:593, pallas_call :698).
//
// One template serves both (DKV a flag): a block's own rows X, Y (DQ: Q
// and dO; DKV: K and V) and a streamed side A, B (DQ: K and V; DKV: Q and
// dO). lse comes from kernel L, delta = rowsum(dO * O) from the caller.
// Each block owns its output rows and loops over the other side: no
// atomics, the same sums in the same order at every call.
//
// What bounds it on the H100 at the UNet's head dims (40 padded to 48, 80,
// 160): one exp per kept logit at 16 ex2 a clock per SM (3.87e12 a second)
// and 3 (DQ) or 4 (DKV) products of 2 d operations per kept logit at 989
// TFLOP/s. At d 40 the two are close (attn1 L1 B4: DQ 0.139 ms of exps
// against 0.130 of products, DKV 0.139 against 0.174), so the products
// have to run while the exps do.
//
// What the design does (flash_wgmma.cuh's, for the gradients):
// - Every product is wgmma.mma_async, bf16 in, fp32 accumulators in
//   registers. The logits S = X A^T and dP = Y B^T (DQ: Q K^T, dO V^T; DKV:
//   K Q^T, V dO^T) take both operands from shared memory, K-major
//   (m64nBNk16, DP / 16 k steps). The gradients take A from registers:
//   S's accumulator layout rounded to bf16 pairs is the register-A
//   fragment, so dS (DQ) and P^T, dS^T (DKV) never leave the registers.
//   B is the streamed tile read N-major (transpose bit), N = DP: dQ += dS K;
//   dV += P^T dO, dK += dS^T Q. The transposed form keeps both DKV
//   products free of a round trip through shared memory.
// - Warp specialisation: a producer warpgroup (one thread issues every TMA
//   copy; with two consumer warpgroups it hands its registers to them by
//   setmaxnreg) and WGM consumer warpgroups, each owning 64 of the block's
//   rows. X and Y land once per block; A and B arrive through a ring of
//   STAGES stages, each operand with its own full and empty mbarriers
//   (DQ's V stage is free once dP is done, its K stage only after dS K).
//   A streamed tile stays in use from its logits to its gradients one
//   iteration later, so the ring needs a stage more than F's to keep a
//   copy in flight: the built lines take 4 at d 48 / 80 (2 ran 2x slower).
// - Registers: a consumer thread holds its gradients' accumulators (DQ:
//   DP / 2 floats; DKV: DP), the logits' and dP's (BN / 2 each) and the
//   fragments. At d 160 DKV's dK and dV alone take 160, so that line has
//   one consumer warpgroup (255 registers a thread, no setmaxnreg) and
//   16-row Q tiles; 32-row tiles spilled.
// - Inside a consumer warpgroup, tile j's two logit products are issued
//   together with tile j-1's gradient products; the group waits for the
//   logits only, computes P and dS in their accumulators, then waits for
//   the gradients and rounds tile j's fragments. With PP, named barriers
//   order the two groups' issues (ping-pong), as in F.
// - The same streamed tile is read K-major (logits) and N-major
//   (gradients). An N-major operand has no canonical layout for a partial
//   swizzle panel, so A and B land in panels of SPW = 16 (d 48, 80) or 32
//   (d 160) columns that divide N = DP, and the K-major k steps are
//   addressed inside them (one k step a 16-column panel, two a 32-column
//   one). X and Y are read K-major only and land in panels of APW columns.
//   Each bf16 operand is seen as a 4-D tensor (D, H, S, B) with its own
//   strides (flash_wgmma.cuh's encode_operand): columns past D (d 40 runs
//   as 48) and rows past S read as zeros; a k|v split view is read in
//   place.
// - DKV's lse and delta are per column (Q row). Each Q tile's BN values of
//   each land beside the tile: by a 2-D TMA copy of the (B H, Sq) fp32 rows
//   where Sq * 4 bytes is a multiple of 16 (and the rows 16-byte aligned),
//   else by the producer thread's plain loads; entries past Sq are 0.
// - Edges and masking, in registers: DQ's columns past Skv and DKV's Q rows
//   past Sq get P = 0 (whatever the zero-filled operands would give). With
//   `keep` (B, nref) over nref equal spans, DQ walks only the K/V tiles that
//   hold a kept row (producer and consumers compute the same walk), and a
//   DKV block whose rows all lie in dropped spans writes zeros without
//   loading anything. A tile or block across a span boundary (spans that
//   BN, DQ, or BM, DKV, does not divide: STRADDLE) masks column by column
//   (DQ) or row by row (DKV). A row that keeps no span gets exact zeros.
//   The exp is ex2.approx of fmaf(s, scale log2(e), -lse log2(e)). Rows
//   past Sq or Skv are not written; columns below D are, as bf16 pairs.
#pragma once
#include <math.h>

#include "flash_wgmma.cuh"

namespace sg_flash {

struct BwArgs {
  const float *lse, *delta;  // (B, H, Sq) fp32
  bf16 *out0, *out1;         // DQ: dQ; DKV: dK, dV; (B, S, H*D)
  const int* keep;           // (B, nref) int32, or null
  int H, Sq, Skv, D;
  int nref, span;  // masked: nref spans of `span` kv rows; else 1, 1
  float scale, scale_log2;
  int scalars_by_tma;  // DKV: lse and delta tiles by TMA, else plain loads
};

// A block of WGM consumer warpgroups (64 own rows each) and a producer
// warpgroup; streamed tiles of BN rows in a ring of STAGES stages; the own
// operands in panels of APW columns, the streamed ones of SPW.
template <bool DKV, int DP, int WGM, int BN, int STAGES, int APW>
struct BwCfg {
  static constexpr int BM = 64 * WGM;
  static constexpr int NTC = 128 * WGM;  // consumer threads
  static constexpr int NT = NTC + 128;   // and the producer warpgroup
  // two consumer warpgroups: 168 registers a thread at launch, then 40 for
  // the producer and 232 for the consumers (flash_wgmma.cuh's pool); one:
  // 255 a thread, no setmaxnreg
  static constexpr int REGS = 512 / (WGM + 1) / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int RISE = (REGS + (REGS - PRODUCER_REGS) / WGM) / 8 * 8;
  static constexpr int CONSUMER_REGS = RISE > 240 ? 240 : RISE;
  static constexpr int ARB = 2 * APW;  // an own panel's row bytes
  static constexpr int APANELS = (DP + APW - 1) / APW;
  static constexpr int SPW = DP % 32 == 0 ? 32 : 16;  // a streamed panel's
  static constexpr int SRB = 2 * SPW;                 // columns, row bytes
  static constexpr int SPANELS = DP / SPW;
  static constexpr int APANEL = BM * ARB, SPANEL = BN * SRB;
  static constexpr int OWN = APANELS * APANEL;   // X or Y
  static constexpr int TILE = SPANELS * SPANEL;  // A or B of one stage
  static constexpr int STAGE = 2 * TILE;
  static constexpr int SROW = (BN * 4 + 127) / 128 * 128;  // lse or delta
  static constexpr int SCALARS = DKV ? STAGES * 2 * SROW : 0;
  // the own operands' barrier, then full A, full B, empty A, empty B per
  // stage
  static constexpr int BARS = 8 * (1 + 4 * STAGES);
  // 1 KB to align the buffers to the swizzles' 1024-byte period
  static constexpr int BYTES = 1024 + 2 * OWN + STAGES * STAGE + SCALARS +
                               BARS;
  static_assert(DP == 48 || DP == 80 || DP == 160, "the UNet's head dims");
  static_assert(APW == 16 || APW == 32 || APW == 64, "a swizzle span");
  static_assert(BN == 16 || BN == 32 || BN == 64 || BN == 128,
                "the logits' N");
  static_assert(WGM == 1 || WGM == 2, "one or two consumer warpgroups");
  static_assert(APANEL % 1024 == 0 && SPANEL % 1024 == 0,
                "every panel on a swizzle period");
  static_assert(STAGES >= 2, "a ring");
  static_assert(WGM == 1 || (WGM * CONSUMER_REGS + PRODUCER_REGS <= 512 &&
                             REGS - PRODUCER_REGS >=
                                 WGM * (CONSUMER_REGS - REGS)),
                "the consumers' increase fits the producer's release");
  static_assert(BYTES <= 232448, "a block's shared memory");
};

__device__ __forceinline__ void st_shared_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// grid (ceil(own rows / BM), H, B); own rows Sq (DQ) or Skv (DKV)
template <bool DKV, int DP, int WGM, int BN, int STAGES, int APW, bool PP,
          bool MASKED, bool STRADDLE>
__global__ void __launch_bounds__(128 * WGM + 128, 1)
    flash_bwd_wg_kernel(const __grid_constant__ CUtensorMap tmx,
                        const __grid_constant__ CUtensorMap tmy,
                        const __grid_constant__ CUtensorMap tmstream_a,
                        const __grid_constant__ CUtensorMap tmstream_b,
                        const __grid_constant__ CUtensorMap tml,
                        const __grid_constant__ CUtensorMap tmd,
                        const BwArgs a) {
  using C = BwCfg<DKV, DP, WGM, BN, STAGES, APW>;
  static_assert(!PP || WGM == 2, "ping-pong between two warpgroups");
  constexpr int NS = BN / 8;        // 8-column accumulator tiles of S
  constexpr int KSTEPS = DP / 16;   // the logits' k steps
  constexpr int APS = APW / 16;     // k steps an own panel holds
  constexpr int SPS = C::SPW / 16;  // and a streamed panel
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // X panels, then Y's
  const uint32_t ring = base + 2 * C::OWN;  // stage s: A panels, B panels
  const uint32_t scal = ring + STAGES * C::STAGE;  // DKV: lse, delta rows
  const uint32_t obar = scal + C::SCALARS;
  auto full_a = [&](int s) { return obar + 8 * (1 + s); };
  auto full_b = [&](int s) { return obar + 8 * (1 + STAGES + s); };
  auto empty_a = [&](int s) { return obar + 8 * (1 + 2 * STAGES + s); };
  auto empty_b = [&](int s) { return obar + 8 * (1 + 3 * STAGES + s); };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z, m0 = blockIdx.x * C::BM;
  const int ntiles = ((DKV ? a.Sq : a.Skv) + BN - 1) / BN;
  const int* kp = MASKED ? a.keep + b * a.nref : a.keep;
  const int tps = MASKED && !STRADDLE ? a.span / BN : 1;  // DQ tiles a span
  // DQ: the spans of K/V tile t's first and last row
  auto first_span = [&](int t) { return t * BN / a.span; };
  auto last_span = [&](int t) {
    return (min(t * BN + BN, a.Skv) - 1) / a.span;
  };
  // DQ: does tile t hold a kept kv row (block-uniform)
  auto kept = [&](int t) {
    if constexpr (!STRADDLE) return kp[t / tps] != 0;
    for (int r = first_span(t); r <= last_span(t); ++r)
      if (kp[r]) return true;
    return false;
  };
  // the first tile at or after t to walk: DQ's next kept one, DKV's next
  auto next_kept = [&](int t) {
    if (!DKV && MASKED)
      while (t < ntiles && !kept(t)) ++t;
    return t;
  };
  // DKV: the spans of the block's first and last kv row; does one of its
  // rows lie in a kept span (block-uniform)
  const int span0 = DKV && MASKED ? m0 / a.span : 0;
  const int span1 =
      DKV && MASKED ? (min(m0 + C::BM, a.Skv) - 1) / a.span : 0;
  bool live = true;
  if (DKV && MASKED) {
    live = false;
    for (int r = span0; r <= span1; ++r) live |= kp[r] != 0;
  }

  if (tid == 0) {
    mbar_init(obar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_a(s), 1);
      mbar_init(full_b(s), 1);
      mbar_init(empty_a(s), C::NTC);
      mbar_init(empty_b(s), C::NTC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WGM) {  // the producer: one thread issues every copy
    if constexpr (WGM > 1) setmaxnreg_dec<C::PRODUCER_REGS>();
    if (live && warp == 4 * WGM && lane == 0) {
      mbar_expect_tx(obar, 2 * C::OWN);
#pragma unroll
      for (int p = 0; p < C::APANELS; ++p) {
        tma_load_4d(base + p * C::APANEL, &tmx, obar, p * APW, h, m0, b);
        tma_load_4d(base + C::OWN + p * C::APANEL, &tmy, obar, p * APW, h,
                    m0, b);
      }
      int i = 0;
      for (int t = next_kept(0); t < ntiles; t = next_kept(t + 1), ++i) {
        const int s = i % STAGES;
        const uint32_t par = (i / STAGES + 1) & 1;  // the stage's last use
        const uint32_t as = ring + s * C::STAGE, bs = as + C::TILE;
        if (i >= STAGES) mbar_wait(empty_a(s), par);
        if constexpr (DKV) {
          const uint32_t sl = scal + s * 2 * C::SROW, sd = sl + C::SROW;
          if (a.scalars_by_tma) {
            mbar_expect_tx(full_a(s), C::TILE + 2 * BN * 4);
            tma_load_2d(sl, &tml, full_a(s), t * BN, b * a.H + h);
            tma_load_2d(sd, &tmd, full_a(s), t * BN, b * a.H + h);
          } else {
            // stored before the arrival that completes the stage's phase
            const long long rb = ((long long)b * a.H + h) * a.Sq;
#pragma unroll 4
            for (int r = 0; r < BN; ++r) {
              const int row = t * BN + r;
              const bool in = row < a.Sq;
              st_shared_f32(sl + 4 * r, in ? a.lse[rb + row] : 0.f);
              st_shared_f32(sd + 4 * r, in ? a.delta[rb + row] : 0.f);
            }
            mbar_expect_tx(full_a(s), C::TILE);
          }
        } else {
          mbar_expect_tx(full_a(s), C::TILE);
        }
#pragma unroll
        for (int p = 0; p < C::SPANELS; ++p)
          tma_load_4d(as + p * C::SPANEL, &tmstream_a, full_a(s),
                      p * C::SPW, h, t * BN, b);
        if (i >= STAGES) mbar_wait(empty_b(s), par);
        mbar_expect_tx(full_b(s), C::TILE);
#pragma unroll
        for (int p = 0; p < C::SPANELS; ++p)
          tma_load_4d(bs + p * C::SPANEL, &tmstream_b, full_b(s),
                      p * C::SPW, h, t * BN, b);
      }
    }
    return;
  }

  // the consumers: warp w of warpgroup g owns rows 64 g + 16 w .. + 15 of
  // the block; acc[4 j + 2 r + e] of an accumulator is row 16 w + lane / 4
  // + 8 r, column 8 j + 2 (lane % 4) + e
  if constexpr (WGM > 1) setmaxnreg_inc<C::CONSUMER_REGS>();
  const int g = warp / 4, w = warp % 4, grp = lane / 4, tq = lane % 4;
  const int row0 = m0 + 64 * g + 16 * w + grp;  // this lane's rows, and + 8
  float acc0[DP / 2];                // DQ: dQ / scale; DKV: dK / scale
  float acc1[DKV ? DP / 2 : 1];      // DKV: dV
  float s[BN / 2], dp[BN / 2];       // the logits and dP (DKV: transposed)
  uint32_t f0[BN / 16][4];           // dS's A fragments (DKV: dS^T's)
  uint32_t f1[DKV ? BN / 16 : 1][4];  // DKV: P^T's
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DKV ? DP / 2 : 1); ++i) acc1[i] = 0.f;
  // DQ: lse (log2 units) and delta of this lane's two Q rows; rows past Sq
  // are never written
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  // DKV across a span boundary: are this lane's two kv rows dropped
  bool drop[2] = {false, false};
  if constexpr (!DKV) {
    const long long rb = ((long long)b * a.H + h) * a.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < a.Sq) {
        lse2[r] = a.lse[rb + row] * LOG2E;
        dlt[r] = a.delta[rb + row];
      }
    }
  } else if (STRADDLE && span0 != span1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      drop[r] = row < a.Skv && !kp[row / a.span];
    }
  }
  const uint32_t xrows = base + 64 * g * C::ARB;  // this group's X rows
  const uint32_t yrows = xrows + C::OWN;          // and Y rows
  // S = X A^T and dP = Y B^T against stage si: X's k step j lies in panel
  // j / APS at byte 32 (j % APS) of each row, A's in panel j / SPS
  auto logits = [&](int si) {
    const uint32_t as = ring + si * C::STAGE, bs = as + C::TILE;
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j)
      WgMmaSS<BN>::run(
          s,
          smem_desc(xrows + (j / APS) * C::APANEL + 32 * (j % APS), 0,
                    8 * C::ARB, C::ARB),
          smem_desc(as + (j / SPS) * C::SPANEL + 32 * (j % SPS), 0,
                    8 * C::SRB, C::SRB),
          j > 0);
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j)
      WgMmaSS<BN>::run(
          dp,
          smem_desc(yrows + (j / APS) * C::APANEL + 32 * (j % APS), 0,
                    8 * C::ARB, C::ARB),
          smem_desc(bs + (j / SPS) * C::SPANEL + 32 * (j % SPS), 0,
                    8 * C::SRB, C::SRB),
          j > 0);
  };
  // the gradients against stage si, N-major: k step kk is the streamed
  // rows 16 kk .. in every panel (LBO the panel stride). DQ: dQ += dS K;
  // DKV: dV += P^T dO, dK += dS^T Q
  auto grad = [&](int si) {
    const uint32_t as = ring + si * C::STAGE, bs = as + C::TILE;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      if constexpr (DKV)
        WgMma<DP>::run(acc1, f1[kk],
                       smem_desc(bs + 16 * kk * C::SRB, C::SPANEL,
                                 8 * C::SRB, C::SRB));
      WgMma<DP>::run(acc0, f0[kk],
                     smem_desc(as + 16 * kk * C::SRB, C::SPANEL, 8 * C::SRB,
                               C::SRB));
    }
  };
  // P and dS of tile t (stage si) in place: s <- P (DKV: P^T), dp <- dS
  // (DKV: dS^T)
  auto compute = [&](int t, int si) {
    if constexpr (!DKV) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        s[i] = fast_exp2(fmaf(s[i], a.scale_log2, -lse2[i % 4 / 2]));
      const int kvalid = a.Skv - t * BN;
      if (kvalid < BN) {  // the ragged last tile: columns past Skv
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          if (8 * (i / 4) + 2 * tq + i % 2 >= kvalid) s[i] = 0.f;
      }
      if (STRADDLE && first_span(t) != last_span(t)) {
        // a tile across a span boundary: its columns in dropped spans
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int col = t * BN + 8 * (i / 4) + 2 * tq + i % 2;
          if (col < a.Skv && !kp[col / a.span]) s[i] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        dp[i] = s[i] * (dp[i] - dlt[i % 4 / 2]);
    } else {
      const float* rows = reinterpret_cast<const float*>(
          smem_raw + (scal - raw) + si * 2 * C::SROW);
      const int qvalid = a.Sq - t * BN;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        // this lane's two columns (Q rows) 8 j + 2 tq and + 1
        const float2 l = *reinterpret_cast<const float2*>(rows + 8 * j +
                                                          2 * tq);
        const float2 dl = *reinterpret_cast<const float2*>(
            rows + C::SROW / 4 + 8 * j + 2 * tq);
        const float nl[2] = {-l.x * LOG2E, -l.y * LOG2E};
        const float dd[2] = {dl.x, dl.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(s[4 * j + e], a.scale_log2, nl[e % 2]));
          // Q rows past Sq; kv rows in dropped spans
          if ((qvalid < BN && 8 * j + 2 * tq + e % 2 >= qvalid) ||
              (STRADDLE && drop[e / 2]))
            p = 0.f;
          s[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - dd[e % 2]);
        }
      }
    }
  };
  // round tile j's operands to bf16 A fragments, one per 16 streamed rows
  auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        f0[kk][f] = pack_bf16(dp[8 * kk + 2 * f], dp[8 * kk + 2 * f + 1]);
        if constexpr (DKV)
          f1[kk][f] = pack_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1]);
      }
  };
  auto fence_acc = [&] {
    fence_regs(acc0);
    if constexpr (DKV) fence_regs(acc1);
  };

  if (live) {
    mbar_wait(obar, 0);  // also where no tile is walked: the copy landed
    int cur = next_kept(0);
    if (cur < ntiles) {
      if (PP && g == 1) named_bar_arrive(1, C::NTC);  // group 0 issues first
      mbar_wait(full_a(0), 0);
      mbar_wait(full_b(0), 0);
      wg_fence();
      logits(0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (!DKV) mbar_arrive(empty_b(0));  // DQ: V_0 is done
      compute(cur, 0);
      pack();
      int i = 1;  // tiles walked
      for (cur = next_kept(cur + 1); cur < ntiles;
           cur = next_kept(cur + 1), ++i) {
        const int si = i % STAGES, pi = (i - 1) % STAGES;
        mbar_wait(full_a(si), (i / STAGES) & 1);
        mbar_wait(full_b(si), (i / STAGES) & 1);
        if (PP) named_bar_sync(1 + g, C::NTC);
        wg_fence();
        logits(si);
        wg_commit();
        grad(pi);
        wg_commit();
        if (PP) named_bar_arrive(2 - g, C::NTC);  // the other group's turn
        wg_wait<1>();  // the logits; tile i-1's gradients may still run
        fence_regs(s);
        fence_regs(dp);
        if (!DKV) mbar_arrive(empty_b(si));
        compute(cur, si);
        wg_wait<0>();
        fence_acc();
        mbar_arrive(empty_a(pi));
        if (DKV) mbar_arrive(empty_b(pi));
        pack();
      }
      wg_fence();
      grad((i - 1) % STAGES);
      wg_commit();
      wg_wait<0>();
      fence_acc();
      // group 1's last turn signal (or its first, where one tile was walked)
      if (PP && g == 0) named_bar_sync(1, C::NTC);
    }
  }

  // the gradients into (B, S, H*D) as bf16 pairs (a dead DKV block: zeros)
  const long long ors = (long long)a.H * a.D;
  const int rows = DKV ? a.Skv : a.Sq;
  auto store = [&](bf16* out, const float(&acc)[DP / 2], float mul) {
    bf16* ob = out + (long long)b * rows * ors + (long long)h * a.D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < rows) {
        bf16* orow = ob + row * ors;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int c = 8 * j + 2 * tq;
          if (c < a.D)
            *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(
                acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
        }
      }
    }
  };
  store(a.out0, acc0, a.scale);
  if constexpr (DKV) store(a.out1, acc1, 1.f);
}

// ---- host side

// The tensor map of a (B H, Sq) fp32 row of scalars (lse or delta) in
// boxes of `rows` entries, unswizzled; entries past Sq read as zero. TMA
// needs the row stride (4 Sq bytes) and the start on 16 bytes.
inline bool encode_scalars(CUtensorMap* m, const float* x, int BH, int Sq,
                           int rows) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dim[2] = {(cuuint64_t)Sq, (cuuint64_t)BH};
  const cuuint64_t str[1] = {sizeof(float) * (cuuint64_t)Sq};
  const cuuint32_t box[2] = {(cuuint32_t)rows, 1};
  const cuuint32_t ones[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x),
             dim, str, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Where DKV reads lse and delta by TMA (encode_scalars' rule); elsewhere
// the producer thread loads them
inline bool scalars_by_tma(const float* lse, const float* delta, int Sq) {
  return Sq % 4 == 0 && reinterpret_cast<uintptr_t>(lse) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(delta) % 16 == 0;
}

// One launch: q, dout (B, Sq, H*D), k and v (B, Skv, H*D) with their
// batch and row strides in elements (dout contiguous); four operand maps
// (DKV: six, with lse and delta's) are encoded per call.
template <bool DKV, int DP, int WGM, int BN, int STAGES, int APW, bool PP,
          bool MASKED, bool STRADDLE>
cudaError_t flash_bwd_wg_launch(const bf16* q, const bf16* k, const bf16* v,
                                const bf16* dout, BwArgs a, int B,
                                long long qb, long long qr, long long kb,
                                long long kr, long long vb, long long vr,
                                cudaStream_t stream) {
  using C = BwCfg<DKV, DP, WGM, BN, STAGES, APW>;
  const long long ors = (long long)a.H * a.D;  // dout's row stride
  CUtensorMap tx, ty, ta, tb, tl = {}, td = {};
  bool ok;
  if constexpr (DKV) {
    ok = encode_operand(&tx, k, B, a.H, a.Skv, a.D, kb, kr, APW, C::BM) &&
         encode_operand(&ty, v, B, a.H, a.Skv, a.D, vb, vr, APW, C::BM) &&
         encode_operand(&ta, q, B, a.H, a.Sq, a.D, qb, qr, C::SPW, BN) &&
         encode_operand(&tb, dout, B, a.H, a.Sq, a.D, a.Sq * ors, ors,
                        C::SPW, BN);
    a.scalars_by_tma = scalars_by_tma(a.lse, a.delta, a.Sq);
    if (ok && a.scalars_by_tma)
      ok = encode_scalars(&tl, a.lse, B * a.H, a.Sq, BN) &&
           encode_scalars(&td, a.delta, B * a.H, a.Sq, BN);
  } else {
    ok = encode_operand(&tx, q, B, a.H, a.Sq, a.D, qb, qr, APW, C::BM) &&
         encode_operand(&ty, dout, B, a.H, a.Sq, a.D, a.Sq * ors, ors, APW,
                        C::BM) &&
         encode_operand(&ta, k, B, a.H, a.Skv, a.D, kb, kr, C::SPW, BN) &&
         encode_operand(&tb, v, B, a.H, a.Skv, a.D, vb, vr, C::SPW, BN);
    a.scalars_by_tma = 0;
  }
  if (!ok) return cudaErrorInvalidValue;
  constexpr auto kern = flash_bwd_wg_kernel<DKV, DP, WGM, BN, STAGES, APW,
                                            PP, MASKED, STRADDLE>;
  cudaError_t err = smem_limit_once<kern>(C::BYTES);
  if (err != cudaSuccess) return err;
  const int rows = DKV ? a.Skv : a.Sq;
  dim3 grid((rows + C::BM - 1) / C::BM, a.H, B);
  kern<<<grid, C::NT, C::BYTES, stream>>>(tx, ty, ta, tb, tl, td, a);
  return cudaGetLastError();
}

}  // namespace sg_flash
