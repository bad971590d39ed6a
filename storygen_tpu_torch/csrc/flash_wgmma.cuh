// Kernels F and M (flash_fwd.cu) on Hopper's own instructions (sm_90a):
// O = softmax(Q K^T * scale) V per head, over every kv row (F) or over the
// kept reference spans only (M); kernel L (below); and the template that
// the attention studies' kernels S1 (study_online.cu), S2
// (study_wgmma.cuh), S3 (study_qk.cu) and S4 (study_int8.cu) share with
// F: the ring and its producer (FwRing), the walk (KvWalk, DenseWalk) and
// the consumers' loop (fw_consume, fw_consume_ahead, fw_block), whose
// softmax step is a policy (FwSoftmax is F's); int8 Q and K (S3, S4) take
// the s8 wgmma into int32 accumulators (FwCfg's EB).
//
// Replaces, with flash_fwd.cu's dispatch, the forward variants of
// storygen_tpu/ops/pallas_attention.py reached through _flash_core:
// _bnd_kernel :83, _bnd2_kernel :124, _online_t_kernel :163 and
// _flash_kernel :208 (F), and their masked forms _bnd_masked_kernel :118,
// _bnd2_masked_kernel :157, _online_t_masked_kernel :202 and
// _masked_kernel :251 (M).
//
// What bounds it on the H100, by head dim (the UNet's 40, 80 and 160; the
// logits never reach HBM, so bytes do not):
// - d = 40: the exponentials. The special-function units compute 16 ex2 a
//   clock per SM, 3.87e12 a second at the 1.83 GHz that the data sheet's
//   989 TFLOP/s implies, against 4 d = 160 tensor-core operations per
//   logit (192 with the head padded to 48): one exp costs 1.6x a logit's
//   products (attn1 L1 B6: 0.208 ms of exps against 0.130 ms of products).
// - d = 80: the two are even (attn3 L2: 0.020 ms of exps, 0.024 of work).
// - d = 160: tensor-core work.
// So the products have to run while the exps do, and at d = 40 the exps
// have to be issued without a gap.
//
// What the design does:
// - Products by wgmma.mma_async, bf16 in, fp32 accumulators in registers.
//   S = Q K^T is m64nBKk16 with both operands in shared memory (K-major:
//   the head dim is contiguous in Q and K), 3 / 5 / 10 k steps at d = 48
//   / 80 / 160. O += P V is m64nDPk16 with A = P in registers (S's
//   accumulators rounded to bf16 pairs are exactly the register-A
//   fragments) and B = V from shared memory, N-major (transpose bit).
// - Warp specialisation: a producer warpgroup (one thread issues every TMA
//   copy; the warpgroup hands its registers to the consumers by
//   setmaxnreg) and WGM consumer warpgroups, each owning 64 query rows of
//   the block's 64 WGM.
// - Inside a consumer warpgroup, tile j's softmax overlaps tile j-1's P V:
//   S_j = Q K_j^T and O += P_{j-1} V_{j-1} are issued together, the group
//   waits for S_j only, computes the row max, the exps and the row sums,
//   then waits for P V, rescales O and rounds P_j. Across the two
//   warpgroups (PP), named barriers order the issues so that one group's
//   products run while the other's exps do (ping-pong).
// - Copies by TMA into a ring of STAGES stages, K and V each with their
//   own full and empty mbarriers, so a K stage is refilled as soon as its
//   Q K^T is done. Q is loaded once. Each operand is seen as a 4-D tensor
//   (D, H, S, B) with strides (1, D, row stride, batch stride): a box of
//   (width, 1, rows, 1) is one head's tile of one batch row. Columns past
//   D and rows past S are out of range and TMA writes zeros, which pads
//   d = 40 to 48 in shared memory only, and never reads the next head's
//   or the next batch row's elements. Q and K land in panels of KPW
//   columns (rows of 2 KPW bytes, swizzled over their span), V in panels
//   of 16 (d 48, 80, 176) or 32 (d 96, 160) columns, which divide its N.
//   (The studies' (BH, S, W) operands are the same map with H = 1; an
//   int8 one gives its row stride as the head stride, every stride being
//   a multiple of 16 bytes.)
// - Masking as the mma.sync template does it: the ragged last tile sets
//   the logits past Skv to -inf in the S registers; M walks only the tiles
//   that hold a kept row (producer and consumers compute the same walk
//   from `keep`), and a tile across a span boundary (spans that BK does
//   not divide: STRADDLE) masks column by column. The accumulator layout
//   per warp is mma.sync's m16n8, so the column of a register is 8 j + 2
//   (lane % 4) + e. A row whose running max is still -inf takes alpha =
//   0, and a row that kept no span writes zeros.
// - The exp is ex2.approx of fmaf(s, scale log2(e), -m), m kept in the
//   scaled log2 domain; the epilogue writes O / l as bf16 pairs into
//   (B, Sq, H*D), columns below D and rows below Sq only.
#pragma once
#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace sg_flash {

using namespace sg_hopper;

struct FwArgs {
  bf16* out;         // F, M, S1, S2: (B, Sq, H*D)
  float* lse;        // L: (B, H, Sq)
  const int* keep;   // M, masked L: (B, nref) int32; else null
  int H, Sq, Skv, D;
  int nref, span;    // M: nref spans of `span` kv rows; F: 1, 1
  float scale_log2;  // scale * log2(e), > 0
  // the studies' (S1, S2, S4): S2 BND2's and S4's row bounds (B, Sq) fp32,
  // S4's q row scales (B, Sq) fp32, S1 MODE 0's scale, S2's and S4's guard
  // on the row sum
  const float* bound;
  const float* qscale;
  float scale, guard;
};

// A block of WGM consumer warpgroups and a producer warpgroup; K/V tiles
// (L and the studies' ablations: K tiles, V = false) of BK rows in a ring
// of STAGES stages; Q and K in panels of KPW columns. Each consumer
// warpgroup owns 64 query rows of the block's 64 WGM, or, with SPLIT = 2,
// both warpgroups own the same 64 rows and each takes half of every
// tile's kv rows (the max-free study's heads walked in turn). QSLOTS Q
// buffers: a block that walks several heads lands the next head's Q while
// the current one runs. EB: bytes of a Q / K element, 2 (bf16, fp32
// logits) or 1 (int8, int32 logits: the int8 studies S3 and S4, one
// 64-byte panel, two k32 steps); an int8 walk with P V (S4) also lands
// each tile's BK fp32 kv scales at the end of its stage (SK).
template <int DP_, int WGM, int BK_, int STAGES_, int KPW, bool V_ = true,
          int SPLIT = 1, int QSLOTS_ = 1, int EB_ = 2>
struct FwCfg {
  static constexpr int DP = DP_, BK = BK_, STAGES = STAGES_;
  static constexpr bool V = V_;
  static constexpr int QSLOTS = QSLOTS_;
  static constexpr int EB = EB_;
  static constexpr bool SK = EB == 1 && V;
  // the S accumulators' type
  using SAcc = typename std::conditional<EB == 1, int, float>::type;
  static constexpr int BQ = 64 * WGM / SPLIT;
  static constexpr int NTC = 128 * WGM;  // consumer threads
  static constexpr int NT = NTC + 128;   // and the producer warpgroup
  // registers a thread at launch, and after setmaxnreg (conv_wgmma.cuh's
  // pool: the producer's release is what the consumers' rise draws on);
  // one consumer warpgroup keeps the launch's 255 and takes no setmaxnreg
  static constexpr int REGS = 512 / (WGM + 1) / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int RISE = (REGS + (REGS - PRODUCER_REGS) / WGM) / 8 * 8;
  static constexpr int CONSUMER_REGS = RISE > 240 ? 240 : RISE;
  static constexpr int KRB = EB * KPW;  // a Q or K panel's row bytes
  static constexpr int KPANELS = (DP + KPW - 1) / KPW;
  static constexpr int KSTEPS = (EB * DP + 31) / 32;  // Q K^T's k steps
  static constexpr int VPW = DP % 32 == 0 ? 32 : 16;  // a V panel's columns
  static constexpr int VRB = 2 * VPW;
  static constexpr int VPANELS = DP / VPW;
  static constexpr int QPANEL = BQ * KRB, KPANEL = BK * KRB;
  static constexpr int VPANEL = BK * VRB;
  static constexpr int QBYTES = KPANELS * QPANEL;
  static constexpr int KBYTES = KPANELS * KPANEL, VBYTES = VPANELS * VPANEL;
  // the kv scales (BK fp32) on a swizzle period of their own
  static constexpr int SKBYTES = SK ? 1024 : 0;
  static constexpr int STAGE = KBYTES + (V ? VBYTES : 0) + SKBYTES;
  // the second warpgroup's O and row sums, handed to the first (SPLIT 2)
  static constexpr int HAND = SPLIT > 1 ? 128 * (DP / 2 + 2) * 4 : 0;
  // barriers: each Q slot's full (and with several slots its empty), then
  // full K, full V, empty K, empty V per stage (without V: full K, empty K)
  static constexpr int QBARS = QSLOTS > 1 ? 2 * QSLOTS : 1;
  static constexpr int BARS = 8 * (QBARS + (V ? 4 : 2) * STAGES);
  // 1 KB to align the buffers to the swizzles' 1024-byte period
  static constexpr int BYTES =
      1024 + QSLOTS * QBYTES + STAGES * STAGE + HAND + BARS;
  static_assert(DP == 48 || DP == 80 || DP == 96 || DP == 160 || DP == 176,
                "the UNet's head dims, and the studies' with a bound column");
  static_assert(KPW == 16 || KPW == 32 || KPW == 64, "a swizzle span");
  static_assert(EB == 2 || (EB == 1 && KPW == 64 && KPANELS == 1),
                "int8 Q / K: one panel of 64-byte rows");
  static_assert(!SK || 4 * BK <= SKBYTES, "the kv scales fit their slot");
  static_assert(BK == 64 || BK == 128 || BK == 256, "a TMA box of BK rows");
  static_assert(SPLIT == 1 || (SPLIT == 2 && WGM == 2),
                "two warpgroups split a tile's kv rows");
  static_assert(WGM >= 1 && BQ <= 256, "a TMA box of BQ rows");
  static_assert(QPANEL % 1024 == 0 && KPANEL % 1024 == 0 &&
                    VPANEL % 1024 == 0,
                "every panel on a swizzle period");
  static_assert(STAGES >= 2, "a ring");
  static_assert(WGM == 1 || (WGM * CONSUMER_REGS + PRODUCER_REGS <= 512 &&
                             REGS - PRODUCER_REGS >=
                                 WGM * (CONSUMER_REGS - REGS)),
                "the consumers' increase fits the producer's release");
  static_assert(BYTES <= 232448, "a block's shared memory");
};

// The ring of a block of configuration C in shared memory from `base` (on
// a 1024-byte boundary): Q slots, stages, the hand-over, the barriers; and
// the producer thread's copies into it.
template <class C>
struct FwRing {
  uint32_t base, ring, bars;
  __device__ explicit FwRing(uint32_t b)
      : base(b),
        ring(b + C::QSLOTS * C::QBYTES),
        bars(ring + C::STAGES * C::STAGE + C::HAND) {}
  __device__ uint32_t q(int slot) const { return base + slot * C::QBYTES; }
  __device__ uint32_t hand() const { return ring + C::STAGES * C::STAGE; }
  __device__ uint32_t q_full(int slot) const { return bars + 8 * slot; }
  __device__ uint32_t q_empty(int slot) const {
    return bars + 8 * (C::QSLOTS + slot);
  }
  __device__ uint32_t full_k(int s) const { return bars + 8 * (C::QBARS + s); }
  __device__ uint32_t full_v(int s) const {
    return bars + 8 * (C::QBARS + C::STAGES + s);
  }
  __device__ uint32_t empty_k(int s) const {
    return bars + 8 * (C::QBARS + (C::V ? 2 : 1) * C::STAGES + s);
  }
  __device__ uint32_t empty_v(int s) const {
    return bars + 8 * (C::QBARS + 3 * C::STAGES + s);
  }
  // walked tile i's K and V stages
  __device__ uint32_t k_stage(int i) const {
    return ring + (i % C::STAGES) * C::STAGE;
  }
  __device__ uint32_t v_stage(int i) const { return k_stage(i) + C::KBYTES; }
  // walked tile i's kv scales (SK)
  __device__ uint32_t sk_stage(int i) const {
    return k_stage(i) + C::KBYTES + (C::V ? C::VBYTES : 0);
  }
  // thread 0, before the block's first __syncthreads
  __device__ void init() const {
#pragma unroll
    for (int s = 0; s < C::QSLOTS; ++s) {
      mbar_init(q_full(s), 1);
      if (C::QSLOTS > 1) mbar_init(q_empty(s), C::NTC);
    }
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_k(s), 1);
      if (C::V) mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), C::NTC);
      if (C::V) mbar_init(empty_v(s), C::NTC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the producer: the BQ rows of Q from row q0 into slot `slot`
  __device__ void load_q(const CUtensorMap* tmq, int slot, int h, int q0,
                         int b) const {
    mbar_expect_tx(q_full(slot), C::QBYTES);
#pragma unroll
    for (int p = 0; p < C::KPANELS; ++p)
      tma_load_4d(q(slot) + p * C::QPANEL, tmq, q_full(slot),
                  p * (C::KRB / C::EB), h, q0, b);
  }
  // the producer: walked tile i (kv rows from `row`) into its stage, once
  // the consumers have released the stage's last use; with SK, the tile's
  // kv scales from the (B, 1, Skv) map tms beside K, under K's barrier
  __device__ void load_kv(const CUtensorMap* tmk, const CUtensorMap* tmv,
                          int i, int h, int row, int b,
                          const CUtensorMap* tms = nullptr) const {
    const int s = i % C::STAGES;
    const uint32_t par = (i / C::STAGES + 1) & 1;  // the stage's last use
    const uint32_t ks = ring + s * C::STAGE, vs = ks + C::KBYTES;
    if (i >= C::STAGES) mbar_wait(empty_k(s), par);
    mbar_expect_tx(full_k(s), C::KBYTES + (C::SK ? 4 * C::BK : 0));
#pragma unroll
    for (int p = 0; p < C::KPANELS; ++p)
      tma_load_4d(ks + p * C::KPANEL, tmk, full_k(s), p * (C::KRB / C::EB),
                  h, row, b);
    if constexpr (C::SK) tma_load_3d(sk_stage(i), tms, full_k(s), row, 0, b);
    if constexpr (C::V) {
      if (i >= C::STAGES) mbar_wait(empty_v(s), par);
      mbar_expect_tx(full_v(s), C::VBYTES);
#pragma unroll
      for (int p = 0; p < C::VPANELS; ++p)
        tma_load_4d(vs + p * C::VPANEL, tmv, full_v(s), p * C::VPW, h, row, b);
    }
  }
};

// The K/V tiles of BK rows that a block of F, M or L walks for batch row
// b, and the logits of a tile that no row may see. M (and masked L) walks
// only the tiles that hold a kept row: producer and consumers find the
// same walk from `keep`.
template <int BK, bool MASKED, bool STRADDLE>
struct KvWalk {
  const int* kp;  // this batch row's keep flags (masked)
  int span, skv, ntiles;
  __device__ KvWalk(const FwArgs& a, int b)
      : kp(MASKED ? a.keep + b * a.nref : a.keep),
        span(a.span),
        skv(a.Skv),
        ntiles((a.Skv + BK - 1) / BK) {}
  // the spans of tile t's first and last kv row
  __device__ int first_span(int t) const { return t * BK / span; }
  __device__ int last_span(int t) const {
    return (min(t * BK + BK, skv) - 1) / span;
  }
  // does tile t hold a kept kv row (block-uniform)
  __device__ bool kept(int t) const {
    if constexpr (!STRADDLE) return kp[t / (span / BK)] != 0;
    for (int r = first_span(t); r <= last_span(t); ++r)
      if (kp[r]) return true;
    return false;
  }
  // the first tile at or after t that holds a kept row
  __device__ int next(int t) const {
    if (MASKED)
      while (t < ntiles && !kept(t)) ++t;
    return t;
  }
  // -inf into this thread's S accumulators of tile t (s[4 j + 2 r + e] is
  // column 8 j + 2 tq + e) past Skv and in dropped spans
  __device__ void mask(float (&s)[BK / 2], int t, int tq) const {
    const int kvalid = skv - t * BK;
    if (kvalid < BK) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * tq + e % 2 >= kvalid) s[4 * j + e] = -INFINITY;
    }
    if (STRADDLE && first_span(t) != last_span(t)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = t * BK + 8 * j + 2 * tq + e;
          if (col < skv && !kp[col / span])
            s[4 * j + e] = s[4 * j + e + 2] = -INFINITY;
        }
    }
  }
};

// The walk of the studies (S1, S2): every tile, whole (Skv % BK == 0), no
// logit masked.
struct DenseWalk {
  int ntiles;
  __device__ int next(int t) const { return t; }
  template <class T, int N>
  __device__ void mask(T (&)[N], int, int) const {}
};

// F's softmax step, the policy of fw_consume: the exact online softmax of
// S in place, P = exp2(s scale log2(e) - m) with the new running max m
// kept in the scaled log2 domain, alpha = exp2(m_old - m) per row to
// rescale O and the row sum l; O / l at the end (0 where l = 0: the row
// kept no span).
struct FwSoftmax {
  static constexpr bool RESCALE = true;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float scale_log2;
  __device__ FwSoftmax(const FwArgs& a, int, int) : scale_log2(a.scale_log2) {}
  template <int N>
  __device__ void step(float (&s)[N], float (&alpha)[2]) {
    float mx[2] = {-INFINITY, -INFINITY}, neg[2];
#pragma unroll
    for (int i = 0; i < N; ++i) mx[i % 4 / 2] = fmaxf(mx[i % 4 / 2], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // finite: a walked tile holds a kept column, and keep is per batch
      // row, so every query row sees it
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
      // the row's first tile: nothing to rescale (and never -inf - -inf)
      alpha[r] = m[r] == -INFINITY ? 0.f : fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
      neg[r] = -m_new;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float e = fast_exp2(fmaf(s[i], scale_log2, neg[i % 4 / 2]));
      s[i] = e;
      l[i % 4 / 2] += e;
    }
  }
  // the factor of this thread's row r (0: grp, 1: grp + 8) at the end
  template <int R>
  __device__ float inv(int r, const float (&)[R], const FwArgs&) const {
    const float den = quad_sum(l[r]);
    return den > 0.f ? 1.f / den : 0.f;
  }
};

// The consumers' walk of F, M and the studies that share it, in one
// consumer warpgroup g: S_i = Q K_i^T of walked tile i is issued with
// P_{i-1} V_{i-1}; the group waits for S_i only and takes the policy's
// softmax step on it while P V runs, then waits for P V, rescales O where
// the policy keeps a running max, and rounds P_i. With PP, named barriers
// order the two groups' issues (ping-pong). Q's rows at `qrows`; the group
// takes kv rows [krow, krow + NS) of each tile (NS = BK, or BK / 2 where
// two groups split a tile); `i0` is the ring position of the walk's first
// tile (a block that walks several heads runs its ring on). Returns the
// tiles walked. acc[4 j + 2 r + e] of an accumulator is row 16 w + lane / 4
// + 8 r of the group's rows, column 8 j + 2 (lane % 4) + e. The S
// accumulators are C::SAcc: int32 logits (int8 Q and K) go to the policy
// with the tile's kv scales (SK), the policy leaves p's bits in place, and
// the K stage (which holds the scales) is released after the step.
template <class C, int NS, bool PP, class Walk, class SM>
__device__ __forceinline__ int fw_consume(const FwRing<C>& rg,
                                          const Walk& walk, SM& sm,
                                          float (&o)[C::DP / 2],
                                          uint32_t qrows, int krow, int i0,
                                          int g, int tq) {
  constexpr int KSTEPS = C::KSTEPS;  // Q K^T's k steps
  constexpr int KPS = C::KRB / 32;   // k steps a Q / K panel holds
  constexpr int STAGES = C::STAGES;
  const int ntiles = walk.ntiles;
  typename C::SAcc s[NS / 2];
  uint32_t p[NS / 16][4];  // P's A fragments, one per 16 kv rows
  // S = Q K^T against the K tile at `ks`: k step j lies in panel j / KPS
  // at byte 32 (j % KPS) of each row
  auto qk = [&](uint32_t ks) {
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j) {
      const uint32_t col = 32 * (j % KPS);
      WgMmaSS<NS>::run(
          s,
          smem_desc(qrows + (j / KPS) * C::QPANEL + col, 0, 8 * C::KRB,
                    C::KRB),
          smem_desc(ks + krow * C::KRB + (j / KPS) * C::KPANEL + col, 0,
                    8 * C::KRB, C::KRB),
          j > 0);
    }
  };
  // O += P V against the V tile at `vs`: k step kk is its kv rows 16 kk ..
  // in every panel (LBO the panel stride)
  auto pv = [&](uint32_t vs) {
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk)
      WgMma<C::DP>::run(o, p[kk],
                        smem_desc(vs + (krow + 16 * kk) * C::VRB, C::VPANEL,
                                  8 * C::VRB, C::VRB));
  };
  auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        p[kk][f] = pack_bf16(acc_f(s[8 * kk + 2 * f]),
                             acc_f(s[8 * kk + 2 * f + 1]));
  };
  auto v_stage = [&](int i) { return rg.v_stage(i0 + i); };
  // the policy's step on walked tile i's logits; the K stage released
  // before it, or with SK after it (the step reads the stage's scales)
  auto take = [&](int i, float(&alpha)[2]) {
    const int pos = i0 + i;
    if constexpr (C::SK) {
      sm.step(s, alpha, rg.sk_stage(pos) + 4 * krow);
      mbar_arrive(rg.empty_k(pos % STAGES));
    } else {
      mbar_arrive(rg.empty_k(pos % STAGES));
      sm.step(s, alpha);
    }
  };

  int cur = walk.next(0);
  if (cur >= ntiles) return 0;
  if (PP && g == 1) named_bar_arrive(1, C::NTC);  // group 0 issues first
  mbar_wait(rg.full_k(i0 % STAGES), (i0 / STAGES) & 1);
  wg_fence();
  qk(rg.k_stage(i0));
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
  walk.mask(s, cur, tq);
  float alpha[2];
  take(0, alpha);  // O is 0: alpha unused
  pack();
  int i = 1;  // tiles walked
  for (cur = walk.next(cur + 1); cur < ntiles; cur = walk.next(cur + 1), ++i) {
    const int si = (i0 + i) % STAGES;
    mbar_wait(rg.full_k(si), ((i0 + i) / STAGES) & 1);
    if (PP) named_bar_sync(1 + g, C::NTC);
    wg_fence();
    qk(rg.k_stage(i0 + i));
    wg_commit();
    mbar_wait(rg.full_v((i0 + i - 1) % STAGES), ((i0 + i - 1) / STAGES) & 1);
    pv(v_stage(i - 1));
    wg_commit();
    if (PP) named_bar_arrive(2 - g, C::NTC);  // the other group's turn
    wg_wait<1>();  // S_i; P_{i-1} V_{i-1} may still run
    fence_regs(s);
    walk.mask(s, cur, tq);
    take(i, alpha);
    wg_wait<0>();
    fence_regs(o);
    mbar_arrive(rg.empty_v((i0 + i - 1) % STAGES));
    if constexpr (SM::RESCALE) {
#pragma unroll
      for (int j = 0; j < C::DP / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }
    pack();
  }
  mbar_wait(rg.full_v((i0 + i - 1) % STAGES), ((i0 + i - 1) / STAGES) & 1);
  wg_fence();
  pv(v_stage(i - 1));
  wg_commit();
  wg_wait<0>();
  fence_regs(o);
  mbar_arrive(rg.empty_v((i0 + i - 1) % STAGES));
  // group 1's last turn signal (or its first, where one tile was walked)
  if (PP && g == 0) named_bar_sync(1, C::NTC);
  return i;
}

// fw_consume with the next tile's Q K^T in flight while the current tile's
// softmax runs (the studies' split2): two S accumulator sets, S_{i+1}
// issued into one before the group takes the softmax step of S_i in the
// other, beside P_{i-1} V_{i-1}; both are waited for inside the same loop
// step, and the last tile (nothing to issue) takes a path of its own:
// ptxas serialises every wgmma where a product is in flight across the
// loop's back edge, or where a path that issued one meets one that did not
// before the wait. Every tile walked, none masked (DenseWalk).
template <class C, class SM>
__device__ __forceinline__ void fw_consume_ahead(const FwRing<C>& rg,
                                                 int ntiles, SM& sm,
                                                 float (&o)[C::DP / 2],
                                                 uint32_t qrows) {
  constexpr int BK = C::BK, KSTEPS = C::DP / 16, KPS = C::KRB / 32;
  constexpr int STAGES = C::STAGES;
  float s0[BK / 2], s1[BK / 2];
  uint32_t p[BK / 16][4];
  // issue S = Q K^T of walked tile i into s once its K stage has landed
  auto qk = [&](float(&s)[BK / 2], int i) {
    mbar_wait(rg.full_k(i % STAGES), (i / STAGES) & 1);
    const uint32_t ks = rg.k_stage(i);
    // s's registers settle before the fence, so that no move of them
    // falls between the fence and the products (ptxas would serialise)
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j) {
      const uint32_t col = 32 * (j % KPS);
      WgMmaSS<BK>::run(
          s,
          smem_desc(qrows + (j / KPS) * C::QPANEL + col, 0, 8 * C::KRB,
                    C::KRB),
          smem_desc(ks + (j / KPS) * C::KPANEL + col, 0, 8 * C::KRB, C::KRB),
          j > 0);
    }
    wg_commit();
  };
  // issue O += P V of walked tile i (P in p) once its V stage has landed
  auto pv = [&](int i) {
    mbar_wait(rg.full_v(i % STAGES), (i / STAGES) & 1);
    const uint32_t vs = rg.v_stage(i);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgMma<C::DP>::run(o, p[kk],
                        smem_desc(vs + 16 * kk * C::VRB, C::VPANEL,
                                  8 * C::VRB, C::VRB));
    wg_commit();
  };
  auto finish = [&](float(&s)[BK / 2], const float(&alpha)[2]) {
    if constexpr (SM::RESCALE) {
#pragma unroll
      for (int j = 0; j < C::DP / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        p[kk][f] = pack_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1]);
  };
  int i = 0;  // the walked tile whose logits are in hand
  // s holds S_i (its K stage released), p holds P_{i-1}, not yet in a P V
  auto step = [&](float(&s)[BK / 2], float(&nxt)[BK / 2]) {
    float alpha[2];
    if (i + 1 >= ntiles) {  // the last tile: nothing to issue ahead
      wg_fence();
      pv(i - 1);
      sm.step(s, alpha);
      wg_wait<0>();
      fence_regs(o);
      mbar_arrive(rg.empty_v((i - 1) % STAGES));
      finish(s, alpha);
      return false;
    }
    qk(nxt, i + 1);
    pv(i - 1);
    sm.step(s, alpha);
    wg_wait<0>();
    fence_regs(nxt);
    fence_regs(o);
    mbar_arrive(rg.empty_k((i + 1) % STAGES));
    mbar_arrive(rg.empty_v((i - 1) % STAGES));
    finish(s, alpha);
    ++i;
    return true;
  };

  qk(s0, 0);
  wg_wait<0>();
  fence_regs(s0);
  mbar_arrive(rg.empty_k(0));
  float alpha[2];
  if (ntiles == 1) {
    sm.step(s0, alpha);  // O is 0: alpha unused
    finish(s0, alpha);
  } else {
    qk(s1, 1);
    sm.step(s0, alpha);
    wg_wait<0>();
    fence_regs(s1);
    mbar_arrive(rg.empty_k(1 % STAGES));
    finish(s0, alpha);
    i = 1;
    while (step(s1, s0) && step(s0, s1)) {
    }
  }
  wg_fence();
  pv(i);
  wg_wait<0>();
  fence_regs(o);
  mbar_arrive(rg.empty_v(i % STAGES));
}

// The consumers' first step past the producer's branch: setmaxnreg where
// the producer hands them its registers, else (one consumer warpgroup, at
// the launch's 255) a barrier of the warpgroup's four warps. Either is an
// aligned instruction, from which ptxas knows that the warpgroup has
// converged; with neither, it serialised every wgmma (C7520).
template <class C>
__device__ __forceinline__ void consumers_start() {
  if constexpr (C::NTC > 128)
    setmaxnreg_inc<C::CONSUMER_REGS>();
  else
    named_bar_sync(1, 128);
}

// One block of F's form, for policy SM: the producer warpgroup lands Q (BQ
// rows from q0 of head h, batch row b) and the walked K/V tiles, the
// consumers walk them (fw_consume, or fw_consume_ahead with AHEAD), and O
// times the policy's factor goes into (B, Sq, H*D) as bf16 pairs, columns
// below D and rows below Sq only.
template <class C, bool PP, bool AHEAD, class SM, class Walk>
__device__ __forceinline__ void fw_block(const CUtensorMap* tmq,
                                         const CUtensorMap* tmk,
                                         const CUtensorMap* tmv,
                                         const FwArgs& a, const Walk& walk,
                                         int h, int b, int q0,
                                         const CUtensorMap* tms = nullptr) {
  static_assert(!PP || C::NTC == 256, "ping-pong between two warpgroups");
  static_assert(C::QSLOTS == 1 && C::HAND == 0, "one head a block");
  constexpr int WGM = C::NTC / 128;
  extern __shared__ unsigned char smem_raw[];
  const FwRing<C> rg((smem_addr(smem_raw) + 1023u) & ~1023u);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) rg.init();
  __syncthreads();

  if (warp >= 4 * WGM) {  // the producer: one thread issues every copy
    if constexpr (WGM > 1) setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == 4 * WGM && lane == 0) {
      rg.load_q(tmq, 0, h, q0, b);
      int i = 0;
      for (int t = walk.next(0); t < walk.ntiles; t = walk.next(t + 1), ++i)
        rg.load_kv(tmk, tmv, i, h, t * C::BK, b, tms);
    }
    return;
  }

  // the consumers: warp w of warpgroup g owns query rows 64 g + 16 w ..
  // 64 g + 16 w + 15 of the block
  consumers_start<C>();
  const int g = warp / 4, w = warp % 4, grp = lane / 4, tq = lane % 4;
  const int row0 = q0 + 64 * g + 16 * w + grp;  // and row0 + 8
  SM sm(a, b, row0);
  float o[C::DP / 2];
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) o[i] = 0.f;
  const uint32_t qrows = rg.q(0) + 64 * g * C::KRB;  // this group's Q rows
  mbar_wait(rg.q_full(0), 0);  // also where no tile is walked: it landed
  if constexpr (AHEAD)
    fw_consume_ahead<C>(rg, walk.ntiles, sm, o, qrows);
  else
    fw_consume<C, C::BK, PP>(rg, walk, sm, o, qrows, 0, 0, g, tq);

  // O times the policy's factor into (B, Sq, H*D)
  const long long ors = (long long)a.H * a.D;
  bf16* ob = a.out + (long long)b * a.Sq * ors + (long long)h * a.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = sm.inv(r, o, a);
    const int row = row0 + 8 * r;
    if (row < a.Sq) {
      bf16* orow = ob + row * ors;
#pragma unroll
      for (int j = 0; j < C::DP / 8; ++j) {
        const int c = 8 * j + 2 * tq;
        if (c < a.D)
          *reinterpret_cast<uint32_t*>(orow + c) =
              pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// Kernels F and M; grid (ceil(Sq / BQ), H, B)
template <int DP, int WGM, int BK, int STAGES, int KPW, bool PP, bool MASKED,
          bool STRADDLE>
__global__ void __launch_bounds__(128 * WGM + 128, 1)
    flash_wg_kernel(const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const FwArgs a) {
  using C = FwCfg<DP, WGM, BK, STAGES, KPW>;
  const int b = blockIdx.z;
  fw_block<C, PP, false, FwSoftmax>(&tmq, &tmk, &tmv, a,
                                    KvWalk<BK, MASKED, STRADDLE>(a, b),
                                    blockIdx.y, b, blockIdx.x * C::BQ);
}

// ---- host side

// The tensor map of a (B, S, H*D) operand with element strides (bs, rs, 1)
// as (D, H, S, B), in boxes of (width, 1, rows, 1) swizzled over eb width
// bytes; out-of-range elements read as zero. Elements of eb bytes: 2
// (bf16) or 1 (int8). The head stride hs (elements) is D unless given: a
// (BH, S, D) int8 operand (H = 1) gives its row stride, since every
// stride must be a multiple of 16 bytes, and D = 40 bytes is not. Mirrored
// by ops/flash_attention.py::operand_map.
inline bool encode_operand(CUtensorMap* m, const void* x, int B, int H, int S,
                           int D, long long bs, long long rs, int width,
                           int rows, int eb = 2, long long hs = 0) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t e = eb;
  const cuuint64_t dim[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                             (cuuint64_t)B};
  const cuuint64_t str[3] = {e * (hs ? hs : D), e * rs, e * bs};
  const cuuint32_t box[4] = {(cuuint32_t)width, 1, (cuuint32_t)rows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return enc(m,
             eb == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             4, const_cast<void*>(x), dim, str, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(eb * width),
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a (P, R, C) array of type t (row and plane strides in
// bytes, multiples of 16) in boxes of (bc, br, 1) elements, unswizzled;
// out-of-range elements read as zero: S3's q_t (BH, D, Sq) in slabs of a
// head's d rows (zeros past D) and BQ queries, and S4's kv scales
// (BH, 1, Skv) fp32 in tiles of BK.
inline bool encode_planes(CUtensorMap* m, const void* x,
                          CUtensorMapDataType t, long long P, long long R,
                          long long C, long long rstride, long long pstride,
                          int bc, int br) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dim[3] = {(cuuint64_t)C, (cuuint64_t)R, (cuuint64_t)P};
  const cuuint64_t str[2] = {(cuuint64_t)rstride, (cuuint64_t)pstride};
  const cuuint32_t box[3] = {(cuuint32_t)bc, (cuuint32_t)br, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return enc(m, t, 3, const_cast<void*>(x), dim, str, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch: q (B, Sq, H*D), k and v (B, Skv, H*D) with their batch and
// row strides in elements; the three tensor maps are encoded per call.
template <int DP, int WGM, int BK, int STAGES, int KPW, bool PP, bool MASKED,
          bool STRADDLE>
cudaError_t flash_wg_launch(const bf16* q, const bf16* k, const bf16* v,
                            const FwArgs& a, int B, long long qb,
                            long long qr, long long kb, long long kr,
                            long long vb, long long vr, cudaStream_t stream) {
  using C = FwCfg<DP, WGM, BK, STAGES, KPW>;
  CUtensorMap tq, tk, tv;
  if (!encode_operand(&tq, q, B, a.H, a.Sq, a.D, qb, qr, KPW, C::BQ) ||
      !encode_operand(&tk, k, B, a.H, a.Skv, a.D, kb, kr, KPW, BK) ||
      !encode_operand(&tv, v, B, a.H, a.Skv, a.D, vb, vr, C::VPW, BK))
    return cudaErrorInvalidValue;
  constexpr auto kern =
      flash_wg_kernel<DP, WGM, BK, STAGES, KPW, PP, MASKED, STRADDLE>;
  cudaError_t err = smem_limit_once<kern>(C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + C::BQ - 1) / C::BQ, a.H, B);
  kern<<<grid, C::NT, C::BYTES, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

// Kernel L: lse[b, h, i] = log sum_j exp(scale q_i . k_j) over every kv row
// (over the kept spans where `keep` is given), -inf for a row that kept
// none; grid (ceil(Sq / BQ), H, B). F's walk without V, P V and O: the
// producer lands Q once and the walked K tiles into a ring of STAGES
// stages; each consumer warpgroup issues S_{j+1} = Q K_{j+1}^T into a
// second accumulator set before it takes the exps and row sums of S_j, so
// the products run while the exps do. The running max m and sum l live in
// the scaled log2 domain, and lse = (m + log2 l) ln 2.
template <int DP, int WGM, int BK, int STAGES, int KPW, bool MASKED,
          bool STRADDLE>
__global__ void __launch_bounds__(128 * WGM + 128, 1)
    lse_wg_kernel(const __grid_constant__ CUtensorMap tmq,
                  const __grid_constant__ CUtensorMap tmk, const FwArgs a) {
  using C = FwCfg<DP, WGM, BK, STAGES, KPW, false>;
  constexpr int KSTEPS = DP / 16, KPS = KPW / 16;
  extern __shared__ unsigned char smem_raw[];
  const FwRing<C> rg((smem_addr(smem_raw) + 1023u) & ~1023u);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * C::BQ;
  const KvWalk<BK, MASKED, STRADDLE> walk(a, b);

  if (tid == 0) rg.init();
  __syncthreads();

  if (warp >= 4 * WGM) {  // the producer: one thread issues every copy
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == 4 * WGM && lane == 0) {
      rg.load_q(&tmq, 0, h, q0, b);
      int i = 0;
      for (int t = walk.next(0); t < walk.ntiles; t = walk.next(t + 1), ++i)
        rg.load_kv(&tmk, &tmk, i, h, t * BK, b);
    }
    return;
  }

  // the consumers: warp w of warpgroup g owns query rows 64 g + 16 w ..
  // 64 g + 16 w + 15 of the block; s[4 j + 2 r + e] of an accumulator set
  // is row 16 w + lane / 4 + 8 r, column 8 j + 2 (lane % 4) + e
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int g = warp / 4, w = warp % 4, grp = lane / 4, tq = lane % 4;
  float s0[BK / 2], s1[BK / 2];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t qrows = rg.q(0) + 64 * g * C::KRB;  // this group's Q rows
  // issue S = Q K^T of walked tile i into s once its K stage has landed: k
  // step j lies in panel j / KPS at byte 32 (j % KPS) of each row
  auto qk = [&](float(&s)[BK / 2], int i) {
    const int st = i % STAGES;
    mbar_wait(rg.full_k(st), (i / STAGES) & 1);
    const uint32_t ks = rg.k_stage(i);
    // s's registers settle before the fence, so that no move of them
    // falls between the fence and the products (ptxas would serialise)
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j) {
      const uint32_t col = 32 * (j % KPS);
      WgMmaSS<BK>::run(
          s,
          smem_desc(qrows + (j / KPS) * C::QPANEL + col, 0, 8 * C::KRB,
                    C::KRB),
          smem_desc(ks + (j / KPS) * C::KPANEL + col, 0, 8 * C::KRB, C::KRB),
          j > 0);
    }
    wg_commit();
  };
  // the running max and sum over the logits in s; the row max through
  // four chains of the row's columns, so that its latency stays short
  auto update = [&](float(&s)[BK / 2]) {
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY}, neg[2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[i % 4] = fmaxf(mx[i % 4], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // finite: a walked tile holds a kept column, and keep is per batch
      // row, so every query row sees it
      const float m_new = fmaxf(
          m[r], quad_max(fmaxf(mx[2 * r], mx[2 * r + 1])) * a.scale_log2);
      // the row's first tile: nothing to rescale (and never -inf - -inf)
      l[r] *= m[r] == -INFINITY ? 0.f : fast_exp2(m[r] - m_new);
      m[r] = m_new;
      neg[r] = -m_new;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};  // two sums a row
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      acc[i % 4] += fast_exp2(fmaf(s[i], a.scale_log2, neg[i % 4 / 2]));
    l[0] += acc[0] + acc[1];
    l[1] += acc[2] + acc[3];
  };
  // walked tile i (tile `cur`) landed in s: the next walked tile's S
  // issued into `nxt`, s's exps while it runs, then its wait, all on one
  // path (ptxas serialises every wgmma where a path that issued one meets
  // one that did not before the wait, or one is in flight across the
  // loop's back edge); false after the last tile. Only the last walked
  // tile can be ragged, so only it (and, with STRADDLE, a tile across a
  // span boundary) takes the mask: a masked tile costs a select a logit.
  int i = 0, cur = walk.next(0);
  auto step = [&](float(&s)[BK / 2], float(&nxt)[BK / 2]) {
    const int after = walk.next(cur + 1);
    if (after >= walk.ntiles) {
      walk.mask(s, cur, tq);
      update(s);
      return false;
    }
    qk(nxt, i + 1);
    if constexpr (STRADDLE) walk.mask(s, cur, tq);
    update(s);
    wg_wait<0>();
    fence_regs(nxt);
    ++i;
    cur = after;
    mbar_arrive(rg.empty_k(i % STAGES));
    return true;
  };

  mbar_wait(rg.q_full(0), 0);  // also where no tile is walked: it landed
  if (cur < walk.ntiles) {
    qk(s0, 0);
    wg_wait<0>();
    fence_regs(s0);
    mbar_arrive(rg.empty_k(0));
    while (step(s0, s1) && step(s1, s0)) {
    }
  }

  // (m + log2 l) ln 2 into (B, H, Sq); l = 0: the row kept no span, -inf
  float* lrow = a.lse + ((long long)b * a.H + h) * a.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = quad_sum(l[r]);
    const int row = q0 + 64 * g + 16 * w + grp + 8 * r;
    if (tq == 0 && row < a.Sq)
      lrow[row] =
          den > 0.f ? (m[r] + log2f(den)) * 0.6931471805599453f : -INFINITY;
  }
}

// One launch of L: q (B, Sq, H*D), k (B, Skv, H*D) with their batch and
// row strides in elements; the two tensor maps are encoded per call.
template <int DP, int WGM, int BK, int STAGES, int KPW, bool MASKED,
          bool STRADDLE>
cudaError_t lse_wg_launch(const bf16* q, const bf16* k, const FwArgs& a,
                          int B, long long qb, long long qr, long long kb,
                          long long kr, cudaStream_t stream) {
  using C = FwCfg<DP, WGM, BK, STAGES, KPW, false>;
  CUtensorMap tq, tk;
  if (!encode_operand(&tq, q, B, a.H, a.Sq, a.D, qb, qr, KPW, C::BQ) ||
      !encode_operand(&tk, k, B, a.H, a.Skv, a.D, kb, kr, KPW, BK))
    return cudaErrorInvalidValue;
  constexpr auto kern =
      lse_wg_kernel<DP, WGM, BK, STAGES, KPW, MASKED, STRADDLE>;
  cudaError_t err = smem_limit_once<kern>(C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + C::BQ - 1) / C::BQ, a.H, B);
  kern<<<grid, C::NT, C::BYTES, stream>>>(tq, tk, a);
  return cudaGetLastError();
}

}  // namespace sg_flash
