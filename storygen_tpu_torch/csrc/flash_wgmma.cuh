// Kernels F and M (flash_fwd.cu) on Hopper's own instructions (sm_90a):
// O = softmax(Q K^T * scale) V per head, over every kv row (F) or over the
// kept reference spans only (M).
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
//   of 16 (d 48, 80) or 32 (d 160) columns, which divide its N.
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

#include "hopper.cuh"
#include "study_mma.cuh"

namespace sg_flash {

using namespace sg_hopper;
using namespace sg_study;

struct FwArgs {
  bf16* out;         // F, M: (B, Sq, H*D)
  float* lse;        // L: (B, H, Sq)
  const int* keep;   // M, masked L: (B, nref) int32; else null
  int H, Sq, Skv, D;
  int nref, span;    // M: nref spans of `span` kv rows; F: 1, 1
  float scale_log2;  // scale * log2(e), > 0
};

// A block of WGM consumer warpgroups (64 query rows each) and a producer
// warpgroup; K/V tiles (L: K tiles, V = false) of BK rows in a ring of
// STAGES stages; Q and K in panels of KPW columns.
template <int DP, int WGM, int BK, int STAGES, int KPW, bool V = true>
struct FwCfg {
  static constexpr int BQ = 64 * WGM;
  static constexpr int NTC = 128 * WGM;  // consumer threads
  static constexpr int NT = NTC + 128;   // and the producer warpgroup
  // registers a thread at launch, and after setmaxnreg (conv_wgmma.cuh's
  // pool: the producer's release is what the consumers' rise draws on)
  static constexpr int REGS = 512 / (WGM + 1) / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int RISE = (REGS + (REGS - PRODUCER_REGS) / WGM) / 8 * 8;
  static constexpr int CONSUMER_REGS = RISE > 240 ? 240 : RISE;
  static constexpr int KRB = 2 * KPW;  // a Q or K panel's row bytes
  static constexpr int KPANELS = (DP + KPW - 1) / KPW;
  static constexpr int VPW = DP % 32 == 0 ? 32 : 16;  // a V panel's columns
  static constexpr int VRB = 2 * VPW;
  static constexpr int VPANELS = DP / VPW;
  static constexpr int QPANEL = BQ * KRB, KPANEL = BK * KRB;
  static constexpr int VPANEL = BK * VRB;
  static constexpr int QBYTES = KPANELS * QPANEL;
  static constexpr int KBYTES = KPANELS * KPANEL, VBYTES = VPANELS * VPANEL;
  static constexpr int STAGE = KBYTES + (V ? VBYTES : 0);
  // Q's barrier, then full K, full V, empty K, empty V per stage (L: full
  // K, empty K)
  static constexpr int BARS = 8 * (1 + (V ? 4 : 2) * STAGES);
  // 1 KB to align the buffers to the swizzles' 1024-byte period
  static constexpr int BYTES = 1024 + QBYTES + STAGES * STAGE + BARS;
  static_assert(DP == 48 || DP == 80 || DP == 160, "the UNet's head dims");
  static_assert(KPW == 16 || KPW == 32 || KPW == 64, "a swizzle span");
  static_assert(BK == 64 || BK == 128, "Q K^T's N");
  // (one consumer warpgroup would launch at 256 registers a thread, past
  // the 255 a thread may hold)
  static_assert(WGM >= 2 && BQ <= 256, "a TMA box of BQ rows");
  static_assert(QPANEL % 1024 == 0 && KPANEL % 1024 == 0 &&
                    VPANEL % 1024 == 0,
                "every panel on a swizzle period");
  static_assert(STAGES >= 2, "a ring");
  static_assert(WGM * CONSUMER_REGS + PRODUCER_REGS <= 512 &&
                    REGS - PRODUCER_REGS >= WGM * (CONSUMER_REGS - REGS),
                "the consumers' increase fits the producer's release");
  static_assert(BYTES <= 232448, "a block's shared memory");
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

// grid (ceil(Sq / BQ), H, B)
template <int DP, int WGM, int BK, int STAGES, int KPW, bool PP, bool MASKED,
          bool STRADDLE>
__global__ void __launch_bounds__(128 * WGM + 128, 1)
    flash_wg_kernel(const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const FwArgs a) {
  using C = FwCfg<DP, WGM, BK, STAGES, KPW>;
  static_assert(!PP || WGM == 2, "ping-pong between two warpgroups");
  constexpr int KSTEPS = DP / 16;  // Q K^T's k steps
  constexpr int KPS = KPW / 16;    // k steps a Q / K panel holds
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + C::QBYTES;  // stage s: K panels, V panels
  const uint32_t qbar = ring + STAGES * C::STAGE;
  auto full_k = [&](int s) { return qbar + 8 * (1 + s); };
  auto full_v = [&](int s) { return qbar + 8 * (1 + STAGES + s); };
  auto empty_k = [&](int s) { return qbar + 8 * (1 + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return qbar + 8 * (1 + 3 * STAGES + s); };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * C::BQ;
  const KvWalk<BK, MASKED, STRADDLE> walk(a, b);
  const int ntiles = walk.ntiles;
  auto next_kept = [&](int t) { return walk.next(t); };

  if (tid == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), C::NTC);
      mbar_init(empty_v(s), C::NTC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WGM) {  // the producer: one thread issues every copy
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == 4 * WGM && lane == 0) {
      mbar_expect_tx(qbar, C::QBYTES);
#pragma unroll
      for (int p = 0; p < C::KPANELS; ++p)
        tma_load_4d(base + p * C::QPANEL, &tmq, qbar, p * KPW, h, q0, b);
      int i = 0;
      for (int t = next_kept(0); t < ntiles; t = next_kept(t + 1), ++i) {
        const int s = i % STAGES;
        const uint32_t par = (i / STAGES + 1) & 1;  // the stage's last use
        const uint32_t ks = ring + s * C::STAGE, vs = ks + C::KBYTES;
        if (i >= STAGES) mbar_wait(empty_k(s), par);
        mbar_expect_tx(full_k(s), C::KBYTES);
#pragma unroll
        for (int p = 0; p < C::KPANELS; ++p)
          tma_load_4d(ks + p * C::KPANEL, &tmk, full_k(s), p * KPW, h, t * BK,
                      b);
        if (i >= STAGES) mbar_wait(empty_v(s), par);
        mbar_expect_tx(full_v(s), C::VBYTES);
#pragma unroll
        for (int p = 0; p < C::VPANELS; ++p)
          tma_load_4d(vs + p * C::VPANEL, &tmv, full_v(s), p * C::VPW, h,
                      t * BK, b);
      }
    }
    return;
  }

  // the consumers: warp w of warpgroup g owns query rows 64 g + 16 w ..
  // 64 g + 16 w + 15 of the block; acc[4 j + 2 r + e] of an accumulator is
  // row 16 w + lane / 4 + 8 r, column 8 j + 2 (lane % 4) + e
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int g = warp / 4, w = warp % 4, grp = lane / 4, tq = lane % 4;
  float o[DP / 2], s[BK / 2];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t p[BK / 16][4];  // P's A fragments, one per 16 kv rows
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  const uint32_t qrows = base + 64 * g * C::KRB;  // this group's Q rows
  // S = Q K^T against the K tile at `ks`: k step j lies in panel j / KPS
  // at byte 32 (j % KPS) of each row
  auto qk = [&](uint32_t ks) {
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
  };
  // O += P V against the V tile at `vs`: k step kk is its kv rows 16 kk ..
  // in every panel (LBO the panel stride)
  auto pv = [&](uint32_t vs) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgMma<DP>::run(o, p[kk],
                     smem_desc(vs + 16 * kk * C::VRB, C::VPANEL, 8 * C::VRB,
                               C::VRB));
  };
  // the logits of tile t that no row may see: past Skv, in dropped spans
  auto mask = [&](int t) { walk.mask(s, t, tq); };
  // the online softmax of S in place: P = exp2(s scale log2(e) - m) with
  // the new running max m, and alpha = exp2(m_old - m) per row
  auto softmax = [&](float (&alpha)[2]) {
    float mx[2] = {-INFINITY, -INFINITY}, neg[2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[i % 4 / 2] = fmaxf(mx[i % 4 / 2], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // finite: a walked tile holds a kept column, and keep is per batch
      // row, so every query row sees it
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * a.scale_log2);
      // the row's first tile: nothing to rescale (and never -inf - -inf)
      alpha[r] = m[r] == -INFINITY ? 0.f : fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
      neg[r] = -m_new;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float e = fast_exp2(fmaf(s[i], a.scale_log2, neg[i % 4 / 2]));
      s[i] = e;
      l[i % 4 / 2] += e;
    }
  };
  auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        p[kk][f] = pack_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1]);
  };
  auto v_stage = [&](int i) {
    return ring + (i % STAGES) * C::STAGE + C::KBYTES;
  };

  mbar_wait(qbar, 0);  // also where no tile is walked: the copy has landed
  int cur = next_kept(0);
  if (cur < ntiles) {
    if (PP && g == 1) named_bar_arrive(1, C::NTC);  // group 0 issues first
    mbar_wait(full_k(0), 0);
    wg_fence();
    qk(ring);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    mbar_arrive(empty_k(0));
    mask(cur);
    float alpha[2];
    softmax(alpha);  // O is 0: alpha unused
    pack();
    int i = 1;  // tiles walked
    for (cur = next_kept(cur + 1); cur < ntiles;
         cur = next_kept(cur + 1), ++i) {
      const int si = i % STAGES;
      mbar_wait(full_k(si), (i / STAGES) & 1);
      if (PP) named_bar_sync(1 + g, C::NTC);
      wg_fence();
      qk(ring + si * C::STAGE);
      wg_commit();
      mbar_wait(full_v((i - 1) % STAGES), ((i - 1) / STAGES) & 1);
      pv(v_stage(i - 1));
      wg_commit();
      if (PP) named_bar_arrive(2 - g, C::NTC);  // the other group's turn
      wg_wait<1>();  // S_i; P_{i-1} V_{i-1} may still run
      fence_regs(s);
      mbar_arrive(empty_k(si));
      mask(cur);
      softmax(alpha);
      wg_wait<0>();
      fence_regs(o);
      mbar_arrive(empty_v((i - 1) % STAGES));
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      pack();
    }
    mbar_wait(full_v((i - 1) % STAGES), ((i - 1) / STAGES) & 1);
    wg_fence();
    pv(v_stage(i - 1));
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    // group 1's last turn signal (or its first, where one tile was walked)
    if (PP && g == 0) named_bar_sync(1, C::NTC);
  }

  // O / l into (B, Sq, H*D); l = 0: the row kept no span, write zeros
  const long long ors = (long long)a.H * a.D;
  bf16* ob = a.out + (long long)b * a.Sq * ors + (long long)h * a.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = quad_sum(l[r]);
    const float inv = den > 0.f ? 1.f / den : 0.f;
    const int row = q0 + 64 * g + 16 * w + grp + 8 * r;
    if (row < a.Sq) {
      bf16* orow = ob + row * ors;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + 2 * tq;
        if (c < a.D)
          *reinterpret_cast<uint32_t*>(orow + c) =
              pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// ---- host side

// The tensor map of a (B, S, H*D) operand with element strides (bs, rs, 1)
// as (D, H, S, B), in boxes of (width, 1, rows, 1) swizzled over 2 width
// bytes; out-of-range elements read as zero. Mirrored by
// ops/flash_attention.py::operand_map.
inline bool encode_operand(CUtensorMap* m, const bf16* x, int B, int H, int S,
                           int D, long long bs, long long rs, int width,
                           int rows) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t dim[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                             (cuuint64_t)B};
  const cuuint64_t str[3] = {e * D, e * rs, e * bs};
  const cuuint32_t box[4] = {(cuuint32_t)width, 1, (cuuint32_t)rows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(x),
             dim, str, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle_of(2 * width), CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
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
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + C::QBYTES;  // stage s: K panels
  const uint32_t qbar = ring + STAGES * C::STAGE;
  auto full = [&](int s) { return qbar + 8 * (1 + s); };
  auto empty = [&](int s) { return qbar + 8 * (1 + STAGES + s); };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * C::BQ;
  const KvWalk<BK, MASKED, STRADDLE> walk(a, b);

  if (tid == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::NTC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WGM) {  // the producer: one thread issues every copy
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == 4 * WGM && lane == 0) {
      mbar_expect_tx(qbar, C::QBYTES);
#pragma unroll
      for (int p = 0; p < C::KPANELS; ++p)
        tma_load_4d(base + p * C::QPANEL, &tmq, qbar, p * KPW, h, q0, b);
      int i = 0;
      for (int t = walk.next(0); t < walk.ntiles; t = walk.next(t + 1), ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), (i / STAGES + 1) & 1);
        mbar_expect_tx(full(s), C::KBYTES);
#pragma unroll
        for (int p = 0; p < C::KPANELS; ++p)
          tma_load_4d(ring + s * C::STAGE + p * C::KPANEL, &tmk, full(s),
                      p * KPW, h, t * BK, b);
      }
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
  const uint32_t qrows = base + 64 * g * C::KRB;  // this group's Q rows
  // issue S = Q K^T of walked tile i into s once its K stage has landed: k
  // step j lies in panel j / KPS at byte 32 (j % KPS) of each row
  auto qk = [&](float(&s)[BK / 2], int i) {
    const int st = i % STAGES;
    mbar_wait(full(st), (i / STAGES) & 1);
    const uint32_t ks = ring + st * C::STAGE;
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
    mbar_arrive(empty(i % STAGES));
    return true;
  };

  mbar_wait(qbar, 0);  // also where no tile is walked: the copy has landed
  if (cur < walk.ntiles) {
    qk(s0, 0);
    wg_wait<0>();
    fence_regs(s0);
    mbar_arrive(empty(0));
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
