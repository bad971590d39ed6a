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
  bf16* out;         // (B, Sq, H*D)
  const int* keep;   // M: (B, nref) int32; F: null
  int H, Sq, Skv, D;
  int nref, span;    // M: nref spans of `span` kv rows; F: 1, 1
  float scale_log2;  // scale * log2(e), > 0
};

// A block of WGM consumer warpgroups (64 query rows each) and a producer
// warpgroup; K/V tiles of BK rows in a ring of STAGES stages; Q and K in
// panels of KPW columns.
template <int DP, int WGM, int BK, int STAGES, int KPW>
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
  static constexpr int STAGE = KBYTES + VBYTES;
  // Q's barrier, then full K, full V, empty K, empty V per stage
  static constexpr int BARS = 8 * (1 + 4 * STAGES);
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
  constexpr int NS = BK / 8;      // S's 8-column accumulator tiles
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
  const int ntiles = (a.Skv + BK - 1) / BK;
  const int* kp = MASKED ? a.keep + b * a.nref : a.keep;
  // the spans of tile t's first and last kv row (M)
  auto first_span = [&](int t) { return t * BK / a.span; };
  auto last_span = [&](int t) {
    return (min(t * BK + BK, a.Skv) - 1) / a.span;
  };
  // does tile t hold a kept kv row (block-uniform)
  auto kept = [&](int t) {
    if constexpr (!STRADDLE) return kp[t / (a.span / BK)] != 0;
    for (int r = first_span(t); r <= last_span(t); ++r)
      if (kp[r]) return true;
    return false;
  };
  // the first tile at or after t that holds a kept row
  auto next_kept = [&](int t) {
    if (MASKED)
      while (t < ntiles && !kept(t)) ++t;
    return t;
  };

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
  auto mask = [&](int t) {
    const int kvalid = a.Skv - t * BK;
    if (kvalid < BK) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * tq + e % 2 >= kvalid) s[4 * j + e] = -INFINITY;
    }
    if (STRADDLE && first_span(t) != last_span(t)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = t * BK + 8 * j + 2 * tq + e;
          if (col < a.Skv && !kp[col / a.span])
            s[4 * j + e] = s[4 * j + e + 2] = -INFINITY;
        }
    }
  };
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

}  // namespace sg_flash
