// Flash-attention forward for Hopper (sm_90a): O = softmax(Q K^T * scale) V,
// kernels F (unmasked) and M (masked), one template.
//
// Replaces the forward variants of the TPU kernel in
// storygen_tpu/ops/pallas_attention.py, reached through _flash_core:
// _bnd_kernel :83, _bnd2_kernel :124, _online_t_kernel :163 and
// _flash_kernel :208 (F), and their masked forms _bnd_masked_kernel :118,
// _bnd2_masked_kernel :157, _online_t_masked_kernel :202 and
// _masked_kernel :251 (M). The TPU's per-row bound with its 120-unit exp2
// clamp and the transposed "bhds" output layout are TPU workarounds and are
// not carried over: this is the exact online softmax.
//
// What bounds it on the H100: tensor-core work, 4 Sq Skv d operations per
// head, and beside it one exp2 per logit on the special-function units. At
// the UNet's 4096 x 4096 (attn1) and 4096 x 12288 (attn3) shapes the logits
// are 16-48x larger than Q, K, V and O together, so a kernel that never
// writes them to HBM is not bound by HBM.
//
// What the design does about it:
// - S, P and O live in registers. Each warp owns HALVES 16-row slices of
//   the block's BQ query rows; S = Q K^T and O += P V are mma.sync m16n8k16
//   products (bf16 in, fp32 accumulation) with ldmatrix fragment loads, and
//   S's accumulators, rounded to bf16 pairs, are P's A fragments
//   (study_mma.cuh). The row max and sum are quad shuffles, the rescale of O
//   a multiply of the warp's own registers. With two halves a warp starts
//   the second half's Q K^T before the first half's softmax.
// - K and V tiles of BK = 64 rows arrive through a ring of STAGES shared
//   buffers filled by cp.async 16-byte copies: the copies of the next tile
//   start before the current tile's Q K^T, so they overlap it. The
//   copy zero-fills rows past Skv and columns past D itself (src-size 0,
//   reading nothing), so head dim 40 runs as 48 in shared memory only. Q
//   takes the same path once and then stays in registers. Rows are an odd
//   number of 16-byte units apart, so ldmatrix is free of bank conflicts.
// - The scale stays in the kernel: p = exp2(s * scale log2(e) - m) is one
//   FFMA and one exp2 per logit, with m kept in the scaled log2 domain
//   (scale > 0, checked by the launcher).
//
// The contract: Q, K and V are read straight from the projections'
// (B, S, H*D) layout through batch and row strides (a split k|v view needs
// no copy), and O is written as (B, Sq, H*D) in bf16: the head merge is
// free. Ragged Sq and Skv (attn2's 77-token text kv): rows past Sq are not
// written, kv columns past Skv become -inf logits. For M the kv is N equal
// reference spans of any length and `keep` (B, N) says which spans a batch
// row may attend to. The ring walks from one tile that holds a kept row to
// the next: a tile wholly inside dropped spans costs neither a copy nor a
// wait. Where a span is a multiple of BK (the 512 px UNet) a flag holds
// for a whole tile and the instantiation with STRADDLE = false does no
// per-column work; otherwise (16 or 144 tokens at the mid block of a 256
// or 768 px image) a tile that straddles a span boundary sets the logits
// of its dropped columns to -inf in the S registers, as the ragged last
// tile does past Skv. A row whose running max is still -inf takes alpha =
// 0, and a row that kept no span writes zeros.
//
// Not yet: wgmma, TMA and warp specialisation.
#include <math.h>

#include "study_mma.cuh"

using namespace sg_study;

namespace {

// rows of a K/V tile
constexpr int BK = 64;

template <int DP, int BQ, int HALVES, int STAGES>
struct Cfg {
  static constexpr int NT = 32 * BQ / (16 * HALVES);  // threads
  static constexpr int PITCH = pitch_bytes(DP * 2);
  static constexpr int CPR = DP * 2 / 16;  // 16-byte chunks per row
  static constexpr int QBYTES = align128(BQ * PITCH);
  static constexpr int TILE = align128(BK * PITCH);  // one K or V tile
  static constexpr int BYTES = QBYTES + STAGES * 2 * TILE;
};

template <int DP, int BQ, int HALVES, int STAGES, bool MASKED, bool STRADDLE>
__global__ void __launch_bounds__(Cfg<DP, BQ, HALVES, STAGES>::NT)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                 int Sq, int Skv, int D, long long qb, long long qr,
                 long long kb, long long kr, long long vb, long long vr,
                 const int* __restrict__ keep, int nref, int span,
                 float scale_log2) {
  using C = Cfg<DP, BQ, HALVES, STAGES>;
  constexpr int KS = DP / 16, NTK = BK / 8, DT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + C::QBYTES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int wrow = warp * 16 * HALVES;  // this warp's first row in the tile
  const bf16* qh = q + b * qb + (long long)h * D;
  const bf16* kh = k + b * kb + (long long)h * D;
  const bf16* vh = v + b * vb + (long long)h * D;
  const int ntiles = (Skv + BK - 1) / BK;
  const int* kp = MASKED ? keep + b * nref : keep;
  const int tps = span / BK;  // tiles per reference span (M, aligned)
  // the spans of tile t's first and last kv row (M, STRADDLE)
  auto first_span = [&](int t) { return t * BK / span; };
  auto last_span = [&](int t) { return (min(t * BK + BK, Skv) - 1) / span; };
  // does tile t hold a kept kv row (block-uniform)
  auto kept = [&](int t) {
    if constexpr (!STRADDLE) return kp[t / tps] != 0;
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
  auto fetch = [&](int t, int stage) {
    unsigned char* ks = ring + stage * 2 * C::TILE;
    copy_tile<BK, C::CPR, C::PITCH, C::NT>(ks, kh, kr, t * BK, Skv, D, tid);
    copy_tile<BK, C::CPR, C::PITCH, C::NT>(ks + C::TILE, vh, vr, t * BK, Skv,
                                           D, tid);
  };

  // group 0: Q; then one group per ring stage but the last
  copy_tile<BQ, C::CPR, C::PITCH, C::NT>(smem, qh, qr, q0, Sq, D, tid);
  cp_async_commit();
  int ld = next_kept(0);  // the next tile to copy
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (ld < ntiles) {
      fetch(ld, s);
      ld = next_kept(ld + 1);
    }
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  uint32_t qa[HALVES][KS][4];
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
    load_a_bf16<KS>(qa[hh], smem + (wrow + 16 * hh) * C::PITCH, C::PITCH,
                    lane);

  // per half: O, the running max (scaled, log2 domain) and this lane's
  // share of the row sum, for rows grp and grp + 8
  float acc[HALVES][DT][4], m[HALVES][2], l[HALVES][2];
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh) {
    m[hh][0] = m[hh][1] = -INFINITY;
    l[hh][0] = l[hh][1] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      acc[hh][j][0] = acc[hh][j][1] = acc[hh][j][2] = acc[hh][j][3] = 0.f;
  }

  int cs = 0, ls = STAGES - 1;  // ring stages of the tile in use / to fill
  for (int cur = next_kept(0); cur < ntiles; cur = next_kept(cur + 1)) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile `cur`
    // every thread's copies have landed, and every warp is done with the
    // stage that the copies below overwrite
    __syncthreads();
    if (ld < ntiles) {
      fetch(ld, ls);
      ld = next_kept(ld + 1);
    }
    cp_async_commit();
    ls = ls + 1 == STAGES ? 0 : ls + 1;
    const unsigned char* ks = ring + cs * 2 * C::TILE;
    cs = cs + 1 == STAGES ? 0 : cs + 1;

    float s[HALVES][NTK][4];
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) {
#pragma unroll
      for (int j = 0; j < NTK; ++j)
        s[hh][j][0] = s[hh][j][1] = s[hh][j][2] = s[hh][j][3] = 0.f;
      qk_bf16<KS, NTK>(s[hh], qa[hh], ks, C::PITCH, lane);
    }
    const int kvalid = Skv - cur * BK;
    if (kvalid < BK) {  // the ragged last tile: columns past Skv
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
        for (int j = 0; j < NTK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * (lane % 4) + e % 2 >= kvalid)
              s[hh][j][e] = -INFINITY;
    }
    if (STRADDLE && first_span(cur) != last_span(cur)) {
      // a tile across a span boundary: its columns in dropped spans
#pragma unroll
      for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = cur * BK + 8 * j + 2 * (lane % 4) + e;
          if (col < Skv && !kp[col / span])
#pragma unroll
            for (int hh = 0; hh < HALVES; ++hh)
              s[hh][j][e] = s[hh][j][e + 2] = -INFINITY;
        }
    }

#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[hh][j][e]);
      float alpha[2], neg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // finite: a processed tile holds at least one kept column, and
        // keep is per batch row, so every query row sees it
        const float m_new = fmaxf(m[hh][r], quad_max(mx[r]) * scale_log2);
        // the row's first processed tile: nothing to rescale (and never
        // exp2(-inf - -inf))
        alpha[r] =
            m[hh][r] == -INFINITY ? 0.f : fast_exp2(m[hh][r] - m_new);
        m[hh][r] = m_new;
        l[hh][r] *= alpha[r];
        neg[r] = -m_new;
      }
#pragma unroll
      for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              fast_exp2(fmaf(s[hh][j][e], scale_log2, neg[e / 2]));
          s[hh][j][e] = p;
          l[hh][e / 2] += p;
        }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[hh][j][0] *= alpha[0];
        acc[hh][j][1] *= alpha[0];
        acc[hh][j][2] *= alpha[1];
        acc[hh][j][3] *= alpha[1];
      }
      uint32_t p[NTK / 2][4];
      pack_p<NTK>(p, s[hh]);
      pv_bf16<NTK / 2, DT>(acc[hh], p, ks + C::TILE, C::PITCH, lane);
    }
  }

  // O / l into (B, Sq, H*D); l = 0: the row kept no span, write zeros
  const int grp = lane / 4, tq = lane % 4;
  const long long ors = (long long)H * D;
  bf16* ob = o + (long long)b * Sq * ors + (long long)h * D;
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float den = quad_sum(l[hh][r]);
      const float inv = den > 0.f ? 1.f / den : 0.f;
      const int row = q0 + wrow + 16 * hh + grp + 8 * r;
      if (row < Sq) {
        bf16* orow = ob + row * ors;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const int c = 8 * j + 2 * tq;
          if (c < D)
            *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(
                acc[hh][j][2 * r] * inv, acc[hh][j][2 * r + 1] * inv);
        }
      }
    }
}

template <int DP, int BQ, int HALVES, int STAGES, bool MASKED, bool STRADDLE>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   int B, int H, int Sq, int Skv, int D, long long qb,
                   long long qr, long long kb, long long kr, long long vb,
                   long long vr, const int* keep, int nref, int span,
                   float scale_log2, cudaStream_t stream) {
  using C = Cfg<DP, BQ, HALVES, STAGES>;
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static_assert(BQ % (16 * HALVES) == 0, "whole 16-row slices per warp");
  auto kern = flash_fwd_kernel<DP, BQ, HALVES, STAGES, MASKED, STRADDLE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, C::NT, C::BYTES, stream>>>(q, k, v, o, H, Sq, Skv, D, qb, qr,
                                          kb, kr, vb, vr, keep, nref, span,
                                          scale_log2);
  return cudaGetLastError();
}

}  // namespace

// keep == nullptr: kernel F; otherwise kernel M with keep (B, nref) int32
// over nref spans of `span` kv rows, nref * span == Skv. D a multiple of 8,
// scale > 0. The instantiations built are the SG_BUILT lines below, one
// per (16-padded head dim, masked), mirrored by FWD_BUILT in
// ops/flash_attention.py; any other returns cudaErrorInvalidValue. A masked
// line builds M twice: for spans that are a multiple of BK and for the
// rest (STRADDLE), chosen here.
extern "C" int sg_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int Sq, int Skv, int D,
                            long long qb, long long qr, long long kb,
                            long long kr, long long vb, long long vr,
                            const void* keep, int nref, int span,
                            float scale, void* stream) {
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(o);
  const int* KEEP = static_cast<const int*>(keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int masked = KEEP != nullptr;
  if (D % 8 || !(scale > 0.f) ||
      (masked && (span <= 0 || nref * span != Skv)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!masked) {
    nref = 1;
    span = 1;
  }
  const bool straddle = masked && span % BK != 0;
  const int dp = (D + 15) / 16 * 16;
#define SG_BUILT(DP_, MASKED_, BQ_, BK_, HALVES_, STAGES_)                  \
  if (dp == DP_ && masked == MASKED_) {                                     \
    static_assert(BK_ == BK, "one K/V tile height");                        \
    if (straddle)                                                           \
      return static_cast<int>(                                              \
          launch<DP_, BQ_, HALVES_, STAGES_, (MASKED_ != 0),                \
                 (MASKED_ != 0)>(Q, K, V, O, B, H, Sq, Skv, D, qb, qr, kb,  \
                                 kr, vb, vr, KEEP, nref, span, sl2, s));    \
    return static_cast<int>(                                                \
        launch<DP_, BQ_, HALVES_, STAGES_, (MASKED_ != 0), false>(          \
            Q, K, V, O, B, H, Sq, Skv, D, qb, qr, kb, kr, vb, vr, KEEP,     \
            nref, span, sl2, s));                                           \
  }
  // (padded head dim, masked, BQ, BK, halves per warp, ring stages): the
  // UNet's head dims 40 (padded to 48), 80 and 160
  SG_BUILT(48, 0, 128, 64, 2, 2)
  SG_BUILT(48, 1, 128, 64, 2, 2)
  SG_BUILT(80, 0, 64, 64, 1, 2)
  SG_BUILT(80, 1, 128, 64, 2, 2)
  SG_BUILT(160, 0, 64, 64, 1, 2)
  SG_BUILT(160, 1, 64, 64, 1, 2)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
