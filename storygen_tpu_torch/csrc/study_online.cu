// Online-softmax flash-attention forward for Hopper (sm_90a), with the
// knobs of two attention studies in scripts/studies/ as compile-time
// instantiations:
//
//   bench_attn_variants.py _variant_kernel (variant_attention) and
//   bench_attn_v2.py _t_kernel (t_attention): O = softmax(q k^T * scale) v
//   by the running-max recurrence (m starts at -1e30; alpha =
//   exp(m_prev - m_new); l = l alpha + sum p; O = O alpha + bf16(p) v;
//   out = O / max(l, 1e-20)).
//
// The knobs (MODE, BQ, BK, HALVES):
//   MODE 0  scale applied to the logits in the kernel, natural exp
//           (variant_attention fold_scale=False);
//   MODE 1  scale folded into q on the host, natural exp
//           (fold_scale=True, use_exp2=False; t_attention use_exp2=False);
//   MODE 2  scale * log2(e) folded into q on the host, exp2
//           (fold_scale=True, use_exp2=True; t_attention use_exp2=True).
//   BQ, BK  the query and K/V tile rows, 64 or 128 (the studies' bq / bk).
//   HALVES  2 is split2: each warp owns two 16-row halves and issues the
//           second half's Q K^T before the first half's softmax.
// t_attention differs from variant_attention(fold_scale=True) only in the
// TPU's transposed (BH, D, Sq) output, which is not carried over, so the
// two share these instantiations.
//
// What bounds it on the H100: tensor-core work (4 Sq Skv d operations) and
// the per-logit softmax work; the logits never touch HBM.
//
// The design is kernel F's (csrc/flash_fwd.cu), so that the study compares
// forms of the softmax and not copy pipelines:
// - S, P and O live in registers: mma.sync m16n8k16 (bf16 in, fp32
//   accumulation) with ldmatrix fragments; two neighbouring S tiles are
//   P's A fragment (study_mma.cuh). The row max and sum are quad shuffles,
//   the rescale of O a multiply of the warp's own registers.
// - K and V tiles of BK rows arrive through a ring of STAGES shared
//   buffers (ring_stages: 3 where two blocks of them fit an SM, else 2)
//   filled by 16-byte cp.async copies: the next tile's copies are issued
//   before the current tile's Q K^T, one barrier per tile. The copy
//   zero-fills columns past d (d = 40 runs as 48 in shared memory only).
// - Q takes the same path once, into the ring's last stage (the first
//   step refills that stage only after its barrier, when every warp holds
//   its Q fragments in registers).
// Rows are an odd number of 16-byte units apart: ldmatrix is free of bank
// conflicts. Not yet: wgmma and TMA.
#include <math.h>

#include "study_mma.cuh"

using namespace sg_study;

namespace {

constexpr float NEG_INF = -1e30f;

template <int DP, int BQ, int BK, int HALVES>
struct Cfg {
  static constexpr int NT = 32 * BQ / (16 * HALVES);
  static constexpr int PITCH = pitch_bytes(DP * 2);
  static constexpr int CPR = DP * 2 / 16;  // 16-byte chunks per row
  static constexpr int TILE = align128(BK * PITCH);  // one K or V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int STAGES = ring_stages(STAGE);
  static constexpr int BYTES = STAGES * STAGE;
  static_assert(align128(BQ * PITCH) <= STAGE, "Q fits a ring stage");
  static_assert(BYTES <= 232448, "a block's shared memory");
};

template <int MODE>
__device__ __forceinline__ float ex(float x) {
  return MODE == 2 ? exp2f(x) : expf(x);
}

template <int DP, int BQ, int BK, int MODE, int HALVES>
__global__ void __launch_bounds__(Cfg<DP, BQ, BK, HALVES>::NT, 1)
online_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
              int Skv, int d, float scale) {
  using C = Cfg<DP, BQ, BK, HALVES>;
  constexpr int KS = DP / 16, NTK = BK / 8, DT = DP / 8;
  constexpr int STAGES = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int wrow = warp * 16 * HALVES;
  const bf16* kh = k + bh * Skv * d;
  const bf16* vh = v + bh * Skv * d;
  const int ntiles = Skv / BK;
  auto fetch = [&](int t, int stage) {
    unsigned char* st = smem + stage * C::STAGE;
    copy_tile_lean<BK, C::CPR, C::PITCH, C::NT>(st, kh, d, t * BK, Skv, d,
                                                tid);
    copy_tile_lean<BK, C::CPR, C::PITCH, C::NT>(st + C::TILE, vh, d, t * BK,
                                                Skv, d, tid);
  };

  // group 0: Q into the last stage; then one group per stage but the last
  unsigned char* qs = smem + (STAGES - 1) * C::STAGE;
  copy_tile_lean<BQ, C::CPR, C::PITCH, C::NT>(qs, q + bh * Sq * d, d, q0, Sq,
                                              d, tid);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) fetch(s, s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  uint32_t qa[HALVES][KS][4];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
    load_a_bf16<KS>(qa[h], qs + (wrow + 16 * h) * C::PITCH, C::PITCH, lane);
  float o[HALVES][DT][4], m[HALVES][2], l[HALVES][2];
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
    m[h][0] = m[h][1] = NEG_INF;
    l[h][0] = l[h][1] = 0.f;  // this lane's share of the row sum
#pragma unroll
    for (int j = 0; j < DT; ++j) o[h][j][0] = o[h][j][1] = o[h][j][2] =
        o[h][j][3] = 0.f;
  }

  int cs = 0, ls = STAGES - 1;  // ring stages of the tile in use / to fill
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t
    // every thread's copies have landed, and every warp is done with the
    // stage that the copies below overwrite
    __syncthreads();
    if (t + STAGES - 1 < ntiles) fetch(t + STAGES - 1, ls);
    cp_async_commit();
    ls = ls + 1 == STAGES ? 0 : ls + 1;
    const unsigned char* ks = smem + cs * C::STAGE;
    cs = cs + 1 == STAGES ? 0 : cs + 1;

    float s[HALVES][NTK][4];
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
#pragma unroll
      for (int j = 0; j < NTK; ++j)
        s[h][j][0] = s[h][j][1] = s[h][j][2] = s[h][j][3] = 0.f;
      qk_bf16<KS, NTK>(s[h], qa[h], ks, C::PITCH, lane);
    }
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (MODE == 0) s[h][j][e] *= scale;
          mx[e / 2] = fmaxf(mx[e / 2], s[h][j][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[h][r], quad_max(mx[r]));
        alpha[r] = ex<MODE>(m[h][r] - m_new);
        m[h][r] = m_new;
        l[h][r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[h][j][0] *= alpha[0];
        o[h][j][1] *= alpha[0];
        o[h][j][2] *= alpha[1];
        o[h][j][3] *= alpha[1];
      }
      // p, its row sum, its bf16 A fragment and P V, 16 kv rows at a
      // time: a chunk's probabilities die once its products are issued
#pragma unroll
      for (int kk = 0; kk < NTK / 2; ++kk) {
#pragma unroll
        for (int j = 2 * kk; j < 2 * kk + 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex<MODE>(s[h][j][e] - m[h][e / 2]);
            s[h][j][e] = p;
            l[h][e / 2] += p;
          }
        uint32_t p[1][4];
        pack_p16(p[0], s[h][2 * kk], s[h][2 * kk + 1]);
        pv_bf16<1, DT>(o[h], p, ks + C::TILE + 16 * kk * C::PITCH, C::PITCH,
                       lane);
      }
    }
  }

  bf16* ob = out + bh * Sq * d;
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
    store_rows<DT>(ob, q0 + wrow + 16 * h, d, o[h],
                   fmaxf(quad_sum(l[h][0]), 1e-20f),
                   fmaxf(quad_sum(l[h][1]), 1e-20f), lane);
}

template <int DP, int BQ, int BK, int MODE, int HALVES>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   int BH, int Sq, int Skv, int d, float scale,
                   cudaStream_t stream) {
  using C = Cfg<DP, BQ, BK, HALVES>;
  auto kern = online_kernel<DP, BQ, BK, MODE, HALVES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / BQ, BH);
  kern<<<grid, C::NT, C::BYTES, stream>>>(q, k, v, out, Sq, Skv, d, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (BH, S, d) bf16 contiguous, d a multiple of 8; out (BH, Sq, d).
// `scale` is used by MODE 0 only (the other modes take q pre-scaled).
// Sq % bq and Skv % bk must be 0. The instantiations built are the
// SG_BUILT / SG_TILES4 lines below; any other returns cudaErrorInvalidValue.
extern "C" int sg_study_online(const void* q, const void* k, const void* v,
                               void* out, int BH, int Sq, int Skv, int d,
                               int mode, int bq, int bk, int halves,
                               float scale, void* stream) {
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 8 || Sq % bq || Skv % bk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (d + 15) / 16 * 16;
#define SG_BUILT(DP_, BQ_, BK_, MODE_, HALVES_)                            \
  if (dp == DP_ && bq == BQ_ && bk == BK_ && mode == MODE_ &&              \
      halves == HALVES_)                                                   \
    return static_cast<int>(launch<DP_, BQ_, BK_, MODE_, HALVES_>(         \
        Q, K, V, O, BH, Sq, Skv, d, scale, s));
#define SG_TILES4(DP_, MODE_, HALVES_)   \
  SG_BUILT(DP_, 64, 64, MODE_, HALVES_)  \
  SG_BUILT(DP_, 64, 128, MODE_, HALVES_) \
  SG_BUILT(DP_, 128, 64, MODE_, HALVES_) \
  SG_BUILT(DP_, 128, 128, MODE_, HALVES_)
  // the scale in the kernel: variant_attention's "ds" at d = 40
  SG_TILES4(48, 0, 1)
  // scale folded, exp and exp2, at d = 40, 80, 160
  SG_TILES4(48, 1, 1)
  SG_TILES4(80, 1, 1)
  SG_TILES4(160, 1, 1)
  SG_TILES4(48, 2, 1)
  SG_TILES4(80, 2, 1)
  SG_TILES4(160, 2, 1)
  // split2 (folded, exp2) at d = 40
  SG_TILES4(48, 2, 2)
#undef SG_TILES4
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
