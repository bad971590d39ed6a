// Kernel S1: the online-softmax flash-attention forward for Hopper
// (sm_90a), with the knobs of two attention studies in scripts/studies/ as
// compile-time instantiations:
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
//   BQ, BK  the query and K/V tile rows, 64 or 128 (the studies' bq / bk):
//           BQ / 64 consumer warpgroups (a wgmma's 64 rows each), BK the
//           N of S = Q K^T.
//   HALVES  2 is split2: on the TPU, the next rows' Q K^T in flight while
//           the current rows' exps run. A warpgroup's rows are one wgmma's
//           64, so bq 64 has no second row half to put in flight; the knob
//           keeps the question (a second Q K^T in flight inside one
//           warpgroup while its exps run) at every bq by holding two S
//           accumulator sets, as kernel L does: the next K/V tile's S is
//           issued into one before the softmax of the current tile's S in
//           the other (fw_consume_ahead).
// t_attention differs from variant_attention(fold_scale=True) only in the
// TPU's transposed (BH, D, Sq) output, which is not carried over, so the
// two share these instantiations.
//
// What bounds it on the H100: the exps at d = 40 (one a logit, 16 a clock
// per SM, against 192 tensor-core operations a logit at the padded 48),
// even at d = 80, tensor-core work (4 Sq Skv d operations) at d = 160;
// the logits never touch HBM.
//
// The design is kernel F's (flash_wgmma.cuh), so that the study compares
// forms of the softmax and not copy pipelines: fw_block with this file's
// softmax step as its policy. A producer warpgroup issues every TMA copy
// (Q once, the K/V tiles into a ring of STAGES stages with full and empty
// mbarriers); each consumer warpgroup issues S_j = Q K_j^T (wgmma, both
// operands in shared memory) with O += P_{j-1} V_{j-1} (wgmma, P from its
// registers), takes the softmax of S_j while P V runs, then rescales O and
// rounds P_j. Operands are (BH, S, d) seen as F's (D, H, S, B) tensor map
// with H = 1; TMA's zero fill past d pads d = 40 to the 48 columns of the
// products in shared memory only. Stages and Q / K panel columns are
// F's line at the same (width, BK) where F has one (ops/flash_attention.py
// FWD_BUILT), else the deepest ring of at most 4 stages that fits a
// block's shared memory (ops/study_attention.py::study_line). split2 takes
// the deeper ring even where F has a line: it needs K_{j+1} a step before
// F's walk does, and on F's two stages each step waited for that copy.
#include <math.h>

#include "flash_wgmma.cuh"

using namespace sg_flash;

namespace {

// exp2 as F takes it (ex2.approx.ftz on the special-function unit), or
// the natural exp on the same unit, of x log2(e)
template <int MODE>
__device__ __forceinline__ float ex(float x) {
  return MODE == 2 ? fast_exp2(x) : fast_exp(x);
}

// The study's softmax step: the running max starts at -1e30 (so the first
// tile's alpha is exp(-1e30 - m) = 0), natural exp (MODE 0, 1) or exp2
// (MODE 2) of the shifted logit, the scale multiplied into the logits in
// the kernel for MODE 0; out = O / max(l, 1e-20).
template <int MODE>
struct OnlineSoftmax {
  static constexpr bool RESCALE = true;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float scale;
  __device__ OnlineSoftmax(const FwArgs& a, int, int) : scale(a.scale) {}
  template <int N>
  __device__ void step(float (&s)[N], float (&alpha)[2]) {
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (MODE == 0) s[i] *= scale;
      mx[i % 4 / 2] = fmaxf(mx[i % 4 / 2], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = ex<MODE>(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float p = ex<MODE>(s[i] - m[i % 4 / 2]);
      s[i] = p;
      l[i % 4 / 2] += p;
    }
  }
  template <int R>
  __device__ float inv(int r, const float (&)[R], const FwArgs&) const {
    return 1.f / fmaxf(quad_sum(l[r]), 1e-20f);
  }
};

// grid (Sq / BQ, 1, BH)
template <int DP, int WGM, int BK, int STAGES, int KPW, int MODE, int HALVES>
__global__ void __launch_bounds__(128 * WGM + 128, 1)
    online_wg_kernel(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv,
                     const FwArgs a) {
  using C = FwCfg<DP, WGM, BK, STAGES, KPW>;
  fw_block<C, false, HALVES == 2, OnlineSoftmax<MODE>>(
      &tmq, &tmk, &tmv, a, DenseWalk{a.Skv / BK}, 0, blockIdx.z,
      blockIdx.x * C::BQ);
}

template <int DP, int BQ, int BK, int STAGES, int KPW, int MODE, int HALVES>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   int BH, int Sq, int Skv, int d, float scale,
                   cudaStream_t stream) {
  static_assert(BQ % 64 == 0, "64 query rows a consumer warpgroup");
  using C = FwCfg<DP, BQ / 64, BK, STAGES, KPW>;
  CUtensorMap tq, tk, tv;
  if (!encode_operand(&tq, q, BH, 1, Sq, d, (long long)Sq * d, d, KPW, BQ) ||
      !encode_operand(&tk, k, BH, 1, Skv, d, (long long)Skv * d, d, KPW,
                      BK) ||
      !encode_operand(&tv, v, BH, 1, Skv, d, (long long)Skv * d, d, C::VPW,
                      BK))
    return cudaErrorInvalidValue;
  FwArgs a = {};
  a.out = out;
  a.H = 1;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = d;
  a.nref = a.span = 1;
  a.scale = scale;
  constexpr auto kern =
      online_wg_kernel<DP, BQ / 64, BK, STAGES, KPW, MODE, HALVES>;
  cudaError_t err = smem_limit_once<kern>(C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / BQ, 1, BH);
  kern<<<grid, C::NT, C::BYTES, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (BH, S, d) bf16 contiguous, d a multiple of 8; out (BH, Sq, d).
// `scale` is used by MODE 0 only (the other modes take q pre-scaled).
// Sq % bq and Skv % bk must be 0. The instantiations built are the
// SG_BUILT lines below, (16-padded d, bq, bk, mode, halves, ring stages,
// Q / K panel columns), mirrored by ops/study_attention.py::ONLINE_BUILT;
// any other returns cudaErrorInvalidValue.
extern "C" int sg_study_online(const void* q, const void* k, const void* v,
                               void* out, int BH, int Sq, int Skv, int d,
                               int mode, int bq, int bk, int halves,
                               float scale, void* stream) {
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 8 || Sq % bq || Skv % bk || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (d + 15) / 16 * 16;
#define SG_BUILT(DP_, BQ_, BK_, MODE_, HALVES_, STAGES_, KPW_)             \
  if (dp == DP_ && bq == BQ_ && bk == BK_ && mode == MODE_ &&              \
      halves == HALVES_)                                                   \
    return static_cast<int>(                                               \
        launch<DP_, BQ_, BK_, STAGES_, KPW_, MODE_, HALVES_>(              \
            Q, K, V, O, BH, Sq, Skv, d, scale, s));
  // the scale in the kernel: variant_attention's "ds" at d = 40
  SG_BUILT(48, 64, 64, 0, 1, 4, 64)
  SG_BUILT(48, 64, 128, 0, 1, 2, 64)
  SG_BUILT(48, 128, 64, 0, 1, 4, 64)
  SG_BUILT(48, 128, 128, 0, 1, 2, 64)
  // scale folded, exp and exp2, at d = 40, 80, 160
  SG_BUILT(48, 64, 64, 1, 1, 4, 64)
  SG_BUILT(48, 64, 128, 1, 1, 2, 64)
  SG_BUILT(48, 128, 64, 1, 1, 4, 64)
  SG_BUILT(48, 128, 128, 1, 1, 2, 64)
  SG_BUILT(80, 64, 64, 1, 1, 4, 64)
  SG_BUILT(80, 64, 128, 1, 1, 2, 64)
  SG_BUILT(80, 128, 64, 1, 1, 4, 64)
  SG_BUILT(80, 128, 128, 1, 1, 2, 64)
  SG_BUILT(160, 64, 64, 1, 1, 2, 32)
  SG_BUILT(160, 64, 128, 1, 1, 2, 32)
  SG_BUILT(160, 128, 64, 1, 1, 2, 32)
  SG_BUILT(160, 128, 128, 1, 1, 2, 32)
  SG_BUILT(48, 64, 64, 2, 1, 4, 64)
  SG_BUILT(48, 64, 128, 2, 1, 2, 64)
  SG_BUILT(48, 128, 64, 2, 1, 4, 64)
  SG_BUILT(48, 128, 128, 2, 1, 2, 64)
  SG_BUILT(80, 64, 64, 2, 1, 4, 64)
  SG_BUILT(80, 64, 128, 2, 1, 2, 64)
  SG_BUILT(80, 128, 64, 2, 1, 4, 64)
  SG_BUILT(80, 128, 128, 2, 1, 2, 64)
  SG_BUILT(160, 64, 64, 2, 1, 2, 32)
  SG_BUILT(160, 64, 128, 2, 1, 2, 32)
  SG_BUILT(160, 128, 64, 2, 1, 2, 32)
  SG_BUILT(160, 128, 128, 2, 1, 2, 32)
  // split2 (folded, exp2) at d = 40
  SG_BUILT(48, 64, 64, 2, 2, 4, 64)
  SG_BUILT(48, 64, 128, 2, 2, 4, 64)
  SG_BUILT(48, 128, 64, 2, 2, 4, 64)
  SG_BUILT(48, 128, 128, 2, 2, 4, 64)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
