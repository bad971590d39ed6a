// Kernel S2 (study_wgmma.cuh) for the max-free kinds without a side input:
// the kernels of the attention studies in scripts/studies/ that shift
// every logit by an a-priori row bound, carried by the extended q/k/v,
// instead of tracking a running maximum. (BND2 and its g-heads form are
// study_bnd2.cu, so that the two sources build in parallel.)
//
// Replaces, as compile-time instantiations of bounded_wg_kernel:
//   TB       bench_attn_v2.py _tb_kernel (tb_attention): p = exp2(s) on
//            q_ext = [q * scale * log2(e), -b], k_ext = [k, 1], with
//            b = |q| max_j |k_j|; v_ext = [v, 1], so the ones column of the
//            accumulator is the row sum of the bf16-rounded p; out = acc[:d]
//            / max(acc[d], 1e-30). Also bench_attn_ablate.py _ablate_kernel
//            with do_exp and do_pv on (the same function, computed the same
//            way), and with halves = 2 (HALVES below).
//   BOUNDED  bench_attn_scan.py _bounded_kernel (bounded_attention): as TB
//            with natural exp on scale-only logits, guard 1e-20; with SUB
//            K/V sub-tiles per step, _bounded_multi_kernel
//            (bounded_multi_attention).
//   QK, QK_EXP, QK_PV
//            _ablate_kernel with do_exp / do_pv off: p = s without exp2;
//            without do_pv the output is the kv sum of p (fp32) broadcast
//            over d.
// The TPU layouts (the transposed (BH, D, Sq) output, the 8-sublane bound
// rows, dimension_semantics) are not carried over: out is (BH, Sq, d).
//
// What bounds it on the H100: as kernel F, the exps at d = 40 (one a
// logit at 16 a clock per SM against 192 tensor-core operations a logit
// at the 48 columns of the extended head), tensor-core work (4 Sq Skv W
// operations) at d = 80 and 160; the logits never touch HBM. The point
// of the max-free form is that without a running maximum the output
// needs no per-tile rescale: O is a plain sum over the K/V tiles. The
// ablations split that time: QK is the products alone, QK_EXP the
// products and the exps, QK_PV both products without the exps.
//
// The design is kernel F's (flash_wgmma.cuh), so that the study compares
// forms of the softmax and not copy pipelines: a producer warpgroup lands
// Q and the K/V tiles by TMA into F's ring; consumer warpgroups of 64
// query rows issue S = Q K^T and O += P V by wgmma, with p formed in the
// S registers; study_wgmma.cuh says how each kind and knob runs on it.
// The operands are (BH, S, W) seen as F's (D, H, S, B) tensor map with H
// = 1, W = pad8(d + 1) = 48, 88 or 168 columns in HBM; TMA's zero fill
// past W makes the 48, 96 and 176 columns of the products in shared
// memory only (the wgmma N of P V is 96 or 176 there, 6 or 11 k steps of
// Q K^T). Stages and Q / K panel columns are F's line at the same (width,
// ring rows) where F has one and the line walks as F does
// (ops/flash_attention.py FWD_BUILT), else the deepest ring of at most 4
// stages that fits a block's shared memory at the widest panel (64, 32 or
// 16 columns) that lets one fit (ops/study_attention.py::study_line).
// split2 and QK / QK_EXP (kernel L's walk) issue the next tile's Q K^T a
// step ahead of F's walk and take the deeper ring.
#include "study_wgmma.cuh"

using namespace sg_flash;

// q, k, v: (BH, S, W) bf16 contiguous, W a multiple of 8 (d + 1 padded
// for the extended kinds, d for BND2); bound: (BH, Sq) fp32 (BND2) or
// NULL; out: (BH, Sq, d) bf16. Sq % bq, Skv % (bk * sub) and BH % g must
// be 0 (checked by the caller and again here). The instantiations built
// are the SG_BUILT lines below, (16-padded W, bq, bk, sub, halves, g,
// kind, ring stages, Q / K panel columns), mirrored by
// ops/study_attention.py::BOUNDED_BUILT; any other returns
// cudaErrorInvalidValue.
extern "C" int sg_study_bounded(const void* q, const void* k, const void* v,
                                const void* bound, void* out, int BH, int Sq,
                                int Skv, int W, int d, int kind, int bq,
                                int bk, int sub, int halves, int g,
                                float guard, void* stream) {
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  const float* BND = static_cast<const float*>(bound);
  bf16* O = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 8 || d > W || d % 2 || Sq % bq || Skv % (bk * sub) || BH % g ||
      BH / g > 65535 || (kind == BND2) != (BND != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (W + 15) / 16 * 16;
#define SG_BUILT(DP_, BQ_, BK_, SUB_, HALVES_, G_, KIND_, STAGES_, KPW_)     \
  if (dp == DP_ && bq == BQ_ && bk == BK_ && sub == SUB_ &&                 \
      halves == HALVES_ && g == G_ && kind == KIND_)                        \
    return static_cast<int>(                                                \
        bounded_wg_launch<DP_, BQ_, BK_, SUB_, HALVES_, G_, KIND_, STAGES_,  \
                          KPW_>(Q, K, V, BND, O, BH, Sq, Skv, W, d, guard, s));
  // tb_attention (and ablate_attention with do_exp, do_pv, halves 1) at
  // d = 40, 80, 160 (d + 1 padded to 48, 96, 176)
  SG_BUILT(48, 64, 64, 1, 1, 1, TB, 4, 64)
  SG_BUILT(48, 64, 128, 1, 1, 1, TB, 2, 64)
  SG_BUILT(48, 128, 64, 1, 1, 1, TB, 4, 64)
  SG_BUILT(48, 128, 128, 1, 1, 1, TB, 2, 64)
  SG_BUILT(96, 64, 64, 1, 1, 1, TB, 4, 32)
  SG_BUILT(96, 64, 128, 1, 1, 1, TB, 4, 32)
  SG_BUILT(96, 128, 64, 1, 1, 1, TB, 4, 32)
  SG_BUILT(96, 128, 128, 1, 1, 1, TB, 4, 32)
  SG_BUILT(176, 64, 64, 1, 1, 1, TB, 4, 32)
  SG_BUILT(176, 64, 128, 1, 1, 1, TB, 2, 32)
  SG_BUILT(176, 128, 64, 1, 1, 1, TB, 3, 32)
  SG_BUILT(176, 128, 128, 1, 1, 1, TB, 2, 16)
  // bounded_attention at d = 40, 80
  SG_BUILT(48, 64, 64, 1, 1, 1, BOUNDED, 4, 64)
  SG_BUILT(48, 64, 128, 1, 1, 1, BOUNDED, 2, 64)
  SG_BUILT(48, 128, 64, 1, 1, 1, BOUNDED, 4, 64)
  SG_BUILT(48, 128, 128, 1, 1, 1, BOUNDED, 2, 64)
  SG_BUILT(96, 64, 64, 1, 1, 1, BOUNDED, 4, 32)
  SG_BUILT(96, 64, 128, 1, 1, 1, BOUNDED, 4, 32)
  SG_BUILT(96, 128, 64, 1, 1, 1, BOUNDED, 4, 32)
  SG_BUILT(96, 128, 128, 1, 1, 1, BOUNDED, 4, 32)
  // bounded_multi_attention: 2 or 4 sub-tiles of 64 kv rows
  SG_BUILT(48, 64, 64, 2, 1, 1, BOUNDED, 2, 64)
  SG_BUILT(48, 64, 64, 4, 1, 1, BOUNDED, 3, 64)
  SG_BUILT(48, 128, 64, 2, 1, 1, BOUNDED, 2, 64)
  SG_BUILT(48, 128, 64, 4, 1, 1, BOUNDED, 3, 64)
  SG_BUILT(96, 64, 64, 2, 1, 1, BOUNDED, 4, 32)
  SG_BUILT(96, 64, 64, 4, 1, 1, BOUNDED, 2, 32)
  SG_BUILT(96, 128, 64, 2, 1, 1, BOUNDED, 4, 32)
  SG_BUILT(96, 128, 64, 4, 1, 1, BOUNDED, 2, 32)
  // ablate_attention's other modes at d = 40, and halves 2
  SG_BUILT(48, 64, 64, 1, 1, 1, QK, 4, 64)
  SG_BUILT(48, 128, 128, 1, 1, 1, QK, 4, 64)
  SG_BUILT(48, 64, 64, 1, 1, 1, QK_EXP, 4, 64)
  SG_BUILT(48, 128, 128, 1, 1, 1, QK_EXP, 4, 64)
  SG_BUILT(48, 64, 64, 1, 1, 1, QK_PV, 4, 64)
  SG_BUILT(48, 128, 128, 1, 1, 1, QK_PV, 2, 64)
  SG_BUILT(48, 64, 64, 1, 2, 1, TB, 4, 64)
  SG_BUILT(48, 128, 128, 1, 2, 1, TB, 4, 64)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
