// Kernel S2 (study_wgmma.cuh) with the row bound as a side input: BND2,
// one head a block or g heads a block. (The kinds with the bound in the
// extended q/k/v are study_bounded.cu, so that the two sources build in
// parallel.)
//
// Replaces, as compile-time instantiations of bounded_wg_kernel:
//   BND2     bench_attn_bnd2.py _bnd2_kernel (bnd2_attention): plain q/k/v,
//            the mean-centred bound as an fp32 side input, p = exp2(s - b),
//            the row sum taken in fp32 from the unrounded p, guard 1e-30;
//            with G heads per block, bench_attn_multihead.py _mh_kernel
//            (mh_attention).
// The TPU layouts (the transposed (BH, D, Sq) output, the 8-sublane bound
// rows, dimension_semantics) are not carried over: out is (BH, Sq, d).
//
// What bounds it on the H100: as kernel F (the exps at d = 40, tensor-core
// work at d = 160); the logits never touch HBM.
//
// The design is kernel F's (flash_wgmma.cuh): fw_block with the max-free
// step as its policy, the bound read once a row. With G heads a block
// (the small-sequence shapes, whose grids are small) the block walks its
// heads in turn, one head's registers and one ring at any G; the ring
// runs on across heads and Q has two slots, so a head boundary costs no
// refill of the ring. Side by side, G heads would need G heads' K/V in
// every stage. At d = 80 and 160 two consumer warpgroups share the 64
// rows, each taking half of every tile's kv rows (S of N 32), and merge O
// and the row sums through shared memory at the head's end; not at d =
// 40, where half a tile is too little work to pay for the finer split.
// Stages and panels as study_bounded.cu says.
#include "study_wgmma.cuh"

using namespace sg_flash;

// q, k, v: (BH, S, W) bf16 contiguous, W a multiple of 8 (= d here); bound: (BH, Sq) fp32 (BND2) or
// NULL; out: (BH, Sq, d) bf16. Sq % bq, Skv % (bk * sub) and BH % g must
// be 0 (checked by the caller and again here). The instantiations built
// are the SG_BUILT lines below, (16-padded W, bq, bk, sub, halves, g,
// kind, ring stages, Q / K panel columns), mirrored by
// ops/study_attention.py::BOUNDED_BUILT; any other returns
// cudaErrorInvalidValue.
extern "C" int sg_study_bnd2(const void* q, const void* k, const void* v,
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
  // bnd2_attention at d = 40, 80
  SG_BUILT(48, 64, 64, 1, 1, 1, BND2, 4, 64)
  SG_BUILT(48, 64, 128, 1, 1, 1, BND2, 2, 64)
  SG_BUILT(48, 128, 64, 1, 1, 1, BND2, 4, 64)
  SG_BUILT(48, 128, 128, 1, 1, 1, BND2, 2, 64)
  SG_BUILT(80, 64, 64, 1, 1, 1, BND2, 4, 64)
  SG_BUILT(80, 64, 128, 1, 1, 1, BND2, 2, 64)
  SG_BUILT(80, 128, 64, 1, 1, 1, BND2, 4, 64)
  SG_BUILT(80, 128, 128, 1, 1, 1, BND2, 2, 64)
  // mh_attention: g heads a block, walked in turn
  SG_BUILT(48, 64, 64, 1, 1, 2, BND2, 4, 64)
  SG_BUILT(48, 64, 64, 1, 1, 4, BND2, 4, 64)
  SG_BUILT(48, 64, 64, 1, 1, 8, BND2, 4, 64)
  SG_BUILT(80, 64, 64, 1, 1, 2, BND2, 4, 64)
  SG_BUILT(80, 64, 64, 1, 1, 4, BND2, 4, 64)
  SG_BUILT(80, 64, 64, 1, 1, 8, BND2, 4, 64)
  SG_BUILT(160, 64, 64, 1, 1, 2, BND2, 2, 32)
  SG_BUILT(160, 64, 64, 1, 1, 4, BND2, 2, 32)
  SG_BUILT(160, 64, 64, 1, 1, 8, BND2, 2, 32)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
