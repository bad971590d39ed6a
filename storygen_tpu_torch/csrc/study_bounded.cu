// Max-free ("bounded") flash-attention forward for Hopper (sm_90a): the
// kernels of the attention studies in scripts/studies/ that shift every
// logit by an a-priori row bound instead of tracking a running maximum.
//
// Replaces, as compile-time instantiations of one kernel (KIND below):
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
//   BND2     bench_attn_bnd2.py _bnd2_kernel (bnd2_attention): plain q/k/v,
//            the mean-centred bound as an fp32 side input, p = exp2(s - b),
//            the row sum taken in fp32 from the unrounded p, guard 1e-30;
//            with G heads per block, bench_attn_multihead.py _mh_kernel
//            (mh_attention).
// The TPU layouts (the transposed (BH, D, Sq) output, the 8-sublane bound
// rows, dimension_semantics) are not carried over: out is (BH, Sq, d).
//
// What bounds it on the H100: the same tensor-core work as the exact
// forward (4 Sq Skv d operations); the logits never touch HBM. The point
// of the max-free form is that without a running maximum the output needs
// no per-tile rescale, so each warp keeps its O accumulators in registers
// across all K/V tiles (the online forward, kernel F, keeps O in shared
// memory and rescales it every tile). S stays in registers too: two
// neighbouring S accumulator tiles are the A fragment of P V.
//
// Design: one block per (BQ query rows, G heads); each warp owns 16 rows
// (two 16-row halves with HALVES = 2, whose Q K^T products are all issued
// before either half's exp) of one head. Q is staged once through shared
// memory into registers; each step copies SUB K/V tiles of BK rows per
// head into shared memory (the same bytes the Q stage used) and issues
// every sub-tile's Q K^T before the first exp. Rows are zero-padded to a
// multiple of 16 columns in shared memory only (the extended widths d + 1
// arrive padded to a multiple of 8 in HBM). mma.sync m16n8k16 bf16 with
// fp32 accumulation; no cp.async, TMA or wgmma yet.
#include <math.h>

#include "study_mma.cuh"

using namespace sg_study;

namespace {

enum Kind { TB = 0, BOUNDED = 1, QK = 2, QK_EXP = 3, QK_PV = 4, BND2 = 5 };

template <int DP, int BQ, int BK, int SUB, int HALVES, int G>
struct Cfg {
  static constexpr int WPH = BQ / (16 * HALVES);  // warps per head
  static constexpr int NT = 32 * G * WPH;
  static constexpr int PITCH = pitch_bytes(DP * 2);
  static constexpr int QBYTES = G * BQ * PITCH;
  static constexpr int KBYTES = G * SUB * BK * PITCH;
  static constexpr int BYTES =
      QBYTES > 2 * KBYTES ? QBYTES : 2 * KBYTES;  // Q stage aliases K/V
};

template <int DP, int BQ, int BK, int SUB, int HALVES, int G, int KIND>
__global__ void __launch_bounds__(Cfg<DP, BQ, BK, SUB, HALVES, G>::NT)
bounded_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ bound,
               bf16* __restrict__ out, int Sq, int Skv, int W, int d,
               float guard) {
  using C = Cfg<DP, BQ, BK, SUB, HALVES, G>;
  constexpr int KS = DP / 16;  // k steps of Q K^T
  constexpr int NTK = BK / 8;  // 8-column tiles of one S sub-tile
  constexpr int DT = DP / 8;   // 8-column tiles of O
  constexpr int ROWS = SUB * BK;
  constexpr bool PV = KIND == TB || KIND == BOUNDED || KIND == QK_PV ||
                      KIND == BND2;
  constexpr bool SUM = KIND == BND2 || !PV;  // fp32 row sum of p
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4;
  const int hg = warp / C::WPH;
  const long long bh0 = (long long)blockIdx.y * G;
  const int q0 = blockIdx.x * BQ;
  const int wrow = (warp % C::WPH) * 16 * HALVES;
  const long long rs = (long long)W * 2;
  const unsigned char* qb = reinterpret_cast<const unsigned char*>(q);
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);

  for (int g = 0; g < G; ++g)
    copy_rows<16>(smem + g * BQ * C::PITCH, C::PITCH,
                  qb + (bh0 + g) * Sq * rs, rs, q0, BQ, W * 2, DP * 2, tid,
                  C::NT);
  __syncthreads();
  uint32_t qa[HALVES][KS][4];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
    load_a_bf16<KS>(qa[h], smem + (hg * BQ + wrow + 16 * h) * C::PITCH,
                    C::PITCH, lane);
  float bnd[HALVES][2];
  float o[HALVES][DT][4];
  float l[HALVES][2];
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
    const long long r = (bh0 + hg) * Sq + q0 + wrow + 16 * h + grp;
    bnd[h][0] = KIND == BND2 ? bound[r] : 0.f;
    bnd[h][1] = KIND == BND2 ? bound[r + 8] : 0.f;
    l[h][0] = l[h][1] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) o[h][j][0] = o[h][j][1] = o[h][j][2] =
        o[h][j][3] = 0.f;
  }

  for (int k0 = 0; k0 < Skv; k0 += ROWS) {
    __syncthreads();  // the Q stage or the previous tiles are consumed
    for (int g = 0; g < G; ++g) {
      copy_rows<16>(smem + g * ROWS * C::PITCH, C::PITCH,
                    kb + (bh0 + g) * Skv * rs, rs, k0, ROWS, W * 2, DP * 2,
                    tid, C::NT);
      copy_rows<16>(smem + C::KBYTES + g * ROWS * C::PITCH, C::PITCH,
                    vb + (bh0 + g) * Skv * rs, rs, k0, ROWS, W * 2, DP * 2,
                    tid, C::NT);
    }
    __syncthreads();
    const unsigned char* ks = smem + hg * ROWS * C::PITCH;
    const unsigned char* vs = ks + C::KBYTES;
    float s[HALVES][SUB][NTK][4];
    // every product first: halves and sub-tiles are independent
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
#pragma unroll
        for (int j = 0; j < NTK; ++j)
          s[h][u][j][0] = s[h][u][j][1] = s[h][u][j][2] = s[h][u][j][3] = 0.f;
        qk_bf16<KS, NTK>(s[h][u], qa[h], ks + u * BK * C::PITCH, C::PITCH,
                         lane);
      }
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
#pragma unroll
        for (int j = 0; j < NTK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[h][u][j][e];
            if (KIND == BND2) x = exp2f(x - bnd[h][e / 2]);
            if (KIND == TB || KIND == QK_EXP) x = exp2f(x);
            if (KIND == BOUNDED) x = expf(x);
            s[h][u][j][e] = x;
            if (SUM) l[h][e / 2] += x;
          }
        if (PV) {
          uint32_t p[NTK / 2][4];
          pack_p<NTK>(p, s[h][u]);
          pv_bf16<NTK / 2, DT>(o[h], p, vs + u * BK * C::PITCH, C::PITCH,
                               lane);
        }
      }
  }

  bf16* ob = out + (bh0 + hg) * Sq * d;
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
    const long long row0 = q0 + wrow + 16 * h;
    float den0, den1;
    if (SUM) {
      den0 = quad_sum(l[h][0]);
      den1 = quad_sum(l[h][1]);
    } else {  // the ones column of v_ext
      column_of<DT>(o[h], d, lane, den0, den1);
    }
    if (PV)
      store_rows<DT>(ob, row0, d, o[h], fmaxf(den0, guard),
                     fmaxf(den1, guard), lane);
    else
      store_broadcast(ob, row0, d, den0, den1, lane);
  }
}

template <int DP, int BQ, int BK, int SUB, int HALVES, int G, int KIND>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const float* bound, bf16* out, int BH, int Sq, int Skv,
                   int W, int d, float guard, cudaStream_t stream) {
  using C = Cfg<DP, BQ, BK, SUB, HALVES, G>;
  static_assert(C::BYTES <= 232448, "over the 227 KB of shared memory");
  auto kern = bounded_kernel<DP, BQ, BK, SUB, HALVES, G, KIND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / BQ, BH / G);
  kern<<<grid, C::NT, C::BYTES, stream>>>(q, k, v, bound, out, Sq, Skv, W, d,
                                          guard);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (BH, S, W) bf16 contiguous, W a multiple of 8 (d + 1 padded
// for the extended kinds, d for BND2); bound: (BH, Sq) fp32 (BND2) or
// NULL; out: (BH, Sq, d) bf16. Sq % bq, Skv % (bk * sub) and BH % g must
// be 0 (checked by the caller and again here). The instantiations built
// are the SG_BUILT / SG_TILES4 lines below; any other returns
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
      (kind == BND2) != (BND != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (W + 15) / 16 * 16;
#define SG_BUILT(DP_, BQ_, BK_, SUB_, HALVES_, G_, KIND_)                   \
  if (dp == DP_ && bq == BQ_ && bk == BK_ && sub == SUB_ &&                 \
      halves == HALVES_ && g == G_ && kind == KIND_)                        \
    return static_cast<int>(launch<DP_, BQ_, BK_, SUB_, HALVES_, G_, KIND_>( \
        Q, K, V, BND, O, BH, Sq, Skv, W, d, guard, s));
#define SG_TILES4(DP_, SUB_, HALVES_, G_, KIND_)   \
  SG_BUILT(DP_, 64, 64, SUB_, HALVES_, G_, KIND_)  \
  SG_BUILT(DP_, 64, 128, SUB_, HALVES_, G_, KIND_) \
  SG_BUILT(DP_, 128, 64, SUB_, HALVES_, G_, KIND_) \
  SG_BUILT(DP_, 128, 128, SUB_, HALVES_, G_, KIND_)
  // tb_attention (and ablate_attention with do_exp, do_pv, halves 1) at
  // d = 40, 80, 160 (d + 1 padded to 48, 96, 176)
  SG_TILES4(48, 1, 1, 1, TB)
  SG_TILES4(96, 1, 1, 1, TB)
  SG_TILES4(176, 1, 1, 1, TB)
  // bounded_attention at d = 40, 80
  SG_TILES4(48, 1, 1, 1, BOUNDED)
  SG_TILES4(96, 1, 1, 1, BOUNDED)
  // bounded_multi_attention: 2 or 4 sub-tiles of 64 kv rows
  SG_BUILT(48, 64, 64, 2, 1, 1, BOUNDED)
  SG_BUILT(48, 128, 64, 2, 1, 1, BOUNDED)
  SG_BUILT(48, 64, 64, 4, 1, 1, BOUNDED)
  SG_BUILT(48, 128, 64, 4, 1, 1, BOUNDED)
  SG_BUILT(96, 64, 64, 2, 1, 1, BOUNDED)
  SG_BUILT(96, 128, 64, 2, 1, 1, BOUNDED)
  SG_BUILT(96, 64, 64, 4, 1, 1, BOUNDED)
  SG_BUILT(96, 128, 64, 4, 1, 1, BOUNDED)
  // ablate_attention's other modes at d = 40
  SG_BUILT(48, 64, 64, 1, 1, 1, QK)
  SG_BUILT(48, 128, 128, 1, 1, 1, QK)
  SG_BUILT(48, 64, 64, 1, 1, 1, QK_EXP)
  SG_BUILT(48, 128, 128, 1, 1, 1, QK_EXP)
  SG_BUILT(48, 64, 64, 1, 1, 1, QK_PV)
  SG_BUILT(48, 128, 128, 1, 1, 1, QK_PV)
  SG_BUILT(48, 64, 64, 1, 2, 1, TB)
  SG_BUILT(48, 128, 128, 1, 2, 1, TB)
  // bnd2_attention at d = 40, 80
  SG_TILES4(48, 1, 1, 1, BND2)
  SG_TILES4(80, 1, 1, 1, BND2)
  // mh_attention: g heads per block; g = 8 at d = 160 takes 32-row K/V
  // tiles (172,032 bytes of shared memory; 64-row tiles would need 344,064)
  SG_BUILT(48, 64, 64, 1, 1, 2, BND2)
  SG_BUILT(48, 64, 64, 1, 1, 4, BND2)
  SG_BUILT(48, 64, 64, 1, 1, 8, BND2)
  SG_BUILT(80, 64, 64, 1, 1, 2, BND2)
  SG_BUILT(80, 64, 64, 1, 1, 4, BND2)
  SG_BUILT(80, 64, 64, 1, 1, 8, BND2)
  SG_BUILT(160, 64, 64, 1, 1, 2, BND2)
  SG_BUILT(160, 64, 64, 1, 1, 4, BND2)
  SG_BUILT(160, 64, 32, 1, 1, 8, BND2)
#undef SG_TILES4
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
