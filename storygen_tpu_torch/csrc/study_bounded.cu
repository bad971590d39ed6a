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
// no per-tile rescale: O is a plain sum over the K/V tiles.
//
// The design is kernel F's (csrc/flash_fwd.cu), so that the study compares
// forms of the softmax and not copy pipelines:
// - S, P and O live in registers: each warp owns 16 query rows (two 16-row
//   halves with HALVES = 2, whose Q K^T products are all issued before
//   either half's exp), mma.sync m16n8k16 bf16 with fp32 accumulation and
//   ldmatrix fragments; two neighbouring S tiles are P's A fragment.
// - One step is one ring stage of SUB K/V sub-tiles of BK rows (SUB x BK
//   rows of K and of V), and every sub-tile's Q K^T is issued before the
//   first exp: that is what the SUB study measures. The stages arrive
//   through a ring of STAGES shared buffers (ring_stages: 3 where two
//   blocks of them fit an SM, else 2) filled by 16-byte cp.async copies;
//   the next stage's copies are issued before the current stage's Q K^T,
//   one barrier per step. The copy zero-fills columns past the HBM width W
//   (d + 1 padded to 8 for the extended kinds), so rows run as 48, 96 or
//   176 columns in shared memory only.
// - Q takes the same path. With one head per block it is copied once into
//   the ring's last stage, which the first step refills only after its
//   barrier, when every warp holds its Q fragments in registers.
// - G heads per block (mh): the block's warps walk its G heads in turn,
//   with O, the row sums and the Q fragments of one head in registers at a
//   time; the ring runs on across heads without a break, and each stage
//   has a slot for the Q of the head whose first step it holds. So a block
//   needs one head's registers and one head's ring at any G; side by side,
//   G heads would need G heads' K/V in every stage (344,064 bytes a stage
//   at G = 8, d = 160). At d = 80 and 160 two warps share each 16-row
//   slice, each taking half of every step's K/V rows (8 warps a block,
//   where the grid has g times fewer blocks); at a head's end the second
//   hands its O and row sums to the first through shared memory. The
//   max-free sum needs no rescale to merge.
// Not yet: wgmma and TMA.
#include <math.h>

#include "study_mma.cuh"

using namespace sg_study;

namespace {

enum Kind { TB = 0, BOUNDED = 1, QK = 2, QK_EXP = 3, QK_PV = 4, BND2 = 5 };

template <int DP, int BQ, int BK, int SUB, int HALVES, int G>
struct Cfg {
  // warps on each 16-row slice of Q: with G > 1 two, each taking half of
  // every step's K/V rows, so that a block walking g heads has 8 warps;
  // not at d = 40, where half a step (12 Q K^T and 12 P V products a
  // warp) is too little work to pay for the finer split
  static constexpr int KSPLIT = G > 1 && DP > 48 ? 2 : 1;
  static constexpr int WPS = BQ / (16 * HALVES);  // warps of one share
  static constexpr int NT = 32 * KSPLIT * WPS;
  static constexpr int PITCH = pitch_bytes(DP * 2);
  static constexpr int CPR = DP * 2 / 16;  // 16-byte chunks per row
  static constexpr int ROWS = SUB * BK;    // K/V rows of one step
  static constexpr int KV = align128(ROWS * PITCH);
  static constexpr int QTILE = align128(BQ * PITCH);
  // a stage: K, V and, with G > 1, the Q of a head whose first step it is
  static constexpr int STAGE = 2 * KV + (G > 1 ? QTILE : 0);
  static constexpr int STAGES = ring_stages(STAGE);
  static constexpr int BYTES = STAGES * STAGE;
  // floats a lane hands over per half with KSPLIT 2: O and two row sums
  static constexpr int HAND = DP / 2 + 2;
  static_assert(QTILE <= STAGE, "Q fits a ring stage");
  static_assert(BYTES <= 232448, "a block's shared memory");
  static_assert(KSPLIT == 1 || WPS * HALVES * HAND * 32 * 4 <= STAGE,
                "the hand-over fits the stage it goes through");
  static_assert(BK % (16 * KSPLIT) == 0, "whole 16-row chunks a share");
};

template <int DP, int BQ, int BK, int SUB, int HALVES, int G, int KIND>
__global__ void __launch_bounds__(Cfg<DP, BQ, BK, SUB, HALVES, G>::NT, 1)
bounded_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ bound,
               bf16* __restrict__ out, int Sq, int Skv, int W, int d,
               float guard) {
  using C = Cfg<DP, BQ, BK, SUB, HALVES, G>;
  constexpr int KS = DP / 16;  // k steps of Q K^T
  constexpr int KSPLIT = C::KSPLIT;
  constexpr int NTK = BK / (8 * KSPLIT);  // 8-column S tiles of a share
  constexpr int DT = DP / 8;              // 8-column tiles of O
  constexpr int STAGES = C::STAGES;
  constexpr bool PV = KIND == TB || KIND == BOUNDED || KIND == QK_PV ||
                      KIND == BND2;
  constexpr bool SUM = KIND == BND2 || !PV;  // fp32 row sum of p
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4;
  const long long bh0 = (long long)blockIdx.y * G;
  const int q0 = blockIdx.x * BQ;
  const int wrow = (warp % C::WPS) * 16 * HALVES;
  // this warp's rows of each K/V sub-tile: [krow, krow + BK / KSPLIT)
  const int share = warp / C::WPS, krow = share * (BK / KSPLIT);
  const int nt = Skv / C::ROWS;  // steps per head
  const int nsteps = G * nt;
  // step i: rows [t ROWS, (t + 1) ROWS) of head bh0 + g, t = i % nt
  auto fetch = [&](int i, int stage) {
    const int g = i / nt, t = i - g * nt;
    unsigned char* st = smem + stage * C::STAGE;
    const long long bh = bh0 + g;
    if (G > 1 && t == 0)
      copy_tile_lean<BQ, C::CPR, C::PITCH, C::NT>(
          st + 2 * C::KV, q + bh * Sq * W, W, q0, Sq, W, tid);
    copy_tile_lean<C::ROWS, C::CPR, C::PITCH, C::NT>(
        st, k + bh * Skv * W, W, t * C::ROWS, Skv, W, tid);
    copy_tile_lean<C::ROWS, C::CPR, C::PITCH, C::NT>(
        st + C::KV, v + bh * Skv * W, W, t * C::ROWS, Skv, W, tid);
  };

  uint32_t qa[HALVES][KS][4];
  // one head: group 0 is Q, into the last stage; then one group per stage
  // but the last
  if constexpr (G == 1) {
    copy_tile_lean<BQ, C::CPR, C::PITCH, C::NT>(
        smem + (STAGES - 1) * C::STAGE, q + bh0 * Sq * W, W, q0, Sq, W, tid);
    cp_async_commit();
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) fetch(s, s);
    cp_async_commit();
  }
  if constexpr (G == 1) {
    cp_async_wait<STAGES - 1>();
    __syncthreads();
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
      load_a_bf16<KS>(qa[h],
                      smem + (STAGES - 1) * C::STAGE +
                          (wrow + 16 * h) * C::PITCH,
                      C::PITCH, lane);
  }

  int ld = STAGES - 1;          // the next step to copy
  int cs = 0, ls = STAGES - 1;  // ring stages of the step in use / to fill
#pragma unroll 1
  for (int g = 0; g < G; ++g) {
    const long long bh = bh0 + g;
    float bnd[HALVES][2];
    float o[HALVES][DT][4];
    float l[HALVES][2];
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      const long long r = bh * Sq + q0 + wrow + 16 * h + grp;
      bnd[h][0] = KIND == BND2 ? bound[r] : 0.f;
      bnd[h][1] = KIND == BND2 ? bound[r + 8] : 0.f;
      l[h][0] = l[h][1] = 0.f;
#pragma unroll
      for (int j = 0; j < DT; ++j) o[h][j][0] = o[h][j][1] = o[h][j][2] =
          o[h][j][3] = 0.f;
    }

    for (int t = 0; t < nt; ++t) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of this step
      // every thread's copies have landed, and every warp is done with the
      // stage that the copies below overwrite
      __syncthreads();
      const unsigned char* ks = smem + cs * C::STAGE;
      const unsigned char* vs = ks + C::KV;
      if constexpr (G > 1) {
        if (t == 0)  // this head's Q, copied with its first step
#pragma unroll
          for (int h = 0; h < HALVES; ++h)
            load_a_bf16<KS>(qa[h], ks + 2 * C::KV + (wrow + 16 * h) * C::PITCH,
                            C::PITCH, lane);
      }
      if (ld < nsteps) fetch(ld, ls);
      cp_async_commit();
      ++ld;
      ls = ls + 1 == STAGES ? 0 : ls + 1;
      cs = cs + 1 == STAGES ? 0 : cs + 1;

      float s[HALVES][SUB][NTK][4];
      // every product first: halves and sub-tiles are independent
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
#pragma unroll
        for (int u = 0; u < SUB; ++u) {
#pragma unroll
          for (int j = 0; j < NTK; ++j)
            s[h][u][j][0] = s[h][u][j][1] = s[h][u][j][2] = s[h][u][j][3] =
                0.f;
          qk_bf16<KS, NTK>(s[h][u], qa[h], ks + (u * BK + krow) * C::PITCH,
                           C::PITCH, lane);
        }
      // p, its row sum, its bf16 A fragment and P V, 16 kv rows at a time:
      // a chunk's probabilities die once its products are issued
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
#pragma unroll
        for (int u = 0; u < SUB; ++u)
#pragma unroll
          for (int kk = 0; kk < NTK / 2; ++kk) {
#pragma unroll
            for (int j = 2 * kk; j < 2 * kk + 2; ++j)
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
              uint32_t p[1][4];
              pack_p16(p[0], s[h][u][2 * kk], s[h][u][2 * kk + 1]);
              pv_bf16<1, DT>(o[h], p,
                             vs + (u * BK + krow + 16 * kk) * C::PITCH,
                             C::PITCH, lane);
            }
          }
    }

    if constexpr (KSPLIT > 1) {
      // the second share's O and row sums go to the first through the
      // stage of the head's last step, which the next step's copies refill
      // only after their barrier
      float* hand = reinterpret_cast<float*>(
                        smem + (cs == 0 ? STAGES - 1 : cs - 1) * C::STAGE) +
                    (warp % C::WPS) * HALVES * C::HAND * 32 + lane;
      __syncthreads();  // every warp is done with that stage
      if (share == 1)
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
#pragma unroll
          for (int j = 0; j < DT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              hand[(h * C::HAND + 4 * j + e) * 32] = o[h][j][e];
          hand[(h * C::HAND + DP / 2) * 32] = l[h][0];
          hand[(h * C::HAND + DP / 2 + 1) * 32] = l[h][1];
        }
      __syncthreads();
      if (share == 1) continue;
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
#pragma unroll
        for (int j = 0; j < DT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[h][j][e] += hand[(h * C::HAND + 4 * j + e) * 32];
        l[h][0] += hand[(h * C::HAND + DP / 2) * 32];
        l[h][1] += hand[(h * C::HAND + DP / 2 + 1) * 32];
      }
    }
    bf16* ob = out + bh * Sq * d;
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
}

template <int DP, int BQ, int BK, int SUB, int HALVES, int G, int KIND>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const float* bound, bf16* out, int BH, int Sq, int Skv,
                   int W, int d, float guard, cudaStream_t stream) {
  using C = Cfg<DP, BQ, BK, SUB, HALVES, G>;
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
  // mh_attention: g heads per block, walked in turn by the block's warps
  SG_BUILT(48, 64, 64, 1, 1, 2, BND2)
  SG_BUILT(48, 64, 64, 1, 1, 4, BND2)
  SG_BUILT(48, 64, 64, 1, 1, 8, BND2)
  SG_BUILT(80, 64, 64, 1, 1, 2, BND2)
  SG_BUILT(80, 64, 64, 1, 1, 4, BND2)
  SG_BUILT(80, 64, 64, 1, 1, 8, BND2)
  SG_BUILT(160, 64, 64, 1, 1, 2, BND2)
  SG_BUILT(160, 64, 64, 1, 1, 4, BND2)
  SG_BUILT(160, 64, 64, 1, 1, 8, BND2)
#undef SG_TILES4
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
