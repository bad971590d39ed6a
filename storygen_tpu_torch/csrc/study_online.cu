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
// the per-logit softmax work; the logits never touch HBM. Unlike kernel F
// (csrc/flash_fwd.cu, which stages S, P and O in shared memory with WMMA),
// this kernel keeps S, P and O in registers with mma.sync: the accumulator
// layout of mma.m16n8k16 is known, so the row max and sum are quad
// shuffles and the rescale of O is a multiply of the warp's own registers.
// One block per (BQ query rows, head); Q is staged through shared memory
// into registers once; each step copies one BK-row K/V tile into shared
// memory (zero-padded from d = 40 to 48 columns there). No cp.async, TMA
// or wgmma yet.
#include <math.h>

#include "study_mma.cuh"

using namespace sg_study;

namespace {

constexpr float NEG_INF = -1e30f;

template <int DP, int BQ, int BK, int HALVES>
struct Cfg {
  static constexpr int NT = 32 * BQ / (16 * HALVES);
  static constexpr int PITCH = pitch_bytes(DP * 2);
  static constexpr int QBYTES = BQ * PITCH;
  static constexpr int KBYTES = BK * PITCH;
  static constexpr int BYTES = QBYTES > 2 * KBYTES ? QBYTES : 2 * KBYTES;
};

template <int MODE>
__device__ __forceinline__ float ex(float x) {
  return MODE == 2 ? exp2f(x) : expf(x);
}

template <int DP, int BQ, int BK, int MODE, int HALVES>
__global__ void __launch_bounds__(Cfg<DP, BQ, BK, HALVES>::NT)
online_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
              int Skv, int d, float scale) {
  using C = Cfg<DP, BQ, BK, HALVES>;
  constexpr int KS = DP / 16, NTK = BK / 8, DT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int wrow = warp * 16 * HALVES;
  const long long rs = (long long)d * 2;

  copy_rows<16>(smem, C::PITCH,
                reinterpret_cast<const unsigned char*>(q) + bh * Sq * rs, rs,
                q0, BQ, d * 2, DP * 2, tid, C::NT);
  __syncthreads();
  uint32_t qa[HALVES][KS][4];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
    load_a_bf16<KS>(qa[h], smem + (wrow + 16 * h) * C::PITCH, C::PITCH, lane);
  float o[HALVES][DT][4], m[HALVES][2], l[HALVES][2];
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
    m[h][0] = m[h][1] = NEG_INF;
    l[h][0] = l[h][1] = 0.f;  // this lane's share of the row sum
#pragma unroll
    for (int j = 0; j < DT; ++j) o[h][j][0] = o[h][j][1] = o[h][j][2] =
        o[h][j][3] = 0.f;
  }

  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k) + bh * Skv * rs;
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v) + bh * Skv * rs;
  for (int k0 = 0; k0 < Skv; k0 += BK) {
    __syncthreads();
    copy_rows<16>(smem, C::PITCH, kb, rs, k0, BK, d * 2, DP * 2, tid, C::NT);
    copy_rows<16>(smem + C::KBYTES, C::PITCH, vb, rs, k0, BK, d * 2, DP * 2,
                  tid, C::NT);
    __syncthreads();
    float s[HALVES][NTK][4];
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
#pragma unroll
      for (int j = 0; j < NTK; ++j)
        s[h][j][0] = s[h][j][1] = s[h][j][2] = s[h][j][3] = 0.f;
      qk_bf16<KS, NTK>(s[h], qa[h], smem, C::PITCH, lane);
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
      for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex<MODE>(s[h][j][e] - m[h][e / 2]);
          s[h][j][e] = p;
          l[h][e / 2] += p;
        }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[h][j][0] *= alpha[0];
        o[h][j][1] *= alpha[0];
        o[h][j][2] *= alpha[1];
        o[h][j][3] *= alpha[1];
      }
      uint32_t p[NTK / 2][4];
      pack_p<NTK>(p, s[h]);
      pv_bf16<NTK / 2, DT>(o[h], p, smem + C::KBYTES, C::PITCH, lane);
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
