// Flash-attention backward for Hopper (sm_90a): the gradient kernels DQ
// and DKV. With P = exp(scale q.k - lse) and dS = P * (dO V^T - delta):
//
//   DQ   sg_flash_dq   replaces _dq_kernel of the TPU backward in
//        storygen_tpu/ops/pallas_attention.py (:558, its pallas_call :685):
//        dQ = scale * dS K, per block of Q rows, over the K/V tiles;
//   DKV  sg_flash_dkv  replaces _dkv_kernel (:593, pallas_call :698):
//        dV = P^T dO and dK = scale * dS^T Q, per block of K/V rows, over
//        the Q tiles, in the transposed form the TPU kernel uses (s_t).
//
// lse comes from kernel L (flash_fwd.cu) and delta = rowsum(dO * O) from
// the caller in fp32 (plain torch, as the JAX package computes it in XLA).
// Each kernel owns its output tile and loops over the other side, so there
// are no atomics and the result is deterministic.
//
// Both kernels are flash_bwd_wgmma.cuh's template (wgmma fed by TMA from a
// producer warpgroup; its header says what bounds the kernels, what the
// design does about it, and how edges and masking are handled). This file
// holds the C interface and the instantiations built: the SG_BUILT lines
// of `dispatch`, one per (kernel, padded head dim, masked), which
// studies/flash_bwd_tiles.py chose and rewrites for its candidates.
#include "flash_bwd_wgmma.cuh"

using sg_hopper::bf16;

namespace {

constexpr float LOG2E = 1.4426950408889634f;

enum Which { kDq = 1, kDkv = 2 };

struct Args {
  const bf16 *q, *k, *v, *dout;
  long long qb, qr, kb, kr, vb, vr;  // batch and row strides of q, k, v
  sg_flash::BwArgs w;
};

// BR: the block's own rows (DQ: Q rows; DKV: K/V rows), 64 per consumer
// warpgroup; BC: the rows of one streamed tile; APW: the own operands'
// panel columns; PP: ping-pong of two consumer warpgroups.
template <Which W, int DP, int BR, int BC, int STAGES, int APW, int PP,
          bool MASKED, bool STRADDLE>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  static_assert(BR % 64 == 0, "64 own rows a consumer warpgroup");
  return sg_flash::flash_bwd_wg_launch<W == kDkv, DP, BR / 64, BC, STAGES,
                                       APW, (PP != 0), MASKED, STRADDLE>(
      a.q, a.k, a.v, a.dout, a.w, B, a.qb, a.qr, a.kb, a.kr, a.vb, a.vr, s);
}

int dispatch(Which which, Args& a, int B, int D, float scale,
             void* stream) {
  sg_flash::BwArgs& w = a.w;
  w.D = D;
  w.scale = scale;
  w.scale_log2 = scale * LOG2E;
  const int masked = w.keep != nullptr;
  if (D % 8 || (masked && (w.span <= 0 || w.nref * w.span != w.Skv)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!masked) {
    w.nref = 1;
    w.span = 1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = (D + 15) / 16 * 16;
  // A masked line builds its kernel twice: for spans that are a multiple
  // of its K/V tile (DQ's BC, DKV's BR) and for the rest (STRADDLE),
  // chosen here.
#define SG_BUILT(KIND_, DP_, MASKED_, BR_, BC_, STAGES_, APW_, PP_)          \
  if (which == KIND_ && dp == DP_ && masked == MASKED_) {                   \
    if (masked && w.span % (KIND_ == kDq ? BC_ : BR_) != 0)                 \
      return static_cast<int>(                                              \
          launch<KIND_, DP_, BR_, BC_, STAGES_, APW_, PP_, (MASKED_ != 0),  \
                 (MASKED_ != 0)>(a, B, s));                                 \
    return static_cast<int>(                                                \
        launch<KIND_, DP_, BR_, BC_, STAGES_, APW_, PP_, (MASKED_ != 0),    \
               false>(a, B, s));                                            \
  }
  // (kernel, 16-padded head dim, masked, BR, BC, ring stages, own panel
  // columns, ping-pong): the UNet's head dims 40 (padded to 48), 80 and 160
  SG_BUILT(kDq, 48, 0, 128, 128, 4, 64, 1)
  SG_BUILT(kDq, 48, 1, 128, 128, 4, 64, 1)
  SG_BUILT(kDq, 80, 0, 128, 64, 4, 64, 1)
  SG_BUILT(kDq, 80, 1, 128, 128, 4, 64, 1)
  SG_BUILT(kDq, 160, 0, 64, 64, 3, 32, 0)
  SG_BUILT(kDq, 160, 1, 64, 64, 3, 32, 0)
  SG_BUILT(kDkv, 48, 0, 128, 64, 4, 64, 1)
  SG_BUILT(kDkv, 48, 1, 128, 64, 4, 64, 1)
  SG_BUILT(kDkv, 80, 0, 128, 64, 4, 64, 1)
  SG_BUILT(kDkv, 80, 1, 128, 64, 4, 64, 1)
  SG_BUILT(kDkv, 160, 0, 64, 16, 4, 32, 0)
  SG_BUILT(kDkv, 160, 1, 64, 16, 4, 32, 0)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int H, int Sq, int Skv,
               long long qb, long long qr, long long kb, long long kr,
               long long vb, long long vr, const void* keep, int nref,
               int span) {
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.qb = qb;
  a.qr = qr;
  a.kb = kb;
  a.kr = kr;
  a.vb = vb;
  a.vr = vr;
  a.w.lse = static_cast<const float*>(lse);
  a.w.delta = static_cast<const float*>(delta);
  a.w.H = H;
  a.w.Sq = Sq;
  a.w.Skv = Skv;
  a.w.keep = static_cast<const int*>(keep);
  a.w.nref = nref;
  a.w.span = span;
  return a;
}

}  // namespace

// dq (B, Sq, H*D) <- q, k, v, dout (B, Sq, H*D) contiguous, lse and delta
// (B, H, Sq) fp32. keep == nullptr: every kv row; otherwise keep (B, nref)
// int32 over nref spans of `span` kv rows, nref * span == Skv. D a multiple
// of 8. The instantiations built are the SG_BUILT lines of `dispatch`; any
// other returns cudaErrorInvalidValue.
extern "C" int sg_flash_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int H, int Sq,
                           int Skv, int D, long long qb, long long qr,
                           long long kb, long long kr, long long vb,
                           long long vr, const void* keep, int nref,
                           int span, float scale, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, H, Sq, Skv, qb, qr, kb, kr,
                     vb, vr, keep, nref, span);
  a.w.out0 = static_cast<bf16*>(dq);
  return dispatch(kDq, a, B, D, scale, stream);
}

// dk, dv (B, Skv, H*D) <- the same inputs as sg_flash_dq.
extern "C" int sg_flash_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B,
                            int H, int Sq, int Skv, int D, long long qb,
                            long long qr, long long kb, long long kr,
                            long long vb, long long vr, const void* keep,
                            int nref, int span, float scale, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, H, Sq, Skv, qb, qr, kb, kr,
                     vb, vr, keep, nref, span);
  a.w.out0 = static_cast<bf16*>(dk);
  a.w.out1 = static_cast<bf16*>(dv);
  return dispatch(kDkv, a, B, D, scale, stream);
}
