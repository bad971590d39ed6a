// Flash-attention forward for Hopper (sm_90a): O = softmax(Q K^T * scale) V,
// kernels F (unmasked) and M (masked), and the backward's kernel L, the
// forward's row logsumexp lse = log sum_k exp(scale q.k).
//
// Replaces the forward variants of the TPU kernel in
// storygen_tpu/ops/pallas_attention.py, reached through _flash_core:
// _bnd_kernel :83, _bnd2_kernel :124, _online_t_kernel :163 and
// _flash_kernel :208 (F), and their masked forms _bnd_masked_kernel :118,
// _bnd2_masked_kernel :157, _online_t_masked_kernel :202 and
// _masked_kernel :251 (M); and _lse_kernel :526 of the TPU backward
// (_pallas_bwd_with_out, reached through _core_bwd) (L), whose gradient
// kernels DQ and DKV are flash_bwd.cu. The TPU's per-row bound with its
// 120-unit exp2 clamp and the transposed "bhds" output layout are TPU
// workarounds and are not carried over: this is the exact online softmax.
//
// This file is the dispatch; the kernels are flash_wgmma.cuh's (wgmma fed
// by TMA, a producer warpgroup and consumer warpgroups; its notes say what
// bounds F and L by head dim and what the design does): flash_wg_kernel
// for F and M, lse_wg_kernel for L, F's walk without V, P V and O.
//
// What bounds L on the H100: one exp2 per kept logit on the
// special-function units (16 a clock per SM, 3.87e12 a second), beside
// the Q K^T products (at attn1 L1 B4 d48: 0.139 ms of exps against 0.052
// ms of products); the logits never reach HBM. It writes (B, H, Sq) fp32.
//
// The contract of all three: Q, K and V are read straight from the
// projections' (B, S, H*D) layout through batch and row strides (a split
// k|v view needs no copy), and O is written as (B, Sq, H*D) in bf16: the
// head merge is free. Ragged Sq and Skv (attn2's 77-token text kv): rows
// past Sq are not written, kv columns past Skv become -inf logits. For M
// (and masked L) the kv is N equal reference spans of any length and
// `keep` (B, N) says which spans a batch row may attend to. The walk goes
// from one tile that holds a kept row to the next: a tile wholly inside
// dropped spans costs neither a copy nor a wait. Where a span is a
// multiple of the line's BK (the 512 px UNet at BK = 64 or 128) a flag
// holds for a whole tile and the instantiation with STRADDLE = false does
// no per-column work; otherwise (16 or 144 tokens at the mid block of a
// 256 or 768 px image) a tile that straddles a span boundary sets the
// logits of its dropped columns to -inf in the S registers, as the ragged
// last tile does past Skv. A row whose running max is still -inf takes
// alpha = 0; a row that kept no span writes zeros (F, M) or -inf (L).
#include "flash_wgmma.cuh"

using sg_study::bf16;

namespace {

// what an SG_BUILT line builds: F or M (O), or L (lse)
enum Kind { kFwd = 1, kLse = 2 };

// The operands of one launch of F, M or L.
struct Call {
  const bf16 *q, *k, *v;
  void* out;
  int B, H, Sq, Skv, D;
  long long qb, qr, kb, kr, vb, vr;
  const int* keep;
  int nref, span;
  float sl2;  // scale * log2(e)
  cudaStream_t stream;
};

sg_flash::FwArgs fw_args(const Call& c) {
  sg_flash::FwArgs a = {};
  a.keep = c.keep;
  a.H = c.H;
  a.Sq = c.Sq;
  a.Skv = c.Skv;
  a.D = c.D;
  a.nref = c.nref;
  a.span = c.span;
  a.scale_log2 = c.sl2;
  return a;
}

// F / M: (BQ = 64 x consumer warpgroups, BK, stages, Q / K panel columns,
// ping-pong)
template <int DP, int BQ, int BK, int STAGES, int KPW, int PP, bool MASKED,
          bool STRADDLE>
cudaError_t launch_fwd(const Call& c) {
  static_assert(BQ % 64 == 0, "64 query rows a consumer warpgroup");
  sg_flash::FwArgs a = fw_args(c);
  a.out = static_cast<bf16*>(c.out);
  return sg_flash::flash_wg_launch<DP, BQ / 64, BK, STAGES, KPW, (PP != 0),
                                   MASKED, STRADDLE>(
      c.q, c.k, c.v, a, c.B, c.qb, c.qr, c.kb, c.kr, c.vb, c.vr, c.stream);
}

// L: (BQ = 64 x consumer warpgroups, BK, stages, Q / K panel columns)
template <int DP, int BQ, int BK, int STAGES, int KPW, bool MASKED,
          bool STRADDLE>
cudaError_t launch_lse(const Call& c) {
  static_assert(BQ % 64 == 0, "64 query rows a consumer warpgroup");
  sg_flash::FwArgs a = fw_args(c);
  a.lse = static_cast<float*>(c.out);
  return sg_flash::lse_wg_launch<DP, BQ / 64, BK, STAGES, KPW, MASKED,
                                 STRADDLE>(c.q, c.k, a, c.B, c.qb, c.qr,
                                           c.kb, c.kr, c.stream);
}

// One launch of `kind`. D a multiple of 8, scale > 0; keep == nullptr or
// (B, nref) int32 over nref spans of `span` kv rows, nref * span == Skv.
// The instantiations built are the SG_BUILT lines below, one per (kind,
// 16-padded head dim, masked), mirrored by FWD_BUILT (kFwd) and LSE_BUILT
// (kLse) in ops/flash_attention.py; any other returns
// cudaErrorInvalidValue. A masked line builds its kernel twice: for spans
// that are a multiple of its BK and for the rest (STRADDLE), chosen here.
int dispatch(Kind kind, const void* q, const void* k, const void* v,
             void* out, int B, int H, int Sq, int Skv, int D, long long qb,
             long long qr, long long kb, long long kr, long long vb,
             long long vr, const void* keep, int nref, int span, float scale,
             void* stream) {
  Call c = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), out, B, H, Sq, Skv, D, qb, qr, kb,
            kr, vb, vr, static_cast<const int*>(keep), nref, span,
            scale * 1.4426950408889634f, static_cast<cudaStream_t>(stream)};
  const int masked = c.keep != nullptr;
  if (D % 8 || !(scale > 0.f) ||
      (masked && (span <= 0 || nref * span != Skv)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!masked) {
    c.nref = 1;
    c.span = 1;
  }
  const int dp = (D + 15) / 16 * 16;
#define SG_BUILT(KIND_, ...) SG_BUILT_##KIND_(__VA_ARGS__)
#define SG_BUILT_kLse(DP_, MASKED_, BQ_, BK_, STAGES_, KPW_)               \
  if (kind == kLse && dp == DP_ && masked == MASKED_) {                     \
    if (masked && span % BK_ != 0)                                          \
      return static_cast<int>(                                              \
          launch_lse<DP_, BQ_, BK_, STAGES_, KPW_, (MASKED_ != 0),          \
                     (MASKED_ != 0)>(c));                                   \
    return static_cast<int>(                                                \
        launch_lse<DP_, BQ_, BK_, STAGES_, KPW_, (MASKED_ != 0), false>(c)); \
  }
#define SG_BUILT_kFwd(DP_, MASKED_, BQ_, BK_, STAGES_, KPW_, PP_)          \
  if (kind == kFwd && dp == DP_ && masked == MASKED_) {                     \
    if (masked && span % BK_ != 0)                                          \
      return static_cast<int>(                                              \
          launch_fwd<DP_, BQ_, BK_, STAGES_, KPW_, PP_, (MASKED_ != 0),     \
                     (MASKED_ != 0)>(c));                                   \
    return static_cast<int>(                                                \
        launch_fwd<DP_, BQ_, BK_, STAGES_, KPW_, PP_, (MASKED_ != 0),       \
                   false>(c));                                              \
  }
  // F and M: (kFwd, 16-padded head dim, masked, BQ, BK, ring stages, Q / K
  // panel columns, ping-pong); L: (kLse, 16-padded head dim, masked, BQ,
  // BK, ring stages, Q / K panel columns). The UNet's head dims 40 (padded
  // to 48), 80 and 160.
  SG_BUILT(kFwd, 48, 0, 192, 128, 2, 64, 0)
  SG_BUILT(kFwd, 48, 1, 128, 128, 3, 64, 1)
  SG_BUILT(kFwd, 80, 0, 128, 128, 2, 64, 1)
  SG_BUILT(kFwd, 80, 1, 128, 128, 2, 64, 1)
  SG_BUILT(kFwd, 160, 0, 128, 64, 2, 32, 1)
  SG_BUILT(kFwd, 160, 1, 128, 64, 2, 32, 1)
  SG_BUILT(kLse, 48, 0, 128, 128, 4, 64)
  SG_BUILT(kLse, 48, 1, 128, 128, 4, 64)
  SG_BUILT(kLse, 80, 0, 128, 128, 3, 64)
  SG_BUILT(kLse, 80, 1, 128, 128, 3, 64)
  SG_BUILT(kLse, 160, 0, 128, 64, 3, 32)
  SG_BUILT(kLse, 160, 1, 128, 64, 3, 32)
#undef SG_BUILT_kFwd
#undef SG_BUILT_kLse
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Kernels F (keep == nullptr) and M: O (B, Sq, H*D) bf16 <- q (B, Sq, H*D),
// k and v (B, Skv, H*D), in the layout of dispatch() above.
extern "C" int sg_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int Sq, int Skv, int D,
                            long long qb, long long qr, long long kb,
                            long long kr, long long vb, long long vr,
                            const void* keep, int nref, int span,
                            float scale, void* stream) {
  return dispatch(kFwd, q, k, v, o, B, H, Sq, Skv, D, qb, qr, kb, kr, vb, vr,
                  keep, nref, span, scale, stream);
}

// Kernel L: lse (B, H, Sq) fp32 <- q (B, Sq, H*D), k (B, Skv, H*D).
extern "C" int sg_flash_lse(const void* q, const void* k, void* lse, int B,
                            int H, int Sq, int Skv, int D, long long qb,
                            long long qr, long long kb, long long kr,
                            const void* keep, int nref, int span,
                            float scale, void* stream) {
  return dispatch(kLse, q, k, k, lse, B, H, Sq, Skv, D, qb, qr, kb, kr, kb,
                  kr, keep, nref, span, scale, stream);
}
