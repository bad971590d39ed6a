// Kernel G, the fused GEGLU -> output GEMM for Hopper (sm_90a):
//   out (M, E) = bf16(value * gelu(gate)) @ W^T + bias,  [value | gate] = proj.
//
// Replaces _geglu_kernel in storygen_tpu/ops/pallas_geglu.py (:50, called
// through geglu_matmul; its pallas_call at :107). Every built line runs
// the wgmma template of geglu_wgmma.cuh (TMA ring, a producer warpgroup,
// the gated product formed in registers as wgmma's A operand, W by
// descriptor; see there for what bounds it and what the design does). The
// tiles follow the site (studies/geglu_tiles.py).
//
// The line is picked by (E, the site class of the rows per image, K step);
// the split of the N reduction by the line and N. Neither reads M, so a
// row's order of summation is the same at every batch: the JAX kernel
// sums every row over the same blocks in the same order whatever M is.
#include "geglu_wgmma.cuh"

using namespace sg_geglu;

namespace {

// The class of a site's rows per image (mirrored by ops/geglu.py's
// site_class): 0 up to 128 (the mid block's 64 at 512 px), 1 up to 512
// (the third level's 256), 2 above (the first two levels).
inline int site_class(int tokens) {
  return tokens <= 128 ? 0 : (tokens <= 512 ? 1 : 2);
}

// The split of the N reduction that a line with SPLIT runs over nk inner
// steps (mirrored by ops/geglu.py's split_count): at least 4 steps a split.
inline int split_count(int split, int nk) {
  const int most = nk / 4 > 1 ? nk / 4 : 1;
  return split < most ? split : most;
}

}  // namespace

// out (M, E) bf16 <- proj (M, 2N), w (E, N) bf16 and bias (E), fp32 where
// bias_fp32 else bf16; `tokens` is the rows per image of the site. The
// instantiations built are the SG_BUILT lines below, one per (E,
// site_class(tokens), BK), mirrored by GEGLU_BUILT in ops/geglu.py: the
// first line of (E, site_class(tokens)) whose K step BK divides N runs, so
// a K step of 32 is taken only where N is not a multiple of 64 (the first
// level's inner shard at tensor parallelism 8, N = 160). Any other key, or
// N that no line's BK divides, returns cudaErrorInvalidValue.
extern "C" int sg_geglu_matmul(const void* proj, const void* w,
                               const void* bias, int bias_fp32, void* out,
                               int M, int N, int E, int tokens,
                               void* stream) {
  GegluArgs a = {};
  a.proj = static_cast<const bf16*>(proj);
  a.w = static_cast<const bf16*>(w);
  a.bias = bias;
  a.out = static_cast<bf16*>(out);
  a.M = M;
  a.N = N;
  a.E = E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sc = site_class(tokens);
#define SG_BUILT(E_, SC_, WGC_, BE_, WN_, BK_, STAGES_, SPLIT_)             \
  if (E == E_ && sc == SC_ && N % BK_ == 0) {                              \
    const int split = split_count(SPLIT_, N / BK_);                        \
    return static_cast<int>(                                               \
        bias_fp32                                                          \
            ? wg_launch<WGC_, BE_, WN_, BK_, STAGES_, true>(a, split, s)   \
            : wg_launch<WGC_, BE_, WN_, BK_, STAGES_, false>(a, split, s)); \
  }
  // (E, site class, consumer warpgroups, BE, WN, BK, ring stages, split):
  // the UNet's widths 320, 640 and 1280; a K step of 32 after the 64 one
  // for the first level's N = 160 shard at tensor parallelism 8
  SG_BUILT(320, 0, 1, 320, 160, 64, 4, 8)
  SG_BUILT(320, 1, 1, 320, 160, 64, 4, 2)
  SG_BUILT(320, 2, 2, 320, 160, 64, 3, 1)
  SG_BUILT(320, 2, 2, 320, 160, 32, 6, 1)
  SG_BUILT(640, 0, 1, 320, 160, 64, 4, 8)
  SG_BUILT(640, 1, 1, 320, 160, 64, 4, 2)
  SG_BUILT(640, 2, 1, 320, 160, 64, 4, 1)
  SG_BUILT(1280, 0, 1, 256, 256, 64, 4, 4)
  SG_BUILT(1280, 1, 1, 320, 160, 64, 4, 2)
  SG_BUILT(1280, 2, 1, 320, 160, 64, 4, 1)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
