// The input gradient of kernel U (nearest 2x upsampling followed by a 3x3
// SAME convolution, computed in its phase form), over NHWC, for Hopper
// (sm_90a), kernel UB:
//   dx[b, r, s, ci] = sum_{ty, tx in 0..3, co}
//       g[b, 2r-1+ty, 2s-1+tx, co] * k16[4*ty+tx, co, ci]
// for the (B, 2H, 2W, Cout) cotangent g of U's output and the (B, H, W,
// Cin) gradient of its source, an index outside g reading 0. k16 holds
// U's phase weights with their taps flipped and transposed
// (ops/upconv.py::dx_weight): output row 2r - 1 + ty is phase (ty + 1) %
// 2, and reached source row r through that phase's tap 1 - ty / 2. It is
// the 4x4 stride-2 padding-1 correlation of g with the phase weights, 16
// multiply-adds a source pixel and channel pair, and no (B, 2H, 2W, Cin)
// tensor exists.
//
// Counterpart of XLA's gradient of the JAX package's four phase convs
// (storygen_tpu/models/layers.py:265-267, _UpsampleConv, differentiated by
// jax.grad): no pallas_call, so UB, like U, is the port's counterpart of
// an XLA module. It accumulates in fp32 and writes bf16 once, with no
// bias.
//
// What bounds it on the H100: tensor-core work, 2 pixels 16 Cin Cout
// operations, at the training path's second and third up blocks (16x16
// and 32x32 sources at 1280 and 640 channels, 53.7 GFLOP each at batch 4);
// the weights' 16 x 1280 x 1280 bf16 = 52 MB at its first (8x8 sources,
// 256 pixels at batch 4).
//
// What the design does about it: kernel D's stride-2 walk of C's wgmma
// template (conv_wgmma.cuh, mode PHASES_DX) with a 4x4 window. A producer
// warpgroup, one thread of which issues the TMA copies, fills an mbarrier
// ring of CK-channel chunks: per chunk g's even and odd columns as two
// planes of (2 TH + 2) rows and TW + 2 half-columns, so that the eight
// output pixels s of one ldmatrix read eight neighbouring half-columns of
// one plane at every tap, TMA's zero fill the padding on every side; and
// the chunk's 16 taps of weights, read by wgmma through a descriptor. The
// pixels (A) come by ldmatrix into registers, the accumulators stay fp32
// in registers, and the epilogue writes bf16 from them. The 8-column
// site takes blocks of two whole images; every site whose grid leaves
// the card short of blocks (the three up blocks) takes C's split of the
// reduction (ops/conv.py::split_count, a function of the shape without
// the batch), added in split order by the template's second kernel. The
// tiles are studies/conv_tiles.py's.
#include "conv_wgmma.cuh"

using namespace sg_conv;

// kernel UB; H, W are the output's (U's source) size, Cin the cotangent's
// channels (U's Cout), Cout the output's (U's Cin); `ws` is the (splits,
// B H W, Cout) fp32 workspace of a split reduction (null where splits ==
// 1). An instantiation not in the SG_BUILT lines returns
// cudaErrorInvalidValue.
extern "C" int sg_upconv_dx3x3(const void* g, const void* k16, void* out,
                               void* ws, int splits, int B, int H, int W,
                               int Cin, int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  WgArgs a = {};
  a.x = static_cast<const bf16*>(g);
  a.w9 = static_cast<const bf16*>(k16);
  a.out = static_cast<bf16*>(out);
  a.ws = static_cast<float*>(ws);
  a.splits = splits;
  a.B = B;
  a.H = 2 * H;
  a.W = 2 * W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.Ho = H;
  a.Wo = W;
  a.pt = a.pl = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncin = Cin % 8 != 0, coutc = conv_cout_class(Cin, Cout),
            wc = w_class(W);
#define SG_BUILT(S_, PRO_, NCIN_, COUTC_, WC_, FAM_, TH_, TW_, IB_, WGM_, \
                 MT_, BN_, CK_, STAGES_)                                 \
  if (ncin == NCIN_ && coutc == COUTC_ && wc == WC_) {                   \
    static_assert(S_ == 2 && PRO_ == 0 && NCIN_ == 0 && FAM_ == 1,       \
                  "the 4x4 window at stride 2 on the wgmma template");   \
    return static_cast<int>(                                             \
        wg_launch<2, PHASES_DX, TH_, TW_, IB_, WGM_, MT_, BN_, CK_,      \
                  STAGES_>(a, s));                                       \
  }
  // (stride, prologue, Cin % 8 != 0, Cout class 1 / 2 for a Cout that 128
  // divides / does not, W class of the output width W 0 / 1 / 2 for W <= 8
  // / <= 16 / wider; family 1, then TH, TW, images a block, consumer
  // warpgroups, 64-row tiles a warpgroup, BN, CK, ring stages), mirrored
  // by UB_BUILT in ops/upconv.py
  SG_BUILT(2, 0, 0, 1, 2, 1, 8, 32, 1, 2, 2, 128, 16, 2)
  SG_BUILT(2, 0, 0, 2, 2, 1, 8, 16, 1, 2, 1, 160, 16, 2)
  SG_BUILT(2, 0, 0, 1, 1, 1, 8, 16, 1, 2, 1, 128, 16, 2)
  SG_BUILT(2, 0, 0, 2, 1, 1, 8, 16, 1, 2, 1, 160, 16, 2)
  SG_BUILT(2, 0, 0, 1, 0, 1, 8, 8, 2, 2, 1, 128, 16, 2)
  SG_BUILT(2, 0, 0, 2, 0, 1, 8, 8, 2, 2, 1, 160, 16, 2)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
