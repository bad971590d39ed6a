// Nearest 2x upsampling followed by a 3x3 SAME convolution, over NHWC, for
// Hopper (sm_90a), kernel U, computed in its phase form on the source grid:
//   out[b, 2y+pa, 2x+pb, co] = bias[co] + sum_{r, c, ci}
//       x[b, y-1+pa+r, x-1+pb+c, ci] * w16[4*(2*pa+pb) + 2*r+c, ci, co]
// for the (B, H, W, Cin) source x and the (B, 2H, 2W, Cout) output, an
// index outside the image reading 0. w16 holds the four phases' 2x2
// kernels, each tap the sum of the 3x3 taps that land on one source pixel
// of the upsampled grid (ops/upconv.py::phase_weight): rows of phase 0 are
// [w0, w1 + w2], of phase 1 [w0 + w1, w2], and columns likewise.
//
// Replaces storygen_tpu/models/layers.py:220 (_UpsampleConv), which the
// JAX package runs at every 2x Upsample2D (the UNet's up blocks, the VAE
// decoder's) as four XLA convolutions on the source grid (:265-267), their
// interleave (:268-270) and the bias: no pallas_call, so U is the port's
// counterpart of an XLA module. The (B, 2H, 2W, Cin) upsampled tensor
// never exists, and each source pixel costs 16 Cin Cout multiply-adds
// instead of the 36 of a 3x3 conv on the upsampled grid.
//
// What bounds it on the H100: tensor-core work, 2 pixels 16 Cin Cout
// operations, at the UNet's second and third up blocks (16x16 -> 32x32 at
// 1280 channels, 32x32 -> 64x64 at 640; 40.3 GFLOP each at batch 3) and
// the VAE decoder's three (64 -> 128 px and 128 -> 256 at 512 channels, 256
// -> 512 at 256; 34-137 GFLOP); the phase weights' bytes, 16 x 1280 x 1280
// bf16 = 52 MB, at the first up block (8x8 -> 16x16, 192 source pixels at
// batch 3), 16 / 9 of a 3x3 conv's weights.
//
// What the design does about it: kernel C's wgmma template
// (conv_wgmma.cuh) in its phase mode. C's stride-1 halo slab of the
// source, landed by TMA with its zero fill as the border, holds every
// pixel that the four phases of its TH x TW pixels read; phase (pa, pb)'s
// tap (r, c) is the slab offset (pa + r, pb + c), an address. A block
// computes one phase (the lowest digit of blockIdx.x, so that the four
// blocks of a tile run together and share its slab in L2) over 4 taps of
// CK-channel chunks, its weights 4 CK rows a panel by TMA in the
// 64-byte-swizzled N-major layout that wgmma reads by descriptor, and the
// epilogue adds the fp32 bias and writes pixel (2y + pa, 2x + pb). C's
// tiles, its whole-image blocks at the 8-column sites and its split of the
// reduction (ops/conv.py::split_count, counting the four phases' blocks; a
// function of the shape without the batch), added in split order by the
// template's second kernel.
#include "conv_wgmma.cuh"

using namespace sg_conv;

// kernel U; an instantiation not in the SG_BUILT lines returns
// cudaErrorInvalidValue. `ws` is the (splits, B 2H 2W, Cout) fp32
// workspace of a split reduction (null where splits == 1).
extern "C" int sg_upconv3x3(const void* x, const void* w16, const void* bias,
                            void* out, void* ws, int splits, int B, int H,
                            int W, int Cin, int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  WgArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.w9 = static_cast<const bf16*>(w16);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.ws = static_cast<float*>(ws);
  a.splits = splits;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.Ho = 2 * H;
  a.Wo = 2 * W;
  a.pt = a.pl = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncin = Cin % 8 != 0, coutc = conv_cout_class(Cin, Cout),
            wc = w_class(W);
#define SG_BUILT(S_, PRO_, NCIN_, COUTC_, WC_, FAM_, TH_, TW_, IB_, WGM_, \
                 MT_, BN_, CK_, STAGES_)                                 \
  if (ncin == NCIN_ && coutc == COUTC_ && wc == WC_) {                   \
    static_assert(S_ == 1 && PRO_ == 0 && NCIN_ == 0 && FAM_ == 1,       \
                  "the phases on the wgmma template's stride-1 slab");   \
    return static_cast<int>(                                             \
        wg_launch<1, PHASES, TH_, TW_, IB_, WGM_, MT_, BN_, CK_,         \
                  STAGES_>(a, s));                                       \
  }
  // (stride, prologue, Cin % 8 != 0, Cout class 1 / 2 for a Cout that 128
  // divides / does not, W class of the source width W 0 / 1 / 2 for W <= 8
  // / <= 16 / wider; family 1, then TH, TW, images a block, consumer
  // warpgroups, 64-row tiles a warpgroup, BN, CK, ring stages), mirrored
  // by UP_BUILT in ops/upconv.py: kernel C's lines at its stride-1 keys
  SG_BUILT(1, 0, 0, 1, 2, 1, 6, 32, 1, 3, 1, 128, 32, 2)
  SG_BUILT(1, 0, 0, 2, 2, 1, 6, 32, 1, 3, 1, 160, 32, 2)
  SG_BUILT(1, 0, 0, 1, 1, 1, 8, 16, 1, 2, 1, 128, 32, 2)
  SG_BUILT(1, 0, 0, 2, 1, 1, 8, 16, 1, 2, 1, 160, 32, 2)
  SG_BUILT(1, 0, 0, 1, 0, 1, 8, 8, 3, 3, 1, 128, 32, 2)
  SG_BUILT(1, 0, 0, 2, 0, 1, 8, 8, 3, 3, 1, 160, 32, 2)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
