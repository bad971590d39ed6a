// 3x3 stride-2 convolution over NHWC with explicit zero padding, for Hopper
// (sm_90a), kernel D:
//   out[b, oy, ox, co] = bias[co] + sum_{dy, dx, ci}
//       x[b, 2*oy+dy-pt, 2*ox+dx-pl, ci] * w9[3*dy+dx, ci, co]
// where an input index outside the image reads 0. The caller gives the top
// and left padding and the output size, Ho = (H + pt + pb - 3) / 2 + 1 and
// Wo likewise; the bottom and right padding is then the zero read past the
// image's last row and column. The UNet's Downsample2D pads (1, 1, 1, 1),
// the VAE encoder's (0, 1, 0, 1): both take 64 rows to 32, 512 to 256.
//
// Replaces _down_kernel in storygen_tpu/ops/pallas_conv.py:312 (reached
// through halo_downconv / downconv3x3): fp32 accumulation and a (Cout)
// bias. The JAX kernel splits the padded input into four parity phases
// outside the kernel only to avoid strided VMEM reads; here TMA lands the
// even and the odd input columns as two planes of one slab, so there is no
// phase pass through device memory.
//
// What bounds it on the H100: tensor-core work, 2 pixels 9 Cin Cout
// operations, at the UNet's first two sites (64x64 -> 32x32 at 320
// channels, 32x32 -> 16x16 at 640) and the VAE encoder's 256 and 128 px
// sites (256 and 512 channels); at the VAE encoder's 512 px site (128
// channels) the bytes of its input, 201 MB at batch 3, read once if each
// input tile goes to shared memory once; at UNet L3 (16x16 -> 8x8, 1280
// channels, 192 output pixels at batch 3) the weights' 29.5 MB.
//
// What the design does about it: kernel C's wgmma template
// (conv_wgmma.cuh) at stride 2. A producer warpgroup, one thread of which
// issues the TMA copies, fills an mbarrier ring of CK-channel chunks: per
// chunk two boxes of the input, its even and its odd columns seen as two
// (Cin, half-columns, H, B) tensors, so that the eight output pixels 2 ox
// + dx of one ldmatrix read eight neighbouring half-columns of one plane,
// and the weights, read by wgmma through a descriptor. TMA's zero fill of
// out-of-range coordinates is the padding, on every side and at any W >=
// 2 (odd widths included). The pixels (A) come by ldmatrix into registers,
// the accumulators stay fp32 in registers, and the bias epilogue writes
// bf16 from them. The few-pixel sites take C's whole-image blocks and its
// split of the 9 Cin reduction (ops/conv.py::split_count, a function of
// the shape without the batch), added in split order by C's second kernel.
// The tiles are studies/conv_tiles.py's.
#include "conv_wgmma.cuh"

using namespace sg_conv;

// kernel D; an instantiation not in the SG_BUILT lines returns
// cudaErrorInvalidValue
extern "C" int sg_downconv3x3(const void* x, const void* w9, const void* bias,
                              void* out, void* ws, int splits, int B, int H,
                              int W, int Cin, int Cout, int Ho, int Wo,
                              int pt, int pl, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Ho <= 0 ||
      Wo <= 0 || pt < 0 || pl < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  WgArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.w9 = static_cast<const bf16*>(w9);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.ws = static_cast<float*>(ws);
  a.splits = splits;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.Ho = Ho;
  a.Wo = Wo;
  a.pt = pt;
  a.pl = pl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncin = Cin % 8 != 0, coutc = conv_cout_class(Cin, Cout),
            wc = w_class(Wo);
#define SG_BUILT(S_, PRO_, NCIN_, COUTC_, WC_, FAM_, TH_, TW_, IB_, WGM_, \
                 MT_, BN_, CK_, STAGES_)                                 \
  if (ncin == NCIN_ && coutc == COUTC_ && wc == WC_) {                   \
    static_assert(S_ == 2 && PRO_ == 0 && NCIN_ == 0 && FAM_ == 1,       \
                  "stride 2 on the wgmma template, no prologue");        \
    return static_cast<int>(                                             \
        wg_launch<2, false, TH_, TW_, IB_, WGM_, MT_, BN_, CK_, STAGES_>( \
            a, s));                                                      \
  }
  // (stride, prologue, Cin % 8 != 0, Cout class 1 / 2 for a Cout that 128
  // divides / does not, W class of Wo 0 / 1 / 2 for Wo <= 8 / <= 16 /
  // wider; family 1, then TH, TW, images a block, consumer warpgroups,
  // 64-row tiles a warpgroup, BN, CK, ring stages), mirrored by DOWN_BUILT
  // in ops/downconv.py
  SG_BUILT(2, 0, 0, 1, 2, 1, 8, 32, 1, 4, 1, 128, 16, 3)
  SG_BUILT(2, 0, 0, 2, 2, 1, 4, 32, 1, 2, 1, 160, 16, 3)
  SG_BUILT(2, 0, 0, 1, 1, 1, 8, 16, 1, 2, 1, 128, 16, 4)
  SG_BUILT(2, 0, 0, 2, 1, 1, 8, 16, 1, 2, 1, 160, 16, 3)
  SG_BUILT(2, 0, 0, 1, 0, 1, 8, 8, 3, 3, 1, 64, 32, 2)
  SG_BUILT(2, 0, 0, 2, 0, 1, 8, 8, 3, 3, 1, 160, 16, 3)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
