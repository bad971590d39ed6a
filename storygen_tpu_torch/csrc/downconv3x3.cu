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
// outside the kernel only to avoid strided VMEM reads; here the taps read
// the strided pixels in place from shared memory, so there is no phase pass
// through device memory.
//
// What bounds it on the H100: tensor-core work, 2 pixels 9 Cin Cout
// operations, at the UNet's three sites (64x64 -> 32x32 at 320 channels
// down to 16x16 -> 8x8 at 1280) and the VAE encoder's 256 and 128 px sites
// (256 and 512 channels); at the VAE encoder's 512 px site (128 channels)
// it is bound by the bytes of its input, read once if each input tile goes
// to shared memory once.
//
// What the design does about it: kernel C's implicit GEMM (conv_mma.cuh)
// with stride 2. mma.sync fragments come by ldmatrix straight from a halo
// slab twice as tall and wide as the output tile, which stores each row's
// even columns and then its odd ones, so the eight pixels 2 ox + dx of one
// ldmatrix are neighbours there and the stride costs an address; slab and
// weights through a cp.async ring of 16-channel chunks, so that two blocks
// fit an SM; the epilogue from registers. At the 16- and 8-column outputs
// smaller pixel tiles or Cout blocks keep the grid at a wave of 132 SMs,
// and the 8-column one walks Cin 1280 in 64-channel chunks, so that fewer
// barriers fall on the deep K (studies/conv_tiles.py).
#include "conv_mma.cuh"

using namespace sg_conv;

// kernel D; an instantiation not in the SG_BUILT lines returns
// cudaErrorInvalidValue
extern "C" int sg_downconv3x3(const void* x, const void* w9, const void* bias,
                              void* out, int B, int H, int W, int Cin,
                              int Cout, int Ho, int Wo, int pt, int pl,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Ho <= 0 ||
      Wo <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.w9 = static_cast<const bf16*>(w9);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.Ho = Ho;
  a.Wo = Wo;
  a.pt = pt;
  a.pl = pl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncin = Cin % 8 != 0, coutc = cout_class(Cout), wc = w_class(Wo);
#define SG_BUILT(S_, PRO_, NCIN_, COUTC_, WC_, TH_, TW_, BN_, WM_, WN_,    \
                 CK_, STAGES_, MINB_)                                      \
  if (ncin == NCIN_ && coutc == COUTC_ && wc == WC_) {                     \
    static_assert(S_ == 2 && PRO_ == 0, "stride 2, no prologue");          \
    return static_cast<int>(                                               \
        conv_launch<S_, false, (NCIN_ == 0), TH_, TW_, BN_, WM_, WN_, CK_, \
                    STAGES_, MINB_>(a, B, s));                             \
  }
  // (stride, prologue, Cin % 8 != 0, Cout > 16, W class of Wo 0 / 1 / 2
  // for Wo <= 8 / <= 16 / wider; TH, TW, BN, warps along M and N, CK, ring
  // stages, blocks per SM), mirrored by DOWN_BUILT in ops/downconv.py
  SG_BUILT(2, 0, 0, 1, 2, 8, 16, 64, 4, 2, 16, 2, 2)
  SG_BUILT(2, 0, 0, 1, 1, 4, 16, 64, 4, 2, 16, 2, 2)
  SG_BUILT(2, 0, 0, 1, 0, 8, 8, 32, 4, 2, 64, 2, 1)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
