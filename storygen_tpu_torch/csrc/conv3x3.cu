// 3x3 stride-1 SAME convolution over NHWC for Hopper (sm_90a), kernels C
// and P:
//   out[b, y, x, co] = bias[b?, co] + sum_{dy, dx, ci}
//       act(x[b, y+dy-1, x+dx-1, ci]) * w9[3*dy+dx, ci, co]   (+ residual)
//
// Kernel C (act the identity) replaces _kernel with fused=False in
// storygen_tpu/ops/pallas_conv.py:61, called through halo_conv / conv3x3:
// fp32 accumulation, a (Cout) or per-batch (B, Cout) bias (the resnet's
// time-embedding add folded into the output write) and an optional
// residual added in fp32 before the bf16 store. In training C also
// computes the conv's input gradient, on the flipped weight (Cin and Cout
// swap: 320 -> 960 at the UNet's up L1).
//
// Kernel P replaces the same _kernel with fused=True (reached through
// gnconv3x3 / gnconvres3x3): act = bf16(silu(x * a[b, ci] + s[b, ci])),
// the resnet's folded GroupNorm affine and SiLU with a and s fp32 (B, Cin),
// applied in shared memory to the slab as it lands, so the normalised
// tensor never exists in device memory. Only elements inside the image and
// below Cin get it: the SAME border and the channel padding stay exactly
// 0, since silu(s) != 0 (the JAX kernel masks its border for the same
// reason). Each of the grid's Cout blocks recomputes the prologue of its
// slab.
//
// What bounds it on the H100: tensor-core work, 2 pixels 9 Cin Cout
// operations, at the UNet's sites (320-2560 -> 320-1280 channels, 64x64 to
// 8x8) and the VAE decoder's 256-512 px sites (128-512 channels), as long
// as the input is read about once; the conv_in (Cin 3 or 4) and the
// conv_out (Cout 3, 4 or 8) are bound by their bytes (the 128-channel side
// of a 512x512 image).
//
// What the design does about it (conv_mma.cuh): an implicit GEMM with
// mma.sync fragments loaded by ldmatrix straight from a halo slab in
// shared memory, so the input is read once per Cout block and the taps are
// addresses; slab and weights through a cp.async ring, so the copies of
// the next chunk overlap the products of this one; the epilogue from
// registers. The tiles follow the site (studies/conv_tiles.py): where the
// image is wider than 16 columns, C computes 8 x 32 pixels by 64 channels
// with four warps of 64 x 64 (two blocks per SM, half the ldmatrix
// traffic per product of 32 x 32 warp tiles) and P 16 x 16 by 64 with
// sixteen warps (its prologue is arithmetic that wants threads); at W =
// 16 and W <= 8 (768 and 192 pixels at batch 3) Cout blocks of 32 or 64
// keep the grid at a wave of 132 SMs or more; Cout <= 16 takes 16
// columns, so conv_out's 3 channels pay for 16, not 64. P keeps C's chunk
// depth at every site, so both sum in one order and P on a slab equals C
// on the prologue applied beforehand. Cin % 8 != 0 takes a synchronous
// slab path of its own.
#include "conv_mma.cuh"

using namespace sg_conv;

namespace {

int launch_built(bool pro, const ConvArgs& a, int B, cudaStream_t s) {
  if (B <= 0 || a.H <= 0 || a.W <= 0 || a.Cin <= 0 || a.Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ncin = a.Cin % 8 != 0, coutc = cout_class(a.Cout),
            wc = w_class(a.Wo);
#define SG_BUILT(S_, PRO_, NCIN_, COUTC_, WC_, TH_, TW_, BN_, WM_, WN_,    \
                 CK_, STAGES_, MINB_)                                      \
  if (pro == (PRO_ != 0) && ncin == NCIN_ && coutc == COUTC_ &&            \
      wc == WC_) {                                                         \
    static_assert(S_ == 1, "stride 1");                                    \
    return static_cast<int>(                                               \
        conv_launch<S_, (PRO_ != 0), (NCIN_ == 0), TH_, TW_, BN_, WM_,     \
                    WN_, CK_, STAGES_, MINB_>(a, B, s));                   \
  }
  // (stride, prologue, Cin % 8 != 0, Cout > 16, W class 0 / 1 / 2 for
  // W <= 8 / <= 16 / wider; TH, TW, BN, warps along M and N, CK, ring
  // stages, blocks per SM), mirrored by CONV_BUILT in ops/conv.py
  SG_BUILT(1, 0, 0, 1, 2, 8, 32, 64, 4, 1, 16, 2, 2)
  SG_BUILT(1, 0, 0, 1, 1, 8, 16, 32, 4, 1, 32, 3, 2)
  SG_BUILT(1, 0, 0, 1, 0, 8, 8, 32, 4, 2, 64, 2, 1)
  SG_BUILT(1, 0, 0, 0, 2, 16, 16, 16, 8, 1, 32, 2, 1)
  SG_BUILT(1, 0, 0, 0, 1, 8, 16, 16, 4, 1, 32, 2, 4)
  SG_BUILT(1, 0, 0, 0, 0, 8, 8, 16, 4, 1, 32, 2, 4)
  SG_BUILT(1, 0, 1, 1, 2, 8, 16, 64, 4, 2, 16, 2, 2)
  SG_BUILT(1, 0, 1, 1, 1, 8, 16, 64, 4, 2, 16, 2, 2)
  SG_BUILT(1, 0, 1, 1, 0, 8, 16, 64, 4, 2, 16, 2, 2)
  SG_BUILT(1, 0, 1, 0, 2, 8, 16, 16, 4, 1, 16, 2, 4)
  SG_BUILT(1, 0, 1, 0, 1, 8, 16, 16, 4, 1, 16, 2, 4)
  SG_BUILT(1, 0, 1, 0, 0, 8, 16, 16, 4, 1, 16, 2, 4)
  SG_BUILT(1, 1, 0, 1, 2, 16, 16, 64, 8, 2, 16, 2, 1)
  SG_BUILT(1, 1, 0, 1, 1, 8, 16, 64, 4, 2, 32, 2, 2)
  SG_BUILT(1, 1, 0, 1, 0, 8, 8, 32, 4, 2, 64, 2, 1)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}

ConvArgs make_args(const void* x, const void* w9, const void* bias,
                   long long bias_bstride, const void* a, const void* s,
                   const void* residual, void* out, int H, int W, int Cin,
                   int Cout) {
  ConvArgs c = {};
  c.x = static_cast<const bf16*>(x);
  c.w9 = static_cast<const bf16*>(w9);
  c.bias = static_cast<const float*>(bias);
  c.bias_bstride = bias_bstride;
  c.pa = static_cast<const float*>(a);
  c.ps = static_cast<const float*>(s);
  c.res = static_cast<const bf16*>(residual);
  c.out = static_cast<bf16*>(out);
  c.H = c.Ho = H;
  c.W = c.Wo = W;
  c.Cin = Cin;
  c.Cout = Cout;
  c.pt = c.pl = 1;
  return c;
}

}  // namespace

// kernel C; an instantiation not in the SG_BUILT lines returns
// cudaErrorInvalidValue
extern "C" int sg_conv3x3(const void* x, const void* w9, const void* bias,
                          long long bias_bstride, const void* residual,
                          void* out, int B, int H, int W, int Cin, int Cout,
                          void* stream) {
  return launch_built(false,
                      make_args(x, w9, bias, bias_bstride, nullptr, nullptr,
                                residual, out, H, W, Cin, Cout),
                      B, static_cast<cudaStream_t>(stream));
}

// kernel P: a and s are fp32 (B, Cin)
extern "C" int sg_gnconv3x3(const void* x, const void* w9, const void* bias,
                            long long bias_bstride, const void* a,
                            const void* s, const void* residual, void* out,
                            int B, int H, int W, int Cin, int Cout,
                            void* stream) {
  return launch_built(true,
                      make_args(x, w9, bias, bias_bstride, a, s, residual,
                                out, H, W, Cin, Cout),
                      B, static_cast<cudaStream_t>(stream));
}
