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
// operations, at the UNet's wide sites (320-960 channels at 64x64) and the
// VAE decoder's 128-512 px sites (128-512 channels); the weights' bytes at
// the UNet's 16- and 8-column sites (1280-2560 -> 1280 channels, 768 and
// 192 pixels at batch 3); bytes too at the conv_in (Cin 3 or 4) and the
// conv_out (Cout 3, 4 or 8), the 128-channel side of a 512x512 image.
//
// What the design does about it: every key with Cin % 8 == 0 and Cout > 16
// runs the wgmma template of conv_wgmma.cuh (TMA ring, a producer warpgroup,
// A fragments by ldmatrix from the halo slab, B by descriptor; whole
// images per block and a split of the 9 Cin reduction that depends on (H,
// W, Cin, Cout) alone at the few-pixel sites). The conv_in and conv_out
// keys keep the mma.sync template of conv_mma.cuh, which is bound by bytes
// there and takes any Cin and Cout. The tiles follow the site
// (studies/conv_tiles.py). P takes C's line at every key, so both sum in
// one order and P on a slab equals C on the prologue applied beforehand.
#include "conv_wgmma.cuh"

using namespace sg_conv;

namespace {

// The two templates a SG_BUILT line can name: family 0 is conv_mma.cuh's
// mma.sync kernel, (TH, TW, BN, warps along M, warps along N, CK, ring
// stages, blocks per SM); family 1 conv_wgmma.cuh's wgmma kernel, (TH, TW,
// images a block, consumer warpgroups, 64-row tiles a warpgroup, BN, CK,
// ring stages).
template <int F>
struct Family;

template <>
struct Family<0> {
  template <bool PRO, bool VEC, int TH, int TW, int BN, int WM, int WN,
            int CK, int STAGES, int MINB>
  static cudaError_t launch(const WgArgs& w, cudaStream_t s) {
    if (w.splits != 1) return cudaErrorInvalidValue;
    ConvArgs c = {};
    c.x = w.x;
    c.w9 = w.w9;
    c.bias = w.bias;
    c.bias_bstride = w.bias_bstride;
    c.pa = w.pa;
    c.ps = w.ps;
    c.res = w.res;
    c.out = w.out;
    c.H = w.H;
    c.W = w.W;
    c.Cin = w.Cin;
    c.Cout = w.Cout;
    return conv_launch<PRO, VEC, TH, TW, BN, WM, WN, CK, STAGES, MINB>(
        c, w.B, s);
  }
};

template <>
struct Family<1> {
  template <bool PRO, bool VEC, int TH, int TW, int IB, int WGM, int MT,
            int BN, int CK, int STAGES>
  static cudaError_t launch(const WgArgs& w, cudaStream_t s) {
    static_assert(VEC, "TMA rows are whole 16-byte pieces");
    return wg_launch<1, PRO ? PROLOGUE : PLAIN, TH, TW, IB, WGM, MT, BN, CK,
                     STAGES>(w, s);
  }
};

int launch_built(bool pro, const WgArgs& a, cudaStream_t s) {
  if (a.B <= 0 || a.H <= 0 || a.W <= 0 || a.Cin <= 0 || a.Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ncin = a.Cin % 8 != 0, coutc = conv_cout_class(a.Cin, a.Cout),
            wc = w_class(a.W);
#define SG_BUILT(S_, PRO_, NCIN_, COUTC_, WC_, FAM_, A_, B_, C_, D_, E_, \
                 F_, G_, H_)                                             \
  if (pro == (PRO_ != 0) && ncin == NCIN_ && coutc == COUTC_ &&          \
      wc == WC_) {                                                       \
    static_assert(S_ == 1, "stride 1");                                  \
    return static_cast<int>(                                             \
        Family<FAM_>::launch<(PRO_ != 0), (NCIN_ == 0), A_, B_, C_, D_,  \
                             E_, F_, G_, H_>(a, s));                     \
  }
  // (stride, prologue, Cin % 8 != 0, Cout class 0 / 1 / 2 for Cout <= 16 /
  // else / Cin % 8 == 0 and Cout % 128 != 0, W class 0 / 1 / 2 for W <= 8
  // / <= 16 / wider; family, then its eight tile parameters), mirrored by
  // CONV_BUILT in ops/conv.py
  SG_BUILT(1, 0, 0, 1, 2, 1, 6, 32, 1, 3, 1, 128, 32, 2)
  SG_BUILT(1, 0, 0, 2, 2, 1, 6, 32, 1, 3, 1, 160, 32, 2)
  SG_BUILT(1, 0, 0, 1, 1, 1, 8, 16, 1, 2, 1, 128, 32, 2)
  SG_BUILT(1, 0, 0, 2, 1, 1, 8, 16, 1, 2, 1, 160, 32, 2)
  SG_BUILT(1, 0, 0, 1, 0, 1, 8, 8, 3, 3, 1, 128, 32, 2)
  SG_BUILT(1, 0, 0, 2, 0, 1, 8, 8, 3, 3, 1, 160, 32, 2)
  SG_BUILT(1, 0, 0, 0, 2, 0, 16, 16, 16, 8, 1, 32, 2, 1)
  SG_BUILT(1, 0, 0, 0, 1, 0, 8, 16, 16, 4, 1, 32, 2, 4)
  SG_BUILT(1, 0, 0, 0, 0, 0, 8, 8, 16, 4, 1, 32, 2, 4)
  SG_BUILT(1, 0, 1, 1, 2, 0, 8, 16, 64, 4, 2, 16, 2, 2)
  SG_BUILT(1, 0, 1, 1, 1, 0, 8, 16, 64, 4, 2, 16, 2, 2)
  SG_BUILT(1, 0, 1, 1, 0, 0, 8, 16, 64, 4, 2, 16, 2, 2)
  SG_BUILT(1, 0, 1, 0, 2, 0, 8, 16, 16, 4, 1, 16, 2, 4)
  SG_BUILT(1, 0, 1, 0, 1, 0, 8, 16, 16, 4, 1, 16, 2, 4)
  SG_BUILT(1, 0, 1, 0, 0, 0, 8, 16, 16, 4, 1, 16, 2, 4)
  SG_BUILT(1, 1, 0, 1, 2, 1, 6, 32, 1, 3, 1, 128, 32, 2)
  SG_BUILT(1, 1, 0, 2, 2, 1, 6, 32, 1, 3, 1, 160, 32, 2)
  SG_BUILT(1, 1, 0, 1, 1, 1, 8, 16, 1, 2, 1, 128, 32, 2)
  SG_BUILT(1, 1, 0, 2, 1, 1, 8, 16, 1, 2, 1, 160, 32, 2)
  SG_BUILT(1, 1, 0, 1, 0, 1, 8, 8, 3, 3, 1, 128, 32, 2)
  SG_BUILT(1, 1, 0, 2, 0, 1, 8, 8, 3, 3, 1, 160, 32, 2)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}

WgArgs make_args(const void* x, const void* w9, const void* bias,
                 long long bias_bstride, const void* a, const void* s,
                 const void* residual, void* out, void* ws, int splits, int B,
                 int H, int W, int Cin, int Cout) {
  WgArgs c = {};
  c.x = static_cast<const bf16*>(x);
  c.w9 = static_cast<const bf16*>(w9);
  c.bias = static_cast<const float*>(bias);
  c.bias_bstride = bias_bstride;
  c.pa = static_cast<const float*>(a);
  c.ps = static_cast<const float*>(s);
  c.res = static_cast<const bf16*>(residual);
  c.out = static_cast<bf16*>(out);
  c.ws = static_cast<float*>(ws);
  c.splits = splits;
  c.B = B;
  c.H = c.Ho = H;
  c.W = c.Wo = W;
  c.Cin = Cin;
  c.Cout = Cout;
  c.pt = c.pl = 1;
  return c;
}

}  // namespace

// kernel C; an instantiation not in the SG_BUILT lines returns
// cudaErrorInvalidValue. `ws` is the (splits, B H W, Cout) fp32 workspace
// of a wgmma line's split reduction (null where splits == 1).
extern "C" int sg_conv3x3(const void* x, const void* w9, const void* bias,
                          long long bias_bstride, const void* residual,
                          void* out, void* ws, int splits, int B, int H,
                          int W, int Cin, int Cout, void* stream) {
  return launch_built(false,
                      make_args(x, w9, bias, bias_bstride, nullptr, nullptr,
                                residual, out, ws, splits, B, H, W, Cin,
                                Cout),
                      static_cast<cudaStream_t>(stream));
}

// kernel P: a and s are fp32 (B, Cin)
extern "C" int sg_gnconv3x3(const void* x, const void* w9, const void* bias,
                            long long bias_bstride, const void* a,
                            const void* s, const void* residual, void* out,
                            void* ws, int splits, int B, int H, int W,
                            int Cin, int Cout, void* stream) {
  return launch_built(true,
                      make_args(x, w9, bias, bias_bstride, a, s, residual,
                                out, ws, splits, B, H, W, Cin, Cout),
                      static_cast<cudaStream_t>(stream));
}
