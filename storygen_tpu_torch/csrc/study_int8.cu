// Max-free attention forward with an int8 q k^T for Hopper (sm_90a).
//
// Replaces scripts/studies/bench_attn_int8.py _full_int8_kernel, reached
// through full_int8 (quantisation on the host) and through
// bench_attn_int8_epilogue.py int8_attn_from_quant (q and k quantised
// after the projection GEMMs); both launch the same kernel. Per head:
//   s32 = q8 k8^T (int8 x int8 -> int32)
//   s   = s32 * sk[kv] * sq[q] - bnd[q]   (fp32, in this order; sq carries
//         scale * log2(e), bnd is the |q| max|k| bound of the dequantised
//         rows in exp2 units)
//   p   = exp2(s), rounded to bf16
//   acc += p v_ext, v_ext = [v, 1] (bf16, fp32 accumulation)
//   out = acc[:d] / max(acc[d], 1.2e-38)
// The TPU's transposed q (BH, D, Sq) and output (BH, D, Sq) are not
// carried over: q8 is (BH, Sq, D) and out (BH, Sq, d).
//
// What bounds it on the H100: the q k^T half of the work runs on the int8
// tensor cores (1,979 TOPS), the P V half on the bf16 ones (989 TFLOP/s);
// the dequant, bound shift and exp2 are per-logit fp32 work. mma.sync
// m16n8k32 int8 (with an m16n8k16 tail: D = 40 bytes padded to 48 in
// shared memory), then the S accumulators become the bf16 A fragments of
// P V in registers; O stays in registers across K/V tiles (no running
// max, no rescale). One block per (BQ queries, head); each step copies
// BK rows of k8 (8-byte pieces, the rows are 40 bytes), v_ext and sk.
#include "study_mma.cuh"

using namespace sg_study;

namespace {

template <int DP8, int DV, int BQ, int BK>
struct Cfg {
  static constexpr int NT = 32 * BQ / 16;
  static constexpr int P8 = pitch_bytes(DP8);
  static constexpr int PV = pitch_bytes(DV * 2);
  static constexpr int QBYTES = BQ * P8;
  static constexpr int KBYTES = BK * P8;
  static constexpr int VBYTES = BK * PV;
  static constexpr int KVBYTES = KBYTES + VBYTES + BK * 4;
  static constexpr int BYTES = QBYTES > KVBYTES ? QBYTES : KVBYTES;
};

template <int DP8, int DV, int BQ, int BK>
__global__ void __launch_bounds__(Cfg<DP8, DV, BQ, BK>::NT)
int8_attn_kernel(const signed char* __restrict__ q8,
                 const signed char* __restrict__ k8,
                 const bf16* __restrict__ v, const float* __restrict__ sq,
                 const float* __restrict__ sk, const float* __restrict__ bnd,
                 bf16* __restrict__ out, int Sq, int Skv, int D, int W) {
  using C = Cfg<DP8, DV, BQ, BK>;
  constexpr int NTK = BK / 8, DT = DV / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tq = lane % 4;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int wrow = warp * 16;

  copy_rows<8>(smem, C::P8,
               reinterpret_cast<const unsigned char*>(q8) + bh * Sq * D, D,
               q0, BQ, D, DP8, tid, C::NT);
  __syncthreads();
  uint32_t a[(DP8 + 31) / 32][4];
  load_a_s8<DP8>(a, smem + wrow * C::P8, C::P8, lane);
  const long long r = bh * Sq + q0 + wrow + grp;
  const float sq_r[2] = {sq[r], sq[r + 8]};
  const float bnd_r[2] = {bnd[r], bnd[r + 8]};
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  unsigned char* ks = smem;
  unsigned char* vs = smem + C::KBYTES;
  float* sks = reinterpret_cast<float*>(smem + C::KBYTES + C::VBYTES);
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k8) + bh * Skv * D;
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v) + bh * Skv * W * 2;
  for (int k0 = 0; k0 < Skv; k0 += BK) {
    __syncthreads();  // the Q stage or the previous tiles are consumed
    copy_rows<8>(ks, C::P8, kb, D, k0, BK, D, DP8, tid, C::NT);
    copy_rows<16>(vs, C::PV, vb, (long long)W * 2, k0, BK, W * 2, DV * 2,
                  tid, C::NT);
    for (int i = tid; i < BK; i += C::NT) sks[i] = sk[bh * Skv + k0 + i];
    __syncthreads();
    int s32[NTK][4];
#pragma unroll
    for (int j = 0; j < NTK; ++j) s32[j][0] = s32[j][1] = s32[j][2] =
        s32[j][3] = 0;
    qk_s8<DP8, NTK>(s32, a, ks, C::P8, lane);
    float s[NTK][4];
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float skv = sks[8 * j + 2 * tq + e % 2];
        // JAX's order, without contraction into an fma
        const float x = __fsub_rn(
            __fmul_rn(__fmul_rn(static_cast<float>(s32[j][e]), skv),
                      sq_r[e / 2]),
            bnd_r[e / 2]);
        s[j][e] = exp2f(x);
      }
    uint32_t p[NTK / 2][4];
    pack_p<NTK>(p, s);
    pv_bf16<NTK / 2, DT>(o, p, vs, C::PV, lane);
  }

  float den0, den1;
  column_of<DT>(o, D, lane, den0, den1);  // the ones column of v_ext
  store_rows<DT>(out + bh * Sq * D, q0 + wrow, D, o, fmaxf(den0, 1.2e-38f),
                 fmaxf(den1, 1.2e-38f), lane);
}

template <int DP8, int DV, int BQ, int BK>
cudaError_t launch(const signed char* q8, const signed char* k8,
                   const bf16* v, const float* sq, const float* sk,
                   const float* bnd, bf16* out, int BH, int Sq, int Skv,
                   int D, int W, cudaStream_t stream) {
  using C = Cfg<DP8, DV, BQ, BK>;
  auto kern = int8_attn_kernel<DP8, DV, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / BQ, BH);
  kern<<<grid, C::NT, C::BYTES, stream>>>(q8, k8, v, sq, sk, bnd, out, Sq,
                                          Skv, D, W);
  return cudaGetLastError();
}

}  // namespace

// q8 (BH, Sq, D), k8 (BH, Skv, D) int8; v_ext (BH, Skv, W) bf16 with the
// ones column at D and W = D + 1 padded to a multiple of 8; sq, bnd
// (BH, Sq) and sk (BH, Skv) fp32; out (BH, Sq, D) bf16; all contiguous.
// Sq % bq == 0, Skv % bk == 0. The instantiations built are the SG_BUILT /
// SG_TILES4 lines below; any other returns cudaErrorInvalidValue.
extern "C" int sg_study_int8(const void* q8, const void* k8, const void* v,
                             const void* sq, const void* sk, const void* bnd,
                             void* out, int BH, int Sq, int Skv, int D, int W,
                             int bq, int bk, void* stream) {
  const signed char* Q = static_cast<const signed char*>(q8);
  const signed char* K = static_cast<const signed char*>(k8);
  const bf16* V = static_cast<const bf16*>(v);
  const float* SQ = static_cast<const float*>(sq);
  const float* SK = static_cast<const float*>(sk);
  const float* BND = static_cast<const float*>(bnd);
  bf16* O = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 || W % 8 || W <= D || Sq % bq || Skv % bk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp8 = (D + 15) / 16 * 16, dv = (W + 15) / 16 * 16;
#define SG_BUILT(DP8_, DV_, BQ_, BK_)                                     \
  if (dp8 == DP8_ && dv == DV_ && bq == BQ_ && bk == BK_)                 \
    return static_cast<int>(launch<DP8_, DV_, BQ_, BK_>(                  \
        Q, K, V, SQ, SK, BND, O, BH, Sq, Skv, D, W, s));
#define SG_TILES4(DP8_, DV_)    \
  SG_BUILT(DP8_, DV_, 64, 64)   \
  SG_BUILT(DP8_, DV_, 64, 128)  \
  SG_BUILT(DP8_, DV_, 128, 64)  \
  SG_BUILT(DP8_, DV_, 128, 128)
  // the study's d = 40 (int8 rows padded to 48 bytes, v_ext 41 -> 48)
  SG_TILES4(48, 48)
#undef SG_TILES4
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
