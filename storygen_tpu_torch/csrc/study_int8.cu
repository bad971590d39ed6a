// Kernel S4: max-free attention forward with an int8 q k^T, for Hopper
// (sm_90a), as the INT8 kind of kernel S2 (study_wgmma.cuh) on kernel F's
// wgmma + TMA template (flash_wgmma.cuh).
//
// Replaces scripts/studies/bench_attn_int8.py _full_int8_kernel, reached
// through full_int8 (quantisation on the host) and through
// bench_attn_int8_epilogue.py int8_attn_from_quant (q and k quantised
// after the projection GEMMs); both launch the same kernel. Per head:
//   s32 = q8 k8^T (int8 x int8 -> int32)
//   s   = s32 * sk[kv] * sq[q] - bnd[q]   (fp32, in this order; sq carries
//         scale * log2(e), bnd is the |q| max|k| bound of the dequantised
//         rows in exp2 units)
//   p   = exp2(s), rounded to bf16 (a result below 2^-126 flushes to
//         zero, as the TPU's fp32 has no subnormals)
//   acc += p v_ext, v_ext = [v, 1] (bf16, fp32 accumulation)
//   out = acc[:d] / max(acc[d], 1.2e-38)
// The TPU's transposed q (BH, D, Sq) and output (BH, D, Sq) are not
// carried over: q8 is (BH, Sq, D) and out (BH, Sq, d).
//
// What bounds it on the H100: the exps. One exp2 a logit on the
// special-function units (16 a clock per SM, 3.87e12 a second) against
// 2 d int8 operations at 1,979 TOPS and 2 d bf16 ones at 989 TFLOP/s a
// logit: at d = 40 the exps take 1.6x the products' time, as in kernel F.
// The dequant adds three fp32 operations a logit and one conversion of
// the int32 logit to fp32 (an I2F in the SASS, chip_smoke.py's int8_sass):
// on the H100 it ran faster than an integer add and an fp32 add on the
// magic number 1.5 * 2^23, so it does not share the exps' rate (PERF.md
// §6, PR 23).
//
// The design is S2 BND2's (study_wgmma.cuh): fw_block with MaxFree<INT8>
// as its policy, four differences:
// - Q K^T is wgmma m64nBKk32.s32.s8.s8 with both operands K-major in
//   shared memory: q8 and k8 land by TMA in 64-byte rows (swizzle 64B),
//   two k32 steps. TMA needs every global stride a multiple of 16 bytes,
//   and it reads a row that ends inside a 32-byte sector far slower
//   (PERF.md §6, PR 23), so q8 and k8 come at a row pitch of whole sectors,
//   64 bytes (the wrapper quantises into such a buffer, zeros past D).
//   Q's map is D = 40 wide, its box's 64 bytes reading columns 40..63 as
//   zeros (Q lands once); K's map is the whole 64-byte row, since what K
//   holds past D meets Q's zeros.
// - The policy dequantises the int32 accumulators in JAX's order without
//   fma contraction, then F's ex2.approx.ftz; it leaves p's bits in the
//   accumulator registers, which P V's packing reads.
// - sq and bnd are per-row registers, loaded once; sk is a tile of BK fp32
//   that TMA lands at the end of each ring stage beside the K tile, under
//   K's full barrier (counted in its expect_tx), and the K stage is
//   released after the step that reads it.
// - The denominator is the tensor core's sum of the bf16-rounded p: v_ext
//   = [v, 1] zero-padded to 48 columns, built by the wrapper (the Pallas
//   kernel's own input, `ve`), makes O's column d that sum.
// bq 128 is two consumer warpgroups, ping-pong (F's named barriers: one
// group's products run while the other's exps do); bq 64 is one, behind
// the warpgroup barrier before its first wgmma (consumers_start). The
// ring's stages and panels follow ops/study_attention.py::study_line.
#include "study_wgmma.cuh"

using namespace sg_flash;

namespace {

template <int BQ, int BK, int STAGES, int KPW>
using Int8Cfg = typename S2Cfg<48, BQ, BK, 1, 1, INT8, STAGES, KPW>::C;

// grid (Sq / BQ, 1, BH)
template <int BQ, int BK, int STAGES, int KPW>
__global__ void __launch_bounds__(Int8Cfg<BQ, BK, STAGES, KPW>::NT, 1)
    int8_wg_kernel(const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv,
                   const __grid_constant__ CUtensorMap tms, const FwArgs a) {
  using C = Int8Cfg<BQ, BK, STAGES, KPW>;
  fw_block<C, C::NTC == 256, false, MaxFree<INT8>>(
      &tmq, &tmk, &tmv, a, DenseWalk{a.Skv / BK}, 0, blockIdx.z,
      blockIdx.x * C::BQ, &tms);
}

// q8 (BH, Sq, P) and k8 (BH, Skv, P) int8 at row pitch P bytes (a multiple
// of 32, columns from D on ignored); v_ext (BH, Skv, W) bf16; sq, bnd
// (BH, Sq) and sk (BH, Skv) fp32; out (BH, Sq, d) bf16. The five tensor
// maps are encoded per call.
template <int BQ, int BK, int STAGES, int KPW>
cudaError_t launch(const signed char* q8, const signed char* k8,
                   const bf16* v, const float* sq, const float* sk,
                   const float* bnd, bf16* out, int BH, int Sq, int Skv,
                   int D, int P, int W, cudaStream_t stream) {
  using C = Int8Cfg<BQ, BK, STAGES, KPW>;
  CUtensorMap tq, tk, tv, ts;
  if (!encode_operand(&tq, q8, BH, 1, Sq, D, (long long)Sq * P, P, KPW,
                      C::BQ, 1, P) ||
      !encode_operand(&tk, k8, BH, 1, Skv, P, (long long)Skv * P, P, KPW,
                      C::BK, 1, P) ||
      !encode_operand(&tv, v, BH, 1, Skv, W, (long long)Skv * W, W, C::VPW,
                      C::BK) ||
      !encode_planes(&ts, sk, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, BH, 1, Skv,
                     4LL * Skv, 4LL * Skv, C::BK, 1))
    return cudaErrorInvalidValue;
  FwArgs a = {};
  a.out = out;
  a.bound = bnd;
  a.qscale = sq;
  a.H = 1;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.nref = a.span = 1;
  a.guard = 1.2e-38f;
  constexpr auto kern = int8_wg_kernel<BQ, BK, STAGES, KPW>;
  cudaError_t err = smem_limit_once<kern>(C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / C::BQ, 1, BH);
  kern<<<grid, C::NT, C::BYTES, stream>>>(tq, tk, tv, ts, a);
  return cudaGetLastError();
}

}  // namespace

// q8 (BH, Sq, pad32(D)) and k8 (BH, Skv, pad32(D)) int8, contiguous, the
// bytes from D on ignored; v_ext (BH, Skv, pad8(D + 1)) bf16 = [v, 1, 0..];
// sq, bnd (BH, Sq) and sk (BH, Skv) fp32 (sq carrying scale * log2(e));
// out (BH, Sq, D) bf16; every pointer 16-byte aligned. D % 8 == 0,
// Sq % bq == 0, Skv % bk == 0. The instantiations built are the SG_BUILT
// lines below, (q8 / k8 row bytes in shared memory, v_ext's padded width,
// bq, bk, ring stages, Q / K panel columns), mirrored by
// ops/study_int8.py::INT8_BUILT; any other returns cudaErrorInvalidValue.
extern "C" int sg_study_int8(const void* q8, const void* k8, const void* v,
                             const void* sq, const void* sk, const void* bnd,
                             void* out, int BH, int Sq, int Skv, int D,
                             int bq, int bk, void* stream) {
  const signed char* Q = static_cast<const signed char*>(q8);
  const signed char* K = static_cast<const signed char*>(k8);
  const bf16* V = static_cast<const bf16*>(v);
  const float* SQ = static_cast<const float*>(sq);
  const float* SK = static_cast<const float*>(sk);
  const float* BND = static_cast<const float*>(bnd);
  bf16* O = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 || Sq % bq || Skv % bk || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = (D + 31) / 32 * 32, W = (D + 1 + 7) / 8 * 8;
  const int dk = P, dv = (W + 15) / 16 * 16;
#define SG_BUILT(DK_, DV_, BQ_, BK_, STAGES_, KPW_)                        \
  if (dk == DK_ && dv == DV_ && bq == BQ_ && bk == BK_)                    \
    return static_cast<int>(launch<BQ_, BK_, STAGES_, KPW_>(               \
        Q, K, V, SQ, SK, BND, O, BH, Sq, Skv, D, P, W, s));
  // the study's d = 40: 64-byte int8 rows, v_ext 41 -> 48
  SG_BUILT(64, 48, 64, 64, 4, 64)
  SG_BUILT(64, 48, 64, 128, 4, 64)
  SG_BUILT(64, 48, 128, 64, 4, 64)
  SG_BUILT(64, 48, 128, 128, 4, 64)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
