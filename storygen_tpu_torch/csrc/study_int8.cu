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
//   p   = exp2(s), rounded to bf16 (a result below 2^-126 flushes to
//         zero, as the TPU's fp32 has no subnormals)
//   acc += p v_ext, v_ext = [v, 1] (bf16, fp32 accumulation)
//   out = acc[:d] / max(acc[d], 1.2e-38)
// v_ext is made in shared memory: the kernel takes v (BH, Skv, d) and
// writes the ones column beside each tile it copies. The TPU's transposed
// q (BH, D, Sq) and output (BH, D, Sq) are not carried over: q8 is
// (BH, Sq, D) and out (BH, Sq, d).
//
// What bounds it on the H100: the q k^T half of the work runs on the int8
// tensor cores (1,979 TOPS), the P V half on the bf16 ones (989 TFLOP/s);
// the dequant, bound shift and exp2 are per-logit fp32 work, and the exp2
// alone (Sq Skv per head on the special-function units, 16 a clock per
// SM) is a floor of its own. mma.sync m16n8k32 int8 (with an m16n8k16
// tail: D = 40 bytes padded to 48 in shared memory), then the S
// accumulators become the bf16 A fragments of P V in registers; O stays in
// registers across K/V tiles (no running max, no rescale).
//
// The design is kernel F's (csrc/flash_fwd.cu), as the S1 / S2 studies'
// is: one block per (BQ queries, head), one warp per 16 queries. The k8, v
// and sk tiles of BK rows arrive through a ring of STAGES shared buffers
// (ring_stages: 3 where two blocks of them fit an SM, else 2): the next
// tile's copies start before the current tile's products, one
// barrier per tile. A k8 tile (BK rows of 40 bytes, one contiguous run in
// HBM) takes 16-byte cp.async copies into a dense shared tile, whose B
// fragments come by 32-bit loads (8-byte copies into a 48-byte pitch read
// by ldmatrix made twice the copies and ran slower). v's 80-byte rows
// take 16-byte copies, and a plain store puts the ones column and zeros in
// the 8 columns past them, so the row sum of the bf16 p comes out of the
// P V products (summing p in registers took more fp32 instructions). Q is
// copied once, in 8-byte pieces into a 48-byte pitch (ldmatrix A
// fragments), into the ring's last stage. The work of a tile goes 32 kv
// rows at a time (int32 logits, exp2, P V), so that few logits are live at
// once.
#include "study_mma.cuh"

using namespace sg_study;

namespace {

template <int DP8, int DV, int BQ, int BK>
struct Cfg {
  static constexpr int NT = 32 * BQ / 16;
  static constexpr int P8 = pitch_bytes(DP8);
  static constexpr int PV = pitch_bytes(DV * 2);
  static constexpr int KTILE = align128(BK * DP8);  // dense, D <= DP8
  static constexpr int VTILE = align128(BK * PV);
  static constexpr int STAGE = KTILE + VTILE + align128(BK * 4);
  static constexpr int STAGES = ring_stages(STAGE);
  static constexpr int BYTES = STAGES * STAGE;
  // 16 warps an SM: 128 registers a thread
  static constexpr int MINB = 512 / NT;
  static_assert(align128(BQ * P8) <= STAGE, "Q fits a ring stage");
  static_assert(BYTES <= 232448, "a block's shared memory");
  static_assert(BK % 32 == 0, "32 kv rows at a time");
};

template <int DP8, int DV, int BQ, int BK>
__global__ void __launch_bounds__(Cfg<DP8, DV, BQ, BK>::NT,
                                  Cfg<DP8, DV, BQ, BK>::MINB)
int8_attn_kernel(const signed char* __restrict__ q8,
                 const signed char* __restrict__ k8,
                 const bf16* __restrict__ v, const float* __restrict__ sq,
                 const float* __restrict__ sk, const float* __restrict__ bnd,
                 bf16* __restrict__ out, int Sq, int Skv, int D) {
  using C = Cfg<DP8, DV, BQ, BK>;
  constexpr int DT = DV / 8, STAGES = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tq = lane % 4;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int wrow = warp * 16;
  const unsigned char* kh =
      reinterpret_cast<const unsigned char*>(k8) + bh * Skv * D;
  const bf16* vh = v + bh * Skv * D;
  const float* skh = sk + bh * Skv;
  const int ntiles = Skv / BK;
  auto fetch = [&](int t, int stage) {
    unsigned char* st = smem + stage * C::STAGE;
    copy_run16<C::NT>(st, kh + (long long)t * BK * D, BK * D, tid);
    // v's columns [0, D) by cp.async; past them a plain store of the ones
    // column (bf16 1.0 at column D) and zeros, seen by every warp after
    // the barrier that precedes the tile's use
#pragma unroll 1
    for (int idx = tid; idx < BK * (DV / 8); idx += C::NT) {
      const int r = idx / (DV / 8), c = idx % (DV / 8);
      unsigned char* dst = st + C::KTILE + r * C::PV + 16 * c;
      if (8 * c < D)
        cp_async16(dst, vh + (long long)(t * BK + r) * D + 8 * c, 16);
      else
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(8 * c == D ? 0x3F80u : 0u, 0u, 0u, 0u);
    }
    for (int i = tid; i < BK / 4; i += C::NT)
      cp_async16(st + C::KTILE + C::VTILE + 16 * i, skh + t * BK + 4 * i,
                 16);
  };

  // group 0: Q into the last stage; then one group per stage but the last
  unsigned char* qs = smem + (STAGES - 1) * C::STAGE;
  copy_rows8<BQ, DP8, C::P8, C::NT>(
      qs, reinterpret_cast<const unsigned char*>(q8) + bh * Sq * D, q0, D,
      tid);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) fetch(s, s);
    cp_async_commit();
  }
  const long long r = bh * Sq + q0 + wrow + grp;
  const float sq_r[2] = {sq[r], sq[r + 8]};
  const float bnd_r[2] = {bnd[r], bnd[r + 8]};
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  uint32_t a[(DP8 + 31) / 32][4];
  load_a_s8<DP8>(a, qs + wrow * C::P8, C::P8, lane);
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  int cs = 0, ls = STAGES - 1;  // ring stages of the tile in use / to fill
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t
    // every thread's copies have landed, and every warp is done with the
    // stage that the copies below overwrite
    __syncthreads();
    if (t + STAGES - 1 < ntiles) fetch(t + STAGES - 1, ls);
    cp_async_commit();
    ls = ls + 1 == STAGES ? 0 : ls + 1;
    const unsigned char* st = smem + cs * C::STAGE;
    cs = cs + 1 == STAGES ? 0 : cs + 1;
    const float* sks = reinterpret_cast<const float*>(st + C::KTILE +
                                                      C::VTILE);
#pragma unroll
    for (int c = 0; c < BK / 32; ++c) {
      int s32[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s32[j][0] = s32[j][1] = s32[j][2] =
          s32[j][3] = 0;
      qk_s8_dense<DP8, 4>(s32, a, st + 32 * c * D, D, lane);
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float skv = sks[32 * c + 8 * j + 2 * tq + e % 2];
          // JAX's order, without contraction into an fma
          const float x = __fsub_rn(
              __fmul_rn(__fmul_rn(static_cast<float>(s32[j][e]), skv),
                        sq_r[e / 2]),
              bnd_r[e / 2]);
          s[j][e] = fast_exp2(x);
        }
      uint32_t p[2][4];
      pack_p<4>(p, s);
      pv_bf16<2, DT>(o, p, st + C::KTILE + 32 * c * C::PV, C::PV, lane);
    }
  }

  float den0, den1;
  column_of<DT>(o, D, lane, den0, den1);  // the ones column
  store_rows<DT>(out + bh * Sq * D, q0 + wrow, D, o, fmaxf(den0, 1.2e-38f),
                 fmaxf(den1, 1.2e-38f), lane);
}

template <int DP8, int DV, int BQ, int BK>
cudaError_t launch(const signed char* q8, const signed char* k8,
                   const bf16* v, const float* sq, const float* sk,
                   const float* bnd, bf16* out, int BH, int Sq, int Skv,
                   int D, cudaStream_t stream) {
  using C = Cfg<DP8, DV, BQ, BK>;
  auto kern = int8_attn_kernel<DP8, DV, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / BQ, BH);
  kern<<<grid, C::NT, C::BYTES, stream>>>(q8, k8, v, sq, sk, bnd, out, Sq,
                                          Skv, D);
  return cudaGetLastError();
}

}  // namespace

// q8 (BH, Sq, D), k8 (BH, Skv, D) int8; v (BH, Skv, D) bf16; sq, bnd
// (BH, Sq) and sk (BH, Skv) fp32; out (BH, Sq, D) bf16; all contiguous and
// 16-byte aligned. D % 8 == 0, Sq % bq == 0, Skv % bk == 0. The
// instantiations built are the SG_BUILT / SG_TILES4 lines below, keyed by
// D padded to 16 (q8 / k8) and D + 1 padded to 16 (v_ext in shared
// memory); any other returns cudaErrorInvalidValue.
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
  if (D % 8 || Sq % bq || Skv % bk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp8 = (D + 15) / 16 * 16, dv = (D + 8 + 15) / 16 * 16;
#define SG_BUILT(DP8_, DV_, BQ_, BK_)                                     \
  if (dp8 == DP8_ && dv == DV_ && bq == BQ_ && bk == BK_)                 \
    return static_cast<int>(launch<DP8_, DV_, BQ_, BK_>(                  \
        Q, K, V, SQ, SK, BND, O, BH, Sq, Skv, D, s));
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
