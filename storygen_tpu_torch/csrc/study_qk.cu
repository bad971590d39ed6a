// Kernel S3: the bare q k^T with a kv sum, int8 or bf16, for Hopper
// (sm_90a), on kernel F's wgmma + TMA template (flash_wgmma.cuh) with
// the V-less walk of S2's QK kind (study_wgmma.cuh's sum_walk).
//
// Replaces scripts/studies/bench_attn_int8.py _qk_kernel (qk_only): for
// q_t (BH, D, Sq) and k (BH, Skv, D), out (BH, 1, Sq) fp32 is, for each
// query column, the sum over kv of s = k q (the study's "is an int8 q k^T
// worth it" measurement; the sum only keeps the product from being
// discarded). int8 x int8 products accumulate in int32; each K tile's
// int32 sums (exact) are then accumulated in fp32, as the TPU kernel does
// per block. bf16 products accumulate in fp32.
//
// What bounds it on the H100: tensor-core work, 2 Sq Skv D operations, at
// 1,979 TOPS in int8 and 989 TFLOP/s in bf16; the output is one float per
// query. wgmma's k32 pads d = 40 to 64 in int8 (a floor 1.6x the bound)
// and its k16 to 48 in bf16 (1.2x). Every block also streams its head's
// whole K from L2 (Sq / BQ times a head); at BQ 128 two consumer
// warpgroups share each landed K tile.
//
// Design: a producer warpgroup lands the block's q_t slab once (its d
// rows of BQ queries, untransposed; TMA's zero fill takes the rows past D
// to the products' padded depth) and the K tiles of BK rows into a ring of
// STAGES stages, K-major: int8 rows of 64 bytes (swizzle 64B), bf16 rows
// in F's panels. K's tensor map is W columns wide, W >= D: TMA reads a row
// that ends inside a 32-byte sector far slower (PERF.md §6, PR 23), so
// the wrapper hands k at a pitch of whole sectors with W the pitch (int8:
// what k holds past D meets the slab's zero rows; bf16: a zero-padded
// copy, as 0 times a NaN is not 0), and the box's columns past W read as
// zeros. Each consumer warpgroup takes
// 64 queries: 8-bit wgmma has no M-major A, so A goes to registers once,
// int8 by 32-bit loads of four d rows and byte permutes (the m16n8k32 A
// fragment, which is wgmma's k32 register A per warp), bf16 by a
// transposing ldmatrix. S = A K^T is wgmma m64nBKk32.s32.s8.s8 (two k
// steps) or m64nBKk16.f32.bf16.bf16 (three), A in registers and K from
// shared memory; two S accumulator sets, the next tile's product in
// flight while the current tile's sums run. The kv sum: each thread sums
// its columns of a tile (int32, exact; bf16 in fp32), int8 then takes the
// quad's sum and one conversion a row a tile into an fp32 running sum.
#include "study_wgmma.cuh"

using namespace sg_flash;

namespace {

// A block of BQ / 64 consumer warpgroups over K tiles of BK rows; the
// q_t slab in the Q slot: DROWS rows of d (the products' padded depth) of
// BQ queries, each row BQ * EB bytes.
template <int I8, int BQ, int BK, int STAGES, int KPW>
struct QkCfg {
  using C = FwCfg<48, BQ / 64, BK, STAGES, KPW, false, 1, 1, I8 ? 1 : 2>;
  static constexpr int EB = C::EB, DROWS = 32 * C::KSTEPS / EB;
  static constexpr int PITCH = BQ * EB, SLAB = DROWS * PITCH;
  static_assert(SLAB <= C::QBYTES, "the q_t slab fits the Q slot");
  static_assert(PITCH % 16 == 0, "ldmatrix rows and TMA's box");
};

// The kv sums of S3 (sum_walk's policy), this thread's rows r = 0, 1: int8
// sums a tile in int32 (exact), then the quad's sum and one conversion
// into fp32; bf16 sums in fp32. Four partial sums, so that the adds'
// chains stay short beside the next tile's product.
struct KvSum {
  float l[2] = {0.f, 0.f};
  template <int N>
  __device__ void step(int (&s)[N], float (&)[2]) {
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i % 4] += s[i];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] += static_cast<float>(quad_sum(acc[2 * r] + acc[2 * r + 1]));
  }
  template <int N>
  __device__ void step(float (&s)[N], float (&)[2]) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i % 4] += s[i];
    l[0] += acc[0] + acc[1];
    l[1] += acc[2] + acc[3];
  }
};

// The int8 A fragments (m16n8k32, k step kk) of the 16 queries from column
// q of the slab (d rows `pitch` bytes apart, one byte a query): the four
// bytes of each register are four consecutive d of one query, gathered
// from four 32-bit loads by byte permutes.
template <int KS>
__device__ __forceinline__ void load_a_s8_t(uint32_t (&a)[KS][4],
                                            const unsigned char* slab,
                                            int pitch, int q, int lane) {
  const int grp = lane / 4, tq = lane % 4;
  auto gather = [&](int d, int row) {
    const int col = q + row;
    const unsigned char* p = slab + d * pitch + (col & ~3);
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + pitch);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(p + 2 * pitch);
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(p + 3 * pitch);
    const uint32_t sel = (col & 3) | ((col & 3) + 4) << 4;
    return __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel),
                       0x5410);
  };
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = gather(32 * kk + 16 * (r / 2) + 4 * tq, grp + 8 * (r % 2));
}

// The bf16 A fragments (m16n8k16, k step kk) of the 16 queries from column
// q of the slab at shared-space address `slab` (d rows `pitch` bytes
// apart): one transposing x4 ldmatrix a k step.
template <int KS>
__device__ __forceinline__ void load_a_bf16_t(uint32_t (&a)[KS][4],
                                              uint32_t slab, int pitch, int q,
                                              int lane) {
  const uint32_t p = slab + (lane % 8 + 8 * (lane / 16)) * pitch + 2 * q +
                     16 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_x4_t_at(a[kk], p + 16 * kk * pitch);
}

// grid (Sq / BQ, 1, BH)
template <int I8, int BQ, int BK, int STAGES, int KPW>
__global__ void __launch_bounds__(QkCfg<I8, BQ, BK, STAGES, KPW>::C::NT, 1)
    qk_wg_kernel(const __grid_constant__ CUtensorMap tmqt,
                 const __grid_constant__ CUtensorMap tmk, float* out, int Sq,
                 int Skv) {
  using Q = QkCfg<I8, BQ, BK, STAGES, KPW>;
  using C = typename Q::C;
  constexpr int WGM = C::NTC / 128, KSTEPS = C::KSTEPS, KPS = C::KRB / 32;
  extern __shared__ unsigned char smem_raw[];
  const FwRing<C> rg((smem_addr(smem_raw) + 1023u) & ~1023u);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.z, q0 = blockIdx.x * BQ, n = Skv / BK;
  if (tid == 0) rg.init();
  __syncthreads();
  if (warp >= 4 * WGM) {  // the producer: one thread issues every copy
    if constexpr (WGM > 1) setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == 4 * WGM && lane == 0) {
      mbar_expect_tx(rg.q_full(0), Q::SLAB);
      tma_load_3d(rg.q(0), &tmqt, rg.q_full(0), q0, 0, bh);
      for (int t = 0; t < n; ++t) rg.load_kv(&tmk, &tmk, t, 0, t * BK, bh);
    }
    return;
  }
  consumers_start<C>();
  const int g = warp / 4, w = warp % 4;
  const int qw = 64 * g + 16 * w;  // the warp's first query in the block
  uint32_t a[KSTEPS][4];
  mbar_wait(rg.q_full(0), 0);
  if constexpr (I8)
    load_a_s8_t<KSTEPS>(a, smem_raw + (rg.q(0) - smem_addr(smem_raw)),
                        Q::PITCH, qw, lane);
  else
    load_a_bf16_t<KSTEPS>(a, rg.q(0), Q::PITCH, qw, lane);
  KvSum sm;
  sum_walk(rg, n, sm, [&](auto& s, uint32_t ks) {
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j) {
      const uint64_t desc = smem_desc(
          ks + (j / KPS) * C::KPANEL + 32 * (j % KPS), 0, 8 * C::KRB, C::KRB);
      if constexpr (I8)
        WgMma<BK>::run(s, a[j], desc, j > 0);
      else
        WgMma<BK>::template run<0>(s, a[j], desc, j > 0);
    }
  });

  // int8's sums are the quad's already, bf16's each lane's part
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float tot = I8 ? sm.l[r] : quad_sum(sm.l[r]);
    if (lane % 4 == 0)
      out[(long long)bh * Sq + q0 + qw + lane / 4 + 8 * r] = tot;
  }
}

template <int I8, int BQ, int BK, int STAGES, int KPW>
cudaError_t launch(const void* qt, const void* k, float* out, int BH, int Sq,
                   int Skv, int D, int W, long long kb, long long kr,
                   cudaStream_t stream) {
  using Q = QkCfg<I8, BQ, BK, STAGES, KPW>;
  using C = typename Q::C;
  CUtensorMap tq, tk;
  if (!encode_planes(&tq, qt,
                     I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     BH, D, Sq, (long long)Sq * Q::EB,
                     (long long)D * Sq * Q::EB, BQ, Q::DROWS) ||
      !encode_operand(&tk, k, BH, 1, Skv, W, kb, kr, KPW, BK, Q::EB, kr))
    return cudaErrorInvalidValue;
  constexpr auto kern = qk_wg_kernel<I8, BQ, BK, STAGES, KPW>;
  cudaError_t err = smem_limit_once<kern>(C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / BQ, 1, BH);
  kern<<<grid, C::NT, C::BYTES, stream>>>(tq, tk, out, Sq, Skv);
  return cudaGetLastError();
}

}  // namespace

// q_t (BH, D, Sq) contiguous and k (BH, Skv, D) with batch and row strides
// kb, kr (elements; their bytes multiples of 16), both int8 (int8 != 0) or
// both bf16, 16-byte aligned; out (BH, Sq) fp32. K's map is W columns wide,
// D <= W <= kr: int8 any such W (the columns past D meet zeros), bf16 W > D
// only where those columns hold zeros. D % 8 == 0, Sq % bq == 0,
// Skv % bk == 0. The instantiations built are the SG_BUILT
// lines below, (int8, the products' padded depth: 64 int8 / 48 bf16, bq,
// bk, ring stages, K panel columns), mirrored by
// ops/study_int8.py::QK_BUILT; any other returns cudaErrorInvalidValue.
extern "C" int sg_study_qk(const void* qt, const void* k, void* out, int BH,
                           int Sq, int Skv, int D, int W, long long kb,
                           long long kr, int int8, int bq, int bk,
                           void* stream) {
  float* O = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 || Sq % bq || Skv % bk || BH > 65535 || W < D || W > kr ||
      (kr * (int8 ? 1 : 2)) % 16 || (kb * (int8 ? 1 : 2)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dk = int8 ? (D + 31) / 32 * 32 : (D + 15) / 16 * 16;
#define SG_BUILT(I8_, DK_, BQ_, BK_, STAGES_, KPW_)                        \
  if (int8 == I8_ && dk == DK_ && bq == BQ_ && bk == BK_)                  \
    return static_cast<int>(launch<I8_, BQ_, BK_, STAGES_, KPW_>(          \
        qt, k, O, BH, Sq, Skv, D, W, kb, kr, s));
  // the study's d = 40: int8 (64-byte rows, two k32 steps) and bf16
  SG_BUILT(1, 64, 64, 64, 4, 64)
  SG_BUILT(1, 64, 64, 128, 4, 64)
  SG_BUILT(1, 64, 128, 64, 4, 64)
  SG_BUILT(1, 64, 128, 128, 4, 64)
  SG_BUILT(0, 48, 64, 64, 4, 64)
  SG_BUILT(0, 48, 64, 128, 4, 64)
  SG_BUILT(0, 48, 128, 64, 4, 64)
  SG_BUILT(0, 48, 128, 128, 4, 64)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
