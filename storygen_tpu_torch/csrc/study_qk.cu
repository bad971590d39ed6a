// Bare q k^T with a kv sum, int8 or bf16, for Hopper (sm_90a).
//
// Replaces scripts/studies/bench_attn_int8.py _qk_kernel (qk_only): for
// q_t (BH, D, Sq) and k (BH, Skv, D), out (BH, 1, Sq) fp32 is, for each
// query column, the sum over kv of s = k q (the study's "is an int8 q k^T
// worth it" measurement; the sum only keeps the product from being
// discarded). int8 x int8 products accumulate in int32; each K/V tile's
// int32 sums (exact) are then accumulated in fp32, as the TPU kernel does
// per block. bf16 products accumulate in fp32.
//
// What bounds it on the H100: tensor-core work, 2 Sq Skv D operations, at
// 1,979 TOPS in int8 and 989 TFLOP/s in bf16; the output is one float per
// query. mma.sync m16n8k32 (int8; an m16n8k16 tail for D = 40, whose rows
// are zero-padded to 48 bytes in shared memory) or m16n8k16 (bf16).
//
// Design: one block per (BQ queries, head), one warp per 16 queries. q_t
// arrives transposed (the TPU's layout); each block transposes its
// (D, BQ) slab once into a (BQ, D) shared tile and keeps its A fragments
// in registers, then loops over BK-row K tiles. The 40-byte int8 K rows
// are copied in 8-byte pieces (no padding in HBM).
#include "study_mma.cuh"

using namespace sg_study;

namespace {

template <bool I8, int DP, int BQ, int BK>
struct Cfg {
  static constexpr int EB = I8 ? 1 : 2;  // bytes per element
  static constexpr int ROWB = DP * EB;
  static constexpr int PITCH = pitch_bytes(ROWB);
  static constexpr int NT = 32 * BQ / 16;
  static constexpr int QBYTES = BQ * PITCH;
  static constexpr int BYTES = QBYTES + BK * PITCH;
};

template <bool I8, int DP, int BQ, int BK>
__global__ void __launch_bounds__(Cfg<I8, DP, BQ, BK>::NT)
qk_kernel(const unsigned char* __restrict__ qt,
          const unsigned char* __restrict__ k, float* __restrict__ out,
          int Sq, int Skv, int D) {
  using C = Cfg<I8, DP, BQ, BK>;
  constexpr int NTK = BK / 8;
  constexpr int PER = 16 / C::EB;  // elements per 16-byte load
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;

  for (int i = tid; i < C::QBYTES / 16; i += C::NT)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const unsigned char* src = qt + bh * D * Sq * C::EB;
  for (int idx = tid; idx < D * (BQ / PER); idx += C::NT) {
    const int dd = idx / (BQ / PER), c = (idx % (BQ / PER)) * PER;
    const uint4 val = *reinterpret_cast<const uint4*>(
        src + ((long long)dd * Sq + q0 + c) * C::EB);
    const unsigned char* b = reinterpret_cast<const unsigned char*>(&val);
#pragma unroll
    for (int e = 0; e < PER; ++e)
#pragma unroll
      for (int x = 0; x < C::EB; ++x)
        smem[(c + e) * C::PITCH + dd * C::EB + x] = b[e * C::EB + x];
  }
  __syncthreads();
  unsigned char* ks = smem + C::QBYTES;
  const unsigned char* kb = k + bh * Skv * D * C::EB;
  const long long rs = (long long)D * C::EB;
  float tot[2] = {0.f, 0.f};

  if constexpr (I8) {
    uint32_t a[(DP + 31) / 32][4];
    load_a_s8<DP>(a, smem + warp * 16 * C::PITCH, C::PITCH, lane);
    for (int k0 = 0; k0 < Skv; k0 += BK) {
      __syncthreads();
      copy_rows<8>(ks, C::PITCH, kb, rs, k0, BK, D, C::ROWB, tid, C::NT);
      __syncthreads();
      int s[NTK][4];
#pragma unroll
      for (int j = 0; j < NTK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0;
      qk_s8<DP, NTK>(s, a, ks, C::PITCH, lane);
      int part[2] = {0, 0};
#pragma unroll
      for (int j = 0; j < NTK; ++j) {
        part[0] += s[j][0] + s[j][1];
        part[1] += s[j][2] + s[j][3];
      }
      // the tile's exact int32 sum, then fp32 across tiles
      tot[0] += static_cast<float>(quad_sum(part[0]));
      tot[1] += static_cast<float>(quad_sum(part[1]));
    }
  } else {
    uint32_t a[DP / 16][4];
    load_a_bf16<DP / 16>(a, smem + warp * 16 * C::PITCH, C::PITCH, lane);
    for (int k0 = 0; k0 < Skv; k0 += BK) {
      __syncthreads();
      copy_rows<16>(ks, C::PITCH, kb, rs, k0, BK, D * 2, C::ROWB, tid, C::NT);
      __syncthreads();
      float s[NTK][4];
#pragma unroll
      for (int j = 0; j < NTK; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      qk_bf16<DP / 16, NTK>(s, a, ks, C::PITCH, lane);
#pragma unroll
      for (int j = 0; j < NTK; ++j) {
        tot[0] += s[j][0] + s[j][1];
        tot[1] += s[j][2] + s[j][3];
      }
    }
    tot[0] = quad_sum(tot[0]);
    tot[1] = quad_sum(tot[1]);
  }
  if (lane % 4 == 0) {
    float* o = out + bh * Sq + q0 + warp * 16 + lane / 4;
    o[0] = tot[0];
    o[8] = tot[1];
  }
}

template <bool I8, int DP, int BQ, int BK>
cudaError_t launch(const void* qt, const void* k, float* out, int BH, int Sq,
                   int Skv, int D, cudaStream_t stream) {
  using C = Cfg<I8, DP, BQ, BK>;
  auto kern = qk_kernel<I8, DP, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / BQ, BH);
  kern<<<grid, C::NT, C::BYTES, stream>>>(
      static_cast<const unsigned char*>(qt),
      static_cast<const unsigned char*>(k), out, Sq, Skv, D);
  return cudaGetLastError();
}

}  // namespace

// q_t (BH, D, Sq) and k (BH, Skv, D), both int8 (int8 != 0) or both bf16,
// contiguous; out (BH, Sq) fp32. D a multiple of 8, Sq % bq == 0 and
// Skv % bk == 0. The instantiations built are the SG_BUILT / SG_TILES4
// lines below; any other returns cudaErrorInvalidValue.
extern "C" int sg_study_qk(const void* qt, const void* k, void* out, int BH,
                           int Sq, int Skv, int D, int int8, int bq, int bk,
                           void* stream) {
  float* O = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 || Sq % bq || Skv % bk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (D + 15) / 16 * 16;
#define SG_BUILT(I8_, DP_, BQ_, BK_)                                      \
  if (int8 == I8_ && dp == DP_ && bq == BQ_ && bk == BK_)                 \
    return static_cast<int>(                                              \
        launch<I8_ != 0, DP_, BQ_, BK_>(qt, k, O, BH, Sq, Skv, D, s));
#define SG_TILES4(I8_, DP_)    \
  SG_BUILT(I8_, DP_, 64, 64)   \
  SG_BUILT(I8_, DP_, 64, 128)  \
  SG_BUILT(I8_, DP_, 128, 64)  \
  SG_BUILT(I8_, DP_, 128, 128)
  // the study's d = 40, int8 and bf16
  SG_TILES4(1, 48)
  SG_TILES4(0, 48)
#undef SG_TILES4
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
