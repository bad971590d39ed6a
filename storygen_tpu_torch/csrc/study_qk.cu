// Bare q k^T with a kv sum, int8 or bf16, for Hopper (sm_90a).
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
// query. Every block streams its head's whole K from L2 (Sq / BQ times
// per head), which at BQ = 128 is a floor near half the tensor-core
// bound. mma.sync m16n8k32 (int8; an m16n8k16 tail for D = 40, whose rows
// are zero-padded to 48 bytes in shared memory) or m16n8k16 (bf16).
//
// Design: one block per (BQ queries, head), one warp per 32 queries (two
// 16-row halves, so that each B fragment serves two products), a few
// accumulators per half so that the products of one step do not wait on
// each other. The q_t slab (D rows of BQ queries, the TPU's layout) is
// copied once with 16-byte cp.async, untransposed; the A fragments come
// from it by a transposing ldmatrix (bf16) or by 32-bit loads of four d
// rows and byte permutes (int8), and stay in registers. K tiles of BK rows
// arrive through a ring of STAGES shared buffers (ring_stages), one
// barrier per tile, the next tiles' copies in flight while the tensor
// cores work: bf16 rows (80 bytes) by 16-byte cp.async into a 112-byte
// pitch, zero-filled past D and read by ldmatrix; an int8 tile, whose
// 40-byte rows are one contiguous run in HBM but not 16-byte aligned each,
// by 16-byte cp.async into a dense tile read by 32-bit loads (8-byte
// copies into a 48-byte pitch read by ldmatrix ran slower).
#include <type_traits>

#include "study_mma.cuh"

using namespace sg_study;

namespace {

template <bool I8, int DP, int BQ, int BK>
struct Cfg {
  static constexpr int EB = I8 ? 1 : 2;  // bytes per element
  static constexpr int NT = 32 * BQ / 32;
  static constexpr int QPITCH = pitch_bytes(BQ * EB);  // a d row of q_t
  static constexpr int QBYTES = align128(DP * QPITCH);
  // a K row: bf16 at an ldmatrix pitch; int8 rows dense (D bytes apart,
  // D <= DP), this the tile's upper bound
  static constexpr int PITCH = I8 ? DP : pitch_bytes(DP * EB);
  static constexpr int STAGE = align128(BK * PITCH);
  static constexpr int STAGES = ring_stages(STAGE);
  static constexpr int BYTES = QBYTES + STAGES * STAGE;
  // 16 warps an SM: 128 registers a thread
  static constexpr int MINB = 512 / NT;
  static_assert(BYTES <= 232448, "a block's shared memory");
};

constexpr int NACC = 2;  // accumulators per 16-row half

// The int8 A fragments of the 16 queries from `q` on (a column of the
// untransposed slab: DPB rows of d, pitch bytes apart, one byte per
// query): the four bytes of each register are four consecutive d of one
// query, gathered from four 32-bit loads by byte permutes.
template <int DPB>
__device__ __forceinline__ void load_a_s8_t(
    uint32_t (&a)[(DPB + 31) / 32][4], const unsigned char* slab, int pitch,
    int q, int lane) {
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
  for (int kk = 0; kk < DPB / 32; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = gather(32 * kk + 16 * (r / 2) + 4 * tq, grp + 8 * (r % 2));
  if constexpr (DPB % 32 != 0) {
    a[DPB / 32][0] = gather(32 * (DPB / 32) + 4 * tq, grp);
    a[DPB / 32][1] = gather(32 * (DPB / 32) + 4 * tq, grp + 8);
  }
}

// The bf16 A fragments of the 16 queries from `q` on, from the
// untransposed slab (KS * 16 rows of d, pitch bytes apart): one
// transposing x4 ldmatrix per 16 d.
template <int KS>
__device__ __forceinline__ void load_a_bf16_t(uint32_t (&a)[KS][4],
                                              const unsigned char* slab,
                                              int pitch, int q, int lane) {
  const unsigned char* p = slab + (lane % 8 + 8 * (lane / 16)) * pitch +
                           2 * q + 16 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_x4_t(a[kk], p + 16 * kk * pitch);
}

template <bool I8, int DP, int BQ, int BK>
__global__ void __launch_bounds__(Cfg<I8, DP, BQ, BK>::NT,
                                  Cfg<I8, DP, BQ, BK>::MINB)
qk_kernel(const unsigned char* __restrict__ qt,
          const unsigned char* __restrict__ k, float* __restrict__ out,
          int Sq, int Skv, int D) {
  using C = Cfg<I8, DP, BQ, BK>;
  constexpr int NTK = BK / 8, STAGES = C::STAGES;
  constexpr int KS = I8 ? (DP + 31) / 32 : DP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int wq = warp * 32;  // the warp's first query in the block
  unsigned char* ring = smem + C::QBYTES;
  const unsigned char* kh = k + bh * Skv * D * C::EB;
  const int ntiles = Skv / BK;
  auto fetch = [&](int t, int stage) {
    unsigned char* st = ring + stage * C::STAGE;
    if constexpr (I8)
      copy_run16<C::NT>(st, kh + (long long)t * BK * D, BK * D, tid);
    else
      copy_tile_lean<BK, DP / 8, C::PITCH, C::NT>(
          st, reinterpret_cast<const bf16*>(kh), D, t * BK, Skv, D, tid);
  };

  // group 0: the q_t slab, d rows past D zero-filled; then one group per
  // ring stage but the last
  {
    constexpr int CPR = BQ * C::EB / 16;
    const unsigned char* src = qt + (bh * D * Sq + q0) * C::EB;
#pragma unroll 1
    for (int idx = tid; idx < DP * CPR; idx += C::NT) {
      const int d = idx / CPR, c = idx % CPR;
      cp_async16(smem + d * C::QPITCH + 16 * c,
                 d < D ? src + (long long)d * Sq * C::EB + 16 * c : src,
                 d < D ? 16 : 0);
    }
  }
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) fetch(s, s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  uint32_t a[2][KS][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (I8)
      load_a_s8_t<DP>(a[h], smem, C::QPITCH, wq + 16 * h, lane);
    else
      load_a_bf16_t<KS>(a[h], smem, C::QPITCH, wq + 16 * h, lane);
  }
  // int8: one tile's int32 sums; bf16: the fp32 sums of every tile
  using Acc = typename std::conditional<I8, int, float>::type;
  Acc c[2][NACC][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < NACC; ++i) c[h][i][0] = c[h][i][1] = c[h][i][2] =
        c[h][i][3] = 0;
  float tot[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [half][row grp / grp + 8]

  // bf16 B fragments: two n tiles per x4 ldmatrix
  const int boff = (lane % 8 + 8 * (lane / 16)) * C::PITCH +
                   16 * ((lane / 8) % 2);
  int cs = 0, ls = STAGES - 1;  // ring stages of the tile in use / to fill
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t
    // every thread's copies have landed, and every warp is done with the
    // stage that the copies below overwrite
    __syncthreads();
    if (t + STAGES - 1 < ntiles) fetch(t + STAGES - 1, ls);
    cp_async_commit();
    ls = ls + 1 == STAGES ? 0 : ls + 1;
    const unsigned char* ks = ring + cs * C::STAGE;
    cs = cs + 1 == STAGES ? 0 : cs + 1;

    if constexpr (I8) {
      // B fragments from the dense tile by 32-bit loads (qk_s8_dense),
      // each serving both halves
      const int grp = lane / 4, tq = lane % 4;
#pragma unroll
      for (int j = 0; j < NTK; ++j) {
        const unsigned char* r = ks + (8 * j + grp) * D + 4 * tq;
#pragma unroll
        for (int kk = 0; kk < DP / 32; ++kk) {
          const uint32_t b0 = ld32(r + 32 * kk), b1 = ld32(r + 32 * kk + 16);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mma_s8_k32(c[h][j % NACC], a[h][kk], b0, b1);
        }
        if constexpr (DP % 32 != 0) {
          const bool in = 32 * (DP / 32) + 4 * tq < D;
          const uint32_t b0 = in ? ld32(r + 32 * (DP / 32)) : 0u;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mma_s8_k16(c[h][j % NACC], a[h][DP / 32][0], a[h][DP / 32][1],
                       b0);
        }
      }
      // the tile's exact int32 sum per query, then fp32 across tiles
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int part[2] = {0, 0};
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
          part[0] += c[h][i][0] + c[h][i][1];
          part[1] += c[h][i][2] + c[h][i][3];
          c[h][i][0] = c[h][i][1] = c[h][i][2] = c[h][i][3] = 0;
        }
        tot[h][0] += static_cast<float>(quad_sum(part[0]));
        tot[h][1] += static_cast<float>(quad_sum(part[1]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < NTK; j += 2)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t b[4];
          ldsm_x4(b, ks + boff + j * 8 * C::PITCH + 32 * kk);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma_bf16(c[h][0], a[h][kk], b[0], b[1]);
            mma_bf16(c[h][1], a[h][kk], b[2], b[3]);
          }
        }
    }
  }
  if constexpr (!I8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        part[0] += c[h][i][0] + c[h][i][1];
        part[1] += c[h][i][2] + c[h][i][3];
      }
      tot[h][0] = quad_sum(part[0]);
      tot[h][1] = quad_sum(part[1]);
    }
  }
  if (lane % 4 == 0) {
    float* o = out + bh * Sq + q0 + wq + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[16 * h] = tot[h][0];
      o[16 * h + 8] = tot[h][1];
    }
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
// contiguous and 16-byte aligned; out (BH, Sq) fp32. D a multiple of 8,
// Sq % bq == 0 and Skv % bk == 0. The instantiations built are the
// SG_BUILT / SG_TILES4 lines below; any other returns
// cudaErrorInvalidValue.
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
