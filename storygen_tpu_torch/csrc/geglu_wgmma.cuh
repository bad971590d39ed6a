// Kernel G (geglu_matmul.cu) on Hopper's own instructions (sm_90a):
//   out (M, E) = bf16(value * gelu(gate)) @ W^T + bias,  [value | gate] = proj
// with proj (M, 2N) and W the nn.Linear weight (E, N). Replaces
// _geglu_kernel of storygen_tpu/ops/pallas_geglu.py (:50, its pallas_call
// :107).
//
// What bounds it on the H100, by site (serving's CFG batch 3):
// - The first two levels (12288 rows at N 1280 -> E 320, 3072 at 2560 ->
//   640): the bytes of proj, the largest activation of a transformer block
//   (63 MB at the first level, more than the 50 MB L2), read once.
// - The third level (768 rows, 5120 -> 1280): tensor-core work, 2 M N E
//   operations, 10 us at 989 TFLOP/s; the mid block (192 rows): W's 13.1
//   MB, read once per call.
// - Everywhere, the exact gelu: one erf per gate element and E tile, about
//   22 FP32 instructions each, as much ALU time as the products take at
//   E tiles of 320 columns. So the gated product is formed once per
//   element and block, with the widest E tile the accumulators allow.
//
// What the design does:
// - Products by wgmma.mma_async m64nWNk16 (bf16 in, fp32 accumulators in
//   registers) with A in registers and B = W read from shared memory
//   through a descriptor, K-major (the transpose bit clear: a W row is one
//   output column's N inputs). A block owns 64 WGC rows (WGC consumer
//   warpgroups of one 64-row tile each) by BE = NB x WN output columns
//   (E = 320 whole as two N = 160 products), so every gate element's gelu
//   is computed once per block and E tile.
// - Copies by TMA from one thread of the producer into a ring of STAGES
//   stages with full and empty mbarriers. Beside one consumer warpgroup
//   the producer is a warp, and the consumers keep the 255 registers a
//   thread may hold (222 used by the 160 accumulators of a 320-column
//   tile); beside two or three it is a warpgroup that gives its registers
//   to them by setmaxnreg (a producer warp would leave them the 168 / 128
//   of the SM sub-partition that holds three / four warps, and the
//   320-column tile spilled there). A stage holds three kinds of box of BK
//   inner columns, each row of 2 BK bytes swizzled over its own span (128
//   bytes at BK = 64, 64 at BK = 32): the value box at (k0, m0) and the
//   gate box at (N + k0, m0) of one 2-D tensor map over proj seen as (2N,
//   M), and NB W boxes (BK, WN) at (k0, e0 + p WN) of a map over W seen as
//   (N, E). TMA fills rows past M and past E with zeros (v * gelu(0) = 0;
//   those rows and columns are not stored).
// - The gated product formed in registers, never stored: each consumer
//   warp loads the value and the gate fragment of its 16 rows by ldmatrix
//   from the swizzled boxes (the same addresses in both, so the two
//   fragments share one layout) and forms bf16(v * gelu(g)) pair by pair:
//   that is the register-A fragment of the next k step. It is computed
//   while the wgmma of the step before runs. No write-back, no proxy
//   fence, no block-wide barrier a stage: a consumer thread arrives on a
//   stage's empty barrier once the wgmma of the next stage's first k step
//   has been issued and the step before it has completed.
// - The gelu is the erf form, 0.5 g (1 + erf(g / sqrt 2)), with the
//   rational erf that XLA and Eigen use for fp32 (x p(x^2) / q(x^2),
//   degrees 13 and 8, clamped to [-4, 4];
//   tests/test_torch_port_geglu_tiles.py holds it within 1e-6 of erf).
// - Split of the N reduction where the site has few rows (ops/geglu.py's
//   split plan, a function of the rows per image, N and E, never of the
//   batch): the split's blocks of one output tile form a thread block
//   cluster (1, 1, split), blockIdx.z walks its run of whole BK steps, and
//   each block leaves its fp32 partial tile in its own shared memory (over
//   the consumed ring). After a cluster barrier block z adds a z-th of the
//   tile over the cluster's blocks in split order, reading its peers'
//   shared memory, and stores it: a row's result is the same bit for bit
//   at every batch and every order of arrival, and no partial sum reaches
//   device memory. No float atomics, no scratch, no second launch.
// - The epilogue from the accumulators (or the cluster's sums): the bias
//   (bf16 or fp32, read as stored) in fp32, bf16 pairs straight into (M,
//   E).
#pragma once
#include <math.h>

#include <type_traits>

#include "hopper.cuh"
#include "study_mma.cuh"

namespace sg_geglu {

using namespace sg_hopper;
using namespace sg_study;

struct GegluArgs {
  const bf16* proj;  // (M, 2N)
  const bf16* w;     // (E, N)
  const void* bias;  // (E), bf16 or fp32
  bf16* out;         // (M, E)
  int M, N, E;
};

// A block of WGC consumer warpgroups (64 rows each) and a producer (a
// warp beside one consumer warpgroup, else a warpgroup); BE output columns
// as BE / WN products of N = WN; inner steps of BK columns in a ring of
// STAGES stages.
template <int WGC, int BE, int WN, int BK, int STAGES>
struct GegluCfg {
  static constexpr int BM = 64 * WGC;
  static constexpr int NB = BE / WN;
  static constexpr int NTC = 128 * WGC;  // consumer threads
  static constexpr int NT = NTC + (WGC == 1 ? 32 : 128);  // and the producer
  // Registers a thread. One consumer warpgroup and a producer warp keep
  // the 255 a thread may hold (an SM sub-partition holds two of the five
  // warps). Two or three consumer warpgroups launch beside a producer
  // warpgroup at 168 / 128, then the producer drops to 40 by setmaxnreg
  // and the consumers rise to 232 / 152 (conv_wgmma.cuh's pool).
  static constexpr int REGS = 512 / (WGC + 1) / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int RISE = (REGS + (REGS - PRODUCER_REGS) / WGC) / 8 * 8;
  static constexpr int CONSUMER_REGS = RISE > 240 ? 240 : RISE;
  static constexpr int RB = 2 * BK;           // a row's bytes = its swizzle
  static constexpr int ATILE = BM * RB;       // the value or the gate box
  static constexpr int WPANEL = WN * RB;      // one W box
  static constexpr int STAGE = 2 * ATILE + NB * WPANEL;  // bytes it lands
  static constexpr int RING = STAGES * STAGE;
  // a split's fp32 partial tile, over the ring once it is consumed: rows of
  // BE + 8 floats (a row 8 banks on from the one before)
  static constexpr int PITCH = BE + 8;
  static constexpr int PART = BM * PITCH * 4;
  // 1 KB to align the ring to the swizzles' 1024-byte period, the full and
  // empty barriers
  static constexpr int BYTES =
      1024 + (RING > PART ? RING : PART) + 16 * STAGES;
  static_assert(WGC >= 1 && WGC <= 3, "one to three consumer warpgroups");
  static_assert(BE % WN == 0 && WN % 16 == 0 && WN <= 256,
                "whole products of N <= 256");
  static_assert(BK == 32 || BK == 64, "a 64- or 128-byte swizzle span");
  static_assert(STAGES >= 2, "a ring");
  static_assert(ATILE % 1024 == 0 && WPANEL % 1024 == 0,
                "every box on a swizzle period");
  static_assert(WGC == 1 || (WGC * CONSUMER_REGS + PRODUCER_REGS <= 512 &&
                             REGS - PRODUCER_REGS >=
                                 WGC * (CONSUMER_REGS - REGS)),
                "the consumers' increase fits the producer's release");
  static_assert(BYTES <= 232448, "a block's shared memory");
};

// erf(x) as x p(x^2) / q(x^2) on [-4, 4], where erf is +-1 in fp32 beyond
__device__ __forceinline__ float erf_of(float x) {
  const float xc = fminf(fmaxf(x, -4.f), 4.f), x2 = xc * xc;
  float p = fmaf(x2, -2.72614225801306e-10f, 2.77068142495902e-08f);
  p = fmaf(x2, p, -2.10102402082508e-06f);
  p = fmaf(x2, p, -5.69250639462346e-05f);
  p = fmaf(x2, p, -7.34990630326855e-04f);
  p = fmaf(x2, p, -2.95459980854025e-03f);
  p = fmaf(x2, p, -1.60960333262415e-02f);
  float q = fmaf(x2, -1.45660718464996e-05f, -2.13374055278905e-04f);
  q = fmaf(x2, q, -1.68282697438203e-03f);
  q = fmaf(x2, q, -7.37332916720468e-03f);
  q = fmaf(x2, q, -1.42647390514189e-02f);
  return __fdividef(xc * p, q);
}

// bf16(v * gelu(g)) of a bf16 pair
__device__ __forceinline__ uint32_t gated2(uint32_t v, uint32_t g) {
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&g));
  constexpr float R = 0.7071067811865476f;  // 1 / sqrt(2)
  // gelu(g) = h + h erf(g / sqrt 2), h = g / 2: one fma for the (1 + erf)
  const float hx = 0.5f * b.x, hy = 0.5f * b.y;
  return pack_bf16(a.x * fmaf(hx, erf_of(b.x * R), hx),
                   a.y * fmaf(hy, erf_of(b.y * R), hy));
}

__device__ __forceinline__ float bias_at(const float* b, int i) { return b[i]; }
__device__ __forceinline__ float bias_at(const bf16* b, int i) {
  return __bfloat162float(b[i]);
}

// grid (ceil(E / BE), ceil(M / BM), split), a cluster of the split's
// blocks of one output tile: the E tiles of one M tile are neighbours in
// launch order, so their re-reads of proj hit L2
template <int WGC, int BE, int WN, int BK, int STAGES, bool BIAS32>
__global__ void __launch_bounds__(128 * WGC + (WGC == 1 ? 32 : 128), 1)
    geglu_wg_kernel(const __grid_constant__ CUtensorMap tmp,
                    const __grid_constant__ CUtensorMap tmw,
                    const GegluArgs a) {
  using C = GegluCfg<WGC, BE, WN, BK, STAGES>;
  using BT = typename std::conditional<BIAS32, float, bf16>::type;
  constexpr int RB = C::RB, KS = BK / 16, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  // full: the stage's boxes landed; empty: every consumer is done with it
  const uint32_t full = base + (C::RING > C::PART ? C::RING : C::PART);
  const uint32_t empty = full + 8 * STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int e0 = blockIdx.x * BE, m0 = blockIdx.y * C::BM;
  const int split = gridDim.z, z = blockIdx.z;
  const BT* bias = static_cast<const BT*>(a.bias);
  // this block's run of inner steps [k0, k0 + steps)
  const int nk = a.N / BK, k0 = z * nk / split;
  const int steps = (z + 1) * nk / split - k0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, C::NTC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WGC) {  // the producer: one thread issues every copy
    if constexpr (WGC > 1) setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == 4 * WGC && lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES + 1) & 1);
        const uint32_t bar = full + 8 * s, st = base + s * C::STAGE;
        const int k = (k0 + i) * BK;
        mbar_expect_tx(bar, C::STAGE);
        tma_load_2d(st, &tmp, bar, k, m0);                   // value
        tma_load_2d(st + C::ATILE, &tmp, bar, a.N + k, m0);  // gate
#pragma unroll
        for (int p = 0; p < NB; ++p)
          tma_load_2d(st + 2 * C::ATILE + p * C::WPANEL, &tmw, bar, k,
                      e0 + p * WN);
      }
    }
    if (split > 1) {  // the cluster's two barriers of the reduction below
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // the consumers: warp w of warpgroup g owns rows 64 g + 16 w .. + 15
  if constexpr (WGC > 1) setmaxnreg_inc<C::CONSUMER_REGS>();
  const int g = warp / 4, w = warp % 4;
  // this lane's ldmatrix row in the value and gate boxes, and its 8-column
  // half of a 16-column k step
  const int R = 64 * g + 16 * w + lane % 8 + 8 * ((lane / 8) % 2);
  const int half = lane / 16;

  float acc[NB][WN / 2];
#pragma unroll
  for (int p = 0; p < NB; ++p)
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[p][i] = 0.f;
  uint32_t frag[2][4];  // A of this k step and of the one in flight

  for (int i = 0; i < steps; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    const uint32_t st = base + s * C::STAGE, ws = st + 2 * C::ATILE;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t(&af)[4] = frag[kk & 1];
      uint32_t v[4], gt[4];
      const uint32_t off = R * RB + 16 * swz_unit<RB>(R, 2 * kk + half);
      ldsm_x4_at(v, st + off);
      ldsm_x4_at(gt, st + C::ATILE + off);
#pragma unroll
      for (int j = 0; j < 4; ++j) af[j] = gated2(v[j], gt[j]);
      wg_fence();
      // K-major W rows of RB bytes: SBO 8 rows, the k step 32 bytes on
#pragma unroll
      for (int p = 0; p < NB; ++p)
        WgMma<WN>::template run<0>(
            acc[p], af,
            smem_desc(ws + p * C::WPANEL + 32 * kk, 0, 8 * RB, RB));
      wg_commit();
      wg_wait<1>();  // the step before is done: its fragment is free
      // and so, at a stage's first step, is the stage before
      if (kk == 0 && i > 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int p = 0; p < NB; ++p) fence_regs(acc[p]);

  // acc[p][4 j + 2 h + e] is row 16 w + lane / 4 + 8 h of the warpgroup's
  // tile, column p WN + 8 j + 2 (lane % 4) + e of the block's
  const int grp = lane / 4, tq = lane % 4;
  if (split == 1) {  // bias in fp32, bf16 pairs into (M, E)
    const int row0 = m0 + 64 * g + 16 * w + grp;
#pragma unroll
    for (int p = 0; p < NB; ++p)
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = e0 + p * WN + 8 * j + 2 * tq;
        if (col >= a.E) continue;
        const float b0 = bias_at(bias, col), b1 = bias_at(bias, col + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row < a.M)
            *reinterpret_cast<uint32_t*>(a.out + (long long)row * a.E +
                                         col) =
                pack_bf16(acc[p][4 * j + 2 * h] + b0,
                          acc[p][4 * j + 2 * h + 1] + b1);
        }
      }
    return;
  }

  // The split's reduction in the cluster: each block's fp32 partial tile
  // goes to its own shared memory (over the consumed ring), then block z
  // adds a z-th of the tile over the cluster's blocks in split order, adds
  // the bias and stores bf16.
  named_bar_sync(1, C::NTC);  // every consumer is done with the ring
  float* part = reinterpret_cast<float*>(
      smem_raw + (base - smem_addr(smem_raw)));
#pragma unroll
  for (int p = 0; p < NB; ++p)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            part + (64 * g + 16 * w + grp + 8 * h) * C::PITCH + p * WN +
            8 * j + 2 * tq) =
            make_float2(acc[p][4 * j + 2 * h], acc[p][4 * j + 2 * h + 1]);
  cluster_sync();
  constexpr int Q = BE / 4;  // 4-column pieces a row
  const int lo = z * (C::BM * Q) / split;
  const int hi = (z + 1) * (C::BM * Q) / split;
  constexpr int U = 4;  // pieces a thread has in flight
  for (int i0 = lo + tid; i0 < hi; i0 += U * C::NTC) {
    float4 sum[U];
#pragma unroll
    for (int u = 0; u < U; ++u) sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < split; ++s) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * C::NTC;
        if (i < hi) {
          const float4 v = ld_cluster_f4(cluster_map(
              base + 4 * ((i / Q) * C::PITCH + 4 * (i % Q)), s));
          sum[u].x += v.x;
          sum[u].y += v.y;
          sum[u].z += v.z;
          sum[u].w += v.w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * C::NTC;
      const int row = m0 + i / Q, col = e0 + 4 * (i % Q);
      if (i >= hi || row >= a.M || col >= a.E) continue;
      *reinterpret_cast<uint2*>(a.out + (long long)row * a.E + col) =
          make_uint2(pack_bf16(sum[u].x + bias_at(bias, col),
                               sum[u].y + bias_at(bias, col + 1)),
                     pack_bf16(sum[u].z + bias_at(bias, col + 2),
                               sum[u].w + bias_at(bias, col + 3)));
    }
  }
  cluster_sync();  // no block leaves while a peer reads its tile
}

// ---- host side

// The tensor maps of one call: proj as (2N, M) in (BK, BM) boxes, W as
// (N, E) in (BK, WN) boxes, both swizzled over 2 BK bytes; out-of-range
// elements read as zero.
inline bool encode_maps(const GegluArgs& a, int bk, int bm, int wn,
                        CUtensorMap* tmp, CUtensorMap* tmw) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t e = sizeof(bf16);
  const cuuint32_t ones[2] = {1, 1};
  const cuuint64_t pdim[2] = {2 * (cuuint64_t)a.N, (cuuint64_t)a.M};
  const cuuint64_t pstr[1] = {2 * e * a.N};
  const cuuint32_t pbox[2] = {(cuuint32_t)bk, (cuuint32_t)bm};
  if (enc(tmp, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
          const_cast<bf16*>(a.proj), pdim, pstr, pbox, ones,
          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(2 * bk),
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  const cuuint64_t wdim[2] = {(cuuint64_t)a.N, (cuuint64_t)a.E};
  const cuuint64_t wstr[1] = {e * a.N};
  const cuuint32_t wbox[2] = {(cuuint32_t)bk, (cuuint32_t)wn};
  return enc(tmw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<bf16*>(a.w), wdim, wstr, wbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(2 * bk),
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch of an instantiation on the grid (ceil(E / BE), ceil(M / BM),
// split) in clusters of (1, 1, split); cudaErrorInvalidValue for operands
// it does not take (N not a multiple of BK, E not a multiple of 8, a split
// outside [1, min(8, N / BK)]).
template <int WGC, int BE, int WN, int BK, int STAGES, bool BIAS32>
cudaError_t wg_launch(const GegluArgs& a, int split, cudaStream_t stream) {
  using C = GegluCfg<WGC, BE, WN, BK, STAGES>;
  if (a.M < 1 || a.N % BK != 0 || a.E % 8 != 0 || split < 1 || split > 8 ||
      split > a.N / BK)
    return cudaErrorInvalidValue;
  CUtensorMap tmp, tmw;
  if (!encode_maps(a, BK, C::BM, WN, &tmp, &tmw)) return cudaErrorInvalidValue;
  constexpr auto kern = geglu_wg_kernel<WGC, BE, WN, BK, STAGES, BIAS32>;
  cudaError_t err = smem_limit_once<kern>(C::BYTES);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.E + BE - 1) / BE, (a.M + C::BM - 1) / C::BM, split);
  cfg.blockDim = dim3(C::NT);
  cfg.dynamicSmemBytes = C::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = split;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, tmp, tmw, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace sg_geglu
