// Kernel G, the fused GEGLU -> output GEMM for Hopper (sm_90a):
//   out (M, E) = bf16(value * gelu(gate)) @ W^T + bias,  [value | gate] = proj.
//
// Replaces _geglu_kernel in storygen_tpu/ops/pallas_geglu.py (called
// through geglu_matmul).
//
// What bounds it on the H100: the feed-forward's packed projection is the
// largest activation of a transformer block ((3*4096, 2*1280) bf16 = 63 MB
// at the first level of a 3-row CFG batch, more than the 50 MB L2). The
// function needs the projection read once and the output written once;
// the GEMM (2 M N E operations) is tensor-core work below that line at
// E = 320, and the exact gelu (one erf per gate element) is ALU work of
// about the same size as the bytes.
//
// What the design does about it:
// - Full-width output blocks, as the TPU kernel's (BM, E) block: a block
//   owns BM rows by BE output columns with BE = E where the accumulators
//   fit (E = 320), so the projection is read from HBM once and every gelu
//   is computed once. Where E is wider, blockIdx.x walks the E tiles
//   fastest: the blocks that share projection rows run together and their
//   re-reads of those rows hit L2.
// - Products are mma.sync m16n8k16 (bf16 in, fp32 accumulators in
//   registers) with ldmatrix fragments (study_mma.cuh). A warp owns MT
//   16-row tiles by NTE 8-column tiles; WM x WE warps cover the block. The
//   gated product is the A operand; W, stored as the nn.Linear weight
//   (E, N), is the B operand read by the non-transposing ldmatrix from
//   its rows, as the flash forward reads K.
// - Value, gate and W tiles of BK inner columns arrive through a ring of
//   STAGES shared buffers filled by cp.async 16-byte copies: the copies of
//   step i + STAGES - 1 start before step i's products. Rows past M and
//   past E are zero-filled by the copy's src-size operand. Rows are an
//   odd number of 16-byte units apart, so ldmatrix is free of bank
//   conflicts.
// - The gated product is formed once per element per block, in shared
//   memory, in place: a thread copies the value and the gate piece of the
//   same 16 bytes, and once its own copies of a step have landed it
//   writes bf16(v * gelu(g)) over the value piece, halfway through the
//   previous step's products, so that the arithmetic overlaps other warps'
//   products and the step's barrier publishes it (kernel P's prologue in
//   conv_mma.cuh works the same way). The gelu is the erf form,
//   0.5 g (1 + erf(g / sqrt 2)), with the rational erf that XLA and Eigen
//   use for fp32 (x p(x^2) / q(x^2), degrees 13 and 8, clamped to [-4, 4];
//   tests/test_torch_port_geglu_tiles.py holds it within 1e-6 of erf): on
//   the card it ran faster than CUDA's erff and than the TPU kernel's
//   Abramowitz & Stegun 7.1.26 form (PERF.md), with fewest instructions
//   and no branch.
// - Split-K for few rows (the mid block's 192 rows, L3's 768): SPLIT
//   blocks share an output tile, each walking its own range of inner
//   steps, and write fp32 partial sums to a scratch (SPLIT, M, E) that the
//   wrapper allocates. The last block of a tile to arrive (a counter per
//   tile, which it resets to 0) adds the SPLIT partials in split order, so
//   the result does not depend on the order of arrival.
// - The epilogue from registers: each lane adds the bias (bf16 or fp32, a
//   template parameter, read as it is stored) in fp32 and stores bf16
//   pairs straight into (M, E). No fp32 staging tile.
//
// Not yet: wgmma, TMA and warp specialisation.
#include <math.h>

#include "study_mma.cuh"

using namespace sg_study;

namespace {

// The classes of M that pick an instantiation together with E (mirrored by
// ops/geglu.py::m_class): the mid block's rows, L3's, and the rest.
__host__ __device__ inline int m_class(int m) {
  return m <= 512 ? 0 : (m <= 2048 ? 1 : 2);
}

template <int BM, int BE, int BK, int WM, int WE, int STAGES>
struct GegluCfg {
  static constexpr int NT = 32 * WM * WE;       // threads
  static constexpr int MT = BM / (16 * WM);     // 16-row tiles a warp
  static constexpr int NTE = BE / (8 * WE);     // 8-column tiles a warp
  static constexpr int KS = BK / 16;            // 16-deep k steps a tile
  static constexpr int CPR = BK / 8;            // 16-byte pieces a row
  static constexpr int PITCH = pitch_bytes(BK * 2);
  static constexpr int ATILE = align128(BM * PITCH);  // value or gate
  static constexpr int WTILE = align128(BE * PITCH);
  static constexpr int STAGE = 2 * ATILE + WTILE;
  static constexpr int BYTES = STAGES * STAGE;
  static_assert(BM % (16 * WM) == 0, "whole 16-row tiles per warp");
  static_assert(BE % (16 * WE) == 0, "pairs of 8-column tiles per warp");
  static_assert(BK % 16 == 0 && STAGES >= 2, "16-deep k steps, a ring");
  static_assert(BYTES <= 232448, "a block's shared memory");
};

struct GegluArgs {
  const bf16* proj;  // (M, 2N)
  const bf16* w;     // (E, N)
  const void* bias;  // (E), bf16 or fp32
  bf16* out;         // (M, E)
  float* part;       // (SPLIT, M, E) fp32 partial sums, split > 1 only
  int* count;        // one counter per output tile, 0 between launches
  int M, N, E;
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

// bf16(v * gelu(g)) of 8 consecutive elements held as 16-byte pieces
__device__ __forceinline__ uint4 gated8(uint4 v, uint4 g) {
  union {
    uint4 u;
    __nv_bfloat162 h[4];
  } pv, pg;
  pv.u = v;
  pg.u = g;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(pv.h[i]);
    const float2 b = __bfloat1622float2(pg.h[i]);
    constexpr float R = 0.7071067811865476f;  // 1 / sqrt(2)
    const float ga = 0.5f * b.x * (1.f + erf_of(b.x * R));
    const float gb = 0.5f * b.y * (1.f + erf_of(b.y * R));
    pv.h[i] = __floats2bfloat162_rn(a.x * ga, a.y * gb);
  }
  return pv.u;
}

__device__ __forceinline__ float bias_at(const float* b, int i) { return b[i]; }
__device__ __forceinline__ float bias_at(const bf16* b, int i) {
  return __bfloat162float(b[i]);
}

template <int BM, int BE, int BK, int WM, int WE, int STAGES, class BT>
__global__ void __launch_bounds__(32 * WM * WE)
geglu_mma_kernel(const GegluArgs a) {
  using C = GegluCfg<BM, BE, BK, WM, WE, STAGES>;
  constexpr int MT = C::MT, NTE = C::NTE, KS = C::KS, CPR = C::CPR;
  constexpr int PITCH = C::PITCH;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;  // split-K: did this block arrive last at its tile
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % WM, we = warp / WM;
  const int e0 = blockIdx.x * BE, m0 = blockIdx.y * BM;
  const int split = gridDim.z, z = blockIdx.z;
  // this block's inner steps [k0, k0 + steps)
  const int nk = a.N / BK, per = (nk + split - 1) / split;
  const int k0 = z * per, steps = max(0, min(nk, k0 + per) - k0);
  const long long prs = 2LL * a.N;  // row stride of proj

  auto fetch = [&](int step, int stage) {
    unsigned char* st = smem + stage * C::STAGE;
    const int n0 = (k0 + step) * BK;
    // value and gate piece idx go to the same thread (see gate())
#pragma unroll
    for (int i = 0; i < (BM * CPR + C::NT - 1) / C::NT; ++i) {
      const int idx = tid + i * C::NT;
      if ((BM * CPR) % C::NT == 0 || idx < BM * CPR) {
        const int r = idx / CPR, c = idx % CPR;
        const bool in = m0 + r < a.M;
        const bf16* src = a.proj + (m0 + r) * prs + n0 + 8 * c;
        cp_async16(st + r * PITCH + 16 * c, in ? src : a.proj, in ? 16 : 0);
        cp_async16(st + C::ATILE + r * PITCH + 16 * c,
                   in ? src + a.N : a.proj, in ? 16 : 0);
      }
    }
#pragma unroll
    for (int i = 0; i < (BE * CPR + C::NT - 1) / C::NT; ++i) {
      const int idx = tid + i * C::NT;
      if ((BE * CPR) % C::NT == 0 || idx < BE * CPR) {
        const int r = idx / CPR, c = idx % CPR;
        const bool in = e0 + r < a.E;
        cp_async16(st + 2 * C::ATILE + r * PITCH + 16 * c,
                   in ? a.w + (long long)(e0 + r) * a.N + n0 + 8 * c : a.w,
                   in ? 16 : 0);
      }
    }
  };
  // the gated product, in place over the value pieces this thread copied
  // (a row past M was zero-filled: v * gelu(0) = 0)
  auto gate = [&](int stage) {
    unsigned char* st = smem + stage * C::STAGE;
#pragma unroll
    for (int i = 0; i < (BM * CPR + C::NT - 1) / C::NT; ++i) {
      const int idx = tid + i * C::NT;
      if ((BM * CPR) % C::NT == 0 || idx < BM * CPR) {
        const int off = (idx / CPR) * PITCH + 16 * (idx % CPR);
        uint4* v = reinterpret_cast<uint4*>(st + off);
        *v = gated8(*v, *reinterpret_cast<const uint4*>(st + C::ATILE + off));
      }
    }
  };

  // this lane's ldmatrix rows: A as load_a_bf16 reads it, B as qk_bf16
  const int arow = (wm * MT * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * PITCH +
                   16 * (lane / 16);
  const int brow = 2 * C::ATILE +
                   (we * NTE * 8 + lane % 8 + 8 * (lane / 16)) * PITCH +
                   16 * ((lane / 8) % 2);

  float acc[MT][NTE][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTE; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) fetch(s, s);
    cp_async_commit();
  }
  if (steps > 0) {  // step 0's gated product; later ones mid-loop
    cp_async_wait<STAGES - 2>();
    gate(0);
  }
  int cs = 0, ls = STAGES - 1;  // ring stages of the step in use / to fill
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step i
    // every piece of step i has landed and been gated, and every warp is
    // done with the stage that the copies below overwrite
    __syncthreads();
    if (i + STAGES - 1 < steps) fetch(i + STAGES - 1, ls);
    cp_async_commit();
    ls = ls + 1 == STAGES ? 0 : ls + 1;
    const unsigned char* st = smem + cs * C::STAGE;
    cs = cs + 1 == STAGES ? 0 : cs + 1;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk == KS / 2 && i + 1 < steps) {
        // halfway through step i, the gated product of step i + 1 (stage
        // cs now), once this thread's copies of it have landed
        cp_async_wait<STAGES - 2>();
        gate(cs);
      }
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[mt], st + arow + mt * 16 * PITCH + 32 * kk);
#pragma unroll
      for (int nt = 0; nt < NTE; nt += 2) {
        uint32_t b[4];
        ldsm_x4(b, st + brow + nt * 8 * PITCH + 32 * kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][nt], af[mt], b[0], b[1]);
          mma_bf16(acc[mt][nt + 1], af[mt], b[2], b[3]);
        }
      }
    }
  }

  const int grp = lane / 4, tq = lane % 4;
  const bool pairs = a.E % 2 == 0;
  if (split > 1) {
    // this block's partial sums, then the tile's last block adds them all
    float* part = a.part + (long long)z * a.M * a.E;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + (wm * MT + mt) * 16 + grp + 8 * h;
        if (row >= a.M) continue;
#pragma unroll
        for (int nt = 0; nt < NTE; ++nt) {
          const int col = e0 + (we * NTE + nt) * 8 + 2 * tq;
          float* p = part + (long long)row * a.E + col;
          if (pairs && col < a.E) {
            *reinterpret_cast<float2*>(p) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          } else {
            if (col < a.E) p[0] = acc[mt][nt][2 * h];
            if (col + 1 < a.E) p[1] = acc[mt][nt][2 * h + 1];
          }
        }
      }
    __threadfence();  // the partials are visible before the count
    __syncthreads();
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) last = atomicAdd(a.count + tile, 1) == split - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + (wm * MT + mt) * 16 + grp + 8 * h;
        if (row >= a.M) continue;
#pragma unroll
        for (int nt = 0; nt < NTE; ++nt) {
          const int col = e0 + (we * NTE + nt) * 8 + 2 * tq;
          float s0 = 0.f, s1 = 0.f;
          for (int s = 0; s < split; ++s) {
            const float* p = a.part + ((long long)s * a.M + row) * a.E + col;
            s0 += s == z ? acc[mt][nt][2 * h]
                         : (col < a.E ? __ldcg(p) : 0.f);
            s1 += s == z ? acc[mt][nt][2 * h + 1]
                         : (col + 1 < a.E ? __ldcg(p + 1) : 0.f);
          }
          acc[mt][nt][2 * h] = s0;
          acc[mt][nt][2 * h + 1] = s1;
        }
      }
    if (tid == 0) a.count[tile] = 0;  // ready for the next launch
  }

  // bias in fp32, bf16 pairs into (M, E)
  const BT* bias = static_cast<const BT*>(a.bias);
  float bz[NTE][2];
#pragma unroll
  for (int nt = 0; nt < NTE; ++nt) {
    const int col = e0 + (we * NTE + nt) * 8 + 2 * tq;
    bz[nt][0] = col < a.E ? bias_at(bias, col) : 0.f;
    bz[nt][1] = col + 1 < a.E ? bias_at(bias, col + 1) : 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + (wm * MT + mt) * 16 + grp + 8 * h;
      if (row >= a.M) continue;
      bf16* o = a.out + (long long)row * a.E;
#pragma unroll
      for (int nt = 0; nt < NTE; ++nt) {
        const int col = e0 + (we * NTE + nt) * 8 + 2 * tq;
        const float v0 = acc[mt][nt][2 * h] + bz[nt][0];
        const float v1 = acc[mt][nt][2 * h + 1] + bz[nt][1];
        if (pairs && col < a.E) {
          *reinterpret_cast<uint32_t*>(o + col) = pack_bf16(v0, v1);
        } else {
          if (col < a.E) o[col] = __float2bfloat16(v0);
          if (col + 1 < a.E) o[col + 1] = __float2bfloat16(v1);
        }
      }
    }
}

// One launch on the grid (ceil(E / BE), ceil(M / BM), split).
template <int BM, int BE, int BK, int WM, int WE, int STAGES, class BT>
cudaError_t launch(const GegluArgs& a, int split, cudaStream_t stream) {
  using C = GegluCfg<BM, BE, BK, WM, WE, STAGES>;
  auto kern = geglu_mma_kernel<BM, BE, BK, WM, WE, STAGES, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((a.E + BE - 1) / BE, (a.M + BM - 1) / BM, split);
  kern<<<grid, C::NT, C::BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// out (M, E) bf16 <- proj (M, 2N), w (E, N) bf16 and bias (E), fp32 where
// bias_fp32 else bf16. `part` is an fp32 scratch of split * M * E floats
// (unused without split-K), `count` a zeroed int per output tile (left
// zeroed). The instantiations built are the SG_BUILT lines below, one per
// (E, m_class(M)), mirrored by GEGLU_BUILT in ops/geglu.py; any other, or
// N not a multiple of the line's BK, returns cudaErrorInvalidValue.
extern "C" int sg_geglu_matmul(const void* proj, const void* w,
                               const void* bias, int bias_fp32, void* out,
                               void* part, void* count, int M, int N, int E,
                               void* stream) {
  GegluArgs a = {};
  a.proj = static_cast<const bf16*>(proj);
  a.w = static_cast<const bf16*>(w);
  a.bias = bias;
  a.out = static_cast<bf16*>(out);
  a.part = static_cast<float*>(part);
  a.count = static_cast<int*>(count);
  a.M = M;
  a.N = N;
  a.E = E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mc = m_class(M);
#define SG_BUILT(E_, MC_, BM_, BE_, BK_, WM_, WE_, STAGES_, SPLIT_)      \
  if (E == E_ && mc == MC_) {                                           \
    if (N % BK_ != 0 || (SPLIT_ > 1 && (!part || !count)))              \
      return static_cast<int>(cudaErrorInvalidValue);                   \
    return static_cast<int>(                                            \
        bias_fp32                                                       \
            ? launch<BM_, BE_, BK_, WM_, WE_, STAGES_, float>(a, SPLIT_, s) \
            : launch<BM_, BE_, BK_, WM_, WE_, STAGES_, bf16>(a, SPLIT_, s)); \
  }
  // (E, M class, BM, BE, BK, warps along M, warps along E, ring stages,
  // split-K): the UNet's widths 320, 640 and 1280
  SG_BUILT(320, 0, 32, 320, 64, 1, 4, 3, 4)
  SG_BUILT(320, 1, 32, 320, 64, 1, 4, 3, 1)
  SG_BUILT(320, 2, 64, 320, 64, 2, 4, 3, 1)
  SG_BUILT(640, 0, 32, 320, 64, 1, 4, 3, 4)
  SG_BUILT(640, 1, 32, 320, 64, 1, 4, 3, 2)
  SG_BUILT(640, 2, 64, 320, 64, 2, 4, 3, 1)
  SG_BUILT(1280, 0, 32, 128, 64, 1, 4, 3, 4)
  SG_BUILT(1280, 1, 64, 256, 64, 2, 4, 3, 2)
  SG_BUILT(1280, 2, 128, 256, 64, 2, 4, 3, 1)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}
