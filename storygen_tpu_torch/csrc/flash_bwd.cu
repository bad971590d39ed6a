// Flash-attention backward for Hopper (sm_90a): the gradient kernels DQ
// and DKV, one template each. With P = exp(scale q.k - lse) and
// dS = P * (dO V^T - delta):
//
//   DQ   flash_dq_kernel   replaces _dq_kernel of the TPU backward in
//        storygen_tpu/ops/pallas_attention.py (:558, its pallas_call :685):
//        dQ = scale * dS K, per block of Q rows, over the K/V tiles;
//   DKV  flash_dkv_kernel  replaces _dkv_kernel (:593, pallas_call :698):
//        dV = P^T dO and dK = scale * dS^T Q, per block of K/V rows, over
//        the Q tiles, in the transposed form the TPU kernel uses (s_t).
//
// lse comes from kernel L (flash_fwd.cu) and delta = rowsum(dO * O) from
// the caller in fp32 (plain torch, as the JAX package computes it in XLA).
// Each kernel owns its output tile and loops over the other side, so there
// are no atomics and the result is deterministic.
//
// What bounds them on the H100: tensor-core work. DQ does 3 products per
// (Q row, kept K/V row) pair (S, dP and dS K) and DKV 4 (S^T, dP^T, P^T dO
// and dS^T Q), 2 D operations each, and one exp2 per pair. At the UNet's
// 4096 x 4096 and 4096 x 12288 shapes the (Sq, Skv) logits are 16-48x
// larger than Q, K, V, dO and the gradients together, so kernels that keep
// S, P, dP and dS on chip are not bound by HBM.
//
// What the design does about it (flash_fwd.cu's, on study_mma.cuh):
// - S, P, dP and dS live in registers. Each warp owns one 16-row slice of
//   the block's BR rows: DQ's Q rows, DKV's K/V rows. S = Q K^T and
//   dP = dO V^T (DKV: S^T = K Q^T, dP^T = V dO^T) are mma.sync m16n8k16
//   products (bf16 in, fp32 accumulation) with ldmatrix fragment loads;
//   P = exp2(s scale log2(e) - lse log2(e)) and dS = P (dP - delta) are
//   computed in the accumulators, and their bf16 pairs are the A fragments
//   of dQ += dS K (DKV: dV += P^T dO, dK += dS^T Q), whose B operand a
//   transposing ldmatrix reads. dQ, dK and dV are fp32 register
//   accumulators, scaled and written once as bf16. DKV's lse and delta are
//   per column: they arrive with each Q tile as two fp32 rows.
// - The other side's tiles of BC rows arrive through a ring of STAGES
//   shared buffers filled by cp.async (16-byte copies of bf16 rows, 4-byte
//   copies of the fp32 rows): the copies of the next tile start before the
//   current tile's products, one barrier per tile. The copy zero-fills rows
//   past Skv or Sq and columns past D itself (src-size 0, reading nothing),
//   so head dim 40 runs as 48 in shared memory only. The block's own two
//   tiles take the same path once. Rows are an odd number of 16-byte units
//   apart, so ldmatrix is free of bank conflicts.
// - Registers are the limit: at d = 160, dQ holds 80 floats per thread and
//   dK plus dV 160. AREG chooses whether a warp holds its A fragments (Q
//   and dO in DQ, K and V in DKV; DP / 4 registers each) or reads them from
//   shared memory at each product, and BC how many logits a warp holds per
//   tile. The SG_BUILT lines below, chosen by studies/flash_bwd_tiles.py
//   and mirrored by BWD_BUILT in ops/flash_attention.py, give each kernel
//   and padded head dim its tile; no built instantiation spills.
//
// Edges and masking: columns past Skv (attn2's 77 text tokens) get P = 0
// in DQ; Q rows past Sq get P = 0 in DKV; rows past Sq or Skv are not
// written. With `keep` (B, N refs) over N equal spans of any length, DQ's
// ring walks only the K/V tiles that hold a kept row, and DKV writes zeros
// for a block whose rows all lie in dropped spans without loading
// anything. A tile that straddles a span boundary (spans of 16 or 144 rows
// at the mid block of a 256 or 768 px image) sets P = 0 in registers at
// its dropped columns (DQ) or rows (DKV); that is an instantiation of its
// own (STRADDLE), chosen at launch, so spans that are multiples of the K/V
// tile (the 512 px UNet) test one flag per tile. A row that keeps no span
// gets exact zeros. Inputs are read from the projections' (B, S, H*D)
// layout through batch and row strides (dO contiguous); dQ, dK, dV are
// written as (B, S, H*D).
//
// Not yet: wgmma, TMA and warp specialisation. Kernel L, the logsumexp
// that DQ and DKV read, is in flash_fwd.cu.
#include <math.h>

#include "study_mma.cuh"

using namespace sg_study;

namespace {

constexpr float LOG2E = 1.4426950408889634f;

enum Which { kDq = 1, kDkv = 2 };

// BR: the block's own rows (DQ: Q rows; DKV: K/V rows), 16 per warp; BC:
// the rows of one tile of the other side, streamed through the ring.
template <int DP, int BR, int BC, int STAGES>
struct Cfg {
  static constexpr int NT = 32 * BR / 16;  // threads
  static constexpr int PITCH = pitch_bytes(DP * 2);
  static constexpr int CPR = DP * 2 / 16;  // 16-byte chunks per row
  static constexpr int OWN = align128(BR * PITCH);   // one own tile
  static constexpr int TILE = align128(BC * PITCH);  // one streamed tile
  static constexpr int ROW = align128(BC * 4);       // one fp32 row (DKV)
  static constexpr int DQ_STAGE = 2 * TILE;              // K, V
  static constexpr int DKV_STAGE = 2 * TILE + 2 * ROW;   // Q, dO, lse, delta
  static constexpr int DQ_BYTES = 2 * OWN + STAGES * DQ_STAGE;
  static constexpr int DKV_BYTES = 2 * OWN + STAGES * DKV_STAGE;
};

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  int H, Sq, Skv, D;
  long long qb, qr, kb, kr, vb, vr;  // batch and row strides of q, k, v
  const int* keep;                   // (B, nref) or nullptr
  int nref, span;
  float scale, scale_log2;
};

// 4-byte cp.async copy (zero-filled where src_bytes is 0)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

// Start the copies of entries [row0, row0 + BC) of two fp32 rows `x` and
// `y` of length n into `dx` and `dy`; entries past n become 0.
template <int BC, int NT>
__device__ __forceinline__ void copy_rows2(float* dx, float* dy,
                                           const float* x, const float* y,
                                           int row0, int n, int tid) {
#pragma unroll
  for (int i = 0; i < (2 * BC + NT - 1) / NT; ++i) {
    const int idx = tid + i * NT;
    if ((2 * BC) % NT == 0 || idx < 2 * BC) {
      const int r = idx % BC;
      const bool in = row0 + r < n;
      const float* src = idx < BC ? x : y;
      cp_async4((idx < BC ? dx : dy) + r, in ? src + row0 + r : src,
                in ? 4 : 0);
    }
  }
}

// S (16 x 8 NTL tiles) += A B^T for a warp: A's 16 rows x DP from its
// registers `a` (AREG) or from the shared rows at `arows`, B's NTL * 8
// rows from `brows`, both at pitch PITCH.
template <int KS, int NTL, int PITCH, bool AREG>
__device__ __forceinline__ void abt(float (&s)[NTL][4],
                                    const uint32_t (&a)[AREG ? KS : 1][4],
                                    const unsigned char* arows,
                                    const unsigned char* brows, int lane) {
  if constexpr (AREG) {
    qk_bf16<KS, NTL>(s, a, brows, PITCH, lane);
  } else {
    const unsigned char* pa = arows +
                              (lane % 8 + 8 * ((lane / 8) % 2)) * PITCH +
                              16 * (lane / 16);
    const unsigned char* pb =
        brows + (lane % 8 + 8 * (lane / 16)) * PITCH + 16 * ((lane / 8) % 2);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, pa + 32 * kk);
#pragma unroll
      for (int j = 0; j < NTL; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, pb + j * 8 * PITCH + 32 * kk);
        mma_bf16(s[j], af, b[0], b[1]);
        mma_bf16(s[j + 1], af, b[2], b[3]);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

// Write a warp's 16 rows (first row `row0` of the S rows) of acc * mul as
// bf16 pairs into a (B, S, H*D) output whose head starts at `out`.
template <int DT>
__device__ __forceinline__ void store_acc(bf16* out, long long rs, int row0,
                                          int S, int D,
                                          const float (&acc)[DT][4],
                                          float mul, int lane) {
  const int grp = lane / 4, tq = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + grp + 8 * r;
    if (row < S) {
      bf16* orow = out + row * rs;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int c = 8 * j + 2 * tq;
        if (c < D)
          *reinterpret_cast<uint32_t*>(orow + c) =
              pack_bf16(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
      }
    }
  }
}

// ----------------------------------------------------------------- DQ
template <int DP, int BR, int BC, int STAGES, bool AREG, bool MASKED,
          bool STRADDLE>
__global__ void __launch_bounds__(Cfg<DP, BR, BC, STAGES>::NT)
flash_dq_kernel(const Args a) {
  using C = Cfg<DP, BR, BC, STAGES>;
  constexpr int KS = DP / 16, NTK = BC / 8, DT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;            // the block's Q rows
  unsigned char* dos = smem + C::OWN;  // and dO rows
  unsigned char* ring = smem + 2 * C::OWN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tq = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BR;
  const int wrow = warp * 16;  // this warp's first row in the block
  const long long hd = (long long)h * a.D;
  const long long drs = (long long)a.H * a.D;  // dO's and dQ's row stride
  const bf16* kh = a.k + b * a.kb + hd;
  const bf16* vh = a.v + b * a.vb + hd;
  const int ntiles = (a.Skv + BC - 1) / BC;
  const int* kp = MASKED ? a.keep + b * a.nref : a.keep;
  const int tps = a.span / BC;  // K/V tiles per reference span (aligned)
  // the spans of tile t's first and last kv row (STRADDLE)
  auto first_span = [&](int t) { return t * BC / a.span; };
  auto last_span = [&](int t) { return (min(t * BC + BC, a.Skv) - 1) / a.span; };
  // does tile t hold a kept kv row (block-uniform)
  auto kept = [&](int t) {
    if constexpr (!STRADDLE) return kp[t / tps] != 0;
    for (int r = first_span(t); r <= last_span(t); ++r)
      if (kp[r]) return true;
    return false;
  };
  // the first tile at or after t that holds a kept row
  auto next_kept = [&](int t) {
    if (MASKED)
      while (t < ntiles && !kept(t)) ++t;
    return t;
  };
  auto fetch = [&](int t, int stage) {
    unsigned char* ks = ring + stage * C::DQ_STAGE;
    copy_tile<BC, C::CPR, C::PITCH, C::NT>(ks, kh, a.kr, t * BC, a.Skv, a.D,
                                           tid);
    copy_tile<BC, C::CPR, C::PITCH, C::NT>(ks + C::TILE, vh, a.vr, t * BC,
                                           a.Skv, a.D, tid);
  };

  // group 0: Q and dO; then one group per ring stage but the last
  copy_tile<BR, C::CPR, C::PITCH, C::NT>(qs, a.q + b * a.qb + hd, a.qr, q0,
                                         a.Sq, a.D, tid);
  copy_tile<BR, C::CPR, C::PITCH, C::NT>(
      dos, a.dout + (long long)b * a.Sq * drs + hd, drs, q0, a.Sq, a.D, tid);
  cp_async_commit();
  int ld = next_kept(0);  // the next tile to copy
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (ld < ntiles) {
      fetch(ld, s);
      ld = next_kept(ld + 1);
    }
    cp_async_commit();
  }
  // this lane's rows grp and grp + 8: lse (log2 units) and delta; rows
  // past Sq have zero Q and dO, so dS = 0 there
  const long long rb = ((long long)b * a.H + h) * a.Sq;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + grp + 8 * r;
    lse2[r] = row < a.Sq ? a.lse[rb + row] * LOG2E : 0.f;
    dlt[r] = row < a.Sq ? a.delta[rb + row] : 0.f;
  }
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  const unsigned char* qw = qs + wrow * C::PITCH;
  const unsigned char* dow = dos + wrow * C::PITCH;
  uint32_t qa[AREG ? KS : 1][4], oa[AREG ? KS : 1][4];
  if constexpr (AREG) {
    load_a_bf16<KS>(qa, qw, C::PITCH, lane);
    load_a_bf16<KS>(oa, dow, C::PITCH, lane);
  }
  float acc[DT][4];  // dQ / scale
  zero(acc);

  int cs = 0, ls = STAGES - 1;  // ring stages of the tile in use / to fill
  for (int cur = next_kept(0); cur < ntiles; cur = next_kept(cur + 1)) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile `cur`
    // every thread's copies have landed, and every warp is done with the
    // stage that the copies below overwrite
    __syncthreads();
    if (ld < ntiles) {
      fetch(ld, ls);
      ld = next_kept(ld + 1);
    }
    cp_async_commit();
    ls = ls + 1 == STAGES ? 0 : ls + 1;
    const unsigned char* ks = ring + cs * C::DQ_STAGE;
    cs = cs + 1 == STAGES ? 0 : cs + 1;

    float s[NTK][4], dp[NTK][4];
    zero(s);
    zero(dp);
    abt<KS, NTK, C::PITCH, AREG>(s, qa, qw, ks, lane);            // Q K^T
    abt<KS, NTK, C::PITCH, AREG>(dp, oa, dow, ks + C::TILE, lane);  // dO V^T
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = fast_exp2(fmaf(s[j][e], a.scale_log2, -lse2[e / 2]));
    const int kvalid = a.Skv - cur * BC;
    if (kvalid < BC) {  // the ragged last tile: columns past Skv
#pragma unroll
      for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * tq + e % 2 >= kvalid) s[j][e] = 0.f;
    }
    if (STRADDLE && first_span(cur) != last_span(cur)) {
      // a tile across a span boundary: its columns in dropped spans
#pragma unroll
      for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = cur * BC + 8 * j + 2 * tq + e;
          if (col < a.Skv && !kp[col / a.span]) s[j][e] = s[j][e + 2] = 0.f;
        }
    }
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - dlt[e / 2];  // dS
    uint32_t ds[NTK / 2][4];
    pack_p<NTK>(ds, s);
    pv_bf16<NTK / 2, DT>(acc, ds, ks, C::PITCH, lane);  // dQ += dS K
  }
  store_acc<DT>(a.dq + (long long)b * a.Sq * drs + hd, drs, q0 + wrow, a.Sq,
                a.D, acc, a.scale, lane);
}

// ---------------------------------------------------------------- DKV
template <int DP, int BR, int BC, int STAGES, bool AREG, bool MASKED,
          bool STRADDLE>
__global__ void __launch_bounds__(Cfg<DP, BR, BC, STAGES>::NT)
flash_dkv_kernel(const Args a) {
  using C = Cfg<DP, BR, BC, STAGES>;
  constexpr int KS = DP / 16, NTQ = BC / 8, DT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* kso = smem;            // the block's K rows
  unsigned char* vso = smem + C::OWN;   // and V rows
  unsigned char* ring = smem + 2 * C::OWN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tq = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BR;
  const int wrow = warp * 16;  // this warp's first K/V row in the block
  const long long hd = (long long)h * a.D;
  const long long drs = (long long)a.H * a.D;  // dO's, dK's, dV's row stride
  float dk[DT][4], dv[DT][4];  // dK / scale, dV
  zero(dk);
  zero(dv);
  const int* kp = MASKED ? a.keep + b * a.nref : a.keep;
  // the spans of the block's first and last kv row; does one of its rows
  // lie in a kept span (block-uniform)
  const int span0 = MASKED ? k0 / a.span : 0;
  const int span1 = MASKED ? (min(k0 + BR, a.Skv) - 1) / a.span : 0;
  bool live = true;
  if (MASKED) {
    live = false;
    for (int r = span0; r <= span1; ++r) live |= kp[r] != 0;
  }
  if (live) {
    const bf16* qh = a.q + b * a.qb + hd;
    const bf16* doh = a.dout + (long long)b * a.Sq * drs + hd;
    const long long rb = ((long long)b * a.H + h) * a.Sq;
    const float* lseh = a.lse + rb;
    const float* dlth = a.delta + rb;
    const int ntiles = (a.Sq + BC - 1) / BC;
    auto fetch = [&](int t, int stage) {
      unsigned char* qs = ring + stage * C::DKV_STAGE;
      float* rows = reinterpret_cast<float*>(qs + 2 * C::TILE);
      copy_tile<BC, C::CPR, C::PITCH, C::NT>(qs, qh, a.qr, t * BC, a.Sq,
                                             a.D, tid);
      copy_tile<BC, C::CPR, C::PITCH, C::NT>(qs + C::TILE, doh, drs, t * BC,
                                             a.Sq, a.D, tid);
      copy_rows2<BC, C::NT>(rows, rows + C::ROW / 4, lseh, dlth, t * BC,
                            a.Sq, tid);
    };
    // group 0: K and V; then one group per ring stage but the last
    copy_tile<BR, C::CPR, C::PITCH, C::NT>(kso, a.k + b * a.kb + hd, a.kr,
                                           k0, a.Skv, a.D, tid);
    copy_tile<BR, C::CPR, C::PITCH, C::NT>(vso, a.v + b * a.vb + hd, a.vr,
                                           k0, a.Skv, a.D, tid);
    cp_async_commit();
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < ntiles) fetch(s, s);
      cp_async_commit();
    }
    // where the block straddles a span boundary: are this lane's kv rows
    // grp and grp + 8 in dropped spans (P = 0 there)
    bool drop[2] = {false, false};
    if (STRADDLE && span0 != span1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = k0 + wrow + grp + 8 * r;
        drop[r] = row < a.Skv && !kp[row / a.span];
      }
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const unsigned char* kw = kso + wrow * C::PITCH;
    const unsigned char* vw = vso + wrow * C::PITCH;
    uint32_t ka[AREG ? KS : 1][4], va[AREG ? KS : 1][4];
    if constexpr (AREG) {
      load_a_bf16<KS>(ka, kw, C::PITCH, lane);
      load_a_bf16<KS>(va, vw, C::PITCH, lane);
    }

    int cs = 0, ls = STAGES - 1;  // ring stages of the tile in use / to fill
    for (int cur = 0; cur < ntiles; ++cur) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of tile `cur`
      // every thread's copies have landed, and every warp is done with the
      // stage that the copies below overwrite
      __syncthreads();
      if (cur + STAGES - 1 < ntiles) fetch(cur + STAGES - 1, ls);
      cp_async_commit();
      ls = ls + 1 == STAGES ? 0 : ls + 1;
      const unsigned char* qs = ring + cs * C::DKV_STAGE;
      const unsigned char* dos = qs + C::TILE;
      const float* lse_s = reinterpret_cast<const float*>(qs + 2 * C::TILE);
      const float* dlt_s = lse_s + C::ROW / 4;
      cs = cs + 1 == STAGES ? 0 : cs + 1;

      float st[NTQ][4], dpt[NTQ][4];
      zero(st);
      zero(dpt);
      abt<KS, NTQ, C::PITCH, AREG>(st, ka, kw, qs, lane);    // K Q^T
      abt<KS, NTQ, C::PITCH, AREG>(dpt, va, vw, dos, lane);  // V dO^T
      const int qvalid = a.Sq - cur * BC;
#pragma unroll
      for (int j = 0; j < NTQ; ++j) {
        // this lane's two columns (Q rows) 8 j + 2 tq and + 1
        const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j +
                                                          2 * tq);
        const float2 dl = *reinterpret_cast<const float2*>(dlt_s + 8 * j +
                                                           2 * tq);
        const float nl[2] = {-l.x * LOG2E, -l.y * LOG2E};
        const float dd[2] = {dl.x, dl.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(st[j][e], a.scale_log2, nl[e % 2]));
          // Q rows past Sq; kv rows in dropped spans
          if ((qvalid < BC && 8 * j + 2 * tq + e % 2 >= qvalid) ||
              (STRADDLE && drop[e / 2]))
            p = 0.f;
          st[j][e] = p;                                // P^T
          dpt[j][e] = p * (dpt[j][e] - dd[e % 2]);     // dS^T
        }
      }
      uint32_t pt[NTQ / 2][4], dst[NTQ / 2][4];
      pack_p<NTQ>(pt, st);
      pack_p<NTQ>(dst, dpt);
      pv_bf16<NTQ / 2, DT>(dv, pt, dos, C::PITCH, lane);  // dV += P^T dO
      pv_bf16<NTQ / 2, DT>(dk, dst, qs, C::PITCH, lane);  // dK += dS^T Q
    }
  }
  // a block wholly in dropped spans writes zeros
  store_acc<DT>(a.dk + (long long)b * a.Skv * drs + hd, drs, k0 + wrow,
                a.Skv, a.D, dk, a.scale, lane);
  store_acc<DT>(a.dv + (long long)b * a.Skv * drs + hd, drs, k0 + wrow,
                a.Skv, a.D, dv, 1.f, lane);
}

template <Which W, int DP, int BR, int BC, int STAGES, bool AREG,
          bool MASKED, bool STRADDLE>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<DP, BR, BC, STAGES>;
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static_assert(BR % 16 == 0 && BC % 16 == 0, "whole 16-row slices");
  static_assert(DP % 16 == 0 && (DP / 8) % 2 == 0, "16-padded head dim");
  void (*kern)(Args);
  int bytes, rows;
  if constexpr (W == kDq) {
    kern = flash_dq_kernel<DP, BR, BC, STAGES, AREG, MASKED, STRADDLE>;
    bytes = C::DQ_BYTES;
    rows = a.Sq;
  } else {
    kern = flash_dkv_kernel<DP, BR, BC, STAGES, AREG, MASKED, STRADDLE>;
    bytes = C::DKV_BYTES;
    rows = a.Skv;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + BR - 1) / BR, a.H, B);
  kern<<<grid, C::NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

int dispatch(Which which, Args& a, int B, int D, float scale,
             void* stream) {
  a.D = D;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  const int masked = a.keep != nullptr;
  if (D % 8 || (masked && (a.span <= 0 || a.nref * a.span != a.Skv)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!masked) {
    a.nref = 1;
    a.span = 1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = (D + 15) / 16 * 16;
  // A masked line builds its kernel twice: for spans that are a multiple
  // of its K/V tile (DQ's BC, DKV's BR) and for the rest (STRADDLE),
  // chosen here.
#define SG_BUILT(KIND_, DP_, MASKED_, BR_, BC_, STAGES_, AREG_)             \
  if (which == KIND_ && dp == DP_ && masked == MASKED_) {                   \
    if (masked && a.span % (KIND_ == kDq ? BC_ : BR_) != 0)                 \
      return static_cast<int>(                                              \
          launch<KIND_, DP_, BR_, BC_, STAGES_, (AREG_ != 0),               \
                 (MASKED_ != 0), (MASKED_ != 0)>(a, B, s));                 \
    return static_cast<int>(                                                \
        launch<KIND_, DP_, BR_, BC_, STAGES_, (AREG_ != 0), (MASKED_ != 0), \
               false>(a, B, s));                                            \
  }
  // (kernel, padded head dim, masked, BR, BC, ring stages, A fragments in
  // registers): the UNet's head dims 40 (padded to 48), 80 and 160
  SG_BUILT(kDq, 48, 0, 64, 64, 2, 1)
  SG_BUILT(kDq, 48, 1, 64, 64, 2, 1)
  SG_BUILT(kDq, 80, 0, 64, 64, 2, 1)
  SG_BUILT(kDq, 80, 1, 64, 64, 2, 1)
  SG_BUILT(kDq, 160, 0, 64, 64, 2, 0)
  SG_BUILT(kDq, 160, 1, 64, 64, 2, 0)
  SG_BUILT(kDkv, 48, 0, 64, 64, 3, 1)
  SG_BUILT(kDkv, 48, 1, 64, 64, 3, 1)
  SG_BUILT(kDkv, 80, 0, 64, 64, 2, 0)
  SG_BUILT(kDkv, 80, 1, 64, 64, 2, 0)
  SG_BUILT(kDkv, 160, 0, 64, 16, 2, 0)
  SG_BUILT(kDkv, 160, 1, 64, 16, 2, 0)
#undef SG_BUILT
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int H, int Sq, int Skv,
               long long qb, long long qr, long long kb, long long kr,
               long long vb, long long vr, const void* keep, int nref,
               int span) {
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.qb = qb;
  a.qr = qr;
  a.kb = kb;
  a.kr = kr;
  a.vb = vb;
  a.vr = vr;
  a.keep = static_cast<const int*>(keep);
  a.nref = nref;
  a.span = span;
  return a;
}

}  // namespace

// dq (B, Sq, H*D) <- q, k, v, dout (B, Sq, H*D) contiguous, lse and delta
// (B, H, Sq) fp32. keep == nullptr: every kv row; otherwise keep (B, nref)
// int32 over nref spans of `span` kv rows, nref * span == Skv. D a multiple
// of 8. The instantiations built are the SG_BUILT lines of `dispatch`; any
// other returns cudaErrorInvalidValue.
extern "C" int sg_flash_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int H, int Sq,
                           int Skv, int D, long long qb, long long qr,
                           long long kb, long long kr, long long vb,
                           long long vr, const void* keep, int nref,
                           int span, float scale, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, H, Sq, Skv, qb, qr, kb, kr,
                     vb, vr, keep, nref, span);
  a.dq = static_cast<bf16*>(dq);
  return dispatch(kDq, a, B, D, scale, stream);
}

// dk, dv (B, Skv, H*D) <- the same inputs as sg_flash_dq.
extern "C" int sg_flash_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B,
                            int H, int Sq, int Skv, int D, long long qb,
                            long long qr, long long kb, long long kr,
                            long long vb, long long vr, const void* keep,
                            int nref, int span, float scale, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, H, Sq, Skv, qb, qr, kb, kr,
                     vb, vr, keep, nref, span);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  return dispatch(kDkv, a, B, D, scale, stream);
}
