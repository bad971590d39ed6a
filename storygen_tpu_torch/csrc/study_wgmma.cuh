// Kernel S2, the max-free ("bounded") flash-attention forward of the
// attention studies, on kernel F's Hopper template (flash_wgmma.cuh):
// every logit is shifted by an a-priori row bound instead of a running
// maximum, so O is a plain sum over the K/V tiles and needs no rescale.
// study_bounded.cu (TB, BOUNDED, the ablations) and study_bnd2.cu (BND2,
// one head or g heads a block) hold its instantiations and their notes.
//
// The kinds (Kind below) differ from F only in the softmax step (MaxFree,
// fw_block's policy) and in the knobs each study sweeps:
// - TB: p = exp2(s) straight from the accumulator (F's ex2.approx.ftz); the bound comes in as
//   q_ext's last column against k_ext's ones column, and v_ext's ones
//   column makes O's column d the tensor core's sum of the bf16-rounded p;
//   out = O[:d] / max(O[d], 1e-30). BOUNDED: p = exp(s) (ex2.approx.ftz of
//   s log2(e)), guard 1e-20.
//   QK_PV: p = s (no exp), guard 1e-30.
// - BND2: p = exp2(s - b) with the fp32 row bound b a side input, the fp32
//   sum of the unrounded p, guard 1e-30.
// - QK, QK_EXP (no P V): K tiles only (the ring without V, as kernel L's),
//   p = s or exp2(s), out = the kv sum of p broadcast over d; two S
//   accumulator sets, the next tile's Q K^T in flight while the current
//   tile's sums (and exps) run (s2_sum over sum_walk, which kernel S3,
//   study_qk.cu, walks too).
// - INT8 (kernel S4, study_int8.cu): BND2 with int8 Q and K, the s8
//   wgmma's int32 logits dequantised by the step with each tile's kv
//   scales (landed beside K), p = exp2(((s sk) sq) - b), and v_ext's ones
//   column for the row sum of the bf16-rounded p.
// - SUB 2 / 4 (s2_sub): a ring stage holds SUB x BK K/V rows; every
//   sub-tile's Q K^T is issued (a commit group each) before the first
//   exp; sub-tile u's exps run while the later sub-tiles' products and
//   sub-tile u-1's P V do, and its P V is issued as soon as its P is
//   rounded.
// - HALVES 2: fw_consume_ahead, the next tile's Q K^T in flight during the
//   current tile's exps.
// - G = 2 / 4 / 8 heads a block (mh, s2_heads): the block walks its heads
//   in turn and the ring runs on across heads; Q has two slots, so the
//   next head's Q lands while the current head runs. At d 80 / 160 two
//   consumer warpgroups split each tile's kv rows (the grid has g times
//   fewer blocks) and merge O and the row sums through shared memory at
//   the head's end; the max-free sum needs no rescale to merge.
#pragma once
#include <math.h>

#include "flash_wgmma.cuh"

namespace sg_flash {

// S2's kinds (ops/study_attention.py mirrors them), and S4's (INT8,
// study_int8.cu)
enum Kind {
  TB = 0,
  BOUNDED = 1,
  QK = 2,
  QK_EXP = 3,
  QK_PV = 4,
  BND2 = 5,
  INT8 = 6
};

// The block configuration of an S2 instantiation: BQ / 64 consumer
// warpgroups, or with g heads a block 64 query rows and, at d 80 / 160,
// two warpgroups that split each tile's kv rows; a ring stage of SUB x BK
// kv rows, V only where the kind takes P V.
template <int DP, int BQ, int BK, int SUB, int G, int KIND, int STAGES,
          int KPW>
struct S2Cfg {
  static constexpr bool PV = KIND != QK && KIND != QK_EXP;
  static constexpr int SPLIT = G > 1 && DP > 48 ? 2 : 1;
  static constexpr int WGM = G > 1 ? SPLIT : BQ / 64;
  using C = FwCfg<DP, WGM, SUB * BK, STAGES, KPW, PV, SPLIT, (G > 1 ? 2 : 1),
                  (KIND == INT8 ? 1 : 2)>;
  static_assert(G == 1 || (BQ == 64 && SUB == 1 && KIND == BND2),
                "g heads a block: bnd2 at 64-row tiles");
  static_assert(SUB == 1 || PV, "sub-tiles of a kind with P V");
};

// The max-free softmax step of kind KIND (fw_consume's policy); l is the
// fp32 row sum (BND2; QK and QK_EXP's kv sum), b the row bound (BND2,
// INT8), sq the row's q scale (INT8).
template <int KIND>
struct MaxFree {
  static constexpr bool RESCALE = false;
  static constexpr bool SUM = KIND == BND2 || KIND == QK || KIND == QK_EXP;
  float b[2] = {0.f, 0.f}, l[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
  // this thread's rows `row` and row + 8 of head (batch row) bh
  __device__ MaxFree(const FwArgs& a, int bh, int row) {
    if (KIND == BND2 || KIND == INT8) {
      const float* br = a.bound + (long long)bh * a.Sq + row;
      b[0] = br[0];
      b[1] = br[8];
    }
    if (KIND == INT8) {
      const float* sr = a.qscale + (long long)bh * a.Sq + row;
      sq[0] = sr[0];
      sq[1] = sr[8];
    }
  }
  __device__ float p_of(float x, int r) const {
    if (KIND == BND2) return fast_exp2(x - b[r]);
    if (KIND == TB || KIND == QK_EXP) return fast_exp2(x);
    if (KIND == BOUNDED) return fast_exp(x);
    return x;  // QK, QK_PV
  }
  template <int N>
  __device__ void step(float (&s)[N], float (&)[2]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s[i] = p_of(s[i], i % 4 / 2);
      if (SUM) l[i % 4 / 2] += s[i];
    }
  }
  // INT8: the int32 logits of a tile whose kv scales (fp32, one a column)
  // lie at shared-space address sk, dequantised in the study's order
  // without contraction into an fma, ((s * sk) * sq) - b, then exp2; p's
  // bits left in s.
  template <int N>
  __device__ void step(int (&s)[N], float (&)[2], uint32_t sk) {
    static_assert(KIND == INT8, "int32 logits: the int8 kind");
    const int tq = threadIdx.x % 4;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float2 k = lds_f2(sk + 4 * (8 * j + 2 * tq));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = __fsub_rn(
            __fmul_rn(__fmul_rn(static_cast<float>(s[4 * j + e]),
                                e % 2 ? k.y : k.x),
                      sq[e / 2]),
            b[e / 2]);
        s[4 * j + e] = __float_as_int(fast_exp2(x));
      }
    }
  }
  // 1 / the row sum of row r: l, or O's column d (the ones column of
  // v_ext). The lane of the quad that holds column d adds it to zero and
  // the others add nothing, so the quad's sum is exact (a select by a run
  // time index would put O in local memory).
  // (the guard and d read from the kernel's parameters: no registers held
  // through the walk)
  template <int R>
  __device__ float inv(int r, const float (&o)[R], const FwArgs& a) const {
    if (KIND == BND2) return 1.f / fmaxf(quad_sum(l[r]), a.guard);
    // TB, BOUNDED, QK_PV, INT8: O's column d
    const int tq = threadIdx.x % 4;
    float x = 0.f;
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + 2 * tq + e == a.D) x += o[4 * j + 2 * r + e];
    return 1.f / fmaxf(quad_sum(x), a.guard);
  }
};

// The set-up of an S2 block that fw_block does not cover: the ring's
// barriers, then the producer warpgroup's copies of the block's `heads`
// heads from batch row b0 (each head's Q into slot h % QSLOTS once the
// slot's last head is done, then its nt K/V tiles, the ring running on
// across heads). False in the producer warpgroup, which is then done.
template <class C>
__device__ __forceinline__ bool s2_start(const FwRing<C>& rg,
                                         const CUtensorMap* tmq,
                                         const CUtensorMap* tmk,
                                         const CUtensorMap* tmv, int b0,
                                         int heads, int nt, int q0) {
  constexpr int WGM = C::NTC / 128;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) rg.init();
  __syncthreads();
  if (warp >= 4 * WGM) {  // the producer: one thread issues every copy
    if constexpr (WGM > 1) setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == 4 * WGM && lane == 0) {
      for (int hd = 0; hd < heads; ++hd) {
        const int slot = hd % C::QSLOTS;
        if (C::QSLOTS > 1 && hd >= C::QSLOTS)
          mbar_wait(rg.q_empty(slot), (hd / C::QSLOTS + 1) & 1);
        rg.load_q(tmq, slot, 0, q0, b0 + hd);
        for (int t = 0; t < nt; ++t)
          rg.load_kv(tmk, tmv, hd * nt + t, 0, t * C::BK, b0 + hd);
      }
    }
    return false;
  }
  consumers_start<C>();
  return true;
}

// O times the policy's factor for this thread's rows row0 and row0 + 8 of
// head (batch row) bh into out (BH, Sq, d), columns below d.
template <int DP, class SM>
__device__ __forceinline__ void s2_store(const FwArgs& a, const SM& sm,
                                         const float (&o)[DP / 2], int bh,
                                         int row0) {
  const int tq = threadIdx.x % 4;
  bf16* ob = a.out + (long long)bh * a.Sq * a.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = sm.inv(r, o, a);
    bf16* orow = ob + (long long)(row0 + 8 * r) * a.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * tq;
      if (c < a.D)
        *reinterpret_cast<uint32_t*>(orow + c) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// The walk without P V (kernel L's) of QK / QK_EXP and of kernel S3
// (study_qk.cu): two S accumulator sets (C::SAcc), the next tile's Q K^T
// issued before the policy's step on the current tile and waited for
// inside the same loop step, the last tile on a path of its own (ptxas
// serialises every wgmma where a product is in flight across the loop's
// back edge). `issue(s, ks)` issues one tile's Q K^T against the K stage
// at ks; the walk fences, commits, waits and releases the stages.
template <class C, class SM, class Issue>
__device__ __forceinline__ void sum_walk(const FwRing<C>& rg, int n, SM& sm,
                                         const Issue& issue) {
  using Acc = typename C::SAcc;
  constexpr int BK = C::BK, STAGES = C::STAGES;
  Acc s0[BK / 2], s1[BK / 2];
  auto qk = [&](Acc(&s)[BK / 2], int i) {
    mbar_wait(rg.full_k(i % STAGES), (i / STAGES) & 1);
    // s's registers settle before the fence, so that no move of them
    // falls between the fence and the products (ptxas would serialise)
    fence_regs(s);
    wg_fence();
    issue(s, rg.k_stage(i));
    wg_commit();
  };
  int i = 0;
  float unused[2];
  // s holds walked tile i's logits; false after the last tile
  auto step = [&](Acc(&s)[BK / 2], Acc(&nxt)[BK / 2]) {
    if (i + 1 >= n) {
      sm.step(s, unused);
      return false;
    }
    qk(nxt, i + 1);
    sm.step(s, unused);
    wg_wait<0>();
    fence_regs(nxt);
    ++i;
    mbar_arrive(rg.empty_k(i % STAGES));
    return true;
  };
  qk(s0, 0);
  wg_wait<0>();
  fence_regs(s0);
  mbar_arrive(rg.empty_k(0));
  while (step(s0, s1) && step(s1, s0)) {
  }
}

// QK and QK_EXP: sum_walk with Q in shared memory and the kv sum of p;
// out = that sum broadcast over d.
template <class C, int KIND>
__device__ __forceinline__ void s2_sum(const CUtensorMap* tmq,
                                       const CUtensorMap* tmk,
                                       const FwArgs& a) {
  constexpr int BK = C::BK, KPS = C::KRB / 32;
  extern __shared__ unsigned char smem_raw[];
  const FwRing<C> rg((smem_addr(smem_raw) + 1023u) & ~1023u);
  const int bh = blockIdx.z, q0 = blockIdx.x * C::BQ, n = a.Skv / BK;
  if (!s2_start(rg, tmq, tmk, tmk, bh, 1, n, q0)) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4, w = warp % 4, tq = lane % 4;
  const int row0 = q0 + 64 * g + 16 * w + lane / 4;
  const uint32_t qrows = rg.q(0) + 64 * g * C::KRB;
  MaxFree<KIND> sm(a, bh, row0);
  mbar_wait(rg.q_full(0), 0);
  sum_walk(rg, n, sm, [&](float(&s)[BK / 2], uint32_t ks) {
#pragma unroll
    for (int j = 0; j < C::KSTEPS; ++j) {
      const uint32_t col = 32 * (j % KPS);
      WgMmaSS<BK>::run(
          s,
          smem_desc(qrows + (j / KPS) * C::QPANEL + col, 0, 8 * C::KRB,
                    C::KRB),
          smem_desc(ks + (j / KPS) * C::KPANEL + col, 0, 8 * C::KRB, C::KRB),
          j > 0);
    }
  });

  bf16* ob = a.out + (long long)bh * a.Sq * a.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float tot = quad_sum(sm.l[r]);
    const uint32_t pair = pack_bf16(tot, tot);
    bf16* orow = ob + (long long)(row0 + 8 * r) * a.D;
    for (int c = 2 * tq; c < a.D; c += 8)
      *reinterpret_cast<uint32_t*>(orow + c) = pair;
  }
}

// SUB sub-tiles of BK kv rows a ring stage: every sub-tile's Q K^T issued
// (a commit group each) before the first exp; sub-tile u waited for
// alone (the groups complete in order: the later sub-tiles' products and
// the earlier sub-tiles' P V stay in flight), its p taken, rounded, and
// its P V issued at once; the stage's P V waited for at its end.
template <class C, int SUB, int KIND>
__device__ __forceinline__ void s2_sub(const CUtensorMap* tmq,
                                       const CUtensorMap* tmk,
                                       const CUtensorMap* tmv,
                                       const FwArgs& a) {
  constexpr int BK = C::BK / SUB, KSTEPS = C::DP / 16, KPS = C::KRB / 32;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const FwRing<C> rg((smem_addr(smem_raw) + 1023u) & ~1023u);
  const int bh = blockIdx.z, q0 = blockIdx.x * C::BQ, n = a.Skv / C::BK;
  if (!s2_start(rg, tmq, tmk, tmv, bh, 1, n, q0)) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4, w = warp % 4;
  const int row0 = q0 + 64 * g + 16 * w + lane / 4;
  const uint32_t qrows = rg.q(0) + 64 * g * C::KRB;
  MaxFree<KIND> sm(a, bh, row0);
  float o[C::DP / 2];
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) o[i] = 0.f;
  float s[SUB][BK / 2], unused[2];
  uint32_t p[SUB][BK / 16][4];
  mbar_wait(rg.q_full(0), 0);
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES;
    const uint32_t par = (i / STAGES) & 1;
    const uint32_t ks = rg.k_stage(i), vs = rg.v_stage(i);
    mbar_wait(rg.full_k(st), par);
#pragma unroll
    for (int u = 0; u < SUB; ++u) fence_regs(s[u]);
    wg_fence();
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j) {
        const uint32_t col = 32 * (j % KPS);
        WgMmaSS<BK>::run(
            s[u],
            smem_desc(qrows + (j / KPS) * C::QPANEL + col, 0, 8 * C::KRB,
                      C::KRB),
            smem_desc(ks + u * BK * C::KRB + (j / KPS) * C::KPANEL + col, 0,
                      8 * C::KRB, C::KRB),
            j > 0);
      }
      wg_commit();
    }
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      wg_wait<SUB - 1>();  // sub-tile u's Q K^T (the oldest group in flight)
      fence_regs(s[u]);
      sm.step(s[u], unused);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          p[u][kk][f] =
              pack_bf16(s[u][8 * kk + 2 * f], s[u][8 * kk + 2 * f + 1]);
      if (u == 0) mbar_wait(rg.full_v(st), par);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        WgMma<C::DP>::run(o, p[u][kk],
                          smem_desc(vs + (u * BK + 16 * kk) * C::VRB,
                                    C::VPANEL, 8 * C::VRB, C::VRB));
      wg_commit();
    }
    mbar_arrive(rg.empty_k(st));
    wg_wait<0>();
    fence_regs(o);
    mbar_arrive(rg.empty_v(st));
  }
  s2_store<C::DP>(a, sm, o, bh, row0);
}

// G heads a block (BND2, 64 query rows): the heads in turn, each through
// fw_consume with the ring running on (walked tile hd * nt + t of head
// hd); at d 80 / 160 warpgroup 1 hands its O and row sums to warpgroup 0
// through shared memory at each head's end (named barrier 1: handed over;
// 2: taken, so the next head's hand-over may overwrite it).
template <class C, int G>
__device__ __forceinline__ void s2_heads(const CUtensorMap* tmq,
                                         const CUtensorMap* tmk,
                                         const CUtensorMap* tmv,
                                         const FwArgs& a) {
  constexpr int NTC = C::NTC, SPLIT = NTC / 128;  // 64 query rows a block
  constexpr int NS = C::BK / SPLIT;               // kv rows a warpgroup
  extern __shared__ unsigned char smem_raw[];
  const FwRing<C> rg((smem_addr(smem_raw) + 1023u) & ~1023u);
  const int b0 = blockIdx.z * G, q0 = blockIdx.x * 64, nt = a.Skv / C::BK;
  if (!s2_start(rg, tmq, tmk, tmv, b0, G, nt, q0)) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = warp / 4, w = warp % 4, tq = lane % 4;
  const int row0 = q0 + 16 * w + lane / 4;
  float* hand = reinterpret_cast<float*>(smem_raw +
                                         (rg.hand() - smem_addr(smem_raw))) +
                tid % 128;
  float o[C::DP / 2];
#pragma unroll 1
  for (int hd = 0; hd < G; ++hd) {
    const int slot = hd % 2;
    MaxFree<BND2> sm(a, b0 + hd, row0);
#pragma unroll
    for (int i = 0; i < C::DP / 2; ++i) o[i] = 0.f;
    mbar_wait(rg.q_full(slot), (hd / 2) & 1);
    fw_consume<C, NS, false>(rg, DenseWalk{nt}, sm, o, rg.q(slot), g * NS,
                             hd * nt, g, tq);
    mbar_arrive(rg.q_empty(slot));  // its products are done
    if constexpr (SPLIT > 1) {
      if (g == 1) {
        if (hd > 0) named_bar_sync(2, NTC);
#pragma unroll
        for (int i = 0; i < C::DP / 2; ++i) hand[128 * i] = o[i];
        hand[128 * (C::DP / 2)] = sm.l[0];
        hand[128 * (C::DP / 2 + 1)] = sm.l[1];
        named_bar_arrive(1, NTC);
        continue;
      }
      named_bar_sync(1, NTC);
#pragma unroll
      for (int i = 0; i < C::DP / 2; ++i) o[i] += hand[128 * i];
      sm.l[0] += hand[128 * (C::DP / 2)];
      sm.l[1] += hand[128 * (C::DP / 2 + 1)];
      if (hd + 1 < G) named_bar_arrive(2, NTC);
    }
    s2_store<C::DP>(a, sm, o, b0 + hd, row0);
  }
}

// grid (Sq / BQ, 1, BH / G)
template <int DP, int BQ, int BK, int SUB, int HALVES, int G, int KIND,
          int STAGES, int KPW>
__global__ void __launch_bounds__(
    S2Cfg<DP, BQ, BK, SUB, G, KIND, STAGES, KPW>::C::NT, 1)
    bounded_wg_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv,
                      const FwArgs a) {
  using S = S2Cfg<DP, BQ, BK, SUB, G, KIND, STAGES, KPW>;
  using C = typename S::C;
  static_assert(HALVES == 1 || (SUB == 1 && G == 1 && S::PV),
                "split2 of a one-head kind with P V");
  if constexpr (G > 1)
    s2_heads<C, G>(&tmq, &tmk, &tmv, a);
  else if constexpr (!S::PV)
    s2_sum<C, KIND>(&tmq, &tmk, a);
  else if constexpr (SUB > 1)
    s2_sub<C, SUB, KIND>(&tmq, &tmk, &tmv, a);
  else
    fw_block<C, false, HALVES == 2, MaxFree<KIND>>(
        &tmq, &tmk, &tmv, a, DenseWalk{a.Skv / BK}, 0, blockIdx.z,
        blockIdx.x * C::BQ);
}

// One launch: q, k, v (BH, S, W) bf16 contiguous; bound (BH, Sq) fp32 or
// null; out (BH, Sq, d) bf16. The three tensor maps are encoded per call.
template <int DP, int BQ, int BK, int SUB, int HALVES, int G, int KIND,
          int STAGES, int KPW>
cudaError_t bounded_wg_launch(const bf16* q, const bf16* k, const bf16* v,
                              const float* bound, bf16* out, int BH, int Sq,
                              int Skv, int W, int d, float guard,
                              cudaStream_t stream) {
  using S = S2Cfg<DP, BQ, BK, SUB, G, KIND, STAGES, KPW>;
  using C = typename S::C;
  CUtensorMap tq, tk, tv;
  if (!encode_operand(&tq, q, BH, 1, Sq, W, (long long)Sq * W, W, KPW,
                      C::BQ) ||
      !encode_operand(&tk, k, BH, 1, Skv, W, (long long)Skv * W, W, KPW,
                      C::BK) ||
      !encode_operand(&tv, S::PV ? v : k, BH, 1, Skv, W, (long long)Skv * W,
                      W, C::VPW, C::BK))
    return cudaErrorInvalidValue;
  FwArgs a = {};
  a.out = out;
  a.bound = bound;
  a.H = 1;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = d;
  a.nref = a.span = 1;
  a.guard = guard;
  constexpr auto kern =
      bounded_wg_kernel<DP, BQ, BK, SUB, HALVES, G, KIND, STAGES, KPW>;
  cudaError_t err = smem_limit_once<kern>(C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / C::BQ, 1, BH / G);
  kern<<<grid, C::NT, C::BYTES, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace sg_flash
