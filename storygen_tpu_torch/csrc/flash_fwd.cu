// Flash-attention forward for Hopper (sm_90a): O = softmax(Q K^T * scale) V.
//
// Replaces the four forward variants of the TPU kernel in
// storygen_tpu/ops/pallas_attention.py (_bnd2_kernel, _bnd_kernel,
// _online_t_kernel, _flash_kernel), reached through _flash_core. The TPU's
// per-row bound with its 120-unit exp2 clamp and the transposed "bhds"
// output layout are TPU workarounds and are not carried over: this is the
// exact online softmax.
//
// What bounds it on the H100: at the UNet's 4096 x 4096 (attn1) and
// 4096 x 12288 (attn3) shapes the logits matrix is 16-48x larger than Q, K,
// V and O together, so a kernel that never writes the logits is bound by
// tensor-core work, not by HBM. The design keeps S and P in shared memory
// (never in HBM) and reads Q once and K/V once per 64-row query tile.
//
// Design: one block of 4 warps per (query tile of 64 rows, head, batch);
// each warp owns 16 query rows. The block loops over 64-row K/V tiles:
// S = Q K^T with bf16 WMMA (fp32 accumulation) into shared memory, the
// online softmax per row in fp32 (running max and sum, exp2 with
// scale*log2(e) folded in), P rounded to bf16, O += P V accumulated in fp32
// in shared memory. Head dims that are not a multiple of the MMA k-step
// (d = 40) are zero-padded to a multiple of 16 in shared memory only
// (40 -> 48), never in HBM. Ragged Sq and Skv (attn2's 77-token text kv)
// are masked at the tile edge: out-of-range K/V rows load as zeros and
// their logits as -inf. Q, K and V are read straight from the projections'
// (B, S, H*D) layout through batch and row strides (so a split k|v view
// needs no copy), and O is written as (B, Sq, H*D): the head merge is free.
//
// The masked instantiation (kernel M) replaces the masked variants
// (_bnd2_masked_kernel, _bnd_masked_kernel, _online_t_masked_kernel,
// _masked_kernel): the kv is N equal reference spans and `keep` (B, N)
// says which spans a batch row may attend to. Every span is a multiple of
// BK, so a flag holds for a whole K/V tile and a dropped tile is skipped
// before it is loaded. The first tile a row sees may then be any kept one,
// so the recurrence no longer relies on column 0 of the first tile: a row
// whose running max is still -inf takes alpha = 0 instead of
// exp2(-inf - -inf), and a row that kept no tile at all (never the case in
// training, where the newest reference is always kept) writes zeros.
// Simple first: no cp.async pipelining, wgmma or TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

template <int DP>
struct Smem {
  static constexpr int q = 0;
  static constexpr int k = align128(q + BQ * DP * 2);
  static constexpr int v = align128(k + BK * DP * 2);
  static constexpr int s = align128(v + BK * DP * 2);
  static constexpr int p = align128(s + BQ * BK * 4);
  static constexpr int o = align128(p + BQ * BK * 2);
  static constexpr int m = align128(o + BQ * DP * 4);
  static constexpr int l = align128(m + BQ * 4);
  static constexpr int bytes = align128(l + BQ * 4);
};

// Copy rows [row0, row0 + TILE) x [0, D) of a strided bf16 matrix into a
// (TILE, DP) shared tile; rows past `nrows` and columns past D become zero.
template <int DP, int TILE>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long rs, int row0, int nrows,
                                          int D) {
  constexpr int CPR = DP / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < TILE * CPR; idx += NTHREADS) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows && c < D)
      val = *reinterpret_cast<const uint4*>(src + (long long)gr * rs + c);
    *reinterpret_cast<uint4*>(dst + r * DP + c) = val;
  }
}

template <int DP, bool MASKED>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                 int Sq, int Skv, int D, long long qb, long long qr,
                 long long kb, long long kr, long long vb, long long vr,
                 const int* __restrict__ keep, int nref, int span,
                 float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem<DP>;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);
  float* Os = reinterpret_cast<float*>(smem + L::o);
  float* Ms = reinterpret_cast<float*>(smem + L::m);
  float* Ls = reinterpret_cast<float*>(smem + L::l);

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * 16;  // this warp's first row inside the tile
  const bf16* qbase = q + b * qb + (long long)h * D;
  const bf16* kbase = k + b * kb + (long long)h * D;
  const bf16* vbase = v + b * vb + (long long)h * D;

  load_tile<DP, BQ>(Qs, qbase, qr, q0, Sq, D);
  for (int i = threadIdx.x; i < BQ * DP; i += NTHREADS) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    Ms[i] = -INFINITY;
    Ls[i] = 0.f;
  }

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    // block-uniform: every thread skips the same tiles
    if (MASKED && !keep[b * nref + k0 / span]) continue;
    load_tile<DP, BK>(Ks, kbase, kr, k0, Skv, D);
    load_tile<DP, BK>(Vs, vbase, vr, k0, Skv, D);
    __syncthreads();

    // S[wr:wr+16, :] = Q K^T (unscaled, fp32)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kc = 0; kc < DP / 16; ++kc) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, Qs + wr * DP + kc * 16, DP);
        wmma::load_matrix_sync(bt, Ks + j * 16 * DP + kc * 16, DP);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(Ss + wr * BK + j * 16, acc, BK,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this warp's 16 rows; lane holds columns lane and
    // lane + 32 of the tile
    const int kvalid = min(BK, Skv - k0);
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
      const float s0 =
          lane < kvalid ? Ss[row * BK + lane] * scale_log2 : -INFINITY;
      const float s1 = lane + 32 < kvalid
                           ? Ss[row * BK + lane + 32] * scale_log2
                           : -INFINITY;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[row];
      // finite: every processed tile holds at least column 0
      const float m_new = fmaxf(m_old, mx);
      const float p0 = exp2f(s0 - m_new);
      const float p1 = exp2f(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // the row's first processed tile: nothing to rescale (and never
      // exp2(-inf - -inf))
      const float alpha = m_old == -INFINITY ? 0.f : exp2f(m_old - m_new);
      Ps[row * BK + lane] = __float2bfloat16(p0);
      Ps[row * BK + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < DP; c += 32) Os[row * DP + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        Ms[row] = m_new;
        Ls[row] = Ls[row] * alpha + sum;
      }
    }
    __syncwarp();

    // O[wr:wr+16, :] += P V
#pragma unroll
    for (int dt = 0; dt < DP / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + wr * DP + dt * 16, DP,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + wr * BK + kk * 16, BK);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * DP + dt * 16, DP);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Os + wr * DP + dt * 16, acc, DP,
                              wmma::mem_row_major);
    }
    __syncthreads();  // K/V tiles are overwritten next iteration
  }

  // O / l, written as (B, Sq, H*D)
  const long long ors = (long long)H * D;
  for (int idx = threadIdx.x; idx < BQ * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    const int gr = q0 + r;
    if (gr < Sq)  // Ls = 0: the row kept no tile and attends to nothing
      o[((long long)b * Sq + gr) * ors + (long long)h * D + c] =
          __float2bfloat16(Ls[r] > 0.f ? Os[r * DP + c] / Ls[r] : 0.f);
  }
}

template <int DP, bool MASKED>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   int B, int H, int Sq, int Skv, int D, long long qb,
                   long long qr, long long kb, long long kr, long long vb,
                   long long vr, const int* keep, int nref, int span,
                   float scale_log2, cudaStream_t stream) {
  constexpr int bytes = Smem<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DP, MASKED><<<grid, NTHREADS, bytes, stream>>>(
      q, k, v, o, H, Sq, Skv, D, qb, qr, kb, kr, vb, vr, keep, nref, span,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

// keep == nullptr: kernel F; otherwise kernel M with keep (B, nref) int32
// and every span of `span` kv rows a multiple of BK (checked by the caller).
extern "C" int sg_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int Sq, int Skv, int D,
                            long long qb, long long qr, long long kb,
                            long long kr, long long vb, long long vr,
                            const void* keep, int nref, int span,
                            float scale, void* stream) {
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(o);
  const int* KEEP = static_cast<const int*>(keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KEEP != nullptr && (span <= 0 || span % BK || nref * span != Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (D + 15) / 16 * 16;
#define SG_CASE(N)                                                          \
  case N:                                                                   \
    return KEEP ? launch<N, true>(Q, K, V, O, B, H, Sq, Skv, D, qb, qr, kb,  \
                                  kr, vb, vr, KEEP, nref, span, sl2, s)     \
                : launch<N, false>(Q, K, V, O, B, H, Sq, Skv, D, qb, qr, kb, \
                                   kr, vb, vr, nullptr, 1, 1, sl2, s);
  // The UNet's head dims: 40 (padded to 48), 80 and 160.
  switch (dp) {
    SG_CASE(48)
    SG_CASE(80)
    SG_CASE(160)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SG_CASE
}
