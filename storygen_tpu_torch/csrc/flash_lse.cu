// Kernel L of the flash-attention backward for Hopper (sm_90a): the
// forward's row logsumexp, lse = log sum_k exp(s * q.k), recomputed over
// K tiles. Replaces _lse_kernel of the TPU backward in
// storygen_tpu/ops/pallas_attention.py (_pallas_bwd_with_out, reached
// through _core_bwd); its gradient kernels DQ and DKV are flash_bwd.cu.
//
// What bounds it on the H100: one Q K^T product per K tile, tensor-core
// work, and one exp2 per logit. This is still the first, simple design:
// one block of 4 warps per (64-row Q tile, head, batch), each warp owning
// 16 rows; bf16 WMMA with the fp32 logits staged in shared memory and read
// back one element at a time; synchronous tile copies. Head dim 40 is
// zero-padded to 48 in shared memory only. Rows past Skv (attn2's 77 text
// tokens) load as zeros and take no part in the sum; rows past Sq are not
// written. With `keep` (B, N refs) over N equal spans of any length, a K
// tile whose rows all lie in dropped spans is skipped, and a tile that
// straddles a span boundary (spans of 16 or 144 rows at the mid block of a
// 256 or 768 px image) drops its columns in dropped spans: an instantiation
// of its own (STRADDLE), chosen at launch, so that spans that are
// multiples of 64 rows (the 512 px UNet) test one flag per tile. A row that
// keeps no span gets lse = -inf. Inputs are read from the projections'
// (B, S, H*D) layout through batch and row strides.
// Not yet: F's register design (mma.sync, a cp.async ring).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BT = 64;  // rows per tile, on both sides
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// Shared-memory layout: two bf16 (BT, DP) tiles (Q, K), one fp32 (BT, BT)
// logit tile and two fp32 rows of BT scalars (running max and sum).
template <int DP>
struct LseSmem {
  static constexpr int tile = align128(BT * DP * 2);
  static constexpr int sf0 = 2 * tile;
  static constexpr int row0 = sf0 + align128(BT * BT * 4);
  static constexpr int bytes = row0 + 2 * align128(BT * 4);
};

// Copy rows [row0, row0 + BT) x [0, D) of a strided bf16 matrix into a
// (BT, DP) shared tile; rows past `nrows` and columns past D become zero.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long rs, int row0, int nrows,
                                          int D) {
  constexpr int CPR = DP / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < BT * CPR; idx += NTHREADS) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows && c < D)
      val = *reinterpret_cast<const uint4*>(src + (long long)gr * rs + c);
    *reinterpret_cast<uint4*>(dst + r * DP + c) = val;
  }
}

// C[wr:wr+16, 0:BT] = A[wr:wr+16, :] B^T over a DP-deep contraction, A and
// B both (BT, DP) row-major bf16 tiles; C fp32 with row stride BT.
template <int DP>
__device__ __forceinline__ void warp_abt(float* C, const bf16* A,
                                         const bf16* B, int wr) {
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
      wmma::load_matrix_sync(a, A + wr * DP + kc * 16, DP);
      wmma::load_matrix_sync(bt, B + j * 16 * DP + kc * 16, DP);
      wmma::mma_sync(acc, a, bt, acc);
    }
    wmma::store_matrix_sync(C + wr * BT + j * 16, acc, BT,
                            wmma::mem_row_major);
  }
}

struct Args {
  const bf16 *q, *k;
  float* lse_out;
  int H, Sq, Skv, D;
  long long qb, qr, kb, kr;  // batch and row strides of q, k
  const int* keep;           // (B, nref) or nullptr
  int nref, span;
  float scale_log2;
};

// Does any of the K tile's rows [k0, k0 + BT) below Skv lie in a kept
// span? Without STRADDLE every span is a multiple of BT rows and one flag
// holds for the tile.
template <bool STRADDLE>
__device__ __forceinline__ bool tile_kept(const Args& a, int b, int k0) {
  const int* kp = a.keep + b * a.nref;
  if (!STRADDLE) return kp[k0 / a.span] != 0;
  const int last = (min(k0 + BT, a.Skv) - 1) / a.span;
  for (int r = k0 / a.span; r <= last; ++r)
    if (kp[r]) return true;
  return false;
}

// Do the K tile's rows lie in more than one span (then each row has its
// own flag)?
__device__ __forceinline__ bool tile_straddles(const Args& a, int k0) {
  return k0 / a.span != (min(k0 + BT, a.Skv) - 1) / a.span;
}

// Is kv row `row` below Skv and in a kept span?
__device__ __forceinline__ bool row_kept(const Args& a, int b, int row) {
  return row < a.Skv && a.keep[b * a.nref + row / a.span] != 0;
}

template <int DP, bool MASKED, bool STRADDLE>
__global__ void __launch_bounds__(NTHREADS) flash_lse_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = LseSmem<DP>;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::tile);
  float* Ss = reinterpret_cast<float*>(smem + L::sf0);
  float* Ms = reinterpret_cast<float*>(smem + L::row0);
  float* Ls = Ms + align128(BT * 4) / 4;

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * 16;
  load_tile<DP>(Qs, a.q + b * a.qb + (long long)h * a.D, a.qr, q0, a.Sq,
                a.D);
  for (int i = threadIdx.x; i < BT; i += NTHREADS) {
    Ms[i] = -INFINITY;
    Ls[i] = 0.f;
  }
  const bf16* kbase = a.k + b * a.kb + (long long)h * a.D;
  for (int k0 = 0; k0 < a.Skv; k0 += BT) {
    if (MASKED && !tile_kept<STRADDLE>(a, b, k0)) continue;
    load_tile<DP>(Ks, kbase, a.kr, k0, a.Skv, a.D);
    __syncthreads();
    warp_abt<DP>(Ss, Qs, Ks, wr);
    __syncwarp();
    // this lane's two columns: below Skv, and kept where the tile straddles
    const int kvalid = min(BT, a.Skv - k0);
    const bool mixed = STRADDLE && tile_straddles(a, k0);
    const bool ok0 = mixed ? row_kept(a, b, k0 + lane) : lane < kvalid;
    const bool ok1 =
        mixed ? row_kept(a, b, k0 + lane + 32) : lane + 32 < kvalid;
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
      const float s0 = ok0 ? Ss[row * BT + lane] * a.scale_log2 : -INFINITY;
      const float s1 =
          ok1 ? Ss[row * BT + lane + 32] * a.scale_log2 : -INFINITY;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[row];
      // finite: a processed tile holds a kept column below Skv
      const float m_new = fmaxf(m_old, mx);
      float sum = exp2f(s0 - m_new) + exp2f(s1 - m_new);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = m_old == -INFINITY ? 0.f : exp2f(m_old - m_new);
      __syncwarp();
      if (lane == 0) {
        Ms[row] = m_new;
        Ls[row] = Ls[row] * alpha + sum;
      }
      __syncwarp();
    }
    __syncthreads();  // the K tile is overwritten next iteration
  }
  // natural-log units; -inf for a row that kept no tile
  for (int i = threadIdx.x; i < BT; i += NTHREADS)
    if (q0 + i < a.Sq)
      a.lse_out[((long long)b * a.H + h) * a.Sq + q0 + i] =
          Ls[i] > 0.f ? (Ms[i] + log2f(Ls[i])) / LOG2E : -INFINITY;
}

template <int DP, bool MASKED, bool STRADDLE>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  auto kern = flash_lse_kernel<DP, MASKED, STRADDLE>;
  const int bytes = LseSmem<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + BT - 1) / BT, a.H, B);
  kern<<<grid, NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// lse (B, H, Sq) fp32 <- q (B, Sq, H*D), k (B, Skv, H*D); keep may be null.
extern "C" int sg_flash_lse(const void* q, const void* k, void* lse, int B,
                            int H, int Sq, int Skv, int D, long long qb,
                            long long qr, long long kb, long long kr,
                            const void* keep, int nref, int span,
                            float scale, void* stream) {
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.lse_out = static_cast<float*>(lse);
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.qb = qb;
  a.qr = qr;
  a.kb = kb;
  a.kr = kr;
  a.keep = static_cast<const int*>(keep);
  a.nref = nref;
  a.span = span;
  a.scale_log2 = scale * LOG2E;
  if (a.keep != nullptr && (span <= 0 || nref * span != Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool straddle = a.keep != nullptr && span % BT != 0;
#define SG_CASE(N)                                                   \
  case N:                                                            \
    return static_cast<int>(                                         \
        straddle ? launch<N, true, true>(a, B, s)                    \
                 : (a.keep ? launch<N, true, false>(a, B, s)         \
                           : launch<N, false, false>(a, B, s)));
  // The UNet's head dims: 40 (padded to 48), 80 and 160.
  switch ((D + 15) / 16 * 16) {
    SG_CASE(48)
    SG_CASE(80)
    SG_CASE(160)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SG_CASE
}
