// Flash-attention backward for Hopper (sm_90a): three kernels that follow
// the split of the TPU backward in storygen_tpu/ops/pallas_attention.py
// (_pallas_bwd_with_out, reached through _core_bwd):
//
//   L    flash_lse_kernel  replaces _lse_kernel: the forward's row
//        logsumexp, lse = log sum_k exp(s * q.k), recomputed over K tiles;
//   DQ   flash_dq_kernel   replaces _dq_kernel: per 64-row Q tile, a loop
//        over K/V tiles accumulating dQ = scale * sum_k dS K, with
//        P = exp(s q.k - lse), dP = dO V^T, dS = P * (dP - delta);
//   DKV  flash_dkv_kernel  replaces _dkv_kernel: per 64-row K/V tile, a
//        loop over Q tiles accumulating dV = P^T dO and dK = scale dS^T Q.
//
// delta = rowsum(dO * O) is computed by the caller in fp32 (plain torch,
// as the JAX package computes it in XLA). Because dQ and dK/dV each own
// their output tile and loop over the other side, no atomics are needed.
//
// What bounds it on the H100: like the forward, the (Sq, Skv) logits are
// 16-48x larger than Q, K, V, dO and the gradients together at the UNet's
// level-1 shapes, so kernels that keep S, P, dP and dS in shared memory are
// bound by tensor-core work: L does 1 product of Q K^T per tile, DQ 3
// (S, dP, dS K) and DKV 4 (S^T, dP^T, P^T dO, dS^T Q). The design recomputes
// P in each kernel rather than storing it.
//
// Layout and numerics as in the forward (flash_fwd.cu): one block of 4
// warps per (64-row tile, head, batch), each warp owning 16 rows of the
// block's own tile, so the softmax-side elementwise work needs only warp
// synchronisation. bf16 WMMA with fp32 accumulation; accumulators in fp32
// shared memory. P and dS are rounded to bf16 as the A operands of their
// products, as the TPU kernels cast them. Head dim 40 is zero-padded to 48
// in shared memory only. Rows past Skv (attn2's 77 text tokens) load as
// zeros, get P = 0 in DQ and are never written by DKV; rows past Sq get
// P = 0 in DKV (lse = +inf) and are never written by DQ. With `keep`
// (B, N refs) over N equal spans that are multiples of 64 rows, L and DQ
// skip dropped K/V tiles and DKV writes zeros for a dropped tile without
// loading anything. Inputs are read from the projections' (B, S, H*D)
// layout through batch and row strides; dQ, dK, dV are written as
// (B, S, H*D). Simple first: no cp.async pipelining, wgmma or TMA yet.
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

// Shared-memory layout: `bt` bf16 (BT, DP) tiles, `sf` fp32 (BT, BT) score
// tiles, `sb` bf16 (BT, BT) operand tiles, `acc` fp32 (BT, DP) accumulators
// and two fp32 rows of BT scalars.
template <int DP, int NT, int NSF, int NSB, int NACC>
struct Smem {
  static constexpr int tile = align128(BT * DP * 2);
  static constexpr int sf = align128(BT * BT * 4);
  static constexpr int sb = align128(BT * BT * 2);
  static constexpr int acc = align128(BT * DP * 4);
  static constexpr int t0 = 0;
  static constexpr int sf0 = t0 + NT * tile;
  static constexpr int sb0 = sf0 + NSF * sf;
  static constexpr int acc0 = sb0 + NSB * sb;
  static constexpr int row0 = acc0 + NACC * acc;
  static constexpr int bytes = row0 + 2 * align128(BT * 4);
};
template <int DP> using LseSmem = Smem<DP, 2, 1, 0, 0>;
template <int DP> using DqSmem = Smem<DP, 4, 2, 1, 1>;
template <int DP> using DkvSmem = Smem<DP, 4, 2, 2, 2>;

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

template <int DP>
__device__ __forceinline__ void zero_acc(float* acc) {
  for (int i = threadIdx.x; i < BT * DP; i += NTHREADS) acc[i] = 0.f;
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

// Acc[wr:wr+16, 0:DP] += P[wr:wr+16, 0:BT] X, P a (BT, BT) row-major bf16
// tile and X a (BT, DP) row-major bf16 tile; Acc fp32 with row stride DP.
template <int DP>
__device__ __forceinline__ void warp_acc_px(float* Acc, const bf16* P,
                                            const bf16* X, int wr) {
#pragma unroll
  for (int dt = 0; dt < DP / 16; ++dt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, Acc + wr * DP + dt * 16, DP,
                           wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bx;
      wmma::load_matrix_sync(a, P + wr * BT + kk * 16, BT);
      wmma::load_matrix_sync(bx, X + kk * 16 * DP + dt * 16, DP);
      wmma::mma_sync(acc, a, bx, acc);
    }
    wmma::store_matrix_sync(Acc + wr * DP + dt * 16, acc, DP,
                            wmma::mem_row_major);
  }
}

// Write rows [row0, row0 + BT) of acc * mul as bf16 into (B, S, H*D).
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, const float* acc,
                                           float mul, int b, int h, int H,
                                           int S, int D, int row0) {
  const long long rs = (long long)H * D;
  for (int idx = threadIdx.x; idx < BT * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    if (gr < S)
      out[((long long)b * S + gr) * rs + (long long)h * D + c] =
          __float2bfloat16(acc[r * DP + c] * mul);
  }
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  float* lse_out;
  bf16 *dq, *dk, *dv;
  int H, Sq, Skv, D;
  long long qb, qr, kb, kr, vb, vr;  // batch and row strides of q, k, v
  const int* keep;                   // (B, nref) or nullptr
  int nref, span;
  float scale, scale_log2;
};

// ----------------------------------------------------------------- L
template <int DP, bool MASKED>
__global__ void __launch_bounds__(NTHREADS) flash_lse_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = LseSmem<DP>;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::t0);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::t0 + L::tile);
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
    if (MASKED && !a.keep[b * a.nref + k0 / a.span]) continue;
    load_tile<DP>(Ks, kbase, a.kr, k0, a.Skv, a.D);
    __syncthreads();
    warp_abt<DP>(Ss, Qs, Ks, wr);
    __syncwarp();
    const int kvalid = min(BT, a.Skv - k0);
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
      const float s0 =
          lane < kvalid ? Ss[row * BT + lane] * a.scale_log2 : -INFINITY;
      const float s1 = lane + 32 < kvalid
                           ? Ss[row * BT + lane + 32] * a.scale_log2
                           : -INFINITY;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[row];
      const float m_new = fmaxf(m_old, mx);  // finite: column 0 is valid
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

// ----------------------------------------------------------------- DQ
template <int DP, bool MASKED>
__global__ void __launch_bounds__(NTHREADS) flash_dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = DqSmem<DP>;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::t0);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::t0 + L::tile);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::t0 + 2 * L::tile);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::t0 + 3 * L::tile);
  float* Ss = reinterpret_cast<float*>(smem + L::sf0);
  float* dPs = reinterpret_cast<float*>(smem + L::sf0 + L::sf);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::sb0);
  float* dQacc = reinterpret_cast<float*>(smem + L::acc0);
  float* lse_s = reinterpret_cast<float*>(smem + L::row0);
  float* delta_s = lse_s + align128(BT * 4) / 4;

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * 16;
  const long long hd = (long long)h * a.D;
  const long long dob = (long long)a.Sq * a.H * a.D;  // dO is contiguous
  load_tile<DP>(Qs, a.q + b * a.qb + hd, a.qr, q0, a.Sq, a.D);
  load_tile<DP>(dOs, a.dout + b * dob + hd, (long long)a.H * a.D, q0, a.Sq,
                a.D);
  zero_acc<DP>(dQacc);
  const long long rb = ((long long)b * a.H + h) * a.Sq;
  for (int i = threadIdx.x; i < BT; i += NTHREADS) {
    const bool ok = q0 + i < a.Sq;
    lse_s[i] = ok ? a.lse[rb + q0 + i] * LOG2E : 0.f;
    delta_s[i] = ok ? a.delta[rb + q0 + i] : 0.f;
  }
  const bf16* kbase = a.k + b * a.kb + hd;
  const bf16* vbase = a.v + b * a.vb + hd;
  for (int k0 = 0; k0 < a.Skv; k0 += BT) {
    if (MASKED && !a.keep[b * a.nref + k0 / a.span]) continue;
    load_tile<DP>(Ks, kbase, a.kr, k0, a.Skv, a.D);
    load_tile<DP>(Vs, vbase, a.vr, k0, a.Skv, a.D);
    __syncthreads();
    warp_abt<DP>(Ss, Qs, Ks, wr);    // S = Q K^T
    warp_abt<DP>(dPs, dOs, Vs, wr);  // dP = dO V^T
    __syncwarp();
    const int kvalid = min(BT, a.Skv - k0);
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
      for (int c = lane; c < BT; c += 32) {
        const float p =
            c < kvalid
                ? exp2f(Ss[row * BT + c] * a.scale_log2 - lse_s[row])
                : 0.f;
        dSs[row * BT + c] =
            __float2bfloat16(p * (dPs[row * BT + c] - delta_s[row]));
      }
    }
    __syncwarp();
    warp_acc_px<DP>(dQacc, dSs, Ks, wr);  // dQ += dS K
    __syncthreads();  // K/V tiles are overwritten next iteration
  }
  store_rows<DP>(a.dq, dQacc, a.scale, b, h, a.H, a.Sq, a.D, q0);
}

// ----------------------------------------------------------------- DKV
template <int DP, bool MASKED>
__global__ void __launch_bounds__(NTHREADS) flash_dkv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = DkvSmem<DP>;
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::t0);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::t0 + L::tile);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::t0 + 2 * L::tile);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::t0 + 3 * L::tile);
  float* St = reinterpret_cast<float*>(smem + L::sf0);
  float* dPt = reinterpret_cast<float*>(smem + L::sf0 + L::sf);
  bf16* Pt = reinterpret_cast<bf16*>(smem + L::sb0);
  bf16* dSt = reinterpret_cast<bf16*>(smem + L::sb0 + L::sb);
  float* dKacc = reinterpret_cast<float*>(smem + L::acc0);
  float* dVacc = reinterpret_cast<float*>(smem + L::acc0 + L::acc);
  float* lse_s = reinterpret_cast<float*>(smem + L::row0);
  float* delta_s = lse_s + align128(BT * 4) / 4;

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * 16;  // this warp's first K/V row inside the tile
  const long long hd = (long long)h * a.D;
  zero_acc<DP>(dKacc);
  zero_acc<DP>(dVacc);
  if (MASKED && !a.keep[b * a.nref + k0 / a.span]) {
    // a dropped span gets no gradient
    __syncthreads();
    store_rows<DP>(a.dk, dKacc, 0.f, b, h, a.H, a.Skv, a.D, k0);
    store_rows<DP>(a.dv, dVacc, 0.f, b, h, a.H, a.Skv, a.D, k0);
    return;
  }
  load_tile<DP>(Ks, a.k + b * a.kb + hd, a.kr, k0, a.Skv, a.D);
  load_tile<DP>(Vs, a.v + b * a.vb + hd, a.vr, k0, a.Skv, a.D);
  const long long dob = (long long)a.Sq * a.H * a.D;  // dO is contiguous
  const long long rb = ((long long)b * a.H + h) * a.Sq;
  for (int q0 = 0; q0 < a.Sq; q0 += BT) {
    load_tile<DP>(Qs, a.q + b * a.qb + hd, a.qr, q0, a.Sq, a.D);
    load_tile<DP>(dOs, a.dout + b * dob + hd, (long long)a.H * a.D, q0,
                  a.Sq, a.D);
    for (int i = threadIdx.x; i < BT; i += NTHREADS) {
      const bool ok = q0 + i < a.Sq;  // rows past Sq: P = exp2(-inf) = 0
      lse_s[i] = ok ? a.lse[rb + q0 + i] * LOG2E : INFINITY;
      delta_s[i] = ok ? a.delta[rb + q0 + i] : 0.f;
    }
    __syncthreads();
    warp_abt<DP>(St, Ks, Qs, wr);    // S^T = K Q^T
    warp_abt<DP>(dPt, Vs, dOs, wr);  // dP^T = V dO^T
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
      for (int c = lane; c < BT; c += 32) {
        const float p = exp2f(St[row * BT + c] * a.scale_log2 - lse_s[c]);
        Pt[row * BT + c] = __float2bfloat16(p);
        dSt[row * BT + c] =
            __float2bfloat16(p * (dPt[row * BT + c] - delta_s[c]));
      }
    }
    __syncwarp();
    warp_acc_px<DP>(dVacc, Pt, dOs, wr);  // dV += P^T dO
    warp_acc_px<DP>(dKacc, dSt, Qs, wr);  // dK += dS^T Q
    __syncthreads();  // Q/dO tiles and the row scalars are overwritten next
  }
  store_rows<DP>(a.dk, dKacc, a.scale, b, h, a.H, a.Skv, a.D, k0);
  store_rows<DP>(a.dv, dVacc, 1.f, b, h, a.H, a.Skv, a.D, k0);
}

enum Which { kLse = 0, kDq = 1, kDkv = 2 };

template <int DP, bool MASKED>
cudaError_t launch(Which which, const Args& a, int B, cudaStream_t stream) {
  void (*kern)(Args);
  int bytes, tiles;
  if (which == kLse) {
    kern = flash_lse_kernel<DP, MASKED>;
    bytes = LseSmem<DP>::bytes;
    tiles = (a.Sq + BT - 1) / BT;
  } else if (which == kDq) {
    kern = flash_dq_kernel<DP, MASKED>;
    bytes = DqSmem<DP>::bytes;
    tiles = (a.Sq + BT - 1) / BT;
  } else {
    kern = flash_dkv_kernel<DP, MASKED>;
    bytes = DkvSmem<DP>::bytes;
    tiles = (a.Skv + BT - 1) / BT;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles, a.H, B);
  kern<<<grid, NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

int dispatch(Which which, Args& a, int B, int D, float scale,
             void* stream) {
  a.D = D;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  if (a.keep != nullptr &&
      (a.span <= 0 || a.span % BT || a.nref * a.span != a.Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = (D + 15) / 16 * 16;
#define SG_CASE(N)                                             \
  case N:                                                      \
    return static_cast<int>(a.keep ? launch<N, true>(which, a, B, s) \
                                   : launch<N, false>(which, a, B, s));
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

Args make_args(const void* q, const void* k, int B, int H, int Sq, int Skv,
               long long qb, long long qr, long long kb, long long kr,
               const void* keep, int nref, int span) {
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.qb = qb;
  a.qr = qr;
  a.kb = kb;
  a.kr = kr;
  a.keep = static_cast<const int*>(keep);
  a.nref = nref;
  a.span = span;
  (void)B;
  return a;
}

}  // namespace

// lse (B, H, Sq) fp32 <- q (B, Sq, H*D), k (B, Skv, H*D); keep may be null.
extern "C" int sg_flash_lse(const void* q, const void* k, void* lse, int B,
                            int H, int Sq, int Skv, int D, long long qb,
                            long long qr, long long kb, long long kr,
                            const void* keep, int nref, int span,
                            float scale, void* stream) {
  Args a = make_args(q, k, B, H, Sq, Skv, qb, qr, kb, kr, keep, nref, span);
  a.lse_out = static_cast<float*>(lse);
  return dispatch(kLse, a, B, D, scale, stream);
}

// dq (B, Sq, H*D) <- q, k, v, dout (B, Sq, H*D) contiguous, lse and delta
// (B, H, Sq) fp32.
extern "C" int sg_flash_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int H, int Sq,
                           int Skv, int D, long long qb, long long qr,
                           long long kb, long long kr, long long vb,
                           long long vr, const void* keep, int nref,
                           int span, float scale, void* stream) {
  Args a = make_args(q, k, B, H, Sq, Skv, qb, qr, kb, kr, keep, nref, span);
  a.v = static_cast<const bf16*>(v);
  a.vb = vb;
  a.vr = vr;
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
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
  Args a = make_args(q, k, B, H, Sq, Skv, qb, qr, kb, kr, keep, nref, span);
  a.v = static_cast<const bf16*>(v);
  a.vb = vb;
  a.vr = vr;
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  return dispatch(kDkv, a, B, D, scale, stream);
}
