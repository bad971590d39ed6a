// Shared building blocks of the mma.sync kernels (the attention studies S3
// and S4, study_qk.cu and study_int8.cu, and the conv template conv_mma.cuh
// at the conv_in / conv_out keys): tile copies from HBM into shared memory
// through cp.async, ldmatrix fragment loads and the mma.sync tensor-core
// products, for sm_90a. The scalar helpers (bf16, smem_addr, fast_exp2,
// pack_bf16, quad_sum, quad_max) are hopper.cuh's, named here too.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 / m16n8k32): in a warp, lane =
// 4 * grp + tq. A 16 x 8 fp32 (or int32) accumulator tile holds, per lane,
// c[0], c[1] at row grp, columns 2 tq and 2 tq + 1, and c[2], c[3] at row
// grp + 8, the same columns. Two neighbouring accumulator tiles of S (kv
// columns 16 kk .. 16 kk + 15) are, packed to bf16 pairs, exactly the A
// fragment of the next product P V over those 16 kv rows, so P never leaves
// the registers.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace sg_study {

using sg_hopper::bf16;
using sg_hopper::fast_exp2;
using sg_hopper::pack_bf16;
using sg_hopper::quad_sum;
using sg_hopper::smem_addr;

__host__ __device__ constexpr int align128(int x) {
  return (x + 127) / 128 * 128;
}

// Ring stages of a kernel whose ring stage takes `stage` bytes of shared
// memory (the attention studies' K/V rings): 3 where two blocks of three
// stages fit in an SM's 233,472 bytes (less the 1 KB the card reserves per
// block), so that the third stage costs no resident block; else 2.
__host__ __device__ constexpr int ring_stages(int stage) {
  return 2 * (3 * stage + 1024) <= 233472 ? 3 : 2;
}

// Row pitch in bytes of a shared tile whose rows hold `row_bytes` bytes (a
// multiple of 16): an odd number of 16-byte units, so the eight rows one
// ldmatrix reads fall in eight different bank groups.
__host__ __device__ constexpr int pitch_bytes(int row_bytes) {
  return (row_bytes / 16) % 2 ? row_bytes : row_bytes + 16;
}

// 16-byte cp.async copy into shared memory; the bytes past `src_bytes`
// are zero-filled (0: the copy reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

// 8-byte cp.async copy into shared memory, through L1 (the .cg form takes
// 16 bytes only); the bytes past `src_bytes` are zero-filled
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of chunk `idx` (row idx / CPR, 16-byte column idx % CPR)
// of rows [row0, ...) x [0, D) of a strided bf16 matrix (`src` its first
// row of this head, row stride `rs` elements) into a shared tile of pitch
// PITCH. A chunk past `nrows` or past D is zero-filled by the copy, which
// then reads nothing; its address is `src`.
template <int CPR, int PITCH>
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const bf16* src,
                                           long long rs, int row0, int nrows,
                                           int D, int idx) {
  const int r = idx / CPR, c = idx % CPR;
  const bool in = row0 + r < nrows && c * 8 < D;
  cp_async16(dst + r * PITCH + c * 16,
             in ? src + (long long)(row0 + r) * rs + c * 8 : src,
             in ? 16 : 0);
}

// Start the copies of rows [row0, row0 + ROWS) of a tile (copy_chunk).
template <int ROWS, int CPR, int PITCH, int NT>
__device__ __forceinline__ void copy_tile(unsigned char* dst, const bf16* src,
                                          long long rs, int row0, int nrows,
                                          int D, int tid) {
  constexpr int N = ROWS * CPR;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int idx = tid + i * NT;
    if (N % NT == 0 || idx < N)
      copy_chunk<CPR, PITCH>(dst, src, rs, row0, nrows, D, idx);
  }
}

// copy_tile for a kernel whose registers hold O and the Q fragments across
// its main loop (the attention studies): where a thread copies more than
// four chunks of the tile, a rolled loop that computes each chunk's
// addresses as it goes, so they are not held in registers.
template <int ROWS, int CPR, int PITCH, int NT>
__device__ __forceinline__ void copy_tile_lean(unsigned char* dst,
                                               const bf16* src, long long rs,
                                               int row0, int nrows, int D,
                                               int tid) {
  if constexpr (ROWS * CPR <= 4 * NT) {
    copy_tile<ROWS, CPR, PITCH, NT>(dst, src, rs, row0, nrows, D, tid);
  } else {
#pragma unroll 1
    for (int idx = tid; idx < ROWS * CPR; idx += NT)
      copy_chunk<CPR, PITCH>(dst, src, rs, row0, nrows, D, idx);
  }
}

// Start the copies of rows [row0, row0 + ROWS) of an int8 matrix whose
// rows are D bytes apart (D a multiple of 8: the 40-byte rows of d = 40
// are 8-byte aligned only) into a shared tile of DPB bytes a row (pitch
// PITCH), in 8-byte pieces; the bytes past D are zero-filled. A rolled
// loop, as copy_tile_lean.
template <int ROWS, int DPB, int PITCH, int NT>
__device__ __forceinline__ void copy_rows8(unsigned char* dst,
                                           const unsigned char* src,
                                           int row0, int D, int tid) {
  constexpr int CPR = DPB / 8;
#pragma unroll 1
  for (int idx = tid; idx < ROWS * CPR; idx += NT) {
    const int r = idx / CPR, c = idx % CPR;
    const bool in = c * 8 < D;
    cp_async8(dst + r * PITCH + c * 8,
              in ? src + (long long)(row0 + r) * D + c * 8 : src, in ? 8 : 0);
  }
}

// Start the 16-byte copies of `nbytes` contiguous bytes (a multiple of 16,
// both ends 16-byte aligned). A rolled loop, as copy_tile_lean.
template <int NT>
__device__ __forceinline__ void copy_run16(unsigned char* dst,
                                           const unsigned char* src,
                                           int nbytes, int tid) {
#pragma unroll 1
  for (int i = tid; i < nbytes / 16; i += NT)
    cp_async16(dst + 16 * i, src + 16 * i, 16);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// c += a b, bf16 inputs, fp32 accumulation, m16n8k16
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, int8 inputs, int32 accumulation, m16n8k32
__device__ __forceinline__ void mma_s8_k32(int (&c)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, int8 inputs, int32 accumulation, m16n8k16 (the tail of d = 40)
__device__ __forceinline__ void mma_s8_k16(int (&c)[4], uint32_t a0,
                                           uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// O (16 x 8 * DT tiles) += P V for a warp: P's A fragment for kv rows
// 16 kk .. 16 kk + 15 is built from S tiles 2 kk and 2 kk + 1 (already
// rounded to bf16 pairs in `p`), V's B fragments come from V's rows with a
// transposing ldmatrix, two d tiles per x4.
template <int KT, int DT>
__device__ __forceinline__ void pv_bf16(float (&o)[DT][4],
                                        const uint32_t (&p)[KT][4],
                                        const unsigned char* vrows, int pitch,
                                        int lane) {
  const unsigned char* q =
      vrows + (lane % 8 + 8 * ((lane / 8) % 2)) * pitch + 16 * (lane / 16);
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int dt = 0; dt < DT; dt += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, q + kk * 16 * pitch + dt * 16);
      mma_bf16(o[dt], p[kk], b[0], b[1]);
      mma_bf16(o[dt + 1], p[kk], b[2], b[3]);
    }
  }
}

// int8 A fragments of a warp's 16 rows of DPB bytes (a multiple of 16):
// a[kk] for each 32-byte k step (m16n8k32), and for a 16-byte tail
// (m16n8k16) a[DPB / 32][0..1].
template <int DPB>
__device__ __forceinline__ void load_a_s8(uint32_t (&a)[(DPB + 31) / 32][4],
                                          const unsigned char* rows,
                                          int pitch, int lane) {
  const unsigned char* p =
      rows + (lane % 8 + 8 * ((lane / 8) % 2)) * pitch + 16 * (lane / 16);
#pragma unroll
  for (int kk = 0; kk < DPB / 32; ++kk) ldsm_x4(a[kk], p + 32 * kk);
  if constexpr (DPB % 32 != 0) {
    uint32_t t[2];
    ldsm_x2(t, rows + (lane % 8 + 8 * ((lane / 8) % 2)) * pitch +
                   32 * (DPB / 32));
    a[DPB / 32][0] = t[0];
    a[DPB / 32][1] = t[1];
  }
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// S (int32, NT tiles of 16 x 8) += A K^T for int8 A fragments against
// NT * 8 int8 K rows stored densely from `krows`, D bytes apart (a K tile
// copied as the one contiguous run it is in HBM: the 40-byte rows of
// d = 40 are not 16-byte aligned, so ldmatrix cannot read them): B
// fragments by 32-bit loads; the k16 tail of D = 40 masks the bytes past D
// (the next row's).
template <int DPB, int NT>
__device__ __forceinline__ void qk_s8_dense(
    int (&s)[NT][4], const uint32_t (&a)[(DPB + 31) / 32][4],
    const unsigned char* krows, int D, int lane) {
  const int grp = lane / 4, tq = lane % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const unsigned char* r = krows + (8 * j + grp) * D + 4 * tq;
#pragma unroll
    for (int kk = 0; kk < DPB / 32; ++kk)
      mma_s8_k32(s[j], a[kk], ld32(r + 32 * kk), ld32(r + 32 * kk + 16));
    if constexpr (DPB % 32 != 0) {
      const bool in = 32 * (DPB / 32) + 4 * tq < D;
      mma_s8_k16(s[j], a[DPB / 32][0], a[DPB / 32][1],
                 in ? ld32(r + 32 * (DPB / 32)) : 0u);
    }
  }
}

// The bf16 A fragment of P V over the 16 kv rows held by S tiles a and b.
__device__ __forceinline__ void pack_p16(uint32_t (&p)[4], const float (&a)[4],
                                         const float (&b)[4]) {
  p[0] = pack_bf16(a[0], a[1]);
  p[1] = pack_bf16(a[2], a[3]);
  p[2] = pack_bf16(b[0], b[1]);
  p[3] = pack_bf16(b[2], b[3]);
}

// Round the probabilities of S tiles (NT = 2 KT) to the bf16 A fragments of
// the P V product.
template <int NT>
__device__ __forceinline__ void pack_p(uint32_t (&p)[NT / 2][4],
                                       const float (&s)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) pack_p16(p[kk], s[2 * kk], s[2 * kk + 1]);
}

// The value at accumulator column `col` of this lane's two rows (grp and
// grp + 8): the lane of the quad that holds it adds it to zero, the others
// add nothing, and the quad's sum is exact. (Picking o[col / 8] by a
// select of its elements would index o at run time, and o would live in
// local memory.)
template <int DT>
__device__ __forceinline__ void column_of(const float (&o)[DT][4], int col,
                                          int lane, float& r0, float& r1) {
  float x0 = 0.f, x1 = 0.f;
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (8 * j + 2 * (lane % 4) + e == col) {
        x0 += o[j][e];
        x1 += o[j][e + 2];
      }
  r0 = quad_sum(x0);
  r1 = quad_sum(x1);
}

// Write a warp's 16 output rows (row0 = first row, out rows of d bf16):
// row grp gets o[.][0..1] / den0, row grp + 8 gets o[.][2..3] / den1.
template <int DT>
__device__ __forceinline__ void store_rows(bf16* out, long long row0, int d,
                                           const float (&o)[DT][4], float den0,
                                           float den1, int lane) {
  const int grp = lane / 4, tq = lane % 4;
  bf16* r0 = out + (row0 + grp) * d;
  bf16* r1 = out + (row0 + grp + 8) * d;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = 8 * j + 2 * tq;
    if (c < d) {
      *reinterpret_cast<uint32_t*>(r0 + c) =
          pack_bf16(o[j][0] / den0, o[j][1] / den0);
      *reinterpret_cast<uint32_t*>(r1 + c) =
          pack_bf16(o[j][2] / den1, o[j][3] / den1);
    }
  }
}

}  // namespace sg_study
