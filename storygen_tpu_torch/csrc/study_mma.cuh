// Shared building blocks of the mma.sync kernels (the conv template
// conv_mma.cuh at the conv_in / conv_out keys): tile copies from HBM into
// shared memory through cp.async, ldmatrix fragment loads and the mma.sync
// bf16 product, for sm_90a. The scalar helpers (bf16, smem_addr,
// fast_exp2, pack_bf16, quad_sum) are hopper.cuh's, named here too.
//
// Fragment layouts (PTX ISA, mma.m16n8k16): in a warp, lane = 4 * grp +
// tq. A 16 x 8 fp32 accumulator tile holds, per lane, c[0], c[1] at row
// grp, columns 2 tq and 2 tq + 1, and c[2], c[3] at row grp + 8, the same
// columns.
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// c += a b, bf16 inputs, fp32 accumulation, m16n8k16
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace sg_study
