// Warp-level tensor-core and async-copy helpers shared by the kernels that
// use them (fused_decode_matmul.cu's prefill kernel, flash_attention.cu's
// bf16 kernel): 16-byte cp.async with its commit and wait, ldmatrix of four
// 8 × 8 bf16 matrices (plain and transposed), and one mma.sync m16n8k16
// (bf16 in, f32 sums).  These are the sm_80 instructions, which Hopper
// keeps; wgmma and TMA are sm_90a's own and are not used here yet.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qmoe {

// dst[0:16) = src[0:16), or zeros when src_bytes is 0 (no read), without
// passing through registers.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's copy groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// The four 8 × 8 bf16 matrices at the rows lanes 0–7, 8–15, 16–23, 24–31
// point at, one register each: lane i holds row i / 4, columns
// 2·(i % 4) and 2·(i % 4) + 1 of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// The same four matrices transposed: lane i holds rows 2·(i % 4) and
// 2·(i % 4) + 1 of column i / 4 (a row-major k × n tile read as the
// column-major B operand of mma.sync).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d += a · b for one m16n8k16 tile, bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace qmoe
