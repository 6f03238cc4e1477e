// bf16 tensor-core helpers shared by the VGG stage (vgg_stage.cu) and the
// fused GATsSPG block's attention kernels (gats_block.cu).
//
// mma.sync m16n8k16, A row-major 16x16 bf16, B column-major 16x8 bf16, C/D
// 16x8 fp32. With g = lane / 4 and t = lane % 4, a thread holds
//   A: a[0] = (row g,     k 2t..2t+1), a[1] = (row g + 8, k 2t..2t+1),
//      a[2] = (row g,     k 2t+8..+9), a[3] = (row g + 8, k 2t+8..+9);
//   B: b0 = (k 2t..2t+1, col g), b1 = (k 2t+8..+9, col g);
//   D: d[0..1] = (row g, cols 2t, 2t+1), d[2..3] = (row g + 8, cols 2t, 2t+1).
// Each 32-bit register holds two bf16, the lower k (or column) in the low half.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 at p (4-byte aligned) as one register.
__device__ __forceinline__ uint32_t ld_bf16x2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (lo, hi) rounded to nearest bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 bf16 matrices from shared memory: lane i gives the address of
// row i % 8 of matrix i / 8; register j of every lane receives matrix j in
// the mma fragment layout (row g, columns 2t and 2t + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
