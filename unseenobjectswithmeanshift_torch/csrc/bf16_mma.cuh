// Device helpers of the port's bf16 tensor-core paths (sm_90a): bf16 values
// as raw 16-bit patterns, their rounding and packing, and mma.sync
// m16n8k16 with bf16 operands and fp32 accumulation.
//
// A product of two bf16 values is exact in fp32, so an mma with bf16
// operands and fp32 accumulation computes what a plain version computes
// from the bf16-rounded operands in fp32 (up to the order of the sums).
// Fragments of m16n8k16 (g = lane / 4, tg = lane % 4; the lower 16 bits of a
// register hold the lower column or k index):
//   A [16 x 16] row-major: a0 (row g, k 2tg, 2tg+1), a1 (row g+8, k 2tg..),
//                          a2 (row g, k 2tg+8, 2tg+9), a3 (row g+8, k 2tg+8..)
//   B [16 x 8]:            b0 (k 2tg, 2tg+1, column g), b1 (k 2tg+8, 2tg+9, column g)
//   C [16 x 8]:            c0, c1 (row g, columns 2tg, 2tg+1), c2, c3 (row g+8, ..)
// The C layout is that of m16n8k8 .tf32, and a warp's rows of a wgmma
// m64nNk accumulator, so epilogues written for those read it as they are.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the bf16 pattern nearest to x (round to nearest even)
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
// the float value of a bf16 pattern (exact)
__device__ __forceinline__ float bf16_float(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}
// two bf16 patterns in one register, lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// d += a b, bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
