// Device helpers shared by the port's tensor-core kernels (sm_90a): the
// TF32 split of 3xTF32 products, mma.sync and wgmma in TF32, shared-memory
// descriptors, cp.async copies.
//
// 3xTF32: each fp32 operand is split as a = a_hi + a_lo, a_hi = rna(a),
// a_lo = rna(a - a_hi), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi (the small
// terms first). rna is cvt.rna.tf32.f32 (10 mantissa bits, ties away from
// zero), computed as two integer operations on the bits, which give the same
// bits and ran faster than the conversion instruction on the H100.
//
// wgmma .tf32 reads B from shared memory, K-major only; A comes from
// registers in the mma.sync fragment layout. Shared-memory operands here are
// K-major "core matrices" of 8 rows x 4 tf32 (128 contiguous bytes), no
// swizzle: the descriptor's leading offset steps to the next core matrix
// along K, its stride offset to the next 8 rows along M/N (core_off).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cvt.rna.tf32.f32 (round to 10 mantissa bits, ties away from zero), as two
// integer operations on the bits: the same result for every finite x.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 (x - hi is exact: hi is x rounded to 10 bits)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// 2^x on the special-function unit
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16- or 4-byte asynchronous copy; with valid false the destination is zeroed
// and nothing is read (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint64_t smem_desc(const void* p, int lead_bytes, int stride_bytes) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lead_bytes & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((stride_bytes & 0x3FFFF) >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accumulator registers across a wgmma in flight
template <int N>
__device__ __forceinline__ void wg_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a b: one warpgroup, M = 64 rows (16 a warp, A in the mma.sync
// fragment layout), N = 32, K = 8; accumulate unless first
__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
// the same with N = 64
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (+)= a b in 3xTF32, the small terms first; B given by its hi and lo descriptors
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[16], const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4], uint64_t bh, uint64_t bl,
                                             bool first) {
  wgmma_m64n32k8(d, al, bh, first ? 0 : 1);
  wgmma_m64n32k8(d, ah, bl, 1);
  wgmma_m64n32k8(d, ah, bh, 1);
}
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[32], const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4], uint64_t bh, uint64_t bl,
                                             bool first) {
  wgmma_m64n64k8(d, al, bh, first ? 0 : 1);
  wgmma_m64n64k8(d, ah, bl, 1);
  wgmma_m64n64k8(d, ah, bh, 1);
}

// offset (floats) of element (row r, k) in a K-major core-matrix layout with
// kcores core matrices along K
__device__ __forceinline__ int core_off(int r, int k, int kcores) {
  return (((r >> 3) * kcores + (k >> 2)) << 5) + ((r & 7) << 2) + (k & 3);
}

}  // namespace
