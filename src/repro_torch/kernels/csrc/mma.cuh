// Tensor-core and asynchronous-copy helpers shared by the port's kernels
// (gradestc.cu, flash_attention.cu); sm_80 instructions, built for sm_90a.
#pragma once

#include <stdint.h>

// ---- asynchronous global -> shared copies (sm_80+).  When !pred nothing is
// read (src may be any valid address) and the destination is zero-filled.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- 3xTF32 on the tensor cores: each f32 operand x splits into hi =
// tf32(x) and lo = tf32(x - hi) (x - hi is exact), and the product
// accumulates lo*hi + hi*lo + hi*hi in f32 (mma.sync m16n8k8; fragment
// lanes g = lane/4, t = lane%4: A a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3
// (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g); C c0 (g, 2t), c1 (g, 2t+1),
// c2 (g+8, 2t), c3 (g+8, 2t+1)).
// tf32(x) rounded to nearest, ties away from zero: cvt.rna.tf32.f32's
// result for every finite x (half of the 13 dropped bits' range is added to
// the magnitude's bit pattern, whose carry rounds up, then the bits are
// dropped), in two integer operations; the cvt instruction costs four on
// sm_90 (it also checks for NaN and infinity, which never reach the MMAs)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}
