// TF32 tensor-core helpers shared by the float32 attention and scan
// kernels: cp.async staging and mma.sync m16n8k8 in the 3xTF32 scheme.
// (The fp16 / bf16 attention kernels use half tensor cores instead:
// half_mma.cuh.)
//
// 3xTF32: each float32 operand x splits into x_hi (x with its low 13
// mantissa bits cleared, a TF32 value) and x_lo = x - x_hi, of which the
// tensor core reads the top 11 significant bits; a product keeps three
// terms, a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, in a float32 accumulator.
// The dropped a_lo*b_lo and the bits of x_lo the tensor core ignores
// leave at most ~2^-19 of each product, near float32, where one TF32
// product (2^-11) breaks the 1e-4 parity of the port.  The split is an
// AND and a subtraction; two cvt.rna roundings cost more ALU time than
// the tensor cores save, for no accuracy the parity needs.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4),
//                    a[3] (g + 8, t + 4)
//   B (8 x 8, col):  b[0] (k = t, n = g), b[1] (k = t + 4, n = g)
//   C (16 x 8):      c[0] (g, 2t), c[1] (g, 2t + 1), c[2] (g + 8, 2t),
//                    c[3] (g + 8, 2t + 1)
#pragma once

#include <cstdint>

#include "common.cuh"

// 16- and 4-byte cp.async copies, filling the destination with zeros when
// `full` is false (src is then not read, but must still be a valid
// address).
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src,
                                                 bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of `rows` rows of W floats (row pitch `st` floats in
// global memory) into shared rows of `ld` floats; rows at or past
// `valid` are zero-filled.  `vec`: 16-byte copies (source address and
// pitch 16-byte aligned, W a multiple of 4), else 4-byte ones.  Every
// thread of the block takes part; the caller commits and waits.
template <int W>
__device__ __forceinline__ void stage_rows(float* s, int ld, const float* g,
                                           long long st, int rows, int valid,
                                           bool vec) {
  if (vec) {
    constexpr int CPR = W / 4;
    for (int idx = threadIdx.x; idx < rows * CPR; idx += blockDim.x) {
      const int i = idx / CPR, c = (idx % CPR) * 4;
      const bool in = i < valid;
      cp_async16_zfill(s + i * ld + c, g + (in ? i : 0) * st + c, in);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * W; idx += blockDim.x) {
      const int i = idx / W, c = idx % W;
      const bool in = i < valid;
      cp_async4_zfill(s + i * ld + c, g + (in ? i : 0) * st + c, in);
    }
  }
}

// x = hi + lo: hi is x with the low 13 mantissa bits cleared (a TF32
// value), lo = x - hi (exact); the tensor core reads lo's top 11
// significant bits and ignores the rest, so x - hi - lo < 2^-21 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in the 3xTF32 scheme, from operands already split
__device__ __forceinline__ void mma_3xtf32_split(float* c, const uint32_t* ah,
                                                 const uint32_t* al,
                                                 const uint32_t* bh,
                                                 const uint32_t* bl) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// c += a * b in the 3xTF32 scheme, from float fragments
__device__ __forceinline__ void mma_3xtf32(float* c, const float* a,
                                           const float* b) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bh[i], bl[i]);
  mma_3xtf32_split(c, ah, al, bh, bl);
}
