// Half tensor-core helpers of the fp16 / bf16 attention kernels: 16-byte
// cp.async copies of half rows, ldmatrix, mma.sync m16n8k16 and the
// two-piece split of the probabilities P.
//
// The products are exact: a product of two fp16 or two bf16 values fits
// float32, and the tensor cores sum them in a float32 accumulator.  The
// probabilities are float32 in registers; rounding each once to the half
// type (what fused attention libraries do) moves an output by up to half
// a ULP of the half type and breaks the port's bit-equal share (99% of
// the outputs of a half attention equal to the float32 plain version's
// rounded once).  So P splits into two pieces of the operands' type,
// P_hi = half(P) and P_lo = half(P - P_hi), each multiplied by V in its
// own half product: P_hi + P_lo is P to 2^-22 (fp16) or 2^-16 (bf16) of P.
//
// Fragment layout of m16n8k16 with 16-bit operands (g = lane / 4,
// t = lane % 4; each register packs two neighbouring k, the lower in the
// low half):
//   A (16 x 16, row): a[0] (g, 2t..2t+1), a[1] (g + 8, 2t..2t+1),
//                     a[2] (g, 2t+8..2t+9), a[3] (g + 8, 2t+8..2t+9)
//   B (16 x 8, col):  b[0] (k = 2t..2t+1, n = g), b[1] (k = 2t+8..2t+9, g)
//   C (16 x 8):       c[0] (g, 2t), c[1] (g, 2t + 1), c[2] (g + 8, 2t),
//                     c[3] (g + 8, 2t + 1)
// so a score accumulator's two neighbouring 8-key tiles are, packed, the
// A fragment of the 16 keys they cover: no relabelling of keys.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Four 8 x 8 matrices of 16-bit values; lanes 8i..8i+7 give the row
// addresses of matrix i (16-byte aligned), which lands in r[i].
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a * b, one m16n8k16 tile of E (__half or __nv_bfloat16) operands.
template <typename E>
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  if constexpr (std::is_same_v<E, __half>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// 2^x in one MUFU op; results below 2^-126 flush to 0 (a probability
// that small is below float32's resolution of a row sum of at least 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two neighbouring probabilities (x in the low half) as packed E pieces:
// hi = E(x, y) rounded to nearest, lo = E(x - hi.x, y - hi.y) (the
// subtraction exact in float32).
template <typename E>
__device__ __forceinline__ void split_half2(float x, float y, uint32_t& hi,
                                            uint32_t& lo) {
  if constexpr (std::is_same_v<E, __half>) {
    const __half2 h = __floats2half2_rn(x, y);
    const float2 f = __half22float2(h);
    const __half2 l = __floats2half2_rn(x - f.x, y - f.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 f = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x - f.x, y - f.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// The A fragments (hi and lo pieces) of 16 keys from the score
// accumulators of their two 8-key tiles, s0 (keys 0-7) and s1 (8-15).
template <typename E>
__device__ __forceinline__ void split_a(const float* s0, const float* s1,
                                        uint32_t* hi, uint32_t* lo) {
  split_half2<E>(s0[0], s0[1], hi[0], lo[0]);
  split_half2<E>(s0[2], s0[3], hi[1], lo[1]);
  split_half2<E>(s1[0], s1[1], hi[2], lo[2]);
  split_half2<E>(s1[2], s1[3], hi[3], lo[3]);
}
