// The 16-bit tensor-core primitives of the four-step stage
// (spectral_common.cuh, stage16): the rounding of two f32 operands to
// bf16 or f16 and their packing into one 32-bit fragment register, and one
// mma.sync.m16n8k16 product with f32 accumulation (sm_80 and later; sm_90a
// here).
//
// Each operand is rounded once, to nearest even (__floats2bfloat162_rn,
// __floats2half2_rn), where the plain version (fft4step._cast) rounds it;
// the product of two 16-bit operands is exact in f32, so a stage differs
// from its plain version only in the order of the f32 accumulation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace spectral {

// The stage's operand type: f32 as three TF32 passes (tf32_mma.cuh), or
// one pass of bf16 or f16 operands (bs16 is f16 behind the codec).
enum Operand { kTf32x3 = 0, kBf16 = 1, kF16 = 2 };

// Two operands rounded to the stage's 16-bit type, `lo` in the low half
// (the element of the lower row or column index of a fragment register).
template <int kOp>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  static_assert(kOp == kBf16 || kOp == kF16, "a 16-bit operand type");
  if constexpr (kOp == kBf16) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// Both halves of a packed pair negated: an exact sign flip.
__device__ __forceinline__ uint32_t neg16(uint32_t v) {
  return v ^ 0x80008000u;
}

// d += A * B on one warp: A 16 x 16 row-major (a0..a3), B 16 x 8
// column-major (b0, b1), d 16 x 8 f32, in the PTX fragment layouts
// (lane = 4 * group + t; each register holds two elements, the lower
// index in its low half):
//   a0 (group, 2t..2t+1)      a1 (group + 8, 2t..2t+1)
//   a2 (group, 2t+8..2t+9)    a3 (group + 8, 2t+8..2t+9)
//   b0 (2t..2t+1, group)      b1 (2t+8..2t+9, group)
//   d0 (group, 2t) d1 (group, 2t + 1) d2 (group + 8, 2t) d3 (group + 8, 2t + 1)
template <int kOp>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (kOp == kBf16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

}  // namespace spectral
