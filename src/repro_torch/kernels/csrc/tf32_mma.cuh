// The two tensor-core primitives of the four-step stage (spectral_common.cuh):
// the split of an f32 operand into two TF32 halves, and one
// mma.sync.m16n8k8 TF32 product with f32 accumulation (sm_80 and later;
// sm_90a here).
//
// Error-compensated 3xTF32: a = hi + lo with hi = tf32(a) and
// lo = tf32(a - hi) (a - hi is exact in f32; tf32 rounds to nearest, ties
// away from zero), and
//   a * b ~ lo_a * hi_b + hi_a * lo_b + hi_a * hi_b,
// three TF32 products into one f32 accumulator. The dropped lo * lo term is
// below 2^-22 of a * b, so the contraction keeps f32 accuracy; one TF32 pass
// alone keeps 10 mantissa bits (~5e-4 relative), which the f32 route never
// uses.
#pragma once

#include <stdint.h>

namespace spectral {

// The split of a finite f32 operand, rounding as cvt.rna.tf32.f32 does
// (to nearest, ties away from zero) in two integer operations a half: add
// half a TF32 ulp to the magnitude bits, then drop the 13 low bits. hi is
// masked, so its f32 value is exactly the rounded value the remainder is
// taken from; lo is left unmasked, since mma reads only the 19 high bits
// of a TF32 operand. (ptxas expands cvt.rna.tf32.f32 into four
// instructions with an infinity test; the kernels' operands are finite.)
struct Tf32Pair {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32Pair split_tf32(float a) {
  const uint32_t hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(__fsub_rn(a, __uint_as_float(hi))) + 0x1000u};
}

// d += A * B on one warp: A 16 x 8 row-major (a0..a3), B 8 x 8
// column-major (b0, b1), d 16 x 8 f32, in the PTX fragment layouts
// (lane = 4 * group + t):
//   a0 (group, t)  a1 (group + 8, t)  a2 (group, t + 4)  a3 (group + 8, t + 4)
//   b0 (t, group)  b1 (t + 4, group)
//   d0 (group, 2t) d1 (group, 2t + 1) d2 (group + 8, 2t) d3 (group + 8, 2t + 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace spectral
