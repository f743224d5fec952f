#pragma once
#include "cuda_runtime.h"
inline uint16_t mock_bf16(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40);
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}
struct __nv_bfloat162 { uint16_t x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {mock_bf16(a), mock_bf16(b)}; }
