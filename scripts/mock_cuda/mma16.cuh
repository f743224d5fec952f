// mock: the 16-bit forms' mma through the warp's slots
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
namespace spectral {
enum Operand { kTf32x3 = 0, kBf16 = 1, kF16 = 2 };
template <int kOp>
inline uint32_t pack16(float lo, float hi) {
  if constexpr (kOp == kBf16) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    uint32_t r; memcpy(&r, &v, 4); return r;
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    uint32_t r; memcpy(&r, &v, 4); return r;
  }
}
inline uint32_t neg16(uint32_t v) { return v ^ 0x80008000u; }
template <int kOp> inline float mock_dec16(uint16_t h) {
  if constexpr (kOp == kBf16) return __uint_as_float((uint32_t)h << 16);
  else { _Float16 f; memcpy(&f, &h, 2); return (float)f; }
}
template <int kOp>
inline void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  MockWarp& w = mock_warp();
  const int lane = g_lane;
  for (int i = 0; i < 4; ++i) w.slot[lane][i] = a[i];
  w.slot[lane][4] = b0; w.slot[lane][5] = b1;
  w.bar.arrive_and_wait();
  const int grp = lane >> 2, t = lane & 3;
  auto half = [&](uint32_t v, int hi) { return mock_dec16<kOp>((uint16_t)(hi ? v >> 16 : v & 0xffffu)); };
  // a0 (g, 2t..2t+1) a1 (g+8, ..) a2 (g, 2t+8..) a3 (g+8, 2t+8..)
  auto A = [&](int r, int k) {
    const int kk = k % 8;
    return half(w.slot[4 * (r % 8) + kk / 2][(r >= 8) + 2 * (k >= 8)], kk & 1);
  };
  auto B = [&](int k, int c) {
    const int kk = k % 8;
    return half(w.slot[4 * c + kk / 2][4 + (k >= 8)], kk & 1);
  };
  for (int e = 0; e < 4; ++e) {
    const int r = grp + (e >> 1) * 8, c = 2 * t + (e & 1);
    double s = d[e];
    for (int k = 0; k < 16; ++k) s += (double)A(r, k) * (double)B(k, c);
    d[e] = (float)s;
  }
  w.bar.arrive_and_wait();
}
}  // namespace spectral
