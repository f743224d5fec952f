// mock: the warp's TF32 mma through the warp's slots (exact products in
// double, one rounding to f32 a fragment element)
#pragma once
#include <stdint.h>
namespace spectral {
struct Tf32Pair { uint32_t hi, lo; };
inline Tf32Pair split_tf32(float a) {
  const uint32_t hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(__fsub_rn(a, __uint_as_float(hi))) + 0x1000u};
}
inline float mock_tf32(uint32_t v) { return __uint_as_float(v & 0xffffe000u); }
inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  MockWarp& w = mock_warp();
  const int lane = g_lane;
  for (int i = 0; i < 4; ++i) w.slot[lane][i] = a[i];
  w.slot[lane][4] = b0; w.slot[lane][5] = b1;
  w.bar.arrive_and_wait();
  const int grp = lane >> 2, t = lane & 3;
  auto A = [&](int r, int k) {   // a0 (g,t) a1 (g+8,t) a2 (g,t+4) a3 (g+8,t+4)
    return mock_tf32(w.slot[4 * (r % 8) + k % 4][(r >= 8) + 2 * (k >= 4)]);
  };
  auto B = [&](int k, int c) { return mock_tf32(w.slot[4 * c + k % 4][4 + (k >= 4)]); };
  for (int e = 0; e < 4; ++e) {
    const int r = grp + (e >> 1) * 8, c = 2 * t + (e & 1);
    double s = d[e];
    for (int k = 0; k < 8; ++k) s += (double)A(r, k) * (double)B(k, c);
    d[e] = (float)s;
  }
  w.bar.arrive_and_wait();
}
}  // namespace spectral
