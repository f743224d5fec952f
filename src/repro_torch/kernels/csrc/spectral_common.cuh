// Device code shared by the hand-written spectral kernels (spectral.cu and
// mega.cu) for Hopper (sm_90a): two FFT routes over whole lines held in
// shared memory — the four-step FFT contraction stages (fft_impl="matmul")
// and the self-sorting radix-4/radix-2 Stockham passes
// (fft_impl="stockham") — the pointwise filter, the four-step order
// permutations with the inverse's 1/N, and the device-memory <->
// shared-memory pass of one per-axis op on a tile of lines.
//
// Lines in shared memory are complex, interleaved (float2). A set of
// `lines` lines of n points keeps point p of line c at s[c * ls + p * es],
// so one stage contracts along either axis of a scene slab: rows of an
// (na, nr) slab are (ls, es) = (nr, 1), its columns (1, nr).
//
// N = n1 * n2. The forward transform runs two in-place stages,
//   A: a[k1, r]  = tw[k1, r] * sum_j1 F1[k1, j1] x[j1 * n2 + r]
//   B: z[k1, k2] = sum_r a[k1, r] F2[r, k2]
// and leaves the spectrum in the transposed order
// s[k1 * n2 + k2] = X[k2 * n1 + k1]. The inverse (conj-FFT-conj) runs the
// swapped factorization on that order and ends in natural order, so
// fwd+inv permutes nothing; fwd-only permutes back to natural order at its
// end, inv-only into the transposed order at its start.
//
// The Stockham route (replacing the JAX package's _fft_stockham,
// src/repro/kernels/fft4step.py:422) runs radix-4 passes while the
// remaining length divides by 4 and one radix-2 pass last when log2 N is
// odd (the reference's pass order), each reading and writing every point
// once, in place, staged through registers between two barriers as the
// four-step stages are. It is self-sorting: natural order in and out, so
// no permutation and no transposed filter index. Its twiddles come from
// one table built on the host (fft4step.stockham_table) that the plain
// version reads too. Per
// point and transform it does ~8.5 flops a pass (~51 at N = 4096) against
// the four-step's 8 (n1 + n2) = 1024, so on Hopper, which has no float32
// tensor-core product, its time goes to the passes' shared-memory traffic
// and barriers and to the tile's device-memory I/O, not to FFMA issue.
//
// Numerics: every complex and twiddle product is written with explicit
// rounding intrinsics (__fmaf_rn, __fmul_rn, __fadd_rn, __fsub_rn), and the
// sources build with -fmad=false, so no result depends on how nvcc would
// contract a*b - c*d in one inlining context or another. A point goes
// through the same float operations in every kernel that includes this
// header: that is what makes the one-launch fused1 equal to the
// three-launch fused3 bit for bit on the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace spectral {

constexpr int kPerThread = 16;   // points each thread stages per in-place pass
constexpr int kMaxThreads = 1024;

enum FilterMode { kNone = 0, kShared = 1, kFull = 2, kOuter = 3,
                  kSharedOuter = 4 };

// DFT matrices F1 (n1 x n1), F2 (n2 x n2) and twiddles (n1 x n2) of n on
// the four-step route; the Stockham twiddle table on the Stockham route
// (stw != nullptr selects it, and the other pointers are unused).
struct Dft {
  const float* f1r;
  const float* f1i;
  const float* f2r;
  const float* f2i;
  const float* twr;
  const float* twi;
  const float2* stw;
  int n, n1, n2;
};

// One composed filter. Element (line, k) of the explicit filter is at
// h[line * h_line + k * h_k] (a shared vector has h_line = 0); the rank-K
// phase is sum_q u[line * u_line + q * u_k] * v[k * v_n + q * v_k].
struct Filter {
  const float* hr;
  const float* hi;
  const float* u;
  const float* v;
  long long h_line, h_k, u_line, u_k, v_n, v_k;
  int mode, rank;
};

struct Lines {
  float2* s;
  int lines, n, ls, es;
};

// Two layouts, one template flag each pass takes:
//   !kLineFast: points of a line are adjacent words (es = 1), and output o
//               of a pass is (line c, point p) = (o / n, o % n);
//   kLineFast:  lines are adjacent words (ls = 1), and o is
//               (o % lines, o / lines), neighbouring threads on
//               neighbouring lines.
// The mapping decides which thread computes a point, never its value; the
// unit stride stays a compile-time constant in the inner loops.
// Output o of a pass over `lines` lines of `per_line` items each.
template <bool kLineFast>
__device__ __forceinline__ void split_items(int lines, int per_line, int o,
                                            int& c, int& p) {
  if (kLineFast) {
    c = o % lines;
    p = o / lines;
  } else {
    c = o / per_line;
    p = o - c * per_line;
  }
}

template <bool kLineFast>
__device__ __forceinline__ void split(const Lines& L, int o, int& c, int& p) {
  split_items<kLineFast>(L.lines, L.n, o, c, p);
}

template <bool kLineFast>
__device__ __forceinline__ float2* at(const Lines& L, int c, int p) {
  return kLineFast ? L.s + c + p * L.es : L.s + c * L.ls + p;
}

__device__ __forceinline__ float2 cmul(float2 a, float br, float bi) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, br), __fmul_rn(a.y, bi)),
                     __fadd_rn(__fmul_rn(a.x, bi), __fmul_rn(a.y, br)));
}

// natural index j -> its position in the transposed order
__device__ __forceinline__ int to_transposed(int j, int n1, int n2) {
  return (j % n1) * n2 + j / n1;
}

// position p of the transposed order -> the natural index it holds
__device__ __forceinline__ int from_transposed(int p, int n1, int n2) {
  return (p % n2) * n1 + p / n2;
}

// One in-place contraction stage over every line. Output (c, rem) with
// rem = hi * n2 + lo overwrites point rem of line c:
//   kColumn: out[hi, lo] = sum_j M[hi, j] * x[j * n2 + lo]   (M is n1 x n1)
//   !kColumn: out[hi, lo] = sum_j x[hi * n2 + j] * M[j, lo]  (M is n2 x n2)
// then times tw[rem] when tw is given; conj_in conjugates the inputs.
// Each stage reads only its own line's column or row group, so each thread
// stages its outputs in registers between two barriers.
template <bool kColumn, bool kLineFast>
__device__ __forceinline__ void stage(const Lines& L, int n1, int n2,
                                      const float* __restrict__ mr,
                                      const float* __restrict__ mi,
                                      const float* __restrict__ twr,
                                      const float* __restrict__ twi,
                                      bool conj_in) {
  float2 stash[kPerThread];
  const int total = L.lines * L.n;
  const int es = kLineFast ? L.es : 1;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int o = threadIdx.x + i * blockDim.x;
    if (o < total) {
      int c, rem;
      split<kLineFast>(L, o, c, rem);
      const int hi = rem / n2;
      const int lo = rem - hi * n2;
      const float2* line = at<kLineFast>(L, c, 0);
      float ar = 0.0f, ai = 0.0f;
      if (kColumn) {
        const float* fr = mr + hi * n1;
        const float* fi = mi + hi * n1;
#pragma unroll 4
        for (int j = 0; j < n1; ++j) {
          const float2 x = line[(j * n2 + lo) * es];
          const float xi = conj_in ? -x.y : x.y;   // exact
          const float a = __ldg(fr + j), b = __ldg(fi + j);
          ar = __fmaf_rn(a, x.x, ar);
          ar = __fmaf_rn(-b, xi, ar);
          ai = __fmaf_rn(a, xi, ai);
          ai = __fmaf_rn(b, x.x, ai);
        }
      } else {
        const float2* row = line + hi * n2 * es;
#pragma unroll 4
        for (int j = 0; j < n2; ++j) {
          const float2 x = row[j * es];
          const float xi = conj_in ? -x.y : x.y;
          const float a = __ldg(mr + j * n2 + lo), b = __ldg(mi + j * n2 + lo);
          ar = __fmaf_rn(a, x.x, ar);
          ar = __fmaf_rn(-b, xi, ar);
          ai = __fmaf_rn(a, xi, ai);
          ai = __fmaf_rn(b, x.x, ai);
        }
      }
      float2 y = make_float2(ar, ai);
      if (twr != nullptr) y = cmul(y, __ldg(twr + rem), __ldg(twi + rem));
      stash[i] = y;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int o = threadIdx.x + i * blockDim.x;
    if (o < total) {
      int c, rem;
      split<kLineFast>(L, o, c, rem);
      *at<kLineFast>(L, c, rem) = stash[i];
    }
  }
  __syncthreads();
}

// One radix-R pass of the Stockham FFT on every line, in place, pass for
// pass the JAX package's _fft_stockham. With s = 2^log_s points already
// combined (s = 1 at the first pass), butterfly b = k * s + q of a line
// (b < n / R) reads x_r = y[r * (n / R) + b] (r < R) and writes
// y[(k * R + r) * s + q] = t_r, with twiddles w of index k:
//   radix 4: t0 = (a + c) + (b + d)          t2 = ((a + c) - (b + d)) w2
//            t1 = ((a - c) - i (b - d)) w1   t3 = ((a - c) + i (b - d)) w3
//   radix 2: t0 = a + b,  t1 = (a - b) w1
// conj_in conjugates the inputs (the first pass of an inverse). Each
// thread stages its butterflies' outputs in registers between two barriers.
template <bool kLineFast, int kRadix>
__device__ __forceinline__ void stockham_pass(const Lines& L, int log_s,
                                              const float2* __restrict__ tw,
                                              bool conj_in) {
  constexpr int kBfly = kPerThread / kRadix;   // butterflies a thread
  float2 stash[kPerThread];
  const int span = L.n / kRadix;               // butterflies a line
  const int total = L.lines * span;
#pragma unroll
  for (int i = 0; i < kBfly; ++i) {
    const int o = threadIdx.x + i * blockDim.x;
    if (o < total) {
      int c, b;
      split_items<kLineFast>(L.lines, span, o, c, b);
      const int k = b >> log_s;
      float2 v[kRadix];
#pragma unroll
      for (int r = 0; r < kRadix; ++r) {
        v[r] = *at<kLineFast>(L, c, r * span + b);
        if (conj_in) v[r].y = -v[r].y;   // exact
      }
      float2* out = stash + i * kRadix;
      if constexpr (kRadix == 4) {
        const float2 w1 = __ldg(tw + 3 * k);
        const float2 w2 = __ldg(tw + 3 * k + 1);
        const float2 w3 = __ldg(tw + 3 * k + 2);
        const float2 apc = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
        const float2 amc = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
        const float2 bpd = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
        const float2 bmd = make_float2(v[1].x - v[3].x, v[1].y - v[3].y);
        out[0] = make_float2(apc.x + bpd.x, apc.y + bpd.y);
        out[1] = cmul(make_float2(amc.x + bmd.y, amc.y - bmd.x), w1.x, w1.y);
        out[2] = cmul(make_float2(apc.x - bpd.x, apc.y - bpd.y), w2.x, w2.y);
        out[3] = cmul(make_float2(amc.x - bmd.y, amc.y + bmd.x), w3.x, w3.y);
      } else {
        const float2 w1 = __ldg(tw + k);
        out[0] = make_float2(v[0].x + v[1].x, v[0].y + v[1].y);
        out[1] = cmul(make_float2(v[0].x - v[1].x, v[0].y - v[1].y), w1.x,
                      w1.y);
      }
    }
  }
  __syncthreads();
  const int s_mask = (1 << log_s) - 1;
#pragma unroll
  for (int i = 0; i < kBfly; ++i) {
    const int o = threadIdx.x + i * blockDim.x;
    if (o < total) {
      int c, b;
      split_items<kLineFast>(L.lines, span, o, c, b);
      const int k = b >> log_s;
      const int base = ((k * kRadix) << log_s) + (b & s_mask);
#pragma unroll
      for (int r = 0; r < kRadix; ++r) {
        *at<kLineFast>(L, c, base + (r << log_s)) = stash[i * kRadix + r];
      }
    }
  }
  __syncthreads();
}

// The n-point Stockham FFT of every line (n = L.n, a power of two >= 2),
// natural order in and out; `tw` is the table of fft4step.stockham_table
// (per pass: (w1, w2, w3) pairs for radix 4, w1 for radix 2).
template <bool kLineFast>
__device__ __forceinline__ void stockham(const Lines& L,
                                         const float2* __restrict__ tw,
                                         bool conj_in) {
  int cur = L.n, log_s = 0;
  while (cur > 1) {
    if ((cur & 3) == 0) {
      cur >>= 2;
      stockham_pass<kLineFast, 4>(L, log_s, tw, conj_in);
      tw += 3 * cur;
      log_s += 2;
    } else {
      cur >>= 1;
      stockham_pass<kLineFast, 2>(L, log_s, tw, conj_in);
      tw += cur;
      log_s += 1;
    }
    conj_in = false;
  }
}

// The transform of every line on the Dft's route: forward, or the inverse
// without its closing conjugate and 1/N (those come with the store). The
// four-step forward ends in the transposed order and its inverse starts
// from it; the Stockham route stays in natural order.
template <bool kLineFast>
__device__ __forceinline__ void transform(const Lines& L, const Dft& d,
                                          bool inverse) {
  if (d.stw != nullptr) {
    stockham<kLineFast>(L, d.stw, inverse);
  } else if (!inverse) {
    stage<true, kLineFast>(L, d.n1, d.n2, d.f1r, d.f1i, d.twr, d.twi, false);
    stage<false, kLineFast>(L, d.n1, d.n2, d.f2r, d.f2i, nullptr, nullptr,
                            false);
  } else {
    stage<false, kLineFast>(L, d.n1, d.n2, d.f2r, d.f2i, d.twr, d.twi, true);
    stage<true, kLineFast>(L, d.n1, d.n2, d.f1r, d.f1i, nullptr, nullptr,
                           false);
  }
}

// The filter at natural index k of line gl (precise sincosf: the azimuth
// and RCMC phases are not small).
__device__ __forceinline__ float2 apply_filter(float2 x, const Filter& f,
                                               long long gl, int k) {
  if (f.mode == kShared || f.mode == kFull || f.mode == kSharedOuter) {
    const long long g = gl * f.h_line + (long long)k * f.h_k;
    x = cmul(x, f.hr[g], f.hi[g]);
  }
  if (f.mode == kOuter || f.mode == kSharedOuter) {
    float ph = 0.0f;
    for (int q = 0; q < f.rank; ++q) {
      ph = __fmaf_rn(f.u[gl * f.u_line + q * f.u_k],
                     f.v[(long long)k * f.v_n + q * f.v_k], ph);
    }
    float sn, cs;
    sincosf(ph, &sn, &cs);
    x = cmul(x, cs, sn);
  }
  return x;
}

// The filter in place on lines [0, valid) (line c is line line0 + c of the
// scene); `transposed` when the lines hold the transposed order.
template <bool kLineFast>
__device__ __forceinline__ void filter_pass(const Lines& L, const Filter& f,
                                            long long line0, int valid,
                                            bool transposed, int n1, int n2) {
  const int total = L.lines * L.n;
  for (int o = threadIdx.x; o < total; o += blockDim.x) {
    int c, p;
    split<kLineFast>(L, o, c, p);
    if (c >= valid) continue;
    const int k = transposed ? from_transposed(p, n1, n2) : p;
    float2* e = at<kLineFast>(L, c, p);
    *e = apply_filter(*e, f, line0 + c, k);
  }
  __syncthreads();
}

enum Order { kKeep = 0, kToNatural = 1, kToTransposed = 2 };

// In place, per line: out[q] = in[src(q)] * (scale, iscale), with src the
// identity (kKeep), to_transposed (kToNatural: a forward-only spectrum back
// to natural order) or from_transposed (kToTransposed: natural data into
// the order an inverse-only segment reads). Staged through registers.
template <bool kLineFast>
__device__ __forceinline__ void reorder(const Lines& L, int order, int n1,
                                        int n2, float scale, float iscale) {
  float2 stash[kPerThread];
  const int total = L.lines * L.n;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int o = threadIdx.x + i * blockDim.x;
    if (o < total) {
      int c, q;
      split<kLineFast>(L, o, c, q);
      const int src = order == kToNatural ? to_transposed(q, n1, n2)
                      : order == kToTransposed ? from_transposed(q, n1, n2)
                      : q;
      const float2 v = *at<kLineFast>(L, c, src);
      stash[i] = make_float2(__fmul_rn(v.x, scale), __fmul_rn(v.y, iscale));
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int o = threadIdx.x + i * blockDim.x;
    if (o < total) {
      int c, q;
      split<kLineFast>(L, o, c, q);
      *at<kLineFast>(L, c, q) = stash[i];
    }
  }
  __syncthreads();
}

// The inverse's store scale: 1/N on the real part, -1/N on the imaginary
// part (the closing conjugate of conj-FFT-conj); 1 without an inverse.
__device__ __forceinline__ float inverse_scale(bool inv, int n) {
  return inv ? __fdiv_rn(1.0f, (float)n) : 1.0f;
}

// One per-axis op [FFT] -> filter -> [IFFT] on a tile of C whole lines,
// lines [line0, line0 + C) of the `lines` lines of one scene that starts at
// element `scene`: read from (xr, xi), held in shared memory s as C lines
// of n points (s[c * n + p]), written to (yr, yi). Rows (axis 1): point j of
// line l at scene + l * n + j; cols (axis 0): at scene + j * lines + l.
// Lines past the scene's end are zero-filled and never stored. The input
// is read through __ldcg (L2, coherent across blocks), never a read-only
// path: in mega_staged it was written by other blocks before the last
// grid barrier, and may be the same buffer as the output.
__device__ __forceinline__ void tile_op(float2* s, const float* xr,
                                        const float* xi, float* yr, float* yi,
                                        long long scene, int lines, int line0,
                                        int C, int axis, bool fwd, bool inv,
                                        const Dft& d, const Filter& f) {
  const int n = d.n, n1 = d.n1, n2 = d.n2;
  const int total = C * n;
  const int T = blockDim.x;
  const int valid = min(C, lines - line0);
  const bool four_step = d.stw == nullptr;   // Stockham: natural order
  const bool perm_in = four_step && !fwd && inv;    // load into the
  const bool perm_out = four_step && fwd && !inv;   // transposed order / out

  for (int idx = threadIdx.x; idx < total; idx += T) {
    int c, j;
    if (axis == 1) { c = idx / n; j = idx - c * n; }
    else { j = idx / C; c = idx - j * C; }
    float2 val = make_float2(0.0f, 0.0f);
    if (c < valid) {
      const long long g = scene + (axis == 1
          ? (long long)(line0 + c) * n + j
          : (long long)j * lines + line0 + c);
      val = make_float2(__ldcg(xr + g), __ldcg(xi + g));
    }
    const int p = perm_in ? to_transposed(j, n1, n2) : j;
    s[c * n + p] = val;
  }
  __syncthreads();

  const Lines L{s, C, n, n, 1};
  if (fwd) transform<false>(L, d, false);
  if (f.mode != kNone) {
    filter_pass<false>(L, f, line0, valid, four_step && (fwd || inv), n1,
                       n2);
  }
  if (inv) transform<false>(L, d, true);

  const float scale = inverse_scale(inv, n);
  const float iscale = inv ? -scale : 1.0f;
  for (int idx = threadIdx.x; idx < total; idx += T) {
    int c, j;
    if (axis == 1) { c = idx / n; j = idx - c * n; }
    else { j = idx / C; c = idx - j * C; }
    if (c >= valid) continue;
    const int p = perm_out ? to_transposed(j, n1, n2) : j;
    const float2 val = s[c * n + p];
    const long long g = scene + (axis == 1
        ? (long long)(line0 + c) * n + j
        : (long long)j * lines + line0 + c);
    yr[g] = __fmul_rn(val.x, scale);
    yi[g] = __fmul_rn(val.y, iscale);
  }
}

}  // namespace spectral
