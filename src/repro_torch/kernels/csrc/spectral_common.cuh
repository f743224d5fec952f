// Device code shared by the hand-written spectral kernels (spectral.cu and
// mega.cu) for Hopper (sm_90a): two FFT routes over whole lines held in
// shared memory — the four-step FFT contraction stages on the tensor cores
// (fft_impl="matmul") and the self-sorting radix-4/radix-2 Stockham passes
// (fft_impl="stockham") — the pointwise filter, the four-step order
// permutations with the inverse's 1/N, and the device-memory <->
// shared-memory pass of one per-axis op on a tile of lines. Each kernel
// is instantiated once per route (template flag kStockham), so each route
// has its own thread bound and register budget.
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
// The stages run on mma.sync.m16n8k8 TF32 in the error-compensated 3xTF32
// form (tf32_mma.cuh): each operand is split into a TF32 hi and lo in
// registers and every real product is lo*hi + hi*lo + hi*hi with f32
// accumulation, as exact as the FFMA contraction it replaced (held to a
// complex128 oracle at 1e-5 x max|want| on the card; one TF32 pass would
// miss by ~3e-4). A stage does 8 (n1 + n2) real flops a point and
// transform, issued as 3 TF32 passes: 24 (n1 + n2) tensor-core flops, over
// the H100 SXM's 495 TFLOP/s dense TF32 (spec sheet) its floor; the column
// launches and mega_staged's phases stay bound by their tile's
// device-memory I/O at one block per SM. mma.sync comes before wgmma
// because wgmma takes a TF32 B operand only K-major from shared memory
// (stage A's data is N-major there) and would need the hi/lo halves
// written back to shared memory; mma.sync takes the split fragments from
// registers. The wgmma form is later work.
//
// The Stockham route (replacing the JAX package's _fft_stockham,
// src/repro/kernels/fft4step.py:422) runs radix-4 passes while the
// remaining length divides by 4 and one radix-2 pass last when log2 N is
// odd (the reference's pass order), each reading and writing every point
// once, in place, staged through registers between two barriers. It is
// self-sorting: natural order in and out, so no permutation and no
// transposed filter index. Its twiddles come from one table built on the
// host (fft4step.stockham_table) that the plain version reads too. Per
// point and transform it does ~8.5 flops a pass (~51 at N = 4096), so its
// time goes to the passes' shared-memory traffic and barriers and to the
// tile's device-memory I/O.
//
// Numerics: every complex and twiddle product outside the tensor cores is
// written with explicit rounding intrinsics (__fmaf_rn, __fmul_rn,
// __fadd_rn, __fsub_rn), and the sources build with -fmad=false, so no
// result depends on how nvcc would contract a*b - c*d in one inlining
// context or another; the tensor-core stage runs one fixed instruction
// sequence per point. A point goes through the same operations in every
// kernel that includes this header: that is what makes the one-launch
// fused1 equal to the three-launch fused3 bit for bit on the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace spectral {

// The Stockham route's block shape (and reorder's staging): 1024 threads,
// 16 points a thread per in-place pass.
constexpr int kPerThread = 16;
constexpr int kMaxThreads = 1024;

enum FilterMode { kNone = 0, kShared = 1, kFull = 2, kOuter = 3,
                  kSharedOuter = 4 };

// DFT matrices F1 (n1 x n1), F2 (n2 x n2) and twiddles (n1 x n2) of n on
// the four-step route; the Stockham twiddle table on the Stockham route
// (stw, non-null there alone; the other pointers are unused).
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

// The matmul route's block shape: at most kMmaThreads threads; each warp
// holds one task between the two barriers of a stage, a task being kGroup
// m16n8 output tiles that share one m-tile, so that the A fragment loaded
// and split at a k-step serves kGroup products: kGroup * 4 = 16 complex
// points a thread a round (32 accumulator registers), as many rounds of
// lines as the tile needs.
constexpr int kMmaThreads = 512;
constexpr int kGroup = 4;
constexpr int kGroupCols = 8 * kGroup;   // output columns of one task

// True when a block of `threads` threads holds one whole line of an
// (nf x nq) stage in one round (the stage loops over rounds of lines).
__host__ __device__ inline bool mma_fits(int threads, int nf, int nq) {
  const int mt = (nf + 15) / 16;
  return (threads / 32) / mt >= (nq + kGroupCols - 1) / kGroupCols;
}

// Floats of the shared-memory copy of F1 and F2 (re, im; rows padded to
// n + 4 floats, so the eight row groups of an A fragment fall on distinct
// banks). F1 and F2 are one matrix when n1 == n2 (the DFT matrix of a size
// is a function of the size alone), kept once: 34 KiB at 64 x 64.
__host__ __device__ inline int dft_smem_floats(int n1, int n2) {
  return 2 * (n1 * (n1 + 4) + (n1 == n2 ? 0 : n2 * (n2 + 4)));
}

// Where a stage reads its DFT matrices: F1 (n1 x n1) and F2 (n2 x n2),
// split re/im, row strides ld1 and ld2 (shared or global memory).
struct Mats {
  const float* f1r;
  const float* f1i;
  const float* f2r;
  const float* f2i;
  int ld1, ld2;
};

// The DFT matrices read in place from device memory (mega_resident).
__device__ __forceinline__ Mats mats_in_place(const Dft& d) {
  return Mats{d.f1r, d.f1i, d.f2r, d.f2i, d.n1, d.n2};
}

// Copy F1 and F2 into shared memory at dst (dft_smem_floats floats, padded
// rows; one copy when n1 == n2). No barrier: the caller's next
// __syncthreads orders it.
__device__ __forceinline__ Mats mats_to_shared(float* dst, const Dft& d) {
  const int ld1 = d.n1 + 4, ld2 = d.n2 + 4;
  float* f1r = dst;
  float* f1i = f1r + d.n1 * ld1;
  for (int i = threadIdx.x; i < d.n1 * d.n1; i += blockDim.x) {
    const int r = i / d.n1, c = i - r * d.n1;
    f1r[r * ld1 + c] = __ldg(d.f1r + i);
    f1i[r * ld1 + c] = __ldg(d.f1i + i);
  }
  if (d.n1 == d.n2) return Mats{f1r, f1i, f1r, f1i, ld1, ld1};
  float* f2r = f1i + d.n1 * ld1;
  float* f2i = f2r + d.n2 * ld2;
  for (int i = threadIdx.x; i < d.n2 * d.n2; i += blockDim.x) {
    const int r = i / d.n2, c = i - r * d.n2;
    f2r[r * ld2 + c] = __ldg(d.f2r + i);
    f2i[r * ld2 + c] = __ldg(d.f2i + i);
  }
  return Mats{f1r, f1i, f2r, f2i, ld1, ld2};
}

// Where one stage reads and writes: X[k, q] is point k * sk + q * sq of a
// line, Y[m, q] goes to point m * om + q * oq, and its twiddle (when the
// stage has one) is tw[m * twm + q * twq].
struct StageMap {
  int nf, nq;          // F is nf x nf; q < nq
  int sk, sq, om, oq, twm, twq;
};

// One in-place contraction stage over every line, on the tensor cores:
//   Y[m, q] = sum_k F[m, k] X[k, q]    (m, k < nf; q < nq)
// then times tw when the stage has one; conj_in conjugates the inputs. F
// (row stride fld) is a DFT matrix, so it is symmetric and both four-step
// stages take this form (transform() below gives the maps):
//   A: a[hi, lo] = tw * sum_j F1[hi, j] x[j * n2 + lo]
//   B: z[hi, lo] = sum_j a[hi, j] F2[j, lo]   (F2 times the transposed row
//                                              group: the data is always
//                                              the B operand)
// The columns q of all lines are numbered as one axis, col = line * nq + q,
// so a factor below 8 still fills whole n8 tiles.
//
// A warp task is one 16-row m-tile of F times kGroup n8 tiles of columns.
// Each k-step loads the A fragment of F and the B fragments of the data,
// splits each operand into TF32 hi and lo in registers (tf32_mma.cuh),
// and issues 12 mma.sync per tile: 4 real products (Fr Xr, Fi (-Xi), Fr Xi,
// Fi Xr; -Xi an exact sign flip) x 3 passes (lo hi, hi lo, hi hi) into
// the f32 accumulators of Re Y and Im Y. kMasked: rows and k past nf and
// columns past the round's end are zero in the fragments (factors 1, 2,
// 4, 8 pad to the m16 / k8 shape); the unmasked form, for nf >= 16 and
// nq >= 32, has no such test in its loop. The outputs wait in the
// accumulators until every warp has read, one barrier, the write-back
// (twiddle with the rounded cmul), a second barrier: in place, as many
// lines a round as the block's warps hold.
//
// Every point goes through the same fragment arithmetic and k order in
// every caller and at every tile position, so its value does not depend
// on the kernel, the warp or the tiling.
template <bool kLineFast, bool kMasked>
__device__ __forceinline__ void stage(const Lines& L, const StageMap& g,
                                      const float* fr, const float* fi,
                                      int fld, const float* __restrict__ twr,
                                      const float* __restrict__ twi,
                                      bool conj_in) {
  const int nf = g.nf, nq = g.nq;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int grp = lane >> 2, tq = lane & 3;
  const int lstr = kLineFast ? 1 : L.ls;   // line stride in s
  const int pstr = kLineFast ? L.es : 1;   // point stride in s
  const int kstr = g.sk * pstr;
  const int lq = __ffs(nq) - 1;            // nq = 2^lq
  const int mt = (nf + 15) >> 4;
  const int chunk = max(1, ((nwarps / mt) * kGroupCols) >> lq);
  float2* __restrict__ xs = L.s;
  const float2 zero = make_float2(0.0f, 0.0f);
  for (int c0 = 0; c0 < L.lines; c0 += chunk) {
    const int cols = min(chunk, L.lines - c0) << lq;
    const int tasks = mt * ((cols + kGroupCols - 1) / kGroupCols);
    const bool busy = warp < tasks;          // task `warp`; warp-uniform
    float acc[kGroup][2][4];
    if (busy) {
      const int m0 = (warp % mt) * 16;
      const int col0 = (warp / mt) * kGroupCols;
      // this lane's fragment offsets at k = 0: F rows r0, r1 at column
      // tq; the data of its column of each n8 tile at row tq
      const int r0 = m0 + grp, r1 = r0 + 8;
      const bool rv0 = !kMasked || r0 < nf, rv1 = !kMasked || r1 < nf;
      const int fo0 = (rv0 ? r0 : 0) * fld + tq;
      const int fo1 = (rv1 ? r1 : 0) * fld + tq;
      int xo[kGroup];
      bool xv[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int col = col0 + 8 * j + grp;
        xv[j] = !kMasked || col < cols;
        xo[j] = xv[j] ? (c0 + (col >> lq)) * lstr
                            + (col & (nq - 1)) * g.sq * pstr + tq * kstr
                      : 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][h][e] = 0.0f;
        }
      }
      for (int k0 = 0; k0 < nf; k0 += 8) {
        const bool kav = !kMasked || k0 + tq < nf;
        const bool kbv = !kMasked || k0 + tq + 4 < nf;
        // A: a0 (r0, ka) a1 (r1, ka) a2 (r0, kb) a3 (r1, kb)
        const int fidx[4] = {fo0 + k0, fo1 + k0, fo0 + k0 + 4, fo1 + k0 + 4};
        const bool fok[4] = {rv0 && kav, rv1 && kav, rv0 && kbv, rv1 && kbv};
        uint32_t frh[4], frl[4], fih[4], fil[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const Tf32Pair pr = split_tf32(fok[i] ? fr[fidx[i]] : 0.0f);
          const Tf32Pair pi = split_tf32(fok[i] ? fi[fidx[i]] : 0.0f);
          frh[i] = pr.hi; frl[i] = pr.lo;
          fih[i] = pi.hi; fil[i] = pi.lo;
        }
        const int xk = k0 * kstr;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (kMasked && col0 + 8 * j >= cols) continue;   // warp-uniform
          float2 x0 = xv[j] && kav ? xs[xo[j] + xk] : zero;
          float2 x1 = xv[j] && kbv ? xs[xo[j] + xk + 4 * kstr] : zero;
          if (conj_in) { x0.y = -x0.y; x1.y = -x1.y; }   // exact
          const Tf32Pair r0s = split_tf32(x0.x), r1s = split_tf32(x1.x);
          const Tf32Pair i0s = split_tf32(x0.y), i1s = split_tf32(x1.y);
          // -Xi for the Fi Xi term of Re Y: an exact sign flip
          const uint32_t n0h = i0s.hi ^ 0x80000000u, n1h = i1s.hi ^ 0x80000000u;
          const uint32_t n0l = i0s.lo ^ 0x80000000u, n1l = i1s.lo ^ 0x80000000u;
          float (&yr)[4] = acc[j][0];
          float (&yi)[4] = acc[j][1];
          mma_tf32(yr, frl, r0s.hi, r1s.hi);
          mma_tf32(yi, frl, i0s.hi, i1s.hi);
          mma_tf32(yr, frh, r0s.lo, r1s.lo);
          mma_tf32(yi, frh, i0s.lo, i1s.lo);
          mma_tf32(yr, frh, r0s.hi, r1s.hi);
          mma_tf32(yi, frh, i0s.hi, i1s.hi);
          mma_tf32(yr, fil, n0h, n1h);
          mma_tf32(yi, fil, r0s.hi, r1s.hi);
          mma_tf32(yr, fih, n0l, n1l);
          mma_tf32(yi, fih, r0s.lo, r1s.lo);
          mma_tf32(yr, fih, n0h, n1h);
          mma_tf32(yi, fih, r0s.hi, r1s.hi);
        }
      }
    }
    __syncthreads();
    if (busy) {
      const int m0 = (warp % mt) * 16;
      const int col0 = (warp / mt) * kGroupCols;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {         // d0..d3 of the tile
          const int m = m0 + grp + (e >> 1) * 8;
          const int col = col0 + 8 * j + 2 * tq + (e & 1);
          if ((!kMasked || m < nf) && (!kMasked || col < cols)) {
            const int q = col & (nq - 1);
            float2 y = make_float2(acc[j][0][e], acc[j][1][e]);
            if (twr != nullptr) {
              const int w = m * g.twm + q * g.twq;
              y = cmul(y, __ldg(twr + w), __ldg(twi + w));
            }
            xs[(c0 + (col >> lq)) * lstr + (m * g.om + q * g.oq) * pstr] = y;
          }
        }
      }
    }
    __syncthreads();
  }
}

// A stage on its unmasked form where the shape allows it (the choice
// depends on the shape alone, so every caller takes the same one).
template <bool kLineFast>
__device__ __forceinline__ void run_stage(const Lines& L, const StageMap& g,
                                          const float* fr, const float* fi,
                                          int fld, const float* twr,
                                          const float* twi, bool conj_in) {
  if (g.nf >= 16 && g.nq >= kGroupCols) {
    stage<kLineFast, false>(L, g, fr, fi, fld, twr, twi, conj_in);
  } else {
    stage<kLineFast, true>(L, g, fr, fi, fld, twr, twi, conj_in);
  }
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
// from it; the Stockham route stays in natural order. kStockham is the
// route of the instantiation; the matmul route reads its DFT matrices
// through m. The forward's stage A writes a[hi, lo] to point lo * n1 + hi,
// so that stage B reads along hi (consecutive words in a fragment row
// group: 4-way instead of 8-way bank conflicts); the inverse reads the
// transposed order as it comes.
template <bool kLineFast, bool kStockham>
__device__ __forceinline__ void transform(const Lines& L, const Dft& d,
                                          const Mats& m, bool inverse) {
  const int n1 = d.n1, n2 = d.n2;
  if constexpr (kStockham) {
    stockham<kLineFast>(L, d.stw, inverse);
  } else if (!inverse) {
    //            nf  nq  sk  sq  om  oq  twm twq
    run_stage<kLineFast>(L, StageMap{n1, n2, n2, 1, 1, n1, n2, 1}, m.f1r,
                         m.f1i, m.ld1, d.twr, d.twi, false);
    run_stage<kLineFast>(L, StageMap{n2, n1, n1, 1, 1, n2, 0, 0}, m.f2r,
                         m.f2i, m.ld2, nullptr, nullptr, false);
  } else {
    run_stage<kLineFast>(L, StageMap{n2, n1, 1, n2, 1, n2, 1, n2}, m.f2r,
                         m.f2i, m.ld2, d.twr, d.twi, true);
    run_stage<kLineFast>(L, StageMap{n1, n2, n2, 1, n2, 1, 0, 0}, m.f1r,
                         m.f1i, m.ld1, nullptr, nullptr, false);
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
// the order an inverse-only segment reads). Staged through registers, in
// rounds of whole lines of at most kPerThread points a thread (the host
// keeps n <= kPerThread * blockDim.x).
template <bool kLineFast>
__device__ __forceinline__ void reorder(const Lines& L, int order, int n1,
                                        int n2, float scale, float iscale) {
  const int chunk = max(1, kPerThread * (int)blockDim.x / L.n);
  for (int c0 = 0; c0 < L.lines; c0 += chunk) {
    const int cl = min(chunk, L.lines - c0);
    const int total = cl * L.n;
    float2 stash[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int o = threadIdx.x + i * blockDim.x;
      if (o < total) {
        int c, q;
        split_items<kLineFast>(cl, L.n, o, c, q);
        const int src = order == kToNatural ? to_transposed(q, n1, n2)
                        : order == kToTransposed ? from_transposed(q, n1, n2)
                        : q;
        const float2 v = *at<kLineFast>(L, c0 + c, src);
        stash[i] = make_float2(__fmul_rn(v.x, scale), __fmul_rn(v.y, iscale));
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int o = threadIdx.x + i * blockDim.x;
      if (o < total) {
        int c, q;
        split_items<kLineFast>(cl, L.n, o, c, q);
        *at<kLineFast>(L, c0 + c, q) = stash[i];
      }
    }
    __syncthreads();
  }
}

// The inverse's store scale: 1/N on the real part, -1/N on the imaginary
// part (the closing conjugate of conj-FFT-conj); 1 without an inverse.
__device__ __forceinline__ float inverse_scale(bool inv, int n) {
  return inv ? __fdiv_rn(1.0f, (float)n) : 1.0f;
}

// Both routes move 4 points a thread in one 16-byte access of re and one
// of im where the layout allows (the one-point loop issues 4-byte ones):
// rows 4 points along the line (n % 4 == 0, no permutation on that side),
// columns 4 adjacent lines of a full tile (C and lines multiples of 4),
// walked in shared-memory order so that a permutation costs nothing. A
// move is exact either way, so the choice depends on the layout only.
__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The tile's load (store = false) or store in 16-byte accesses: rows 4
// points of a line, columns point j of 4 adjacent lines.
__device__ __forceinline__ void move_vec4(bool store, float2* s,
                                          const float* xr, const float* xi,
                                          float* yr, float* yi,
                                          long long scene, int lines,
                                          int line0, int C, int n, int valid,
                                          int axis, bool perm, int n1,
                                          int n2, float scale, float iscale) {
  const int per = axis == 1 ? n / 4 : C / 4;   // accesses a line / a point
  const int step = axis == 1 ? 1 : n;          // s distance of the 4
  for (int idx = threadIdx.x; idx < C * n / 4; idx += blockDim.x) {
    int c, p, j;
    long long g;
    if (axis == 1) {
      c = idx / per;
      j = p = (idx - c * per) * 4;
      g = scene + (long long)(line0 + c) * n + j;
    } else {
      p = idx / per;
      c = (idx - p * per) * 4;
      j = perm ? from_transposed(p, n1, n2) : p;
      g = scene + (long long)j * lines + line0 + c;
    }
    float2* o = s + c * n + p;
    if (store) {
      if (c >= valid) continue;
      const float2 v0 = o[0], v1 = o[step], v2 = o[2 * step],
                   v3 = o[3 * step];
      *reinterpret_cast<float4*>(yr + g) =
          make_float4(__fmul_rn(v0.x, scale), __fmul_rn(v1.x, scale),
                      __fmul_rn(v2.x, scale), __fmul_rn(v3.x, scale));
      *reinterpret_cast<float4*>(yi + g) =
          make_float4(__fmul_rn(v0.y, iscale), __fmul_rn(v1.y, iscale),
                      __fmul_rn(v2.y, iscale), __fmul_rn(v3.y, iscale));
    } else {
      float4 vr = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vi = vr;
      if (c < valid) {
        vr = __ldcg(reinterpret_cast<const float4*>(xr + g));
        vi = __ldcg(reinterpret_cast<const float4*>(xi + g));
      }
      o[0] = make_float2(vr.x, vi.x);
      o[step] = make_float2(vr.y, vi.y);
      o[2 * step] = make_float2(vr.z, vi.z);
      o[3 * step] = make_float2(vr.w, vi.w);
    }
  }
}

// One per-axis op [FFT] -> filter -> [IFFT] on a tile of C whole lines,
// lines [line0, line0 + C) of the `lines` lines of one scene that starts at
// element `scene`: read from (xr, xi), held in shared memory s as C lines
// of n points (s[c * n + p]), written to (yr, yi). Rows (axis 1): point j of
// line l at scene + l * n + j; cols (axis 0): at scene + j * lines + l.
// Lines past the scene's end are zero-filled and never stored. The input
// is read through __ldcg (L2, coherent across blocks), never a read-only
// path: in mega_staged it was written by other blocks before the last
// grid barrier, and may be the same buffer as the output. On the matmul
// route m holds the DFT matrices (in shared memory past the tile).
template <bool kStockham>
__device__ __forceinline__ void tile_op(float2* s, const float* xr,
                                        const float* xi, float* yr, float* yi,
                                        long long scene, int lines, int line0,
                                        int C, int axis, bool fwd, bool inv,
                                        const Dft& d, const Mats& m,
                                        const Filter& f) {
  const int n = d.n, n1 = d.n1, n2 = d.n2;
  const int total = C * n;
  const int T = blockDim.x;
  const int valid = min(C, lines - line0);
  const bool four_step = !kStockham;         // Stockham: natural order
  const bool perm_in = four_step && !fwd && inv;    // load into the
  const bool perm_out = four_step && fwd && !inv;   // transposed order / out
  const bool vec =                           // 16-byte accesses
      (axis == 1 ? n % 4 == 0
                 : C % 4 == 0 && lines % 4 == 0 && valid == C) &&
      aligned16(xr + scene) && aligned16(xi + scene) &&
      aligned16(yr + scene) && aligned16(yi + scene);
  const float scale = inverse_scale(inv, n);
  const float iscale = inv ? -scale : 1.0f;

  if (vec && !(axis == 1 && perm_in)) {
    move_vec4(false, s, xr, xi, yr, yi, scene, lines, line0, C, n, valid,
              axis, perm_in, n1, n2, scale, iscale);
  } else {
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
  }
  __syncthreads();

  const Lines L{s, C, n, n, 1};
  if (fwd) transform<false, kStockham>(L, d, m, false);
  if (f.mode != kNone) {
    filter_pass<false>(L, f, line0, valid, four_step && (fwd || inv), n1,
                       n2);
  }
  if (inv) transform<false, kStockham>(L, d, m, true);

  if (vec && !(axis == 1 && perm_out)) {
    move_vec4(true, s, xr, xi, yr, yi, scene, lines, line0, C, n, valid,
              axis, perm_out, n1, n2, scale, iscale);
  } else {
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
}

}  // namespace spectral
