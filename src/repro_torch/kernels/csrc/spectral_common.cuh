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
// registers. The wgmma form is later work. The other operand forms of the
// stage — bf16 and f16 on mma.sync.m16n8k16 (one pass; bs16 is f16 behind
// the per-line exponent codec), and Karatsuba's 3 real products a complex
// contraction on each — are instantiations of their own (stage_kara,
// stage16), so the f32 form's code is the same whether they exist or not.
//
// The Stockham route (replacing the JAX package's _fft_stockham,
// src/repro/kernels/fft4step.py:422) runs its radix-4/radix-2 passes two
// at a time on registers, one shared-memory exchange a pair, the tile's
// load fused into the first pair and its store into the last, and a
// fwd+inv op turned around in registers where it can (the section "The
// Stockham route" below).
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

#include "mma16.cuh"
#include "tf32_mma.cuh"

namespace spectral {

// The Stockham route's block shape (and reorder's staging): 16 points a
// thread in registers, up to 512 threads, so that a thread may take 128
// registers (at 1024 threads and 64 the out-of-line ops spilled ~1.2-1.8
// KB each).
constexpr int kPerThread = 16;
constexpr int kStockhamThreads = 512;
// Points a thread holds where 16 a thread do not cover a block's lines:
// two groups, so that 16384 points (a 4-column tile at N = 4096, whose
// 16-byte runs need the 4 columns) fit 512 threads.
constexpr int kWidePerThread = 32;

// The one rule of a Stockham block's shape (ops.stockham_per_thread is its
// host copy): points a thread holds when `threads` threads hold `points`
// points of n-point lines at once — 16, or 32 where 16 do not cover them.
__host__ __device__ constexpr int stockham_per_thread(
    int points, int n, int threads = kStockhamThreads) {
  return points > kPerThread * threads && n >= kWidePerThread
             ? kWidePerThread
             : kPerThread;
}

// Whether the device-memory tile op (tile_op) of `per` points a thread is
// built for (axis, n): at 32 a thread only the 4-column tile at N = 4096.
__host__ __device__ constexpr bool stockham_tile_built(int axis, int n,
                                                       int per) {
  return per == kPerThread || (axis == 0 && n == 4096);
}

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

// The Stockham route keeps its lines in shared memory XOR-swizzled:
// element i (c * ls + p * es, as `at`) lives at swz(i), its low four bits
// permuted by the next four. Each step's 8-byte reads and writes then fall
// on 16 distinct bank pairs in every half-warp, on rows and columns, tiles
// and slabs alike; unswizzled, the first pair's writes (16 consecutive
// points a thread) hit one bank pair 16 times. The map stays inside each
// aligned run of 16 elements, so the launches round the shared memory up
// to a multiple of 16 points.
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 4) & 15); }

// Points of shared memory a Stockham tile or slab of `points` takes.
__host__ __device__ inline int stockham_points(int points) {
  return (points + 15) & ~15;
}

template <bool kLineFast>
__device__ __forceinline__ float2* sat(const Lines& L, int c, int p) {
  return L.s + swz(kLineFast ? c + p * L.es : c * L.ls + p);
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

// The stage's other operand forms (bf16, f16, and Karatsuba on each), one
// instantiation each, so that the f32 form above keeps its code.
//
// Karatsuba takes 3 real products a complex contraction instead of 4:
// P1 = Fr Xr, P2 = Fi Xi, P3 = (Fr + Fi)(Xr + Xi), each in accumulators of
// its own, the sums formed in f32 and then split or rounded (the inverse's
// conj_in flips Xi before its sum), and Re Y = P1 - P2,
// Im Y = (P3 - P1) - P2 at the write-back, as fft4step._cdot computes
// them: 9 mma.sync a tile and k-step on 3xTF32 (stage_kara) instead of 12,
// 3 on 16-bit operands (stage16) instead of 4.
//
// stage16 runs one pass of mma.sync.m16n8k16 on bf16 or f16 operands
// (mma16.cuh) with f32 accumulation, k-steps of 16: each operand, F and
// the data alike, rounded to nearest even once as it enters a fragment,
// where fft4step._cast rounds it; the twiddle stays an f32 cmul at the
// write-back. A product of two 16-bit operands is exact in f32, so such a
// stage differs from the plain version only in the order of f32
// accumulation.

// The write-back of one stage's accumulators (between the stage's two
// barriers), the twiddle with the rounded cmul: (Re, Im) of the
// four-product form, or Karatsuba's from (P1, P2, P3).
template <bool kLineFast, bool kMasked, bool kKara, int kAcc>
__device__ __forceinline__ void stage_write(const Lines& L, const StageMap& g,
                                            const float (&acc)[kGroup][kAcc][4],
                                            int m0, int col0, int c0,
                                            int cols,
                                            const float* __restrict__ twr,
                                            const float* __restrict__ twi) {
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;
  const int lstr = kLineFast ? 1 : L.ls;
  const int pstr = kLineFast ? L.es : 1;
  const int lq = __ffs(g.nq) - 1;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + grp + (e >> 1) * 8;
      const int col = col0 + 8 * j + 2 * tq + (e & 1);
      if ((!kMasked || m < g.nf) && (!kMasked || col < cols)) {
        const int q = col & (g.nq - 1);
        float2 y;
        if constexpr (kKara) {
          y = make_float2(__fsub_rn(acc[j][0][e], acc[j][1][e]),
                          __fsub_rn(__fsub_rn(acc[j][2][e], acc[j][0][e]),
                                    acc[j][1][e]));
        } else {
          y = make_float2(acc[j][0][e], acc[j][1][e]);
        }
        if (twr != nullptr) {
          const int w = m * g.twm + q * g.twq;
          y = cmul(y, __ldg(twr + w), __ldg(twi + w));
        }
        L.s[(c0 + (col >> lq)) * lstr + (m * g.om + q * g.oq) * pstr] = y;
      }
    }
  }
}

// Karatsuba on 3xTF32: stage()'s task shape, k-steps of 8 and splits,
// each of P1, P2, P3 as lo hi + hi lo + hi hi.
template <bool kLineFast, bool kMasked>
__device__ __forceinline__ void stage_kara(const Lines& L, const StageMap& g,
                                           const float* fr, const float* fi,
                                           int fld,
                                           const float* __restrict__ twr,
                                           const float* __restrict__ twi,
                                           bool conj_in) {
  const int nf = g.nf, nq = g.nq;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int grp = lane >> 2, tq = lane & 3;
  const int lstr = kLineFast ? 1 : L.ls;
  const int pstr = kLineFast ? L.es : 1;
  const int kstr = g.sk * pstr;
  const int lq = __ffs(nq) - 1;
  const int mt = (nf + 15) >> 4;
  const int chunk = max(1, ((nwarps / mt) * kGroupCols) >> lq);
  const float2* xs = L.s;
  const float2 zero = make_float2(0.0f, 0.0f);
  for (int c0 = 0; c0 < L.lines; c0 += chunk) {
    const int cols = min(chunk, L.lines - c0) << lq;
    const int tasks = mt * ((cols + kGroupCols - 1) / kGroupCols);
    const bool busy = warp < tasks;
    const int m0 = (warp % mt) * 16;
    const int col0 = (warp / mt) * kGroupCols;
    float acc[kGroup][3][4];
    if (busy) {
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
        for (int h = 0; h < 3; ++h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][h][e] = 0.0f;
        }
      }
      for (int k0 = 0; k0 < nf; k0 += 8) {
        const bool kav = !kMasked || k0 + tq < nf;
        const bool kbv = !kMasked || k0 + tq + 4 < nf;
        const int fidx[4] = {fo0 + k0, fo1 + k0, fo0 + k0 + 4, fo1 + k0 + 4};
        const bool fok[4] = {rv0 && kav, rv1 && kav, rv0 && kbv, rv1 && kbv};
        uint32_t frh[4], frl[4], fih[4], fil[4], fsh[4], fsl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = fok[i] ? fr[fidx[i]] : 0.0f;
          const float b = fok[i] ? fi[fidx[i]] : 0.0f;
          const Tf32Pair pr = split_tf32(a), pi = split_tf32(b);
          const Tf32Pair ps = split_tf32(__fadd_rn(a, b));
          frh[i] = pr.hi; frl[i] = pr.lo;
          fih[i] = pi.hi; fil[i] = pi.lo;
          fsh[i] = ps.hi; fsl[i] = ps.lo;
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
          const Tf32Pair s0s = split_tf32(__fadd_rn(x0.x, x0.y));
          const Tf32Pair s1s = split_tf32(__fadd_rn(x1.x, x1.y));
          float (&p1)[4] = acc[j][0];
          float (&p2)[4] = acc[j][1];
          float (&p3)[4] = acc[j][2];
          mma_tf32(p1, frl, r0s.hi, r1s.hi);
          mma_tf32(p2, fil, i0s.hi, i1s.hi);
          mma_tf32(p3, fsl, s0s.hi, s1s.hi);
          mma_tf32(p1, frh, r0s.lo, r1s.lo);
          mma_tf32(p2, fih, i0s.lo, i1s.lo);
          mma_tf32(p3, fsh, s0s.lo, s1s.lo);
          mma_tf32(p1, frh, r0s.hi, r1s.hi);
          mma_tf32(p2, fih, i0s.hi, i1s.hi);
          mma_tf32(p3, fsh, s0s.hi, s1s.hi);
        }
      }
    }
    __syncthreads();
    if (busy) {
      stage_write<kLineFast, kMasked, true>(L, g, acc, m0, col0, c0, cols,
                                            twr, twi);
    }
    __syncthreads();
  }
}

// One pass of 16-bit operands (kOp: kBf16 or kF16), four products or
// Karatsuba's three: stage()'s task shape with k-steps of 16.
template <bool kLineFast, bool kMasked, int kOp, bool kKara>
__device__ __forceinline__ void stage16(const Lines& L, const StageMap& g,
                                        const float* fr, const float* fi,
                                        int fld,
                                        const float* __restrict__ twr,
                                        const float* __restrict__ twi,
                                        bool conj_in) {
  constexpr int kAcc = kKara ? 3 : 2;
  const int nf = g.nf, nq = g.nq;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int grp = lane >> 2, tq = lane & 3;
  const int lstr = kLineFast ? 1 : L.ls;
  const int pstr = kLineFast ? L.es : 1;
  const int kstr = g.sk * pstr;
  const int lq = __ffs(nq) - 1;
  const int mt = (nf + 15) >> 4;
  const int chunk = max(1, ((nwarps / mt) * kGroupCols) >> lq);
  const float2* xs = L.s;
  const float2 zero = make_float2(0.0f, 0.0f);
  for (int c0 = 0; c0 < L.lines; c0 += chunk) {
    const int cols = min(chunk, L.lines - c0) << lq;
    const int tasks = mt * ((cols + kGroupCols - 1) / kGroupCols);
    const bool busy = warp < tasks;
    const int m0 = (warp % mt) * 16;
    const int col0 = (warp / mt) * kGroupCols;
    float acc[kGroup][kAcc][4];
    if (busy) {
      // this lane's fragment offsets at k = 0: F rows r0, r1 at columns
      // 2tq, 2tq + 1 (+ 8); the data of its column of each n8 tile at rows
      // 2tq, 2tq + 1 (+ 8)
      const int r0 = m0 + grp, r1 = r0 + 8;
      const bool rv0 = !kMasked || r0 < nf, rv1 = !kMasked || r1 < nf;
      const int fo0 = (rv0 ? r0 : 0) * fld + 2 * tq;
      const int fo1 = (rv1 ? r1 : 0) * fld + 2 * tq;
      int xo[kGroup];
      bool xv[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int col = col0 + 8 * j + grp;
        xv[j] = !kMasked || col < cols;
        xo[j] = xv[j] ? (c0 + (col >> lq)) * lstr
                            + (col & (nq - 1)) * g.sq * pstr + 2 * tq * kstr
                      : 0;
#pragma unroll
        for (int h = 0; h < kAcc; ++h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][h][e] = 0.0f;
        }
      }
      for (int k0 = 0; k0 < nf; k0 += 16) {
        // element t of the lane's pairs sits at k = k0 + 2tq + kOff(t)
        bool kv[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          kv[t] = !kMasked || k0 + 2 * tq + (t >> 1) * 8 + (t & 1) < nf;
        }
        // A: a_i at row (i & 1 ? r1 : r0), columns k0 + 2tq + 8 (i >> 1)
        // and the next
        uint32_t ar[4], ai[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool rv = (i & 1) ? rv1 : rv0;
          const int fo = ((i & 1) ? fo1 : fo0) + k0 + (i >> 1) * 8;
          const bool v0 = rv && kv[(i >> 1) * 2];
          const bool v1 = rv && kv[(i >> 1) * 2 + 1];
          const float rl = v0 ? fr[fo] : 0.0f, rh = v1 ? fr[fo + 1] : 0.0f;
          const float il = v0 ? fi[fo] : 0.0f, ih = v1 ? fi[fo + 1] : 0.0f;
          ar[i] = pack16<kOp>(rl, rh);
          ai[i] = pack16<kOp>(il, ih);
          if constexpr (kKara) {
            as[i] = pack16<kOp>(__fadd_rn(rl, il), __fadd_rn(rh, ih));
          }
        }
        const int xk = k0 * kstr;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (kMasked && col0 + 8 * j >= cols) continue;   // warp-uniform
          float2 x[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            x[t] = xv[j] && kv[t]
                       ? xs[xo[j] + xk + ((t >> 1) * 8 + (t & 1)) * kstr]
                       : zero;
            if (conj_in) x[t].y = -x[t].y;   // exact
          }
          const uint32_t br0 = pack16<kOp>(x[0].x, x[1].x);
          const uint32_t br1 = pack16<kOp>(x[2].x, x[3].x);
          const uint32_t bi0 = pack16<kOp>(x[0].y, x[1].y);
          const uint32_t bi1 = pack16<kOp>(x[2].y, x[3].y);
          if constexpr (kKara) {
            const uint32_t bs0 = pack16<kOp>(__fadd_rn(x[0].x, x[0].y),
                                             __fadd_rn(x[1].x, x[1].y));
            const uint32_t bs1 = pack16<kOp>(__fadd_rn(x[2].x, x[2].y),
                                             __fadd_rn(x[3].x, x[3].y));
            mma16<kOp>(acc[j][0], ar, br0, br1);
            mma16<kOp>(acc[j][1], ai, bi0, bi1);
            mma16<kOp>(acc[j][2], as, bs0, bs1);
          } else {
            mma16<kOp>(acc[j][0], ar, br0, br1);
            mma16<kOp>(acc[j][0], ai, neg16(bi0), neg16(bi1));
            mma16<kOp>(acc[j][1], ar, bi0, bi1);
            mma16<kOp>(acc[j][1], ai, br0, br1);
          }
        }
      }
    }
    __syncthreads();
    if (busy) {
      stage_write<kLineFast, kMasked, kKara>(L, g, acc, m0, col0, c0, cols,
                                             twr, twi);
    }
    __syncthreads();
  }
}

// The stage of one operand form (kOp, kKara).
template <bool kLineFast, bool kMasked, int kOp, bool kKara>
__device__ __forceinline__ void stage_form(const Lines& L, const StageMap& g,
                                           const float* fr, const float* fi,
                                           int fld, const float* twr,
                                           const float* twi, bool conj_in) {
  if constexpr (kOp != kTf32x3) {
    stage16<kLineFast, kMasked, kOp, kKara>(L, g, fr, fi, fld, twr, twi,
                                            conj_in);
  } else if constexpr (kKara) {
    stage_kara<kLineFast, kMasked>(L, g, fr, fi, fld, twr, twi, conj_in);
  } else {
    stage<kLineFast, kMasked>(L, g, fr, fi, fld, twr, twi, conj_in);
  }
}

// A stage on its unmasked form where the shape allows it (the choice
// depends on the shape alone, so every caller takes the same one).
template <bool kLineFast, int kOp = kTf32x3, bool kKara = false>
__device__ __forceinline__ void run_stage(const Lines& L, const StageMap& g,
                                          const float* fr, const float* fi,
                                          int fld, const float* twr,
                                          const float* twi, bool conj_in) {
  if (g.nf >= 16 && g.nq >= kGroupCols) {
    stage_form<kLineFast, false, kOp, kKara>(L, g, fr, fi, fld, twr, twi,
                                             conj_in);
  } else {
    stage_form<kLineFast, true, kOp, kKara>(L, g, fr, fi, fld, twr, twi,
                                            conj_in);
  }
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

// The forward's two stages, the split (n1, n2) on natural order, ending in
// the transposed order (conj_in: the inverse's opening conjugate).
template <bool kLineFast, int kOp, bool kKara>
__device__ __forceinline__ void stages_n1n2(const Lines& L, const Dft& d,
                                            const Mats& m, bool conj_in) {
  const int n1 = d.n1, n2 = d.n2;
  //            nf  nq  sk  sq  om  oq  twm twq
  run_stage<kLineFast, kOp, kKara>(
      L, StageMap{n1, n2, n2, 1, 1, n1, n2, 1}, m.f1r, m.f1i, m.ld1, d.twr,
      d.twi, conj_in);
  run_stage<kLineFast, kOp, kKara>(
      L, StageMap{n2, n1, n1, 1, 1, n2, 0, 0}, m.f2r, m.f2i, m.ld2,
      nullptr, nullptr, false);
}

// The swapped split (n2, n1) on the transposed order, ending in natural
// order: the inverse (its opening conjugate included).
template <bool kLineFast, int kOp, bool kKara>
__device__ __forceinline__ void stages_n2n1(const Lines& L, const Dft& d,
                                            const Mats& m) {
  const int n1 = d.n1, n2 = d.n2;
  run_stage<kLineFast, kOp, kKara>(
      L, StageMap{n2, n1, 1, n2, 1, n2, 1, n2}, m.f2r, m.f2i, m.ld2, d.twr,
      d.twi, true);
  run_stage<kLineFast, kOp, kKara>(
      L, StageMap{n1, n2, n2, 1, n2, 1, 0, 0}, m.f1r, m.f1i, m.ld1,
      nullptr, nullptr, false);
}

// The four-step transform of every line (the matmul route): forward, or
// the inverse without its closing conjugate and 1/N (those come with the
// store). The forward ends in the transposed order and its inverse starts
// from it; the DFT matrices are read through m. The forward's stage A
// writes a[hi, lo] to point lo * n1 + hi, so that stage B reads along hi
// (consecutive words in a fragment row group: 4-way instead of 8-way bank
// conflicts); the inverse reads the transposed order as it comes, which
// makes it the four-step of the swapped split (n2, n1). At f32 that
// differs from the plain version's (n1, n2) inverse (fft4step._run_fft)
// in rounding alone. A 16-bit operand form rounds its operands where the
// plain version does, so at a split of two unequal factors its inverse
// turns the lines to natural order, runs the forward's (n1, n2) stages on
// them and turns the result back (two exact permutations in shared
// memory); at n1 == n2 the two splits contract the same values. Two
// other forms measured slower on the card (PERF.md §6): permuting
// at every split, and the (n1, n2) inverse out of line. (The Stockham
// route runs stockham_op below instead.)
template <bool kLineFast, int kOp = kTf32x3, bool kKara = false>
__device__ __forceinline__ void transform(const Lines& L, const Dft& d,
                                          const Mats& m, bool inverse) {
  if constexpr (kOp != kTf32x3) {
    const bool natural = inverse && d.n1 != d.n2;
    if (natural) reorder<kLineFast>(L, kToNatural, d.n1, d.n2, 1.0f, 1.0f);
    if (!inverse || natural) {
      stages_n1n2<kLineFast, kOp, kKara>(L, d, m, inverse);
    } else {
      stages_n2n1<kLineFast, kOp, kKara>(L, d, m);
    }
    if (natural) reorder<kLineFast>(L, kToNatural, d.n1, d.n2, 1.0f, 1.0f);
  } else if (!inverse) {
    stages_n1n2<kLineFast, kOp, kKara>(L, d, m, false);
  } else {
    stages_n2n1<kLineFast, kOp, kKara>(L, d, m);
  }
}

// Karatsuba by instantiation: kKara 0 never (no Karatsuba code), 1 every
// transform, 2 as each call's `kara` says (a megakernel's segments choose
// their own; both forms compiled in).
template <bool kLineFast, int kOp, int kKara>
__device__ __forceinline__ void transform_k(const Lines& L, const Dft& d,
                                            const Mats& m, bool inverse,
                                            bool kara) {
  if constexpr (kKara == 2) {
    if (kara) {
      transform<kLineFast, kOp, true>(L, d, m, inverse);
    } else {
      transform<kLineFast, kOp, false>(L, d, m, inverse);
    }
  } else {
    transform<kLineFast, kOp, kKara == 1>(L, d, m, inverse);
  }
}

// The filter at natural index k of line gl (precise sincosf: the azimuth
// and RCMC phases are not small).
__device__ __forceinline__ bool has_h(const Filter& f) {
  return f.mode == kShared || f.mode == kFull || f.mode == kSharedOuter;
}

__device__ __forceinline__ bool has_phase(const Filter& f) {
  return f.mode == kOuter || f.mode == kSharedOuter;
}

__device__ __forceinline__ float2 apply_filter(float2 x, const Filter& f,
                                               long long gl, int k) {
  if (has_h(f)) {
    const long long g = gl * f.h_line + (long long)k * f.h_k;
    x = cmul(x, f.hr[g], f.hi[g]);
  }
  if (has_phase(f)) {
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
// kSwz: the lines are the Stockham route's (swizzled).
template <bool kLineFast, bool kSwz = false>
__device__ __forceinline__ void filter_pass(const Lines& L, const Filter& f,
                                            long long line0, int valid,
                                            bool transposed, int n1, int n2) {
  const int total = L.lines * L.n;
  for (int o = threadIdx.x; o < total; o += blockDim.x) {
    int c, p;
    split<kLineFast>(L, o, c, p);
    if (c >= valid) continue;
    const int k = transposed ? from_transposed(p, n1, n2) : p;
    float2* e = kSwz ? sat<kLineFast>(L, c, p) : at<kLineFast>(L, c, p);
    *e = apply_filter(*e, f, line0 + c, k);
  }
  __syncthreads();
}

// The inverse's store scale: 1/N on the real part, -1/N on the imaginary
// part (the closing conjugate of conj-FFT-conj); 1 without an inverse.
__device__ __forceinline__ float inverse_scale(bool inv, int n) {
  return inv ? __fdiv_rn(1.0f, (float)n) : 1.0f;
}

// ---------------------------------------------------------------------------
// The bs16 codec (replacing the JAX package's line_exponents /
// remove_exponents / apply_exponents, src/repro/kernels/fft4step.py:551-590,
// as its _spectral_kernel runs them around a transform, :617-635)
// ---------------------------------------------------------------------------
//
// One power-of-two exponent a line, e = ceil(log2(max(amax, 1e-37))) in
// [-126, 126], amax the line's largest |re| or |im| on the op's load; the
// line is scaled by 2^-e there and by 2^e at the store, after the inverse's
// (scale, iscale). Both scales are built from the exponent bits (never
// exp2f), and the ceil-log2 is read from the float's bits, as the plain
// version (fft4step.line_exponents) reads it, so kernel and plain version
// take the same exponents. On the Stockham route a power-of-two scale
// commutes with every pass exactly, so bs16 changes a result only where
// values leave the normal float range (a subnormal line comes out more
// exactly). The matmul route codes the lines of its tile or slab in shared
// memory (lines_encode, lines_decode_scaled / lines_decode) and runs its
// stages on f16 operands between them. A
// megakernel runs the codec in every segment: each segment's store folds
// its exponents back in, which is, point for point, the plain version's
// carrying them to the next segment boundary.

// The codec's exponent of a line whose largest |re| or |im| is amax (the
// floor keeps the argument a normal float, so its bits give the ceil).
__device__ __forceinline__ int line_exponent(float amax) {
  const unsigned b = __float_as_uint(fmaxf(amax, 1e-37f));
  const int e = (int)(b >> 23) - 127 + ((b & 0x7fffffu) != 0u ? 1 : 0);
  return min(126, max(-126, e));
}

// Words of shared memory the codec takes past a Stockham tile of `lines`
// lines: stockham_op's two a thread (a line's partial maxima, then 2^e for
// the store), or a filter-only tile's exponent a line.
__host__ __device__ inline int codec_words(int lines, int threads) {
  return 2 * threads > lines ? 2 * threads : lines;
}

// 2^e for an integer e in [-126, 126], exactly.
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ float point_amax(float2 v) {
  return fmaxf(fabsf(v.x), fabsf(v.y));
}

__device__ __forceinline__ float2 scale2(float2 v, float s) {
  return make_float2(__fmul_rn(v.x, s), __fmul_rn(v.y, s));
}

template <bool kLineFast, bool kSwz>
__device__ __forceinline__ float2* line_point(const Lines& L, int c, int p) {
  return kSwz ? L.s + swz(kLineFast ? c + p * L.es : c * L.ls + p)
              : at<kLineFast>(L, c, p);
}

// The codec on lines held in shared memory (a filter-only tile, the
// resident slab; kSwz: the Stockham route's swizzled lines): encode takes
// each line's exponent into ex[c] (its amax by an atomicMax on the bits,
// which order non-negative floats) and scales the line by 2^-e in place;
// decode scales it by 2^e. Whole passes over the lines, between barriers.
template <bool kLineFast, bool kSwz>
__device__ __forceinline__ void lines_encode(const Lines& L, int* ex) {
  unsigned* bits = reinterpret_cast<unsigned*>(ex);
  for (int c = threadIdx.x; c < L.lines; c += blockDim.x) bits[c] = 0u;
  __syncthreads();
  const int total = L.lines * L.n;
  for (int o = threadIdx.x; o < total; o += blockDim.x) {
    int c, p;
    split<kLineFast>(L, o, c, p);
    atomicMax(bits + c,
              __float_as_uint(point_amax(*line_point<kLineFast, kSwz>(L, c,
                                                                      p))));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < L.lines; c += blockDim.x) {
    ex[c] = line_exponent(__uint_as_float(bits[c]));
  }
  __syncthreads();
  for (int o = threadIdx.x; o < total; o += blockDim.x) {
    int c, p;
    split<kLineFast>(L, o, c, p);
    float2* e = line_point<kLineFast, kSwz>(L, c, p);
    *e = scale2(*e, pow2(-ex[c]));
  }
  __syncthreads();
}

template <bool kLineFast, bool kSwz>
__device__ __forceinline__ void lines_decode(const Lines& L, const int* ex) {
  const int total = L.lines * L.n;
  for (int o = threadIdx.x; o < total; o += blockDim.x) {
    int c, p;
    split<kLineFast>(L, o, c, p);
    float2* e = line_point<kLineFast, kSwz>(L, c, p);
    *e = scale2(*e, pow2(ex[c]));
  }
  __syncthreads();
}

// lines_decode after the inverse's (scale, iscale), in the plain version's
// order (its 1/N, then 2^e): the matmul route's tile, whose store then
// scales by 1.
__device__ __forceinline__ void lines_decode_scaled(const Lines& L,
                                                    const int* ex,
                                                    float scale,
                                                    float iscale) {
  const int total = L.lines * L.n;
  for (int o = threadIdx.x; o < total; o += blockDim.x) {
    int c, p;
    split<false>(L, o, c, p);
    float2* e = at<false>(L, c, p);
    *e = scale2(make_float2(__fmul_rn(e->x, scale), __fmul_rn(e->y, iscale)),
                pow2(ex[c]));
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The Stockham route (replacing the JAX package's _fft_stockham,
// src/repro/kernels/fft4step.py:422)
// ---------------------------------------------------------------------------
//
// Radix-4 passes while the remaining length divides by 4, one radix-2 pass
// last when log2 N is odd (the reference's pass order); self-sorting, so
// natural order in and out. A pass of radix R and stride s has butterfly
// b = k * s + q read y[r * N / R + b] and write y[(k R + r) s + q] = t_r:
//   radix 4: t0 = (a + c) + (b + d)          t2 = ((a + c) - (b + d)) w2
//            t1 = ((a - c) - i (b - d)) w1   t3 = ((a - c) + i (b - d)) w3
//   radix 2: t0 = a + b,  t1 = (a - b) w1
// with the twiddles of index k from the host's table
// (fft4step.stockham_table, which the plain version reads too).
//
// The passes run in steps of two (fft4step.stockham_pairs gives the plan
// and tests/test_torch_stockham_pairs.py runs it on the CPU): two passes
// (R1, R2) split a line into N / G independent groups of G = R1 R2
// points, so a thread holds a group in registers, runs R2 butterflies of
// the first pass and R1 of the second on them, and trips through shared
// memory once per step instead of once per pass. Group g = k' s + q reads
// points {g + m N / G} and writes {G s k' + q + s m}; the last pass is a
// step of its own when the count of passes is odd. A thread holds 16
// points (one group of a (4, 4) step, two of a (4, 2), four of a lone
// radix-4 pass, eight of a radix-2 one) or, where a block holds 32 a
// thread, twice that. At N = 4096 a transform is 3 steps.
//
// Around the steps: the first step reads its groups straight from device
// memory (__ldcg, all loads issued before the first use) and the last one
// writes straight to it, times (scale, iscale), so a tile of tile_op goes
// through shared memory only between steps. The filter is applied in
// registers to the forward's last outputs (or, inverse-only, to the loaded
// inputs) at their natural index, with apply_filter's operations; the
// outer phase's (cos, sin) goes through the thread's own points of shared
// memory, computed out of line (phase_factors). Where the forward's last
// step and the inverse's first have the same G (N = 2, 4, 8, 16, 256,
// 4096) the last step of group g wrote exactly the points the first step
// of group g reads: the thread turns around in its registers, applying
// the filter and the inverse's conjugate there, with no exchange at all.
// Rows of a multi-line tile synchronise per line (named barriers).
//
// Shape: the steps are compile-time (StockhamOp<..., kN, ...>), so the
// points stay in registers; 16 points and two passes' butterflies want
// ~100 registers, so blocks take at most 512 threads (128 registers), and
// the lengths a kernel takes run out of line, one function each
// (stockham_n), except where a megakernel is specialised on the main
// path's N and inlines its ops (PERF.md measures both).
//
// Per point and transform ~8.5 flops a pass (~51 at N = 4096), so what
// bounds it is the tile's device-memory I/O, the outer phase's sincosf
// and the exchanges. Each thread computes every point with the float
// operations of the plain version, so the kernels equal it bit for bit.

// One step of an n-point transform, fixed at compile time: the step that
// starts at remaining length kCur (stride s = 2^kLogS) with its first
// pass's twiddles at kTw in the table; r2 = 1 for a lone pass.
template <int kCur, int kLogS, int kTw>
struct Step {
  static constexpr int cur = kCur, log_s = kLogS;
  static constexpr int r1 = kCur == 2 ? 2 : 4;
  static constexpr int r2 = kCur >= 16 ? 4 : kCur == 8 ? 2 : 1;
  static constexpr int g = r1 * r2;             // points of a group
  static constexpr int lg = (r1 == 4 ? 2 : 1) + (r2 == 4 ? 2 : r2 - 1);
  static constexpr int tw1 = kTw;
  static constexpr int tw2 = kTw + (r1 == 4 ? 3 * (kCur / 4) : kCur / 2);
  static constexpr int tw_next =
      tw2 + (r2 == 4 ? 3 * (kCur / 16) : r2 == 2 ? kCur / 8 : 0);
  static constexpr bool last = kCur == g;
};

template <class S>
using NextStep = Step<S::cur / S::g, S::log_s + S::lg, S::tw_next>;

template <class S, bool kLast = S::last>
struct LastStep {
  using type = typename LastStep<NextStep<S>>::type;
};

template <class S>
struct LastStep<S, true> {
  using type = S;
};

// A radix-kR butterfly on v[0], v[kS], ..., v[(kR - 1) kS], in place,
// with the twiddles of index k of its pass's table.
template <int kR, int kS>
__device__ __forceinline__ void butterfly(float2* v,
                                          const float2* __restrict__ tw,
                                          int k) {
  if constexpr (kR == 4) {
    const float2 w1 = __ldg(tw + 3 * k);
    const float2 w2 = __ldg(tw + 3 * k + 1);
    const float2 w3 = __ldg(tw + 3 * k + 2);
    const float2 a = v[0], b = v[kS], c = v[2 * kS], d = v[3 * kS];
    const float2 apc = make_float2(a.x + c.x, a.y + c.y);
    const float2 amc = make_float2(a.x - c.x, a.y - c.y);
    const float2 bpd = make_float2(b.x + d.x, b.y + d.y);
    const float2 bmd = make_float2(b.x - d.x, b.y - d.y);
    v[0] = make_float2(apc.x + bpd.x, apc.y + bpd.y);
    v[kS] = cmul(make_float2(amc.x + bmd.y, amc.y - bmd.x), w1.x, w1.y);
    v[2 * kS] = cmul(make_float2(apc.x - bpd.x, apc.y - bpd.y), w2.x, w2.y);
    v[3 * kS] = cmul(make_float2(amc.x - bmd.y, amc.y + bmd.x), w3.x, w3.y);
  } else {
    const float2 w1 = __ldg(tw + k);
    const float2 a = v[0], b = v[kS];
    v[0] = make_float2(a.x + b.x, a.y + b.y);
    v[kS] = cmul(make_float2(a.x - b.x, a.y - b.y), w1.x, w1.y);
  }
}

// Where a Stockham op's first step reads and its last step writes: a
// tile's lines in device memory (point p of line c at
// scene + (line0 + c) * n + p for rows, scene + p * lines + line0 + c for
// columns), or the Lines themselves (mega_resident's slab).
struct Io {
  const float* xr;
  const float* xi;
  float* yr;
  float* yi;
  long long scene;
  int lines, line0, axis;
  __device__ __forceinline__ long long at(int c, int p, int n) const {
    return scene + (axis == 1 ? (long long)(line0 + c) * n + p
                              : (long long)p * lines + line0 + c);
  }
};

// A barrier over the threads of one line (named barrier 1 + line, `count`
// threads) where each line of the block has whole warps of its own, or
// over the block (id 0): the lines of a tile are independent, so a line
// need not wait for the block between its steps.
struct LineSync {
  int id, count;
  __device__ __forceinline__ void sync() const {
    if (id == 0) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
    }
  }
};

// Per line where rows of n points, `points` a thread, give every line its
// own warps, the block holds at most 15 lines and no thread is idle; else
// the block.
template <bool kLineFast>
__device__ __forceinline__ LineSync line_sync(int lines, int n, int points) {
  const int units = n / points;
  if (!kLineFast && lines > 1 && lines <= 15 && units % 32 == 0 &&
      lines * units == (int)blockDim.x) {
    return LineSync{1 + (int)threadIdx.x / units, units};
  }
  return LineSync{0, 0};
}

// The maximum of m over the threads of this thread's line, `units` threads
// a line: a run of consecutive threads (rows), or every `here`-th thread
// with `here` lines in the block (columns). Lanes of one line combine by
// shuffles; where a line spans warps, each thread leaves its value in
// red[thread] and, behind bar, reads one of each warp (or each thread of
// the line, where its lanes do not pair by xor). Every thread of the block
// calls it; a thread with no line holds 0.
template <bool kLineFast>
__device__ __forceinline__ float line_max(float m, int here, int units,
                                          float* red, const LineSync& bar) {
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x;
  int first, step, count;
  if (!kLineFast) {
    for (int off = 1; off < min(units, 32); off <<= 1) {
      m = fmaxf(m, __shfl_xor_sync(full, m, off));
    }
    if (units <= 32) return m;
    first = t - t % units;
    step = 32;
    count = units / 32;
  } else {
    step = here;
    if (here < 32 && (here & (here - 1)) == 0) {
      for (int off = here; off < 32; off <<= 1) {
        m = fmaxf(m, __shfl_xor_sync(full, m, off));
      }
      step = 32;
    }
    first = t % here;
    count = here * units / step;
  }
  red[t] = m;
  bar.sync();
  float r = 0.0f;
  for (int k = 0; k < count; ++k) r = fmaxf(r, red[first + k * step]);
  return r;
}

// This thread's line c and unit u (n >= points): a thread keeps one line
// and one unit u < n / points through every step, its groups
// g = u + i n / points. Rows put a line's units on neighbouring threads,
// columns (kLineFast) the
// lines, so that the 4 columns of one point of a column tile sit on
// neighbouring lanes and load in 16-byte runs. False: no line.
template <bool kLineFast>
__device__ __forceinline__ bool thread_unit(int lines, int units, int& c,
                                            int& u) {
  const int t = threadIdx.x;
  if (kLineFast) {
    c = t % lines;
    u = t / lines;
    return u < units;
  }
  c = t / units;
  u = t - c * units;
  return c < lines;
}

// The phase factors (cos, sin) of this thread's points into its own points
// of B (the positions it last read, free while their values sit in
// registers): a step's inputs g + span m, or the last step's outputs, the
// same points held as output r1 r'' + t in register r2 t + r''. Rolled and
// kept out of line, so that sincosf (whose slow path is a call) has one
// site outside the unrolled steps: unrolled over 16 points in every
// specialisation, its slow path became a call at each, and the registers
// live across them spilled.
template <bool kLineFast>
__device__ __noinline__ void phase_factors(const Lines B, int points,
                                           int r1, int r2, bool outputs,
                                           const Filter f, long long fline0,
                                           int valid, int line_base, int c0,
                                           int u, bool on) {
  const int big = r1 * r2, span = B.n / big, units = B.n / points;
  const float* __restrict__ fu = f.u;   // read-only: u of a line loads once
  const float* __restrict__ fv = f.v;
  for (int i = 0; i < points / big; ++i) {
    int c = c0, g = u + i * units;
    bool ok = on;
    if (units == 0) {   // n < points: slot i is a whole line
      c = line_base + threadIdx.x + i * blockDim.x;
      g = 0;
      ok = c < B.lines;
    }
    if (!ok || c >= valid) continue;
    const long long gl = fline0 + c;
    for (int j = 0; j < big; ++j) {
      const int p = g + span * (outputs ? r1 * (j % r2) + j / r2 : j);
      float ph = 0.0f;   // apply_filter's operations
      for (int q = 0; q < f.rank; ++q) {
        ph = __fmaf_rn(__ldg(fu + gl * f.u_line + q * f.u_k),
                       __ldg(fv + (long long)p * f.v_n + q * f.v_k), ph);
      }
      float sn, cs;
      sincosf(ph, &sn, &cs);
      *sat<kLineFast>(B, c, p) = make_float2(cs, sn);
    }
  }
}

// One per-axis op [FFT] -> filter -> [IFFT] (at least one transform) of
// kN-point lines on the Stockham route: this thread's 16 points in a,
// through the steps of the op (compile-time, so that a stays in
// registers). L.s: the swizzled lines in shared memory, read and written
// in place (an exchange: every read of a step, a barrier, its writes, a
// barrier). kIo: the first step reads from io's device memory and the
// last writes there (tile_op); else both in place in L (mega_resident).
// Line c is line fline0 + c of the filter; lines from `valid` on read as
// zero and are never filtered nor stored. The block's threads take lines
// from line_base on (a slab of more lines than the block holds runs in
// rounds). In place, every write is done on exit.
template <bool kLineFast, int kN, bool kIo, int kP, bool kBs = false>
struct StockhamOp {
  static_assert(kIo || !kBs, "the codec in registers needs a device tile");
  static constexpr int kUnits = kN / kP;   // threads a line (kN >= kP)
  using First = Step<kN, 0, 0>;
  using Last = typename LastStep<First>::type;

  const Lines& L;
  const Io& io;
  const float2* __restrict__ tw;
  const Filter& f;
  const long long fline0;
  const int valid;
  const LineSync& bar;
  const int line_base;      // the first line of the block's round
  int c0 = 0, u = 0;        // kN >= kP: this thread's line and unit
  bool on = false;          // kN >= kP: the thread has a line
  long long base = 0;       // kIo, kN >= kP: element of (c0, point 0)
  long long pstride = 0;    // kIo: element distance of neighbouring points
  bool from_shared = !kIo;  // a was read from L.s (else device memory)
  float2 a[kP];
  float up[kN < kP ? kP / kN : 1];   // kBs, kN < kP: 2^e of a slot's line

  __device__ __forceinline__ StockhamOp(const Lines& lines, const Io& io_,
                                        const float2* __restrict__ tw_,
                                        const Filter& f_, long long fline0_,
                                        int valid_, const LineSync& bar_,
                                        int line_base_)
      : L(lines), io(io_), tw(tw_), f(f_), fline0(fline0_), valid(valid_),
        bar(bar_), line_base(line_base_) {
    if constexpr (kN >= kP) {
      const int here = min(L.lines - line_base, (int)blockDim.x / kUnits);
      on = thread_unit<kLineFast>(here, kUnits, c0, u);
      c0 += line_base;
    }
    if constexpr (kIo) {
      pstride = io.axis == 1 ? 1 : io.lines;
      if constexpr (kN >= kP) base = io.at(c0, 0, kN);
    }
  }

  // slot i's line c and group g (false: no group)
  __device__ __forceinline__ bool slot(int i, int& c, int& g) const {
    if constexpr (kN >= kP) {
      c = c0;
      g = u + i * kUnits;
      return on;
    } else {   // one step, one group a line: slot i is a whole line
      c = line_base + threadIdx.x + i * blockDim.x;
      g = 0;
      return c < L.lines;
    }
  }

  __device__ __forceinline__ long long element(int c, int p) const {
    if constexpr (kN >= kP) return base + p * pstride;
    return io.at(c, p, kN);
  }

  __device__ __forceinline__ float2* shared(float2* buf, int c, int p) const {
    return buf + swz(kLineFast ? c + p * L.es : c * L.ls + p);
  }

  // point of register j of group g after step S: output r1 r'' + t sits
  // in register r2 t + r''
  template <class S>
  static __device__ __forceinline__ int out_point(int g, int j) {
    constexpr int s = 1 << S::log_s;
    const int t = j / S::r2, r = j % S::r2;
    return (g >> S::log_s) * S::g * s + (g & (s - 1)) + (S::r1 * r + t) * s;
  }

  // the inputs of step S, g + span m into register m of its group: from
  // device memory (kGlobal; lines past `valid` read as zero) or buf, every
  // load issued before the first use; conj_in: the inverse's first pass
  template <class S, bool kGlobal>
  __device__ __forceinline__ void read(float2* buf, bool conj_in) {
    constexpr int span = kN / S::g;
#pragma unroll
    for (int i = 0; i < kP / S::g; ++i) {
      int c, g;
      const bool ok = slot(i, c, g);
      const bool load = ok && c < valid;
#pragma unroll
      for (int j = 0; j < S::g; ++j) {
        const int p = g + j * span;
        float2 v = make_float2(0.0f, 0.0f);
        if constexpr (kGlobal) {
          if (load) {
            const long long e = element(c, p);
            v = make_float2(__ldcg(io.xr + e), __ldcg(io.xi + e));
          }
        } else if (ok) {
          v = *shared(buf, c, p);
        }
        if (conj_in) v.y = -v.y;   // exact
        a[i * S::g + j] = v;
      }
    }
  }

  // step S's passes on every slot's group
  template <class S>
  __device__ __forceinline__ void compute() {
    constexpr int kk = S::cur / S::g;   // K': groups of one first-pass row
#pragma unroll
    for (int i = 0; i < kP / S::g; ++i) {
      int c, g;
      if (!slot(i, c, g)) continue;
      const int kp = g >> S::log_s;
      float2* v = a + i * S::g;
#pragma unroll
      for (int r = 0; r < S::r2; ++r) {
        butterfly<S::r1, S::r2>(v + r, tw + S::tw1, r * kk + kp);
      }
      if constexpr (S::r2 > 1) {
#pragma unroll
        for (int t = 0; t < S::r1; ++t) {
          butterfly<S::r2, 1>(v + S::r2 * t, tw + S::tw2, kp);
        }
      }
    }
  }

  // the filter on step S's inputs or (`outputs`, S the last step) its
  // outputs, at each point's natural index, with apply_filter's
  // operations; the phase factors go through this thread's points of buf
  template <class S>
  __device__ __forceinline__ void filter(float2* buf, bool outputs) {
    constexpr int span = kN / S::g;
    const Lines B{buf, L.lines, kN, L.ls, L.es};
    const bool phase = has_phase(f), h = has_h(f);
    if (phase) {
      phase_factors<kLineFast>(B, kP, S::r1, S::r2, outputs, f, fline0,
                               valid, line_base, c0, u, on);
    }
#pragma unroll
    for (int i = 0; i < kP / S::g; ++i) {
      int c, g;
      if (!slot(i, c, g) || c >= valid) continue;
#pragma unroll
      for (int j = 0; j < S::g; ++j) {
        const int p = outputs ? out_point<S>(g, j) : g + j * span;
        float2 x = a[i * S::g + j];
        if (h) {
          const long long e = (fline0 + c) * f.h_line + (long long)p * f.h_k;
          x = cmul(x, f.hr[e], f.hi[e]);
        }
        if (phase) {
          const float2 w = *shared(buf, c, p);
          x = cmul(x, w.x, w.y);
        }
        a[i * S::g + j] = x;
      }
    }
  }

  // kBs: the codec's 2 blockDim floats of shared memory past the tile
  __device__ __forceinline__ float* codec() const {
    return reinterpret_cast<float*>(L.s + stockham_points(L.lines * kN));
  }

  // kBs on the loaded points: each line's exponent (this thread's
  // maximum, then its line's through line_max, where a line spans
  // threads), the points scaled by 2^-e in registers, 2^e kept for the
  // store (codec()[blockDim + thread]; per slot where a slot is a whole
  // line)
  __device__ __forceinline__ void encode() {
    if constexpr (kN >= kP) {
      float* red = codec();
      float m = 0.0f;
#pragma unroll
      for (int j = 0; j < kP; ++j) m = fmaxf(m, point_amax(a[j]));
      const int here = min(L.lines - line_base, (int)blockDim.x / kUnits);
      const int e = line_exponent(
          line_max<kLineFast>(m, here, kUnits, red, bar));
      const float down = pow2(-e);
#pragma unroll
      for (int j = 0; j < kP; ++j) a[j] = scale2(a[j], down);
      red[blockDim.x + threadIdx.x] = pow2(e);
    } else {
#pragma unroll
      for (int i = 0; i < kP / kN; ++i) {
        float m = 0.0f;
#pragma unroll
        for (int j = 0; j < kN; ++j) m = fmaxf(m, point_amax(a[i * kN + j]));
        const int e = line_exponent(m);
        const float down = pow2(-e);
#pragma unroll
        for (int j = 0; j < kN; ++j) a[i * kN + j] = scale2(a[i * kN + j],
                                                            down);
        up[i] = pow2(e);
      }
    }
  }

  // step S's outputs to device memory (kGlobal; lines below `valid`) or
  // buf, times (scale, iscale) when `scaled`, then, kGlobal with kBs, by
  // the line's 2^e
  template <class S, bool kGlobal>
  __device__ __forceinline__ void write(float2* buf, bool scaled,
                                        float scale, float iscale) {
    float up_line = 1.0f;
    if constexpr (kGlobal && kBs && kN >= kP) {
      up_line = codec()[blockDim.x + threadIdx.x];
    }
#pragma unroll
    for (int i = 0; i < kP / S::g; ++i) {
      int c, g;
      const bool ok = slot(i, c, g);
      const bool store = ok && c < valid;
#pragma unroll
      for (int j = 0; j < S::g; ++j) {
        const int p = out_point<S>(g, j);
        float2 v = a[i * S::g + j];
        if (scaled) {
          v = make_float2(__fmul_rn(v.x, scale), __fmul_rn(v.y, iscale));
        }
        if constexpr (kGlobal && kBs) {
          v = scale2(v, kN >= kP ? up_line : up[kN >= kP ? 0 : i]);
        }
        if constexpr (kGlobal) {
          if (store) {
            const long long e = element(c, p);
            io.yr[e] = v.x;
            io.yi[e] = v.y;
          }
        } else if (ok) {
          *shared(buf, c, p) = v;
        }
      }
    }
  }

  __device__ __forceinline__ void conj() {
#pragma unroll
    for (int j = 0; j < kP; ++j) a[j].y = -a[j].y;   // exact
  }

  // the forward's last outputs of each group as the inverse's first
  // inputs (same G): output r1 r'' + t sits in register r2 t + r''
  __device__ __forceinline__ void turn() {
    using S = Last;
#pragma unroll
    for (int i = 0; i < kP / S::g; ++i) {
      float2 t[S::g];
#pragma unroll
      for (int m = 0; m < S::g; ++m) {
        t[m] = a[i * S::g + S::r2 * (m % S::r1) + m / S::r1];
      }
#pragma unroll
      for (int m = 0; m < S::g; ++m) a[i * S::g + m] = t[m];
    }
    conj();
  }

  // step S's outputs to shared memory, then step T's inputs from there
  // (every read of S's inputs from L.s done first)
  template <class S, class T>
  __device__ __forceinline__ void exchange(bool conj_in) {
    if (from_shared) bar.sync();
    write<S, false>(L.s, false, 1.0f, 1.0f);
    bar.sync();
    read<T, false>(L.s, conj_in);
    from_shared = true;
  }

  // a transform's steps from S on, the last one's outputs left in a
  template <class S>
  __device__ __forceinline__ void steps() {
    compute<S>();
    if constexpr (!S::last) {
      exchange<S, NextStep<S>>(false);
      steps<NextStep<S>>();
    }
  }

  __device__ __forceinline__ void run(bool fwd, bool inv, float scale,
                                      float iscale) {
    const bool filt = f.mode != kNone;
    read<First, kIo>(L.s, !fwd && !filt);
    if constexpr (kBs) encode();
    if (!fwd && filt) {       // inverse-only: filter the loaded inputs
      filter<First>(L.s, false);
      conj();
      if (kIo) bar.sync();    // L.s held factors: before its first write
    }
    steps<First>();
    if (fwd) {
      if (filt) filter<Last>(L.s, true);
      if (inv) {
        if constexpr (Last::g == First::g) {
          turn();             // the turnaround in registers
        } else {
          exchange<Last, First>(true);
        }
        steps<First>();
      }
    }
    if constexpr (kIo) {      // the last step, scaled, out
      write<Last, true>(nullptr, true, scale, iscale);
    } else {
      bar.sync();
      write<Last, false>(L.s, true, scale, iscale);
      bar.sync();
    }
  }
};

// One Stockham op on kN-point lines, out of line: each n, layout and
// source gets a register allocation of its own (inlined side by side, the
// twelve lengths shared one and spilled).
template <bool kLineFast, int kN, bool kIo, int kP, bool kBs>
__device__ __noinline__ void stockham_n(const Lines L, const Io io,
                                        const float2* __restrict__ tw,
                                        bool fwd, bool inv, const Filter f,
                                        long long fline0, int valid,
                                        float scale, float iscale,
                                        const LineSync bar, int line_base) {
  StockhamOp<kLineFast, kN, kIo, kP, kBs>(L, io, tw, f, fline0, valid, bar,
                                          line_base)
      .run(fwd, inv, scale, iscale);
}

// One Stockham op on L's lines (see StockhamOp); `points` a thread, as
// stockham_per_thread gives them for the block: kPerThread, or
// kWidePerThread (N >= 32) for a 4-column tile at N = 4096 (kIo; the one
// wide tile op built, stockham_tile_built) or a 16384-point slab on 512
// threads (mega_resident). kN > 0: every op of the kernel has L.n == kN,
// and the op is inlined at one shape (a megakernel on the main path's
// scene, whose out-of-line ops spilled 1-3 KB each under its register
// budget and ran slower, PERF.md): 32 points a thread in a 4-column tile
// at N = 4096, else 16, `points` unused; kN == 0: by L.n, out of line. A
// shape no op is built for traps (the launchers refuse it first). kWide:
// the 32-point ops are built (without them a caller passes 16 a thread,
// in rounds of lines).
template <bool kLineFast, bool kIo, int kN = 0, bool kBs = false,
          bool kWide = true>
__device__ __forceinline__ void stockham_op(const Lines& L, const Io& io,
                                            const float2* __restrict__ tw,
                                            bool fwd, bool inv,
                                            const Filter& f, long long fline0,
                                            int valid, float scale,
                                            float iscale, const LineSync& bar,
                                            int line_base = 0,
                                            int points = kPerThread) {
  if constexpr (kN > 0) {   // the one shape built for (layout, kN)
    constexpr int kP =
        kIo && stockham_tile_built(kLineFast ? 0 : 1, kN, kWidePerThread)
            ? kWidePerThread
            : kPerThread;
    if (kIo && L.lines * kN > kP * (int)blockDim.x) __trap();
    StockhamOp<kLineFast, kN, kIo, kP, kBs>(L, io, tw, f, fline0, valid,
                                            bar, line_base)
        .run(fwd, inv, scale, iscale);
    return;
  }
#define SPECTRAL_STOCKHAM_N(kN, kP)                                          \
  case kN:                                                                   \
    stockham_n<kLineFast, kN, kIo, kP, kBs>(L, io, tw, fwd, inv, f, fline0,  \
                                            valid, scale, iscale, bar,       \
                                            line_base);                      \
    return;
  if constexpr (!kWide) {
    if (points == kWidePerThread) __trap();
  } else if (points == kWidePerThread) {
    if constexpr (kIo) {   // columns at N = 4096
      if constexpr (kLineFast) {
        if (L.n == 4096) {
          stockham_n<kLineFast, 4096, kIo, kWidePerThread, kBs>(
              L, io, tw, fwd, inv, f, fline0, valid, scale, iscale, bar,
              line_base);
          return;
        }
      }
    } else {
      switch (L.n) {
        SPECTRAL_STOCKHAM_N(32, kWidePerThread)
        SPECTRAL_STOCKHAM_N(64, kWidePerThread)
        SPECTRAL_STOCKHAM_N(128, kWidePerThread)
        SPECTRAL_STOCKHAM_N(256, kWidePerThread)
        SPECTRAL_STOCKHAM_N(512, kWidePerThread)
        SPECTRAL_STOCKHAM_N(1024, kWidePerThread)
        SPECTRAL_STOCKHAM_N(2048, kWidePerThread)
        SPECTRAL_STOCKHAM_N(4096, kWidePerThread)
        default:
          break;
      }
    }
    __trap();
  }
  switch (L.n) {
    SPECTRAL_STOCKHAM_N(2, kPerThread)
    SPECTRAL_STOCKHAM_N(4, kPerThread)
    SPECTRAL_STOCKHAM_N(8, kPerThread)
    SPECTRAL_STOCKHAM_N(16, kPerThread)
    SPECTRAL_STOCKHAM_N(32, kPerThread)
    SPECTRAL_STOCKHAM_N(64, kPerThread)
    SPECTRAL_STOCKHAM_N(128, kPerThread)
    SPECTRAL_STOCKHAM_N(256, kPerThread)
    SPECTRAL_STOCKHAM_N(512, kPerThread)
    SPECTRAL_STOCKHAM_N(1024, kPerThread)
    SPECTRAL_STOCKHAM_N(2048, kPerThread)
    SPECTRAL_STOCKHAM_N(4096, kPerThread)
    default:
      break;
  }
#undef SPECTRAL_STOCKHAM_N
  __trap();
}

// One per-axis op on the Stockham route on a tile of C whole lines (see
// tile_op): a transform through stockham_op, the tile in s as
// C lines of n points — rows s[c * n + p], columns s[p * C + c], so that
// neighbouring lanes take neighbouring columns — swizzled; filter-only
// straight from device memory to device memory, or with kBs (the bs16
// codec) through s, its lines coded there, their exponents past the tile.
// kBs: the codec's shared memory follows the tile (codec_words: stockham_op's
// 2 blockDim floats, or a filter-only tile's C exponents).
template <bool kLineFast, int kN = 0, bool kBs = false>
__device__ __forceinline__ void stockham_tile(float2* s, const Io& io,
                                              int C, int n,
                                              int valid, bool fwd, bool inv,
                                              const float2* tw,
                                              const Filter& f, float scale,
                                              float iscale) {
  const Lines L = kLineFast ? Lines{s, C, n, 1, C} : Lines{s, C, n, n, 1};
  if (fwd || inv) {
    const int points = stockham_per_thread(C * n, n, blockDim.x);
    stockham_op<kLineFast, true, kN, kBs>(L, io, tw, fwd, inv, f, io.line0,
                                          valid, scale, iscale,
                                          line_sync<kLineFast>(C, n, points),
                                          0, points);
    return;
  }
  if constexpr (kBs) {
    int* ex = reinterpret_cast<int*>(s + stockham_points(C * n));
    for (int o = threadIdx.x; o < C * n; o += blockDim.x) {
      int c, p;
      split_items<kLineFast>(C, n, o, c, p);
      float2 v = make_float2(0.0f, 0.0f);
      if (c < valid) {
        const long long e = io.at(c, p, n);
        v = make_float2(__ldcg(io.xr + e), __ldcg(io.xi + e));
      }
      *at<kLineFast>(L, c, p) = v;
    }
    __syncthreads();
    lines_encode<kLineFast, false>(L, ex);
    filter_pass<kLineFast>(L, f, io.line0, valid, false, 1, 1);
    lines_decode<kLineFast, false>(L, ex);   // scale, iscale: 1 here
    for (int o = threadIdx.x; o < C * n; o += blockDim.x) {
      int c, p;
      split_items<kLineFast>(C, n, o, c, p);
      if (c >= valid) continue;
      const long long e = io.at(c, p, n);
      const float2 v = *at<kLineFast>(L, c, p);
      io.yr[e] = __fmul_rn(v.x, scale);
      io.yi[e] = __fmul_rn(v.y, iscale);
    }
    return;
  }
  for (int o = threadIdx.x; o < C * n; o += blockDim.x) {
    int c, p;
    split_items<kLineFast>(C, n, o, c, p);
    if (c >= valid) continue;
    const long long e = io.at(c, p, n);
    float2 v = make_float2(__ldcg(io.xr + e), __ldcg(io.xi + e));
    v = apply_filter(v, f, io.line0 + c, p);
    io.yr[e] = __fmul_rn(v.x, scale);
    io.yi[e] = __fmul_rn(v.y, iscale);
  }
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
// route m holds the DFT matrices (in shared memory past the tile) and its
// stages run the operand form (kOp, kKara: as transform_k's, `kara` its
// per-call choice); kBs codes the tile's lines in shared memory after the
// load (their exponents past F1 and F2) and decodes them, after the
// inverse's scale, before the store. The Stockham route runs
// stockham_tile (kN: as stockham_op's; kBs: the bs16 codec around the op).
template <bool kStockham, int kN = 0, bool kBs = false, int kOp = kTf32x3,
          int kKara = 0>
__device__ __forceinline__ void tile_op(float2* s, const float* xr,
                                        const float* xi, float* yr, float* yi,
                                        long long scene, int lines, int line0,
                                        int C, int axis, bool fwd, bool inv,
                                        const Dft& d, const Mats& m,
                                        const Filter& f, bool kara = false) {
  static_assert(!kStockham || (kOp == kTf32x3 && kKara == 0),
                "the Stockham route has no matrix operands");
  const int n = d.n, n1 = d.n1, n2 = d.n2;
  const int total = C * n;
  const int T = blockDim.x;
  const int valid = min(C, lines - line0);
  const float scale = inverse_scale(inv, n);
  const float iscale = inv ? -scale : 1.0f;
  if constexpr (kStockham) {
    const Io io{xr, xi, yr, yi, scene, lines, line0, axis};
    if (axis == 1) {
      stockham_tile<false, kN, kBs>(s, io, C, n, valid, fwd, inv, d.stw, f,
                                    scale, iscale);
    } else {
      stockham_tile<true, kN, kBs>(s, io, C, n, valid, fwd, inv, d.stw, f,
                                   scale, iscale);
    }
    return;
  }
  const bool perm_in = !fwd && inv;    // load into the transposed order
  const bool perm_out = fwd && !inv;   // and out of it
  const bool vec =                           // 16-byte accesses
      (axis == 1 ? n % 4 == 0
                 : C % 4 == 0 && lines % 4 == 0 && valid == C) &&
      aligned16(xr + scene) && aligned16(xi + scene) &&
      aligned16(yr + scene) && aligned16(yi + scene);

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
  float out_scale = scale, out_iscale = iscale;
  int* ex = nullptr;
  if constexpr (kBs) {
    ex = reinterpret_cast<int*>(reinterpret_cast<float*>(s + total) +
                                dft_smem_floats(n1, n2));
    lines_encode<false, false>(L, ex);
  }
  if (fwd) transform_k<false, kOp, kKara>(L, d, m, false, kara);
  if (f.mode != kNone) {
    filter_pass<false>(L, f, line0, valid, fwd || inv, n1, n2);
  }
  if (inv) transform_k<false, kOp, kKara>(L, d, m, true, kara);
  if constexpr (kBs) {
    lines_decode_scaled(L, ex, scale, iscale);
    out_scale = out_iscale = 1.0f;
  }

  if (vec && !(axis == 1 && perm_out)) {
    move_vec4(true, s, xr, xi, yr, yi, scene, lines, line0, C, n, valid,
              axis, perm_out, n1, n2, out_scale, out_iscale);
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
      yr[g] = __fmul_rn(val.x, out_scale);
      yi[g] = __fmul_rn(val.y, out_iscale);
    }
  }
}

}  // namespace spectral
