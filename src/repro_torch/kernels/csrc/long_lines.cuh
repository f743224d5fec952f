// Lines longer than one block holds, and the matmul route's three-factor
// splits, for Hopper (sm_90a): the four-step over device memory inside ONE
// cooperative launch, shared by spectral.cu (spectral_long) and mega.cu
// (a mega_staged segment past one block).
//
// Replaces, past the N <= 4096 two-factor lines of spectral_common.cuh's
// tile_op: src/repro/kernels/fft4step.py:598 `_spectral_kernel` at every N
// and split its `default_factorization` (:166) and explicit n1/n2/n3 take
// (2 or 3 factors up to 128, N up to 128^3 = 2^21), every precision, both
// layouts, all five filter modes; with fft_impl="stockham" its
// `_fft_stockham` (:422) at
// every power of two up to 2^21; and, inside mega_staged, those segments of
// `_mega_kernel_staged` (:1002).
//
// Why not one block a line: at N = 8192 on the matmul route (128 x 64) F1
// and F2 take 169,984 B and the line 65,536 B, past the 232,448 B a block
// may opt in to; at 2^21 a line is 16 MiB, past even a 16-block cluster's
// distributed shared memory.
//
// The decomposition. A line of N = d_1 ... d_D * B points, position p in
// mixed radix (digit d_1 most significant). The forward (decimation in
// frequency) runs D device-memory passes, then one tile pass:
//   digit pass i: the d_i-point transforms down the strided "columns" of
//     each block of d_i * R_i points (R_i = the digits after it times B),
//     times the twiddle tw_i[k_i, r] = exp(-2 pi i k_i r / (d_i R_i))
//     (fft4step.four_step_twiddle, float64 rounded once, indexed by the
//     exact integers k_i and r < R_i), written back to the same places;
//   tail pass: the B-point transforms of each run of B points (the matmul
//     route's remaining one or two factors, today's stages; the Stockham
//     route's B = 4096-point passes), which leave X[k] at the digit-reversed
//     position of k (k = k_1 + d_1 (k_2 + d_2 (... + d_D K_B))).
// The inverse (conj-FFT-conj) runs the transpose of that product on the
// digit-reversed order — tail first, then the digits in reverse, each
// multiplying by its twiddle before its transforms — and ends in natural
// order. So fwd [filter] inv is 2D + 1 passes, each reading and writing the
// same places, in place in the output; the filter is applied in the tail
// pass at each point's natural index. A forward-only op stores its tail in
// natural order and an inverse-only one loads its tail from it: those two
// moves cross tiles, so they go through a scratch slab (the wrapper's).
// Every pass walks its tiles in a loop over the co-resident blocks, and a
// grid barrier (cooperative_groups::this_grid().sync()) separates passes;
// reads go through __ldcg (L2, written by other blocks before the barrier).
//
// The matmul route: D = 1 (the leading factor) unless the last two factors
// multiply past 4096 (128^3: D = 2). A digit pass holds C sub-lines of d
// points side by side (s[k * C + c]); the tensor-core stage
// (spectral_common.cuh, 3xTF32 mma.sync) contracts d <= 16 in one stage
// with the sub-lines as its columns, a larger d in two stages of at most 16
// (d = 32, 64, 128 as 8 x 4, 8 x 8, 16 x 8: the tensor cores' accumulation
// truncates, and 128-term sums strayed past the 1e-5 oracle on the 8192 x
// 16384 image); its twiddle is applied in the store (forward) or the load
// (inverse). A tail of two factors runs stages_n1n2 / stages_n2n1's maps
// (so the tail's spectrum is in today's transposed order); the host splits
// a one-factor tail past 16 points in two the same way, and a tail of 16
// or fewer runs one stage with the tile's lines as columns. The Stockham
// route: N = (N / 4096) x 4096, the A-point and
// 4096-point transforms each an out-of-line stockham_n on the tile in
// shared memory (16 points a thread, rows, swizzled), the filter between
// the tail's forward and inverse; the plain version
// (fft4step._fft_stockham_long) runs the same operations, so the kernels
// equal it bit for bit.
//
// Every precision. The Stockham route has no matrix operand, so
// bf16 and f16 run its f32 passes. bs16 is the per-line exponent codec of
// spectral_common.cuh across a line that spans many tiles: a reduction
// phase in the same launch (each (scene, line)'s largest |re| or |im| by an
// atomicMax on its bits in device memory, a grid barrier), the line scaled
// by 2^-e on the op's first load and by 2^e on its last store, e built from
// the exponent bits as the plain version builds it. The matmul route's
// 16-bit forms (bf16, f16, bs16's f16) round each operand once where the
// plain version's _cdot rounds it and contract all f terms with f32
// accumulation, so a digit or a one-factor tail is ONE dense
// mma.sync.m16n8k16 stage of up to 128 terms (never the f32 form's two
// stages, which would round an intermediate the plain version does not),
// and the inverse runs what the plain version runs: conj, the forward's
// passes on natural order, conj x 1/N (the "natural" schedule: the forward's
// tail stores natural order through the scratch slab, so a fwd + inv op is
// 2D + 2 passes). Karatsuba runs on every form, 3xTF32 (9 mma a k-step) at
// f32, 3 passes at 16 bits. Each form is an instantiation of its own
// (long_op_form<kStockham, kOp, kKara, kBs>, spectral_long_form), with the
// codec's words and the Karatsuba flag beside the op (LongForm), so the f32
// forms (long_op, spectral_long) keep their code.
//
// What bounds it: bytes. Each pass reads and writes the slab once (16 B a
// point), a forward-only or inverse-only op 16 B more for its scratch: the
// 8192 x 16384 scene's range launch (D = 1, three passes) moves 3 x 2 GiB,
// 1.92 ms at 3.35 TB/s, where the one-pass bound is 0.641 ms. The tiles are
// simple: scalar (4-byte) loads and stores, coalesced along the contiguous
// axis, one tile per block at a time; a thread-block-cluster form holding a
// line in distributed shared memory, and 16-byte moves, are later speed
// work (ROADMAP).
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "spectral_common.cuh"

namespace spectral {

constexpr int kMaxDigits = 2;
constexpr int kLongThreads = 512;   // both routes
constexpr int kDigitFields = 12;    // int64 fields of a digit in a record
constexpr int kSegFields = 32 + kMaxDigits * kDigitFields;

// One device-memory digit: its factor f, the sub-lines of its tiles, its
// four-step twiddle (f, rest), and its f-point transform: the Stockham
// table (Stockham), or on the matmul route f = fa * fb — one stage of the
// fa x fa DFT matrix (fb = 1, f <= 16), or two: F_fa, the (fa, fb)
// twiddle, F_fb (the tensor cores' accumulation truncates, so a longer
// sum of products strays further: at 128-point sums the 8192 x 16384
// image missed complex128 by 1.04e-5, PERF.md).
struct Digit {
  const float* fr;
  const float* fi;
  const float* fbr;
  const float* fbi;
  const float* itwr;
  const float* itwi;
  const float2* stw;
  const float* twr;
  const float* twi;
  int f, tile, fb;
};

// A segment past one block: `on`, its digits (0 for filter-only), the
// tail's lines a tile, and the scratch slab (forward-only or inverse-only).
struct Long {
  int on, ndev, tail_tile;
  float* sr;
  float* si;
  Digit dig[kMaxDigits];
};

// One per-axis op of a launch table (mega.cu's segments, spectral.cu's one
// long op). For a long op, d describes the tail's transform (d.n = B).
struct Segment {
  Dft d;
  Filter f;
  int axis, fwd, inv;
  int tile;           // mega_staged: lines per tile (the tail's, long)
  int kara;           // the matmul route: Karatsuba in this segment
  Long lg;
};

template <typename T>
const T* as_ptr(long long v) {
  return reinterpret_cast<const T*>(static_cast<uintptr_t>(v));
}

inline bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// A segment from its record (kSegFields int64: axis, fwd, inv, mode, rank,
// n, n1, n2, tile, f1r, f1i, f2r, f2i, twr, twi, hr, hi, h_line, h_k, u, v,
// u_line, u_k, v_n, v_k, stw, kara, then on, ndev, tail_tile, sr, si and,
// per digit, f, tile, fb, fr, fi, fbr, fbi, itwr, itwi, stw, twr, twi).
// n_line: the length of the segment's lines in the scene; op: the launch's
// operand form (the matmul route's 16-bit forms take one stage a digit and
// a scratch slab in every direction); resident: mega_resident's record,
// whose long passes run on its slab and take no scratch slab. Checks what
// the kernels rely on.
inline cudaError_t unpack_segment(const long long* r, int n_line,
                                  Segment& g, int op = kTf32x3,
                                  bool resident = false) {
  g.axis = (int)r[0]; g.fwd = (int)r[1]; g.inv = (int)r[2];
  g.f.mode = (int)r[3]; g.f.rank = (int)r[4];
  g.d.n = (int)r[5]; g.d.n1 = (int)r[6]; g.d.n2 = (int)r[7];
  g.tile = (int)r[8];
  g.d.f1r = as_ptr<float>(r[9]);  g.d.f1i = as_ptr<float>(r[10]);
  g.d.f2r = as_ptr<float>(r[11]); g.d.f2i = as_ptr<float>(r[12]);
  g.d.twr = as_ptr<float>(r[13]); g.d.twi = as_ptr<float>(r[14]);
  g.f.hr = as_ptr<float>(r[15]);  g.f.hi = as_ptr<float>(r[16]);
  g.f.h_line = r[17]; g.f.h_k = r[18];
  g.f.u = as_ptr<float>(r[19]);   g.f.v = as_ptr<float>(r[20]);
  g.f.u_line = r[21]; g.f.u_k = r[22]; g.f.v_n = r[23]; g.f.v_k = r[24];
  g.d.stw = as_ptr<float2>(r[25]);
  g.kara = (int)r[26];
  Long& lg = g.lg;
  lg.on = (int)r[27]; lg.ndev = (int)r[28]; lg.tail_tile = (int)r[29];
  lg.sr = const_cast<float*>(as_ptr<float>(r[30]));
  lg.si = const_cast<float*>(as_ptr<float>(r[31]));
  for (int i = 0; i < kMaxDigits; ++i) {
    const long long* q = r + 32 + kDigitFields * i;
    Digit& dg = lg.dig[i];
    dg.f = (int)q[0]; dg.tile = (int)q[1]; dg.fb = (int)q[2];
    dg.fr = as_ptr<float>(q[3]); dg.fi = as_ptr<float>(q[4]);
    dg.fbr = as_ptr<float>(q[5]); dg.fbi = as_ptr<float>(q[6]);
    dg.itwr = as_ptr<float>(q[7]); dg.itwi = as_ptr<float>(q[8]);
    dg.stw = as_ptr<float2>(q[9]);
    dg.twr = as_ptr<float>(q[10]); dg.twi = as_ptr<float>(q[11]);
  }
  if (g.axis != 0 && g.axis != 1) return cudaErrorInvalidValue;
  if (g.kara && (g.d.stw != nullptr || !(g.fwd || g.inv))) {
    g.kara = 0;     // no stage runs Karatsuba there
  }
  const bool any_fft = g.fwd || g.inv;
  if (!lg.on) {
    const int n = g.d.n;
    if (n != n_line) return cudaErrorInvalidValue;
    if (any_fft && (g.d.stw != nullptr ? !is_pow2(n) || n < 2
                                       : g.d.n1 * g.d.n2 != n)) {
      return cudaErrorInvalidValue;
    }
    return cudaSuccess;
  }
  // a long segment
  if (!any_fft) return lg.ndev == 0 ? cudaSuccess : cudaErrorInvalidValue;
  const bool stockham = g.d.stw != nullptr;
  const bool nat = !stockham && op != kTf32x3;   // the 16-bit forms
  const bool scratch = lg.sr != nullptr && lg.si != nullptr;
  if (lg.ndev < 1 || lg.ndev > kMaxDigits || lg.tail_tile < 1 ||
      (resident ? scratch : (nat || g.fwd != g.inv) != scratch)) {
    return cudaErrorInvalidValue;
  }
  long long prod = g.d.n;
  for (int i = 0; i < lg.ndev; ++i) {
    const Digit& dg = lg.dig[i];
    if (!is_pow2(dg.f) || dg.f < 2 || dg.tile < 1 || dg.twr == nullptr ||
        (stockham ? dg.stw == nullptr || dg.f > 4096
                  : dg.fr == nullptr || dg.f > 128)) {
      return cudaErrorInvalidValue;
    }
    prod *= dg.f;
  }
  if (prod != n_line || !is_pow2(g.d.n)) return cudaErrorInvalidValue;
  if (stockham) {
    if (g.d.n < 2 || g.d.n > 4096 ||
        (long long)g.d.n * lg.tail_tile > kPerThread * kLongThreads) {
      return cudaErrorInvalidValue;
    }
    for (int i = 0; i < lg.ndev; ++i) {
      if ((long long)lg.dig[i].f * lg.dig[i].tile >
          kPerThread * kLongThreads) {
        return cudaErrorInvalidValue;
      }
    }
  } else {
    const bool one = g.d.n2 == 1;
    if (g.d.n1 * g.d.n2 != g.d.n ||
        (one ? g.d.n1 > 128 || !is_pow2(lg.tail_tile) ||
                   !mma_fits(kLongThreads, g.d.n1, lg.tail_tile)
             : !(mma_fits(kLongThreads, g.d.n1, g.d.n2) &&
                 mma_fits(kLongThreads, g.d.n2, g.d.n1)))) {
      return cudaErrorInvalidValue;
    }
    for (int i = 0; i < lg.ndev; ++i) {
      const Digit& dg = lg.dig[i];
      const int fa = dg.fb >= 1 ? dg.f / dg.fb : 0;
      if (dg.fb < 1 || !is_pow2(dg.fb) || fa * dg.fb != dg.f ||
          (nat && dg.fb != 1) ||
          (dg.fb == 1
               ? dg.f > (nat ? 128 : 16) || !is_pow2(dg.tile) ||
                     !mma_fits(kLongThreads, dg.f, dg.tile)
               : dg.fbr == nullptr || dg.itwr == nullptr ||
                     !(mma_fits(kLongThreads, fa, dg.fb) &&
                       mma_fits(kLongThreads, dg.fb, fa)))) {
        return cudaErrorInvalidValue;
      }
    }
  }
  return cudaSuccess;
}

// One long op at run time: the source (the input, or the intermediate in
// the output buffer) and the destination of its batch of `lines` lines of
// n points, in the rows (axis 1: (B, lines, n)) or columns (axis 0:
// (B, n, lines)) layout.
struct LongOp {
  const float* xr;
  const float* xi;
  float* yr;
  float* yi;
  int batch, lines, n, axis, fwd, inv;
  Dft d;
  Filter f;
  Long lg;
};

// A segment of a (batch, na, nr) scene as a long op.
__host__ __device__ inline LongOp long_op_of(const Segment& g,
                                             const float* xr,
                                             const float* xi, float* yr,
                                             float* yi, int batch, int na,
                                             int nr) {
  return LongOp{xr, xi, yr, yi, batch, g.axis == 1 ? na : nr,
                g.axis == 1 ? nr : na, g.axis, g.fwd, g.inv, g.d, g.f, g.lg};
}

enum PassKind { kDigitFwd = 0, kDigitInv = 1, kTail = 2, kFilterOnly = 3 };

struct Pass {
  int kind, digit;
  const float* sr;
  const float* si;
  float* dr;
  float* di;
  bool last;          // the inverse's closing conjugate and 1/N
};

__host__ __device__ inline int long_pass_count(const LongOp& op) {
  if (!(op.fwd || op.inv)) return 1;
  return op.fwd && op.inv ? 2 * op.lg.ndev + 1 : op.lg.ndev + 1;
}

// Pass k of the op: fwd + inv digits forward (the first from the input),
// the tail, digits inverse, all in the output; forward-only digits into the
// scratch and the tail out of it to natural order in the output;
// inverse-only the tail from natural order into the scratch, the digits
// inverse there, the last into the output.
__host__ __device__ inline Pass long_pass(const LongOp& op, int k) {
  const int D = op.lg.ndev;
  const float* xr = op.xr;
  const float* xi = op.xi;
  float* yr = op.yr;
  float* yi = op.yi;
  float* sr = op.lg.sr;
  float* si = op.lg.si;
  if (!(op.fwd || op.inv)) return Pass{kFilterOnly, 0, xr, xi, yr, yi, false};
  if (op.fwd && op.inv) {
    if (k < D) {
      return Pass{kDigitFwd, k, k == 0 ? xr : yr, k == 0 ? xi : yi, yr, yi,
                  false};
    }
    if (k == D) return Pass{kTail, 0, yr, yi, yr, yi, false};
    const int i = 2 * D - k;
    return Pass{kDigitInv, i, yr, yi, yr, yi, i == 0};
  }
  if (op.fwd) {
    if (k < D) {
      return Pass{kDigitFwd, k, k == 0 ? xr : sr, k == 0 ? xi : si, sr, si,
                  false};
    }
    return Pass{kTail, 0, sr, si, yr, yi, false};
  }
  if (k == 0) return Pass{kTail, 0, xr, xi, sr, si, false};
  const int i = D - k;
  return Pass{kDigitInv, i, sr, si, i == 0 ? yr : sr, i == 0 ? yi : si,
              i == 0};
}

// The forms other than f32 take beside the op: bs16's words (one a (scene,
// line): the largest |re| or |im| of its line on the op's load) and the
// matmul route's Karatsuba flag.
struct LongForm {
  unsigned* ex;
  int kara;
};

// What a pass of the forms does besides the f32 pass of its kind: the
// natural schedule's tail the filter after its forward (its tails all run
// the forward and store natural order); a digit pass's load the inverse's
// opening conjugate or an inverse-only op's filter; bs16's 2^-e on the
// op's first load and 2^e on its last store.
struct PassForm {
  bool filt, conj_in, filt_in, enc, dec;
};

// Passes of the natural schedule (the 16-bit forms): fwd + inv runs the
// forward's D + 1 passes twice.
__host__ __device__ inline int long_pass_count_natural(const LongOp& op) {
  if (!(op.fwd || op.inv)) return 1;
  return op.fwd && op.inv ? 2 * op.lg.ndev + 2 : op.lg.ndev + 1;
}

// Pass k of the natural schedule, the inverse as conj, the forward on
// natural order, conj x 1/N: digits forward into the scratch (the first
// from the input, the inverse's first from the output), the tail out of
// the scratch to natural order in the output (the inverse's with its
// closing conjugate and 1/N: `last`).
__host__ __device__ inline Pass long_pass_natural(const LongOp& op, int k) {
  const int D = op.lg.ndev;
  if (!(op.fwd || op.inv)) {
    return Pass{kFilterOnly, 0, op.xr, op.xi, op.yr, op.yi, false};
  }
  const bool second = op.fwd && op.inv && k > D;   // the inverse's passes
  const int i = second ? k - D - 1 : k;
  const bool inverse = second || !op.fwd;
  if (i < D) {
    return Pass{kDigitFwd, i, i > 0 ? op.lg.sr : second ? op.yr : op.xr,
                i > 0 ? op.lg.si : second ? op.yi : op.xi, op.lg.sr,
                op.lg.si, false};
  }
  return Pass{kTail, 0, op.lg.sr, op.lg.si, op.yr, op.yi, inverse};
}

// The PassForm of pass k: bs16's first and last pass and, kNat, the
// natural schedule's (its tails forward, natural order out, the forward's
// filtered; digit 0's load conjugated by the inverse, filtered by an
// inverse-only op). The f32 schedule's tails take their transforms,
// orders and filter from the op (tail_tile).
template <bool kNat>
__host__ __device__ inline PassForm pass_form(const LongOp& op, int k) {
  PassForm f{};
  const int np = kNat ? long_pass_count_natural(op) : long_pass_count(op);
  f.enc = k == 0;
  f.dec = k == np - 1;
  if constexpr (kNat) {
    const int D = op.lg.ndev;
    const bool second = op.fwd && op.inv && k > D;
    const int i = second ? k - D - 1 : k;
    const bool inverse = second || !op.fwd;
    f.filt = !inverse;
    f.conj_in = i == 0 && inverse;
    f.filt_in = i == 0 && !op.fwd && op.f.mode != kNone;
  }
  return f;
}

// The stride R_i of digit i (the points after it in a block).
__host__ __device__ inline int digit_rest(const LongOp& op, int i) {
  int r = op.n;
  for (int j = 0; j <= i; ++j) r /= op.lg.dig[j].f;
  return r;
}

// Points of a filter-only pass a block takes a turn.
constexpr int kFilterChunk = 4 * kLongThreads;

// Tiles of pass p (the grid walks them; a filter-only pass its chunks).
// Digit pass i: sub-scenes of d_i R_i points a line (times the lines in
// the rows layout), each of R_i sub-lines (R_i * lines in the columns
// layout, where a sub-line is one (r, line)), tile sub-lines a tile. Tail:
// rows, lines of B points over the whole batch; columns, per run of B
// points of a scene, its lines.
__host__ __device__ inline long long long_pass_tiles(const LongOp& op,
                                                     const Pass& p) {
  const long long lines = op.lines;
  if (p.kind == kFilterOnly) {
    const long long total = (long long)op.batch * lines * op.n;
    return (total + kFilterChunk - 1) / kFilterChunk;
  }
  if (p.kind == kTail) {
    const int B = op.d.n, C = op.lg.tail_tile;
    const long long P = op.n / B;
    if (op.axis == 1) return ((long long)op.batch * lines * P + C - 1) / C;
    return (long long)op.batch * P * ((lines + C - 1) / C);
  }
  const Digit& g = op.lg.dig[p.digit];
  const long long rest = digit_rest(op, p.digit);
  const long long sub = rest * (op.axis == 1 ? 1 : lines);
  const long long scenes = (long long)op.batch *
                           (op.axis == 1 ? lines : 1) * (op.n / (rest * g.f));
  return scenes * ((sub + g.tile - 1) / g.tile);
}

// Words of shared memory the bs16 reduction phase takes (long_amax).
constexpr int kAmaxWords = 32;

// Shared memory of a long op's largest pass (mats: the matmul route's DFT
// matrices past the tile); with bs, at least the reduction's words.
inline size_t long_smem(const LongOp& op, bool stockham, bool bs = false) {
  const size_t least = bs ? kAmaxWords * sizeof(unsigned) : 0;
  if (!(op.fwd || op.inv)) return least;
  auto bytes = [&](int points, int n1, int n2) {
    return stockham ? (size_t)stockham_points(points) * sizeof(float2)
                    : (size_t)points * sizeof(float2) +
                          (size_t)dft_smem_floats(n1, n2) * sizeof(float);
  };
  size_t out = bytes(op.d.n * op.lg.tail_tile, op.d.n1,
                     op.d.n2 == 1 ? op.d.n1 : op.d.n2);
  for (int i = 0; i < op.lg.ndev; ++i) {
    const Digit& g = op.lg.dig[i];
    const int fb = g.fb > 1 ? g.fb : 0;
    out = std::max(out, bytes(g.f * g.tile, fb ? g.f / fb : g.f,
                              fb ? fb : g.f));
  }
  return std::max(out, least);
}

// The most tiles of any pass (the cooperative grid's useful size; the
// natural schedule runs the same kinds of pass).
inline long long long_work(const LongOp& op) {
  long long w = 1;
  for (int k = 0; k < long_pass_count(op); ++k) {
    w = std::max(w, long_pass_tiles(op, long_pass(op, k)));
  }
  return w;
}

// The Stockham passes of every line of L (rows, swizzled, in place): a
// forward (fwd) or, conjugated on the read and not after, the inverse's
// (inv), no filter, times 1 on the last write. 16 points a thread, in
// rounds of the lines the block holds; each length one out-of-line op
// (stockham_n).
__device__ __forceinline__ void stockham_lines(const Lines& L,
                                               const float2* stw, bool fwd,
                                               bool inv) {
  const Filter none{};
  const int units = L.n / kPerThread;
  const int round = units > 0 ? (int)blockDim.x / units
                              : (int)blockDim.x * kPerThread / L.n;
  for (int line0 = 0; line0 < L.lines; line0 += round) {
#define SPECTRAL_LONG_N(kN)                                                  \
  case kN:                                                                   \
    stockham_n<false, kN, false, kPerThread, false>(                         \
        L, Io{}, stw, fwd, inv, none, 0, L.lines, 1.0f, 1.0f,                \
        LineSync{0, 0}, line0);                                              \
    break;
    switch (L.n) {
      SPECTRAL_LONG_N(2)
      SPECTRAL_LONG_N(4)
      SPECTRAL_LONG_N(8)
      SPECTRAL_LONG_N(16)
      SPECTRAL_LONG_N(32)
      SPECTRAL_LONG_N(64)
      SPECTRAL_LONG_N(128)
      SPECTRAL_LONG_N(256)
      SPECTRAL_LONG_N(512)
      SPECTRAL_LONG_N(1024)
      SPECTRAL_LONG_N(2048)
      SPECTRAL_LONG_N(4096)
      default:
        __trap();
    }
#undef SPECTRAL_LONG_N
  }
}

// One tensor-core stage of the long passes (spectral_common.cuh's stage on
// 3xTF32), out of line: every pass calls this one copy of its masked and
// unmasked forms, rather than inlining them at each site (which cost
// minutes of ptxas time a library).
__device__ __noinline__ void long_stage(const Lines L, const StageMap g,
                                        const float* fr, const float* fi,
                                        int fld, const float* twr,
                                        const float* twi, bool conj_in) {
  run_stage<false>(L, g, fr, fi, fld, twr, twi, conj_in);
}

// The same on lines whose points are C words apart (a digit pass's tile).
__device__ __noinline__ void long_stage_cols(const Lines L, const StageMap g,
                                             const float* fr,
                                             const float* fi, int fld,
                                             const float* twr,
                                             const float* twi) {
  run_stage<true>(L, g, fr, fi, fld, twr, twi, false);
}

// The other operand forms' stages (kOp: 16-bit operands; kKara:
// Karatsuba), out of line as long_stage, one copy a form.
template <int kOp, bool kKara>
__device__ __noinline__ void long_stage_form(const Lines L, const StageMap g,
                                             const float* fr,
                                             const float* fi, int fld,
                                             const float* twr,
                                             const float* twi, bool conj_in) {
  run_stage<false, kOp, kKara>(L, g, fr, fi, fld, twr, twi, conj_in);
}

// 3xTF32 Karatsuba on a digit tile's strided lines (the f32 form's two
// stages; the 16-bit forms run one stage of lines side by side).
__device__ __noinline__ void long_stage_cols_kara(const Lines L,
                                                  const StageMap g,
                                                  const float* fr,
                                                  const float* fi, int fld,
                                                  const float* twr,
                                                  const float* twi) {
  run_stage<true, kTf32x3, true>(L, g, fr, fi, fld, twr, twi, false);
}

// A stage of the op's form: kOp, and Karatsuba as kKara says (0 never, 2
// as the op's `kara`).
template <int kOp, int kKara>
__device__ __forceinline__ void form_stage(bool kara, const Lines L,
                                           const StageMap g,
                                           const float* fr, const float* fi,
                                           int fld, const float* twr,
                                           const float* twi, bool conj_in) {
  if constexpr (kKara == 2) {
    if (kara) {
      long_stage_form<kOp, true>(L, g, fr, fi, fld, twr, twi, conj_in);
      return;
    }
  }
  if constexpr (kOp == kTf32x3) {
    long_stage(L, g, fr, fi, fld, twr, twi, conj_in);
  } else {
    long_stage_form<kOp, false>(L, g, fr, fi, fld, twr, twi, conj_in);
  }
}

template <int kKara>
__device__ __forceinline__ void form_stage_cols(bool kara, const Lines L,
                                                const StageMap g,
                                                const float* fr,
                                                const float* fi, int fld,
                                                const float* twr,
                                                const float* twi) {
  if constexpr (kKara == 2) {
    if (kara) {
      long_stage_cols_kara(L, g, fr, fi, fld, twr, twi);
      return;
    }
  }
  long_stage_cols(L, g, fr, fi, fld, twr, twi);
}

// The bs16 codec's exponent of (scene, line) bl, from the largest |re| or
// |im| the reduction phase left in the form's words (other blocks wrote
// them: L2).
__device__ __forceinline__ int codec_exponent(const LongForm form,
                                              long long bl) {
  return line_exponent(__uint_as_float(__ldcg(form.ex + bl)));
}

// A point of digit 0's tile (the line's leading factor, one sub-scene a
// line): its (scene, line) bl, its line in the scene and its natural
// index, from the sub-scene `scene`, its position k and sub-line j.
struct DigitPoint {
  long long bl;
  int line, k;
};

__device__ __forceinline__ DigitPoint digit0_point(const LongOp& op,
                                                   long long scene, int k,
                                                   long long j, int rest) {
  if (op.axis == 1) {
    return DigitPoint{scene, (int)(scene % op.lines), k * rest + (int)j};
  }
  const int l = (int)(j % op.lines);
  return DigitPoint{scene * op.lines + l, l,
                    k * rest + (int)(j / op.lines)};
}

// One digit pass's tile: sub-lines [j0, j0 + C) of the sub-scene at `off`,
// point k of sub-line j at off + k * sub + j. Forward: the f-point
// transforms, then the twiddle tw[k * rest + r] (r = j / ldiv: a columns
// layout's sub-line is (r, line)); inverse: the twiddle, then the
// transforms, and on the last pass (scale, iscale). Both directions run the
// forward transform (the inverse's conjugates are the tail's and the last
// store's). In shared memory: the matmul route's sub-lines side by side
// (s[k * C + c]; one stage of f <= 16 — of any f in the 16-bit forms —
// takes them as one line of f x C, the stage's C columns; two stages, fa
// then fb, leave point k at the transposed position of k), the Stockham
// route's C rows of f points (swizzled). Digit 0's load takes, as the
// pass's form says, bs16's 2^-e, an inverse-only op's filter at the
// point's natural index and the inverse's conjugate (the natural
// schedule), in the plain version's order; its store bs16's 2^e after the
// inverse's scale.
template <bool kStockham, int kOp = kTf32x3, int kKara = 0, bool kBs = false>
__device__ __forceinline__ void digit_tile(float2* s, const Mats& m,
                                           const LongOp& op, const Pass& p,
                                           const PassForm pf,
                                           const LongForm form, long long t) {
  constexpr bool kNat = !kStockham && kOp != kTf32x3;
  const Digit& g = op.lg.dig[p.digit];
  const int f = g.f, C = g.tile;
  const int rest = digit_rest(op, p.digit);
  const int ldiv = op.axis == 1 ? 1 : op.lines;
  const long long sub = (long long)rest * ldiv;
  const long long tps = (sub + C - 1) / C;
  const long long scene = t / tps;
  const long long j0 = (t - scene * tps) * C;
  const long long off = scene * f * sub;
  const bool inverse = p.kind == kDigitInv;
  const int total = f * C;
  const float* __restrict__ twr = g.twr;
  const float* __restrict__ twi = g.twi;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int k = i / C, c = i - k * C;
    const long long j = j0 + c;
    float2 v = make_float2(0.0f, 0.0f);
    if (j < sub) {
      const long long e = off + k * sub + j;
      v = make_float2(__ldcg(p.sr + e), __ldcg(p.si + e));
      if constexpr (kBs || kNat) {
        if ((kBs && pf.enc) || (kNat && pf.filt_in)) {
          const DigitPoint q = digit0_point(op, scene, k, j, rest);
          if (kBs && pf.enc) v = scale2(v, pow2(-codec_exponent(form, q.bl)));
          if (kNat && pf.filt_in) v = apply_filter(v, op.f, q.line, q.k);
        }
        if (kNat && pf.conj_in) v.y = -v.y;   // exact
      }
      if (inverse) {
        const int w = k * rest + (int)(j / ldiv);
        v = cmul(v, __ldg(twr + w), __ldg(twi + w));
      }
    }
    s[kStockham ? swz(c * f + k) : i] = v;
  }
  __syncthreads();
  const int fb = kStockham ? 1 : g.fb, fa = f / fb;
  if constexpr (kStockham) {
    stockham_lines(Lines{s, C, f, f, 1}, g.stw, true, false);
  } else if (fb == 1) {
    //                                            nf nq sk sq om oq twm twq
    form_stage<kOp, kKara>(form.kara, Lines{s, 1, total, total, 1},
                           StageMap{f, C, C, 1, C, 1, 0, 0}, m.f1r, m.f1i,
                           m.ld1, nullptr, nullptr, false);
  } else if constexpr (kOp == kTf32x3) {   // stages_n1n2's maps
    const Lines L{s, C, f, 1, C};
    form_stage_cols<kKara>(form.kara, L, StageMap{fa, fb, fb, 1, 1, fa, fb, 1},
                           m.f1r, m.f1i, m.ld1, g.itwr, g.itwi);
    form_stage_cols<kKara>(form.kara, L, StageMap{fb, fa, fa, 1, 1, fb, 0, 0},
                           m.f2r, m.f2i, m.ld2, nullptr, nullptr);
  } else {
    __trap();   // the 16-bit forms take one stage (unpack_segment)
  }
  const float scale = inverse_scale(p.last, op.n);
  const float iscale = -scale;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int q = i / C, c = i - q * C;   // q: the position in the tile
    const long long j = j0 + c;
    if (j >= sub) continue;
    const int k = fb > 1 ? from_transposed(q, fa, fb) : q;
    float2 v = s[kStockham ? swz(c * f + q) : i];
    if (!inverse) {
      const int w = k * rest + (int)(j / ldiv);
      v = cmul(v, __ldg(twr + w), __ldg(twi + w));
    }
    if (p.last) v = make_float2(__fmul_rn(v.x, scale), __fmul_rn(v.y, iscale));
    if constexpr (kBs) {
      if (pf.dec) {
        v = scale2(v, pow2(codec_exponent(
                          form, digit0_point(op, scene, k, j, rest).bl)));
      }
    }
    const long long e = off + k * sub + j;
    p.dr[e] = v.x;
    p.di[e] = v.y;
  }
  __syncthreads();   // the next tile's load overwrites s
}

// Line c of a tail tile: whether it exists, its point q = 0 in the
// position order (point q at pos + q * stride), its line's natural index 0
// (natural index k at nat + k * stride), its line in the scene (the
// filter's) and the index klo its run of B points adds to every natural
// index (the digits of the run's position, reversed).
struct TailLine {
  bool valid;
  long long pos, nat;
  int line;
  int klo;
};

__device__ __forceinline__ TailLine tail_line(const LongOp& op, long long t,
                                              int c) {
  const int B = op.d.n, C = op.lg.tail_tile;
  const int P = op.n / B;
  TailLine r{};
  long long run;           // b * P + the run's position among the P
  if (op.axis == 1) {
    const long long T = t * C + c;
    r.valid = T < (long long)op.batch * op.lines * P;
    const long long bl = T / P;
    run = T;
    r.line = (int)(bl % op.lines);
    r.pos = T * B;
    r.nat = bl * op.n;
  } else {
    const long long tps = (op.lines + C - 1) / C;
    const long long sc = t / tps;
    const int l = (int)((t - sc * tps) * C) + c;
    r.valid = l < op.lines;
    run = sc;
    r.line = l;
    r.pos = sc * B * op.lines + l;
    r.nat = (sc / P) * op.n * op.lines + l;
  }
  const int blk = (int)(run % P);
  r.klo = op.lg.ndev == 1 ? blk
                          : blk / op.lg.dig[1].f +
                                op.lg.dig[0].f * (blk % op.lg.dig[1].f);
  return r;
}

// The (scene, line) of a tail tile's line (bs16's word).
__device__ __forceinline__ long long tail_bl(const LongOp& op,
                                            const TailLine& r) {
  return op.axis == 1
             ? r.nat / op.n
             : r.nat / ((long long)op.n * op.lines) * op.lines + r.line;
}

// The natural index of a tail tile's point q (the matmul route's two-factor
// tail leaves its runs in the transposed order).
template <bool kStockham>
__device__ __forceinline__ int tail_k(const LongOp& op, const TailLine& r,
                                      int q) {
  const int kb = !kStockham && op.d.n2 > 1 ? from_transposed(q, op.d.n1,
                                                             op.d.n2)
                                           : q;
  return r.klo + (op.n / op.d.n) * kb;
}

// The tail's B-point transform of every line of L (forward, or the
// inverse's without its closing conjugate and 1/N). Two factors: the
// stages of spectral_common.cuh's stages_n1n2 (forward, ending in the
// transposed order) and stages_n2n1 (the inverse, from it), each through
// form_stage (the op's operand form; the f32 form's is tail_transform).
template <bool kStockham, int kOp, int kKara>
__device__ __forceinline__ void tail_transform_form(const Lines& L,
                                                    const Dft& d,
                                                    const Mats& m,
                                                    bool inverse, bool kara) {
  if constexpr (kStockham) {
    stockham_lines(L, d.stw, !inverse, inverse);
  } else if (d.n2 == 1) {   // one factor: the lines as the stage's columns
    const int total = L.lines * L.n;
    form_stage<kOp, kKara>(kara, Lines{L.s, 1, total, total, 1},
                           StageMap{L.n, L.lines, 1, L.n, 1, L.n, 0, 0},
                           m.f1r, m.f1i, m.ld1, nullptr, nullptr, inverse);
  } else if (!inverse) {
    const int n1 = d.n1, n2 = d.n2;
    //                   nf  nq  sk  sq  om  oq  twm twq
    form_stage<kOp, kKara>(kara, L, StageMap{n1, n2, n2, 1, 1, n1, n2, 1},
                           m.f1r, m.f1i, m.ld1, d.twr, d.twi, false);
    form_stage<kOp, kKara>(kara, L, StageMap{n2, n1, n1, 1, 1, n2, 0, 0},
                           m.f2r, m.f2i, m.ld2, nullptr, nullptr, false);
  } else {
    const int n1 = d.n1, n2 = d.n2;
    form_stage<kOp, kKara>(kara, L, StageMap{n2, n1, 1, n2, 1, n2, 1, n2},
                           m.f2r, m.f2i, m.ld2, d.twr, d.twi, true);
    form_stage<kOp, kKara>(kara, L, StageMap{n1, n2, n2, 1, n2, 1, 0, 0},
                           m.f1r, m.f1i, m.ld1, nullptr, nullptr, false);
  }
}

// tail_tile (below, the f32 form's) at the other forms: the same loads,
// transforms and stores through form_stage. The natural schedule (kNat)
// runs the
// forward and stores natural order, filtered where the pass's form says,
// its last pass with the inverse's closing conjugate and 1/N on the
// store; bs16 scales by 2^-e on the op's first load, before the filter,
// and by 2^e on its last store.
template <bool kStockham, int kOp, int kKara, bool kBs>
__device__ __forceinline__ void tail_tile_form(float2* s, const Mats& m,
                                               const LongOp& op,
                                               const Pass& p,
                                               const PassForm pf,
                                               const LongForm form,
                                               long long t) {
  constexpr bool kNat = !kStockham && kOp != kTf32x3;
  const int B = op.d.n, C = op.lg.tail_tile;
  const int total = C * B;
  const long long stride = op.axis == 1 ? 1 : op.lines;
  const bool tfwd = kNat || op.fwd;
  const bool tinv = !kNat && op.inv;
  const bool perm_in = !kNat && !op.fwd;
  const bool perm_out = kNat || !op.inv;
  const bool filt = (kNat ? pf.filt : true) && op.f.mode != kNone;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    int c, q;
    if (op.axis == 0 || perm_in) { q = i / C; c = i - q * C; }
    else { c = i / B; q = i - c * B; }
    const TailLine r = tail_line(op, t, c);
    float2 v = make_float2(0.0f, 0.0f);
    if (r.valid) {
      if (perm_in) {
        const int k = tail_k<kStockham>(op, r, q);
        const long long e = r.nat + k * stride;
        v = make_float2(__ldcg(p.sr + e), __ldcg(p.si + e));
        if constexpr (kBs) {
          if (pf.enc) {
            v = scale2(v, pow2(-codec_exponent(form, tail_bl(op, r))));
          }
        }
        if (filt) v = apply_filter(v, op.f, r.line, k);
      } else {
        const long long e = r.pos + q * stride;
        v = make_float2(__ldcg(p.sr + e), __ldcg(p.si + e));
      }
    }
    s[kStockham ? swz(c * B + q) : c * B + q] = v;
  }
  __syncthreads();
  const Lines L{s, C, B, B, 1};
  if (tfwd) {
    tail_transform_form<kStockham, kOp, kKara>(L, op.d, m, false,
                                                 form.kara);
    if (filt) {
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        const int c = i / B, q = i - c * B;
        const TailLine r = tail_line(op, t, c);
        if (!r.valid) continue;
        float2* e = s + (kStockham ? swz(i) : i);
        *e = apply_filter(*e, op.f, r.line, tail_k<kStockham>(op, r, q));
      }
      __syncthreads();
    }
  }
  if constexpr (!kNat) {   // the natural schedule runs forwards alone
    if (tinv) {
      tail_transform_form<kStockham, kOp, kKara>(L, op.d, m, true,
                                                 form.kara);
    }
  }
  const float scale = inverse_scale(kNat && p.last, op.n);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    int c, q;
    if (op.axis == 0 || perm_out) { q = i / C; c = i - q * C; }
    else { c = i / B; q = i - c * B; }
    const TailLine r = tail_line(op, t, c);
    if (!r.valid) continue;
    float2 v = s[kStockham ? swz(c * B + q) : c * B + q];
    if constexpr (kNat) {
      if (p.last) {
        v = make_float2(__fmul_rn(v.x, scale), __fmul_rn(v.y, -scale));
      }
    }
    if constexpr (kBs) {
      if (pf.dec) v = scale2(v, pow2(codec_exponent(form, tail_bl(op, r))));
    }
    const long long e = perm_out
                            ? r.nat + tail_k<kStockham>(op, r, q) * stride
                            : r.pos + q * stride;
    p.dr[e] = v.x;
    p.di[e] = v.y;
  }
  __syncthreads();   // the next tile's load overwrites s
}

// A filter-only op past one block: elementwise, device memory to device
// memory (bs16: 2^-e, the filter, 2^e, as the plain version orders them).
template <bool kBs = false>
__device__ __forceinline__ void filter_only(const LongOp& op, const Pass& p,
                                            const LongForm form) {
  const long long total = (long long)op.batch * op.lines * op.n;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step) {
    int line, k;
    if (op.axis == 1) {
      const long long l = e / op.n;
      k = (int)(e - l * op.n);
      line = (int)(l % op.lines);
    } else {
      const long long pl = e / op.lines;
      line = (int)(e - pl * op.lines);
      k = (int)(pl % op.n);
    }
    if constexpr (!kBs) {
      const float2 v = apply_filter(make_float2(__ldcg(p.sr + e),
                                                __ldcg(p.si + e)),
                                    op.f, line, k);
      p.dr[e] = v.x;
      p.di[e] = v.y;
    } else {
      const long long bl = op.axis == 1
                               ? e / op.n
                               : e / ((long long)op.n * op.lines) * op.lines +
                                     line;
      const int ex = codec_exponent(form, bl);
      float2 v = scale2(make_float2(__ldcg(p.sr + e), __ldcg(p.si + e)),
                        pow2(-ex));
      v = scale2(apply_filter(v, op.f, line, k), pow2(ex));
      p.dr[e] = v.x;
      p.di[e] = v.y;
    }
  }
}

// Points of a row a block reduces a turn, and rows of the columns layout
// (32 lines side by side a tile).
constexpr int kAmaxChunk = 4096;
constexpr int kAmaxRows = 1024;

// bs16's reduction phase (before the op's first pass): every (scene, line)'s
// largest |re| or |im| of the op's input into ex, by an atomicMax on its
// bits (non-negative floats order as their bits): the words zeroed, a grid
// barrier, each tile's maximum reduced in the block (rows: a warp's lanes
// share the line; columns: a lane a line, the warps' maxima in shared
// memory), then one atomic a warp or a line. The caller's grid barrier
// follows.
__device__ __forceinline__ void long_amax(float2* s, const LongOp& op,
                                          const LongForm form) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  unsigned* ex = form.ex;
  const long long words = (long long)op.batch * op.lines;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < words; i += (long long)gridDim.x * blockDim.x) {
    ex[i] = 0u;
  }
  grid.sync();
  const float* __restrict__ xr = op.xr;
  const float* __restrict__ xi = op.xi;
  const int lane = threadIdx.x & 31;
  if (op.axis == 1) {
    const int chunk = min(op.n, kAmaxChunk);
    const long long per = op.n / chunk;
    const long long tiles = words * per;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long row = t / per;
      const long long base = row * op.n + (t - row * per) * chunk;
      unsigned mx = 0u;
      for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
        const float2 v = make_float2(__ldcg(xr + base + i),
                                     __ldcg(xi + base + i));
        mx = max(mx, __float_as_uint(point_amax(v)));
      }
      mx = __reduce_max_sync(0xffffffffu, mx);
      if (lane == 0 && mx != 0u) atomicMax(ex + row, mx);
    }
    return;
  }
  unsigned* red = reinterpret_cast<unsigned*>(s);
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const long long lt = (op.lines + 31) / 32;           // line tiles
  const long long kt = (op.n + kAmaxRows - 1) / kAmaxRows;
  const long long tiles = (long long)op.batch * kt * lt;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long b = t / (kt * lt);
    const long long r = t - b * kt * lt;
    const int k0 = (int)(r / lt) * kAmaxRows;
    const int l = (int)(r % lt) * 32 + lane;
    if (threadIdx.x < 32) red[threadIdx.x] = 0u;
    __syncthreads();
    unsigned mx = 0u;
    if (l < op.lines) {
      const int k1 = min(op.n, k0 + kAmaxRows);
      for (int k = k0 + warp; k < k1; k += nwarps) {
        const long long e = (b * op.n + k) * op.lines + l;
        mx = max(mx, __float_as_uint(point_amax(
                         make_float2(__ldcg(xr + e), __ldcg(xi + e)))));
      }
    }
    if (mx != 0u) atomicMax(red + lane, mx);
    __syncthreads();
    if (threadIdx.x < 32 && l < op.lines && red[lane] != 0u) {
      atomicMax(ex + b * op.lines + l, red[lane]);
    }
    __syncthreads();   // the next tile zeroes red
  }
}

// The matmul route's DFT matrices of pass p in shared memory past its tile
// (`at`): the digit's f x f matrix, or the tail's F1 and F2 (one F1 for a
// one-factor tail). No barrier: the first tile's load barrier orders it.
__device__ __forceinline__ Mats long_mats(float2* s, const LongOp& op,
                                          const Pass& p) {
  if (p.kind == kTail) {
    const Dft& d = op.d;
    float* at = reinterpret_cast<float*>(s + op.lg.tail_tile * d.n);
    if (d.n2 > 1) return mats_to_shared(at, d);
    return mats_to_shared(at, Dft{d.f1r, d.f1i, d.f1r, d.f1i, nullptr,
                                  nullptr, nullptr, d.n, d.n, d.n});
  }
  const Digit& g = op.lg.dig[p.digit];
  float* at = reinterpret_cast<float*>(s + g.f * g.tile);
  if (g.fb > 1) {
    return mats_to_shared(at, Dft{g.fr, g.fi, g.fbr, g.fbi, nullptr, nullptr,
                                  nullptr, g.f, g.f / g.fb, g.fb});
  }
  return mats_to_shared(at, Dft{g.fr, g.fi, g.fr, g.fi, nullptr, nullptr,
                                nullptr, g.f, g.f, g.f});
}

// The tail's B-point transform of every line of L (forward, or the
// inverse's without its closing conjugate and 1/N). Two factors: the
// stages of spectral_common.cuh's stages_n1n2 (forward, ending in the
// transposed order) and stages_n2n1 (the inverse, from it), each through
// long_stage.
template <bool kStockham>
__device__ __forceinline__ void tail_transform(const Lines& L, const Dft& d,
                                               const Mats& m, bool inverse) {
  if constexpr (kStockham) {
    stockham_lines(L, d.stw, !inverse, inverse);
  } else if (d.n2 == 1) {   // one factor: the lines as the stage's columns
    const int total = L.lines * L.n;
    long_stage(Lines{L.s, 1, total, total, 1},
               StageMap{L.n, L.lines, 1, L.n, 1, L.n, 0, 0}, m.f1r, m.f1i,
               m.ld1, nullptr, nullptr, inverse);
  } else if (!inverse) {
    const int n1 = d.n1, n2 = d.n2;
    //                   nf  nq  sk  sq  om  oq  twm twq
    long_stage(L, StageMap{n1, n2, n2, 1, 1, n1, n2, 1}, m.f1r, m.f1i, m.ld1,
               d.twr, d.twi, false);
    long_stage(L, StageMap{n2, n1, n1, 1, 1, n2, 0, 0}, m.f2r, m.f2i, m.ld2,
               nullptr, nullptr, false);
  } else {
    const int n1 = d.n1, n2 = d.n2;
    long_stage(L, StageMap{n2, n1, 1, n2, 1, n2, 1, n2}, m.f2r, m.f2i, m.ld2,
               d.twr, d.twi, true);
    long_stage(L, StageMap{n1, n2, n2, 1, n2, 1, 0, 0}, m.f1r, m.f1i, m.ld1,
               nullptr, nullptr, false);
  }
}

// One tail tile: C lines of B points, s[c * B + q] (swizzled on the
// Stockham route). Loads its runs (an inverse-only op from natural order,
// filtered there), runs the forward, the filter at natural indices and the
// inverse, and stores (a forward-only op to natural order). Neighbouring
// threads take neighbouring points of a row where the run is contiguous,
// neighbouring lines otherwise.
template <bool kStockham>
__device__ __forceinline__ void tail_tile(float2* s, const Mats& m,
                                          const LongOp& op, const Pass& p,
                                          long long t) {
  const int B = op.d.n, C = op.lg.tail_tile;
  const int total = C * B;
  const long long stride = op.axis == 1 ? 1 : op.lines;
  const bool perm_in = !op.fwd, perm_out = !op.inv;
  const bool filt = op.f.mode != kNone;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    int c, q;
    if (op.axis == 0 || perm_in) { q = i / C; c = i - q * C; }
    else { c = i / B; q = i - c * B; }
    const TailLine r = tail_line(op, t, c);
    float2 v = make_float2(0.0f, 0.0f);
    if (r.valid) {
      if (perm_in) {
        const int k = tail_k<kStockham>(op, r, q);
        const long long e = r.nat + k * stride;
        v = make_float2(__ldcg(p.sr + e), __ldcg(p.si + e));
        if (filt) v = apply_filter(v, op.f, r.line, k);
      } else {
        const long long e = r.pos + q * stride;
        v = make_float2(__ldcg(p.sr + e), __ldcg(p.si + e));
      }
    }
    s[kStockham ? swz(c * B + q) : c * B + q] = v;
  }
  __syncthreads();
  const Lines L{s, C, B, B, 1};
  if (op.fwd) {
    tail_transform<kStockham>(L, op.d, m, false);
    if (filt) {
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        const int c = i / B, q = i - c * B;
        const TailLine r = tail_line(op, t, c);
        if (!r.valid) continue;
        float2* e = s + (kStockham ? swz(i) : i);
        *e = apply_filter(*e, op.f, r.line, tail_k<kStockham>(op, r, q));
      }
      __syncthreads();
    }
  }
  if (op.inv) tail_transform<kStockham>(L, op.d, m, true);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    int c, q;
    if (op.axis == 0 || perm_out) { q = i / C; c = i - q * C; }
    else { c = i / B; q = i - c * B; }
    const TailLine r = tail_line(op, t, c);
    if (!r.valid) continue;
    const float2 v = s[kStockham ? swz(c * B + q) : c * B + q];
    const long long e = perm_out
                            ? r.nat + tail_k<kStockham>(op, r, q) * stride
                            : r.pos + q * stride;
    p.dr[e] = v.x;
    p.di[e] = v.y;
  }
  __syncthreads();   // the next tile's load overwrites s
}

// Every pass of one long op at f32, a grid barrier between two (the
// caller's grid is cooperative). Out of line: its registers are its own,
// whatever the kernel that calls it.
template <bool kStockham>
__device__ __noinline__ void long_op(float2* s, const LongOp& op) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int np = long_pass_count(op);
  for (int k = 0; k < np; ++k) {
    if (k) grid.sync();
    const Pass p = long_pass(op, k);
    if (p.kind == kFilterOnly) {
      filter_only(op, p, LongForm{});
      continue;
    }
    Mats m{};
    if constexpr (!kStockham) m = long_mats(s, op, p);
    const long long tiles = long_pass_tiles(op, p);
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      if (p.kind == kTail) {
        tail_tile<kStockham>(s, m, op, p, t);
      } else {
        digit_tile<kStockham>(s, m, op, p, PassForm{}, LongForm{}, t);
      }
    }
  }
}

// long_op at the other forms: every pass of one long op, a grid barrier
// between two, bs16's reduction phase first. kOp, kKara: the matmul
// route's operand form (kKara 0 never, 2 as the form's kara); the 16-bit
// forms run the natural schedule. kBs: the bs16 codec. Out of line
// likewise.
template <bool kStockham, int kOp, int kKara, bool kBs>
__device__ __noinline__ void long_op_form(float2* s, const LongOp& op,
                                          const LongForm form) {
  static_assert(!kStockham || (kOp == kTf32x3 && kKara == 0),
                "the Stockham route has no matrix operands");
  constexpr bool kNat = !kStockham && kOp != kTf32x3;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if constexpr (kBs) {
    long_amax(s, op, form);
    grid.sync();
  }
  const int np = kNat ? long_pass_count_natural(op) : long_pass_count(op);
  for (int k = 0; k < np; ++k) {
    if (k) grid.sync();
    const Pass p = kNat ? long_pass_natural(op, k) : long_pass(op, k);
    const PassForm pf = kNat || kBs ? pass_form<kNat>(op, k) : PassForm{};
    if (p.kind == kFilterOnly) {
      filter_only<kBs>(op, p, form);
      continue;
    }
    Mats m{};
    if constexpr (!kStockham) m = long_mats(s, op, p);
    const long long tiles = long_pass_tiles(op, p);
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      if (p.kind == kTail) {
        tail_tile_form<kStockham, kOp, kKara, kBs>(s, m, op, p, pf, form, t);
      } else {
        digit_tile<kStockham, kOp, kKara, kBs>(s, m, op, p, pf, form, t);
      }
    }
  }
}

// One segment of a (batch, na, nr) scene past one block, as mega_staged
// runs it (out of line, so that the kernel's own register allocation is
// what it was without it).
template <bool kStockham>
__device__ __noinline__ void long_segment(float2* s, const Segment& g,
                                          const float* xr, const float* xi,
                                          float* yr, float* yi, int batch,
                                          int na, int nr) {
  long_op<kStockham>(s, long_op_of(g, xr, xi, yr, yi, batch, na, nr));
}

// The same at another form (its words and the segment's Karatsuba).
template <bool kStockham, int kOp, int kKara, bool kBs>
__device__ __noinline__ void long_segment_form(float2* s, const Segment& g,
                                               const float* xr,
                                               const float* xi, float* yr,
                                               float* yi, int batch, int na,
                                               int nr, unsigned* ex) {
  long_op_form<kStockham, kOp, kKara, kBs>(
      s, long_op_of(g, xr, xi, yr, yi, batch, na, nr), LongForm{ex, g.kara});
}

// Launch `kernel` (one argument struct, kLongThreads threads) cooperatively
// on as many blocks as the card holds at once, at most `work`.
template <class A>
cudaError_t launch_cooperative(void (*kernel)(A), A& a, int threads,
                               size_t smem, long long work,
                               cudaStream_t stream) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = (int)std::max(1LL, std::min((long long)per_sm * sms,
                                               work));
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(threads), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The passes on a resident slab (mega_resident past one block)
// ---------------------------------------------------------------------------
//
// mega_resident's segments past one block (a line of 8192 or 16384 points,
// or a three-factor split, on a slab of at most 16384 points): the passes
// above, in place on the slab in shared memory. The slab of `batch` scenes
// is the op's device-memory layout itself ((batch, lines, n) rows,
// (batch, n, lines) columns; the Stockham route's swizzled, element e at
// swz(e)), so every pass reads and writes the places it would in device
// memory, through the same decomposition (long_geometry's digits, their
// tiles' sub-lines, the tail's runs) and, point for point, the operations
// of its tile function (digit_tile, tail_tile_form) in the same order:
//   - each transform runs the same stage (long_stage, long_stage_form: a
//     digit's f-point stage with the slab's sub-lines as its columns, the
//     tail's stages with its runs as the lines, the slab's strides in the
//     StageMap) or Stockham op (stockham_op on the slab's strided lines),
//     and reads its DFT matrices and twiddle tables from device memory in
//     place, as mega_resident always has;
//   - what a tile function does on a load or a store besides moving a
//     point (a twiddle, the filter, the inverse's conjugate and 1/N) is a
//     pass over the slab's points in place (slab_points), and a move that
//     crosses the places of one tile (the two-stage digit's transposed
//     order back to the natural one; the tail's turns between the runs'
//     order and the natural one, which one-direction ops and the natural
//     schedule take through device memory's scratch slab) goes through
//     registers between two barriers, up to 32 points a thread
//     (slab_move);
//   - bs16 codes the op's lines once on entry, each (scene, line)'s
//     exponent from its amax inside the block (lines_encode, no grid
//     barrier), and decodes them once on exit: point for point, the
//     reduction phase's 2^-e on the op's first load and 2^e on its last
//     store.
// So a long op on the slab equals spectral_long and mega_staged's long
// phases bit for bit; no scratch slab and no grid barrier.

// Points a thread holds in a slab move: 16384 points at 512 threads.
constexpr int kSlabPerThread = 32;

// slab_points' kinds: digit_tile's load besides the move (the natural
// schedule's filter and conjugate on digit 0, the inverse's twiddle),
// its store (the forward's twiddle, the inverse's closing conjugate and
// 1/N on the last pass), the tail's filter at each point's natural index,
// and the natural schedule's closing conjugate and 1/N on the tail.
enum SlabPoints { kPtsDigitIn = 0, kPtsDigitOut = 1, kPtsTailFilter = 2,
                  kPtsTailScale = 3 };
// slab_move's kinds: the two-stage digit's transposed order to the natural
// one in each sub-line; the tail's load from natural order into the runs'
// order (an inverse-only op); its store from the runs' order to natural
// order (a forward-only op, the natural schedule).
enum SlabMove { kMoveDigit = 0, kMoveTailIn = 1, kMoveTailOut = 2 };

// Element e of the slab (the Stockham route's swizzled).
template <bool kSwz>
__device__ __forceinline__ float2* slab_at(float2* s, int e) {
  return s + (kSwz ? swz(e) : e);
}

// Points of the op's slab.
__device__ __forceinline__ int slab_total(const LongOp& op) {
  return op.batch * op.lines * op.n;
}

// Point o of a digit pass: its sub-scene, its position q in the sub-line
// (points sub apart) and its sub-line j (the tile function's e = scene *
// f * sub + q * sub + j is o itself).
__device__ __forceinline__ void digit_point(const LongOp& op, int digit,
                                            int o, int& scene, int& q,
                                            int& j) {
  const int f = op.lg.dig[digit].f;
  const int sub = digit_rest(op, digit) * (op.axis == 1 ? 1 : op.lines);
  scene = o / (f * sub);
  const int rem = o - scene * f * sub;
  q = rem / sub;
  j = rem - q * sub;
}

// Point o of a tail pass: its run (tail_line, as the tail tile that holds
// it numbers it) and its position q in the run (o = r.pos + q * stride).
__device__ __forceinline__ TailLine slab_tail_line(const LongOp& op, int o,
                                                   int& q) {
  const int B = op.d.n, C = op.lg.tail_tile;
  if (op.axis == 1) {
    const int run = o / B;
    q = o - run * B;
    return tail_line(op, run / C, run % C);
  }
  const int span = B * op.lines;
  const int sc = o / span;
  const int rem = o - sc * span;
  q = rem / op.lines;
  const int l = rem - q * op.lines;
  const long long tps = (op.lines + C - 1) / C;
  return tail_line(op, sc * tps + l / C, l % C);
}

// The natural element of tail point o (its run's natural index of q).
template <bool kStockham>
__device__ __forceinline__ int tail_natural(const LongOp& op, int o) {
  int q;
  const TailLine r = slab_tail_line(op, o, q);
  return (int)(r.nat +
               (long long)tail_k<kStockham>(op, r, q) *
                   (op.axis == 1 ? 1 : op.lines));
}

// One pass over the slab's points in place (kind: SlabPoints), each with
// its tile function's operations, then a barrier.
template <bool kStockham, bool kNat>
__device__ __noinline__ void slab_points(float2* s, const LongOp& op,
                                         const Pass& p, const PassForm& pf,
                                         int kind) {
  const int total = slab_total(op);
  const bool inverse = p.kind == kDigitInv;
  const float scale = inverse_scale(p.last, op.n);
  const int ldiv = op.axis == 1 ? 1 : op.lines;
  const bool digit = kind == kPtsDigitIn || kind == kPtsDigitOut;
  const Digit& g = op.lg.dig[digit ? p.digit : 0];
  const int rest = digit ? digit_rest(op, p.digit) : 1;
  for (int o = threadIdx.x; o < total; o += blockDim.x) {
    float2* e = slab_at<kStockham>(s, o);
    float2 v = *e;
    if (digit) {   // k: the point's natural position in its sub-line
      int scene, k, j;
      digit_point(op, p.digit, o, scene, k, j);
      const int w = k * rest + j / ldiv;
      if (kind == kPtsDigitIn) {
        if constexpr (kNat) {
          if (pf.filt_in) {
            const DigitPoint dp = digit0_point(op, scene, k, j, rest);
            v = apply_filter(v, op.f, dp.line, dp.k);
          }
          if (pf.conj_in) v.y = -v.y;   // exact
        }
        if (inverse) v = cmul(v, __ldg(g.twr + w), __ldg(g.twi + w));
      } else {
        if (!inverse) v = cmul(v, __ldg(g.twr + w), __ldg(g.twi + w));
        if (p.last) {
          v = make_float2(__fmul_rn(v.x, scale), __fmul_rn(v.y, -scale));
        }
      }
    } else if (kind == kPtsTailFilter) {
      int q;
      const TailLine r = slab_tail_line(op, o, q);
      v = apply_filter(v, op.f, r.line, tail_k<kStockham>(op, r, q));
    } else {
      v = make_float2(__fmul_rn(v.x, scale), __fmul_rn(v.y, -scale));
    }
    *e = v;
  }
  __syncthreads();
}

// Where slab_move takes point o from (kMoveTailIn, a gather) or puts it
// (the others, a scatter).
template <bool kStockham>
__device__ __forceinline__ int move_index(const LongOp& op, int digit,
                                          int kind, int o) {
  if (kind != kMoveDigit) return tail_natural<kStockham>(op, o);
  const Digit& g = op.lg.dig[digit];
  int scene, q, j;
  digit_point(op, digit, o, scene, q, j);
  const int sub = digit_rest(op, digit) * (op.axis == 1 ? 1 : op.lines);
  return scene * g.f * sub + from_transposed(q, g.f / g.fb, g.fb) * sub + j;
}

// One move of the slab's points (kind: SlabMove) through registers: every
// point read, a barrier, every point written, a barrier. Moves are exact.
template <bool kStockham>
__device__ __noinline__ void slab_move(float2* s, const LongOp& op,
                                       int digit, int kind) {
  const int total = slab_total(op);
  const bool gather = kind == kMoveTailIn;
  float2 v[kSlabPerThread];
#pragma unroll
  for (int i = 0; i < kSlabPerThread; ++i) {
    const int o = threadIdx.x + i * blockDim.x;
    if (o < total) {
      v[i] = *slab_at<kStockham>(
          s, gather ? move_index<kStockham>(op, digit, kind, o) : o);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSlabPerThread; ++i) {
    const int o = threadIdx.x + i * blockDim.x;
    if (o < total) {
      *slab_at<kStockham>(
          s, gather ? o : move_index<kStockham>(op, digit, kind, o)) = v[i];
    }
  }
  __syncthreads();
}

// Forward (fwd) or, conjugated on the read and not after, the inverse's
// (inv) Stockham transform of every line of L in place on the slab (the
// tail's and a digit's, as stockham_lines runs them on a tile), no filter,
// 16 points a thread in rounds of the lines the block holds (the ops of
// 32 points a thread are not built for the long chains' kernel).
template <bool kLineFast>
__device__ __forceinline__ void slab_stockham(const Lines& L,
                                              const float2* stw, bool fwd,
                                              bool inv) {
  const Filter none{};
  const int units = L.n / kPerThread;
  const int round = units > 0 ? (int)blockDim.x / units
                              : (int)blockDim.x * kPerThread / L.n;
  for (int line0 = 0; line0 < L.lines; line0 += round) {
    stockham_op<kLineFast, false, 0, false, false>(
        L, Io{}, stw, fwd, inv, none, 0, L.lines, 1.0f, 1.0f,
        LineSync{0, 0}, line0, kPerThread);
  }
}

// Digit pass p on the slab: digit_tile's load besides the move, the f-point
// transforms of every sub-line in place (the Stockham route's forward; the
// matmul route's one stage — with the sub-lines of all sub-scenes as its
// columns where one round of the stage takes a sub-scene's, else a
// sub-scene at a time — or, f32 past 16 points, two stages on each
// sub-scene's sub-lines and the move back to natural order), its store.
template <bool kStockham, int kOp, int kKara>
__device__ __forceinline__ void slab_digit(float2* s, const LongOp& op,
                                           const Pass& p, const PassForm& pf,
                                           bool kara) {
  constexpr bool kNat = !kStockham && kOp != kTf32x3;
  const Digit& g = op.lg.dig[p.digit];
  const int f = g.f, fb = kStockham ? 1 : g.fb, fa = f / fb;
  const int sub = digit_rest(op, p.digit) * (op.axis == 1 ? 1 : op.lines);
  const int scenes = slab_total(op) / (f * sub);
  const bool inverse = p.kind == kDigitInv;
  if (inverse || (kNat && (pf.filt_in || pf.conj_in))) {
    slab_points<kStockham, kNat>(s, op, p, pf, kPtsDigitIn);
  }
  if constexpr (kStockham) {
    for (int sc = 0; sc < scenes; ++sc) {
      slab_stockham<true>(Lines{s + sc * f * sub, sub, f, 1, sub}, g.stw,
                          true, false);
    }
  } else if (fb == 1) {
    const int cap = ((int)blockDim.x / 32 / ((f + 15) / 16)) * kGroupCols;
    if (sub <= cap) {
      //                                              nf nq  sk  sq om  oq
      form_stage<kOp, kKara>(kara, Lines{s, scenes, f * sub, f * sub, 1},
                             StageMap{f, sub, sub, 1, sub, 1, 0, 0}, g.fr,
                             g.fi, f, nullptr, nullptr, false);
    } else {
      for (int sc = 0; sc < scenes; ++sc) {
        form_stage<kOp, kKara>(kara,
                               Lines{s + sc * f * sub, sub / cap, cap, cap,
                                     1},
                               StageMap{f, cap, sub, 1, sub, 1, 0, 0}, g.fr,
                               g.fi, f, nullptr, nullptr, false);
      }
    }
  } else if constexpr (kOp == kTf32x3) {   // stages_n1n2's maps
    for (int sc = 0; sc < scenes; ++sc) {
      const Lines L{s + sc * f * sub, sub, f, 1, 1};
      form_stage<kOp, kKara>(
          kara, L, StageMap{fa, fb, fb * sub, sub, sub, fa * sub, fb, 1},
          g.fr, g.fi, fa, g.itwr, g.itwi, false);
      form_stage<kOp, kKara>(
          kara, L, StageMap{fb, fa, fa * sub, sub, sub, fb * sub, 0, 0},
          g.fbr, g.fbi, fb, nullptr, nullptr, false);
    }
    slab_move<false>(s, op, p.digit, kMoveDigit);
  } else {
    __trap();   // the 16-bit forms take one stage (unpack_segment)
  }
  if (!inverse || p.last) {
    slab_points<kStockham, kNat>(s, op, p, pf, kPtsDigitOut);
  }
}

// The tail's B-point transform of every run on the slab (tail_transform's,
// forward or the inverse's without its closing conjugate and 1/N): rows
// all runs at once (B apart), columns the runs of one (scene, run
// position) at a time (lines adjacent, points `lines` apart, the stages'
// maps scaled by that stride).
template <bool kStockham, int kOp, int kKara>
__device__ __noinline__ void slab_tail_transform(float2* s, const LongOp& op,
                                                 bool inverse, bool kara) {
  const Dft& d = op.d;
  const int B = d.n;
  const bool rows = op.axis == 1;
  const int views = rows ? 1 : op.batch * (op.n / B);
  const int lines = rows ? slab_total(op) / B : op.lines;
  const int es = rows ? 1 : op.lines;
  for (int v = 0; v < views; ++v) {
    float2* base = s + v * B * op.lines;
    if constexpr (kStockham) {
      if (rows) {
        slab_stockham<false>(Lines{base, lines, B, B, 1}, d.stw, !inverse,
                             inverse);
      } else {
        slab_stockham<true>(Lines{base, lines, B, 1, es}, d.stw, !inverse,
                            inverse);
      }
    } else {
      const Lines L{base, lines, B, rows ? B : 1, 1};
      const int n1 = d.n1, n2 = d.n2;
      if (n2 == 1) {   // one factor: a line a column
        form_stage<kOp, kKara>(kara, L, StageMap{B, 1, es, 0, es, 0, 0, 0},
                               d.f1r, d.f1i, B, nullptr, nullptr, inverse);
      } else if (!inverse) {
        //                      nf  nq  sk       sq  om  oq       twm twq
        form_stage<kOp, kKara>(kara, L,
                               StageMap{n1, n2, n2 * es, es, es, n1 * es,
                                        n2, 1},
                               d.f1r, d.f1i, n1, d.twr, d.twi, false);
        form_stage<kOp, kKara>(kara, L,
                               StageMap{n2, n1, n1 * es, es, es, n2 * es, 0,
                                        0},
                               d.f2r, d.f2i, n2, nullptr, nullptr, false);
      } else {
        form_stage<kOp, kKara>(kara, L,
                               StageMap{n2, n1, es, n2 * es, es, n2 * es, 1,
                                        n2},
                               d.f2r, d.f2i, n2, d.twr, d.twi, true);
        form_stage<kOp, kKara>(kara, L,
                               StageMap{n1, n2, n2 * es, es, n2 * es, es, 0,
                                        0},
                               d.f1r, d.f1i, n1, nullptr, nullptr, false);
      }
    }
  }
}

// Tail pass p on the slab (tail_tile_form's): an inverse-only op's move
// from natural order and its filter there, the forward and the filter at
// natural indices, the inverse, and the move to natural order where the
// op or the natural schedule stores it there (the inverse's last with its
// closing conjugate and 1/N).
template <bool kStockham, int kOp, int kKara>
__device__ __forceinline__ void slab_tail(float2* s, const LongOp& op,
                                          const Pass& p, const PassForm& pf,
                                          bool kara) {
  constexpr bool kNat = !kStockham && kOp != kTf32x3;
  const bool tfwd = kNat || op.fwd;
  const bool tinv = !kNat && op.inv;
  const bool perm_in = !kNat && !op.fwd;
  const bool perm_out = kNat || !op.inv;
  const bool filt = (kNat ? pf.filt : true) && op.f.mode != kNone;
  if (perm_in) {
    slab_move<kStockham>(s, op, 0, kMoveTailIn);
    if (filt) slab_points<kStockham, kNat>(s, op, p, pf, kPtsTailFilter);
  }
  if (tfwd) {
    slab_tail_transform<kStockham, kOp, kKara>(s, op, false, kara);
    if (filt) slab_points<kStockham, kNat>(s, op, p, pf, kPtsTailFilter);
  }
  if (tinv) slab_tail_transform<kStockham, kOp, kKara>(s, op, true, kara);
  if (perm_out) {
    if (kNat && p.last) {
      slab_points<kStockham, kNat>(s, op, p, pf, kPtsTailScale);
    }
    slab_move<kStockham>(s, op, 0, kMoveTailOut);
  }
}

// bs16's codec on the op's lines of the slab: encode (each line's
// exponent into ex, the line scaled by 2^-e) or decode (by 2^e).
template <bool kStockham>
__device__ __noinline__ void slab_codec(float2* s, const LongOp& op, int* ex,
                                        bool encode) {
  if (op.axis == 1) {
    const Lines L{s, op.batch * op.lines, op.n, op.n, 1};
    if (encode) {
      lines_encode<false, kStockham>(L, ex);
    } else {
      lines_decode<false, kStockham>(L, ex);
    }
    return;
  }
  for (int b = 0; b < op.batch; ++b) {
    const Lines L{s + b * op.n * op.lines, op.lines, op.n, 1, op.lines};
    if (encode) {
      lines_encode<true, kStockham>(L, ex + b * op.lines);
    } else {
      lines_decode<true, kStockham>(L, ex + b * op.lines);
    }
  }
}

// Every pass of one long op on the resident slab, in long_op's (f32) or
// the natural schedule's (the matmul route's 16-bit forms) order, bs16's
// codec around them (ex: a word a (scene, line)). kOp, kKara: as
// long_op_form's, `kara` the segment's. Out of line, so that mega_resident's
// one-block segments keep their register allocation.
template <bool kStockham, int kOp, int kKara, bool kBs>
__device__ __noinline__ void resident_long_op(float2* s, const LongOp& op,
                                              bool kara, int* ex) {
  static_assert(!kStockham || (kOp == kTf32x3 && kKara == 0),
                "the Stockham route has no matrix operands");
  constexpr bool kNat = !kStockham && kOp != kTf32x3;
  if constexpr (kBs) slab_codec<kStockham>(s, op, ex, true);
  const int np = kNat ? long_pass_count_natural(op) : long_pass_count(op);
  for (int k = 0; k < np; ++k) {
    const Pass p = kNat ? long_pass_natural(op, k) : long_pass(op, k);
    const PassForm pf = kNat ? pass_form<true>(op, k) : PassForm{};
    if (p.kind == kTail) {
      slab_tail<kStockham, kOp, kKara>(s, op, p, pf, kara);
    } else {
      slab_digit<kStockham, kOp, kKara>(s, op, p, pf, kara);
    }
  }
  if constexpr (kBs) slab_codec<kStockham>(s, op, ex, false);
}

}  // namespace spectral
