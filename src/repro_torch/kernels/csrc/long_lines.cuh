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
// (long_op_form<kStockham, kOp, kKara, kBs>; the f32 form <kStockham,
// kTf32x3, 0, false> is spectral.cu's spectral_long and mega_long.cu's),
// with the codec's words and the Karatsuba flag beside the op (LongForm).
//
// What bounds it, and the design. The bytes bound is the slab read and
// written once (16 B a point): 0.641 ms for the 8192 x 16384 scene at
// 3.35 TB/s. Passes over device memory multiply it (the range launch, D =
// 1 fwd + inv, made three), and one-tile-a-block scalar I/O ran each pass
// at 2.7-3.9x its bytes (PERF.md). So:
//   - on the rows layout with one digit and 4096 <= N <= 16384 every pass
//     runs in a whole-line tile (below): one read and one write of the
//     slab, no scratch slab, no grid barrier, bs16 without a reduction
//     phase;
//   - the passes that remain (the columns layout, shorter lines, lines
//     past 16384, two digits) move 4 points of a plane in one 16-byte
//     access along each run of contiguous points (digit_tile,
//     tail_tile_form, filter_only), the Stockham route's column tails 4
//     lines a tile (one 16-byte run a row; 2 lines used a quarter of each
//     32-byte sector);
//   - where the segment asks for it (Long::ring), their tiles' loads go
//     through an asynchronous ring (pass_ring): two slots past the tile,
//     cp.async.cg 16 bytes a copy, tile i + 2's copies issued once tile
//     i's points are in the tile, so two tiles' loads are in flight while
//     a tile's stages and stores run; the host sizes the tiles for it
//     (8192 points: 64 KiB of tile and 128 KiB of slots). The Stockham
//     column tail's 4 lines of 4096 points (128 KiB, its slots 256 KiB
//     more) do not fit beside it and load without. The port asks for it
//     nowhere: on the H100 every op measured ran 5-62 % slower with it
//     (its tiles halved, its slots in L1's place);
//   - the matmul route's digit rows sit digit_pad points apart in shared
//     memory (the stages' reads down the sub-lines had hit one bank pair
//     16 ways); past the bytes it is bound by its 3xTF32 mma.sync stages
//     (the MMA floor).
// The ring's times against the same passes without it, and what bounds
// each pass, are in PERF.md; a thread-block-cluster form holding a column line or a
// line past 16384 points in distributed shared memory, and wgmma, are
// later work (ROADMAP, Queue 2).
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "async_copy.cuh"
#include "spectral_common.cuh"

namespace spectral {

constexpr int kMaxDigits = 2;
constexpr int kLongThreads = 512;   // both routes
constexpr int kDigitFields = 12;    // int64 fields of a digit in a record
constexpr int kSegFields = 33 + kMaxDigits * kDigitFields;
// Whole-line tiles (line_plan, "Whole lines in one tile" below).
constexpr long long kSmemOptin = 232448;   // a block's opt-in, sm_90
constexpr int kLineMaxN = 16384;           // 128 KiB of f32 points
constexpr int kLineMinN = 4096;            // a line fills the block
constexpr int kLinePerThread = 32;         // kLineMaxN at kLongThreads
constexpr int kLineLoads = 8;              // 16-byte loads a plane in flight

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
// tail's lines a tile, whether its tiles' loads take the asynchronous ring
// (pass_ring), and the scratch slab (forward-only or inverse-only).
struct Long {
  int on, ndev, tail_tile, ring;
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


// Bytes of a digit's DFT matrices (stages_n1n2's pair, or the one f x f
// matrix of a one-stage digit) and of the tail's (one matrix for one
// factor), as long_mats copies them.
__host__ __device__ inline long long digit_mats_bytes(const Digit& g) {
  return 4LL * (g.fb > 1 ? dft_smem_floats(g.f / g.fb, g.fb)
                         : dft_smem_floats(g.f, g.f));
}

__host__ __device__ inline long long tail_mats_bytes(const Dft& d) {
  return 4LL * (d.n2 > 1 ? dft_smem_floats(d.n1, d.n2)
                         : dft_smem_floats(d.n, d.n));
}

// Tile I/O in 16-byte groups (below): a thread's loads in flight, and the
// least points of a tile that takes them (132 x 128^2 at (8, 4, 4),
// 128-point tiles: 2.16 ms on the one-point loop against 3.09 in 16-byte
// groups, PERF.md).
constexpr int kTileLoads = 4;
constexpr int kTileVecPoints = 2048;
// Slots of the asynchronous ring (pass_ring).
constexpr int kRingSlots = 2;

// Points between the matmul route's digit rows in shared memory past the
// C sub-lines of a digit tile (or the B points of a whole line's row): the
// stage's B fragments read 8 or 16 points down the sub-lines a k-step,
// which a row of 64 or 128 points (a multiple of 32 banks) put on one
// bank pair, 16 ways a half-warp; one point more (two stages) or four
// (one) spreads them over 2-4 (one stage: none). The Stockham route
// swizzles instead.
__host__ __device__ inline int digit_pad(const Digit& g, bool stockham) {
  return stockham ? 0 : g.fb > 1 ? 1 : 4;
}

// Whether a long op runs as whole-line tiles (rows of one digit, 4096 to
// 16384 points: a shorter line leaves most of a tile a line idle, where
// the passes' tail tiles hold many; 132 x 128^2 at (8, 4, 4) ran 1.9x
// slower whole-line, PERF.md), and its shared memory: the
// line (its rows digit_pad points apart), bs16's words, then (matmul) the
// digit's matrices and the tail's, each where it fits beside what comes
// before it.
struct LinePlan {
  bool on, dig_smem, tail_smem;
  long long bytes;
};

__host__ __device__ inline LinePlan line_plan(const LongOp& op,
                                              bool stockham, bool bs) {
  LinePlan pl{false, false, false, 0};
  if (!(op.fwd || op.inv) || op.axis != 1 || op.lg.ndev != 1 ||
      op.n > kLineMaxN || op.n < kLineMinN) {
    return pl;
  }
  const Digit& g = op.lg.dig[0];
  long long b = 8LL * (stockham ? stockham_points(op.n)
                                : op.n + g.f * digit_pad(g, false)) +
                (bs ? 4LL * kAmaxWords : 0LL);
  if (!stockham) {
    const long long dm = digit_mats_bytes(g);
    pl.dig_smem = b + dm <= kSmemOptin;
    if (pl.dig_smem) b += dm;
    const long long tm = tail_mats_bytes(op.d);
    pl.tail_smem = b + tm <= kSmemOptin;
    if (pl.tail_smem) b += tm;
  }
  pl.on = b <= kSmemOptin;
  pl.bytes = b;
  return pl;
}

// Points of pass p's tile (a digit's f x C, the tail's C lines of B).
__host__ __device__ inline long long pass_tile_points(const LongOp& op,
                                                      const Pass& p) {
  if (p.kind == kTail) return (long long)op.d.n * op.lg.tail_tile;
  const Digit& g = op.lg.dig[p.digit];
  return (long long)g.f * g.tile;
}

// Bytes of pass p's tile in shared memory (a digit's rows digit_pad points
// apart; the Stockham route's rounded up to whole runs of 16 points) and,
// on the matmul route, the DFT matrices long_mats puts past it.
__host__ __device__ inline long long pass_tile_bytes(const LongOp& op,
                                                     const Pass& p,
                                                     bool stockham) {
  long long pts = pass_tile_points(op, p);
  long long mats = 0;
  if (p.kind == kTail) {
    mats = tail_mats_bytes(op.d);
  } else {
    const Digit& g = op.lg.dig[p.digit];
    pts += (long long)g.f * digit_pad(g, stockham);
    mats = digit_mats_bytes(g);
  }
  return stockham ? 8LL * stockham_points((int)pts) : 8LL * pts + mats;
}

// The asynchronous ring of a tile pass: kRingSlots slots past the tile and
// its matrices (16-byte aligned), each a tile's points as device memory
// holds them, its re plane then its im plane (8 bytes a point). The
// segment asks for it (Long::ring); a pass takes it where its tiles reach
// kTileVecPoints points and the slots fit beside the tile in a block's
// opt-in. ring_at: the slots' first byte; ring_bytes: what they add past
// the tile, 0 where the pass takes no ring.
__host__ __device__ inline long long ring_at(long long tile_bytes) {
  return (tile_bytes + 15) / 16 * 16;
}

__host__ __device__ inline long long ring_bytes(const LongOp& op,
                                                const Pass& p,
                                                bool stockham) {
  const long long pts = pass_tile_points(op, p);
  if (!op.lg.ring || p.kind == kFilterOnly || pts < kTileVecPoints) return 0;
  const long long before = pass_tile_bytes(op, p, stockham);
  const long long end = ring_at(before) + kRingSlots * 8LL * pts;
  return end <= kSmemOptin ? end - before : 0;
}

// A segment from its record (kSegFields int64: axis, fwd, inv, mode, rank,
// n, n1, n2, tile, f1r, f1i, f2r, f2i, twr, twi, hr, hi, h_line, h_k, u, v,
// u_line, u_k, v_n, v_k, stw, kara, then on, ndev, tail_tile, ring, sr, si
// and,
// per digit, f, tile, fb, fr, fi, fbr, fbi, itwr, itwi, stw, twr, twi).
// n_line: the length of the segment's lines in the scene; op: the launch's
// operand form (the matmul route's 16-bit forms take one stage a digit and
// a scratch slab in every direction); bs: the bs16 codec; resident:
// mega_resident's record, whose long passes run on its slab and take no
// scratch slab. Checks what the kernels rely on.
inline cudaError_t unpack_segment(const long long* r, int n_line,
                                  Segment& g, int op = kTf32x3,
                                  bool bs = false, bool resident = false) {
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
  lg.ring = (int)r[30];
  lg.sr = const_cast<float*>(as_ptr<float>(r[31]));
  lg.si = const_cast<float*>(as_ptr<float>(r[32]));
  for (int i = 0; i < kMaxDigits; ++i) {
    const long long* q = r + 33 + kDigitFields * i;
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
  // whole-line tiles move their lines in shared memory: the kernels' own
  // rule (line_plan), on the segment's lines
  const bool whole =
      line_plan(long_op_of(g, nullptr, nullptr, nullptr, nullptr, 1, n_line,
                           n_line),
                stockham, bs)
          .on;
  if (lg.ndev < 1 || lg.ndev > kMaxDigits || lg.tail_tile < 1 ||
      (resident ? scratch
                : (!whole && (nat || g.fwd != g.inv)) != scratch)) {
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
        (long long)g.d.n * lg.tail_tile > kLinePerThread * kLongThreads) {
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

// Shared memory of a long op's largest pass (its tile, the matmul route's
// DFT matrices, its ring); with bs, at least the reduction's words.
inline size_t long_smem(const LongOp& op, bool stockham, bool bs = false) {
  const long long least = bs ? kAmaxWords * sizeof(unsigned) : 0;
  if (!(op.fwd || op.inv)) return (size_t)least;
  const LinePlan pl = line_plan(op, stockham, bs);
  if (pl.on) return (size_t)pl.bytes;
  long long out = least;
  for (int k = -1; k < op.lg.ndev; ++k) {   // the tail, then each digit
    const Pass p{k < 0 ? kTail : kDigitFwd, k < 0 ? 0 : k};
    out = std::max(out, pass_tile_bytes(op, p, stockham) +
                            ring_bytes(op, p, stockham));
  }
  return (size_t)out;
}

// The most tiles of any pass (the cooperative grid's useful size; the
// natural schedule runs the same kinds of pass).
inline long long long_work(const LongOp& op) {
  if (line_plan(op, false, false).on) {   // a tile a line, no barrier
    return (long long)op.batch * op.lines;
  }
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

// Tile I/O of the passes: 4 points of a plane in one 16-byte access where
// the tile's run of points is contiguous (a digit tile's sub-lines, a
// tail tile's runs along a row or its lines side by side in the columns
// layout), the tile's groups either staged by the ring (pass_ring) or
// loaded by the tile function, a thread's kTileLoads groups in flight
// before their points' operations and shared-memory stores; the one-point
// loop where the layout does not allow it (a ragged or unaligned run, a
// permuted side), and for tiles under kTileVecPoints points, which the
// one-point loop moves faster. A move is exact either way.

__device__ __forceinline__ void load4(const float* r, const float* i,
                                      long long e, float4& a, float4& b) {
  a = __ldcg(reinterpret_cast<const float4*>(r + e));
  b = __ldcg(reinterpret_cast<const float4*>(i + e));
}

__device__ __forceinline__ float2 lane4(const float4& a, const float4& b,
                                        int m) {
  return m == 0   ? make_float2(a.x, b.x)
         : m == 1 ? make_float2(a.y, b.y)
         : m == 2 ? make_float2(a.z, b.z)
                  : make_float2(a.w, b.w);
}

__device__ __forceinline__ void store4(float* r, float* i, long long e,
                                       const float2 (&v)[4]) {
  *reinterpret_cast<float4*>(r + e) =
      make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
  *reinterpret_cast<float4*>(i + e) =
      make_float4(v[0].y, v[1].y, v[2].y, v[3].y);
}

// Whether a pass's planes take 16-byte accesses.
__device__ __forceinline__ bool planes16(const Pass& p) {
  return aligned16(p.sr) && aligned16(p.si) && aligned16(p.dr) &&
         aligned16(p.di);
}

// Where tile t of digit pass p lies: its sub-scene, sub-lines [j0, j0 + C)
// of it at `off`, point k of sub-line j at off + k * sub + j (rest: the
// digit's stride R_i; ldiv: a columns layout's sub-line is (r, line)).
struct DigitAt {
  int f, C, rest, ldiv;
  long long sub, scene, j0, off;
};

__device__ __forceinline__ DigitAt digit_at(const LongOp& op, const Pass& p,
                                            long long t) {
  const Digit& g = op.lg.dig[p.digit];
  DigitAt d;
  d.f = g.f;
  d.C = g.tile;
  d.rest = digit_rest(op, p.digit);
  d.ldiv = op.axis == 1 ? 1 : op.lines;
  d.sub = (long long)d.rest * d.ldiv;
  const long long tps = (d.sub + d.C - 1) / d.C;
  d.scene = t / tps;
  d.j0 = (t - d.scene * tps) * d.C;
  d.off = d.scene * d.f * d.sub;
  return d;
}

// Whether digit pass p's tiles move in 16-byte groups: 4 sub-lines of a
// row, C and sub multiples of 4, both planes aligned.
__device__ __forceinline__ bool digit_vec(const LongOp& op, const Pass& p) {
  const Digit& g = op.lg.dig[p.digit];
  const long long sub =
      (long long)digit_rest(op, p.digit) * (op.axis == 1 ? 1 : op.lines);
  return g.tile % 4 == 0 && sub % 4 == 0 &&
         g.f * g.tile >= kTileVecPoints && planes16(p);
}

// Tile t of digit pass p into a ring slot (digit_vec): group q (row k,
// sub-lines c to c + 3) at float4 q of each plane; a ragged tile's groups
// past the sub-lines are not read.
__device__ __forceinline__ void digit_fetch(float* slot, const LongOp& op,
                                            const Pass& p, long long t) {
  const DigitAt d = digit_at(op, p, t);
  const int C4 = d.C / 4, groups = d.f * C4;
  const long long pts = (long long)d.f * d.C;
  for (int q = threadIdx.x; q < groups; q += blockDim.x) {
    const int k = q / C4, c = 4 * (q - k * C4);
    if (d.j0 + c >= d.sub) continue;
    const long long e = d.off + k * d.sub + d.j0 + c;
    cp_async16(slot + 4 * q, p.sr + e);
    cp_async16(slot + pts + 4 * q, p.si + e);
  }
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
// inverse's scale. The sub-lines of a row k are contiguous: 16-byte
// accesses of 4 sub-lines where C and sub are multiples of 4 (digit_vec),
// read from the ring's slot where the pass takes one (`slot`, filled by
// digit_fetch), which then takes tile `next` (-1: none) once the tile's
// points are in s.
template <bool kStockham, int kOp = kTf32x3, int kKara = 0, bool kBs = false>
__device__ __forceinline__ void digit_tile(float2* s, const Mats& m,
                                           const LongOp& op, const Pass& p,
                                           const PassForm pf,
                                           const LongForm form, long long t,
                                           float* slot = nullptr,
                                           long long next = -1) {
  constexpr bool kNat = !kStockham && kOp != kTf32x3;
  const Digit& g = op.lg.dig[p.digit];
  const DigitAt d = digit_at(op, p, t);
  const int f = d.f, C = d.C, rest = d.rest, ldiv = d.ldiv;
  const long long sub = d.sub, scene = d.scene, j0 = d.j0, off = d.off;
  const bool inverse = p.kind == kDigitInv;
  const int total = f * C;
  const float* __restrict__ twr = g.twr;
  const float* __restrict__ twi = g.twi;
  const bool vec = slot != nullptr || digit_vec(op, p);
  const float4* __restrict__ rr = reinterpret_cast<const float4*>(slot);
  const float4* __restrict__ ri =
      reinterpret_cast<const float4*>(slot + (slot ? total : 0));
  const int Cp = C + digit_pad(g, kStockham);   // the matmul rows' stride
  auto at = [&](int k, int c) { return kStockham ? swz(c * f + k)
                                                 : k * Cp + c; };
  // the load's operations on point k of sub-line j: at f32 (no codec, no
  // natural schedule) the inverse's twiddle alone, applied as it loads
  constexpr bool kTwiddleOnly = !kBs && !kNat;
  auto in_ops = [&](float2 v, int k, long long j) {
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
    return v;
  };
  if (vec) {
    const int C4 = C / 4, groups = f * C4;
    for (int g0 = 0; g0 < groups; g0 += kTileLoads * blockDim.x) {
      float4 a[kTileLoads], b[kTileLoads];
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const int q = g0 + threadIdx.x + u * blockDim.x;
        const int k = q / C4, c = 4 * (q - k * C4);
        a[u] = b[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (q < groups && j0 + c < sub) {
          if (slot) {
            a[u] = rr[q];
            b[u] = ri[q];
          } else {
            load4(p.sr, p.si, off + k * sub + j0 + c, a[u], b[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const int q = g0 + threadIdx.x + u * blockDim.x;
        if (q >= groups) continue;
        const int k = q / C4, c = 4 * (q - k * C4);
        const bool valid = j0 + c < sub;
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const float2 v = lane4(a[u], b[u], mm);
          s[at(k, c + mm)] = kTwiddleOnly && valid
                                   ? in_ops(v, k, j0 + c + mm)
                                   : v;
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int k = i / C, c = i - k * C;
      const long long j = j0 + c;
      float2 v = make_float2(0.0f, 0.0f);
      if (j < sub) {
        const long long e = off + k * sub + j;
        v = make_float2(__ldcg(p.sr + e), __ldcg(p.si + e));
        if constexpr (kTwiddleOnly) v = in_ops(v, k, j);
      }
      s[at(k, c)] = v;
    }
  }
  // the other forms' load operations in place (one copy of their code)
  if (!kTwiddleOnly &&
      (inverse || (kBs && pf.enc) || (kNat && (pf.filt_in || pf.conj_in)))) {
    __syncthreads();
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int k = i / C, c = i - k * C;
      const long long j = j0 + c;
      if (j >= sub) continue;
      float2& r = s[at(k, c)];
      r = in_ops(r, k, j);
    }
  }
  __syncthreads();
  if (slot) {   // the slot is read: the ring's load of tile `next`
    if (next >= 0) digit_fetch(slot, op, p, next);
    cp_async_commit();
  }
  const int fb = kStockham ? 1 : g.fb, fa = f / fb;
  if constexpr (kStockham) {
    stockham_lines(Lines{s, C, f, f, 1}, g.stw, true, false);
  } else if (fb == 1) {
    //                                         nf nq sk  sq om  oq twm twq
    form_stage<kOp, kKara>(form.kara, Lines{s, 1, f * Cp, f * Cp, 1},
                           StageMap{f, C, Cp, 1, Cp, 1, 0, 0}, m.f1r, m.f1i,
                           m.ld1, nullptr, nullptr, false);
  } else if constexpr (kOp == kTf32x3) {   // stages_n1n2's maps
    const Lines L{s, C, f, 1, Cp};
    form_stage_cols<kKara>(form.kara, L, StageMap{fa, fb, fb, 1, 1, fa, fb, 1},
                           m.f1r, m.f1i, m.ld1, g.itwr, g.itwi);
    form_stage_cols<kKara>(form.kara, L, StageMap{fb, fa, fa, 1, 1, fb, 0, 0},
                           m.f2r, m.f2i, m.ld2, nullptr, nullptr);
  } else {
    __trap();   // the 16-bit forms take one stage (unpack_segment)
  }
  const float scale = inverse_scale(p.last, op.n);
  const float iscale = -scale;
  // the store's operations on point k (natural) of sub-line j, read from
  // position q of the tile
  auto out = [&](int q, int c, int k, long long j) {
    float2 v = s[at(q, c)];
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
    return v;
  };
  if (vec) {
    const int C4 = C / 4;
    for (int i = threadIdx.x; i < f * C4; i += blockDim.x) {
      const int q = i / C4, c = 4 * (i - q * C4);
      const long long j = j0 + c;
      if (j >= sub) continue;
      const int k = fb > 1 ? from_transposed(q, fa, fb) : q;
      float2 v[4];
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) v[mm] = out(q, c + mm, k, j + mm);
      store4(p.dr, p.di, off + k * sub + j, v);
    }
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int q = i / C, c = i - q * C;   // q: the position in the tile
      const long long j = j0 + c;
      if (j >= sub) continue;
      const int k = fb > 1 ? from_transposed(q, fa, fb) : q;
      const float2 v = out(q, c, k, j);
      const long long e = off + k * sub + j;
      p.dr[e] = v.x;
      p.di[e] = v.y;
    }
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

// The tail's 16-byte group i: rows 4 points q to q + 3 of line c of the
// tile (a run), columns point q of lines c to c + 3.
__device__ __forceinline__ void tail_group(const LongOp& op, int i, int& c,
                                           int& q) {
  if (op.axis == 1) {
    const int per = op.d.n / 4;
    c = i / per;
    q = 4 * (i - c * per);
  } else {
    const int per = op.lg.tail_tile / 4;
    q = i / per;
    c = 4 * (i - q * per);
  }
}

// Where a tail tile's point q of line r is read from: its run (its
// position q), or, where the op's tail loads natural order (perm_in: an
// inverse-only op), its natural index.
template <bool kStockham>
__device__ __forceinline__ long long tail_src(const LongOp& op,
                                              const TailLine& r, int q,
                                              bool perm_in) {
  const long long stride = op.axis == 1 ? 1 : op.lines;
  return perm_in ? r.nat + tail_k<kStockham>(op, r, q) * stride
                 : r.pos + q * stride;
}

// Whether tail pass p's tiles load in 16-byte groups (tail_group): tiles
// of kTileVecPoints points or more, both planes aligned, rows B a
// multiple of 4 and the run's order (a permuted load is a gather),
// columns C and the lines multiples of 4. The store's test is the same
// with the store's order.
__device__ __forceinline__ bool tail_vec(const LongOp& op, const Pass& p,
                                         bool permuted) {
  const int B = op.d.n, C = op.lg.tail_tile;
  return C * B >= kTileVecPoints && planes16(p) &&
         (op.axis == 1 ? B % 4 == 0 && !permuted
                       : C % 4 == 0 && op.lines % 4 == 0);
}

// Tile t of tail pass p into a ring slot (tail_vec of its load): group i
// at float4 i of each plane; the lines past the op's are not read.
template <bool kStockham>
__device__ __forceinline__ void tail_fetch(float* slot, const LongOp& op,
                                           const Pass& p, long long t,
                                           bool perm_in) {
  const int total = op.d.n * op.lg.tail_tile;
  for (int i = threadIdx.x; i < total / 4; i += blockDim.x) {
    int c, q;
    tail_group(op, i, c, q);
    const TailLine r = tail_line(op, t, c);
    if (!r.valid) continue;   // columns: 4 lines valid or none
    const long long e = tail_src<kStockham>(op, r, q, perm_in);
    cp_async16(slot + 4 * i, p.sr + e);
    cp_async16(slot + total + 4 * i, p.si + e);
  }
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
                           StageMap{L.n, L.lines, 1, L.ls, 1, L.ls, 0, 0},
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

// One tail tile: C lines of B points, s[c * B + q] (swizzled on the
// Stockham route). Loads its runs (an inverse-only op from natural order,
// filtered there), runs the forward, the filter at natural indices and the
// inverse, and stores (a forward-only op to natural order), each stage
// through form_stage (the op's operand form). The natural schedule (kNat)
// runs the forward and stores natural order, filtered where the pass's
// form says, its last pass with the inverse's closing conjugate and 1/N
// on the store; bs16 scales by 2^-e on the op's first load, before the
// filter, and by 2^e on its last store. Neighbouring threads take
// neighbouring points of a row where the run is contiguous, neighbouring
// lines otherwise; 16-byte accesses of 4 of them where the side is not
// permuted on the rows layout (B a multiple of 4) and on the columns
// layout where C and the lines are multiples of 4 (tail_vec), the load's
// read from the ring's slot where the pass takes one (`slot`, filled by
// tail_fetch), which then takes tile `next` (-1: none) once the tile's
// points are in s.
template <bool kStockham, int kOp, int kKara, bool kBs>
__device__ __forceinline__ void tail_tile_form(float2* s, const Mats& m,
                                               const LongOp& op,
                                               const Pass& p,
                                               const PassForm pf,
                                               const LongForm form,
                                               long long t,
                                               float* slot = nullptr,
                                               long long next = -1) {
  constexpr bool kNat = !kStockham && kOp != kTf32x3;
  const int B = op.d.n, C = op.lg.tail_tile;
  const int total = C * B;
  const bool tfwd = kNat || op.fwd;
  const bool tinv = !kNat && op.inv;
  const bool perm_in = !kNat && !op.fwd;
  const bool perm_out = kNat || !op.inv;
  const bool filt = (kNat ? pf.filt : true) && op.f.mode != kNone;
  auto at = [&](int c, int q) { return kStockham ? swz(c * B + q)
                                                 : c * B + q; };
  // point (c, q) of the tile: the load's operations
  auto in_ops = [&](float2 v, const TailLine& r, int q) {
    if (perm_in) {
      if constexpr (kBs) {
        if (pf.enc) v = scale2(v, pow2(-codec_exponent(form, tail_bl(op, r))));
      }
      if (filt) v = apply_filter(v, op.f, r.line, tail_k<kStockham>(op, r, q));
    }
    return v;
  };
  // 16-byte groups (tail_group)
  if (slot != nullptr || tail_vec(op, p, perm_in)) {
    const float4* __restrict__ rr = reinterpret_cast<const float4*>(slot);
    const float4* __restrict__ ri =
        reinterpret_cast<const float4*>(slot + (slot ? total : 0));
    const int groups = total / 4;
    for (int g0 = 0; g0 < groups; g0 += kTileLoads * blockDim.x) {
      float4 a[kTileLoads], b[kTileLoads];
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const int i = g0 + threadIdx.x + u * blockDim.x;
        a[u] = b[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i >= groups) continue;
        int c, q;
        tail_group(op, i, c, q);
        const TailLine r = tail_line(op, t, c);
        if (!r.valid) continue;
        if (slot) {
          a[u] = rr[i];
          b[u] = ri[i];
        } else {
          load4(p.sr, p.si, tail_src<kStockham>(op, r, q, perm_in), a[u],
                b[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const int i = g0 + threadIdx.x + u * blockDim.x;
        if (i >= groups) continue;
        int c, q;
        tail_group(op, i, c, q);
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          s[op.axis == 1 ? at(c, q + mm) : at(c + mm, q)] =
              lane4(a[u], b[u], mm);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      int c, q;
      if (op.axis == 0 || perm_in) { q = i / C; c = i - q * C; }
      else { c = i / B; q = i - c * B; }
      const TailLine r = tail_line(op, t, c);
      float2 v = make_float2(0.0f, 0.0f);
      if (r.valid) {
        const long long e = tail_src<kStockham>(op, r, q, perm_in);
        v = make_float2(__ldcg(p.sr + e), __ldcg(p.si + e));
      }
      s[at(c, q)] = v;
    }
  }
  // an inverse-only op's load operations in place (one copy of their code)
  if (perm_in && ((kBs && pf.enc) || filt)) {
    __syncthreads();
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int c = i / B, q = i - c * B;
      const TailLine r = tail_line(op, t, c);
      if (!r.valid) continue;
      float2& e = s[at(c, q)];
      e = in_ops(e, r, q);
    }
  }
  __syncthreads();
  if (slot) {   // the slot is read: the ring's load of tile `next`
    if (next >= 0) tail_fetch<kStockham>(slot, op, p, next, perm_in);
    cp_async_commit();
  }
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
  auto out = [&](const TailLine& r, int c, int q) {
    float2 v = s[at(c, q)];
    if constexpr (kNat) {
      if (p.last) {
        v = make_float2(__fmul_rn(v.x, scale), __fmul_rn(v.y, -scale));
      }
    }
    if constexpr (kBs) {
      if (pf.dec) v = scale2(v, pow2(codec_exponent(form, tail_bl(op, r))));
    }
    return v;
  };
  auto dst = [&](const TailLine& r, int q) {
    return tail_src<kStockham>(op, r, q, perm_out);
  };
  if (tail_vec(op, p, perm_out)) {
    for (int i = threadIdx.x; i < total / 4; i += blockDim.x) {
      int c, q;
      tail_group(op, i, c, q);
      const TailLine r = tail_line(op, t, c);
      if (!r.valid) continue;   // columns: 4 lines valid or none
      float2 v[4];
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        v[mm] = op.axis == 1 ? out(r, c, q + mm)
                             : out(tail_line(op, t, c + mm), c + mm, q);
      }
      store4(p.dr, p.di, dst(r, q), v);
    }
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      int c, q;
      if (op.axis == 0 || perm_out) { q = i / C; c = i - q * C; }
      else { c = i / B; q = i - c * B; }
      const TailLine r = tail_line(op, t, c);
      if (!r.valid) continue;
      const float2 v = out(r, c, q);
      const long long e = dst(r, q);
      p.dr[e] = v.x;
      p.di[e] = v.y;
    }
  }
  __syncthreads();   // the next tile's load overwrites s
}

// A filter-only op past one block: elementwise, device memory to device
// memory (bs16: 2^-e, the filter, 2^e, as the plain version orders them),
// 4 points of a plane a 16-byte access and a thread's kTileLoads groups of
// loads in flight where the planes allow it and the filter has no phase.
template <bool kBs = false>
__device__ __forceinline__ void filter_only(const LongOp& op, const Pass& p,
                                            const LongForm form) {
  const long long total = (long long)op.batch * op.lines * op.n;
  const long long step = (long long)gridDim.x * blockDim.x;
  auto point = [&](long long e, float2 v) {
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
      return apply_filter(v, op.f, line, k);
    } else {
      const long long bl = op.axis == 1
                               ? e / op.n
                               : e / ((long long)op.n * op.lines) * op.lines +
                                     line;
      const int ex = codec_exponent(form, bl);
      v = scale2(v, pow2(-ex));
      return scale2(apply_filter(v, op.f, line, k), pow2(ex));
    }
  };
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // a phase filter's sincosf makes the pass compute-bound: its one-point
  // loop keeps one copy of that code (16 unrolled ones ran 7 % slower)
  if (total % 4 == 0 && planes16(p) && !has_phase(op.f)) {
    const long long groups = total / 4;
    for (long long g0 = first; g0 < groups; g0 += kTileLoads * step) {
      float4 a[kTileLoads], b[kTileLoads];
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const long long g = g0 + u * step;
        if (g < groups) load4(p.sr, p.si, 4 * g, a[u], b[u]);
      }
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const long long g = g0 + u * step;
        if (g >= groups) continue;
        float2 v[4];
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          v[mm] = point(4 * g + mm, lane4(a[u], b[u], mm));
        }
        store4(p.dr, p.di, 4 * g, v);
      }
    }
    return;
  }
  for (long long e = first; e < total; e += step) {
    const float2 v = point(e, make_float2(__ldcg(p.sr + e),
                                          __ldcg(p.si + e)));
    p.dr[e] = v.x;
    p.di[e] = v.y;
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
  float* at = reinterpret_cast<float*>(
      s + g.f * (g.tile + digit_pad(g, false)));
  if (g.fb > 1) {
    return mats_to_shared(at, Dft{g.fr, g.fi, g.fbr, g.fbi, nullptr, nullptr,
                                  nullptr, g.f, g.f / g.fb, g.fb});
  }
  return mats_to_shared(at, Dft{g.fr, g.fi, g.fr, g.fi, nullptr, nullptr,
                                nullptr, g.f, g.f, g.f});
}

// ---------------------------------------------------------------------------
// Whole lines in one tile (the rows layout, one device-memory digit)
// ---------------------------------------------------------------------------
//
// On the rows layout with one device-memory digit (N = f * B) a digit
// tile of B sub-lines is a whole line, held in its device-memory order:
// point k of sub-line c is element e = k * B + c of the line, and run c of
// the tail is elements [c * B, c * B + B) (the matmul route's rows of B
// digit_pad points apart, LineIdx). So every pass of the op runs on the
// line in shared memory, each with its tile function's operations in the
// same order (digit_tile, tail_tile_form: the same stages on the same
// sub-lines and runs, the same twiddles, filter points, conjugates and
// 1/N), and what a pass writes back to device memory for the next one
// stays in the tile:
//   - a digit pass's load and store operations run in place over the
//     line (line_update), its stage(s) on the line's sub-lines as the
//     pass's tile holds them (a one-stage digit wider than one round of
//     the stage in rounds of its columns, as slab_digit takes them); the
//     two-stage digit's transposed order goes back to natural order
//     through registers (line_move), and the Stockham route's sub-lines
//     (C rows of f points) move to and from the line's order the same
//     way;
//   - the tail's runs are the line's order itself; a one-direction op's
//     moves between the runs' order and the natural one (the scratch
//     slab's, over device memory) and the natural schedule's are
//     line_moves;
//   - bs16 takes the line's exponent from its largest |re| or |im| in the
//     block (line_exponent_of): the reduction phase's word exactly, a
//     maximum being order-free, so no reduction phase and no grid barrier.
// So a whole-line op equals the passes bit for bit, and reads the line
// once and writes it once: 16-byte loads of 4 points of a plane, a
// thread's kLineLoads of them in flight before its shared-memory stores,
// and 16-byte stores. The line takes 8 N bytes (the Stockham route's
// rounded up to 16 points), kLineMinN <= N <= kLineMaxN; on the matmul
// route the digit's DFT matrices and the tail's follow it where each
// fits, else the stages read them in place from device memory
// (line_plan), as mega_resident's do. A block walks the lines; no grid
// barrier.
//
// The resident slab's passes below (slab_digit, slab_tail) run the same
// sequence on a slab and share this section's primitives (line_update,
// line_move, LineIdx), but not its pass functions: a slab is the op's
// device-memory layout, which mega_resident's one-block segments share,
// so its rows take no padding (the line's rows digit_pad apart are what
// freed the matmul route's stages of 16-way bank conflicts), and it holds
// many lines, the columns layout and two digits, where a whole line is
// one row of one digit, whose indices are shifts (nat, lb). Serving both
// from one set would branch on the caller at every point; porting the
// line's padding and batched passes to the slab is ROADMAP Queue 2, 2h.

// Where element e of the line lives in shared memory: the Stockham route
// swizzled, the matmul route's rows of B points (a run, or point k of the
// B sub-lines) digit_pad points apart (the digit stage's reads down its
// sub-lines then fall on distinct banks).
template <bool kSwz>
struct LineIdx {
  int lb, pad;
  __device__ __forceinline__ int operator()(int e) const {
    return kSwz ? swz(e) : e + (e >> lb) * pad;
  }
};

// Every point o < n of the line (at s[ix(o)]) through v = f(o, v) in
// place, then a barrier: kU points a thread read (and whatever f loads,
// a twiddle) before any is written back; kU = 1 where f is long (the
// filter's phase, its sincosf), so that its code appears once.
template <int kU, bool kSwz, class F>
__device__ __forceinline__ void line_update(float2* s,
                                            const LineIdx<kSwz>& ix, int n,
                                            F f) {
  for (int o0 = threadIdx.x; o0 < n; o0 += kU * blockDim.x) {
    float2 v[kU];
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const int o = o0 + i * blockDim.x;
      if (o < n) v[i] = f(o, s[ix(o)]);
    }
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const int o = o0 + i * blockDim.x;
      if (o < n) s[ix(o)] = v[i];
    }
  }
  __syncthreads();
}

// A permutation of the line's points through registers: every point
// o < n read as get(o), a barrier, each written as put(o, v), a barrier
// (exact).
template <class Get, class Put>
__device__ __forceinline__ void line_move(int n, Get get, Put put) {
  float2 v[kLinePerThread];
#pragma unroll
  for (int i = 0; i < kLinePerThread; ++i) {
    const int o = threadIdx.x + i * blockDim.x;
    if (o < n) v[i] = get(o);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kLinePerThread; ++i) {
    const int o = threadIdx.x + i * blockDim.x;
    if (o < n) put(o, v[i]);
  }
  __syncthreads();
}

// Line `base` of (xr, xi) into s in its device order (placed by ix), 4
// points of a plane a 16-byte load where both planes are aligned (n is a
// multiple of 16), kLineLoads of them a thread in flight; the caller's
// barrier follows.
template <bool kSwz>
__device__ __forceinline__ void line_load(float2* s, const LineIdx<kSwz> ix,
                                          const float* xr, const float* xi,
                                          long long base, int n) {
  if (!(aligned16(xr + base) && aligned16(xi + base))) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      s[ix(e)] = make_float2(__ldcg(xr + base + e), __ldcg(xi + base + e));
    }
    return;
  }
  const float4* __restrict__ vr = reinterpret_cast<const float4*>(xr + base);
  const float4* __restrict__ vi = reinterpret_cast<const float4*>(xi + base);
  const int groups = n / 4;
  for (int g0 = 0; g0 < groups; g0 += kLineLoads * blockDim.x) {
    float4 a[kLineLoads], b[kLineLoads];
#pragma unroll
    for (int i = 0; i < kLineLoads; ++i) {
      const int g = g0 + threadIdx.x + i * blockDim.x;
      if (g < groups) {
        a[i] = __ldcg(vr + g);
        b[i] = __ldcg(vi + g);
      }
    }
#pragma unroll
    for (int i = 0; i < kLineLoads; ++i) {
      const int g = g0 + threadIdx.x + i * blockDim.x;
      if (g >= groups) continue;
#pragma unroll
      for (int m = 0; m < 4; ++m) s[ix(4 * g + m)] = lane4(a[i], b[i], m);
    }
  }
}

// The line in s (placed by ix) to `base` of (yr, yi): the load's mirror.
template <bool kSwz>
__device__ __forceinline__ void line_store(const float2* s,
                                           const LineIdx<kSwz> ix,
                                           float* yr, float* yi,
                                           long long base, int n) {
  if (!(aligned16(yr + base) && aligned16(yi + base))) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const float2 v = s[ix(e)];
      yr[base + e] = v.x;
      yi[base + e] = v.y;
    }
    return;
  }
  for (int g = threadIdx.x; g < n / 4; g += blockDim.x) {
    float2 v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) v[m] = s[ix(4 * g + m)];
    store4(yr, yi, base + 4 * g, v);
  }
}

// bs16's exponent of the line in s: its largest |re| or |im| (the
// reduction phase's word exactly: a maximum is order-free) through a
// warp reduction and red (a word a warp), then the codec's ceil-log2.
// Every thread returns it; the caller's next barrier frees red.
template <bool kSwz>
__device__ __forceinline__ int line_exponent_of(const float2* s,
                                                const LineIdx<kSwz> ix, int n,
                                                unsigned* red) {
  unsigned mx = 0u;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    mx = max(mx, __float_as_uint(point_amax(s[ix(e)])));
  }
  mx = __reduce_max_sync(0xffffffffu, mx);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  unsigned all = 0u;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) all = max(all, red[w]);
  return line_exponent(__uint_as_float(all));
}

// A whole-line op's DFT matrices: the digit's and the tail's.
struct LineMats {
  Mats dig, tail;
};

// The digit pass p on the line (digit_tile's, its tile the whole line):
// its load's operations (bs16's 2^-e on the op's first pass, the natural
// schedule's filter and conjugate, the inverse's twiddle) at each point's
// device place e = k * B + c, the f-point transforms of the B sub-lines,
// its store's (the forward's twiddle, the last pass's conjugate and 1/N,
// bs16's 2^e) at the natural place. The operations run in place (one
// copy of their code each), the moves are pure permutations.
template <bool kStockham, int kOp, int kKara, bool kBs>
__device__ __forceinline__ void line_digit(float2* s,
                                           const LineIdx<kStockham> ix,
                                           const Mats& m, const LongOp& op,
                                           const Pass& p, const PassForm pf,
                                           bool kara, int ex, int line) {
  constexpr bool kNat = !kStockham && kOp != kTf32x3;
  const Digit& g = op.lg.dig[0];
  const int n = op.n, f = g.f, B = n / f, Bp = B + ix.pad;
  const int lb = ix.lb, lf = __ffs(f) - 1;
  const bool inverse = p.kind == kDigitInv;
  const float* __restrict__ twr = g.twr;
  const float* __restrict__ twi = g.twi;
  const bool any_in = inverse || (kBs && pf.enc) ||
                      (kNat && (pf.filt_in || pf.conj_in));
  const bool any_out = !inverse || p.last || (kBs && pf.dec);
  const float scale = inverse_scale(p.last, n);
  // the load's operations on the point at device place e
  auto load = [&](int e, float2 v) {
    if constexpr (kBs || kNat) {
      if (kBs && pf.enc) v = scale2(v, pow2(-ex));
      if (kNat && pf.filt_in) v = apply_filter(v, op.f, line, e);
      if (kNat && pf.conj_in) v.y = -v.y;   // exact
    }
    if (inverse) v = cmul(v, __ldg(twr + e), __ldg(twi + e));
    return v;
  };
  // the store's operations on the point of natural place e
  auto store = [&](int e, float2 v) {
    if (!inverse) v = cmul(v, __ldg(twr + e), __ldg(twi + e));
    if (p.last) v = make_float2(__fmul_rn(v.x, scale), __fmul_rn(v.y, -scale));
    if constexpr (kBs) {
      if (pf.dec) v = scale2(v, pow2(ex));
    }
    return v;
  };
  if (any_in) {
    if (kNat && pf.filt_in) {
      line_update<1>(s, ix, n, load);
    } else {
      line_update<kLineLoads>(s, ix, n, load);
    }
  }
  if constexpr (kStockham) {   // C rows of f points: s[swz(c * f + k)]
    line_move(n, [&](int e) { return s[swz(e)]; },
              [&](int e, float2 v) {
                s[swz((e & (B - 1)) * f + (e >> lb))] = v;
              });
    stockham_lines(Lines{s, B, f, f, 1}, g.stw, true, false);
    line_move(n, [&](int o) { return s[swz(o)]; },
              [&](int o, float2 v) {
                s[swz((o & (f - 1)) * B + (o >> lf))] = v;
              });
    if (any_out) line_update<kLineLoads>(s, ix, n, store);
  } else {
    const int fb = g.fb, fa = f / fb;
    if (fb == 1) {
      // one stage, the sub-lines its columns (in rounds of the columns one
      // round of the stage takes, as slab_digit runs them)
      const int cap = ((int)blockDim.x / 32 / ((f + 15) / 16)) * kGroupCols;
      if (B <= cap) {
        //                                          nf nq sk  sq om  oq
        form_stage<kOp, kKara>(kara, Lines{s, 1, f * Bp, f * Bp, 1},
                               StageMap{f, B, Bp, 1, Bp, 1, 0, 0}, m.f1r,
                               m.f1i, m.ld1, nullptr, nullptr, false);
      } else {
        form_stage<kOp, kKara>(kara, Lines{s, B / cap, cap, cap, 1},
                               StageMap{f, cap, Bp, 1, Bp, 1, 0, 0}, m.f1r,
                               m.f1i, m.ld1, nullptr, nullptr, false);
      }
      if (any_out) line_update<kLineLoads>(s, ix, n, store);
    } else if constexpr (kOp == kTf32x3) {   // stages_n1n2's maps
      const Lines L{s, B, f, 1, Bp};
      form_stage_cols<kKara>(kara, L,
                             StageMap{fa, fb, fb, 1, 1, fa, fb, 1}, m.f1r,
                             m.f1i, m.ld1, g.itwr, g.itwi);
      form_stage_cols<kKara>(kara, L, StageMap{fb, fa, fa, 1, 1, fb, 0, 0},
                             m.f2r, m.f2i, m.ld2, nullptr, nullptr);
      // row q holds the natural k = from_transposed(q)
      auto nat = [&](int o) {
        return from_transposed(o >> lb, fa, fb) * B + (o & (B - 1));
      };
      if (any_out) {
        line_update<kLineLoads>(
            s, ix, n, [&](int o, float2 v) { return store(nat(o), v); });
      }
      line_move(n, [&](int o) { return s[ix(o)]; },
                [&](int o, float2 v) { s[ix(nat(o))] = v; });
    } else {
      __trap();   // the 16-bit forms take one stage (unpack_segment)
    }
  }
}

// The tail's B-point transforms of the line's P runs, run r at s + r * ls
// (tail_transform_form on a tile of P lines; a one-factor tail wider than
// one round of its stage in rounds of the runs).
template <bool kStockham, int kOp, int kKara>
__device__ __forceinline__ void line_tail_transform(float2* s, int ls,
                                                    const Dft& d,
                                                    const Mats& m, int P,
                                                    bool inverse,
                                                    bool kara) {
  const int B = d.n;
  if constexpr (!kStockham) {
    const int cap = ((int)blockDim.x / 32 / ((B + 15) / 16)) * kGroupCols;
    if (d.n2 == 1 && P > cap) {
      form_stage<kOp, kKara>(kara, Lines{s, P / cap, cap * ls, cap * ls, 1},
                             StageMap{B, cap, 1, ls, 1, ls, 0, 0}, m.f1r,
                             m.f1i, m.ld1, nullptr, nullptr, inverse);
      return;
    }
  }
  tail_transform_form<kStockham, kOp, kKara>(Lines{s, P, B, ls, 1}, d, m,
                                             inverse, kara);
}

// The tail pass p on the line (tail_tile_form's, its tile the line's P
// runs): an inverse-only op's load from natural order (bs16's 2^-e, the
// filter), the forward and the filter at natural indices, the inverse,
// the store's operations and, where the op or the natural schedule
// stores natural order, the move there.
template <bool kStockham, int kOp, int kKara, bool kBs>
__device__ __forceinline__ void line_tail(float2* s,
                                          const LineIdx<kStockham> ix,
                                          const Mats& m, const LongOp& op,
                                          const Pass& p, const PassForm pf,
                                          bool kara, int ex, int line) {
  constexpr bool kNat = !kStockham && kOp != kTf32x3;
  const int n = op.n, B = op.d.n, P = n / B;
  const int lb = ix.lb;
  const bool tfwd = kNat || op.fwd;
  const bool tinv = !kNat && op.inv;
  const bool perm_in = !kNat && !op.fwd;
  const bool perm_out = kNat || !op.inv;
  const bool filt = (kNat ? pf.filt : true) && op.f.mode != kNone;
  const bool two = !kStockham && op.d.n2 > 1;
  const int n1 = op.d.n1, n2 = op.d.n2;
  // tail_k of point o (run o / B, position o % B): klo is the run's index
  auto nat = [&](int o) {
    const int q = o & (B - 1);
    return (o >> lb) + P * (two ? from_transposed(q, n1, n2) : q);
  };
  if (perm_in) {
    line_move(n, [&](int o) { return s[ix(nat(o))]; },
              [&](int o, float2 v) { s[ix(o)] = v; });
    if ((kBs && pf.enc) || filt) {
      line_update<1>(s, ix, n, [&](int o, float2 v) {
        if constexpr (kBs) {
          if (pf.enc) v = scale2(v, pow2(-ex));
        }
        if (filt) v = apply_filter(v, op.f, line, nat(o));
        return v;
      });
    }
  }
  const int ls = B + ix.pad;
  if (tfwd) {
    line_tail_transform<kStockham, kOp, kKara>(s, ls, op.d, m, P, false,
                                               kara);
    if (filt) {
      line_update<1>(s, ix, n, [&](int o, float2 v) {
        return apply_filter(v, op.f, line, nat(o));
      });
    }
  }
  if (tinv) {
    line_tail_transform<kStockham, kOp, kKara>(s, ls, op.d, m, P, true,
                                               kara);
  }
  const float scale = inverse_scale(kNat && p.last, n);
  if ((kNat && p.last) || (kBs && pf.dec)) {
    line_update<kLineLoads>(s, ix, n, [&](int, float2 v) {
      if constexpr (kNat) {
        if (p.last) {
          v = make_float2(__fmul_rn(v.x, scale), __fmul_rn(v.y, -scale));
        }
      }
      if constexpr (kBs) {
        if (pf.dec) v = scale2(v, pow2(ex));
      }
      return v;
    });
  }
  if (perm_out) {
    line_move(n, [&](int o) { return s[ix(o)]; },
              [&](int o, float2 v) { s[ix(nat(o))] = v; });
  }
}

// Every pass of the op on its lines, a line a tile: each block walks the
// (scene, line)s, loads one, runs the op's passes (long_pass, or the
// natural schedule's long_pass_natural) on it in shared memory and
// stores it. kOp, kKara, kBs: long_op_form's (the f32 form: kTf32x3, 0,
// false).
template <bool kStockham, int kOp, int kKara, bool kBs>
__device__ __noinline__ void long_lines_whole(float2* s, const LongOp& op,
                                              const LongForm form) {
  constexpr bool kNat = !kStockham && kOp != kTf32x3;
  const LinePlan pl = line_plan(op, kStockham, kBs);
  const int n = op.n;
  const Digit& g = op.lg.dig[0];
  const LineIdx<kStockham> ix{__ffs(n / g.f) - 1, digit_pad(g, kStockham)};
  unsigned* red = reinterpret_cast<unsigned*>(
      s + (kStockham ? stockham_points(n) : n + g.f * ix.pad));
  LineMats m{};
  if constexpr (!kStockham) {
    float* at = reinterpret_cast<float*>(red + (kBs ? kAmaxWords : 0));
    const Dft dd = g.fb > 1 ? Dft{g.fr, g.fi, g.fbr, g.fbi, nullptr, nullptr,
                                  nullptr, g.f, g.f / g.fb, g.fb}
                            : Dft{g.fr, g.fi, g.fr, g.fi, nullptr, nullptr,
                                  nullptr, g.f, g.f, g.f};
    if (pl.dig_smem) {
      m.dig = mats_to_shared(at, dd);
      at += digit_mats_bytes(g) / 4;
    } else {
      m.dig = mats_in_place(dd);
    }
    const Dft& d = op.d;
    const Dft td = d.n2 > 1 ? d
                            : Dft{d.f1r, d.f1i, d.f1r, d.f1i, nullptr,
                                  nullptr, nullptr, d.n, d.n, d.n};
    m.tail = pl.tail_smem ? mats_to_shared(at, td) : mats_in_place(td);
  }
  const int np = kNat ? long_pass_count_natural(op) : long_pass_count(op);
  const long long lines = (long long)op.batch * op.lines;
  for (long long bl = blockIdx.x; bl < lines; bl += gridDim.x) {
    const int line = (int)(bl % op.lines);
    line_load(s, ix, op.xr, op.xi, bl * n, n);
    __syncthreads();
    int ex = 0;
    if constexpr (kBs) ex = line_exponent_of(s, ix, n, red);
    for (int k = 0; k < np; ++k) {
      const Pass p = kNat ? long_pass_natural(op, k) : long_pass(op, k);
      const PassForm pf = kNat || kBs ? pass_form<kNat>(op, k) : PassForm{};
      if (p.kind == kTail) {
        line_tail<kStockham, kOp, kKara, kBs>(
            s, ix, m.tail, op, p, pf, form.kara, ex, line);
      } else {
        line_digit<kStockham, kOp, kKara, kBs>(
            s, ix, m.dig, op, p, pf, form.kara, ex, line);
      }
    }
    line_store(s, ix, op.yr, op.yi, bl * n, n);
    __syncthreads();   // the next line's load overwrites s
  }
}

// The ring of tile pass p (ring_bytes), past its tile in s, where the
// pass takes one and its loads move in 16-byte groups; else null, and the
// tile functions load from device memory themselves.
template <bool kStockham, bool kNat>
__device__ __forceinline__ float* pass_ring(float2* s, const LongOp& op,
                                            const Pass& p) {
  if (ring_bytes(op, p, kStockham) == 0) return nullptr;
  const bool vec = p.kind == kTail ? tail_vec(op, p, !kNat && !op.fwd)
                                   : digit_vec(op, p);
  if (!vec) return nullptr;
  return reinterpret_cast<float*>(reinterpret_cast<char*>(s) +
                                  ring_at(pass_tile_bytes(op, p, kStockham)));
}

// Every pass of one long op, a grid barrier between two (the caller's
// grid is cooperative), bs16's reduction phase first; a whole-line op
// (line_plan) one tile a line, no barrier. kOp, kKara: the matmul route's
// operand form (kKara 0 never, 2 as the form's kara); the 16-bit forms run
// the natural schedule. kBs: the bs16 codec. The f32 form (spectral_long,
// mega_long.cu's chains) is <kStockham, kTf32x3, 0, false>. Out of line:
// its registers are its own, whatever the kernel that calls it.
template <bool kStockham, int kOp, int kKara, bool kBs>
__device__ __noinline__ void long_op_form(float2* s, const LongOp& op,
                                          const LongForm form) {
  static_assert(!kStockham || (kOp == kTf32x3 && kKara == 0),
                "the Stockham route has no matrix operands");
  constexpr bool kNat = !kStockham && kOp != kTf32x3;
  if (line_plan(op, kStockham, kBs).on) {
    long_lines_whole<kStockham, kOp, kKara, kBs>(s, op, form);
    return;
  }
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
    const bool tail = p.kind == kTail;
    float* ring = pass_ring<kStockham, kNat>(s, op, p);
    const long long pts = pass_tile_points(op, p);
    // tile i of the block takes ring slot i % kRingSlots: the first
    // kRingSlots tiles' loads go out now, each later one's as its slot's
    // tile has moved into s (before that tile's stages)
    auto fetch = [&](float* slot, long long t) {
      if (tail) {
        tail_fetch<kStockham>(slot, op, p, t, !kNat && !op.fwd);
      } else {
        digit_fetch(slot, op, p, t);
      }
    };
    if (ring) {
      for (int i = 0; i < kRingSlots; ++i) {
        const long long t = blockIdx.x + (long long)i * gridDim.x;
        if (t < tiles) fetch(ring + 2 * pts * i, t);
        cp_async_commit();
      }
    }
    int i = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
      float* slot = nullptr;
      long long next = t + (long long)kRingSlots * gridDim.x;
      if (ring) {
        cp_async_wait<kRingSlots - 1>();   // tile i's group
        __syncthreads();
        slot = ring + 2 * pts * (i % kRingSlots);
        if (next >= tiles) next = -1;
      }
      if (tail) {
        tail_tile_form<kStockham, kOp, kKara, kBs>(s, m, op, p, pf, form, t,
                                                   slot, next);
      } else {
        digit_tile<kStockham, kOp, kKara, kBs>(s, m, op, p, pf, form, t,
                                               slot, next);
      }
    }
  }
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

// Points a thread holds in a slab move (line_move): 16384 points at 512
// threads.
constexpr int kSlabPerThread = kLinePerThread;

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

// Element e of the slab: s[slab_ix<kSwz>()(e)] (the Stockham route's
// swizzled; the slab's rows are not padded).
template <bool kSwz>
__device__ __forceinline__ LineIdx<kSwz> slab_ix() {
  return LineIdx<kSwz>{0, 0};
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
// its tile function's operations (line_update, a point a thread at a
// time), then a barrier.
template <bool kStockham, bool kNat>
__device__ __noinline__ void slab_points(float2* s, const LongOp& op,
                                         const Pass& p, const PassForm& pf,
                                         int kind) {
  const bool inverse = p.kind == kDigitInv;
  const float scale = inverse_scale(p.last, op.n);
  const int ldiv = op.axis == 1 ? 1 : op.lines;
  const bool digit = kind == kPtsDigitIn || kind == kPtsDigitOut;
  const Digit& g = op.lg.dig[digit ? p.digit : 0];
  const int rest = digit ? digit_rest(op, p.digit) : 1;
  line_update<1>(s, slab_ix<kStockham>(), slab_total(op),
                 [&](int o, float2 v) {
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
    return v;
  });
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

// One move of the slab's points (kind: SlabMove) through registers
// (line_move): every point read, a barrier, every point written, a
// barrier. Moves are exact.
template <bool kStockham>
__device__ __noinline__ void slab_move(float2* s, const LongOp& op,
                                       int digit, int kind) {
  const LineIdx<kStockham> ix = slab_ix<kStockham>();
  const bool gather = kind == kMoveTailIn;
  line_move(slab_total(op),
            [&](int o) {
              return s[ix(gather ? move_index<kStockham>(op, digit, kind, o)
                                 : o)];
            },
            [&](int o, float2 v) {
              s[ix(gather ? o : move_index<kStockham>(op, digit, kind, o))] =
                  v;
            });
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

// Every pass of one long op on the resident slab, in long_pass's (f32) or
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
