// Fused spectral kernel for Hopper (sm_90a): [FFT] -> filter -> [IFFT]
// along one axis of a batch of lines, in ONE launch.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/fft4step.py:598
// `_spectral_kernel` (built by `build_spectral_call`, pallas_call at
// fft4step.py:728, wrapped by src/repro/kernels/ops.py:66 `spectral_op`),
// at every precision (f32, bf16, f16, bs16) with and without Karatsuba,
// N <= 4096 and a two-factor split, both layouts (rows:
// (B, lines, N); cols: (B, N, lines)), all five filter modes (rank-K
// outer), fwd-only / inv-only / fwd+inv / filter-only; and, with
// fft_impl="stockham", also src/repro/kernels/fft4step.py:422
// `_fft_stockham` inside it (N any power of two from 2 to 4096). Lines
// past 4096 points (up to 2^21) and three-factor splits run, at every
// precision and with Karatsuba, as the device-memory passes of
// long_lines.cuh in one cooperative launch (spectral_long, entry point
// spectral_long_launch; the f32 form's here, the others' in
// spectral_long_forms.cu, which builds this source with
// SPECTRAL_LONG_FORMS set).
//
// What bounds it on an H100 SXM at the paper's 4096 x 4096 scene: each
// launch reads re+im once and writes re+im once, 4 x 64 MiB = ~268 MB,
// ~80 us at the spec sheet's 3.35 TB/s; the nominal FFT work
// (5 N log2 N per transform) of the fused range launch (forward +
// inverse over 4096 lines) is ~2.1 GFLOP, ~31 us at 67 TFLOP/s FP32.
// So by the nominal count it is bound by bytes. The four-step form does
// 8 N (n1 + n2) real flops per transform, ~34 GFLOP for that launch; on
// the tensor cores as 3 TF32 passes that is ~103 GFLOP, ~0.21 ms at the
// dense 495 TFLOP/s TF32 rate (mma_floor_ms in chip_smoke.py), still
// above the bytes bound; mma.sync reaches about two thirds of that rate
// on its own (src/repro_torch/kernels/probe.py). A block does not overlap
// its tile's load, stages and store, and the column launches hold one
// tile per SM, so the tile's device-memory I/O is the other half of their
// time (filter-only launches, the same probe). The Stockham route does
// ~5 N log2 N flops a transform, the nominal count; what it spends time
// on is the tile's device-memory I/O and its exchanges through shared
// memory, one a pair of passes (spectral_common.cuh).
//
// Design:
//   * A CTA holds a tile of whole lines in shared memory (complex,
//     interleaved): rows take 4096/N lines (one 32 KiB line at N=4096);
//     cols take at least 4 adjacent columns so that global loads of the
//     strided column layout come in 16-byte runs (128 KiB at N=4096,
//     opted in with cudaFuncAttributeMaxDynamicSharedMemorySize).
//   * The route is a template flag (spectral_kernel<kStockham>), so each
//     route has its own launch bound and register budget.
//   * Matmul route: N = n1 * n2, two in-place four-step stages per
//     transform on mma.sync TF32 in the 3xTF32 form (spectral_common.cuh,
//     shared with mega.cu), the spectrum left in the transposed order
//     between a forward and an inverse transform, so fwd+inv permutes
//     nothing; fwd-only permutes on the store, inv-only on the load. F1
//     and F2 (`dft_constants(n1, n2)`, one f32 copy each, one matrix when
//     n1 == n2) are copied into shared memory past the tile once per
//     block, rows padded to n + 4 floats (34 KiB at N = 4096: a row tile
//     takes 66 KiB, a column tile 162 KiB). 256 to 512 threads
//     (__launch_bounds__(512): up to 128 registers for the 32 accumulator
//     floats of a warp's task and the split fragments): 256 at 4096
//     points a tile, 8 warps of 16 x 32 outputs of the 64 x 64 block a
//     line; 512 for the 16384-point column tile, in two rounds of lines.
//     bf16 / f16 run the stages as one pass of mma.sync.m16n8k16 with f32
//     accumulation, bs16 f16 behind the per-line exponent codec (the
//     tile's lines coded in shared memory after the load, decoded before
//     the store), Karatsuba 3 real products a complex contraction instead
//     of 4; each form its own instantiation (spectral_kernel<matmul, kBs,
//     kOp, kKara>), so the f32 form's code is the same as without them.
//   * Stockham route (stockham_op in spectral_common.cuh): 16 points a
//     thread in registers, 32 in a 4-column tile at N = 4096 (256
//     threads for a row, 512 for that tile; up to 128 registers), the
//     radix-4/radix-2 passes two at a time on them, one exchange through
//     the swizzled tile in shared memory a pair; the first pair loads the
//     tile's points straight from device memory, the last stores them,
//     and a fwd+inv launch turns around in registers at N = 16, 256,
//     4096. Columns put adjacent columns of a point on neighbouring lanes;
//     rows of a multi-line tile synchronise per line (named barriers).
//     Self-sorting, so nothing is permuted and the filter index is the
//     natural one; twiddles from the table fft4step.stockham_table builds
//     on the host (the plain version reads the same numbers).
//   * bs16 on the Stockham route (bf16 and f16 are its f32 passes, since
//     the route has no matrix operands): each line's exponent is reduced from
//     the points the first step loaded into registers (warp shuffles, and
//     a slot a thread in shared memory where a line spans warps), the
//     points scaled by 2^-e before the first butterflies and by 2^e at the
//     store (spectral_common.cuh, "The bs16 codec"); a filter-only launch
//     codes its tile in shared memory. The codec is a template flag
//     (spectral_kernel<kStockham, kBs>): the f32 instantiations carry none
//     of its code.
//   * The matmul route moves the tile between device and shared memory in
//     16-byte accesses (4 points of a row, or one point of 4 adjacent
//     columns) wherever the layout and alignment allow, and filters it in
//     shared memory; the Stockham route filters in registers. Both use
//     precise sincosf for the outer phase (the azimuth and RCMC phases are
//     not small). Lines past the end of a ragged tile are zero-filled and
//     never stored.

// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// -shared -Xcompiler -fPIC (no --use_fast_math); bound through ctypes by
// src/repro_torch/kernels/_build.py and src/repro_torch/kernels/ops.py.

#include "long_lines.cuh"

// spectral_long_forms.cu includes this source with SPECTRAL_LONG_FORMS
// set, to build spectral_long's forms other than f32 alone (no tile
// kernel, no spectral_launch) into a library of their own.
#ifndef SPECTRAL_LONG_FORMS
#define SPECTRAL_LONG_FORMS 0
#endif

namespace {

using namespace spectral;

#if !SPECTRAL_LONG_FORMS

struct Args {
  const float* xr;
  const float* xi;
  float* yr;
  float* yi;
  Dft d;
  Filter f;
  int lines;          // lines per scene (the free axis)
  int axis, fwd, inv;
  int tile;           // lines per CTA
};

// One tile of whole lines per CTA: grid (tiles, batch). The matmul route
// keeps F1 and F2 in shared memory past the tile, and with kBs (bs16) the
// codec's exponent a line past them; the Stockham route with kBs the
// codec's words past the tile (codec_words). kOp, kKara: the matmul
// route's operand form (transform_k; kKara 0 or 1 here).
template <bool kStockham, bool kBs = false, int kOp = kTf32x3, int kKara = 0>
__device__ __forceinline__ void spectral_tile(const Args& a) {
  extern __shared__ float2 s[];
  Mats m{};
  if constexpr (!kStockham) {
    if (a.fwd || a.inv) {
      m = mats_to_shared(reinterpret_cast<float*>(s + a.tile * a.d.n), a.d);
    }
  }
  tile_op<kStockham, 0, kBs, kOp, kKara>(
      s, a.xr, a.xi, a.yr, a.yi, (long long)blockIdx.y * a.lines * a.d.n,
      a.lines, blockIdx.x * a.tile, a.tile, a.axis, a.fwd, a.inv, a.d, m,
      a.f);
}

// The matmul route, every operand form: f32 (3xTF32), bf16, f16, bs16
// (kBs with f16), each with or without Karatsuba (kKara = 1).
template <bool kStockham, bool kBs, int kOp, int kKara>
__global__ void __launch_bounds__(kMmaThreads)
spectral_kernel(const Args a) {
  static_assert(!kStockham, "the Stockham route's kernels follow");
  spectral_tile<false, kBs, kOp, kKara>(a);
}

// Naming the blocks an SM holds gives ptxas the register file of the
// thread bound (128 at 512 threads; a 256-thread row tile runs two blocks
// an SM): with the bound alone it held the kernel to 32 registers once
// the kernel made a call.
template <>
__global__ void __launch_bounds__(kStockhamThreads, 1)
spectral_kernel<true, false, kTf32x3, 0>(const Args a) {
  spectral_tile<true>(a);
}

template <>
__global__ void __launch_bounds__(kStockhamThreads, 1)
spectral_kernel<true, true, kTf32x3, 0>(const Args a) {
  spectral_tile<true, true>(a);
}

template <class K>
cudaError_t launch(K kernel, const Args& a, int batch, int threads,
                   size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lines + a.tile - 1) / a.tile, batch);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The matmul route's instantiation of one operand form.
template <bool kBs, int kOp>
cudaError_t launch_mma(const Args& a, bool kara, int batch, int threads,
                       size_t smem, cudaStream_t st) {
  return kara ? launch(spectral_kernel<false, kBs, kOp, 1>, a, batch,
                       threads, smem, st)
              : launch(spectral_kernel<false, kBs, kOp, 0>, a, batch,
                       threads, smem, st);
}

cudaError_t launch_form(const Args& a, int op, bool bs, bool kara, int batch,
                        int threads, size_t smem, cudaStream_t st) {
  if (bs) {   // bs16: f16 operands behind the codec
    return op == kF16 ? launch_mma<true, kF16>(a, kara, batch, threads, smem,
                                               st)
                      : cudaErrorInvalidValue;
  }
  switch (op) {
    case kTf32x3:
      return launch_mma<false, kTf32x3>(a, kara, batch, threads, smem, st);
    case kBf16:
      return launch_mma<false, kBf16>(a, kara, batch, threads, smem, st);
    case kF16:
      return launch_mma<false, kF16>(a, kara, batch, threads, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

#endif  // !SPECTRAL_LONG_FORMS

// One op on lines past one block (or a three-factor split): every
// device-memory pass of long_lines.cuh, a grid barrier between two, in one
// cooperative launch on the co-resident blocks. Naming one block per SM
// gives ptxas the register file of the thread bound, as for mega_staged.
struct LongArgs {
  LongOp op;
};

template <bool kStockham>
__global__ void __launch_bounds__(kLongThreads, 1)
spectral_long(const __grid_constant__ LongArgs a) {
  extern __shared__ float2 s[];
  long_op_form<kStockham, kTf32x3, 0, false>(s, a.op, LongForm{});
}

// The same at the other forms (kOp, kKara, kBs: long_op_form's), the
// codec's words and the Karatsuba flag beside the op.
struct LongFormArgs {
  LongOp op;
  LongForm form;
};

template <bool kStockham, int kOp, int kKara, bool kBs>
__global__ void __launch_bounds__(kLongThreads, 1)
spectral_long_form(const __grid_constant__ LongFormArgs a) {
  extern __shared__ float2 s[];
  long_op_form<kStockham, kOp, kKara, kBs>(s, a.op, a.form);
}

}  // namespace

extern "C" {

#if !SPECTRAL_LONG_FORMS

// Launches one fused spectral op on `stream`; returns cudaGetLastError()
// after the launch (0 on success). `stw` (the Stockham twiddle table, or
// null) selects the route and with it the instantiation: the four-step
// stages read f1*, f2*, tw* with N = n1 * n2 (at most 512 threads) on the
// operand form `op` (0 f32 as 3xTF32, 1 bf16, 2 f16; with block_scaled,
// bs16) with Karatsuba's 3 products when `karatsuba`; Stockham reads stw
// alone (at most 512 threads, stockham_per_thread points a thread, a tile
// op that is built: threads = tile * n / points puts no thread idle, which
// per-line barriers need) and takes no operand form (bf16 and f16 run its
// f32 passes). The caller has checked shapes, types, devices and
// contiguity. block_scaled: the bs16 codec around the op (a filter-only
// launch, which runs no stage, takes it on the Stockham instantiation,
// with the tile and threads the host gave).
int spectral_launch(const float* xr, const float* xi, float* yr, float* yi,
                    int batch, int lines, int n, int n1, int n2, int axis,
                    int fwd, int inv, int mode, const float* f1r,
                    const float* f1i, const float* f2r, const float* f2i,
                    const float* twr, const float* twi, const float* stw,
                    const float* hr,
                    const float* hi, const float* u, const float* v, int rank,
                    long long h_line, long long h_k, long long u_line,
                    long long u_k, long long v_n, long long v_k, int tile,
                    int threads, int block_scaled, int op, int karatsuba,
                    void* stream) {
  Args a;
  a.xr = xr; a.xi = xi; a.yr = yr; a.yi = yi;
  a.d = Dft{f1r, f1i, f2r, f2i, twr, twi,
            reinterpret_cast<const float2*>(stw), n, n1, n2};
  a.f = Filter{hr, hi, u, v, h_line, h_k, u_line, u_k, v_n, v_k, mode, rank};
  a.lines = lines;
  a.axis = axis; a.fwd = fwd; a.inv = inv;
  a.tile = tile;
  const bool any_fft = fwd || inv;
  if (op < kTf32x3 || op > kF16 || (block_scaled && op != kF16)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool stockham = stw != nullptr || (block_scaled && !any_fft);
  const int per = stockham_per_thread(tile * n, n, threads);   // Stockham
  if (stockham ? threads > kStockhamThreads || threads * per < tile * n ||
                     !stockham_tile_built(axis, n, per)
               : threads > kMmaThreads || threads % 32 != 0 ||
                     (any_fft && !(mma_fits(threads, n1, n2) &&
                                     mma_fits(threads, n2, n1)))) {
    return (int)cudaErrorInvalidConfiguration;
  }
  if (any_fft && (stockham ? n < 2 || (n & (n - 1)) != 0
                             : n1 * n2 != n)) {
    return (int)cudaErrorInvalidValue;
  }
  size_t smem = (size_t)tile * n * sizeof(float2);
  if (stockham) smem = (size_t)stockham_points(tile * n) * sizeof(float2);
  if (!stockham && any_fft) smem += dft_smem_floats(n1, n2) * sizeof(float);
  if (block_scaled) {
    smem += (stockham ? codec_words(tile, threads) : tile) * sizeof(int);
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (stockham) {
    return (int)(block_scaled
                     ? launch(spectral_kernel<true, true, kTf32x3, 0>, a,
                              batch, threads, smem, st)
                     : launch(spectral_kernel<true, false, kTf32x3, 0>, a,
                              batch, threads, smem, st));
  }
  if (!any_fft) {   // a filter-only launch runs no stage: the f32 form
    op = kTf32x3;
    karatsuba = 0;
  }
  return (int)launch_form(a, op, block_scaled, karatsuba, batch, threads,
                          smem, st);
}

#endif  // !SPECTRAL_LONG_FORMS

// Launches one op on lines past one block — fwd / inv / fwd+inv, any
// filter, or filter-only — on `stream` (returns the launch's error, 0 on
// success): the (batch, na, nr) scene layout of mega.cu, rows (axis 1,
// lines of nr points) or columns (axis 0, lines of na points), and one
// segment record of long_lines.cuh (kSegFields int64) with its `on` set
// (its kara field: Karatsuba on the matmul route). The Stockham table of
// the tail (non-null) selects the Stockham route. block_scaled, op: as
// spectral_launch's (a filter-only op runs no stage: the f32 form, or with
// the codec the Stockham instantiation); ex: bs16's words, one int a
// (scene, line) of the op's lines (the kernel zeroes them), null
// otherwise. The f32 form (the Stockham route's bf16 and f16 too)
// launches from spectral.cu's library, the others from
// spectral_long_forms.cu's; each refuses the other's.
int spectral_long_launch(const float* xr, const float* xi, float* yr,
                         float* yi, int batch, int na, int nr,
                         const long long* rec, int block_scaled, int op,
                         unsigned* ex, void* stream) {
  if (batch < 1 || na < 1 || nr < 1 || op < kTf32x3 || op > kF16 ||
      (block_scaled && (op != kF16 || ex == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const bool any_fft = rec[1] || rec[2];
  if (!any_fft) op = kTf32x3;
  Segment g{};
  const cudaError_t err = unpack_segment(rec, rec[0] == 1 ? nr : na, g, op,
                                         block_scaled != 0);
  if (err != cudaSuccess) return (int)err;
  if (!g.lg.on) return (int)cudaErrorInvalidValue;
  const LongOp lop = long_op_of(g, xr, xi, yr, yi, batch, na, nr);
  const bool stockham = g.d.stw != nullptr || (!any_fft && block_scaled);
  const bool form =
      block_scaled || (!stockham && (op != kTf32x3 || g.kara));
  if (form != (SPECTRAL_LONG_FORMS != 0)) return (int)cudaErrorInvalidValue;
  const size_t smem = long_smem(lop, stockham, block_scaled != 0);
  const long long work = long_work(lop);
  const cudaStream_t st = (cudaStream_t)stream;
#if !SPECTRAL_LONG_FORMS
  LongArgs a{lop};
  return (int)(stockham ? launch_cooperative(spectral_long<true>, a,
                                             kLongThreads, smem, work, st)
                        : launch_cooperative(spectral_long<false>, a,
                                             kLongThreads, smem, work, st));
#else
  LongFormArgs a{lop, LongForm{ex, g.kara}};
  auto go = [&](auto kernel) {
    return (int)launch_cooperative(kernel, a, kLongThreads, smem, work, st);
  };
  if (stockham) return go(spectral_long_form<true, kTf32x3, 0, true>);
  if (block_scaled) return go(spectral_long_form<false, kF16, 2, true>);
  switch (op) {
    case kTf32x3:
      return go(spectral_long_form<false, kTf32x3, 2, false>);
    case kBf16:
      return go(spectral_long_form<false, kBf16, 2, false>);
    default:
      return go(spectral_long_form<false, kF16, 2, false>);
  }
#endif
}

#if !SPECTRAL_LONG_FORMS
// Blocks of spectral_long (stockham != 0: the Stockham route's) one SM
// holds with `smem` bytes of dynamic shared memory, after setting the
// attribute (-1 on error): its cooperative grid is this times the SM
// count, at most the op's tiles.
int spectral_long_blocks_per_sm(long long smem, int stockham) {
  auto per = [&](auto kernel) {
    int per_sm = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kLongThreads, (size_t)smem) != cudaSuccess) {
      return -1;
    }
    return per_sm;
  };
  return stockham ? per(spectral_long<true>) : per(spectral_long<false>);
}
#endif

const char* spectral_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
