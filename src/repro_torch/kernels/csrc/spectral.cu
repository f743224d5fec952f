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
// `_fft_stockham` inside it (N any power of two from 2 to 4096).
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

#include "spectral_common.cuh"

namespace {

using namespace spectral;

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

}  // namespace

extern "C" {

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

const char* spectral_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
