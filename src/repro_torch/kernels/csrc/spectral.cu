// Fused spectral kernel for Hopper (sm_90a): [FFT] -> filter -> [IFFT]
// along one axis of a batch of lines, in ONE launch.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/fft4step.py:598
// `_spectral_kernel` (built by `build_spectral_call`, pallas_call at
// fft4step.py:728, wrapped by src/repro/kernels/ops.py:66 `spectral_op`),
// at float32 with karatsuba=False, N <= 4096, both layouts (rows:
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
// So by the nominal count it is bound by bytes. The four-step FFMA form
// used here does 8 N (n1 + n2) real flops per transform, ~34 GFLOP for
// that launch (~0.5 ms at 67 TFLOP/s), so its arithmetic floor sits
// above the memory bound; closing that gap (tensor-core stages for the
// reduced precisions, register tiling of the contractions) is later work.
// The Stockham route does ~5 N log2 N flops a transform, the nominal
// count, so its arithmetic floor is below the memory bound; what it
// spends time on is its log4 N in-place passes over the tile in shared
// memory (one load and one store a point a pass, two barriers a pass).
//
// Design:
//   * A CTA holds a tile of whole lines in shared memory (complex,
//     interleaved): rows take 4096/N lines (one 32 KiB line at N=4096);
//     cols take at least 4 adjacent columns so that global loads of the
//     strided column layout come in 16-byte runs (128 KiB at N=4096,
//     opted in with cudaFuncAttributeMaxDynamicSharedMemorySize).
//   * N = n1 * n2, two in-place four-step stages per transform, the
//     spectrum left in the transposed order between a forward and an
//     inverse transform (spectral_common.cuh, shared with mega.cu), so
//     fwd+inv permutes nothing; fwd-only permutes on the store, inv-only
//     on the load. Every stage reads only its own row or column group of
//     the tile, so each thread stages its 16 outputs in registers, the
//     CTA syncs, and the outputs overwrite their inputs in place.
//   * Inner loops are FFMA in float32 (no tensor cores, no TF32); the
//     warp reads consecutive shared-memory words and a broadcast (or
//     coalesced, L1-resident) DFT-matrix entry per step. The DFT
//     matrices and twiddles are the float32 tensors of
//     `dft_constants(n1, n2)`; DFT matrices are symmetric, which both
//     stage orientations use.
//   * fft_impl="stockham" replaces the two stages of each transform by
//     the radix-4/radix-2 Stockham passes of spectral_common.cuh, in place
//     on the same tile with the same register staging; it is
//     self-sorting, so nothing is permuted on load or store and the
//     filter index is the natural one. Its twiddles are read from the
//     table fft4step.stockham_table builds on the host (the plain version
//     reads the same numbers), not computed in the kernel.
//   * The filter runs on the tile in shared memory, with precise
//     sincosf for the outer phase (the azimuth and RCMC phases are not
//     small). Lines past the end of a ragged tile are zero-filled and
//     never stored.
//
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

// One tile of whole lines per CTA: grid (tiles, batch).
__global__ void __launch_bounds__(kMaxThreads)
spectral_kernel(const Args a) {
  extern __shared__ float2 s[];
  tile_op(s, a.xr, a.xi, a.yr, a.yi,
          (long long)blockIdx.y * a.lines * a.d.n, a.lines,
          blockIdx.x * a.tile, a.tile, a.axis, a.fwd, a.inv, a.d, a.f);
}

}  // namespace

extern "C" {

// Launches one fused spectral op on `stream`; returns cudaGetLastError()
// after the launch (0 on success). `stw` (the Stockham twiddle table, or
// null) selects the route: the four-step stages read f1*, f2*, tw* with
// N = n1 * n2; Stockham reads stw alone. The caller has checked shapes,
// types, devices and contiguity.
int spectral_launch(const float* xr, const float* xi, float* yr, float* yi,
                    int batch, int lines, int n, int n1, int n2, int axis,
                    int fwd, int inv, int mode, const float* f1r,
                    const float* f1i, const float* f2r, const float* f2i,
                    const float* twr, const float* twi, const float* stw,
                    const float* hr,
                    const float* hi, const float* u, const float* v, int rank,
                    long long h_line, long long h_k, long long u_line,
                    long long u_k, long long v_n, long long v_k, int tile,
                    int threads, void* stream) {
  Args a;
  a.xr = xr; a.xi = xi; a.yr = yr; a.yi = yi;
  a.d = Dft{f1r, f1i, f2r, f2i, twr, twi,
            reinterpret_cast<const float2*>(stw), n, n1, n2};
  a.f = Filter{hr, hi, u, v, h_line, h_k, u_line, u_k, v_n, v_k, mode, rank};
  a.lines = lines;
  a.axis = axis; a.fwd = fwd; a.inv = inv;
  a.tile = tile;
  if (threads > kMaxThreads || threads * kPerThread < tile * n) {
    return (int)cudaErrorInvalidConfiguration;
  }
  if ((fwd || inv) && (stw != nullptr ? n < 2 || (n & (n - 1)) != 0
                                      : n1 * n2 != n)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)tile * n * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      spectral_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((lines + tile - 1) / tile, batch);
  spectral_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* spectral_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
