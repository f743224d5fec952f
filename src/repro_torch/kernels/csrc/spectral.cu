// Fused spectral kernel for Hopper (sm_90a): [FFT] -> filter -> [IFFT]
// along one axis of a batch of lines, in ONE launch.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/fft4step.py:598
// `_spectral_kernel` (built by `build_spectral_call`, pallas_call at
// fft4step.py:728, wrapped by src/repro/kernels/ops.py:66 `spectral_op`),
// at float32 with karatsuba=False, fft_impl="matmul", N <= 4096, both
// layouts (rows: (B, lines, N); cols: (B, N, lines)), all five filter
// modes (rank-K outer), fwd-only / inv-only / fwd+inv / filter-only.
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
//
// Design:
//   * A CTA holds a tile of whole lines in shared memory (complex,
//     interleaved): rows take 4096/N lines (one 32 KiB line at N=4096);
//     cols take at least 4 adjacent columns so that global loads of the
//     strided column layout come in 16-byte runs (128 KiB at N=4096,
//     opted in with cudaFuncAttributeMaxDynamicSharedMemorySize).
//   * N = n1 * n2. The forward transform runs two in-place stages:
//       A: a[k1, r]  = tw[k1, r] * sum_j1 F1[k1, j1] x[j1 * n2 + r]
//       B: z[k1, k2] = sum_r a[k1, r] F2[r, k2]
//     and leaves the spectrum in the transposed layout
//     s[k1 * n2 + k2] = X[k2 * n1 + k1]. The inverse (conj-FFT-conj)
//     runs the swapped factorization (n2, n1) on that layout, whose
//     input order it is, and ends in natural order — so fwd+inv needs no
//     permutation at all; fwd-only permutes on the store, inv-only on
//     the load. Every stage reads only its own row or column group of
//     the tile, so each thread stages its 16 outputs in registers, the
//     CTA syncs, and the outputs overwrite their inputs in place.
//   * Inner loops are FFMA in float32 (no tensor cores, no TF32); the
//     warp reads consecutive shared-memory words and a broadcast (or
//     coalesced, L1-resident) DFT-matrix entry per step. The DFT
//     matrices and twiddles are the float32 tensors of
//     `dft_constants(n1, n2)`; DFT matrices are symmetric, which both
//     stage orientations use.
//   * The filter runs on the tile in shared memory, with precise
//     sincosf for the outer phase (the azimuth and RCMC phases are not
//     small). Lines past the end of a ragged tile are zero-filled and
//     never stored.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math); bound through ctypes by
// src/repro_torch/kernels/_build.py and src/repro_torch/kernels/ops.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPerThread = 16;   // outputs each thread stages per stage
constexpr int kMaxThreads = 1024;

enum FilterMode { kNone = 0, kShared = 1, kFull = 2, kOuter = 3,
                  kSharedOuter = 4 };

struct Args {
  const float* xr;
  const float* xi;
  float* yr;
  float* yi;
  const float* f1r;   // (n1, n1)
  const float* f1i;
  const float* f2r;   // (n2, n2)
  const float* f2i;
  const float* twr;   // (n1, n2)
  const float* twi;
  const float* hr;    // shared (n,); full (lines, n) rows / (n, lines) cols
  const float* hi;
  const float* u;     // element (line, k) at u[line * u_line + k * u_k]
  const float* v;     // element (sample, k) at v[sample * v_n + k * v_k]
  long long u_line, u_k, v_n, v_k;
  int lines;          // lines per scene (the free axis)
  int n, n1, n2;
  int axis, fwd, inv, mode, rank;
  int tile;           // lines per CTA
};

// One in-place contraction stage over the tile. Output o of the tile is
// (line c, position rem = hi * n2 + lo) and overwrites position rem.
//   kColumn: out[hi, lo] = sum_j M[hi, j] * s[j * n2 + lo]   (M is n1 x n1)
//   !kColumn: out[hi, lo] = sum_j s[hi * n2 + j] * M[j, lo]  (M is n2 x n2)
// then times tw[rem] when tw is given; conj_in conjugates the inputs.
template <bool kColumn>
__device__ __forceinline__ void stage(float2* s, int total, int n, int n1,
                                      int n2, const float* __restrict__ mr,
                                      const float* __restrict__ mi,
                                      const float* __restrict__ twr,
                                      const float* __restrict__ twi,
                                      bool conj_in) {
  float2 stash[kPerThread];
  const float sgn = conj_in ? -1.0f : 1.0f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int o = threadIdx.x + i * blockDim.x;
    if (o < total) {
      const int c = o / n;
      const int rem = o - c * n;
      const int hi = rem / n2;
      const int lo = rem - hi * n2;
      const float2* line = s + c * n;
      float ar = 0.0f, ai = 0.0f;
      if (kColumn) {
        const float* fr = mr + hi * n1;
        const float* fi = mi + hi * n1;
#pragma unroll 4
        for (int j = 0; j < n1; ++j) {
          const float2 x = line[j * n2 + lo];
          const float xi = sgn * x.y;
          const float a = __ldg(fr + j), b = __ldg(fi + j);
          ar = fmaf(a, x.x, ar);
          ar = fmaf(-b, xi, ar);
          ai = fmaf(a, xi, ai);
          ai = fmaf(b, x.x, ai);
        }
      } else {
        const float2* row = line + hi * n2;
#pragma unroll 4
        for (int j = 0; j < n2; ++j) {
          const float2 x = row[j];
          const float xi = sgn * x.y;
          const float a = __ldg(mr + j * n2 + lo), b = __ldg(mi + j * n2 + lo);
          ar = fmaf(a, x.x, ar);
          ar = fmaf(-b, xi, ar);
          ai = fmaf(a, xi, ai);
          ai = fmaf(b, x.x, ai);
        }
      }
      if (twr != nullptr) {
        const float tr = __ldg(twr + rem), ti = __ldg(twi + rem);
        const float yr = ar * tr - ai * ti;
        const float yi = ar * ti + ai * tr;
        ar = yr;
        ai = yi;
      }
      stash[i] = make_float2(ar, ai);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int o = threadIdx.x + i * blockDim.x;
    if (o < total) s[o] = stash[i];
  }
  __syncthreads();
}

__device__ __forceinline__ float2 cmul(float2 a, float br, float bi) {
  return make_float2(a.x * br - a.y * bi, a.x * bi + a.y * br);
}

__global__ void __launch_bounds__(kMaxThreads)
spectral_kernel(const Args a) {
  extern __shared__ float2 s[];
  const int n = a.n, n1 = a.n1, n2 = a.n2, C = a.tile;
  const int total = C * n;
  const int T = blockDim.x;
  const int line0 = blockIdx.x * C;
  const int valid = min(C, a.lines - line0);
  const long long scene = (long long)blockIdx.y * a.lines * n;
  const bool transform = a.fwd || a.inv;
  const bool perm_in = !a.fwd && a.inv;    // load into the transposed layout
  const bool perm_out = a.fwd && !a.inv;   // store out of it

  // ---- load the tile (zero-fill lines past a ragged end) ----
  for (int idx = threadIdx.x; idx < total; idx += T) {
    int c, j;
    if (a.axis == 1) { c = idx / n; j = idx - c * n; }
    else { j = idx / C; c = idx - j * C; }
    float2 val = make_float2(0.0f, 0.0f);
    if (c < valid) {
      const long long g = scene + (a.axis == 1
          ? (long long)(line0 + c) * n + j
          : (long long)j * a.lines + line0 + c);
      val = make_float2(a.xr[g], a.xi[g]);
    }
    const int p = perm_in ? (j % n1) * n2 + j / n1 : j;
    s[c * n + p] = val;
  }
  __syncthreads();

  if (a.fwd) {
    stage<true>(s, total, n, n1, n2, a.f1r, a.f1i, a.twr, a.twi, false);
    stage<false>(s, total, n, n1, n2, a.f2r, a.f2i, nullptr, nullptr, false);
  }

  // ---- filter, in the transposed layout whenever a transform runs ----
  if (a.mode != kNone) {
    for (int o = threadIdx.x; o < total; o += T) {
      const int c = o / n;
      if (c >= valid) continue;
      const int p = o - c * n;
      const int k = transform ? (p % n2) * n1 + p / n2 : p;
      const long long gl = line0 + c;
      float2 x = s[o];
      if (a.mode == kShared || a.mode == kSharedOuter) {
        x = cmul(x, a.hr[k], a.hi[k]);
      } else if (a.mode == kFull) {
        const long long g = a.axis == 1 ? gl * n + k : (long long)k * a.lines + gl;
        x = cmul(x, a.hr[g], a.hi[g]);
      }
      if (a.mode == kOuter || a.mode == kSharedOuter) {
        float ph = 0.0f;
        for (int q = 0; q < a.rank; ++q) {
          ph = fmaf(a.u[gl * a.u_line + q * a.u_k],
                    a.v[(long long)k * a.v_n + q * a.v_k], ph);
        }
        float sn, cs;
        sincosf(ph, &sn, &cs);
        x = cmul(x, cs, sn);
      }
      s[o] = x;
    }
    __syncthreads();
  }

  if (a.inv) {
    // conj-FFT-conj over the swapped factorization (n2, n1)
    stage<false>(s, total, n, n1, n2, a.f2r, a.f2i, a.twr, a.twi, true);
    stage<true>(s, total, n, n1, n2, a.f1r, a.f1i, nullptr, nullptr, false);
  }

  // ---- store (conj and 1/N of the inverse folded in) ----
  const float scale = a.inv ? 1.0f / (float)n : 1.0f;
  const float iscale = a.inv ? -scale : 1.0f;
  for (int idx = threadIdx.x; idx < total; idx += T) {
    int c, j;
    if (a.axis == 1) { c = idx / n; j = idx - c * n; }
    else { j = idx / C; c = idx - j * C; }
    if (c >= valid) continue;
    const int p = perm_out ? (j % n1) * n2 + j / n1 : j;
    const float2 val = s[c * n + p];
    const long long g = scene + (a.axis == 1
        ? (long long)(line0 + c) * n + j
        : (long long)j * a.lines + line0 + c);
    a.yr[g] = val.x * scale;
    a.yi[g] = val.y * iscale;
  }
}

}  // namespace

extern "C" {

// Launches one fused spectral op on `stream`; returns cudaGetLastError()
// after the launch (0 on success). The caller has checked shapes, types,
// devices and contiguity.
int spectral_launch(const float* xr, const float* xi, float* yr, float* yi,
                    int batch, int lines, int n, int n1, int n2, int axis,
                    int fwd, int inv, int mode, const float* f1r,
                    const float* f1i, const float* f2r, const float* f2i,
                    const float* twr, const float* twi, const float* hr,
                    const float* hi, const float* u, const float* v, int rank,
                    long long u_line, long long u_k, long long v_n,
                    long long v_k, int tile, int threads, void* stream) {
  Args a;
  a.xr = xr; a.xi = xi; a.yr = yr; a.yi = yi;
  a.f1r = f1r; a.f1i = f1i; a.f2r = f2r; a.f2i = f2i;
  a.twr = twr; a.twi = twi;
  a.hr = hr; a.hi = hi; a.u = u; a.v = v;
  a.u_line = u_line; a.u_k = u_k; a.v_n = v_n; a.v_k = v_k;
  a.lines = lines; a.n = n; a.n1 = n1; a.n2 = n2;
  a.axis = axis; a.fwd = fwd; a.inv = inv; a.mode = mode; a.rank = rank;
  a.tile = tile;
  if (threads > kMaxThreads || threads * kPerThread < tile * n) {
    return (int)cudaErrorInvalidConfiguration;
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
