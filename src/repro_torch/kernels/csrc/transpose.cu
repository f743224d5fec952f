// Tiled corner turn for Hopper (sm_90a): (B, R, C) -> (B, C, R) in ONE
// launch, for 4-byte (float32) and 8-byte (complex64 read as float2)
// elements.
//
// Replaces: the Pallas TPU kernels src/repro/kernels/transpose.py:26
// `_transpose_kernel` and :30 `_transpose_kernel_b` (pallas_calls at
// transpose.py:49 and :59, wrapped by `transpose`), used by the
// paper-faithful `fused` RDA for its four global corner turns.
//
// What bounds it on an H100 SXM: a transpose does no arithmetic; it reads
// the array once and writes it once. At the paper's 4096 x 4096 complex64
// scene that is 2 x 128 MiB = 268 MB a turn, 0.080 ms at the spec sheet's
// 3.35 TB/s, and 0.32 ms for `fused`'s four turns. So it is bound by bytes,
// and the design is about moving them at full rate:
//   * a block of 32 x 8 threads turns one 32 x 32 tile through shared
//     memory, each thread moving 4 elements in and 4 out, so that a warp
//     reads 32 consecutive elements of an input row and writes 32
//     consecutive elements of an output row (128-byte rows of f32, 256-byte
//     rows of float2: coalesced both ways);
//   * the tile has one padding column (32 x 33), so the column reads from
//     shared memory fall in different banks (f32: bank = lane; float2:
//     each half-warp covers the 32 banks once) — no bank conflicts;
//   * grid (ceil(C/32), ceil(R/32), B); the kernel masks the ragged edge
//     itself, so no padding is needed — the Hopper counterpart of the
//     reference's pad-to-tile-and-slice.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// -shared -Xcompiler -fPIC; bound through ctypes by
// src/repro_torch/kernels/_build.py and src/repro_torch/kernels/transpose.py.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;    // thread rows of a block: 4 elements a thread

template <typename T>
__global__ void __launch_bounds__(kTile * kRows)
transpose_kernel(const T* __restrict__ x, T* __restrict__ y, int R, int C) {
  __shared__ T tile[kTile][kTile + 1];
  const long long base = (long long)blockIdx.z * R * C;
  const int c = blockIdx.x * kTile + threadIdx.x;   // input column
  const int r0 = blockIdx.y * kTile + threadIdx.y;  // input row
#pragma unroll
  for (int j = 0; j < kTile; j += kRows) {
    const int r = r0 + j;
    if (r < R && c < C) {
      tile[threadIdx.y + j][threadIdx.x] = x[base + (long long)r * C + c];
    }
  }
  __syncthreads();
  const int oc = blockIdx.y * kTile + threadIdx.x;   // output column (< R)
  const int or0 = blockIdx.x * kTile + threadIdx.y;  // output row (< C)
#pragma unroll
  for (int j = 0; j < kTile; j += kRows) {
    const int orow = or0 + j;
    if (orow < C && oc < R) {
      y[base + (long long)orow * R + oc] = tile[threadIdx.x][threadIdx.y + j];
    }
  }
}

template <typename T>
int launch(const void* x, void* y, int batch, int rows, int cols,
           cudaStream_t stream) {
  const dim3 grid((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile,
                  batch);
  transpose_kernel<T><<<grid, dim3(kTile, kRows), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), rows, cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one batched transpose of `batch` (rows, cols) arrays of
// `elem_bytes`-byte elements (4 or 8) on `stream`; returns
// cudaGetLastError() after the launch (0 on success). The caller has
// checked shapes, types, devices and contiguity.
int transpose_launch(const void* x, void* y, int batch, int rows, int cols,
                     int elem_bytes, void* stream) {
  if (batch < 1 || batch > 65535 || rows < 1 || cols < 1 ||
      (rows + kTile - 1) / kTile > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (elem_bytes == 4) {
    return launch<float>(x, y, batch, rows, cols, (cudaStream_t)stream);
  }
  if (elem_bytes == 8) {
    return launch<float2>(x, y, batch, rows, cols, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

const char* transpose_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
