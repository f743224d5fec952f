// A CPU mock of the CUDA runtime for running the kernels' device code with
// g++: one std::thread a CUDA thread, std::barrier for __syncthreads, the
// grid run block after block (a grid barrier is then a block barrier: the
// occupancy query says one block on one SM).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <math.h>
#include <mutex>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __grid_constant__

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct uint3 { unsigned x = 0, y = 0, z = 0; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9,
  cudaErrorNotSupported = 801, cudaErrorCooperativeLaunchTooLarge = 720
};
enum cudaDeviceAttr {
  cudaDevAttrCooperativeLaunch = 95, cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

inline thread_local uint3 threadIdx;
inline thread_local uint3 blockIdx;
inline dim3 blockDim, gridDim;

struct MockWarp {
  std::barrier<> bar{32};
  uint32_t slot[32][8];
};
struct MockBlock {
  std::barrier<>* bar;
  std::vector<MockWarp*> warps;
  void* smem;
};
inline thread_local MockBlock* g_block = nullptr;
inline thread_local int g_lane = 0;

inline void __syncthreads() { g_block->bar->arrive_and_wait(); }
inline void mock_bar_sync(int id, int) {
  if (id != 0) { fprintf(stderr, "mock: named barrier %d\n", id); abort(); }
  __syncthreads();
}
inline MockWarp& mock_warp() { return *g_block->warps[threadIdx.x / 32]; }
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  MockWarp& w = mock_warp();
  w.slot[g_lane][0] = v;
  w.bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r = std::max(r, w.slot[i][0]);
  w.bar.arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int off) {
  MockWarp& w = mock_warp();
  memcpy(&w.slot[g_lane][0], &v, 4);
  w.bar.arrive_and_wait();
  float r;
  memcpy(&r, &w.slot[g_lane ^ off][0], 4);
  w.bar.arrive_and_wait();
  return r;
}

template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int u) { float f; memcpy(&f, &u, 4); return f; }
inline int __ffs(int v) { return __builtin_ffs(v); }
[[noreturn]] inline void __trap() { fprintf(stderr, "mock: __trap\n"); abort(); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline unsigned max(unsigned a, unsigned b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }
inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> r(*p);
  unsigned old = r.load();
  while (old < v && !r.compare_exchange_weak(old, v)) {}
  return old;
}

template <class T> inline T* mock_smem() { return static_cast<T*>(g_block->smem); }

inline size_t g_smem_bytes = 0;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrCooperativeLaunch ? 1
     : a == cudaDevAttrMultiProcessorCount ? 1 : 232448;
  return cudaSuccess;
}
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "mock error"; }

template <class A>
cudaError_t mock_launch(void (*fn)(A), dim3 grid, dim3 block, size_t smem, A a) {
  if (smem > 232448) return cudaErrorInvalidValue;
  blockDim = block;
  gridDim = grid;
  const int nt = block.x * block.y * block.z;
  std::vector<float> mem((smem + 3) / 4 + 64, std::nanf(""));
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    std::fill(mem.begin(), mem.end(), std::nanf(""));
    std::barrier<> bar(nt);
    MockBlock blk{&bar, {}, mem.data()};
    for (int w = 0; w < (nt + 31) / 32; ++w) blk.warps.push_back(new MockWarp);
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t) {
      ts.emplace_back([&, t] {
        g_block = &blk;
        g_lane = t % 32;
        threadIdx.x = t % block.x;
        threadIdx.y = (t / block.x) % block.y;
        threadIdx.z = t / (block.x * block.y);
        blockIdx.x = bx; blockIdx.y = by; blockIdx.z = bz;
        fn(a);
      });
    }
    for (auto& th : ts) th.join();
    for (auto* w : blk.warps) delete w;
  }
  return cudaSuccess;
}

template <class A>
cudaError_t cudaLaunchCooperativeKernel(void (*fn)(A), dim3 grid, dim3 block,
                                        void** params, size_t smem, cudaStream_t) {
  return mock_launch(fn, grid, block, smem, *static_cast<A*>(params[0]));
}
