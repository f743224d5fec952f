// Asynchronous copies from device memory into shared memory (sm_80+):
// cp.async.cg (16 bytes, cached in L2 only, as __ldcg reads), their
// commit groups and the wait for all but the newest N groups of the
// calling thread. A barrier after the wait makes every thread's copies
// visible to the block.
#pragma once

#include <cuda_runtime.h>

namespace spectral {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN) : "memory");
}

}  // namespace spectral
