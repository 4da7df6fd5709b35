// Host-side launch helpers shared by the port's kernel sources (sm_90a): the
// opt-in to dynamic shared memory beyond 48 KiB, and the blocks of a kernel
// that one SM holds.
#pragma once

#include <cuda_runtime.h>

namespace grt {

// Opts a kernel in to `smem` bytes of dynamic shared memory where that is
// beyond the 48 KiB every launch may have, and does nothing at or below it.
// The opt-in is a property of the kernel, not of a launch: a call above
// 48 KiB sets it to its own bytes, lower than before or not, so every launch
// above 48 KiB calls this for its own bytes just before it launches.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Blocks of `threads` threads of `kernel` that one SM of the current device
// holds with `smem` bytes of dynamic shared memory (after allow_smem); 0
// where the query fails.
template <class Kernel>
inline int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  int per_sm = 0;
  if (allow_smem(kernel, smem) != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)
             != cudaSuccess) {
    return 0;
  }
  return per_sm;
}

}  // namespace grt
