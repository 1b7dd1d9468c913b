// Launch helpers shared by the port's kernels: one thread per item, 256
// threads a block, and the saturation value of the u8 counters.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace khmer_cuda {

constexpr int kThreads = 256;
constexpr int kMaxCount = 255;

inline unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ int64_t thread_index() {
  return blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
}

}  // namespace khmer_cuda
