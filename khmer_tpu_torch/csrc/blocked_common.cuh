// Device helpers shared by the blocked Count-Min kernels.
//
// Layout (khmer_tpu_torch/core/blocked.py): table[nblocks][128] u8;
// a hash h lives in block h % nblocks, and its four sub-counters sit at
// lanes 32*t + ((mix64(h) >> 5t) & 31), t = 0..3, one per 32-lane
// quarter. Hashes arrive as int64 tensors holding u64 bit patterns. The
// block is reduced by the reciprocal of nblocks (u64_common.cuh), which
// the entry points compute on the host.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"
#include "u64_common.cuh"

namespace khmer_blocked {

using khmer_cuda::grid_for;
using khmer_cuda::kMaxCount;
using khmer_cuda::kThreads;

constexpr int kLanes = 128;
constexpr int kSub = 4;
constexpr int kQuart = kLanes / kSub;

// splitmix64 finalizer (core/blocked.py mix64)
__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

// Flat index of the first lane of h's block: (h % nblocks) * kLanes, with
// recip = khmer_cuda::reciprocal(nblocks).
__device__ __forceinline__ uint64_t row_of(uint64_t h, uint64_t nblocks,
                                          uint64_t recip) {
  return khmer_cuda::reduce(h, nblocks, recip) * kLanes;
}

// Flat table index of sub-counter t; row = row_of(h, ...), m = mix64(h).
__device__ __forceinline__ uint64_t lane_index(uint64_t row, uint64_t m,
                                               int t) {
  return row + kQuart * t + ((m >> (5 * t)) & (kQuart - 1));
}

}  // namespace khmer_blocked
