// Unsigned 64-bit helpers shared by both layouts' kernels (counterpart of
// khmer_tpu_torch/ops/u64.py): the reduction h % p by a reciprocal that
// the host computes once, in place of the software division nvcc emits
// for a 64-bit `%` by a run-time divisor.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace khmer_cuda {

// floor((2^64 - 1) / p), the constant reduce() takes; p in [1, 2^63).
inline uint64_t reciprocal(uint64_t p) { return ~0ULL / p; }

// h % p for a run-time p in [1, 2^63), by its reciprocal m = floor((2^64 -
// 1) / p). With 2^64 - 1 = m p + s, 0 <= s < p: h m / 2^64 = h / p - h (1 + s) /
// (p 2^64), and h (1 + s) < p 2^64, so q = umulhi(h, m) is floor(h / p) or
// one less, r = h - q p lies in [0, 2p), and one subtraction ends it. Exact
// for every u64 h; khmer_tpu_torch/ops/u64.py umod_reciprocal mirrors the
// steps.
__device__ __forceinline__ uint64_t reduce(uint64_t h, uint64_t p,
                                           uint64_t m) {
  const uint64_t r = h - __umul64hi(h, m) * p;
  return r >= p ? r - p : r;
}

}  // namespace khmer_cuda
