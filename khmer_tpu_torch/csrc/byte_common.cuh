// The exact byte layout: T prime-sized u8 tables joined end to end in one
// flat buffer (khmer_tpu_torch/core/sketch_kernels.py ByteTables). Hash h
// has counter offset_t + h % prime_t in table t. All indices are 64-bit:
// the tables of -x 6e8 -N 4 already exceed 2^31 counters.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"
#include "u64_common.cuh"

namespace khmer_byte {

constexpr int kMaxTables = 32;

// Passed by value as a kernel parameter (776 bytes).
struct ByteLayout {
  int ntables;
  uint64_t primes[kMaxTables];
  uint64_t recips[kMaxTables];  // floor((2^64 - 1) / prime)
  uint64_t offsets[kMaxTables];
};

// Fill a layout from the host arrays the wrapper passes; false when the
// table count is out of range or a prime is not in [1, 2^63).
inline bool make_layout(int ntables, const int64_t* primes,
                        const int64_t* offsets, ByteLayout* out) {
  if (ntables < 1 || ntables > kMaxTables) return false;
  out->ntables = ntables;
  for (int t = 0; t < ntables; ++t) {
    if (primes[t] < 1) return false;
    out->primes[t] = static_cast<uint64_t>(primes[t]);
    out->recips[t] = khmer_cuda::reciprocal(out->primes[t]);
    out->offsets[t] = static_cast<uint64_t>(offsets[t]);
  }
  return true;
}

// h % p_t by the reciprocal (u64_common.cuh reduce)
__device__ __forceinline__ uint64_t counter_index(const ByteLayout& layout,
                                                  uint64_t h, int t) {
  return layout.offsets[t]
         + khmer_cuda::reduce(h, layout.primes[t], layout.recips[t]);
}

// The bigcount table's count for hash h (its u64 keys ascending, n of
// them; sketch_kernels.py bigcount_table), or 255 where it has none.
__device__ __forceinline__ int big_count(const uint64_t* __restrict__ keys,
                                         const int32_t* __restrict__ values,
                                         int64_t n, uint64_t h) {
  int64_t lo = 0;
  int64_t hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (keys[mid] < h) lo = mid + 1; else hi = mid;
  }
  return lo < n && keys[lo] == h ? values[lo] : khmer_cuda::kMaxCount;
}

}  // namespace khmer_byte
