// The canonical 2-bit k-mer hash on the card: the device form of
// khmer_tpu_torch/ops/hashing.py rolling_hash_windows (reference
// include/oxli/kmer_hash.hh:62-96). Codes are the cleaned 2-bit codes
// A=0, T=1, C=2, G=3 (complement = code ^ 1), one byte each.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace khmer_twobit {

// The canonical hash of the k-window starting at `codes`, k in [1, 32]:
// the forward hash packs codes[0..k) most significant first, the reverse
// hash packs their complements least significant first, and the canonical
// value is their unsigned minimum. For k = 32 every bit of the u64 is
// used, and the minimum is taken unsigned, as the host's is.
__device__ __forceinline__ uint64_t canonical(const uint8_t* codes, int k) {
  uint64_t f = 0;
  uint64_t r = 0;
  for (int i = 0; i < k; ++i) {
    const uint64_t c = codes[i];
    f = (f << 2) | c;
    r |= (c ^ 1) << (2 * i);
  }
  return f < r ? f : r;
}

// canonical(), with the k codes loaded at once before any is used: one
// memory latency a window instead of one for every few codes.
__device__ __forceinline__ uint64_t canonical_loads_first(
    const uint8_t* codes, int k) {
  uint32_t c[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) c[i] = i < k ? codes[i] : 0;
  uint64_t f = 0;
  uint64_t r = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i < k) {
      f = (f << 2) | c[i];
      r |= static_cast<uint64_t>(c[i] ^ 1) << (2 * i);
    }
  }
  return f < r ? f : r;
}

// Windows of a read row of `len` codes that a k-mer test counts:
// max(len - k + 1, 0), as khmer_tpu/core/diginorm_scan.py takes nvalid.
__device__ __forceinline__ int n_windows(int len, int k) {
  return len >= k ? len - k + 1 : 0;
}

}  // namespace khmer_twobit
