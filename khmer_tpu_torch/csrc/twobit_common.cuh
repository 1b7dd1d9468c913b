// The canonical 2-bit k-mer hash on the card: the device form of
// khmer_tpu_torch/ops/hashing.py rolling_hash_windows (reference
// include/oxli/kmer_hash.hh:62-96). Codes are the cleaned 2-bit codes
// A=0, T=1, C=2, G=3 (complement = code ^ 1), one byte each. Kernels E
// and H pack a segment of a row into 2-bit words (pack_word) and hash each
// window from two of them (hash_at).
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

// 4 codes in the bytes of x (code i in byte i, 2 bits each) packed into 8
// bits: code 0 most significant (msb4) or least significant (lsb4).
__device__ __forceinline__ uint32_t msb4(uint32_t x) {
  return ((x << 6) | (x >> 4) | (x >> 14) | (x >> 24)) & 0xffu;
}
__device__ __forceinline__ uint32_t lsb4(uint32_t x) {
  return (x | (x >> 6) | (x >> 12) | (x >> 18)) & 0xffu;
}

// Codes [p, p + 32) of a row of L codes (zeros past L) as the forward word
// (code p in the top two bits) and the reverse-complement word (code p's
// complement in the low two bits).
__device__ __forceinline__ void pack_word(const uint8_t* row, int p, int L,
                                          uint64_t* fw, uint64_t* rw) {
  uint32_t x[8];
  const uint8_t* src = row + p;
  if (p + 32 <= L && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(src));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(src) + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (p + 4 * i + j < L) x[i] |= uint32_t{src[4 * i + j]} << (8 * j);
      }
    }
  }
  uint64_t f = 0;
  uint64_t r = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t c = x[i] & 0x03030303u;
    f = (f << 8) | msb4(c);
    r |= static_cast<uint64_t>(lsb4(c)) << (8 * i);
  }
  *fw = f;
  *rw = r ^ 0x5555555555555555ULL;  // complement: code ^ 1
}

// The canonical hash of the window at code q of a packed segment (q < seg):
// khmer_twobit::canonical of the same k codes.
__device__ __forceinline__ uint64_t hash_at(const uint64_t* fw,
                                            const uint64_t* rw, int q,
                                            int k) {
  const int w = q >> 5;
  const int sh = 2 * (q & 31);
  const uint64_t f = ((fw[w] << sh) | ((fw[w + 1] >> 1) >> (63 - sh)))
                     >> (64 - 2 * k);
  const uint64_t r = ((rw[w] >> sh) | ((rw[w + 1] << 1) << (63 - sh)))
                     & (~0ULL >> (64 - 2 * k));
  return f < r ? f : r;
}

}  // namespace khmer_twobit
