// Kernel Q: the nibble-layout count gather, the min over T prime tables of
// 4-bit counters; and kernel R, the same gather without the min: every
// table's counter.
//
// Q replaces khmer_tpu/core/sketch_kernels.py:649 (_gather_counts, nibble
// branch :660), an XLA gather on the TPU; its plain PyTorch version is
// khmer_tpu_torch/core/sketch_kernels.py:nibble_gather_plain. It serves a
// SmallCountgraph's get(), the abundance histogram's main count and
// core/pipeline.py counts_for_records. R replaces :681 (make_pertable_get,
// nibble branch :692) and khmer_tpu/core/diginorm.py:36
// (make_pertable_counts, nibble branch :51); its plain version is
// nibble_pertable_plain. It serves diginorm's and trim's windows
// (core/diginorm.py SeqWindow) and the knot pipeline's evaluation.
//
// The layout is kernel P's (nibble_update.cu): table t's counter b is the
// high nibble of byte offset_t + b / 2 for an even b, the low one for an
// odd b; as a flat nibble index, 2 * offset_t + b, the layout's offsets in
// nibbles, so one reduction (byte_common.cuh counter_index, by the
// reciprocal the host computes) gives byte and parity.
//
// What bounds them: random single-byte reads, one a table a hash, as for
// kernels B and M (byte_gather.cu): each costs a 32-byte sector, so the
// floor is the distinct sectors they read. A nibble table holds two
// counters a byte, so a table of the same memory holds twice the counters
// and a gather touches as many sectors.
//
// Design. Q is B's: kPerThread hashes a thread, loaded as 16-byte pairs,
// the byte loads of all of them in up to kGroup tables issued before any is
// used, the minimum (from 15) out as int32 in 8-byte pairs. R is M's: a
// thread a (hash, table), grid row y on table y, the counters loaded under
// an L2 evict-last policy and the hashes and output streaming.

#include "byte_common.cuh"

namespace khmer_nibble {
namespace {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;

constexpr int kNibbleMax = 15;
constexpr int kPerThread = 8;
constexpr int kBlock = 128;
static_assert(kPerThread % 2 == 0, "hashes load in pairs");

// The counter at flat nibble `key` of the byte `v` that holds it.
__device__ __forceinline__ int nibble_of(unsigned v, uint64_t key) {
  return static_cast<int>((key & 1) ? v & 0xFu : v >> 4);
}

// Hashes j, j + 1 with j = base + 2 * (p * blockDim + threadIdx), p <
// kPerThread / 2, of the block's kPerThread * blockDim. `paired`: hashes
// 16-byte and out 8-byte aligned, so whole pairs move as vectors.
template <int kGroup>
__global__ void __launch_bounds__(kBlock)
gather_kernel(const uint64_t* __restrict__ hashes, int64_t n, bool paired,
              const __grid_constant__ ByteLayout layout,
              const uint8_t* __restrict__ flat, int32_t* __restrict__ out) {
  const int64_t base =
      blockIdx.x * static_cast<int64_t>(blockDim.x) * kPerThread;
  int64_t first[kPerThread / 2];
  uint64_t h[kPerThread];
#pragma unroll
  for (int p = 0; p < kPerThread / 2; ++p) {
    const int64_t j =
        base + 2 * (p * static_cast<int64_t>(blockDim.x) + threadIdx.x);
    first[p] = j;
    if (paired && j + 1 < n) {
      const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(hashes + j);
      h[2 * p] = v.x;
      h[2 * p + 1] = v.y;
    } else {
      h[2 * p] = j < n ? hashes[j] : 0;
      h[2 * p + 1] = j + 1 < n ? hashes[j + 1] : 0;
    }
  }
  int count[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) count[k] = kNibbleMax;
  for (int t0 = 0; t0 < layout.ntables; t0 += kGroup) {
    // each counter's byte, and its nibble's shift in it (an even index:
    // the high nibble); past the last table a byte of 0xFF
    unsigned v[kGroup][kPerThread];
    unsigned shift[kGroup][kPerThread];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const uint64_t key = t0 + g < layout.ntables
                                 ? counter_index(layout, h[k], t0 + g) : 0;
        shift[g][k] = (key & 1) ? 0 : 4;
        v[g][k] = t0 + g < layout.ntables ? flat[key >> 1] : 0xFFu;
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        count[k] = min(count[k],
                       static_cast<int>((v[g][k] >> shift[g][k]) & 0xFu));
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kPerThread / 2; ++p) {
    const int64_t j = first[p];
    if (paired && j + 1 < n) {
      *reinterpret_cast<int2*>(out + j) =
          make_int2(count[2 * p], count[2 * p + 1]);
    } else {
      if (j < n) out[j] = count[2 * p];
      if (j + 1 < n) out[j + 1] = count[2 * p + 1];
    }
  }
}

template <int kGroup>
void launch(const uint64_t* hashes, int64_t n, bool paired,
            const ByteLayout& layout, const uint8_t* flat, int32_t* out,
            cudaStream_t s) {
  const int64_t per_block = int64_t{kBlock} * kPerThread;
  gather_kernel<kGroup>
      <<<static_cast<unsigned>((n + per_block - 1) / per_block), kBlock, 0,
         s>>>(hashes, n, paired, layout, flat, out);
}

// Kernel R's cache hints, as kernel M's (byte_gather.cu).
constexpr int kPerTableBlock = 256;

__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t load_hash(const uint64_t* p) {
  uint64_t v;
  asm("ld.global.cs.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned load_counter(const uint8_t* p,
                                                 uint64_t policy) {
  unsigned v;
  asm("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;" : "=r"(v)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void store_counter(uint8_t* p, unsigned v) {
  asm volatile("st.global.cs.u8 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kPerTableBlock)
pertable_kernel(const uint64_t* __restrict__ hashes, int64_t n,
                const __grid_constant__ ByteLayout layout,
                const uint8_t* __restrict__ flat,
                uint8_t* __restrict__ out) {
  const int64_t i = khmer_cuda::thread_index();
  if (i >= n) return;
  const int t = blockIdx.y;
  const uint64_t key = counter_index(layout, load_hash(hashes + i), t);
  store_counter(out + t * n + i,
                static_cast<unsigned>(nibble_of(
                    load_counter(flat + (key >> 1), keep_policy()), key)));
}

}  // namespace
}  // namespace khmer_nibble

// out[i] = min(15, min over tables t of the nibble at flat nibble index
// nibble_offsets[t] + hashes[i] % primes[t]), for i < n: kernel Q.
// primes/nibble_offsets are HOST arrays of ntables.
extern "C" int khmer_nibble_gather(const uint8_t* flat, int ntables,
                                   const int64_t* primes,
                                   const int64_t* nibble_offsets,
                                   const int64_t* hashes, int64_t n,
                                   int32_t* out, int device, void* stream) {
  using namespace khmer_nibble;
  ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, nibble_offsets, &layout)
      || n < 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const uint64_t* h = reinterpret_cast<const uint64_t*>(hashes);
  const bool paired = reinterpret_cast<uintptr_t>(h) % 16 == 0
                      && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ntables) {
    case 1: launch<1>(h, n, paired, layout, flat, out, s); break;
    case 2: launch<2>(h, n, paired, layout, flat, out, s); break;
    case 3: launch<3>(h, n, paired, layout, flat, out, s); break;
    case 4: launch<4>(h, n, paired, layout, flat, out, s); break;
    default: launch<8>(h, n, paired, layout, flat, out, s); break;
  }
  return cudaGetLastError();
}

// out[t * n + i] = the nibble at flat nibble index nibble_offsets[t] +
// hashes[i] % primes[t], for t < ntables and i < n: kernel R.
extern "C" int khmer_nibble_pertable(const uint8_t* flat, int ntables,
                                     const int64_t* primes,
                                     const int64_t* nibble_offsets,
                                     const int64_t* hashes, int64_t n,
                                     uint8_t* out, int device,
                                     void* stream) {
  using namespace khmer_nibble;
  ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, nibble_offsets, &layout)
      || n < 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>((n + kPerTableBlock - 1)
                                       / kPerTableBlock),
                  static_cast<unsigned>(ntables));
  pertable_kernel<<<grid, kPerTableBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint64_t*>(hashes), n, layout, flat, out);
  return cudaGetLastError();
}
