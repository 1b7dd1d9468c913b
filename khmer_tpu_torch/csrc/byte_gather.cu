// Kernel B: the byte-layout count gather, min over T prime tables; and
// kernel M, the same gather without the min: every table's counter.
//
// Replaces khmer_tpu/core/sketch_kernels.py:649 (_gather_counts, byte
// branch :654-659), an XLA gather on the TPU; its plain PyTorch version is
// khmer_tpu_torch/core/sketch_kernels.py:byte_gather_plain. It serves
// get() and the abundance-histogram step.
//
// What bounds it: random single-byte reads, one per table per hash, in
// tables far larger than L2. Each costs a 32-byte sector, so the floor of
// a random gather is the distinct sectors it reads, well above the bytes
// it needs.
//
// Design. No arithmetic beyond what locates a counter: the reduction
// h % p_t is by the reciprocal the host computes (byte_common.cuh
// counter_index), two multiplies and a subtraction in place of nvcc's
// software 64-bit division. What holds a gather back is the number of
// random sector reads in flight, so each thread gathers kPerThread hashes,
// loaded as 16-byte pairs (a warp's load is 512 contiguous bytes), and
// issues the byte loads of all its hashes in up to kGroup tables before it
// uses any: 32 reads in flight a thread at T = 4; T <= 8 tables are one
// group. The minimum goes out as int32, in 8-byte pairs. Saturated
// values (255) are resolved against the bigcount map on the host
// (khmer_tpu/core/sketch.py:325-330).

#include "byte_common.cuh"

namespace khmer_byte {
namespace {

// Hashes a thread gathers and threads a block: on an H100, 8 x 128 came
// out ahead of 2, 4 and 16 hashes and 256 or 512 threads on a batch shaped
// as abundance-dist's (30% live hashes, then zero padding) on config-1
// tables; the L2 fetch granularity made no difference.
constexpr int kPerThread = 8;
constexpr int kBlock = 128;
static_assert(kPerThread % 2 == 0, "hashes load in pairs");

// Hashes j, j + 1 with j = base + 2 * (p * blockDim + threadIdx), p <
// kPerThread / 2, of the block's kPerThread * blockDim. `paired`: hashes
// 16-byte and out 8-byte aligned, so whole pairs move as vectors. The
// layout stays in parameter space (__grid_constant__): the tables' index
// is a run-time value, and a by-value copy would go to local memory.
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
  for (int k = 0; k < kPerThread; ++k) count[k] = khmer_cuda::kMaxCount;
  for (int t0 = 0; t0 < layout.ntables; t0 += kGroup) {
    int v[kGroup][kPerThread];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        v[g][k] = t0 + g < layout.ntables
                      ? flat[counter_index(layout, h[k], t0 + g)]
                      : khmer_cuda::kMaxCount;
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) count[k] = min(count[k], v[g][k]);
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

// Kernel M replaces khmer_tpu/core/sketch_kernels.py:681
// (make_pertable_get, byte branch), an XLA gather on the TPU; its plain
// PyTorch version is core/sketch_kernels.py:byte_pertable_plain. It serves
// the repartition of the knot pipeline (core/partition.py), which walks
// each excursion's k-mers with every table's counter.
//
// What bounds it: the same random byte reads as kernel B, T a hash, and
// 8 B of hash read for each T B written. A batch's keepers repeat k-mers
// (phase 11's largest call: 35 M reads on 1.2 M distinct sectors), so most
// reads hit L2 while a table's touched sectors stay there: the 9 MB of one
// table fit the 50 MB L2, the 37 MB of four do not. Then the rate at which
// L2 serves random sectors bounds it (about 111 G reads/s on an H100);
// reads in flight do not: 2, 4 or 8 hashes a thread, their loads issued
// together, were no faster (scripts/pertable_bench.py).
//
// Design. A thread a (hash, table): grid row y takes table y, so that
// the blocks of a table run together and its counters share L2, and a
// warp loads 256 contiguous bytes of hashes and stores 32 contiguous bytes
// of its row. Cache hints (kCacheHints): the hashes load and the counters
// store as streaming (evict first), the counters load under an L2
// evict-last policy, so that a table's repeated sectors outlive the 70 MB
// of hashes and the output that stream past in its pass (5% on phase
// 11's largest call; equal on distinct hashes). pertable_bench.py also
// builds this kernel as a loop with more hashes a thread, several tables
// on one load of the hashes, chunk-major order and a grid sized to the
// card, and times each against it.
constexpr int kPerTableBlock = 256;
constexpr bool kCacheHints = true;

__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t policy = 0;
  if (kCacheHints) {
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
        : "=l"(policy));
  }
  return policy;
}

__device__ __forceinline__ uint64_t load_hash(const uint64_t* p) {
  if (!kCacheHints) return *p;
  uint64_t v;
  asm("ld.global.cs.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned load_counter(const uint8_t* p,
                                                 uint64_t policy) {
  if (!kCacheHints) return *p;
  unsigned v;
  asm("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;" : "=r"(v)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void store_counter(uint8_t* p, unsigned v) {
  if (!kCacheHints) {
    *p = static_cast<uint8_t>(v);
    return;
  }
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
  const uint64_t h = load_hash(hashes + i);
  store_counter(out + t * n + i,
                load_counter(flat + counter_index(layout, h, t),
                             keep_policy()));
}

}  // namespace
}  // namespace khmer_byte

// out[t * n + i] = flat[offsets[t] + hashes[i] % primes[t]], for t <
// ntables and i < n: kernel M. primes/offsets are HOST arrays of ntables.
extern "C" int khmer_byte_pertable(const uint8_t* flat, int ntables,
                                   const int64_t* primes,
                                   const int64_t* offsets,
                                   const int64_t* hashes, int64_t n,
                                   uint8_t* out, int device, void* stream) {
  using namespace khmer_byte;
  ByteLayout layout;
  if (!make_layout(ntables, primes, offsets, &layout) || n < 0) {
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

// out[i] = min over tables t of flat[offsets[t] + hashes[i] % primes[t]],
// for i < n. primes/offsets are HOST arrays of ntables.
extern "C" int khmer_byte_gather(const uint8_t* flat, int ntables,
                                 const int64_t* primes,
                                 const int64_t* offsets,
                                 const int64_t* hashes, int64_t n,
                                 int32_t* out, int device, void* stream) {
  using namespace khmer_byte;
  ByteLayout layout;
  if (!make_layout(ntables, primes, offsets, &layout) || n < 0) {
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
