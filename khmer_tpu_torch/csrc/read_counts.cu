// Kernel H: per-read count and trim over whole reads, reading the u8
// tables only.
//
// Replaces khmer_tpu/core/pipeline.py:755 (counts_for_records: the hash
// batch and the sketch's gather, XLA device functions on the TPU, then the
// host's trim_pos_from_counts and median_at_least_from_counts) and the
// pass-2 gather of trim-low-abund (khmer_tpu/core/diginorm.py:36
// make_pertable_counts through SeqWindow); its plain PyTorch version is
// khmer_tpu_torch/core/sketch_kernels.py:read_counts_plain.
//
// Per read r of a [R, L] code matrix with lengths [R], from the minimum
// over the T tables of each valid window's counter:
//   trim_at[r]: 0 for a read with no window or one, or whose window 0 is
//     below `cutoff`; k + j - 1 for the first later window j below it;
//     else the read's length (utils/trimming.py trim_pos_from_counts);
//   n_ge[r]: the windows at or above `at_least` (median_at_least needs
//     that count alone).
// With a bigcount table (the map's u64 hashes in ascending order and
// their counts), a count of 255 becomes the table's count for its hash
// where it has one, as counts_for_records reads the map.
//
// What bounds it: the random gathers. Each window's T counters lie in T
// random 32-byte sectors of tables far larger than the L2, so every
// window costs T sector reads; the codes and outputs are small beside
// them.
//
// Design: a warp a read, kReads reads a block. Lane l takes windows l,
// l + 32, ...: it loads the window's k codes at once (adjacent lanes share
// their cache lines), hashes them, and issues the T counter loads
// together; a saturated count with a bigcount table is looked up by
// binary search. Warp reductions give the read's count at or above
// `at_least`, whether window 0 is bad and its first later bad window; lane
// 0 writes both outputs. No shared memory and no scratch.

#include "byte_common.cuh"
#include "twobit_common.cuh"

namespace khmer_read_trim {
namespace {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;
using khmer_cuda::kMaxCount;

// core/sketch_kernels.py READ_THREADS and READS_PER_BLOCK
constexpr int kBlock = 256;
constexpr int kReads = kBlock / 32;
constexpr int kNone = 0x7fffffff;  // no bad window past the 0th
constexpr unsigned kFull = 0xffffffffu;

// The bigcount table's count for hash h, or 255 where it has none.
__device__ __forceinline__ int big_count(const uint64_t* __restrict__ keys,
                                         const int32_t* __restrict__ values,
                                         int64_t n, uint64_t h) {
  int64_t lo = 0;
  int64_t hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (keys[mid] < h) lo = mid + 1; else hi = mid;
  }
  return lo < n && keys[lo] == h ? values[lo] : kMaxCount;
}

__global__ void __launch_bounds__(kBlock)
counts_kernel(const uint8_t* __restrict__ codes,
              const int32_t* __restrict__ lengths, int64_t nrows, int L,
              int k, int cutoff, int at_least,
              const __grid_constant__ ByteLayout layout,
              const uint8_t* __restrict__ flat,
              const uint64_t* __restrict__ big_keys,
              const int32_t* __restrict__ big_values, int64_t nbig,
              int32_t* __restrict__ trim_at, int32_t* __restrict__ n_ge) {
  const int64_t row = blockIdx.x * static_cast<int64_t>(kReads)
                      + threadIdx.x / 32;
  if (row >= nrows) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const int len = lengths[row];
  const int nw = min(khmer_twobit::n_windows(len, k), L - k + 1);
  const uint8_t* read = codes + row * L;
  int ge = 0;
  int bad0 = 0;
  int first_bad = kNone;
  for (int j = lane; j < nw; j += 32) {
    const uint64_t h = khmer_twobit::canonical_loads_first(read + j, k);
    int m = kMaxCount;
    for (int t = 0; t < layout.ntables; ++t) {
      m = min(m, static_cast<int>(flat[counter_index(layout, h, t)]));
    }
    if (m == kMaxCount && nbig > 0) {
      m = big_count(big_keys, big_values, nbig, h);
    }
    ge += m >= at_least;
    if (m < cutoff) {
      if (j == 0) {
        bad0 = 1;
      } else {
        first_bad = min(first_bad, j);
      }
    }
  }
  ge = __reduce_add_sync(kFull, ge);
  first_bad = __reduce_min_sync(kFull, first_bad);
  bad0 = __any_sync(kFull, bad0);
  if (lane == 0) {
    n_ge[row] = ge;
    trim_at[row] = nw <= 1 || bad0 ? 0
                   : first_bad != kNone ? k + first_bad - 1 : len;
  }
}

}  // namespace
}  // namespace khmer_read_trim

// Rows 0..nrows-1 of codes [nrows, L] / lengths [nrows]: trim_at[r] and
// n_ge[r]. cutoff and at_least are clamped to [-1, 65536] by the caller.
// big_keys / big_values (device, nbig entries, keys ascending as u64) may
// be null with nbig 0. primes/offsets are HOST arrays of ntables.
extern "C" int khmer_read_counts(const uint8_t* flat, int ntables,
                                 const int64_t* primes,
                                 const int64_t* offsets,
                                 const uint8_t* codes,
                                 const int32_t* lengths, int64_t nrows,
                                 int L, int k, int cutoff, int at_least,
                                 const void* big_keys,
                                 const int32_t* big_values, int64_t nbig,
                                 int32_t* trim_at, int32_t* n_ge, int device,
                                 void* stream) {
  using namespace khmer_read_trim;
  khmer_byte::ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, offsets, &layout)
      || nrows < 0 || k < 1 || k > 32 || L < k || nbig < 0
      || (nbig > 0 && (big_keys == nullptr || big_values == nullptr))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nrows == 0) return cudaSuccess;
  const int64_t blocks = (nrows + kReads - 1) / kReads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  counts_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      codes, lengths, nrows, L, k, cutoff, at_least, layout, flat,
      static_cast<const uint64_t*>(big_keys), big_values, nbig, trim_at,
      n_ge);
  return cudaGetLastError();
}
