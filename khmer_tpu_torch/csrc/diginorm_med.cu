// Kernel E: the diginorm median test of a whole window (phase A).
//
// Replaces khmer_tpu/core/diginorm_scan.py:93 (make_med_ok), an XLA
// function on the TPU; its plain PyTorch version is
// khmer_tpu_torch/core/sketch_kernels.py:med_ok_plain.
//
// For each bundle b of a window (reads 2b and 2b + 1 of a [2B, L] code
// matrix), reject[b] is true iff every present read (length >= k) passes
// median_at_least(C) (reference hashtable.cc:333-364) under the tables as
// they stand: #(valid windows whose count, the minimum over the T tables,
// is >= C) >= (nvalid + 1) / 2, with nvalid = len - k + 1. Counts only
// grow during diginorm and the test is monotone in them, so a rejection
// here is final; the rest are the keep candidates of kernel F.
//
// What bounds it: bytes. It reads the codes once and one counter per
// window per table, at random in tables far larger than L2 at the sizes
// users run (4 GB at -x 1e9 -N 4); each such read costs a 32-byte sector.
// The tables are only read.
//
// Design. One warp per bundle, its two reads one after the other: each
// lane hashes its windows from the codes (twobit_common.cuh, no hash
// matrix in memory), issues the T counter loads of a window together,
// and counts the windows at or above C; a warp reduction gives the read's
// count. No scratch.

#include "byte_common.cuh"
#include "twobit_common.cuh"

namespace khmer_digi_med {
namespace {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

// Whether read `row` passes median_at_least(cutoff); an absent read passes.
__device__ __forceinline__ bool read_ok(const uint8_t* codes,
                                        const int32_t* lengths, int64_t row,
                                        int L, int k, int cutoff,
                                        const ByteLayout& layout,
                                        const uint8_t* flat, int lane) {
  const int nvalid = khmer_twobit::n_windows(lengths[row], k);
  if (nvalid == 0) return true;
  const int nw = min(nvalid, L - k + 1);
  const uint8_t* base = codes + row * L;
  int ge = 0;
  for (int j = lane; j < nw; j += 32) {
    const uint64_t h = khmer_twobit::canonical(base + j, k);
    int m = khmer_cuda::kMaxCount;
    for (int t = 0; t < layout.ntables; ++t) {
      m = min(m, static_cast<int>(flat[counter_index(layout, h, t)]));
    }
    ge += m >= cutoff;
  }
  ge = __reduce_add_sync(0xffffffffu, ge);
  return ge >= (nvalid + 1) / 2;
}

__global__ void __launch_bounds__(kBlock)
med_kernel(const uint8_t* __restrict__ codes,
           const int32_t* __restrict__ lengths, int64_t nbundles, int L,
           int k, int cutoff, const __grid_constant__ ByteLayout layout,
           const uint8_t* __restrict__ flat, uint8_t* __restrict__ reject) {
  const int lane = threadIdx.x % 32;
  const int64_t b = blockIdx.x * static_cast<int64_t>(kWarps)
                    + threadIdx.x / 32;
  if (b >= nbundles) return;
  const bool ok0 = read_ok(codes, lengths, 2 * b, L, k, cutoff, layout,
                           flat, lane);
  const bool ok1 = read_ok(codes, lengths, 2 * b + 1, L, k, cutoff, layout,
                           flat, lane);
  if (lane == 0) reject[b] = ok0 && ok1;
}

}  // namespace
}  // namespace khmer_digi_med

// reject[b] for b < nbundles from codes [2 nbundles, L] (u8 2-bit codes),
// lengths [2 nbundles] and the flat byte tables; primes/offsets are HOST
// arrays of ntables.
extern "C" int khmer_diginorm_med(const uint8_t* flat, int ntables,
                                  const int64_t* primes,
                                  const int64_t* offsets,
                                  const uint8_t* codes,
                                  const int32_t* lengths, int64_t nbundles,
                                  int L, int k, int cutoff, uint8_t* reject,
                                  int device, void* stream) {
  using namespace khmer_digi_med;
  khmer_byte::ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, offsets, &layout)
      || nbundles < 0 || k < 1 || k > 32 || L < k) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbundles == 0) return cudaSuccess;
  med_kernel<<<static_cast<unsigned>((nbundles + kWarps - 1) / kWarps),
               kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      codes, lengths, nbundles, L, k, cutoff, layout, flat, reject);
  return cudaGetLastError();
}
