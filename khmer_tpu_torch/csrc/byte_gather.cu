// Kernel B: the byte-layout count gather, min over T prime tables.
//
// Replaces khmer_tpu/core/sketch_kernels.py:649 (_gather_counts, byte
// branch :654-659), an XLA gather on the TPU; its plain PyTorch version is
// khmer_tpu_torch/core/sketch_kernels.py:byte_gather_plain. It serves
// get() and the abundance-histogram step.
//
// What bounds it: random single-byte reads, one per table per hash, in
// tables far larger than L2; there is no arithmetic to speak of beyond a
// 64-bit modulo per table.
//
// Design: one thread per hash, T byte loads, the minimum written as int32.
// Saturated values (255) are resolved against the bigcount map on the
// host (khmer_tpu/core/sketch.py:325-330).

#include "byte_common.cuh"

namespace khmer_byte {
namespace {

__global__ void gather_kernel(const uint64_t* __restrict__ hashes,
                              int64_t n, ByteLayout layout,
                              const uint8_t* __restrict__ flat,
                              int32_t* __restrict__ out) {
  const int64_t i = khmer_cuda::thread_index();
  if (i >= n) return;
  const uint64_t h = hashes[i];
  int count = khmer_cuda::kMaxCount;
  for (int t = 0; t < layout.ntables; ++t) {
    count = min(count, static_cast<int>(flat[counter_index(layout, h, t)]));
  }
  out[i] = count;
}

}  // namespace
}  // namespace khmer_byte

// out[i] = min over tables t of flat[offsets[t] + hashes[i] % primes[t]],
// for i < n. primes/offsets are HOST arrays of ntables.
extern "C" int khmer_byte_gather(const uint8_t* flat, int ntables,
                                 const int64_t* primes,
                                 const int64_t* offsets,
                                 const int64_t* hashes, int64_t n,
                                 int32_t* out, int device, void* stream) {
  using namespace khmer_byte;
  ByteLayout layout;
  if (!make_layout(ntables, primes, offsets, &layout)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  gather_kernel<<<khmer_cuda::grid_for(n), khmer_cuda::kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint64_t*>(hashes), n, layout, flat, out);
  return cudaGetLastError();
}
