// Kernel C: histogram_add, out[idx[i]] += 1 for every i < n, as JAX's
// .at[].add does it: an index in [-nbins, 0) wraps to idx + nbins, as in
// numpy; one >= nbins or < -nbins is dropped.
//
// Replaces the Pallas kernel scripts/profile_scatter2.py:59 (pallas_hist,
// pallas_call :69), a serial scatter-add of 2^21 bins into a VMEM-resident
// int32 histogram of 2^17 bins, and serves the histogram step of
// abundance-dist (khmer_tpu/core/sketch_kernels.py:744-745). Its plain
// PyTorch version is khmer_tpu_torch/core/sketch_kernels.py:
// histogram_add_plain.
//
// What bounds it: same-address atomics. The indices are read once,
// coalesced (8 B each); the abundance path sends most of them to a few
// bins (count 1, and the overflow slot 65,536 that collects every event
// the tracking table did not count), so contention, not bandwidth, limits
// a naive scatter.
//
// Design. The TPU kernel walked the indices one by one into VMEM. Here a
// grid-stride loop over warps: each warp groups its 32 indices by value
// (__match_any_sync) and one lane adds the group's size, so a bin gets at
// most one atomic per warp and step. Bins below nshared (up to 48K, 192 KB
// of dynamic shared memory) go to a privatized 32-bit sub-histogram of the
// block, flushed once with 64-bit atomicAdd into the int64 output; higher
// bins go straight to global memory. Neither shape fits whole: 2^17 int32
// bins are 512 KB and abundance-dist's 65,537 bins 256 KB, against 227 KB
// per block; the abundance path's counted bins are 0..254, inside the
// privatized range. The output is accumulated into, not overwritten.

#include <cstdint>

#include <cuda_runtime.h>

namespace khmer_hist {
namespace {

constexpr int kThreads = 512;
constexpr int64_t kMaxSharedBins = 48 * 1024;

__global__ void histogram_kernel(const int64_t* __restrict__ idx, int64_t n,
                                 unsigned long long* __restrict__ out,
                                 int64_t nbins, int nshared) {
  extern __shared__ unsigned int sub[];
  for (int b = threadIdx.x; b < nshared; b += blockDim.x) sub[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // the loop bound is the same for every lane of a warp, so the warp
  // stays converged for __match_any_sync
  for (int64_t w = blockIdx.x * static_cast<int64_t>(blockDim.x)
                   + (threadIdx.x & ~31);
       w < n; w += stride) {
    const int64_t i = w + lane;
    int64_t b = i < n ? idx[i] : nbins;
    if (b < 0) b += nbins;
    const bool in_range = b >= 0 && b < nbins;
    const unsigned long long key =
        in_range ? static_cast<unsigned long long>(b) : ~0ULL;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
    if (in_range && lane == __ffs(peers) - 1) {
      const unsigned int count = __popc(peers);
      if (b < nshared) {
        atomicAdd(&sub[b], count);
      } else {
        atomicAdd(&out[b], static_cast<unsigned long long>(count));
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nshared; b += blockDim.x) {
    if (sub[b] != 0) {
      atomicAdd(&out[b], static_cast<unsigned long long>(sub[b]));
    }
  }
}

}  // namespace
}  // namespace khmer_hist

// out[idx[i]] += 1 (int64 out[nbins]) for i < n, wrapping indices in
// [-nbins, 0) and dropping those outside [-nbins, nbins). n must stay
// below 2^31 (32-bit shared counters).
extern "C" int khmer_histogram_add(const int64_t* idx, int64_t n,
                                   int64_t* out, int64_t nbins, int device,
                                   void* stream) {
  using namespace khmer_hist;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int nshared = static_cast<int>(nbins < kMaxSharedBins ? nbins
                                                              : kMaxSharedBins);
  const size_t smem = static_cast<size_t>(nshared) * sizeof(unsigned int);
  err = cudaFuncSetAttribute(histogram_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, histogram_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  histogram_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      idx, n, reinterpret_cast<unsigned long long*>(out), nbins, nshared);
  return cudaGetLastError();
}
