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
// coalesced (8 B each); the abundance path sends most of the ones it keeps
// to a few low bins (count 1 above all), so contention, not bandwidth,
// limits a naive scatter, and worst of all on a global address. Atomics on
// distinct global addresses are cheap: L2 serves them in parallel. (The
// slots abundance-dist does not count, three in four of a batch, carry an
// index past its histogram: dropped here at no cost.)
//
// Design. The TPU kernel walked the indices one by one into VMEM. Here a
// grid-stride loop over warps loads kUnroll groups of 32 indices before
// it counts any; each warp groups a group's indices by value
// (__match_any_sync) and one lane adds the group's size. Every block keeps
// its own 32-bit counters in shared memory for bins [0, kLow) (every count
// a u8 counter holds), the bins that take the crowds, and adds them into
// the int64 output once at the end; every other bin goes straight to
// global memory with a 64-bit atomicAdd. The block needs 1 KB of shared
// memory. On an H100 this beat a thread-block cluster that holds every
// bin in distributed shared memory, on abundance-dist's batch and on 2^21
// uniform indices into 2^17 bins alike: the cluster's remote adds crowd
// onto the blocks owning the hot bins, and at the uniform shape its flush
// adds about as many bins as there are indices (PERF.md). The output is
// accumulated into, not overwritten. A launch takes fewer than 2^31
// indices, so no 32-bit counter overflows; the wrapper splits larger
// inputs.

#include <cstdint>

#include <cuda_runtime.h>

namespace khmer_hist {
namespace {

// mirrored in core/sketch_kernels.py as HIST_THREADS, HIST_PER_THREAD,
// HIST_LOW_BINS and HIST_LAUNCH_LIMIT
constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // 32-index groups a warp loads at once
constexpr int kLow = 256;
constexpr int64_t kMaxLaunch = 2147483647;

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const int64_t* __restrict__ idx, int64_t n,
                 unsigned long long* __restrict__ out, int64_t nbins) {
  __shared__ unsigned int sub[kLow];  // bins [0, low)
  for (int b = threadIdx.x; b < kLow; b += blockDim.x) sub[b] = 0;
  __syncthreads();
  const int64_t low = nbins < kLow ? nbins : kLow;
  const int lane = threadIdx.x & 31;
  const int64_t stride =
      static_cast<int64_t>(gridDim.x) * blockDim.x * kUnroll;
  // the loop bound is the same for every lane of a warp, so the warp
  // stays converged for __match_any_sync
  for (int64_t w = (blockIdx.x * static_cast<int64_t>(blockDim.x)
                    + (threadIdx.x & ~31)) * kUnroll;
       w < n; w += stride) {
    int64_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = w + 32 * u + lane;
      v[u] = i < n ? idx[i] : nbins;  // past n: dropped
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int64_t b = v[u];
      if (b < 0) b += nbins;
      const bool in_range = b >= 0 && b < nbins;
      const unsigned long long key =
          in_range ? static_cast<unsigned long long>(b) : ~0ULL;
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
      if (in_range && lane == __ffs(peers) - 1) {
        const unsigned count = __popc(peers);
        if (b < low) {
          atomicAdd(&sub[b], count);
        } else {
          atomicAdd(&out[b], static_cast<unsigned long long>(count));
        }
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < low; b += blockDim.x) {
    if (sub[b] != 0) {
      atomicAdd(&out[b], static_cast<unsigned long long>(sub[b]));
    }
  }
}

}  // namespace
}  // namespace khmer_hist

// out[idx[i]] += 1 (int64 out[nbins]) for i < n < 2^31, wrapping indices
// in [-nbins, 0) and dropping those outside [-nbins, nbins), on `blocks`
// blocks (core/sketch_kernels.py histogram_plan).
extern "C" int khmer_histogram_add(const int64_t* idx, int64_t n,
                                   int64_t* out, int64_t nbins, int blocks,
                                   int device, void* stream) {
  using namespace khmer_hist;
  if (n < 0 || n > kMaxLaunch || nbins < 1 || blocks < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  histogram_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      idx, n, reinterpret_cast<unsigned long long*>(out), nbins);
  return cudaGetLastError();
}
