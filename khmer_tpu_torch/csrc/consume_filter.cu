// Kernel S: the consume filter. On a dense chunk of canonical k-mer hashes
// already on the card (the host hasher's, core/pipeline.py DenseHasher), it
// keeps a hash when its band test and its mask test both pass, and writes
// the kept hashes, in stream order, into a dense prefix of `out`, with
// their count. That prefix goes unchanged to the update of the sketch's
// layout (kernels A, P, J or 1), which credits a k-mer's n_unique to its
// first event, so the order must be the stream's.
//
// Replaces the filters of khmer_tpu/core/pipeline.py:163 make_flat_consume
// (an XLA function on the TPU; :521 _band_filter, :527 make_mask_filter):
// there a filtered window stays in the chunk as an invalid slot of the
// update; here it leaves the chunk. Its plain PyTorch version is
// khmer_tpu_torch/core/sketch_kernels.py consume_filter_plain (boolean
// indexing).
//
// What it computes. Hash i < nvalid is kept iff
//   - with a band [lo, hi): lo <= h < hi, as unsigned 64-bit values
//     (ops/hashing.py compute_band_interval);
//   - with a mask: its count c (the least counter of the mask's tables,
//     from the gather of the mask's layout: kernels B, Q, L's gather mode
//     or 2; no bigcount map) passes the threshold: c >= threshold where
//     at_least, else c <= threshold (reference hashtable.cc:175-183).
//
// What bounds it: bytes. It reads 8 B a hash (and 4 B a count with a
// mask) and writes 8 B a kept hash; the mask's own counter loads are the
// gather's.
//
// Design: three launches on a tile of kTile hashes a block. The count pass
// tests each hash and writes the block's total; one block scans the totals
// (warp shuffles) into each tile's first output slot and the count; the
// scatter pass tests the hashes again, and each block ranks its kept
// hashes by warp ballots: item j of every thread, thread t at index
// tile + j * kThreads + t, so that the ranks of item j's ballots, warp by
// warp, then lane by lane, follow the stream; a kept hash goes to
// out[tile's slot + rank].

#include "launch.cuh"

namespace khmer_filter {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;

struct Filter {
  int64_t nvalid;
  uint64_t lo, hi;
  int band;
  const int32_t* counts;  // null: no mask
  int threshold;
  int at_least;
};

__device__ __forceinline__ bool kept(const Filter& f,
                                     const uint64_t* __restrict__ hashes,
                                     int64_t i) {
  if (i >= f.nvalid) return false;
  if (f.band) {
    const uint64_t h = hashes[i];
    if (h < f.lo || h >= f.hi) return false;
  }
  if (f.counts != nullptr) {
    const int c = f.counts[i];
    return f.at_least ? c >= f.threshold : c <= f.threshold;
  }
  return true;
}

// totals[b] = the hashes tile b keeps.
__global__ void __launch_bounds__(kThreads)
count_kernel(const uint64_t* __restrict__ hashes, const Filter f,
             int64_t* __restrict__ totals) {
  __shared__ int warp_sums[kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  int c = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    c += kept(f, hashes, base + j * kThreads + threadIdx.x);
  }
  c = __reduce_add_sync(~0u, c);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    totals[blockIdx.x] = total;
  }
}

// The exclusive scan of totals[0, nblocks) in place, and their sum into
// count[0]: one block, kScanThreads totals a round.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int64_t* __restrict__ totals, int64_t nblocks,
            int64_t* __restrict__ count) {
  __shared__ int64_t warp_sums[kScanThreads / 32];
  __shared__ int64_t carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t b0 = 0; b0 < nblocks; b0 += kScanThreads) {
    const int64_t b = b0 + threadIdx.x;
    const int64_t v = b < nblocks ? totals[b] : 0;
    int64_t x = v;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(~0u, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int64_t s = lane < kScanThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int64_t y = __shfl_up_sync(~0u, s, o);
        if (lane >= o) s += y;
      }
      if (lane < kScanThreads / 32) warp_sums[lane] = s;  // inclusive
    }
    __syncthreads();
    const int64_t before = carry + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (b < nblocks) totals[b] = before + x - v;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = before + x;
    __syncthreads();
  }
  if (threadIdx.x == 0) count[0] = carry;
}

// Each tile's kept hashes at out[slots[b] + their rank in the tile].
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint64_t* __restrict__ hashes, const Filter f,
               const int64_t* __restrict__ slots,
               uint64_t* __restrict__ out) {
  __shared__ int ranks[kItems * kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned ballots[kItems];
  uint64_t h[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    const bool keep = kept(f, hashes, i);
    h[j] = keep ? hashes[i] : 0;
    ballots[j] = __ballot_sync(~0u, keep);
    if (lane == 0) ranks[j * kWarps + warp] = __popc(ballots[j]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the (item, warp) counts in order
    constexpr int kPer = kItems * kWarps / 32;
    int v[kPer];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      v[q] = ranks[lane * kPer + q];
      sum += v[q];
    }
    int x = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(~0u, x, o);
      if (lane >= o) x += y;
    }
    int run = x - sum;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      ranks[lane * kPer + q] = run;
      run += v[q];
    }
  }
  __syncthreads();
  const int64_t slot = slots[blockIdx.x];
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (ballots[j] >> lane & 1) {
      out[slot + ranks[j * kWarps + warp] + __popc(ballots[j] & below)] =
          h[j];
    }
  }
}

static_assert(kItems * kWarps % 32 == 0, "the rank scan's lanes");

}  // namespace
}  // namespace khmer_filter

// Kernel S on hashes[0, n): the kept hashes of hashes[0, nvalid) in stream
// order at out[0, count[0]) (out: n slots; the rest is left as it was).
// band: test lo <= h < hi (u64 bit patterns in int64). counts (device,
// int32 [n], may be null): test counts[i] >= threshold where at_least,
// else counts[i] <= threshold. totals: int64 scratch of ceil(n / 2048)
// entries (sketch_kernels.py FILTER_TILE).
extern "C" int khmer_consume_filter(const int64_t* hashes, int64_t n,
                                    int64_t nvalid, int band, int64_t lo,
                                    int64_t hi, const int32_t* counts,
                                    int threshold, int at_least,
                                    int64_t* out, int64_t* count,
                                    int64_t* totals, int device,
                                    void* stream) {
  using namespace khmer_filter;
  if (n < 0 || nvalid < 0 || nvalid > n) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  const Filter f{nvalid, static_cast<uint64_t>(lo), static_cast<uint64_t>(hi),
                 band, counts, threshold, at_least};
  const int64_t nblocks = (n + kTile - 1) / kTile;
  if (nblocks == 0) {
    return cudaMemsetAsync(count, 0, sizeof(int64_t), s);
  }
  const auto* h = reinterpret_cast<const uint64_t*>(hashes);
  count_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(h, f,
                                                                   totals);
  scan_kernel<<<1, kScanThreads, 0, s>>>(totals, nblocks, count);
  scatter_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(
      h, f, totals, reinterpret_cast<uint64_t*>(out));
  return cudaGetLastError();
}
