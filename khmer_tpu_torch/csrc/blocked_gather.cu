// Kernel 2: the blocked count gather, min over a hash's four lanes.
//
// Replaces khmer_tpu/core/blocked.py:158 (gather_counts), an XLA row
// gather on the TPU; its plain PyTorch version is
// khmer_tpu_torch/core/blocked.py:gather_counts_plain. It serves get()
// and the abundance-histogram step.
//
// What bounds it: random 128-byte row traffic. Each hash reads four
// bytes in four different 32-byte sectors of one 128-byte block of a
// table far larger than L2; there is no arithmetic to speak of. A hash
// costs its block's whole line, so the floor of a random gather is the
// distinct lines it reads, well above the bytes it needs.
//
// Design: one thread per hash. The block h % nblocks is reduced by the
// reciprocal the host computes (u64_common.cuh reduce) in place of nvcc's
// software 64-bit division, and the four byte loads are issued before the
// minimum is taken, each with the L2 128-byte fetch hint
// (ld.global.nc.L2::128B): on a miss L2 fetches the line whole, one DRAM
// request for the four sectors a hash reads. On an H100 (700 W) this came
// out ahead of 2, 4 and 8 hashes a thread with 16-byte hash loads, of four
// lanes of a warp per hash, and of a whole-line load per hash by eight
// lanes, on the config-1 table and on abundance-dist's batch
// (scripts/hist_gather_bench.py). The minimum is written as int32
// (PyTorch's uint16 support is thin).

#include "blocked_common.cuh"

namespace khmer_blocked {
namespace {

__device__ __forceinline__ int load_line_hinted(const uint8_t* p) {
  unsigned v;
  asm("ld.global.nc.L2::128B.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return static_cast<int>(v);
}

__global__ void gather_kernel(const uint64_t* __restrict__ hashes,
                              int64_t n, uint64_t nblocks, uint64_t recip,
                              const uint8_t* __restrict__ table,
                              int32_t* __restrict__ out) {
  const int64_t i = khmer_cuda::thread_index();
  if (i >= n) return;
  const uint64_t h = hashes[i];
  const uint64_t m = mix64(h);
  const uint64_t row = row_of(h, nblocks, recip);
  int v[kSub];
#pragma unroll
  for (int t = 0; t < kSub; ++t) {
    v[t] = load_line_hinted(table + lane_index(row, m, t));
  }
  out[i] = min(min(v[0], v[1]), min(v[2], v[3]));
}

}  // namespace
}  // namespace khmer_blocked

// out[i] = min over the four lanes of hashes[i], for i < n.
extern "C" int khmer_blocked_gather(const uint8_t* table, int64_t nblocks,
                                    const int64_t* hashes, int64_t n,
                                    int32_t* out, int device, void* stream) {
  using namespace khmer_blocked;
  if (nblocks <= 0 || n < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const uint64_t nb = static_cast<uint64_t>(nblocks);
  gather_kernel<<<grid_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint64_t*>(hashes), n, nb,
      khmer_cuda::reciprocal(nb), table, out);
  return cudaGetLastError();
}
