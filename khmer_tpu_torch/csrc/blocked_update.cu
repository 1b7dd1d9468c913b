// Kernel 1: the blocked Count-Min update, exact in stream order.
//
// Replaces the Pallas kernel khmer_tpu/ops/pallas_blocked.py:63
// (_make_update_call) and its XLA twin khmer_tpu/core/blocked.py:83
// (blocked_local_update), whose plain PyTorch version is
// khmer_tpu_torch/core/blocked.py:blocked_local_update.
//
// What bounds it: random 128-byte row traffic. Each event touches four
// counters in one 128-byte block of a table far larger than L2 (200 MB
// to 2.1 GB) and the same four entries of the winner image (4 B per
// counter), with a few integer ops per touch. The limit is the number of
// random sector accesses, not bandwidth or arithmetic.
//
// Design. The TPU kernel walks events one at a time, so each sees every
// earlier increment. Here the claim / credit / commit launches of
// rmw_common.cuh give the same counters and new flags in parallel; this
// file supplies the event source: a hash's four counters, one per 32-lane
// quarter of its block (distinct by construction). Only events
// i < nvalid take part: hash 0 is a real k-mer, so the zero padding of a
// tail chunk is excluded by index, never by value.

#include "blocked_common.cuh"

namespace khmer_blocked {
namespace {

struct HashEvents {
  const uint64_t* hashes;
  uint64_t nblocks;

  __device__ bool valid(int64_t) const { return true; }

  template <class F>
  __device__ void for_each_lane(int64_t i, F f) const {
    const uint64_t h = hashes[i];
    const uint64_t m = mix64(h);
    const uint64_t row = (h % nblocks) * kLanes;
#pragma unroll
    for (int t = 0; t < kSub; ++t) f(lane_index(row, m, t));
  }
};

}  // namespace
}  // namespace khmer_blocked

extern "C" const char* khmer_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Update table[nblocks][128] in place with hashes[0:nvalid] (of m), write
// the per-event new flags [m] (false from nvalid on), add the new count to
// *n_unique. winner [nblocks*128] must hold IDX_FILL and does again after.
extern "C" int khmer_blocked_update(uint8_t* table, int64_t nblocks,
                                    const int64_t* hashes, int64_t m,
                                    int64_t nvalid, int32_t* winner,
                                    bool* flags, int64_t* n_unique,
                                    int device, void* stream) {
  using namespace khmer_blocked;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const HashEvents ev{reinterpret_cast<const uint64_t*>(hashes),
                      static_cast<uint64_t>(nblocks)};
  return khmer_rmw::launch_rmw(
      ev, m, nvalid, table, winner, flags, nullptr,
      reinterpret_cast<unsigned long long*>(n_unique),
      static_cast<cudaStream_t>(stream));
}
