// Kernel 1: the blocked Count-Min update, exact in stream order.
//
// Replaces the Pallas kernel khmer_tpu/ops/pallas_blocked.py:63
// (_make_update_call) and its XLA twin khmer_tpu/core/blocked.py:83
// (blocked_local_update), whose plain PyTorch version is
// khmer_tpu_torch/core/blocked.py:blocked_local_update.
//
// What bounds it: random 128-byte row traffic. Each event touches four
// counters in one 128-byte block of a table far larger than L2 (200 MB
// to 2.1 GB), with a few integer ops per touch. The least work is one
// read and one write of each distinct counter the chunk touches, each a
// 32-byte sector.
//
// Design. The TPU kernel walks events one at a time, so each sees every
// earlier increment. Here the bucketed core of bucket_common.cuh gives the
// same counters and new flags in parallel, reading and writing each
// touched counter once, with scratch sized by the chunk; this file
// supplies the event source: a hash's four counters, one per 32-lane
// quarter of its block (distinct by construction). Only events
// i < nvalid take part: hash 0 is a real k-mer, so the zero padding of a
// tail chunk is excluded by index, never by value.

#include "blocked_common.cuh"
#include "bucket_common.cuh"

namespace khmer_blocked {
namespace {

struct HashEvents {
  using Item = uint64_t;
  const uint64_t* hashes;
  uint64_t nblocks;
  uint64_t recip;  // khmer_cuda::reciprocal(nblocks)

  __device__ Item load(int64_t i) const { return hashes[i]; }

  __device__ uint64_t key(uint64_t h, int t) const {
    return lane_index(row_of(h, nblocks, recip), mix64(h), t);
  }
};

}  // namespace
}  // namespace khmer_blocked

extern "C" const char* khmer_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Update table[nblocks][128] in place with hashes[0:nvalid] (of m), write
// the per-event new flags [m] (false from nvalid on), add the new count to
// *n_unique. ids .. ev_word are the chunk's scratch of nbuckets buckets
// (core/sketch_kernels.py update_plan).
extern "C" int khmer_blocked_update(uint8_t* table, int64_t nblocks,
                                    const int64_t* hashes, int64_t m,
                                    int64_t nvalid, int nbuckets, void* ids,
                                    void* start, void* cursor, void* ev_word,
                                    bool* flags,
                                    int64_t* n_unique, int device,
                                    void* stream) {
  using namespace khmer_blocked;
  if (nblocks <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const khmer_bucket::Scratch sc{
      static_cast<uint32_t*>(ids), static_cast<uint32_t*>(start),
      static_cast<uint32_t*>(cursor), static_cast<uint32_t*>(ev_word),
      nullptr};
  return khmer_bucket::launch_update(
      HashEvents{reinterpret_cast<const uint64_t*>(hashes),
                 static_cast<uint64_t>(nblocks),
                 khmer_cuda::reciprocal(static_cast<uint64_t>(nblocks))},
      kSub, static_cast<uint64_t>(nblocks) * kLanes, m, nvalid,
      static_cast<uint32_t>(nbuckets), sc, table, flags,
      reinterpret_cast<unsigned long long*>(n_unique), nullptr, nullptr,
      nullptr, nullptr, static_cast<cudaStream_t>(stream));
}
