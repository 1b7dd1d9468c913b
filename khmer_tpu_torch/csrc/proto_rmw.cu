// Kernel D: the fused blocked read-modify-write over decoded events.
//
// Replaces the Pallas prototype scripts/pallas_proto.py:44 (make_kernel,
// pallas_call :109), which walks precomputed events one by one through a
// VMEM-resident table: bids[i] (block id, < 0 invalid) and offs[i] (four
// lane offsets, 8 bits each, & 127). Its plain PyTorch version is
// khmer_tpu_torch/core/blocked.py:proto_rmw_plain; the microbenchmark is
// khmer_tpu_torch/scripts/pallas_proto.py.
//
// What bounds it: random 128-byte row traffic, as for kernel 1 (the same
// update with the hash already decoded): 8 bytes of event per event, up to
// four counters and winner entries in one block.
//
// Design. The claim / credit / commit launches of kernel 1
// (rmw_common.cuh) with this decoder in place of the hash. An event's
// lanes are a SET, as in the Pallas kernel, which ORs the four one-hots
// (pallas_proto.py:87-93): a repeated offset is incremented once. (The
// script's numpy oracle, :160-162, would increment it twice; the two agree
// on the script's inputs, one lane per quarter.) nnew counts the valid
// events that found one of their lanes at 0, in stream order. A block id
// at or past nblocks makes the event invalid, as a negative one does.

#include "blocked_common.cuh"
#include "rmw_common.cuh"

namespace khmer_blocked {
namespace {

struct ProtoEvents {
  const int32_t* bids;
  const int32_t* offs;
  int64_t nblocks;

  __device__ bool valid(int64_t i) const {
    return bids[i] >= 0 && bids[i] < nblocks;
  }

  template <class F>
  __device__ void for_each_lane(int64_t i, F f) const {
    const uint64_t row = static_cast<uint64_t>(bids[i]) * kLanes;
    const int32_t packed = offs[i];
    int o[kSub];
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      o[j] = (packed >> (8 * j)) & (kLanes - 1);
      bool repeated = false;
#pragma unroll
      for (int k = 0; k < j; ++k) repeated |= o[k] == o[j];
      if (!repeated) f(row + o[j]);
    }
  }
};

}  // namespace
}  // namespace khmer_blocked

// Update table[nblocks][128] in place with the m events in order and add
// the number of new events to *nnew. winner [nblocks*128] must hold
// IDX_FILL and does again after.
extern "C" int khmer_proto_rmw(const int32_t* bids, const int32_t* offs,
                               int64_t m, uint8_t* table, int64_t nblocks,
                               int32_t* winner, int64_t* nnew, int device,
                               void* stream) {
  using namespace khmer_blocked;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ProtoEvents ev{bids, offs, nblocks};
  return khmer_rmw::launch_rmw(
      ev, m, m, table, winner, nullptr, nullptr,
      reinterpret_cast<unsigned long long*>(nnew),
      static_cast<cudaStream_t>(stream));
}
