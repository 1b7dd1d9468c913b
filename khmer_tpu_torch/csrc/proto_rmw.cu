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
// update with the hash already decoded): 8 bytes of event per event, and
// one read and one write of each distinct counter the events touch.
//
// Design. The bucketed core of bucket_common.cuh, as kernel 1 runs it,
// with this decoder in place of the hash: one read and at most one write
// of each touched counter, and scratch sized by the events, not the table.
// An event's lanes are a SET, as in the Pallas kernel, which ORs the four
// one-hots (pallas_proto.py:87-93): a lane that repeats an earlier lane of
// its event takes no part, so a repeated offset is incremented once. (The
// script's numpy oracle, :160-162, would increment it twice; the two agree
// on the script's inputs, one lane per quarter.) A block id below 0 or at
// or past nblocks makes the event invalid: none of its lanes takes part.
// nnew counts the events that were first to a counter at 0, the core's
// rule, equal to the Pallas kernel's sequential any(hot & tile == 0).

#include "blocked_common.cuh"
#include "bucket_common.cuh"

namespace khmer_blocked {
namespace {

struct ProtoEvents {
  struct Item {
    int32_t bid;
    int32_t offs;
  };
  const int32_t* bids;
  const int32_t* offs;
  int64_t nblocks;

  __device__ Item load(int64_t i) const { return {bids[i], offs[i]}; }

  __device__ uint64_t key(const Item& x, int t) const {
    if (x.bid < 0 || x.bid >= nblocks) return khmer_bucket::kNone;
    const int o = (x.offs >> (8 * t)) & (kLanes - 1);
#pragma unroll
    for (int k = 0; k < kSub - 1; ++k) {
      if (k < t && ((x.offs >> (8 * k)) & (kLanes - 1)) == o) {
        return khmer_bucket::kNone;
      }
    }
    return static_cast<uint64_t>(x.bid) * kLanes + o;
  }
};

}  // namespace
}  // namespace khmer_blocked

// Update table[nblocks][128] in place with the m events in order and add
// the number of new events to *nnew. ids .. ev_word are the events'
// scratch of nbuckets buckets (core/sketch_kernels.py update_plan(m, 4)).
extern "C" int khmer_proto_rmw(const int32_t* bids, const int32_t* offs,
                               int64_t m, uint8_t* table, int64_t nblocks,
                               int nbuckets, void* ids, void* start,
                               void* cursor, void* ev_word, int64_t* nnew,
                               int device, void* stream) {
  using namespace khmer_blocked;
  if (nblocks <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const khmer_bucket::Scratch sc{
      static_cast<uint32_t*>(ids), static_cast<uint32_t*>(start),
      static_cast<uint32_t*>(cursor), static_cast<uint32_t*>(ev_word),
      nullptr};
  return khmer_bucket::launch_update(
      ProtoEvents{bids, offs, nblocks}, kSub,
      static_cast<uint64_t>(nblocks) * kLanes, m, m,
      static_cast<uint32_t>(nbuckets), sc, table, nullptr,
      reinterpret_cast<unsigned long long*>(nnew), nullptr, nullptr, nullptr,
      nullptr, static_cast<cudaStream_t>(stream));
}
