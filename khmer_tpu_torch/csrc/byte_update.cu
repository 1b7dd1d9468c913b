// Kernel A: the exact byte-layout Count-Min update over T prime tables,
// with the bigcount report.
//
// Replaces the TPU's byte update paths, which XLA compiled and no Pallas
// kernel covered: khmer_tpu/core/sketch_kernels.py:496 (v2_update_core),
// :312 (image_update_outputs) and the sort path of :600 (make_update).
// Its plain PyTorch version is
// khmer_tpu_torch/core/sketch_kernels.py:byte_update_plain.
//
// What bounds it: random single-byte traffic. Each event touches one
// counter in each of T tables that together far exceed L2 (200 MB at
// config 1, 4 GB at -x 1e9 -N 4) and the same entries of the winner image
// (4 B per counter), plus a 64-bit modulo per table. The limit is the
// number of random sector accesses.
//
// Design. The claim / credit / commit launches of rmw_common.cuh, with the
// event's T counters as its lanes (distinct: each table has its own range
// of the flat buffer). Exact at any batch and table size, so the v2 path's
// collision budget and sticky overflow flag, artifacts of its fixed-size
// sort, have no counterpart here. The credit pass keeps each event's least
// pre-chunk counter; with bigcount on, a fourth launch appends every event
// whose counters are all 255 after the commit, as (hash, least pre-chunk
// counter), to a compact buffer through an atomic counter. The host groups
// them by hash: triggers = count - max(0, 255 - min_old), the rule of the
// JAX image path (khmer_tpu/core/sketch.py:267-295), equal to v2's
// per-hash ucnt - max(255 - min_old, 0). Counts saturate at 255 whether
// bigcount is on or off; bigcount lives only in the host map.

#include "byte_common.cuh"

namespace khmer_byte {
namespace {

using khmer_rmw::grid_for;
using khmer_rmw::kMaxCount;
using khmer_rmw::kThreads;
using khmer_rmw::thread_index;

struct ByteEvents {
  const uint64_t* hashes;
  ByteLayout layout;

  __device__ bool valid(int64_t) const { return true; }

  template <class F>
  __device__ void for_each_lane(int64_t i, F f) const {
    const uint64_t h = hashes[i];
    for (int t = 0; t < layout.ntables; ++t) f(counter_index(layout, h, t));
  }
};

__global__ void report_kernel(ByteEvents ev, int64_t nvalid,
                              const uint8_t* __restrict__ table,
                              const uint8_t* __restrict__ min_old,
                              int64_t* __restrict__ cand_hash,
                              int32_t* __restrict__ cand_old,
                              unsigned int* __restrict__ n_cand) {
  const int64_t i = thread_index();
  if (i >= nvalid) return;
  int post = kMaxCount;
  ev.for_each_lane(i, [&](uint64_t lane) {
    post = min(post, static_cast<int>(table[lane]));
  });
  if (post == kMaxCount) {
    const unsigned int slot = atomicAdd(n_cand, 1u);
    cand_hash[slot] = static_cast<int64_t>(ev.hashes[i]);
    cand_old[slot] = min_old[i];
  }
}

}  // namespace
}  // namespace khmer_byte

// Update the flat table buffer in place with hashes[0:nvalid] and add the
// new count to *n_unique. primes/offsets are HOST arrays of ntables.
// winner [flat length] must hold IDX_FILL and does again after. With
// cand_hash non-null (bigcount on), min_old [nvalid] is scratch and the
// candidates go to cand_hash/cand_old [nvalid], their number added to
// *n_cand (zeroed by the caller).
extern "C" int khmer_byte_update(uint8_t* flat, int ntables,
                                 const int64_t* primes,
                                 const int64_t* offsets,
                                 const int64_t* hashes, int64_t nvalid,
                                 int32_t* winner, uint8_t* min_old,
                                 int64_t* n_unique, int64_t* cand_hash,
                                 int32_t* cand_old, int32_t* n_cand,
                                 int device, void* stream) {
  using namespace khmer_byte;
  ByteLayout layout;
  if (!make_layout(ntables, primes, offsets, &layout)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ByteEvents ev{reinterpret_cast<const uint64_t*>(hashes), layout};
  err = khmer_rmw::launch_rmw(
      ev, nvalid, nvalid, flat, winner, nullptr,
      cand_hash != nullptr ? min_old : nullptr,
      reinterpret_cast<unsigned long long*>(n_unique), s);
  if (err != cudaSuccess || cand_hash == nullptr || nvalid == 0) return err;
  report_kernel<<<grid_for(nvalid), kThreads, 0, s>>>(
      ev, nvalid, flat, min_old, cand_hash, cand_old,
      reinterpret_cast<unsigned int*>(n_cand));
  return cudaGetLastError();
}
