// Kernel A: the exact byte-layout Count-Min update over T prime tables,
// with the bigcount report and, where asked, each event's new flag.
//
// Replaces the TPU's byte update paths, which XLA compiled and no Pallas
// kernel covered: khmer_tpu/core/sketch_kernels.py:496 (v2_update_core),
// :312 (image_update_outputs) and the sort path of :600 (make_update).
// Its plain PyTorch version is
// khmer_tpu_torch/core/sketch_kernels.py:byte_update_plain.
//
// What bounds it: random single-byte traffic. Each event touches one
// counter in each of T tables that together far exceed L2 (200 MB at
// config 1, 4 GB at -x 1e9 -N 4), plus a 64-bit reduction per table (by
// a precomputed reciprocal, byte_common.cuh counter_index). The least
// work is one read and one write of each distinct counter the chunk
// touches; each costs a 32-byte sector.
//
// Design. The bucketed core of bucket_common.cuh, with the event's T
// counters as its lanes (distinct: each table has its own range of the
// flat buffer): one read and at most one write of each touched counter,
// no CAS and no table-sized scratch; the event stream (8 B a hash) is
// read three times and the chunk's (counter, event) pairs, 12 B each,
// twice. Exact at any batch and table size, so the v2 path's collision
// budget and sticky overflow flag, artifacts of its fixed-size sort, have
// no counterpart here. The T counters of an event lie in different
// buckets, so the buckets fold their per-lane results into per-event words
// (the new bit; with bigcount, the count of lanes at 255 and the least
// pre-chunk counter of those lanes); the last launch appends every event
// whose T counters all reached 255, as (hash, least pre-chunk counter), to
// a compact buffer through an atomic counter. The host groups them by
// hash: triggers = count - max(0, 255 - min_old), the rule of the JAX
// image path (khmer_tpu/core/sketch.py:267-295), equal to v2's per-hash
// ucnt - max(255 - min_old, 0). Counts saturate at 255 whether bigcount
// is on or off; bigcount lives only in the host map.
//
// The new flags (the tagged consume of a Countgraph, JAX's
// with_event_new, khmer_tpu/core/sketch_kernels.py:559-561) are the
// per-event words' new bit, which the last launch already reads to count
// n_unique: an event is new iff it is the lowest-index event of the chunk
// to touch some counter that was 0 before the chunk (the bucket kernel
// sets the bit on that event), which is the first event of a hash that
// the reference's sequential adds would count as new. They cost one byte
// an event written, nothing else.

#include "bucket_common.cuh"
#include "byte_common.cuh"

namespace khmer_byte {
namespace {

struct ByteEvents {
  using Item = uint64_t;
  const uint64_t* hashes;
  ByteLayout layout;

  __device__ Item load(int64_t i) const { return hashes[i]; }

  __device__ uint64_t key(uint64_t h, int t) const {
    return counter_index(layout, h, t);
  }
};

}  // namespace
}  // namespace khmer_byte

// Update the flat table buffer of `size` bytes in place with
// hashes[0:nvalid] and add the new count to *n_unique. primes/offsets are
// HOST arrays of ntables. ids .. min_old are the chunk's scratch of
// nbuckets buckets (core/sketch_kernels.py update_plan). With cand_hash
// non-null (bigcount on) the candidates go to cand_hash/cand_old [nvalid],
// their number added to *n_cand (zeroed by the caller). With flags
// non-null, flags[i] is event i's new flag for i < nvalid.
extern "C" int khmer_byte_update(uint8_t* flat, int64_t size, int ntables,
                                 const int64_t* primes,
                                 const int64_t* offsets,
                                 const int64_t* hashes, int64_t nvalid,
                                 int nbuckets, void* ids, void* start,
                                 void* cursor, void* ev_word, void* min_old,
                                 int64_t* n_unique,
                                 int64_t* cand_hash, int32_t* cand_old,
                                 int32_t* n_cand, bool* flags, int device,
                                 void* stream) {
  using namespace khmer_byte;
  ByteLayout layout;
  if (!make_layout(ntables, primes, offsets, &layout) || size <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const khmer_bucket::Scratch sc{
      static_cast<uint32_t*>(ids), static_cast<uint32_t*>(start),
      static_cast<uint32_t*>(cursor), static_cast<uint32_t*>(ev_word),
      static_cast<uint32_t*>(min_old)};
  const uint64_t* h = reinterpret_cast<const uint64_t*>(hashes);
  return khmer_bucket::launch_update(
      ByteEvents{h, layout}, ntables, static_cast<uint64_t>(size), nvalid,
      nvalid, static_cast<uint32_t>(nbuckets), sc, flat, flags,
      reinterpret_cast<unsigned long long*>(n_unique), h, cand_hash,
      cand_old, reinterpret_cast<unsigned int*>(n_cand),
      static_cast<cudaStream_t>(stream));
}
