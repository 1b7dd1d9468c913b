// Kernel J: the Bloom-filter (bit table) test-and-set over T prime tables,
// in stream order, with a per-event new flag.
//
// Replaces the TPU's bit update, which XLA compiled and no Pallas kernel
// covered: khmer_tpu/core/sketch_kernels.py:204 (_bit_table_update, with
// :55 _dedup_batch, :103 _group_by_bin and :580 _apply_update), reached
// through khmer_tpu/core/pipeline.py:209 _update_dispatch with its
// per-event flags (:242-254) and through :722 make_abund_dist. Its plain
// PyTorch version is khmer_tpu_torch/core/sketch_kernels.py:
// bit_update_plain.
//
// Semantics (sequential BitStorage::add, reference storage.hh:95-229): an
// event is new iff, in some table, it is the lowest-index event of the
// chunk to touch a bit that was 0 before the chunk; every touched bit is
// set; n_unique grows by the new events. Events past nvalid, or whose
// entry of the optional valid mask is 0, take no part and are not new.
//
// What bounds it: random bit traffic. Each event touches one bit in each
// of T tables, 4 GB of them at -x 8e9 -N 4, far beyond L2; the least work
// is one read of each distinct 32-byte sector a chunk touches and one
// write of each bit it sets, beside 8 B a hash and 1 B a flag.
//
// Design. The bucketed core of bucket_common.cuh, with flat bit indices as
// its keys (8 * the table's byte offset in the joined buffer + h % p_t,
// 64-bit: 3.2e10 bits at -x 8e9 -N 4) and BitStore below as what a bucket
// commits to: one block per bucket reads each distinct bit once and, where
// it was 0, sets it with one atomicOr on its 32-bit word (buckets are cut
// by bit range, so a word may span two buckets: a plain byte store could
// drop the other bucket's bits) and credits its lowest event. The same
// per-event words and finalize as kernels A and 1 give the flags and the
// count. The events are sized by the chunk (update_plan), never by the
// tables, and no sort of the chunk is made: this one launch sequence takes
// the place of the plain version's three sorts, its index_add_ and its
// scatter_reduce_.

#include "bucket_common.cuh"
#include "byte_common.cuh"

namespace khmer_bit {
namespace {

using khmer_byte::ByteLayout;

// A hash and whether its event takes part.
struct BitItem {
  uint64_t h;
  bool live;
};

struct BitEvents {
  using Item = BitItem;
  const uint64_t* hashes;
  const bool* valid;  // nullable: every event i < nvalid takes part
  ByteLayout layout;  // offsets in bits

  __device__ Item load(int64_t i) const {
    return {hashes[i], valid == nullptr || valid[i]};
  }

  __device__ uint64_t key(const BitItem& x, int t) const {
    return x.live ? khmer_byte::counter_index(layout, x.h, t)
                  : khmer_bucket::kNone;
  }
};

// Bits as the core's counters: the value before the chunk is the bit; a
// bit that was 0 is set by one atomicOr on its little-endian 32-bit word
// (bit b of byte j is bit 8 (j % 4) + b of word j / 4).
struct BitStore {
  uint32_t* words;

  __device__ __forceinline__ uint32_t read(uint64_t key) const {
    return (words[key >> 5] >> (key & 31)) & 1u;
  }
  __device__ __forceinline__ uint32_t add(uint64_t key, uint32_t old,
                                          uint32_t) const {
    if (old == 0) atomicOr(&words[key >> 5], 1u << (key & 31));
    return 1;
  }
};

}  // namespace
}  // namespace khmer_bit

// Update the joined bit tables `flat` (`size` bytes, a multiple of 4, 4-byte
// aligned) in place with the events i < nvalid of hashes [m_total] (those
// with valid[i], when valid is not null), write their new flags to flags
// [m_total] (false from nvalid on) and add their count to *n_unique.
// primes/bit_offsets are HOST arrays of ntables; ids .. ev_word are the
// chunk's scratch of nbuckets buckets (core/sketch_kernels.py update_plan).
extern "C" int khmer_bit_update(uint8_t* flat, int64_t size, int ntables,
                                const int64_t* primes,
                                const int64_t* bit_offsets,
                                const int64_t* hashes, const bool* valid,
                                int64_t m_total, int64_t nvalid,
                                int nbuckets, void* ids, void* start,
                                void* cursor, void* ev_word, bool* flags,
                                int64_t* n_unique, int device,
                                void* stream) {
  using namespace khmer_bit;
  ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, bit_offsets, &layout)
      || size <= 0 || size % 4 != 0
      || reinterpret_cast<uintptr_t>(flat) % 4 != 0 || nvalid > m_total) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const khmer_bucket::Scratch sc{
      static_cast<uint32_t*>(ids), static_cast<uint32_t*>(start),
      static_cast<uint32_t*>(cursor), static_cast<uint32_t*>(ev_word),
      nullptr};
  return khmer_bucket::launch_store_update(
      BitEvents{reinterpret_cast<const uint64_t*>(hashes), valid, layout},
      ntables, static_cast<uint64_t>(size) * 8, m_total, nvalid,
      static_cast<uint32_t>(nbuckets), sc,
      BitStore{reinterpret_cast<uint32_t*>(flat)}, flags,
      reinterpret_cast<unsigned long long*>(n_unique), nullptr, nullptr,
      nullptr, nullptr, static_cast<cudaStream_t>(stream));
}
