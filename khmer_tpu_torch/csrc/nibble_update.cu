// Kernel P: the nibble-layout Count-Min update over T prime tables of
// 4-bit counters, with each event's new flag where asked.
//
// Replaces the TPU's nibble update, which XLA compiled and no Pallas kernel
// covered: khmer_tpu/core/sketch_kernels.py:198 (_nibble_table_update, one
// pass of :167 _nibble_phase a parity of bins), reached through :580
// (_apply_update) from :601 (make_update). Its plain PyTorch version is
// khmer_tpu_torch/core/sketch_kernels.py:nibble_update_plain. It serves a
// SmallCountgraph's dense consume, the window commits of diginorm and trim
// (core/diginorm.py SeqWindow) and the knot pipeline's adds.
//
// Layout (reference storage.hh:245-405): table t holds p_t counters in
// p_t / 2 + 1 bytes at byte offset_t of one flat buffer; counter b is the
// high nibble of byte b / 2 for an even b, the low one for an odd b. So
// lane-event (i, t) names flat nibble 2 * offset_t + h_i % p_t: its byte is
// key >> 1 and, offset_t counting bytes, its parity is key & 1 (even: the
// high nibble).
//
// What bounds it: as kernel A, random traffic into tables far larger than
// L2 (4 x 25 MB at -x 5e7, 4 GB at -x 2e9 -N 4); the least work is one
// read and one write of each distinct counter the chunk touches.
//
// Design. The bucketed core of bucket_common.cuh with the event's T
// counters as its lanes and a NibbleStore for its counters: one read and
// at most one write of each touched counter, no table-sized scratch, exact
// at any chunk and table size. Buckets are cut by counter range, so the
// two nibbles of one byte may lie in two buckets, whose blocks write that
// byte at once; a plain byte store would drop the other bucket's nibble.
// The write is therefore one 32-bit atomicAdd of (post - old) << shift on
// the aligned word that holds the nibble (as kernel J sets a bit with
// atomicOr). It is exact: only this bucket changes this nibble, `old` is
// its value before the chunk, and post = min(old + occ, 15) <= 15 cannot
// carry out of it. The new flags and n_unique follow the core's rule: a
// hash is new iff its first event is the lowest of the chunk to touch a
// counter that was 0 (JAX's two-phase credit, cred_e | cred_o over the
// tables, names the same events). A nibble never reaches the core's
// kMaxCount (255), so its bigcount report stays off and never fires.

#include "bucket_common.cuh"
#include "byte_common.cuh"

namespace khmer_nibble {
namespace {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;

constexpr uint32_t kNibbleMax = 15;

struct NibbleEvents {
  using Item = uint64_t;
  const uint64_t* hashes;
  ByteLayout layout;  // offsets in nibbles: twice the byte offsets

  __device__ Item load(int64_t i) const { return hashes[i]; }

  __device__ uint64_t key(uint64_t h, int t) const {
    return counter_index(layout, h, t);
  }
};

// Where flat nibble `key` lies in its little-endian 32-bit word (word
// key / 8): byte key / 2 is bits 8 ((key / 2) % 4) and up, and in it an
// even key holds bits 4-7, an odd one bits 0-3.
__device__ __forceinline__ uint32_t nibble_shift(uint64_t key) {
  return 8 * static_cast<uint32_t>((key >> 1) & 3) + ((key & 1) ? 0 : 4);
}

// 4-bit counters saturating at 15 as the core's counters; add() writes
// the change by a 32-bit atomicAdd on the nibble's word (see above).
struct NibbleStore {
  uint32_t* words;

  __device__ __forceinline__ uint32_t read(uint64_t key) const {
    return (words[key >> 3] >> nibble_shift(key)) & 0xFu;
  }
  __device__ __forceinline__ uint32_t add(uint64_t key, uint32_t old,
                                          uint32_t occ) const {
    const uint32_t post = min(old + occ, kNibbleMax);
    if (post != old) {
      atomicAdd(&words[key >> 3], (post - old) << nibble_shift(key));
    }
    return post;
  }
};

}  // namespace
}  // namespace khmer_nibble

// Update the joined nibble tables `flat` (`size` bytes, a multiple of 4,
// 4-byte aligned) in place with hashes[0:nvalid] and add the new count to
// *n_unique. primes/nibble_offsets are HOST arrays of ntables (the offsets
// in nibbles); ids .. ev_word are the chunk's scratch of nbuckets buckets
// (core/sketch_kernels.py update_plan). With flags non-null, flags[i] is
// event i's new flag for i < nvalid.
extern "C" int khmer_nibble_update(uint8_t* flat, int64_t size, int ntables,
                                   const int64_t* primes,
                                   const int64_t* nibble_offsets,
                                   const int64_t* hashes, int64_t nvalid,
                                   int nbuckets, void* ids, void* start,
                                   void* cursor, void* ev_word, bool* flags,
                                   int64_t* n_unique, int device,
                                   void* stream) {
  using namespace khmer_nibble;
  ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, nibble_offsets, &layout)
      || size <= 0 || size % 4 != 0
      || reinterpret_cast<uintptr_t>(flat) % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const khmer_bucket::Scratch sc{
      static_cast<uint32_t*>(ids), static_cast<uint32_t*>(start),
      static_cast<uint32_t*>(cursor), static_cast<uint32_t*>(ev_word),
      nullptr};
  return khmer_bucket::launch_store_update(
      NibbleEvents{reinterpret_cast<const uint64_t*>(hashes), layout},
      ntables, static_cast<uint64_t>(size) * 2, nvalid, nvalid,
      static_cast<uint32_t>(nbuckets), sc,
      NibbleStore{reinterpret_cast<uint32_t*>(flat)}, flags,
      reinterpret_cast<unsigned long long*>(n_unique), nullptr, nullptr,
      nullptr, nullptr, static_cast<cudaStream_t>(stream));
}
