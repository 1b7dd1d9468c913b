// Kernel J: the Bloom-filter (bit table) test-and-set over T prime tables,
// in stream order, with a per-event new flag.
//
// Replaces the TPU's bit update, which XLA compiled and no Pallas kernel
// covered: khmer_tpu/core/sketch_kernels.py:204 (_bit_table_update, with
// :55 _dedup_batch, :103 _group_by_bin and :580 _apply_update), reached
// through khmer_tpu/core/pipeline.py:209 _update_dispatch with its
// per-event flags (:242-254) and through :722 make_abund_dist. Its plain
// PyTorch version is khmer_tpu_torch/core/sketch_kernels.py:
// bit_update_plain; its two parts, the probe and the commit of the lanes
// it leaves open, are mirrored by bit_probe_plain and bit_commit_plain.
//
// Semantics (sequential BitStorage::add, reference storage.hh:95-229): an
// event is new iff, in some table, it is the lowest-index event of the
// chunk to touch a bit that was 0 before the chunk; every touched bit is
// set; n_unique grows by the new events. Events past nvalid, or whose
// entry of the optional valid mask is 0, take no part and are not new.
//
// What bounds it: random bit traffic. Each event touches one bit in each
// of T tables, 4 GB of them at -x 8e9 -N 4, far beyond L2, so each lane
// reads a 32-byte sector of its own; a lane whose bit was 0 also writes
// it. Beside that, 8 B a hash and 1 B a flag.
//
// Design, on the current stream with no host sync:
//   0. sample: one block probes kSample events spread evenly over the chunk
//      and decides whether the probe pays: at most kProbeMaxOpen percent
//      of the sampled lanes are open (their bit is 0). Where more are, as
//      in a stream's first chunks or a fresh table, probing every lane
//      would read each sector once more for nothing (measured: 0.665
//      against 0.527 ms on a chunk that sets all its bits in 4 GB, PERF.md
//      section 6).
//   1. probe: one thread per event computes its T flat bit indices (8 *
//      the table's byte offset in the joined buffer + h % p_t, 64-bit:
//      3.2e10 bits at -x 8e9 -N 4), issues the T loads together, kProbe
//      tables at a time, and writes the event's lane mask: bit t set iff
//      the event takes part and its bit in table t is 0 (an open lane).
//      Where the sample rules the probe out, it loads nothing and opens
//      every lane of each event that takes part. The mask is chunk
//      scratch (the min_old part of update_plan, which the bigcount report
//      of the byte updates uses and J does not).
//   2. commit: the bucketed core of bucket_common.cuh over the open lanes
//      alone (BitEvents::key is kNone for a settled lane, so the count and
//      scatter passes skip it, and an event with no open lane is never
//      new). One block per bucket gathers each distinct bit with its
//      lowest event, reads it and, where it was 0, sets it with one
//      atomicOr on its 32-bit word and credits that event; the same
//      per-event words and finalize as kernels A and 1 give the flags and
//      the count.
// Most lanes of a stream land on bits an earlier chunk set (from its sixth
// chunk on, more than 70% of load-graph's on 9b's reads): the probe settles
// them with one read each, and only the rest go through the core's five
// launches. The scratch is sized by the chunk (update_plan), never by the
// tables, and no sort of the chunk is made.

#include "bucket_common.cuh"
#include "byte_common.cuh"

namespace khmer_bit {
namespace {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;
using khmer_cuda::kThreads;
using khmer_cuda::thread_index;

constexpr int kProbe = 8;     // tables whose loads a thread issues together
constexpr int kSample = 1024;  // events the sample probes: BIT_SAMPLE
// The probe runs where at most this percent of the sampled lanes are open
// (BIT_PROBE_MAX_OPEN): where probing every lane and sending every lane to
// the commit cross on 9b's stream into 4 GB, between its chunk 2 (53% of
// lanes open: 0.461 against 0.480 ms) and chunk 1 (71%: 0.569 against
// 0.503), by scripts/graph_bench.py --rules (PERF.md section 6).
constexpr int kProbeMaxOpen = 57;

// Bit t of the result set iff hash h's bit in table t is 0: the T loads
// issued kProbe at a time before any is used.
__device__ __forceinline__ uint32_t zero_lanes(const ByteLayout& layout,
                                               const uint8_t* flat,
                                               uint64_t h) {
  uint32_t open = 0;
  for (int t0 = 0; t0 < layout.ntables; t0 += kProbe) {
    uint32_t bit[kProbe];
#pragma unroll
    for (int u = 0; u < kProbe; ++u) {
      if (t0 + u < layout.ntables) {
        const uint64_t key = counter_index(layout, h, t0 + u);
        bit[u] = (flat[key >> 3] >> (key & 7)) & 1u;
      }
    }
#pragma unroll
    for (int u = 0; u < kProbe; ++u) {
      if (t0 + u < layout.ntables && bit[u] == 0) open |= 1u << (t0 + u);
    }
  }
  return open;
}

__device__ __forceinline__ bool takes_part(const bool* valid, int64_t i) {
  return valid == nullptr || valid[i];
}

// The sum over a block of kBlock threads of each thread's v, in thread 0.
template <int kBlock>
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* warps) {
  v = __reduce_add_sync(0xFFFFFFFFu, v);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t sum = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kBlock / 32; ++w) sum += warps[w];
  }
  return sum;
}

// Step 0, one block of kSample threads, one for each event j * nvalid /
// kSample: *probe becomes 1 iff at most kProbeMaxOpen percent of their
// lanes are open.
__global__ void __launch_bounds__(kSample)
bit_sample_kernel(const uint64_t* __restrict__ hashes,
                  const bool* __restrict__ valid, int64_t nvalid,
                  ByteLayout layout, const uint8_t* __restrict__ flat,
                  uint32_t* __restrict__ probe) {
  __shared__ uint32_t warps[kSample / 32];
  const int64_t i = threadIdx.x * nvalid / kSample;
  uint32_t lanes = 0, open = 0;
  if (takes_part(valid, i)) {
    lanes = layout.ntables;
    open = __popc(zero_lanes(layout, flat, hashes[i]));
  }
  const uint32_t all = block_sum<kSample>(lanes, warps);
  __syncthreads();
  const uint32_t opened = block_sum<kSample>(open, warps);
  if (threadIdx.x == 0) {
    *probe = 100 * static_cast<int64_t>(opened)
             <= static_cast<int64_t>(kProbeMaxOpen) * all;
  }
}

// Step 1: one thread per event i < nvalid (grid_for(nvalid) blocks of
// kThreads).
__global__ void __launch_bounds__(kThreads)
bit_probe_kernel(const uint64_t* __restrict__ hashes,
                 const bool* __restrict__ valid, int64_t nvalid,
                 ByteLayout layout, const uint8_t* __restrict__ flat,
                 const uint32_t* __restrict__ probe,
                 uint32_t* __restrict__ mask) {
  const int64_t i = thread_index();
  if (i >= nvalid) return;
  uint32_t open = 0;
  if (takes_part(valid, i)) {
    open = *probe ? zero_lanes(layout, flat, hashes[i])
                  : ~0u >> (32 - layout.ntables);
  }
  mask[i] = open;
}

// A hash and its lane mask from the probe.
struct BitItem {
  uint64_t h;
  uint32_t open;
};

struct BitEvents {
  using Item = BitItem;
  const uint64_t* hashes;
  const uint32_t* mask;  // the probe's lane masks
  ByteLayout layout;     // offsets in bits

  // both loads at once: the hash is not made to wait for the mask
  __device__ Item load(int64_t i) const { return {hashes[i], mask[i]}; }
  // a lane in a bucket is open: no mask load
  __device__ Item bucket_load(int64_t i) const { return {hashes[i], ~0u}; }

  __device__ uint64_t key(const BitItem& x, int t) const {
    return (x.open >> t) & 1u ? counter_index(layout, x.h, t)
                              : khmer_bucket::kNone;
  }
};

// Bits as the core's counters: the value before the chunk is the bit. A
// bit that was 0 is set by one atomicOr on its little-endian 32-bit word
// (bit b of byte j is bit 8 (j % 4) + b of word j / 4): buckets are cut by
// bit range, so a word may hold bits of two buckets, and atomicOr changes
// this bit alone, where a plain store could drop the other bucket's. The
// read stays although a probed lane's bit was 0: in a call the sample
// left unprobed, lanes on set bits reach the commit too, and the read
// fetches the sector the atomicOr then finds in L2.
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
// primes/bit_offsets are HOST arrays of ntables; ids .. mask are the
// chunk's scratch of nbuckets buckets (core/sketch_kernels.py
// update_plan; mask is its min_old part, which keeps the probe's lane
// masks after the call).
extern "C" int khmer_bit_update(uint8_t* flat, int64_t size, int ntables,
                                const int64_t* primes,
                                const int64_t* bit_offsets,
                                const int64_t* hashes, const bool* valid,
                                int64_t m_total, int64_t nvalid,
                                int nbuckets, void* ids, void* start,
                                void* cursor, void* ev_word, void* mask,
                                bool* flags, int64_t* n_unique,
                                int device, void* stream) {
  using namespace khmer_bit;
  ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, bit_offsets, &layout)
      || size <= 0 || size % 4 != 0
      || reinterpret_cast<uintptr_t>(flat) % 4 != 0 || nvalid > m_total) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* h = reinterpret_cast<const uint64_t*>(hashes);
  auto* lane_mask = static_cast<uint32_t*>(mask);
  // the sample's decision lives in start[0] until the core clears start
  auto* probe = static_cast<uint32_t*>(start);
  if (nvalid > 0) {
    bit_sample_kernel<<<1, kSample, 0, s>>>(h, valid, nvalid, layout, flat,
                                            probe);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bit_probe_kernel<<<khmer_cuda::grid_for(nvalid), kThreads, 0, s>>>(
        h, valid, nvalid, layout, flat, probe, lane_mask);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const khmer_bucket::Scratch sc{
      static_cast<uint32_t*>(ids), static_cast<uint32_t*>(start),
      static_cast<uint32_t*>(cursor), static_cast<uint32_t*>(ev_word),
      nullptr};
  return khmer_bucket::launch_store_update(
      BitEvents{h, lane_mask, layout}, ntables,
      static_cast<uint64_t>(size) * 8, m_total, nvalid,
      static_cast<uint32_t>(nbuckets), sc,
      BitStore{reinterpret_cast<uint32_t*>(flat)}, flags,
      reinterpret_cast<unsigned long long*>(n_unique), nullptr, nullptr,
      nullptr, nullptr, s);
}
