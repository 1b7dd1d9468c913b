// Exact stream-order update of saturating u8 counters, one read and one
// write of each distinct counter a chunk touches, with scratch sized by
// the chunk.
//
// Shared by the blocked update (kernel 1, blocked_update.cu), the byte
// update (kernel A, byte_update.cu), the decoded-event update (kernel
// D, proto_rmw.cu) and, with bits for counters, the Bloom-filter update
// (kernel J, bit_update.cu: a Store other than CounterStore, below). They
// differ only in how an event names its counters,
// so each supplies an event source `Ev` with
//
//   using Item = ...;
//   __device__ Item load(int64_t i) const;
//   __device__ uint64_t key(const Item& x, int t) const;
//
// where load(i) reads event i once (a hash, or a block id and its packed
// offsets; an event source may add bucket_load(i), the item a bucket reads
// for a lane that takes part) and key(load(i), t), t < ntables, is the
// flat counter of
// lane-event (i, t), or kNone when that lane-event takes no part: an
// invalid event, a lane that repeats an earlier lane of the same event
// (kernel D), or a lane whose bit its probe found already set (kernel J).
// The counters of one event that take part are distinct. Kernels 1 and A
// never return kNone; events i >= nvalid take no part in any kernel.
//
// Semantics (sequential ByteStorage::add, reference storage.hh:571-624):
// each counter becomes min(old + occurrences in the chunk, 255); an event
// is new iff it is the lowest-index event of the chunk to touch a counter
// whose value before the chunk was 0 (equal to the sequential rule: capped
// +1s commute, and a repeat of a hash touches the same counters later).
//
// Design. A lane-event is one counter of one event, named by the 32-bit
// id i * ntables + t; a chunk of n events has at most n * ntables that
// take part (the count and scatter passes skip kNone). They
// are partitioned into buckets by counter range, the number of buckets
// taken from the lane-event count (core/sketch_kernels.py update_plan:
// about 512 a bucket, at most kMaxBuckets), never from the table size:
//   1. count:   each block counts its tile's lane-events per bucket in a
//               shared histogram and adds it to the global counts;
//   2. scan:    one block turns the counts into bucket starts;
//   3. scatter: each block counts its tile again, reserves one range per
//               bucket with one global atomic, and writes its ids there
//               (positions from shared atomics);
//   4. bucket:  one block per bucket rebuilds each id's counter from its
//               event (the chunk's 8 MB of events stay in L2) and builds an
//               open-addressing map in shared memory from counter to
//               (occurrences, lowest event), aggregating equal counters
//               within a warp first (__match_any_sync); its slots follow
//               the counters' address order. Then each map entry reads its
//               counter once and writes min(old + occ, 255) once, as a
//               plain byte store (a counter lies in one bucket, so no other
//               block writes it), the reads of a thread issued together
//               and a warp's on neighbouring counters. A counter that was 0
//               sets the new bit of its lowest event in a per-event word. With the bigcount report on, a bucket
//               that saturated a counter reads its ids once more and, for
//               each lane-event on a counter now at 255, counts it in the
//               event's word and folds the counter's old value into the
//               event's min_old;
//   5. finalize: one thread per event writes the new flag, counts the new
//               events (a block reduce, one 64-bit atomic per block) and,
//               with the report on, appends each event whose ntables
//               counters all reached 255 as (hash, min_old), from the hash
//               array the caller names.
// A bucket whose distinct counters do not fit the map (kLoadLimit) is
// split inside the kernel: its counters are halved by the top bits of a
// bijective mix, depth first, each half in its own pass over the bucket's
// ids, until every part fits. It never falls back to the plain version,
// and any skew (one hash repeated 2^20 times, every event on a few hundred
// counters) costs passes, not correctness.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace khmer_bucket {
// internal linkage: both update files include this header
namespace {

using khmer_cuda::grid_for;
using khmer_cuda::kMaxCount;
using khmer_cuda::kThreads;
using khmer_cuda::thread_index;

// core/sketch_kernels.py MAX_BUCKETS; the wrapper plans the bucket count
constexpr uint32_t kMaxBuckets = 16384;
constexpr int kTileEvents = 8;          // events per thread of a tile
constexpr int kSlots = 2048;            // map slots of a bucket block: 32 KB
constexpr int kLoadLimit = kSlots / 2;  // distinct counters per pass
constexpr int kMapThreads = kThreads;   // threads of a bucket block
constexpr int kPerThread = kSlots / kMapThreads;
static_assert(kLoadLimit + kMapThreads < kSlots,
              "the map must never fill");
constexpr int kUnroll = 2;              // ids a lane loads at once
constexpr int kMaxDepth = 64;           // a part at depth 64 holds one key
constexpr uint64_t kNone = ~0ULL;      // Ev::key: takes no part
constexpr unsigned long long kEmpty = kNone;  // a free map slot
constexpr uint32_t kNewBit = 1u << 31;  // per-event word: new
constexpr uint32_t kSatMask = 0xFFu;    //   and saturated lanes, below
constexpr uint32_t kSatBit = 1u << 8;   // map entry after commit: at 255

// What a bucket commits to: u8 counters saturating at 255 (kernels 1, A
// and D). read(key) is the counter before the chunk; add(key, old, occ)
// applies the chunk's occ adds to it, writes it where it changed (a
// counter lies in one bucket, so no other block writes it) and returns it.
struct CounterStore {
  uint8_t* table;

  __device__ __forceinline__ uint32_t read(uint64_t key) const {
    return table[key];
  }
  __device__ __forceinline__ uint32_t add(uint64_t key, uint32_t old,
                                          uint32_t occ) const {
    const uint32_t post = min(old + occ, static_cast<uint32_t>(kMaxCount));
    if (post != old) table[key] = static_cast<uint8_t>(post);
    return post;
  }
};

// The chunk's scratch (core/sketch_kernels.py update_plan): lane-event
// ids [n * ntables], bucket starts [nbuckets + 1], scatter cursors
// [nbuckets], per-event words and min_old [n].
struct Scratch {
  uint32_t* ids;
  uint32_t* start;
  uint32_t* cursor;
  uint32_t* ev_word;
  uint32_t* min_old;
};

// The bucket of flat counter index key < size, with q = (2^64 - 1) / size:
// floor(key * q * nbuckets / 2^64), monotone in key, so each bucket is one
// contiguous range of counters (core/sketch_kernels.py bucket_of).
__device__ __forceinline__ uint32_t bucket_of(uint64_t key, uint64_t q,
                                              uint32_t nbuckets) {
  return static_cast<uint32_t>(__umul64hi(key * q, nbuckets));
}

// splitmix64 finalizer: a bijection, so distinct counters differ in it.
__device__ __forceinline__ uint64_t mix(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

// Whether counter `key` lies in the part of a bucket named by the top
// `depth` bits of its mix.
__device__ __forceinline__ bool in_part(uint64_t key, uint64_t part,
                                        int depth) {
  return depth == 0 || (mix(key) >> (64 - depth)) == part;
}

// Event i's item for a lane that reached a bucket, so takes part:
// Ev::bucket_load(i) where the event source has one (kernel J's skips its
// probe's mask), else Ev::load(i).
template <class Ev>
__device__ __forceinline__ auto bucket_item(const Ev& ev, int64_t i, int)
    -> decltype(ev.bucket_load(i)) {
  return ev.bucket_load(i);
}
template <class Ev>
__device__ __forceinline__ auto bucket_item(const Ev& ev, int64_t i, long)
    -> decltype(ev.load(i)) {
  return ev.load(i);
}

// The counter and event of lane-event `id`, which takes part.
template <class Ev>
__device__ __forceinline__ uint64_t key_of(const Ev& ev, uint32_t id,
                                           int ntables, uint32_t* event) {
  const uint32_t i = id / static_cast<uint32_t>(ntables);
  *event = i;
  return ev.key(bucket_item(ev, i, 0), static_cast<int>(id - i * ntables));
}

// Steps 1 and 3: one block per tile of kThreads * kTileEvents events.
// Without kScatter the tile's per-bucket counts go to start[]; with it the
// tile reserves its ranges from cursor[] and writes its ids.
template <class Ev, bool kScatter>
__global__ void tile_kernel(Ev ev, int ntables, int64_t nvalid, uint64_t q,
                            uint32_t nbuckets, Scratch sc) {
  extern __shared__ uint32_t hist[];
  for (uint32_t b = threadIdx.x; b < nbuckets; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const int64_t first =
      blockIdx.x * static_cast<int64_t>(blockDim.x) * kTileEvents;
  for (int k = 0; k < kTileEvents; ++k) {
    const int64_t i = first + k * static_cast<int64_t>(blockDim.x)
                      + threadIdx.x;
    if (i >= nvalid) break;
    const auto x = ev.load(i);
    for (int t = 0; t < ntables; ++t) {
      const uint64_t key = ev.key(x, t);
      if (key != kNone) atomicAdd(&hist[bucket_of(key, q, nbuckets)], 1u);
    }
  }
  __syncthreads();
#pragma unroll 4
  for (uint32_t b = threadIdx.x; b < nbuckets; b += blockDim.x) {
    const uint32_t c = hist[b];
    if (c == 0) continue;
    if (kScatter) {
      hist[b] = atomicAdd(&sc.cursor[b], c);
    } else {
      atomicAdd(&sc.start[b], c);
    }
  }
  if (!kScatter) return;
  __syncthreads();
  for (int k = 0; k < kTileEvents; ++k) {
    const int64_t i = first + k * static_cast<int64_t>(blockDim.x)
                      + threadIdx.x;
    if (i >= nvalid) break;
    const auto x = ev.load(i);
    for (int t = 0; t < ntables; ++t) {
      const uint64_t key = ev.key(x, t);
      if (key == kNone) continue;
      const uint32_t pos = atomicAdd(&hist[bucket_of(key, q, nbuckets)], 1u);
      sc.ids[pos] = static_cast<uint32_t>(i * ntables + t);
    }
  }
}

// Step 2, one block of kScanThreads: start[0..nbuckets) holds the counts
// and becomes their exclusive prefix sum, start[nbuckets] the total;
// cursor[] starts equal to start[]. Each thread sums a run of buckets,
// the runs are scanned within warps by shuffles, then across warps.
constexpr int kScanThreads = 1024;
static_assert(kScanThreads == 32 * 32, "one warp scans the warp sums");

__global__ void scan_kernel(uint32_t* __restrict__ start,
                            uint32_t* __restrict__ cursor,
                            uint32_t nbuckets) {
  __shared__ uint32_t warp_sum[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t per = (nbuckets + kScanThreads - 1) / kScanThreads;
  const uint32_t lo = min(threadIdx.x * per, nbuckets);
  const uint32_t hi = min(lo + per, nbuckets);
  uint32_t sum = 0;
  for (uint32_t b = lo; b < hi; ++b) sum += start[b];
  uint32_t run = sum;  // inclusive within the warp
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, run, off);
    if (lane >= off) run += v;
  }
  if (lane == 31) warp_sum[warp] = run;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = warp_sum[lane];  // kScanThreads / 32 == 32 warps
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, w, off);
      if (lane >= off) w += v;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  run += (warp > 0 ? warp_sum[warp - 1] : 0) - sum;  // exclusive
  for (uint32_t b = lo; b < hi; ++b) {
    const uint32_t c = start[b];
    start[b] = run;
    cursor[b] = run;
    run += c;
  }
  if (threadIdx.x == kScanThreads - 1) start[nbuckets] = warp_sum[31];
}

// Step 4's map: keys, occurrences, lowest event; kSlots each.
struct Map {
  unsigned long long* key;
  uint32_t* occ;
  uint32_t* first;
  uint64_t q;           // as for bucket_of
  uint64_t scale;       // nbuckets * kSlots
  uint64_t base;        // this bucket * kSlots

  // Linear probing from the key's place in the bucket's counter range:
  // the slot order follows the address order, so a warp's 32 slots in the
  // commit touch neighbouring counters. The caller keeps the number of
  // keys below kSlots, so a free slot always exists.
  __device__ int slot_of(uint64_t key) const {
    return static_cast<int>(__umul64hi(key * q, scale) - base);
  }

  __device__ int find(uint64_t k) const {
    int s = slot_of(k);
    while (key[s] != k) s = (s + 1) & (kSlots - 1);
    return s;
  }
};

constexpr size_t kMapBytes = kSlots * (sizeof(unsigned long long)
                                       + 2 * sizeof(uint32_t));

// Step 4: one block of kMapThreads per bucket (grid = nbuckets), kMapBytes
// of dynamic shared memory.
template <class Ev, class Store>
__global__ void __launch_bounds__(kMapThreads)
bucket_kernel(Ev ev, int ntables, uint64_t q, bool narrow, Scratch sc,
              Store store, bool report) {
  extern __shared__ unsigned long long map_mem[];
  const Map map{map_mem, reinterpret_cast<uint32_t*>(map_mem + kSlots),
                reinterpret_cast<uint32_t*>(map_mem + kSlots) + kSlots, q,
                static_cast<uint64_t>(gridDim.x) * kSlots,
                static_cast<uint64_t>(blockIdx.x) * kSlots};
  __shared__ uint64_t stack_part[kMaxDepth + 2];
  __shared__ int stack_depth[kMaxDepth + 2];
  __shared__ int top;
  __shared__ int nkeys;
  __shared__ int any_sat;
  __shared__ volatile int overflow;

  const uint32_t lo = sc.start[blockIdx.x];
  const uint32_t hi = sc.start[blockIdx.x + 1];
  if (lo == hi) return;
  const int lane = threadIdx.x & 31;
  const uint32_t warp_base = lo + (threadIdx.x & ~31u);
  if (threadIdx.x == 0) {
    top = 1;
    stack_part[0] = 0;
    stack_depth[0] = 0;
  }
  for (;;) {
    __syncthreads();
    if (top == 0) break;
    const uint64_t part = stack_part[top - 1];
    const int depth = stack_depth[top - 1];
    __syncthreads();
    if (threadIdx.x == 0) {
      --top;
      nkeys = 0;
      any_sat = 0;
      overflow = 0;
    }
    for (int s = threadIdx.x; s < kSlots; s += kMapThreads) {
      map.key[s] = kEmpty;
      map.occ[s] = 0;
      map.first[s] = 0xFFFFFFFFu;
    }
    __syncthreads();

    // build: kUnroll ids a lane at once; equal counters of a warp step
    // meet in one insertion
    for (uint32_t base = warp_base; base < hi;
         base += kUnroll * kMapThreads) {
      unsigned long long key[kUnroll];
      uint32_t e[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t j = base + u * kMapThreads + lane;
        key[u] = kEmpty;
        e[u] = 0;
        if (j < hi) {
          key[u] = key_of(ev, sc.ids[j], ntables, &e[u]);
          if (!in_part(key[u], part, depth)) key[u] = kEmpty;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // counters of one bucket differ in their low 32 bits when it spans
        // at most 2^32 of them (narrow), and the 32-bit match is cheaper;
        // empty lanes are masked out of every group
        const unsigned peers =
            (narrow ? __match_any_sync(0xFFFFFFFFu,
                                       static_cast<uint32_t>(key[u]))
                    : __match_any_sync(0xFFFFFFFFu, key[u]))
            & __ballot_sync(0xFFFFFFFFu, key[u] != kEmpty);
        bool made = false;
        if (key[u] != kEmpty) {
          const uint32_t lowest = __reduce_min_sync(peers, e[u]);
          if (lane == __ffs(peers) - 1 && !overflow) {
            int s = map.slot_of(key[u]);
            for (;;) {
              const unsigned long long cur =
                  atomicCAS(&map.key[s], kEmpty, key[u]);
              if (cur == kEmpty || cur == key[u]) {
                made = cur == kEmpty;
                break;
              }
              s = (s + 1) & (kSlots - 1);
            }
            atomicAdd(&map.occ[s], static_cast<uint32_t>(__popc(peers)));
            atomicMin(&map.first[s], lowest);
          }
        }
        // one count of new keys a warp step: at most kMapThreads keys land
        // past kLoadLimit before every warp sees the overflow
        const unsigned fresh = __ballot_sync(0xFFFFFFFFu, made);
        if (lane == 0 && fresh != 0
            && atomicAdd(&nkeys, __popc(fresh)) + __popc(fresh)
                   > kLoadLimit) {
          overflow = 1;
        }
      }
    }
    __syncthreads();
    if (overflow) {
      // split this part in two by the next bit of the mix, depth first
      if (threadIdx.x == 0) {
        stack_part[top] = part << 1 | 1;
        stack_depth[top] = depth + 1;
        stack_part[top + 1] = part << 1;
        stack_depth[top + 1] = depth + 1;
        top += 2;
      }
      continue;
    }

    // commit: one read and at most one write of each counter; a thread's
    // reads are issued before any is used
    uint32_t old[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const unsigned long long key =
          map.key[threadIdx.x + k * kMapThreads];
      old[k] = key != kEmpty ? store.read(key) : 0;
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int s = threadIdx.x + k * kMapThreads;
      const unsigned long long key = map.key[s];
      if (key == kEmpty) continue;
      const uint32_t post = store.add(key, old[k], map.occ[s]);
      if (old[k] == 0) atomicOr(&sc.ev_word[map.first[s]], kNewBit);
      if (post == kMaxCount) {
        map.occ[s] = old[k] | kSatBit;
        any_sat = 1;
      } else {
        map.occ[s] = old[k];
      }
    }
    __syncthreads();
    if (!report || !any_sat) continue;
    // the bigcount fold: lane-events on counters now at 255
    for (uint32_t j = lo + threadIdx.x; j < hi; j += kMapThreads) {
      uint32_t e;
      const unsigned long long key = key_of(ev, sc.ids[j], ntables, &e);
      if (!in_part(key, part, depth)) continue;
      const uint32_t v = map.occ[map.find(key)];
      if (v & kSatBit) {
        atomicAdd(&sc.ev_word[e], 1u);
        atomicMin(&sc.min_old[e], v & kSatMask);
      }
    }
  }
}

// Step 5: one thread per event i < max(m_total, nvalid); hashes is read
// only with the report on.
__global__ void finalize_kernel(int64_t m_total, int64_t nvalid,
                                int ntables,
                                const uint32_t* __restrict__ ev_word,
                                const uint32_t* __restrict__ min_old,
                                bool* __restrict__ flags,
                                unsigned long long* __restrict__ n_new,
                                const uint64_t* __restrict__ hashes,
                                int64_t* __restrict__ cand_hash,
                                int32_t* __restrict__ cand_old,
                                unsigned int* __restrict__ n_cand) {
  const int64_t i = thread_index();
  const uint32_t w = i < nvalid ? ev_word[i] : 0;
  const bool fresh = (w & kNewBit) != 0;
  if (flags != nullptr && i < m_total) flags[i] = fresh;
  if (cand_hash != nullptr && i < nvalid
      && (w & kSatMask) == static_cast<uint32_t>(ntables)) {
    const unsigned int slot = atomicAdd(n_cand, 1u);
    cand_hash[slot] = static_cast<int64_t>(hashes[i]);
    cand_old[slot] = static_cast<int32_t>(min_old[i]);
  }
  // every thread of the block reaches this barrier
  const int count = __syncthreads_count(fresh);
  if (threadIdx.x == 0 && count > 0) {
    atomicAdd(n_new, static_cast<unsigned long long>(count));
  }
}

// All launches on stream s for events i < nvalid of ntables counters each
// in a flat table of `size` counters. flags [m_total] (nullable) gets the
// new flags, false from nvalid on; *n_new grows by the new events. With
// cand_hash non-null the bigcount report of the events, whose hashes are
// hashes [nvalid], goes to cand_hash/cand_old [nvalid], its length added
// to *n_cand (zeroed by the caller).
template <class Ev, class Store>
cudaError_t launch_store_update(const Ev& ev, int ntables, uint64_t size,
                                int64_t m_total, int64_t nvalid,
                                uint32_t nbuckets, const Scratch& sc,
                                const Store& store, bool* flags,
                                unsigned long long* n_new,
                                const uint64_t* hashes, int64_t* cand_hash,
                                int32_t* cand_old, unsigned int* n_cand,
                                cudaStream_t s) {
  if (size == 0 || nbuckets < 1 || nbuckets > kMaxBuckets || ntables < 1
      || nvalid < 0 || nvalid * ntables >= (int64_t{1} << 31)
      || (cand_hash != nullptr && hashes == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (nvalid == 0) {
    return flags != nullptr && m_total > 0
               ? cudaMemsetAsync(flags, 0, m_total, s) : cudaSuccess;
  }
  const bool report = cand_hash != nullptr;
  if ((err = cudaMemsetAsync(sc.start, 0, (nbuckets + 1) * sizeof(uint32_t),
                             s)) != cudaSuccess
      || (err = cudaMemsetAsync(sc.ev_word, 0, nvalid * sizeof(uint32_t), s))
             != cudaSuccess
      || (report && (err = cudaMemsetAsync(
                         sc.min_old, 0xFF, nvalid * sizeof(uint32_t), s))
                        != cudaSuccess)) {
    return err;
  }
  const uint64_t q = ~0ULL / size;
  const int tile_smem = static_cast<int>(nbuckets * sizeof(uint32_t));
  if ((err = cudaFuncSetAttribute(tile_kernel<Ev, false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  tile_smem)) != cudaSuccess
      || (err = cudaFuncSetAttribute(
              tile_kernel<Ev, true>,
              cudaFuncAttributeMaxDynamicSharedMemorySize, tile_smem))
             != cudaSuccess
      || (err = cudaFuncSetAttribute(
              bucket_kernel<Ev, Store>,
              cudaFuncAttributeMaxDynamicSharedMemorySize,
              static_cast<int>(kMapBytes))) != cudaSuccess) {
    return err;
  }
  const int64_t per_tile = static_cast<int64_t>(kThreads) * kTileEvents;
  const unsigned tiles = static_cast<unsigned>((nvalid + per_tile - 1)
                                               / per_tile);
  tile_kernel<Ev, false><<<tiles, kThreads, tile_smem, s>>>(
      ev, ntables, nvalid, q, nbuckets, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_kernel<<<1, kScanThreads, 0, s>>>(sc.start, sc.cursor, nbuckets);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tile_kernel<Ev, true><<<tiles, kThreads, tile_smem, s>>>(
      ev, ntables, nvalid, q, nbuckets, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const bool narrow = size / nbuckets + 2 <= (uint64_t{1} << 32);
  bucket_kernel<Ev, Store><<<nbuckets, kMapThreads, kMapBytes, s>>>(
      ev, ntables, q, narrow, sc, store, report);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t span = m_total > nvalid ? m_total : nvalid;
  finalize_kernel<<<grid_for(span), kThreads, 0, s>>>(
      m_total, nvalid, ntables, sc.ev_word, sc.min_old, flags, n_new,
      hashes, cand_hash, cand_old, n_cand);
  return cudaGetLastError();
}

// launch_store_update on u8 counters (kernels 1, A and D).
template <class Ev>
cudaError_t launch_update(const Ev& ev, int ntables, uint64_t size,
                          int64_t m_total, int64_t nvalid, uint32_t nbuckets,
                          const Scratch& sc, uint8_t* table, bool* flags,
                          unsigned long long* n_new, const uint64_t* hashes,
                          int64_t* cand_hash, int32_t* cand_old,
                          unsigned int* n_cand, cudaStream_t s) {
  return launch_store_update(ev, ntables, size, m_total, nvalid, nbuckets,
                             sc, CounterStore{table}, flags, n_new, hashes,
                             cand_hash, cand_old, n_cand, s);
}

}  // namespace
}  // namespace khmer_bucket
