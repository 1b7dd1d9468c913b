// The groups of kernels F and G (csrc/diginorm_scan.cu, csrc/trim_scan.cu):
// one block walks a window's bundles in stream order, taking a run of
// them at a time on a shared-memory OVERLAY of their counters, so that the
// run's counters are loaded in one round of independent loads and every
// later read and add of the run happens in shared memory.
//
// The kernel compacts the bundles it must visit a tile of kBlock bundles
// at a time into a Tile (compact_tile): each bundle's window counts and
// its events' prefix sum, clamped at group_events + 1. A group is then a
// run of the tile's list whose events x T items fit kGroupItems, half of
// the overlay's kOverlay slots, and takes these steps:
//   a. (gather_group) all threads hash all of its events, each loading
//      its window's codes at once, and keep the counter of each item
//      (event, table); each item finds its counter's slot or claims a free
//      one (a read, then a 32-bit CAS of its own index: a slot's counter
//      is its claimer's), and keeps the slot's 2-byte index, so later
//      steps never probe;
//   b. (gather_group) each claimer loads its counter from the tables, all
//      together: one round of independent global loads for the group;
//   c. the kernel's own step for each bundle in stream order, on the
//      overlay alone: read_bundle reads each item's value through its slot
//      while adding the bundle's hits and lowest event per slot (shared
//      atomics the read does not see); add_bundle then has the lowest
//      event on each slot clear the slot's hits and, if the bundle adds,
//      set v = min(v + hits, 255), mark it dirty and credit its event new
//      if v was 0 (reference ByteStorage::add, storage.hh:571-624);
//   d. (store_group) each claimer of a dirty slot stores its counter once
//      to the tables, a plain byte store, and frees the slot.
// One block owns the tables for the launch; a group's reads all come
// before its writes and every later value comes from the overlay, so the
// groups compose into the sequential scan exactly.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "byte_common.cuh"
#include "twobit_common.cuh"

namespace khmer_groups {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;
using khmer_cuda::kMaxCount;

// core/sketch_kernels.py DIGI_SCAN_THREADS, DIGI_OVERLAY_SLOTS and
// DIGI_GROUP_ITEMS
constexpr int kBlock = 512;
constexpr int kWarps = kBlock / 32;
constexpr int kOverlayBits = 13;
constexpr int kOverlay = 1 << kOverlayBits;
constexpr int kGroupItems = kOverlay / 2;
// counters a thread loads at once: a full group's in one round
constexpr int kLoadBatch = kGroupItems / kBlock;

constexpr uint32_t kNoEvent = ~0u;
constexpr uint16_t kDirty = 0x100;  // an overlay value the group changed
constexpr int kOwner = 0x8000;      // on the item that claimed its slot
constexpr int kSlotMask = kOverlay - 1;
constexpr uint64_t kNoKey = ~0ULL;
constexpr uint64_t kFib = 0x9E3779B97F4A7C15ULL;  // 2^64 / golden ratio
constexpr unsigned kFull = 0xffffffffu;

struct Group {
  uint32_t* claim;   // kOverlay: the claiming item + 1 (0: free)
  uint64_t* keys;    // kGroupItems: the counter of each item
  uint32_t* hits;    // kOverlay; 0 outside a bundle's add
  uint32_t* first;   // kOverlay; kNoEvent outside a bundle's add
  uint16_t* values;  // kOverlay: the counter, kDirty once changed
  uint16_t* slots;   // kGroupItems: slot of item e * T + t, with kOwner
                     // on the item that took it
  uint8_t* fresh;    // the group's events: new k-mer
};

struct Tile {
  int2* reads;      // per bundle listed: windows of read 0 and of read 1
  int32_t* list;    // per bundle listed: its bundle - tile base
  int32_t* starts;  // kBlock + 1: events before each, clamped
};

__host__ __device__ inline int64_t group_bytes(int group_events) {
  return int64_t{4} * kOverlay + int64_t{8} * kGroupItems
         + int64_t{4} * kOverlay * 2 + int64_t{2} * kOverlay
         + int64_t{2} * kGroupItems + group_events;
}

constexpr int64_t kTileBytes =
    int64_t{8} * kBlock + int64_t{4} * kBlock + int64_t{4} * (kBlock + 1);

__device__ __forceinline__ Group carve_group(unsigned char* base,
                                             int group_events) {
  Group g;
  g.claim = reinterpret_cast<uint32_t*>(base);
  base += sizeof(uint32_t) * kOverlay;
  g.keys = reinterpret_cast<uint64_t*>(base);
  base += sizeof(uint64_t) * kGroupItems;
  g.hits = reinterpret_cast<uint32_t*>(base);
  base += sizeof(uint32_t) * kOverlay;
  g.first = reinterpret_cast<uint32_t*>(base);
  base += sizeof(uint32_t) * kOverlay;
  g.values = reinterpret_cast<uint16_t*>(base);
  base += sizeof(uint16_t) * kOverlay;
  g.slots = reinterpret_cast<uint16_t*>(base);
  base += sizeof(uint16_t) * kGroupItems;
  g.fresh = base;
  return g;
}

__device__ __forceinline__ Tile carve_tile(unsigned char* base) {
  Tile tl;
  tl.reads = reinterpret_cast<int2*>(base);
  base += sizeof(int2) * kBlock;
  tl.list = reinterpret_cast<int32_t*>(base);
  base += sizeof(int32_t) * kBlock;
  tl.starts = reinterpret_cast<int32_t*>(base);
  return tl;
}

// Empty overlay: the state it keeps between groups.
__device__ inline void clear_group(const Group& g, int group_events) {
  for (int i = threadIdx.x; i < kOverlay; i += kBlock) {
    g.claim[i] = 0;
    g.hits[i] = 0;
    g.first[i] = kNoEvent;
  }
  for (int i = threadIdx.x; i < group_events; i += kBlock) g.fresh[i] = 0;
}

// Item i of a group is (event i / T, table i % T); i < kGroupItems, and
// for such i, (i * recip) >> 20 with recip = ceil(2^20 / T) is i / T.
struct Items {
  int T;
  uint32_t recip;
  __device__ __forceinline__ explicit Items(int ntables)
      : T(ntables), recip(((1u << 20) + ntables - 1) / ntables) {}
  __device__ __forceinline__ int event(int i) const {
    return static_cast<int>((static_cast<uint32_t>(i) * recip) >> 20);
  }
};

// List this thread's bundle b of the tile at `base` if `take`, with its
// window counts nv (of which at most W each count), in bundle order, and
// the prefix sum of the listed bundles' events, each clamped at
// group_events + 1 (more than that runs alone). Two barriers; returns how
// many the tile listed. warp_total and warp_events: kWarps ints of
// shared memory.
__device__ inline int compact_tile(const Tile& tl, int64_t b, int64_t base,
                                   bool take, int2 nv, int W,
                                   int group_events, int* warp_total,
                                   int* warp_events) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long events =
      static_cast<long long>(min(nv.x, W)) + min(nv.y, W);
  const int nev = events > group_events ? group_events + 1
                                        : static_cast<int>(events);
  const unsigned ballot = __ballot_sync(kFull, take);
  int incl = nev;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) {
    warp_total[warp] = __popc(ballot);
    warp_events[warp] = incl;
  }
  __syncthreads();
  int offset = 0;
  int count = 0;
  int ev_off = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      offset += warp_total[w];
      ev_off += warp_events[w];
    }
    count += warp_total[w];
  }
  if (take) {
    const int pos = offset + __popc(ballot & ((1u << lane) - 1));
    tl.list[pos] = static_cast<int32_t>(b - base);
    tl.reads[pos] = nv;
    tl.starts[pos] = ev_off + incl - nev;
  }
  if (threadIdx.x == kBlock - 1) tl.starts[count] = ev_off + incl;
  __syncthreads();
  return count;
}

// Listed bundles [c0, c1) of the tile at `base` as one group: steps a and
// b above, ending behind a barrier. Event j of a bundle with read-0
// windows nw0 = min(reads.x, W) is window j of read 0 if j < nw0, else
// window j - nw0 of read 1 (rows 2 b and 2 b + 1 of codes [2B, L]).
__device__ inline void gather_group(const Group& g, const Tile& tl, int c0,
                                    int c1, int64_t base,
                                    const uint8_t* codes, int L, int k,
                                    int W, const ByteLayout& layout,
                                    const uint8_t* flat) {
  const int tid = threadIdx.x;
  const int T = layout.ntables;
  const int s0 = tl.starts[c0];
  const int gnev = tl.starts[c1] - s0;
  const int items = gnev * T;

  // a. hash every event of the group (its bundle is the last whose events
  //    start at or before it), and keep each item's counter
  for (int e = tid; e < gnev; e += kBlock) {
    int lo = c0;
    int hi = c1 - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (tl.starts[mid] - s0 <= e) lo = mid; else hi = mid - 1;
    }
    const int j = e - (tl.starts[lo] - s0);
    const int nw0 = min(tl.reads[lo].x, W);
    const int r = j >= nw0;
    const int64_t row = 2 * (base + tl.list[lo]) + r;
    const uint64_t h = khmer_twobit::canonical_loads_first(
        codes + row * L + (r ? j - nw0 : j), k);
    for (int t = 0; t < T; ++t) {
      g.keys[e * T + t] = counter_index(layout, h, t);
    }
  }
  __syncthreads();
  //    each item finds its counter's slot, or claims a free one (a read,
  //    then a 32-bit CAS of its index + 1: the claimer owns the slot, and
  //    the slot's counter is the claimer's)
  for (int i = tid; i < items; i += kBlock) {
    const uint64_t key = g.keys[i];
    uint32_t slot =
        static_cast<uint32_t>((key * kFib) >> (64 - kOverlayBits));
    uint32_t own = 0;
    for (;;) {
      uint32_t prev = g.claim[slot];
      if (prev == 0) prev = atomicCAS(&g.claim[slot], 0u, i + 1u);
      if (prev == 0) {
        own = kOwner;
        break;
      }
      if (g.keys[prev - 1] == key) break;
      slot = (slot + 1) & kSlotMask;
    }
    g.slots[i] = static_cast<uint16_t>(slot | own);
  }
  __syncthreads();

  // b. every claimed counter loaded at once
  for (int i0 = tid; i0 < items; i0 += kBlock * kLoadBatch) {
    uint64_t key[kLoadBatch];
    uint8_t v[kLoadBatch];
#pragma unroll
    for (int q = 0; q < kLoadBatch; ++q) {
      const int i = i0 + q * kBlock;
      key[q] = i < items && (g.slots[i] & kOwner) ? g.keys[i] : kNoKey;
    }
#pragma unroll
    for (int q = 0; q < kLoadBatch; ++q) {
      v[q] = key[q] != kNoKey ? flat[key[q]] : 0;
    }
#pragma unroll
    for (int q = 0; q < kLoadBatch; ++q) {
      if (key[q] != kNoKey) {
        g.values[g.slots[i0 + q * kBlock] & kSlotMask] = v[q];
      }
    }
  }
  __syncthreads();
}

// Step c's read of one bundle whose items start at `sl`: f(e, m) for each
// of its events e < nev (this thread's share) with m its count, the
// minimum over the T tables in the overlay, while the bundle's hits and
// lowest event per slot are recorded for add_bundle (the read does not
// see them).
template <class F>
__device__ __forceinline__ void read_bundle(const Group& g,
                                            const uint16_t* sl, int nev,
                                            int T, F f) {
  for (int e = threadIdx.x; e < nev; e += kBlock) {
    int m = kMaxCount;
    for (int t = 0; t < T; ++t) {
      const int slot = sl[e * T + t] & kSlotMask;
      m = min(m, static_cast<int>(g.values[slot] & 0xff));
      atomicAdd(&g.hits[slot], 1u);
      atomicMin(&g.first[slot], static_cast<uint32_t>(e));
    }
    f(e, m);
  }
}

// Step c's add, after the bundle's decision (behind the barrier that
// made it): each slot's lowest event of the bundle clears the slot's hits
// and, if `adds`, adds them; clearing `first` cannot make another item of
// the slot look like its lowest. The bundle's events start at event e0 of
// the group. Ends behind a barrier.
__device__ __forceinline__ void add_bundle(const Group& g,
                                           const uint16_t* sl, int nev,
                                           int e0, const Items& it,
                                           bool adds) {
  for (int i = threadIdx.x; i < nev * it.T; i += kBlock) {
    const int slot = sl[i] & kSlotMask;
    const uint32_t e = static_cast<uint32_t>(it.event(i));
    if (g.first[slot] != e) continue;
    const int hits = static_cast<int>(g.hits[slot]);
    g.hits[slot] = 0;
    g.first[slot] = kNoEvent;
    if (!adds) continue;
    const int v = g.values[slot] & 0xff;
    if (v == 0) g.fresh[e0 + e] = 1;
    g.values[slot] =
        static_cast<uint16_t>(kDirty | min(v + hits, kMaxCount));
  }
  __syncthreads();
}

// Step d for the group of listed bundles [c0, c1): write back what
// changed, count the new k-mers into my_new, empty the overlay; behind a
// barrier.
__device__ inline void store_group(const Group& g, const Tile& tl, int c0,
                                   int c1, int T, uint8_t* flat,
                                   unsigned long long& my_new) {
  const int gnev = tl.starts[c1] - tl.starts[c0];
  for (int i = threadIdx.x; i < gnev * T; i += kBlock) {
    const int sl = g.slots[i];
    if (!(sl & kOwner)) continue;
    const int slot = sl & kSlotMask;
    const uint16_t v = g.values[slot];
    if (v & kDirty) flat[g.keys[i]] = static_cast<uint8_t>(v);
    g.claim[slot] = 0;
  }
  for (int e = threadIdx.x; e < gnev; e += kBlock) {
    my_new += g.fresh[e];
    g.fresh[e] = 0;
  }
  __syncthreads();
}

}  // namespace khmer_groups
