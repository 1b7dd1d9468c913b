// Kernel F: the diginorm keep/consume scan of one window, in stream order,
// updating the u8 tables in place.
//
// Replaces khmer_tpu/core/diginorm_scan.py:127 (make_diginorm_window), a
// lax.scan on the TPU over u32 copies of the tables; its plain PyTorch
// version is khmer_tpu_torch/core/sketch_kernels.py:diginorm_window_plain.
//
// Per bundle b of the window (reads 2b and 2b + 1 of a [2B, L] code
// matrix) that kernel E did not reject, in stream order:
//   1. hash its valid windows and gather their counts, the minimum over
//      the T tables, from the tables as the earlier bundles left them;
//   2. test median_at_least(C) per present read (kernel E's test); the
//      bundle is kept iff some present read fails it;
//   3. if kept, add +1 to the counter of every valid window in every
//      table, saturating at 255, and credit n_unique: a k-mer event is new
//      iff some counter of it was 0 when the event came, in stream order
//      (reference ByteStorage::add, storage.hh:571-624).
// Rejected bundles get keep = 0. The scan ignores the bigcount map, as the
// JAX scan does.
//
// What bounds it: latency. The candidates are sequential: each one's test
// reads counters the earlier kept ones may have raised. Taken one at a
// time, a candidate is a chain of dependent round trips to device memory
// (its codes, its counters, the counters again for the add), each behind a
// block-wide barrier. Its byte bound (the codes once, each counter read
// once and each changed counter written once) is far below that chain.
// One block also means few warps to hide each step's latency, and one
// SM's rate of random global loads and stores.
//
// Design. One block walks the whole window: there is no host round trip
// inside a window, and the host reads the keep flags once per window. The
// block compacts kernel E's flags a tile of kBlock bundles at a time into
// a candidate list in shared memory, with each candidate's window counts
// and its events' prefix sum. It then takes the list in GROUPS: the next
// run of candidates, in order, whose events x T items fit kGroupItems,
// half of a shared-memory OVERLAY of kOverlay slots. For a group:
//   a. all threads hash all of its events, each loading its window's
//      codes at once, and keep the counter of each item (event, table);
//      each item then finds its counter's slot or claims a free one (a
//      read, then a 32-bit CAS of its own index: a slot's counter is its
//      claimer's), and keeps the slot's 2-byte index, so later steps
//      never probe;
//   b. each claimer loads its counter from the tables, all together: one
//      round of independent global loads for the group;
//   c. the candidates run in stream order against the overlay alone, no
//      global load or store, two barriers each: the test reads each
//      item's value through its slot while adding the bundle's hits and
//      lowest event per slot (shared atomics, which the test does not
//      read); then the lowest event on each slot clears the slot's hits
//      and, if the bundle is kept, sets v = min(v + hits, 255), marks it
//      dirty and credits its event new if v was 0 (the reference rule);
//   d. each claimer of a dirty slot stores its counter once to the
//      tables, a plain byte store, and frees the slot.
// One block owns the tables for the launch; a group's reads all come
// before its writes and every later value comes from the overlay, so the
// groups compose into the sequential scan exactly.
//
// A bundle whose events x T alone exceed kGroupItems (rows of thousands of
// codes, or many tables) is a group of its own, scanned as one: its
// hashes in shared memory (or, for rows too long for that, in a device
// buffer of 16 B a window), its counts gathered from the tables, and its
// adds in sub-chunks of `sub` events through a map of kMap slots (counter
// -> hits, lowest event), each entry reading its counter as the sub-chunk
// finds it and writing it once: the sub-chunks compose into the
// sequential rule as the groups do. That layout shares the shared memory
// with the overlay's (a union), each cleared when the scan switches to it.
// The tables are read and written only with plain loads and stores,
// ordered by __syncthreads() within the one block (no read-only cache
// path). No u32 copy of the tables and no scratch the size of the tables:
// the shared memory is sized by the window's row length and the number of
// tables (core/sketch_kernels.py diginorm_plan).

#include "byte_common.cuh"
#include "twobit_common.cuh"

namespace khmer_digi_scan {
namespace {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;
using khmer_cuda::kMaxCount;

// core/sketch_kernels.py DIGI_SCAN_THREADS, DIGI_OVERLAY_SLOTS,
// DIGI_GROUP_ITEMS and DIGI_MAP_SLOTS
constexpr int kBlock = 512;
constexpr int kWarps = kBlock / 32;
constexpr int kOverlayBits = 13;
constexpr int kOverlay = 1 << kOverlayBits;
constexpr int kGroupItems = kOverlay / 2;
constexpr int kMapBits = 12;
constexpr int kMap = 1 << kMapBits;
constexpr int kMapPerThread = kMap / kBlock;
// counters a thread loads at once: a full group's in one round
constexpr int kLoadBatch = kGroupItems / kBlock;

constexpr unsigned long long kEmpty = ~0ULL;
constexpr uint32_t kNoEvent = ~0u;
constexpr uint16_t kDirty = 0x100;  // an overlay value the group changed
constexpr int kOwner = 0x8000;      // on the item that claimed its slot
constexpr int kSlotMask = kOverlay - 1;
constexpr uint64_t kNoKey = ~0ULL;
constexpr uint64_t kFib = 0x9E3779B97F4A7C15ULL;  // 2^64 / golden ratio
constexpr unsigned kFull = 0xffffffffu;

// splitmix64 finalizer: spreads counters over the slots.
__device__ __forceinline__ uint64_t mix(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

// The dynamic shared memory, in the order of diginorm_plan: a union of
// the group's overlay and the lone bundle's map, rounded up to 16 bytes,
// then the tile's candidate list.
struct Group {
  uint32_t* claim;           // kOverlay: the claiming item + 1 (0: free)
  uint64_t* keys;            // kGroupItems: the counter of each item
  uint32_t* hits;            // kOverlay; 0 outside a bundle's add
  uint32_t* first;           // kOverlay; kNoEvent outside a bundle's add
  uint16_t* values;          // kOverlay: the counter, kDirty once changed
  uint16_t* slots;           // kGroupItems: slot of item e * T + t,
                             // with kOwner on the item that took it
  uint8_t* fresh;            // the group's events: new k-mer
};

struct Alone {
  unsigned long long* keys;  // kMap
  uint64_t* hashes;          // the bundle's events (or the device buffer)
  uint32_t* hits;            // kMap
  uint32_t* first;           // kMap
  uint8_t* fresh;            // a sub-chunk's events
};

struct Tile {
  int2* reads;     // per candidate: windows of read 0 and of read 1
  int32_t* list;   // per candidate: its bundle - tile base
  int32_t* starts; // kBlock + 1: events before each candidate, clamped
};

__host__ __device__ inline int64_t group_bytes(int group_events) {
  return int64_t{4} * kOverlay + int64_t{8} * kGroupItems
         + int64_t{4} * kOverlay * 2 + int64_t{2} * kOverlay
         + int64_t{2} * kGroupItems + group_events;
}

__host__ __device__ inline int64_t alone_bytes(int64_t smem_hash_words,
                                               int sub) {
  return int64_t{8} * kMap + int64_t{8} * smem_hash_words
         + int64_t{4} * kMap * 2 + sub;
}

__host__ __device__ inline int64_t union_bytes(int group_events,
                                               int64_t smem_hash_words,
                                               int sub) {
  const int64_t g = group_bytes(group_events);
  const int64_t a = alone_bytes(smem_hash_words, sub);
  return ((g > a ? g : a) + 15) & ~int64_t{15};
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

__device__ __forceinline__ Alone carve_alone(unsigned char* base,
                                             int64_t words,
                                             uint64_t* hash_buf) {
  Alone a;
  a.keys = reinterpret_cast<unsigned long long*>(base);
  base += sizeof(unsigned long long) * kMap;
  if (hash_buf != nullptr) {
    a.hashes = hash_buf;
  } else {
    a.hashes = reinterpret_cast<uint64_t*>(base);
    base += sizeof(uint64_t) * words;
  }
  a.hits = reinterpret_cast<uint32_t*>(base);
  base += sizeof(uint32_t) * kMap;
  a.first = reinterpret_cast<uint32_t*>(base);
  base += sizeof(uint32_t) * kMap;
  a.fresh = base;
  return a;
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

// Empty overlay or map: the state each layout keeps between its uses.
__device__ void clear_group(const Group& g, int group_events) {
  for (int i = threadIdx.x; i < kOverlay; i += kBlock) {
    g.claim[i] = 0;
    g.hits[i] = 0;
    g.first[i] = kNoEvent;
  }
  for (int i = threadIdx.x; i < group_events; i += kBlock) g.fresh[i] = 0;
}

__device__ void clear_alone(const Alone& a, int sub) {
  for (int i = threadIdx.x; i < kMap; i += kBlock) {
    a.keys[i] = kEmpty;
    a.hits[i] = 0;
    a.first[i] = kNoEvent;
  }
  for (int i = threadIdx.x; i < sub; i += kBlock) a.fresh[i] = 0;
}

// The per-read counts at or above C, three bundles' worth in rotation:
// ge[turn] is counted for this bundle, and ge[turn + 1], last read two
// bundles ago, is cleared for the next one before this one's barrier,
// which the next bundle's counting comes after.
struct Counts {
  int (*ge)[2];
  int turn;
};

__device__ __forceinline__ void open_bundle(Counts& n) {
  if (threadIdx.x == 0) {
    const int next = n.turn == 2 ? 0 : n.turn + 1;
    n.ge[next][0] = 0;
    n.ge[next][1] = 0;
  }
}

// Sum this bundle's counts over the block (one barrier) and decide: kept
// iff some present read fails median_at_least(C); an absent read passes.
__device__ __forceinline__ bool decide(Counts& n, int c0, int c1, int2 nv,
                                       int64_t bundle, uint8_t* keep) {
  c0 = __reduce_add_sync(kFull, c0);
  c1 = __reduce_add_sync(kFull, c1);
  if (threadIdx.x % 32 == 0 && (c0 | c1)) {
    atomicAdd(&n.ge[n.turn][0], c0);
    atomicAdd(&n.ge[n.turn][1], c1);
  }
  __syncthreads();
  const bool ok0 = nv.x == 0 || n.ge[n.turn][0] >= (nv.x + 1) / 2;
  const bool ok1 = nv.y == 0 || n.ge[n.turn][1] >= (nv.y + 1) / 2;
  n.turn = n.turn == 2 ? 0 : n.turn + 1;
  const bool kept = !(ok0 && ok1);
  if (threadIdx.x == 0) keep[bundle] = kept;
  return kept;
}

// Item i of a group is (event i / T, table i % T); i < kGroupItems, and
// for such i, (i * recip) >> 20 with recip = ceil(2^20 / T) is i / T.
struct Items {
  int T;
  uint32_t recip;
  __device__ __forceinline__ int event(int i) const {
    return static_cast<int>((static_cast<uint32_t>(i) * recip) >> 20);
  }
};

// Candidates [c0, c1) of the tile as one group (steps a-d above). Leaves
// the overlay empty, behind a barrier.
__device__ void group_pass(const Group& g, const Tile& tl, int c0, int c1,
                           int64_t base, const uint8_t* codes, int L, int k,
                           int W, int cutoff, const ByteLayout& layout,
                           uint8_t* flat, uint8_t* keep, Counts& n,
                           unsigned long long& my_new) {
  const int tid = threadIdx.x;
  const int T = layout.ntables;
  const Items it{T, ((1u << 20) + T - 1) / T};
  const int s0 = tl.starts[c0];
  const int gnev = tl.starts[c1] - s0;
  const int items = gnev * T;

  // a. hash every event of the group (its candidate is the last whose
  //    events start at or before it), and keep each item's counter
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

  // c. the candidates in stream order, on the overlay alone
  for (int c = c0; c < c1; ++c) {
    const int2 nv = tl.reads[c];
    const int nw0 = min(nv.x, W);
    const int nev = nw0 + min(nv.y, W);
    const int e0 = tl.starts[c] - s0;
    const uint16_t* sl = g.slots + e0 * T;
    const int64_t bundle = base + tl.list[c];
    open_bundle(n);
    // the test, and the bundle's hits and lowest events per slot should
    // it be kept (they do not touch the values the test reads)
    int n0 = 0;
    int n1 = 0;
    for (int e = tid; e < nev; e += kBlock) {
      int m = kMaxCount;
      for (int t = 0; t < T; ++t) {
        const int slot = sl[e * T + t] & kSlotMask;
        m = min(m, static_cast<int>(g.values[slot] & 0xff));
        atomicAdd(&g.hits[slot], 1u);
        atomicMin(&g.first[slot], static_cast<uint32_t>(e));
      }
      if (m >= cutoff) {
        if (e >= nw0) ++n1; else ++n0;
      }
    }
    const bool kept = decide(n, n0, n1, nv, bundle, keep);
    // each slot's lowest event of the bundle clears the slot's hits and,
    // if the bundle is kept, adds them; clearing `first` cannot make
    // another item of the slot look like its lowest
    for (int i = tid; i < nev * T; i += kBlock) {
      const int slot = sl[i] & kSlotMask;
      const uint32_t e = static_cast<uint32_t>(it.event(i));
      if (g.first[slot] != e) continue;
      const int hits = static_cast<int>(g.hits[slot]);
      g.hits[slot] = 0;
      g.first[slot] = kNoEvent;
      if (!kept) continue;
      const int v = g.values[slot] & 0xff;
      if (v == 0) g.fresh[e0 + e] = 1;
      g.values[slot] =
          static_cast<uint16_t>(kDirty | min(v + hits, kMaxCount));
    }
    __syncthreads();
  }

  // d. write back what changed, empty the overlay
  for (int i = tid; i < items; i += kBlock) {
    const int sl = g.slots[i];
    if (!(sl & kOwner)) continue;
    const int slot = sl & kSlotMask;
    const uint16_t v = g.values[slot];
    if (v & kDirty) flat[g.keys[i]] = static_cast<uint8_t>(v);
    g.claim[slot] = 0;
  }
  for (int e = tid; e < gnev; e += kBlock) {
    my_new += g.fresh[e];
    g.fresh[e] = 0;
  }
  __syncthreads();
}

// Record one hit of `key` by sub-chunk event `e`. The map holds at most
// sub * ntables <= kMap / 2 keys (diginorm_plan), so it never fills.
__device__ __forceinline__ void map_add(const Alone& a, uint64_t key,
                                        uint32_t e) {
  uint32_t slot = static_cast<uint32_t>(mix(key) >> (64 - kMapBits));
  for (;;) {
    const unsigned long long prev = atomicCAS(&a.keys[slot], kEmpty, key);
    if (prev == kEmpty || prev == key) break;
    slot = (slot + 1) & (kMap - 1);
  }
  atomicAdd(&a.hits[slot], 1u);
  atomicMin(&a.first[slot], e);
}

// Commit the map: each counter read once and written once, its lowest
// event marked new where the counter was 0; the map left empty. The
// thread's kMapPerThread slots load together, then their counters.
__device__ __forceinline__ void map_commit(const Alone& a, uint8_t* flat) {
  unsigned long long key[kMapPerThread];
  int cur[kMapPerThread];
#pragma unroll
  for (int i = 0; i < kMapPerThread; ++i) {
    key[i] = a.keys[threadIdx.x + i * kBlock];
  }
#pragma unroll
  for (int i = 0; i < kMapPerThread; ++i) {
    cur[i] = key[i] != kEmpty ? static_cast<int>(flat[key[i]]) : 0;
  }
#pragma unroll
  for (int i = 0; i < kMapPerThread; ++i) {
    if (key[i] == kEmpty) continue;
    const int slot = threadIdx.x + i * kBlock;
    if (cur[i] == 0) a.fresh[a.first[slot]] = 1;
    flat[key[i]] = static_cast<uint8_t>(
        min(cur[i] + static_cast<int>(a.hits[slot]), kMaxCount));
    a.keys[slot] = kEmpty;
    a.hits[slot] = 0;
    a.first[slot] = kNoEvent;
  }
}

// One bundle too large for the overlay, as a group of its own: gather
// from the tables, test, and add in sub-chunks through the map.
__device__ void alone_pass(const Alone& a, int64_t bundle, int2 nv,
                           const uint8_t* codes, int L, int k, int W,
                           int cutoff, int sub, const ByteLayout& layout,
                           uint8_t* flat, uint8_t* keep, Counts& n,
                           unsigned long long& my_new) {
  const int tid = threadIdx.x;
  const int nw0 = min(nv.x, W);
  const int nev = nw0 + min(nv.y, W);
  open_bundle(n);
  int n0 = 0;
  int n1 = 0;
  for (int e = tid; e < nev; e += kBlock) {
    const int r = e >= nw0;
    const int j = r ? e - nw0 : e;
    const uint64_t h = khmer_twobit::canonical(
        codes + (2 * bundle + r) * L + j, k);
    a.hashes[e] = h;
    int m = kMaxCount;
    for (int t = 0; t < layout.ntables; ++t) {
      m = min(m, static_cast<int>(flat[counter_index(layout, h, t)]));
    }
    if (m >= cutoff) {
      if (r) ++n1; else ++n0;
    }
  }
  if (!decide(n, n0, n1, nv, bundle, keep)) return;
  for (int s0 = 0; s0 < nev; s0 += sub) {
    const int cnt = min(sub, nev - s0);
    for (int e = tid; e < cnt; e += kBlock) {
      const uint64_t h = a.hashes[s0 + e];
      for (int t = 0; t < layout.ntables; ++t) {
        map_add(a, counter_index(layout, h, t), static_cast<uint32_t>(e));
      }
    }
    __syncthreads();
    map_commit(a, flat);
    __syncthreads();
    for (int e = tid; e < cnt; e += kBlock) {
      my_new += a.fresh[e];
      a.fresh[e] = 0;
    }
  }
}

__global__ void __launch_bounds__(kBlock)
scan_kernel(const uint8_t* __restrict__ codes,
            const int32_t* __restrict__ lengths,
            const uint8_t* __restrict__ reject, int64_t nbundles, int L,
            int k, int cutoff, int sub,
            const __grid_constant__ ByteLayout layout, uint8_t* flat,
            uint64_t* hash_buf, uint8_t* __restrict__ keep,
            unsigned long long* __restrict__ n_unique,
            unsigned long long* __restrict__ n_cand,
            unsigned long long* __restrict__ n_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = L - k + 1;
  const int group_events = kGroupItems / layout.ntables;
  const int64_t words = int64_t{2} * W;
  const Group g = carve_group(smem_raw, group_events);
  const Alone a = carve_alone(smem_raw, words, hash_buf);
  const Tile tl = carve_tile(
      smem_raw + union_bytes(group_events, hash_buf ? 0 : words, sub));
  __shared__ int ge[3][2];
  __shared__ int warp_total[kWarps];
  __shared__ int warp_events[kWarps];
  __shared__ unsigned long long warp_new[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  clear_group(g, group_events);
  if (tid < 6) ge[tid / 2][tid % 2] = 0;
  Counts counts{ge, 0};
  bool alone_layout = false;  // which layout the union holds, cleared
  unsigned long long my_new = 0;
  unsigned long long cand_total = 0;   // thread 0's count of candidates
  unsigned long long group_total = 0;  // and of groups
  __syncthreads();

  for (int64_t base = 0; base < nbundles; base += kBlock) {
    // compact this tile's candidates into the list, in bundle order, with
    // their window counts and the prefix sum of their events, each
    // clamped at group_events + 1 (more than that runs alone)
    const int64_t b = base + tid;
    const bool cand = b < nbundles && !reject[b];
    if (b < nbundles && !cand) keep[b] = 0;
    int2 nv = make_int2(0, 0);
    if (cand) {
      nv.x = khmer_twobit::n_windows(lengths[2 * b], k);
      nv.y = khmer_twobit::n_windows(lengths[2 * b + 1], k);
    }
    const long long events =
        static_cast<long long>(min(nv.x, W)) + min(nv.y, W);
    const int nev = events > group_events ? group_events + 1
                                          : static_cast<int>(events);
    const unsigned ballot = __ballot_sync(kFull, cand);
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
    int ncand = 0;
    int ev_off = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) {
        offset += warp_total[w];
        ev_off += warp_events[w];
      }
      ncand += warp_total[w];
    }
    if (cand) {
      const int pos = offset + __popc(ballot & ((1u << lane) - 1));
      tl.list[pos] = static_cast<int32_t>(b - base);
      tl.reads[pos] = nv;
      tl.starts[pos] = ev_off + incl - nev;
    }
    if (tid == kBlock - 1) tl.starts[ncand] = ev_off + incl;
    if (tid == 0) cand_total += ncand;
    __syncthreads();

    for (int c0 = 0; c0 < ncand;) {
      // the group: from c0, as many candidates as fit, and at least one
      const int s0 = tl.starts[c0];
      const bool alone = tl.starts[c0 + 1] - s0 > group_events;
      int c1 = c0 + 1;
      if (!alone) {
        while (c1 < ncand && tl.starts[c1 + 1] - s0 <= group_events) ++c1;
      }
      if (tid == 0) ++group_total;
      if (alone != alone_layout) {
        __syncthreads();  // the other layout's last readers are done
        if (alone) clear_alone(a, sub); else clear_group(g, group_events);
        alone_layout = alone;
        __syncthreads();
      }
      if (alone) {
        alone_pass(a, base + tl.list[c0], tl.reads[c0], codes, L, k, W,
                   cutoff, sub, layout, flat, keep, counts, my_new);
      } else {
        group_pass(g, tl, c0, c1, base, codes, L, k, W, cutoff, layout,
                   flat, keep, counts, my_new);
      }
      c0 = c1;
    }
    __syncthreads();  // the list is refilled next tile
  }

  my_new = __reduce_add_sync(kFull, static_cast<unsigned>(my_new));
  if (lane == 0) warp_new[warp] = my_new;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_new[w];
    *n_unique += total;
    *n_cand += cand_total;
    if (n_groups != nullptr) *n_groups += group_total;
  }
}

}  // namespace
}  // namespace khmer_digi_scan

// Scan bundles 0..nbundles-1 of codes [2 nbundles, L] / lengths
// [2 nbundles], skipping those with reject[b] set: keep[b] for every b,
// the flat byte tables updated in place, the new k-mers added to
// *n_unique, the bundles scanned to *n_cand and the groups they formed to
// *n_groups (may be null). primes/offsets are HOST arrays of ntables;
// `sub` (events a sub-chunk of a lone bundle's adds), `smem` (dynamic
// shared bytes) and whether a lone bundle's hashes go to `hashes`, a
// device buffer of 2 (L - k + 1) words, or to shared memory (`hashes`
// null) come from core/sketch_kernels.py diginorm_plan(L, k, ntables).
extern "C" int khmer_diginorm_scan(uint8_t* flat, int ntables,
                                   const int64_t* primes,
                                   const int64_t* offsets,
                                   const uint8_t* codes,
                                   const int32_t* lengths,
                                   const uint8_t* reject, int64_t nbundles,
                                   int L, int k, int cutoff, int sub,
                                   int smem, void* hashes, uint8_t* keep,
                                   int64_t* n_unique, int64_t* n_cand,
                                   int64_t* n_groups, int device,
                                   void* stream) {
  using namespace khmer_digi_scan;
  khmer_byte::ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, offsets, &layout)
      || nbundles < 0 || k < 1 || k > 32 || L < k || sub < 1
      || static_cast<int64_t>(sub) * ntables > kMap / 2) {
    return cudaErrorInvalidValue;
  }
  const int64_t words = int64_t{2} * (L - k + 1);
  const int64_t need = union_bytes(kGroupItems / ntables,
                                   hashes ? 0 : words, sub)
                       + kTileBytes;
  if (smem < need) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbundles == 0) return cudaSuccess;
  err = cudaFuncSetAttribute(scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  scan_kernel<<<1, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      codes, lengths, reject, nbundles, L, k, cutoff, sub, layout, flat,
      static_cast<uint64_t*>(hashes), keep,
      reinterpret_cast<unsigned long long*>(n_unique),
      reinterpret_cast<unsigned long long*>(n_cand),
      reinterpret_cast<unsigned long long*>(n_groups));
  return cudaGetLastError();
}
