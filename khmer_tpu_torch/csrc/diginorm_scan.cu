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
// a candidate list in shared memory and takes the list in GROUPS on a
// shared-memory overlay (csrc/overlay_groups.cuh, steps a-d): a group's
// counters load in one round, then the candidates run in stream order
// against the overlay alone, no global load or store, two barriers each
// (the test reads each item's value while the bundle's hits are
// recorded; then, if the bundle is kept, its lowest event on each slot
// adds them), and each changed counter is stored once.
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

#include "overlay_groups.cuh"

namespace khmer_digi_scan {
namespace {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;
using khmer_cuda::kMaxCount;
using khmer_groups::Group;
using khmer_groups::Items;
using khmer_groups::kBlock;
using khmer_groups::kFull;
using khmer_groups::kGroupItems;
using khmer_groups::kNoEvent;
using khmer_groups::kTileBytes;
using khmer_groups::kWarps;
using khmer_groups::Tile;

// core/sketch_kernels.py DIGI_MAP_SLOTS
constexpr int kMapBits = 12;
constexpr int kMap = 1 << kMapBits;
constexpr int kMapPerThread = kMap / kBlock;

constexpr unsigned long long kEmpty = ~0ULL;

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
// the group's overlay (khmer_groups::Group) and the lone bundle's map,
// rounded up to 16 bytes, then the tile's candidate list
// (khmer_groups::Tile).
struct Alone {
  unsigned long long* keys;  // kMap
  uint64_t* hashes;          // the bundle's events (or the device buffer)
  uint32_t* hits;            // kMap
  uint32_t* first;           // kMap
  uint8_t* fresh;            // a sub-chunk's events
};

__host__ __device__ inline int64_t alone_bytes(int64_t smem_hash_words,
                                               int sub) {
  return int64_t{8} * kMap + int64_t{8} * smem_hash_words
         + int64_t{4} * kMap * 2 + sub;
}

__host__ __device__ inline int64_t union_bytes(int group_events,
                                               int64_t smem_hash_words,
                                               int sub) {
  const int64_t g = khmer_groups::group_bytes(group_events);
  const int64_t a = alone_bytes(smem_hash_words, sub);
  return ((g > a ? g : a) + 15) & ~int64_t{15};
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

// Empty map: the state it keeps between its uses.
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

// Candidates [c0, c1) of the tile as one group (overlay_groups.cuh,
// steps a-d). Leaves the overlay empty, behind a barrier.
__device__ void group_pass(const Group& g, const Tile& tl, int c0, int c1,
                           int64_t base, const uint8_t* codes, int L, int k,
                           int W, int cutoff, const ByteLayout& layout,
                           uint8_t* flat, uint8_t* keep, Counts& n,
                           unsigned long long& my_new) {
  const int T = layout.ntables;
  const Items it(T);
  const int s0 = tl.starts[c0];
  khmer_groups::gather_group(g, tl, c0, c1, base, codes, L, k, W, layout,
                             flat);

  // c. the candidates in stream order, on the overlay alone
  for (int c = c0; c < c1; ++c) {
    const int2 nv = tl.reads[c];
    const int nw0 = min(nv.x, W);
    const int nev = nw0 + min(nv.y, W);
    const int e0 = tl.starts[c] - s0;
    const uint16_t* sl = g.slots + e0 * T;
    const int64_t bundle = base + tl.list[c];
    open_bundle(n);
    // the test, while the bundle's hits are recorded should it be kept
    int n0 = 0;
    int n1 = 0;
    khmer_groups::read_bundle(g, sl, nev, T, [&](int e, int m) {
      if (m >= cutoff) {
        if (e >= nw0) ++n1; else ++n0;
      }
    });
    const bool kept = decide(n, n0, n1, nv, bundle, keep);
    khmer_groups::add_bundle(g, sl, nev, e0, it, kept);
  }
  khmer_groups::store_group(g, tl, c0, c1, T, flat, my_new);
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
  const Group g = khmer_groups::carve_group(smem_raw, group_events);
  const Alone a = carve_alone(smem_raw, words, hash_buf);
  const Tile tl = khmer_groups::carve_tile(
      smem_raw + union_bytes(group_events, hash_buf ? 0 : words, sub));
  __shared__ int ge[3][2];
  __shared__ int warp_total[kWarps];
  __shared__ int warp_events[kWarps];
  __shared__ unsigned long long warp_new[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  khmer_groups::clear_group(g, group_events);
  if (tid < 6) ge[tid / 2][tid % 2] = 0;
  Counts counts{ge, 0};
  bool alone_layout = false;  // which layout the union holds, cleared
  unsigned long long my_new = 0;
  unsigned long long cand_total = 0;   // thread 0's count of candidates
  unsigned long long group_total = 0;  // and of groups
  __syncthreads();

  for (int64_t base = 0; base < nbundles; base += kBlock) {
    // compact this tile's candidates into the list, with their window
    // counts (the reads' own; the events count at most W a read)
    const int64_t b = base + tid;
    const bool cand = b < nbundles && !reject[b];
    if (b < nbundles && !cand) keep[b] = 0;
    int2 nv = make_int2(0, 0);
    if (cand) {
      nv.x = khmer_twobit::n_windows(lengths[2 * b], k);
      nv.y = khmer_twobit::n_windows(lengths[2 * b + 1], k);
    }
    const int ncand = khmer_groups::compact_tile(
        tl, b, base, cand, nv, W, group_events, warp_total, warp_events);
    if (tid == 0) cand_total += ncand;

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
        if (alone) {
          clear_alone(a, sub);
        } else {
          khmer_groups::clear_group(g, group_events);
        }
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
