// Kernel G: trim-low-abund's pass-1 scan of one window, in stream order,
// updating the u8 tables in place: the walk over the bundles that the
// pre-pass (csrc/trim_prepass.cu) left LIVE.
//
// Replaces khmer_tpu/core/diginorm_scan.py:168 (make_trim1_window), a
// lax.scan on the TPU over u32 copies of the tables; its plain PyTorch
// version is khmer_tpu_torch/core/sketch_kernels.py:trim_window_plain,
// and that of the walk alone trim_walk_plain.
//
// Per bundle b of the window (reads 2b and 2b + 1 of a [2B, L] code
// matrix), in stream order:
//   1. gather the counts of its valid windows, the minimum over the T
//      tables, from the tables as the earlier bundles left them; per read,
//      count the windows at or above trim_cov and (with --diginorm)
//      digi_cov, and find whether window 0 is below `cutoff` and the first
//      later window that is;
//   2. decide: branch 0 if --diginorm and every present read has
//      median_at_least(digi_cov), else 1 if every present read has
//      median_at_least(trim_cov), else 2 (an absent read passes both);
//      write the branch and each read's trim position;
//   3. on branch 2, add +1 to the counter of every valid window in every
//      table, saturating at 255, and credit n_unique: a k-mer event is new
//      iff some counter of it was 0 when the event came, in stream order
//      (reference ByteStorage::add, storage.hh:571-624).
// The scan ignores the bigcount map, as the JAX scan does.
//
// Why walking the LIVE bundles alone is exact. Counts only rise, and only
// branch-2 bundles write. The pre-pass decides every bundle against the
// window's starting tables: a CANDIDATE would take branch 2 now; a bundle
// that would not passes trim_cov (or digi_cov) now, and so to the end of
// the window: it is never consumed. Such a bundle is SETTLED, its
// pre-pass outputs final, unless some window of it below cutoff (or, when
// its --diginorm test fails at the start, below digi_cov) has every
// counter below that threshold among the candidates' counters: only then
// can an add move that window across it. Candidates and such bundles are
// LIVE. The walk runs the LIVE bundles in stream order against the tables
// plus every earlier add, which all came from LIVE bundles, so each sees
// the tables the sequential scan would show it; a LIVE non-candidate still
// decides branch 0 or 1 and adds nothing.
//
// What bounds it: latency. Every live bundle depends on the adds of the
// live bundles before it, so one block walks them, and each step is a
// chain of dependent round trips to device memory behind block barriers.
// The byte bound (the codes once, each counter read once, each changed
// counter written once) is far below that chain. The pre-pass takes the
// bundles no add can change off the chain (at config 3's sizes, most of
// them), and the walk takes the rest in groups, one round of loads each.
//
// Design: kernel F's (csrc/diginorm_scan.cu). One block walks the window:
// it compacts the LIVE flags a tile of kBlock bundles at a time into a
// list in shared memory and takes the list in GROUPS on a shared-memory
// overlay (csrc/overlay_groups.cuh, steps a-d): a group's counters load
// in one round, then its bundles run in stream order against the overlay
// alone, two barriers each (the tally reads each item's value while the
// bundle's hits are recorded; then, on branch 2, its lowest event on each
// slot adds them), and each changed counter is stored once.
// A bundle whose items alone exceed kGroupItems (rows of thousands of
// codes, or many tables) runs ALONE: its counts gathered from the tables,
// its adds in sub-chunks of `sub` events through a map of kMap slots
// (counter -> hits, lowest event) whose owners read their counter as the
// sub-chunk finds it and write it once, its windows hashed again from
// their codes for the add. The sub-chunks compose into the sequential
// scan as the groups do. The two layouts share the shared memory (a
// union), each cleared when the walk switches to it. The tables are read
// and written only with plain loads and stores, ordered by
// __syncthreads() within the one block; the shared memory depends on the
// number of tables alone (core/sketch_kernels.py trim_plan), and there is
// no other scratch.

#include "overlay_groups.cuh"

namespace khmer_trim1 {
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
using khmer_groups::kOwner;
using khmer_groups::kTileBytes;
using khmer_groups::kWarps;
using khmer_groups::Tile;

// core/sketch_kernels.py TRIM_MAP_SLOTS
constexpr int kMapBits = 12;
constexpr int kMap = 1 << kMapBits;
constexpr int kMaxItems = kMap / 2;  // a sub-chunk's (event, table) items
constexpr int kItemsPerThread = kMaxItems / kBlock;

constexpr uint8_t kLive = 1;  // core/sketch_kernels.py TRIM_LIVE
constexpr unsigned long long kEmpty = ~0ULL;
constexpr int kNone = 0x7fffffff;  // no bad window past the 0th

// splitmix64 finalizer: spreads counters over the map's slots.
__device__ __forceinline__ uint64_t mix(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

// The dynamic shared memory, in the order of trim_plan: a union of the
// group's overlay (khmer_groups::Group) and the lone bundle's map,
// rounded up to 16 bytes, then the tile's list of live bundles
// (khmer_groups::Tile).
struct Alone {
  unsigned long long* keys;  // kMap: a counter, or kEmpty
  uint32_t* hits;            // kMap; 0 outside an add
  uint32_t* first;           // kMap; kNoEvent outside an add
  uint16_t* slots;           // kMaxItems: slot of sub-chunk item e T + t
  uint8_t* fresh;            // `sub`: a sub-chunk's new flags
};

__host__ __device__ inline int64_t alone_bytes(int sub) {
  return int64_t{8} * kMap + int64_t{4} * kMap * 2
         + int64_t{2} * kMaxItems + sub;
}

__host__ __device__ inline int64_t union_bytes(int group_events, int sub) {
  const int64_t g = khmer_groups::group_bytes(group_events);
  const int64_t a = alone_bytes(sub);
  return ((g > a ? g : a) + 15) & ~int64_t{15};
}

__device__ __forceinline__ Alone carve_alone(unsigned char* base) {
  Alone a;
  a.keys = reinterpret_cast<unsigned long long*>(base);
  base += sizeof(unsigned long long) * kMap;
  a.hits = reinterpret_cast<uint32_t*>(base);
  base += sizeof(uint32_t) * kMap;
  a.first = reinterpret_cast<uint32_t*>(base);
  base += sizeof(uint32_t) * kMap;
  a.slots = reinterpret_cast<uint16_t*>(base);
  base += sizeof(uint16_t) * kMaxItems;
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

// One bundle's per-read tallies.
struct Tally {
  int trim[2];       // windows >= trim_cov
  int digi[2];       // windows >= digi_cov
  int bad0[2];       // window 0 < cutoff
  int first_bad[2];  // the first window j >= 1 < cutoff, or kNone
};

__device__ __forceinline__ void clear(Tally& t) {
  for (int r = 0; r < 2; ++r) {
    t.trim[r] = 0;
    t.digi[r] = 0;
    t.bad0[r] = 0;
    t.first_bad[r] = kNone;
  }
}

// A thread's share of one bundle's tallies.
struct Part {
  int trim[2] = {0, 0};
  int digi[2] = {0, 0};
  int bad0[2] = {0, 0};
  int first_bad[2] = {kNone, kNone};

  // window j of read r, of count m
  __device__ __forceinline__ void add(int r, int j, int m, int cutoff,
                                      int trim_cov, int digi_cov) {
    trim[r] += m >= trim_cov;
    digi[r] += m >= digi_cov;
    if (m < cutoff) {
      if (j == 0) {
        bad0[r] = 1;
      } else {
        first_bad[r] = min(first_bad[r], j);
      }
    }
  }
};

// The trim position (hashtable.cc:504-533, as make_trim1_window takes it)
// of a read with `nvalid` windows: 0 if its window 0 is bad or it has one
// window, k + j - 1 for its first later bad window j, else nvalid + k - 1
// (its length; k - 1 for an absent read).
__device__ __forceinline__ int trim_pos(int nvalid, int bad0, int first_bad,
                                        int k) {
  if ((nvalid > 0 && bad0) || nvalid == 1) return 0;
  if (first_bad != kNone) return k + first_bad - 1;
  return nvalid + k - 1;
}

// median_at_least's threshold (nvalid + 1) / 2 = floor(0.5 + nvalid / 2);
// an absent read passes.
__device__ __forceinline__ bool at_least(int ge, int nvalid) {
  return nvalid == 0 || ge >= (nvalid + 1) / 2;
}

// The tallies of the bundles, three in rotation: tally[turn] is summed for
// this bundle, and tally[turn + 1], last read two bundles ago, is cleared
// for the next one before this one's barrier, which the next bundle's
// tally comes after.
struct Tallies {
  Tally* t;
  int turn;
};

__device__ __forceinline__ void open_bundle(Tallies& n) {
  if (threadIdx.x == 0) clear(n.t[n.turn == 2 ? 0 : n.turn + 1]);
}

// Sum this bundle's parts over the block (one barrier), decide its
// branch, and write it and the trim positions. Returns the branch.
__device__ __forceinline__ int decide(Tallies& n, Part p, int2 nv, int k,
                                      int use_digi, int64_t bundle,
                                      int32_t* branch, int32_t* trim_at) {
  Tally& cur = n.t[n.turn];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = __reduce_add_sync(kFull, p.trim[r]);
    const int d = __reduce_add_sync(kFull, p.digi[r]);
    const int f = __reduce_min_sync(kFull, p.first_bad[r]);
    const bool z = __any_sync(kFull, p.bad0[r]);
    if (threadIdx.x % 32 == 0) {
      if (t) atomicAdd(&cur.trim[r], t);
      if (d) atomicAdd(&cur.digi[r], d);
      if (f != kNone) atomicMin(&cur.first_bad[r], f);
      if (z) cur.bad0[r] = 1;
    }
  }
  __syncthreads();
  const bool ok_trim = at_least(cur.trim[0], nv.x)
                       && at_least(cur.trim[1], nv.y);
  const bool ok_digi = use_digi && at_least(cur.digi[0], nv.x)
                       && at_least(cur.digi[1], nv.y);
  const int br = ok_digi ? 0 : (ok_trim ? 1 : 2);
  if (threadIdx.x == 0) {
    branch[bundle] = br;
    trim_at[2 * bundle] = trim_pos(nv.x, cur.bad0[0], cur.first_bad[0], k);
    trim_at[2 * bundle + 1] =
        trim_pos(nv.y, cur.bad0[1], cur.first_bad[1], k);
  }
  n.turn = n.turn == 2 ? 0 : n.turn + 1;
  return br;
}

// The thresholds and outputs every bundle's step shares.
struct Args {
  const uint8_t* codes;
  int L;
  int k;
  int cutoff;
  int trim_cov;
  int digi_cov;
  int use_digi;
  int sub;
  int32_t* branch;
  int32_t* trim_at;
};

// The canonical hash of window e of bundle b (read 0's windows first).
__device__ __forceinline__ uint64_t event_hash(const Args& x, int64_t b,
                                               int nv0, int e) {
  const int r = e >= nv0;
  return khmer_twobit::canonical_loads_first(
      x.codes + (2 * b + r) * x.L + (r ? e - nv0 : e), x.k);
}

// Live bundles [c0, c1) of the tile as one group (overlay_groups.cuh,
// steps a-d). Leaves the overlay empty, behind a barrier.
__device__ void group_pass(const Group& g, const Tile& tl, int c0, int c1,
                           int64_t base, const Args& x, int W,
                           const ByteLayout& layout, uint8_t* flat,
                           Tallies& n, unsigned long long& my_new) {
  const int T = layout.ntables;
  const Items it(T);
  const int s0 = tl.starts[c0];
  khmer_groups::gather_group(g, tl, c0, c1, base, x.codes, x.L, x.k, W,
                             layout, flat);

  // c. the bundles in stream order, on the overlay alone
  for (int c = c0; c < c1; ++c) {
    const int2 nv = tl.reads[c];
    const int e0 = tl.starts[c] - s0;
    const uint16_t* sl = g.slots + e0 * T;
    open_bundle(n);
    // the tally, while the bundle's hits are recorded should it take
    // branch 2
    Part p;
    khmer_groups::read_bundle(g, sl, nv.x + nv.y, T, [&](int e, int m) {
      const int r = e >= nv.x;
      p.add(r, r ? e - nv.x : e, m, x.cutoff, x.trim_cov, x.digi_cov);
    });
    const bool consume = decide(n, p, nv, x.k, x.use_digi,
                                base + tl.list[c], x.branch,
                                x.trim_at) == 2;
    khmer_groups::add_bundle(g, sl, nv.x + nv.y, e0, it, consume);
  }
  khmer_groups::store_group(g, tl, c0, c1, T, flat, my_new);
}

// A branch-2 bundle too large for the overlay: its adds in sub-chunks
// through the map. Leaves the map empty, behind a barrier.
__device__ void consume_alone(const Alone& a, int64_t b, int2 nv,
                              const Args& x, const ByteLayout& layout,
                              uint8_t* flat, unsigned long long& my_new) {
  const int tid = threadIdx.x;
  const int T = layout.ntables;
  const int nev = nv.x + nv.y;
  for (int s0 = 0; s0 < nev; s0 += x.sub) {
    const int cnt = min(x.sub, nev - s0);
    // each item finds its counter's slot or inserts it (a 64-bit CAS: the
    // inserter owns the slot), then records a hit and its event
    for (int e = tid; e < cnt; e += kBlock) {
      const uint64_t h = event_hash(x, b, nv.x, s0 + e);
      for (int t = 0; t < T; ++t) {
        const unsigned long long key = counter_index(layout, h, t);
        uint32_t slot = static_cast<uint32_t>(mix(key) >> (64 - kMapBits));
        uint16_t own = 0;
        for (;;) {
          const unsigned long long prev =
              atomicCAS(&a.keys[slot], kEmpty, key);
          if (prev == kEmpty) {
            own = kOwner;
            break;
          }
          if (prev == key) break;
          slot = (slot + 1) & (kMap - 1);
        }
        atomicAdd(&a.hits[slot], 1u);
        atomicMin(&a.first[slot], static_cast<uint32_t>(e));
        a.slots[e * T + t] = static_cast<uint16_t>(slot | own);
      }
    }
    __syncthreads();
    // each owner reads its counter (a thread's at once), credits its
    // lowest event if it was 0, writes it once and frees the slot
    const int items = cnt * T;
    for (int i0 = tid; i0 < items; i0 += kBlock * kItemsPerThread) {
      unsigned long long key[kItemsPerThread];
      int slot[kItemsPerThread];
      int v[kItemsPerThread];
#pragma unroll
      for (int q = 0; q < kItemsPerThread; ++q) {
        const int i = i0 + q * kBlock;
        const int sl = i < items ? a.slots[i] : 0;
        slot[q] = sl & (kMap - 1);
        key[q] = (sl & kOwner) ? a.keys[slot[q]] : kEmpty;
      }
#pragma unroll
      for (int q = 0; q < kItemsPerThread; ++q) {
        v[q] = key[q] != kEmpty ? static_cast<int>(flat[key[q]]) : 0;
      }
#pragma unroll
      for (int q = 0; q < kItemsPerThread; ++q) {
        if (key[q] == kEmpty) continue;
        if (v[q] == 0) a.fresh[a.first[slot[q]]] = 1;
        flat[key[q]] = static_cast<uint8_t>(
            min(v[q] + static_cast<int>(a.hits[slot[q]]), kMaxCount));
        a.keys[slot[q]] = kEmpty;
        a.hits[slot[q]] = 0;
        a.first[slot[q]] = kNoEvent;
      }
    }
    __syncthreads();
    for (int e = tid; e < cnt; e += kBlock) {
      my_new += a.fresh[e];
      a.fresh[e] = 0;
    }
  }
}

// One live bundle too large for the overlay, as a group of its own: its
// counts gathered from the tables, its branch decided, its adds (on
// branch 2) through the map.
__device__ void alone_pass(const Alone& a, int64_t b, int2 nv,
                           const Args& x, const ByteLayout& layout,
                           uint8_t* flat, Tallies& n,
                           unsigned long long& my_new) {
  const int T = layout.ntables;
  open_bundle(n);
  Part p;
  for (int e = threadIdx.x; e < nv.x + nv.y; e += kBlock) {
    const uint64_t h = event_hash(x, b, nv.x, e);
    int m = kMaxCount;
    for (int t = 0; t < T; ++t) {
      m = min(m, static_cast<int>(flat[counter_index(layout, h, t)]));
    }
    const int r = e >= nv.x;
    p.add(r, r ? e - nv.x : e, m, x.cutoff, x.trim_cov, x.digi_cov);
  }
  if (decide(n, p, nv, x.k, x.use_digi, b, x.branch, x.trim_at) == 2) {
    consume_alone(a, b, nv, x, layout, flat, my_new);
  }
}

__global__ void __launch_bounds__(kBlock)
walk_kernel(const uint8_t* __restrict__ codes,
            const int32_t* __restrict__ lengths,
            const uint8_t* __restrict__ state, int64_t nbundles, int L,
            int k, int cutoff, int trim_cov, int digi_cov, int use_digi,
            int sub, const __grid_constant__ ByteLayout layout,
            uint8_t* flat, int32_t* __restrict__ branch,
            int32_t* __restrict__ trim_at,
            unsigned long long* __restrict__ n_unique,
            unsigned long long* __restrict__ n_live,
            unsigned long long* __restrict__ n_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = L - k + 1;
  const int group_events = kGroupItems / layout.ntables;
  const Group g = khmer_groups::carve_group(smem_raw, group_events);
  const Alone a = carve_alone(smem_raw);
  const Tile tl =
      khmer_groups::carve_tile(smem_raw + union_bytes(group_events, sub));
  __shared__ Tally tally[3];
  __shared__ int warp_total[kWarps];
  __shared__ int warp_events[kWarps];
  __shared__ unsigned long long warp_new[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const Args x{codes, L, k, cutoff, trim_cov, digi_cov, use_digi, sub,
               branch, trim_at};

  khmer_groups::clear_group(g, group_events);
  if (tid < 3) clear(tally[tid]);
  Tallies n{tally, 0};
  bool alone_layout = false;  // which layout the union holds, cleared
  unsigned long long my_new = 0;
  unsigned long long live_total = 0;   // thread 0's count of live bundles
  unsigned long long group_total = 0;  // and of groups
  __syncthreads();

  for (int64_t base = 0; base < nbundles; base += kBlock) {
    // compact this tile's live bundles into the list, with their window
    // counts (at most W a read)
    const int64_t b = base + tid;
    const bool live = b < nbundles && state[b] == kLive;
    int2 nv = make_int2(0, 0);
    if (live) {
      nv.x = min(khmer_twobit::n_windows(lengths[2 * b], k), W);
      nv.y = min(khmer_twobit::n_windows(lengths[2 * b + 1], k), W);
    }
    const int nlive = khmer_groups::compact_tile(
        tl, b, base, live, nv, W, group_events, warp_total, warp_events);
    if (tid == 0) live_total += nlive;

    for (int c0 = 0; c0 < nlive;) {
      // the group: from c0, as many live bundles as fit, and at least one
      const int s0 = tl.starts[c0];
      const bool alone = tl.starts[c0 + 1] - s0 > group_events;
      int c1 = c0 + 1;
      if (!alone) {
        while (c1 < nlive && tl.starts[c1 + 1] - s0 <= group_events) ++c1;
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
        alone_pass(a, base + tl.list[c0], tl.reads[c0], x, layout, flat, n,
                   my_new);
      } else {
        group_pass(g, tl, c0, c1, base, x, W, layout, flat, n, my_new);
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
    if (n_live != nullptr) *n_live += live_total;
    if (n_groups != nullptr) *n_groups += group_total;
  }
}

}  // namespace
}  // namespace khmer_trim1

// Walk the bundles b < nbundles of codes [2 nbundles, L] / lengths
// [2 nbundles] whose state[b] is LIVE (csrc/trim_prepass.cu), in stream
// order: branch[b] and trim_at[2b], trim_at[2b + 1] written for them (the
// others keep the pre-pass's), the flat byte tables updated in place, the
// new k-mers added to *n_unique, the live bundles to *n_live and the
// groups they formed to *n_groups (both may be null). cutoff, trim_cov and
// digi_cov are clamped to [-1, 256] by the caller; digi_cov counts only
// when use_digi is set. primes/offsets are HOST arrays of ntables; `sub`
// (events a sub-chunk of a lone bundle's adds) and `smem` (dynamic shared
// bytes) come from core/sketch_kernels.py trim_plan(ntables).
extern "C" int khmer_trim_scan(uint8_t* flat, int ntables,
                               const int64_t* primes, const int64_t* offsets,
                               const uint8_t* codes, const int32_t* lengths,
                               const uint8_t* state, int64_t nbundles, int L,
                               int k, int cutoff, int trim_cov, int digi_cov,
                               int use_digi, int sub, int smem,
                               int32_t* branch, int32_t* trim_at,
                               int64_t* n_unique, int64_t* n_live,
                               int64_t* n_groups, int device, void* stream) {
  using namespace khmer_trim1;
  khmer_byte::ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, offsets, &layout)
      || nbundles < 0 || k < 1 || k > 32 || L < k || sub < 1
      || static_cast<int64_t>(sub) * ntables > kMaxItems
      || smem < union_bytes(kGroupItems / ntables, sub) + kTileBytes) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbundles == 0) return cudaSuccess;
  err = cudaFuncSetAttribute(walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  walk_kernel<<<1, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      codes, lengths, state, nbundles, L, k, cutoff, trim_cov, digi_cov,
      use_digi, sub, layout, flat, branch, trim_at,
      reinterpret_cast<unsigned long long*>(n_unique),
      reinterpret_cast<unsigned long long*>(n_live),
      reinterpret_cast<unsigned long long*>(n_groups));
  return cudaGetLastError();
}
