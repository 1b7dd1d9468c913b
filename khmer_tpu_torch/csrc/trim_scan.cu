// Kernel G: trim-low-abund's pass-1 scan of one window, in stream order,
// updating the u8 tables in place.
//
// Replaces khmer_tpu/core/diginorm_scan.py:168 (make_trim1_window), a
// lax.scan on the TPU over u32 copies of the tables; its plain PyTorch
// version is khmer_tpu_torch/core/sketch_kernels.py:trim_window_plain.
//
// Per bundle b of the window (reads 2b and 2b + 1 of a [2B, L] code
// matrix), in stream order:
//   1. hash its valid windows and gather their counts, the minimum over
//      the T tables, from the tables as the earlier bundles left them;
//      per read, count the windows at or above trim_cov and (with
//      --diginorm) digi_cov, and find whether window 0 is below `cutoff`
//      and the first later window that is;
//   2. decide: branch 0 if --diginorm and every present read has
//      median_at_least(digi_cov), else 1 if every present read has
//      median_at_least(trim_cov), else 2 (an absent read passes both);
//      write the branch and each read's trim position, from these counts
//      whatever the branch;
//   3. on branch 2, add +1 to the counter of every valid window in every
//      table, saturating at 255, and credit n_unique: a k-mer event is new
//      iff some counter of it was 0 when the event came, in stream order
//      (reference ByteStorage::add, storage.hh:571-624).
// The scan ignores the bigcount map, as the JAX scan does.
//
// What bounds it: latency. Every bundle depends on the adds of the
// bundles before it, so one block walks the window, and each bundle is a
// chain of dependent round trips to device memory (its codes, its
// counters, and on branch 2 the counters again for the add), each behind
// a block-wide barrier. The byte bound (the codes once, each counter read
// once, each changed counter written once) is far below that chain.
//
// Design: kernel F's lone-bundle path (csrc/diginorm_scan.cu), for every
// bundle. The block loads a tile of kBlock bundles' window counts at once.
// For a bundle, each thread takes windows e = tid, tid + kBlock, ...: it
// loads the window's k codes at once, hashes them and gathers the T
// counters; warp reductions then one shared atomic a warp fold the
// per-read tallies, behind one barrier. The tallies rotate over three
// slots, so a slot is cleared two bundles after it was read with no barrier
// of its own. A consumed bundle's adds go in sub-chunks of `sub` events
// through a map of kMap slots in shared memory (counter -> hits, lowest
// event): each (event, table) item inserts its counter and keeps the
// slot, the item that inserted a counter owns it, and each owner then
// reads its counter as the sub-chunk finds it, marks its lowest event new
// if it was 0, writes min(v + hits, 255) once and frees the slot. The
// sub-chunks compose into the sequential rule: a counter's lowest event
// of the bundle lies in its first sub-chunk. The add hashes each window
// again from its codes (they were just read). The tables are read and
// written only with plain loads and stores, ordered by __syncthreads()
// within the one block; the shared memory depends on the number of tables
// alone (core/sketch_kernels.py trim_plan), and there is no other scratch.

#include "byte_common.cuh"
#include "twobit_common.cuh"

namespace khmer_trim1 {
namespace {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;
using khmer_cuda::kMaxCount;

// core/sketch_kernels.py TRIM_THREADS and TRIM_MAP_SLOTS
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMapBits = 12;
constexpr int kMap = 1 << kMapBits;
constexpr int kMaxItems = kMap / 2;  // a sub-chunk's (event, table) items
constexpr int kItemsPerThread = kMaxItems / kBlock;

constexpr unsigned long long kEmpty = ~0ULL;
constexpr uint32_t kNoEvent = ~0u;
constexpr uint16_t kOwner = 0x8000;  // on the item that inserted its slot
constexpr int kSlotMask = kMap - 1;
constexpr int kNone = 0x7fffffff;    // no bad window past the 0th
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

// The dynamic shared memory, in the order of trim_plan.
struct Shared {
  unsigned long long* keys;  // kMap: a counter, or kEmpty
  uint32_t* hits;            // kMap; 0 outside an add
  uint32_t* first;           // kMap; kNoEvent outside an add
  int2* reads;               // kBlock: the tile's bundles' windows
  uint16_t* slots;           // kMaxItems: slot of sub-chunk item e T + t
  uint8_t* fresh;            // `sub`: a sub-chunk's new flags
};

__device__ __forceinline__ Shared carve(unsigned char* base) {
  Shared s;
  s.keys = reinterpret_cast<unsigned long long*>(base);
  base += sizeof(unsigned long long) * kMap;
  s.hits = reinterpret_cast<uint32_t*>(base);
  base += sizeof(uint32_t) * kMap;
  s.first = reinterpret_cast<uint32_t*>(base);
  base += sizeof(uint32_t) * kMap;
  s.reads = reinterpret_cast<int2*>(base);
  base += sizeof(int2) * kBlock;
  s.slots = reinterpret_cast<uint16_t*>(base);
  base += sizeof(uint16_t) * kMaxItems;
  s.fresh = base;
  return s;
}

__host__ __device__ inline int64_t smem_bytes(int sub) {
  return int64_t{8} * kMap + int64_t{4} * kMap * 2 + int64_t{8} * kBlock
         + int64_t{2} * kMaxItems + ((sub + 15) & ~15);
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

// The canonical hash of window e of bundle b (read 0's windows first).
__device__ __forceinline__ uint64_t event_hash(const uint8_t* codes,
                                               int64_t b, int2 nv, int e,
                                               int L, int k) {
  const int r = e >= nv.x;
  const int j = r ? e - nv.x : e;
  return khmer_twobit::canonical_loads_first(codes + (2 * b + r) * L + j,
                                             k);
}

// Step 3: commit bundle b's adds, in sub-chunks through the map. Leaves
// the map empty, behind a barrier.
__device__ void consume(const Shared& s, int64_t b, int2 nv,
                        const uint8_t* codes, int L, int k, int sub,
                        const ByteLayout& layout, uint8_t* flat,
                        unsigned long long& my_new) {
  const int tid = threadIdx.x;
  const int T = layout.ntables;
  const int nev = nv.x + nv.y;
  for (int s0 = 0; s0 < nev; s0 += sub) {
    const int cnt = min(sub, nev - s0);
    // each item finds its counter's slot or inserts it (a 64-bit CAS: the
    // inserter owns the slot), then records a hit and its event
    for (int e = tid; e < cnt; e += kBlock) {
      const uint64_t h = event_hash(codes, b, nv, s0 + e, L, k);
      for (int t = 0; t < T; ++t) {
        const unsigned long long key = counter_index(layout, h, t);
        uint32_t slot = static_cast<uint32_t>(mix(key) >> (64 - kMapBits));
        uint16_t own = 0;
        for (;;) {
          const unsigned long long prev =
              atomicCAS(&s.keys[slot], kEmpty, key);
          if (prev == kEmpty) {
            own = kOwner;
            break;
          }
          if (prev == key) break;
          slot = (slot + 1) & kSlotMask;
        }
        atomicAdd(&s.hits[slot], 1u);
        atomicMin(&s.first[slot], static_cast<uint32_t>(e));
        s.slots[e * T + t] = static_cast<uint16_t>(slot | own);
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
        const int sl = i < items ? s.slots[i] : 0;
        slot[q] = sl & kSlotMask;
        key[q] = (sl & kOwner) ? s.keys[slot[q]] : kEmpty;
      }
#pragma unroll
      for (int q = 0; q < kItemsPerThread; ++q) {
        v[q] = key[q] != kEmpty ? static_cast<int>(flat[key[q]]) : 0;
      }
#pragma unroll
      for (int q = 0; q < kItemsPerThread; ++q) {
        if (key[q] == kEmpty) continue;
        if (v[q] == 0) s.fresh[s.first[slot[q]]] = 1;
        flat[key[q]] = static_cast<uint8_t>(
            min(v[q] + static_cast<int>(s.hits[slot[q]]), kMaxCount));
        s.keys[slot[q]] = kEmpty;
        s.hits[slot[q]] = 0;
        s.first[slot[q]] = kNoEvent;
      }
    }
    __syncthreads();
    for (int e = tid; e < cnt; e += kBlock) {
      my_new += s.fresh[e];
      s.fresh[e] = 0;
    }
  }
}

__global__ void __launch_bounds__(kBlock)
trim_kernel(const uint8_t* __restrict__ codes,
            const int32_t* __restrict__ lengths, int64_t nbundles, int L,
            int k, int cutoff, int trim_cov, int digi_cov, int use_digi,
            int sub, const __grid_constant__ ByteLayout layout,
            uint8_t* flat, int32_t* __restrict__ branch,
            int32_t* __restrict__ trim_at,
            unsigned long long* __restrict__ n_unique) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Shared s = carve(smem_raw);
  __shared__ Tally tally[3];
  __shared__ unsigned long long warp_new[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int W = L - k + 1;
  const int T = layout.ntables;

  for (int i = tid; i < kMap; i += kBlock) {
    s.keys[i] = kEmpty;
    s.hits[i] = 0;
    s.first[i] = kNoEvent;
  }
  for (int i = tid; i < sub; i += kBlock) s.fresh[i] = 0;
  if (tid < 3) clear(tally[tid]);
  int turn = 0;
  unsigned long long my_new = 0;
  __syncthreads();

  for (int64_t base = 0; base < nbundles; base += kBlock) {
    // the tile's window counts, one bundle a thread
    const int64_t bt = base + tid;
    int2 nvt = make_int2(0, 0);
    if (bt < nbundles) {
      nvt.x = min(khmer_twobit::n_windows(lengths[2 * bt], k), W);
      nvt.y = min(khmer_twobit::n_windows(lengths[2 * bt + 1], k), W);
    }
    s.reads[tid] = nvt;
    __syncthreads();
    const int nb = nbundles - base < kBlock
                       ? static_cast<int>(nbundles - base) : kBlock;
    for (int i = 0; i < nb; ++i) {
      const int64_t b = base + i;
      const int2 nv = s.reads[i];
      const int nev = nv.x + nv.y;
      Tally& cur = tally[turn];
      // the slot two bundles back: every thread read it before the last
      // bundle's barrier
      if (tid == 0) clear(tally[turn == 2 ? 0 : turn + 1]);
      // 1. gather, min over tables, tally per read
      int ge_t[2] = {0, 0};
      int ge_d[2] = {0, 0};
      int bad0[2] = {0, 0};
      int first_bad[2] = {kNone, kNone};
      for (int e = tid; e < nev; e += kBlock) {
        const int r = e >= nv.x;
        const int j = r ? e - nv.x : e;
        const uint64_t h = khmer_twobit::canonical_loads_first(
            codes + (2 * b + r) * L + j, k);
        int m = kMaxCount;
        for (int t = 0; t < T; ++t) {
          m = min(m, static_cast<int>(flat[counter_index(layout, h, t)]));
        }
        ge_t[r] += m >= trim_cov;
        ge_d[r] += m >= digi_cov;
        if (m < cutoff) {
          if (j == 0) {
            bad0[r] = 1;
          } else {
            first_bad[r] = min(first_bad[r], j);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = __reduce_add_sync(kFull, ge_t[r]);
        const int d = __reduce_add_sync(kFull, ge_d[r]);
        const int f = __reduce_min_sync(kFull, first_bad[r]);
        const bool z = __any_sync(kFull, bad0[r]);
        if (lane == 0) {
          if (t) atomicAdd(&cur.trim[r], t);
          if (d) atomicAdd(&cur.digi[r], d);
          if (f != kNone) atomicMin(&cur.first_bad[r], f);
          if (z) cur.bad0[r] = 1;
        }
      }
      __syncthreads();
      // 2. decide
      const bool ok_trim = at_least(cur.trim[0], nv.x)
                           && at_least(cur.trim[1], nv.y);
      const bool ok_digi = use_digi && at_least(cur.digi[0], nv.x)
                           && at_least(cur.digi[1], nv.y);
      const int br = ok_digi ? 0 : (ok_trim ? 1 : 2);
      if (tid == 0) {
        branch[b] = br;
        trim_at[2 * b] = trim_pos(nv.x, cur.bad0[0], cur.first_bad[0], k);
        trim_at[2 * b + 1] =
            trim_pos(nv.y, cur.bad0[1], cur.first_bad[1], k);
      }
      turn = turn == 2 ? 0 : turn + 1;
      // 3. consume
      if (br == 2) {
        consume(s, b, nv, codes, L, k, sub, layout, flat, my_new);
      }
    }
    __syncthreads();  // the tile's window counts are refilled next
  }

  my_new = __reduce_add_sync(kFull, static_cast<unsigned>(my_new));
  if (lane == 0) warp_new[warp] = my_new;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_new[w];
    *n_unique += total;
  }
}

}  // namespace
}  // namespace khmer_trim1

// Scan bundles 0..nbundles-1 of codes [2 nbundles, L] / lengths
// [2 nbundles]: branch[b] and trim_at[2b], trim_at[2b + 1] for every b,
// the flat byte tables updated in place, the new k-mers added to
// *n_unique. cutoff, trim_cov and digi_cov are clamped to [-1, 256] by the
// caller; digi_cov counts only when use_digi is set. primes/offsets are
// HOST arrays of ntables; `sub` (events a sub-chunk of a consumed bundle's
// adds) and `smem` (dynamic shared bytes) come from core/sketch_kernels.py
// trim_plan(ntables).
extern "C" int khmer_trim_scan(uint8_t* flat, int ntables,
                               const int64_t* primes, const int64_t* offsets,
                               const uint8_t* codes, const int32_t* lengths,
                               int64_t nbundles, int L, int k, int cutoff,
                               int trim_cov, int digi_cov, int use_digi,
                               int sub, int smem, int32_t* branch,
                               int32_t* trim_at, int64_t* n_unique,
                               int device, void* stream) {
  using namespace khmer_trim1;
  khmer_byte::ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, offsets, &layout)
      || nbundles < 0 || k < 1 || k > 32 || L < k || sub < 1
      || static_cast<int64_t>(sub) * ntables > kMaxItems
      || smem < smem_bytes(sub)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbundles == 0) return cudaSuccess;
  err = cudaFuncSetAttribute(trim_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  trim_kernel<<<1, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      codes, lengths, nbundles, L, k, cutoff, trim_cov, digi_cov, use_digi,
      sub, layout, flat, branch, trim_at,
      reinterpret_cast<unsigned long long*>(n_unique));
  return cudaGetLastError();
}
