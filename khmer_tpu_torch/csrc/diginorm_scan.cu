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
// What bounds it: latency. Each candidate is a chain of dependent round
// trips to device memory (the codes, the counters for the test, the
// counters again for the add), each step waiting for the one before it
// and for a block-wide barrier; a window's candidates run one after the
// other. Its byte bound (the codes once, each counter read once and each
// changed counter written once) is far below what the chain allows.
//
// Design. One block walks the whole window: there is no host round trip
// inside a window, and the host reads the keep flags once per window. The
// block compacts kernel E's flags a tile at a time into a candidate list
// in shared memory, then takes the candidates in order. Step 1 caches the
// bundle's hashes in shared memory. Step 3 adds in sub-chunks of `sub`
// events, each through an open-addressing map in shared memory from
// counter to (hits, lowest event), as csrc/bucket_common.cuh does for a
// chunk: the map is filled, then each entry reads its counter once and
// writes min(old + hits, 255) once, a plain byte store, and if the counter
// was 0 marks its lowest event new. Reading the counter as the sub-chunk
// finds it (not as the bundle found it) is what makes sub-chunks compose
// into the sequential rule: a counter an earlier sub-chunk hit is no
// longer 0. The tables are read and written only with plain loads and
// stores, ordered by __syncthreads() within the one block (no read-only
// cache path). No u32 copy of the tables and no scratch the size of the
// tables: the shared memory is sized by the window's row length
// (core/sketch_kernels.py diginorm_plan). Rows too long for the bundle's
// hashes to fit in shared memory (about 10,000 codes) keep them in a
// device buffer of 16 B a window instead, also sized by the row.

#include "byte_common.cuh"
#include "twobit_common.cuh"

namespace khmer_digi_scan {
namespace {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;
using khmer_cuda::kMaxCount;

// core/sketch_kernels.py DIGI_SCAN_THREADS and DIGI_MAP_SLOTS
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kSlotBits = 12;
constexpr int kSlots = 1 << kSlotBits;
constexpr int kPerThread = kSlots / kBlock;
constexpr unsigned long long kEmpty = ~0ULL;
constexpr uint32_t kNoEvent = ~0u;

// splitmix64 finalizer: spreads counters over the map's slots.
__device__ __forceinline__ uint64_t mix(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

// The dynamic shared memory, in the order of diginorm_plan: map keys,
// the bundle's hashes (unless `hash_buf` holds them), map hits and lowest
// events, the candidate list, the new flags of a sub-chunk.
struct Smem {
  unsigned long long* keys;
  uint64_t* hashes;
  uint32_t* hits;
  uint32_t* first;
  int32_t* list;
  uint8_t* fresh;
};

__device__ __forceinline__ Smem carve(unsigned char* base, int max_events,
                                      uint64_t* hash_buf) {
  Smem s;
  s.keys = reinterpret_cast<unsigned long long*>(base);
  base += sizeof(unsigned long long) * kSlots;
  if (hash_buf != nullptr) {
    s.hashes = hash_buf;
  } else {
    s.hashes = reinterpret_cast<uint64_t*>(base);
    base += sizeof(uint64_t) * max_events;
  }
  s.hits = reinterpret_cast<uint32_t*>(base);
  base += sizeof(uint32_t) * kSlots;
  s.first = reinterpret_cast<uint32_t*>(base);
  base += sizeof(uint32_t) * kSlots;
  s.list = reinterpret_cast<int32_t*>(base);
  base += sizeof(int32_t) * kBlock;
  s.fresh = base;
  return s;
}

// Record one hit of `key` by sub-chunk event `e`. The map holds at most
// sub * ntables <= kSlots / 2 keys (diginorm_plan), so it never fills.
__device__ __forceinline__ void map_add(const Smem& s, uint64_t key,
                                        uint32_t e) {
  uint32_t slot = static_cast<uint32_t>(mix(key) >> (64 - kSlotBits));
  for (;;) {
    const unsigned long long prev = atomicCAS(&s.keys[slot], kEmpty, key);
    if (prev == kEmpty || prev == key) break;
    slot = (slot + 1) & (kSlots - 1);
  }
  atomicAdd(&s.hits[slot], 1u);
  atomicMin(&s.first[slot], e);
}

// Commit the map: each counter read once and written once, its lowest
// event marked new where the counter was 0; the map left empty. The
// thread's kPerThread slots load together, then their counters.
__device__ __forceinline__ void map_commit(const Smem& s, uint8_t* flat) {
  unsigned long long key[kPerThread];
  int cur[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    key[i] = s.keys[threadIdx.x + i * kBlock];
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    cur[i] = key[i] != kEmpty ? static_cast<int>(flat[key[i]]) : 0;
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (key[i] == kEmpty) continue;
    const int slot = threadIdx.x + i * kBlock;
    if (cur[i] == 0) s.fresh[s.first[slot]] = 1;
    flat[key[i]] = static_cast<uint8_t>(
        min(cur[i] + static_cast<int>(s.hits[slot]), kMaxCount));
    s.keys[slot] = kEmpty;
    s.hits[slot] = 0;
    s.first[slot] = kNoEvent;
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
            unsigned long long* __restrict__ n_cand) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = L - k + 1;
  const Smem s = carve(smem_raw, 2 * W, hash_buf);
  // per-read counts at or above C, three bundles' worth in rotation (see
  // the reset below); warp totals of the tile compaction and of the end
  __shared__ int ge[3][2];
  __shared__ int warp_total[kWarps];
  __shared__ unsigned long long warp_new[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  for (int i = tid; i < kSlots; i += kBlock) {
    s.keys[i] = kEmpty;
    s.hits[i] = 0;
    s.first[i] = kNoEvent;
  }
  for (int i = tid; i < sub; i += kBlock) s.fresh[i] = 0;
  if (tid < 6) ge[tid / 2][tid % 2] = 0;
  unsigned long long my_new = 0;
  unsigned long long cand_total = 0;  // thread 0's count of candidates
  int turn = 0;  // bundles tested so far, mod 3
  __syncthreads();

  for (int64_t base = 0; base < nbundles; base += kBlock) {
    // compact this tile's candidates into s.list, in bundle order
    const int64_t b = base + tid;
    const bool cand = b < nbundles && !reject[b];
    if (b < nbundles && !cand) keep[b] = 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, cand);
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0;
    int ncand = 0;
    for (int w = 0; w < kWarps; ++w) {
      offset += w < warp ? warp_total[w] : 0;
      ncand += warp_total[w];
    }
    if (cand) {
      s.list[offset + __popc(ballot & ((1u << lane) - 1))] =
          static_cast<int32_t>(b - base);
    }
    if (tid == 0) cand_total += ncand;
    __syncthreads();

    for (int c = 0; c < ncand; ++c) {
      const int64_t bundle = base + s.list[c];
      const int len0 = lengths[2 * bundle];
      const int len1 = lengths[2 * bundle + 1];
      const int nv0 = khmer_twobit::n_windows(len0, k);
      const int nv1 = khmer_twobit::n_windows(len1, k);
      const int nw0 = min(nv0, W);
      const int nev = nw0 + min(nv1, W);
      // ge[turn] is counted now; ge[(turn + 1) % 3], last read two
      // bundles ago, is cleared for the next bundle before this one's
      // barrier, which the next bundle's counting comes after
      if (tid == 0) {
        const int next = turn == 2 ? 0 : turn + 1;
        ge[next][0] = 0;
        ge[next][1] = 0;
      }

      // 1. hash and gather
      int c0 = 0;
      int c1 = 0;
      for (int e = tid; e < nev; e += kBlock) {
        const int r = e >= nw0;
        const int j = r ? e - nw0 : e;
        const uint64_t h = khmer_twobit::canonical(
            codes + (2 * bundle + r) * L + j, k);
        s.hashes[e] = h;
        int m = kMaxCount;
        for (int t = 0; t < layout.ntables; ++t) {
          m = min(m, static_cast<int>(flat[counter_index(layout, h, t)]));
        }
        if (m >= cutoff) {
          if (r) ++c1; else ++c0;
        }
      }
      c0 = __reduce_add_sync(0xffffffffu, c0);
      c1 = __reduce_add_sync(0xffffffffu, c1);
      if (lane == 0 && (c0 | c1)) {
        atomicAdd(&ge[turn][0], c0);
        atomicAdd(&ge[turn][1], c1);
      }
      __syncthreads();

      // 2. the median test; an absent read passes
      const bool ok0 = nv0 == 0 || ge[turn][0] >= (nv0 + 1) / 2;
      const bool ok1 = nv1 == 0 || ge[turn][1] >= (nv1 + 1) / 2;
      const bool kept = !(ok0 && ok1);
      turn = turn == 2 ? 0 : turn + 1;
      if (tid == 0) keep[bundle] = kept;
      if (!kept) continue;

      // 3. the adds, in sub-chunks of `sub` events in stream order
      for (int s0 = 0; s0 < nev; s0 += sub) {
        const int n = min(sub, nev - s0);
        for (int e = tid; e < n; e += kBlock) {
          const uint64_t h = s.hashes[s0 + e];
          for (int t = 0; t < layout.ntables; ++t) {
            map_add(s, counter_index(layout, h, t), static_cast<uint32_t>(e));
          }
        }
        __syncthreads();
        map_commit(s, flat);
        __syncthreads();
        for (int e = tid; e < n; e += kBlock) {
          my_new += s.fresh[e];
          s.fresh[e] = 0;
        }
      }
    }
    __syncthreads();  // s.list and warp_total are refilled next tile
  }

  my_new = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(my_new));
  if (lane == 0) warp_new[warp] = my_new;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_new[w];
    *n_unique += total;
    *n_cand += cand_total;
  }
}

}  // namespace
}  // namespace khmer_digi_scan

// Scan bundles 0..nbundles-1 of codes [2 nbundles, L] / lengths
// [2 nbundles], skipping those with reject[b] set: keep[b] for every b,
// the flat byte tables updated in place, the new k-mers added to
// *n_unique and the bundles scanned to *n_cand. primes/offsets are HOST
// arrays of ntables; `sub` (events a sub-chunk), `smem` (dynamic shared
// bytes) and whether the bundle's hashes go to `hashes`, a device buffer
// of 2 (L - k + 1) words, or to shared memory (`hashes` null) come from
// core/sketch_kernels.py diginorm_plan(L, k, ntables).
extern "C" int khmer_diginorm_scan(uint8_t* flat, int ntables,
                                   const int64_t* primes,
                                   const int64_t* offsets,
                                   const uint8_t* codes,
                                   const int32_t* lengths,
                                   const uint8_t* reject, int64_t nbundles,
                                   int L, int k, int cutoff, int sub,
                                   int smem, void* hashes, uint8_t* keep,
                                   int64_t* n_unique, int64_t* n_cand,
                                   int device, void* stream) {
  using namespace khmer_digi_scan;
  khmer_byte::ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, offsets, &layout)
      || nbundles < 0 || k < 1 || k > 32 || L < k || sub < 1
      || static_cast<int64_t>(sub) * ntables > kSlots / 2) {
    return cudaErrorInvalidValue;
  }
  const int64_t need = int64_t{8} * kSlots
                       + (hashes ? 0 : int64_t{8} * 2 * (L - k + 1))
                       + int64_t{8} * kSlots + int64_t{4} * kBlock + sub;
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
      reinterpret_cast<unsigned long long*>(n_cand));
  return cudaGetLastError();
}
