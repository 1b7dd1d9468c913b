// Kernel P: the nibble-layout Count-Min update over T prime tables of
// 4-bit counters, with each event's new flag.
//
// Replaces the TPU's nibble update, which XLA compiled and no Pallas kernel
// covered: khmer_tpu/core/sketch_kernels.py:198 (_nibble_table_update, one
// pass of :167 _nibble_phase a parity of bins), reached through :580
// (_apply_update) from :601 (make_update). Its plain PyTorch version is
// khmer_tpu_torch/core/sketch_kernels.py:nibble_update_plain. It serves a
// SmallCountgraph's dense consume, the window commits of diginorm and trim
// (core/diginorm.py SeqWindow), the tagged consume and the knot pipeline's
// adds.
//
// Semantics (sequential SmallCountgraph adds): each counter becomes
// min(old + occurrences in the chunk, 15); an event is new iff it is the
// lowest event of the chunk to touch a counter that was 0 before the chunk
// (JAX's two-phase credit, cred_e | cred_o over the tables, names the same
// events); n_unique grows by the new events.
//
// Layout (reference storage.hh:245-405): table t holds p_t counters in
// p_t / 2 + 1 bytes at byte offset_t of one flat buffer; counter b is the
// high nibble of byte b / 2 for an even b, the low one for an odd b. So
// lane-event (i, t) names flat nibble key = 2 * offset_t + h_i % p_t, which
// lies in the little-endian 32-bit word key / 8.
//
// What bounds it: random traffic into tables far larger than L2 (4 x 25 MB
// at -x 5e7, 4 GB at -x 2e9 -N 4); the least work is one read and one
// write of each distinct word the chunk touches. At 4 GB that read and
// write-back of random sectors holds the bucket pass (PERF.md section 6).
//
// Design (scratch sized by the chunk, core/sketch_kernels.py
// nibble_update_plan; no table-sized scratch):
//   1. count:   a block a tile of up to 6,144 records (1,536 events of
//               four tables), a thread's hashes loaded 8 at a time. Each
//               warp's 32 consecutive events are grouped by hash
//               (__match_any_sync): the lowest lane of a group stands for
//               it, with the group's size as its occurrences. Its T counters
//               are bucketed by WORD: bucket b spans words [b * span, (b +
//               1) * span), span = ceil(words / nbuckets), so all 8 nibbles
//               of a word lie in one bucket and no other block writes that
//               word. A bucket holds about 3,584 records. The tile counts
//               them in shared memory, reserves its run of each bucket with
//               one atomic a bucket and writes its places in a row of the
//               scratch. It also zeroes the flag bytes.
//   2. scatter: a block the same tile: the buckets' starts by a scan of the
//               counts (block 0 publishes them), then each record computed
//               once and staged in shared memory with its slot in its
//               bucket, and the records written out in bucket order, so a
//               warp's stores are runs of neighbouring addresses. A record
//               is 64 bits: the nibble's offset in its bucket (32), the
//               occurrences, saturated at 15 (4), and the lowest event (28).
//   3. bucket:  a block of 512 threads a bucket, two blocks an SM. It
//               loads the bucket's records into shared memory (4,096 at
//               once) and sorts them by nibble offset: a counting sort into
//               4,096 bins of the offset's top bits, then each bin by
//               insertion, a thread a bin (a bin holds about one entry);
//               where a bin holds more than 16, LSD radix passes of 8-bit
//               digits instead, each stable by warp-match ranking. Each
//               word's run of entries is then one thread's: its read is
//               issued with the thread's other reads before any is used (up
//               to 4,096 in flight a block), the runs of equal nibbles give
//               each nibble's occurrences and lowest event, and the word is
//               written back by one plain 32-bit store when it changed. A
//               nibble that was 0 stores 1 in its lowest event's flag byte.
//               A bucket of at most 1,024 words (tables of a few MB) skips the
//               sort: a dense pass adds each record to its nibble's slot in
//               shared memory, then a thread a word commits.
//   4. flags:   n_unique grows by the flag bytes set, a popcount a word.
// Skew costs passes, never correctness, and never falls back to the plain
// version. A bucket with more than 4,096 entries streams them: whenever
// fewer than 2,048 slots are free the entries are sorted and equal nibbles
// merged. If more than 2,048 distinct nibbles remain, the bucket's word range
// is measured (its least and greatest word) and processed in parts, each a
// pass over the bucket's records: halves, until a part spans at most 1,024
// words, which a dense pass takes with a slot a nibble in shared memory.
// One hash 2^20 times is one record a warp, and a warp's load of records
// that all share one offset is one entry; a crowded range is a few dense
// passes.

#include <cstdint>

#include <cuda_runtime.h>

#include "byte_common.cuh"

namespace khmer_nibble {
namespace {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kNibbleMax = 15;
constexpr uint32_t kMaxBuckets = 8192;  // core/sketch_kernels.py
constexpr int kTileThreads = 256;       // count and scatter blocks
constexpr int kStage = 6144;            // records a scatter block stages
constexpr int kSlotBits = 13;           // a staged record's slot in its run
static_assert(kStage <= 1 << kSlotBits, "a slot is below 2^kSlotBits");
constexpr int kPrefetch = 8;            // hashes a thread loads at once
static_assert((uint64_t{kMaxBuckets} << kSlotBits) < 0xFFFFFFFFu,
              "a bucket and its slot fit 32 bits, below kNoSlot");
constexpr int kThreadsB = 512;          // a bucket block
constexpr int kWarpsB = kThreadsB / 32;
constexpr int kCap = 4096;              // entries a bucket block holds
constexpr int kPer = kCap / kThreadsB;  // entries a thread owns
constexpr int kChunks = kCap / (32 * kWarpsB);  // 32-entry chunks a warp
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kCounters = kRadix * kWarpsB;
constexpr int kRun = kCounters / kThreadsB;  // counters a thread scans
constexpr int kBinBits = 12;            // the bin sort's bins: kCounters
static_assert(kCounters == 1 << kBinBits, "a bin a counter");
constexpr uint32_t kBinMax = 16;        // entries a thread sorts in a bin
constexpr uint32_t kDenseWords = 1024;  // words a dense pass holds
constexpr int kStack = 64;
constexpr int kEventBits = 28;
constexpr uint32_t kEventMask = (1u << kEventBits) - 1;
constexpr uint32_t kNoSlot = kFull;
// a bucket's offsets (8 * span nibbles) must fit the record's 32 bits
constexpr uint64_t kMaxSpanWords = uint64_t{1} << 29;
static_assert(kDenseWords * 8 * 4 <= kCap * 8,
              "a dense array of u32 fits one entry buffer");
static_assert(kCounters % kThreadsB == 0 && kWarpsB % kRun == 0,
              "a thread scans one digit's counters of kRun warps");

#ifdef KHMER_NIBBLE_CLOCKS
// A diagnostic build (scripts/nibble_update_bench.py --clocks): thread 0 of
// each block adds each phase's cycles, read after a barrier, to its slot.
__device__ unsigned long long g_clocks[16];
#define KHMER_CLOCK_START long long clock_mark = clock64()
#define KHMER_CLOCK(slot)                                            \
  do {                                                               \
    if (threadIdx.x == 0) {                                          \
      const long long now = clock64();                               \
      atomicAdd(&g_clocks[slot],                                     \
                static_cast<unsigned long long>(now - clock_mark));  \
      clock_mark = now;                                              \
    }                                                                \
  } while (0)
#define KHMER_CLOCK_COUNT(slot) \
  do { if (threadIdx.x == 0) atomicAdd(&g_clocks[slot], 1ULL); } while (0)
#else
#define KHMER_CLOCK_START do {} while (0)
#define KHMER_CLOCK(slot) do {} while (0)
#define KHMER_CLOCK_COUNT(slot) do {} while (0)
#endif

// Words [b * span, (b + 1) * span) form bucket b; recip is floor((2^64 -
// 1) / span). of() splits a word into its bucket and its word in the bucket
// (the quotient by the reciprocal is exact or one low, as in
// u64_common.cuh reduce).
struct Buckets {
  uint64_t span;
  uint64_t recip;

  __device__ __forceinline__ uint32_t of(uint64_t word,
                                         uint32_t* local) const {
    uint64_t q = __umul64hi(word, recip);
    uint64_t r = word - q * span;
    if (r >= span) {
      ++q;
      r -= span;
    }
    *local = static_cast<uint32_t>(r);
    return static_cast<uint32_t>(q);
  }
};

// A record: offset in the bucket (nibbles) | occurrences | lowest event.
__device__ __forceinline__ uint64_t make_record(uint32_t off, uint32_t occ,
                                                uint32_t ev) {
  return static_cast<uint64_t>(off) << 32 | occ << kEventBits | ev;
}
__device__ __forceinline__ uint32_t off_of(uint64_t r) {
  return static_cast<uint32_t>(r >> 32);
}
__device__ __forceinline__ uint32_t occ_of(uint64_t r) {
  return static_cast<uint32_t>(r) >> kEventBits;
}
__device__ __forceinline__ uint32_t ev_of(uint64_t r) {
  return static_cast<uint32_t>(r) & kEventMask;
}

// Where the nibble at offset `off` (its low 3 bits those of its flat key:
// a bucket starts on a word) lies in its little-endian 32-bit word: byte
// (off / 2) % 4 is bits 8 * that and up, and in it an even key holds bits
// 4-7, an odd one bits 0-3.
__device__ __forceinline__ uint32_t nibble_shift(uint32_t off) {
  return 8 * ((off >> 1) & 3) + ((off & 1) ? 0 : 4);
}

// The occurrences an event stands for in its warp's group of equal hashes:
// min(group size, 15) for the group's lowest lane, else 0 (also for an
// invalid event). All 32 lanes call it.
__device__ __forceinline__ uint32_t lead_occ(uint64_t h, bool valid) {
  const unsigned active = __ballot_sync(kFull, valid);
  const unsigned peers =
      __match_any_sync(kFull, static_cast<unsigned long long>(h)) & active;
  if (!valid || static_cast<int>(threadIdx.x & 31) != __ffs(peers) - 1) {
    return 0;
  }
  return min(static_cast<uint32_t>(__popc(peers)), kNibbleMax);
}

// Exclusive prefix sum of x over a block of kBlock threads; *total gets
// the sum. warp_sum holds kBlock / 32 words. Every thread calls it.
template <int kBlock>
__device__ uint32_t block_exclusive(uint32_t x, uint32_t* warp_sum,
                                    uint32_t* total) {
  constexpr int kWarps = kBlock / 32;
  static_assert(kWarps <= 32, "one warp scans the warp sums");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t inc = x;
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += v;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? warp_sum[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t v = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += v;
    }
    if (lane < kWarps) warp_sum[lane] = w;
  }
  __syncthreads();
  *total = warp_sum[kWarps - 1];
  const uint32_t out = inc - x + (warp > 0 ? warp_sum[warp - 1] : 0);
  __syncthreads();
  return out;
}

// Steps 1 and 2 share their tiles: width * per_thread events, the first
// `width` threads of a block (a multiple of 32) taking per_thread events
// each, a thread's hashes loaded kPrefetch at a time; a tile has at most
// kStage records (per_thread * ntables * width <= kStage).
//
// Step 1: a block a tile counts its records per bucket in shared memory
// (hist, nb of them), then reserves each bucket's run for the tile, one
// atomic a bucket (a thread's issued together), and writes the tile's
// place in each bucket to offsets[tile * nb + b]. Also zeroes flags[0,
// nflag).
__global__ void __launch_bounds__(kTileThreads)
nib_count_kernel(const uint64_t* __restrict__ hashes,
                 const __grid_constant__ ByteLayout layout, int64_t nvalid,
                 int64_t nflag, int per_thread, int width, Buckets bk,
                 uint32_t nb, uint32_t* __restrict__ counts,
                 uint32_t* __restrict__ offsets,
                 uint8_t* __restrict__ flags) {
  extern __shared__ uint32_t hist[];
  KHMER_CLOCK_START;
  for (uint32_t b = threadIdx.x; b < nb; b += kTileThreads) hist[b] = 0;
  const int64_t first = blockIdx.x * static_cast<int64_t>(width) * per_thread;
  const int64_t last = first + static_cast<int64_t>(width) * per_thread;
  for (int64_t i = first + threadIdx.x; i < last && i < nflag;
       i += kTileThreads) {
    flags[i] = 0;
  }
  __syncthreads();
  const bool taking = static_cast<int>(threadIdx.x) < width;  // warp-uniform
  for (int k0 = 0; k0 < per_thread; k0 += kPrefetch) {
    uint64_t h[kPrefetch];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int64_t i = first + (k0 + u) * width + threadIdx.x;
      h[u] = taking && k0 + u < per_thread && i < nvalid ? hashes[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      if (k0 + u >= per_thread) break;  // block-uniform
      const int64_t i = first + (k0 + u) * width + threadIdx.x;
      if (lead_occ(h[u], taking && i < nvalid) == 0) continue;
      for (int t = 0; t < layout.ntables; ++t) {
        uint32_t local;
        atomicAdd(&hist[bk.of(counter_index(layout, h[u], t) >> 3, &local)],
                  1u);
      }
    }
  }
  __syncthreads();
  uint32_t* row = offsets + static_cast<int64_t>(blockIdx.x) * nb;
  for (uint32_t b0 = 0; b0 < nb; b0 += kTileThreads * kPrefetch) {
    uint32_t got[kPrefetch];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const uint32_t b = b0 + u * kTileThreads + threadIdx.x;
      const uint32_t c = b < nb ? hist[b] : 0;
      got[u] = c != 0 ? atomicAdd(&counts[b], c) : 0;
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const uint32_t b = b0 + u * kTileThreads + threadIdx.x;
      if (b < nb) row[b] = got[u];
    }
  }
  KHMER_CLOCK(13);
  KHMER_CLOCK_COUNT(14);
}

// Step 2: a block a tile, as step 1 cut them. Dynamic shared memory:
// kStage records, their slots (bucket and place in the tile's run of it)
// and their order by bucket, and two arrays of nb. start[0, nb] gets the
// buckets' starts; the tile's run of bucket b starts at start[b] +
// offsets[tile * nb + b]. The records go out in bucket order, so a warp's
// stores are runs of neighbouring addresses.
__global__ void __launch_bounds__(kTileThreads)
nib_scatter_kernel(const uint64_t* __restrict__ hashes,
                   const __grid_constant__ ByteLayout layout, int64_t nvalid,
                   int per_thread, int width, Buckets bk, uint32_t nb,
                   const uint32_t* __restrict__ counts,
                   const uint32_t* __restrict__ offsets,
                   uint32_t* __restrict__ start,
                   uint64_t* __restrict__ recs) {
  extern __shared__ uint64_t stage[];
  uint32_t* slot = reinterpret_cast<uint32_t*>(stage + kStage);
  uint16_t* order = reinterpret_cast<uint16_t*>(slot + kStage);
  uint32_t* base = reinterpret_cast<uint32_t*>(order + kStage);
  uint32_t* hist = base + nb;
  __shared__ uint32_t warp_sum[kTileThreads / 32];
  KHMER_CLOCK_START;

  // base = the buckets' starts (exclusive prefix sums of counts, a run of
  // buckets a thread) plus the tile's places
  const uint32_t* row = offsets + static_cast<int64_t>(blockIdx.x) * nb;
  const uint32_t per = (nb + kTileThreads - 1) / kTileThreads;
  const uint32_t lo = min(threadIdx.x * per, nb);
  const uint32_t hi = min(lo + per, nb);
  uint32_t sum = 0;
  for (uint32_t b = lo; b < hi; ++b) sum += counts[b];
  uint32_t total;
  uint32_t run = block_exclusive<kTileThreads>(sum, warp_sum, &total);
  for (uint32_t b = lo; b < hi; ++b) {
    base[b] = run + row[b];
    if (blockIdx.x == 0) start[b] = run;
    run += counts[b];
    hist[b] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) start[nb] = total;
  __syncthreads();
  KHMER_CLOCK(8);

  const int ntables = layout.ntables;
  const bool taking = static_cast<int>(threadIdx.x) < width;  // warp-uniform
  const int64_t first = blockIdx.x * static_cast<int64_t>(width) * per_thread;
  for (int k0 = 0; k0 < per_thread; k0 += kPrefetch) {
    uint64_t h[kPrefetch];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int64_t i = first + (k0 + u) * width + threadIdx.x;
      h[u] = taking && k0 + u < per_thread && i < nvalid ? hashes[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int k = k0 + u;
      if (k >= per_thread) break;  // block-uniform
      const int64_t i = first + k * width + threadIdx.x;
      const uint32_t occ = lead_occ(h[u], taking && i < nvalid);
      if (!taking) continue;
      for (int t = 0; t < ntables; ++t) {
        // lane-contiguous, so a warp's stores meet no bank twice
        const int at_s = (k * ntables + t) * width + threadIdx.x;
        uint32_t at = kNoSlot;
        if (occ != 0) {
          const uint64_t key = counter_index(layout, h[u], t);
          uint32_t local;
          const uint32_t b = bk.of(key >> 3, &local);
          at = b << kSlotBits | atomicAdd(&hist[b], 1u);
          stage[at_s] = make_record(
              8 * local + static_cast<uint32_t>(key & 7), occ,
              static_cast<uint32_t>(i));
        }
        slot[at_s] = at;
      }
    }
  }
  __syncthreads();
  KHMER_CLOCK(9);
  // hist becomes the runs' starts in the tile's bucket order
  sum = 0;
  for (uint32_t b = lo; b < hi; ++b) sum += hist[b];
  run = block_exclusive<kTileThreads>(sum, warp_sum, &total);
  for (uint32_t b = lo; b < hi; ++b) {
    const uint32_t c = hist[b];
    hist[b] = run;
    run += c;
  }
  __syncthreads();
  KHMER_CLOCK(10);
  const int staged = per_thread * ntables * width;
  for (int s = threadIdx.x; s < staged; s += kTileThreads) {
    const uint32_t at = slot[s];
    if (at != kNoSlot) {
      order[hist[at >> kSlotBits] + (at & ((1u << kSlotBits) - 1))] =
          static_cast<uint16_t>(s);
    }
  }
  __syncthreads();
  for (uint32_t x = threadIdx.x; x < total; x += kTileThreads) {
    const int s = order[x];
    const uint32_t at = slot[s];
    recs[base[at >> kSlotBits] + (at & ((1u << kSlotBits) - 1))] = stage[s];
  }
  KHMER_CLOCK(11);
  KHMER_CLOCK_COUNT(12);
}

// Step 3's shared memory: two entry buffers and the radix counters.
struct BucketSmem {
  uint64_t buf[2][kCap];
  uint32_t cnt[kCounters];
};

__device__ __forceinline__ uint32_t digit(uint64_t r, uint32_t base,
                                          int shift) {
  return ((off_of(r) - base) >> shift) & (kRadix - 1);
}

// One stable radix pass of src[0, m) into dst by the digit of (offset -
// base) at `shift`. Warp w ranks entries [w * 32 * kChunks, (w + 1) * 32 *
// kChunks) in order, 32 at a time: equal digits of a chunk meet by
// __match_any_sync, and cnt[w * kRadix + digit] keeps the warp's running
// count (warp-major, so a chunk's random digits spread over the banks).
// The counters' exclusive scan in digit-major order, (digit, warp), then
// places each entry after every entry of a lower digit or of an earlier
// warp or chunk with its digit.
__device__ void radix_pass(const uint64_t* src, uint64_t* dst, int m,
                           uint32_t base, int shift, uint32_t* cnt,
                           uint32_t* warp_sum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* mine = cnt + warp * kRadix;
  for (int c = threadIdx.x; c < kCounters; c += kThreadsB) cnt[c] = 0;
  __syncthreads();
  const int first = warp * 32 * kChunks;
  const unsigned below = (1u << lane) - 1;
  uint32_t rank[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    rank[c] = 0;
    if (first + c * 32 >= m) continue;  // warp-uniform
    const int j = first + c * 32 + lane;
    const bool valid = j < m;
    const uint32_t d = valid ? digit(src[j], base, shift) : kFull;
    const unsigned peers =
        __match_any_sync(kFull, d) & __ballot_sync(kFull, valid);
    uint32_t prior = 0;
    if (valid) prior = mine[d];
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) mine[d] = prior + __popc(peers);
    __syncwarp();
    rank[c] = prior + __popc(peers & below);
  }
  __syncthreads();
  // thread t scans digit t / (kWarpsB / kRun) over kRun warps
  constexpr int kSplit = kWarpsB / kRun;
  uint32_t* col = cnt + (threadIdx.x / kSplit)
                  + (threadIdx.x % kSplit) * kRun * kRadix;
  uint32_t sum = 0;
#pragma unroll
  for (int k = 0; k < kRun; ++k) sum += col[k * kRadix];
  uint32_t total;
  uint32_t at = block_exclusive<kThreadsB>(sum, warp_sum, &total);
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const uint32_t c = col[k * kRadix];
    col[k * kRadix] = at;
    at += c;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = first + c * 32 + lane;
    if (j < m) {
      const uint64_t r = src[j];
      dst[mine[digit(r, base, shift)] + rank[c]] = r;
    }
  }
  __syncthreads();
}

// Sort s.buf[cur][0, m) by (offset - base), `bits` wide; returns the
// buffer that holds them. A counting sort into kCounters bins of the
// offset's top bits (a bin at least a word), then each bin by insertion, a
// thread a bin: one pass where the offsets spread, as a bucket's do. Where
// a bin holds more than kBinMax entries, LSD radix passes instead.
// `largest` is a shared word.
__device__ int sort_entries(BucketSmem& s, int cur, int m, uint32_t base,
                            int bits, uint32_t* warp_sum, uint32_t* largest) {
  if (m < 2) return cur;
  const int shift = bits - kBinBits > 3 ? bits - kBinBits : 3;
  const uint64_t* src = s.buf[cur];
  uint64_t* dst = s.buf[cur ^ 1];
  uint32_t* hist = s.cnt;
  for (int b = threadIdx.x; b < kCounters; b += kThreadsB) hist[b] = 0;
  if (threadIdx.x == 0) *largest = 0;
  __syncthreads();
  uint32_t slot[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.x + k * kThreadsB;
    if (j < m) {
      slot[k] = atomicAdd(&hist[(off_of(src[j]) - base) >> shift], 1u);
    }
  }
  __syncthreads();
  uint32_t* mine = hist + threadIdx.x * kRun;
  uint32_t sum = 0;
  uint32_t most = 0;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    sum += mine[k];
    most = max(most, mine[k]);
  }
  most = __reduce_max_sync(kFull, most);
  if ((threadIdx.x & 31) == 0) atomicMax(largest, most);
  uint32_t total;
  uint32_t at = block_exclusive<kThreadsB>(sum, warp_sum, &total);
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const uint32_t c = mine[k];
    mine[k] = at;
    at += c;
  }
  __syncthreads();
  if (*largest > kBinMax) {
    for (int sh = 0; sh < bits; sh += kRadixBits) {
      radix_pass(s.buf[cur], s.buf[cur ^ 1], m, base, sh, s.cnt, warp_sum);
      cur ^= 1;
    }
    return cur;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.x + k * kThreadsB;
    if (j < m) {
      const uint64_t r = src[j];
      dst[hist[(off_of(r) - base) >> shift] + slot[k]] = r;
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kCounters; b += kThreadsB) {
    const int lo = static_cast<int>(hist[b]);
    const int hi = b + 1 < kCounters ? static_cast<int>(hist[b + 1]) : m;
    for (int i = lo + 1; i < hi; ++i) {
      const uint64_t r = dst[i];
      int j = i - 1;
      while (j >= lo && off_of(dst[j]) > off_of(r)) {
        dst[j + 1] = dst[j];
        --j;
      }
      dst[j + 1] = r;
    }
  }
  __syncthreads();
  return cur ^ 1;
}

__device__ __forceinline__ bool starts(const uint64_t* e, int j,
                                       uint32_t shift) {
  return j == 0 || (off_of(e[j]) >> shift) != (off_of(e[j - 1]) >> shift);
}

// Merge the runs of equal nibbles of sorted src[0, m) into one entry each
// (occurrences summed to at most 15, the lowest event), appended to dst at
// *count (zeroed here; the order does not matter, the entries are sorted
// again); returns their count. Entry j is thread j % kThreadsB's, with
// the run it starts.
__device__ int merge_runs(const uint64_t* src, uint64_t* dst, int m,
                          uint32_t* count) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.x + k * kThreadsB;
    const bool head = j < m && starts(src, j, 0);
    uint64_t merged = 0;
    if (head) {
      const uint32_t off = off_of(src[j]);
      uint32_t occ = 0;
      uint32_t ev = kEventMask;
      for (int x = j; x < m && off_of(src[x]) == off; ++x) {
        occ = min(occ + occ_of(src[x]), kNibbleMax);
        ev = min(ev, ev_of(src[x]));
      }
      merged = make_record(off, occ, ev);
    }
    const unsigned mask = __ballot_sync(kFull, head);
    if (mask == 0) continue;  // warp-uniform
    uint32_t at = 0;
    if (lane == 0) at = atomicAdd(count, static_cast<uint32_t>(__popc(mask)));
    at = __shfl_sync(kFull, at, 0);
    if (head) dst[at + __popc(mask & ((1u << lane) - 1))] = merged;
  }
  __syncthreads();
  return static_cast<int>(*count);
}


// Commit sorted e[0, m): each word's run is the thread's that owns its
// first entry (entry j is thread j % kThreadsB's, so a warp reads 32
// neighbouring entries and words in address order); a thread's word reads
// are issued before any is used, and each changed word is stored once.
// A nibble that was 0 sets its lowest event's flag byte to 1 (a plain
// store: every writer stores 1).
__device__ void commit(const uint64_t* e, int m, uint32_t* words,
                       uint8_t* flags) {
  uint32_t old[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.x + k * kThreadsB;
    old[k] = 0;
    if (j < m && starts(e, j, 3)) old[k] = words[off_of(e[j]) >> 3];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.x + k * kThreadsB;
    if (j >= m || !starts(e, j, 3)) continue;
    const uint32_t w = off_of(e[j]) >> 3;
    uint32_t word = old[k];
    int x = j;
    while (x < m && (off_of(e[x]) >> 3) == w) {
      const uint32_t off = off_of(e[x]);
      uint32_t occ = 0;
      uint32_t ev = kEventMask;
      for (; x < m && off_of(e[x]) == off; ++x) {
        occ = min(occ + occ_of(e[x]), kNibbleMax);
        ev = min(ev, ev_of(e[x]));
      }
      const uint32_t shift = nibble_shift(off);
      const uint32_t was = (old[k] >> shift) & kNibbleMax;
      const uint32_t post = min(was + occ, kNibbleMax);
      word = (word & ~(kNibbleMax << shift)) | post << shift;
      if (was == 0) flags[ev] = 1;
    }
    if (word != old[k]) words[w] = word;
  }
}

// Append the records of recs[p, end) whose word lies in [rlo, rhi) to dst
// at *count (end - p <= kCap, and the room is there); a warp's records that
// all share one offset (one hash many times) go in as one entry
// (occurrences summed to at most 15, the lowest event). A thread's kPer
// loads are issued together.
__device__ void append(uint64_t* dst, const uint64_t* __restrict__ recs,
                       uint32_t p, uint32_t end, uint32_t rlo, uint32_t rhi,
                       uint32_t* count) {
  const int lane = threadIdx.x & 31;
  uint64_t r[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const uint32_t j = p + u * kThreadsB + threadIdx.x;
    r[u] = j < end ? recs[j] : 0;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const uint32_t j = p + u * kThreadsB + threadIdx.x;
    const uint32_t off = off_of(r[u]);
    const bool in = j < end && (off >> 3) >= rlo && (off >> 3) < rhi;
    const unsigned inside = __ballot_sync(kFull, in);
    if (inside == 0) continue;  // warp-uniform
    const uint32_t off0 = __shfl_sync(kFull, off, __ffs(inside) - 1);
    if (__all_sync(kFull, !in || off == off0)) {
      const uint32_t occ =
          __reduce_add_sync(kFull, in ? occ_of(r[u]) : 0u);
      const uint32_t ev =
          __reduce_min_sync(kFull, in ? ev_of(r[u]) : kEventMask);
      if (lane == 0) {
        dst[atomicAdd(count, 1u)] = make_record(off0, min(occ, kNibbleMax),
                                                ev);
      }
      continue;
    }
    uint32_t at = 0;
    if (lane == 0) {
      at = atomicAdd(count, static_cast<uint32_t>(__popc(inside)));
    }
    at = __shfl_sync(kFull, at, 0);
    if (in) dst[at + __popc(inside & ((1u << lane) - 1))] = r[u];
  }
}

// The least and greatest word of the records in recs[lo, hi) whose word
// lies in [rlo, rhi), into *least and *most.
__device__ void word_bounds(const uint64_t* __restrict__ recs, uint32_t lo,
                            uint32_t hi, uint32_t rlo, uint32_t rhi,
                            uint32_t* least, uint32_t* most) {
  if (threadIdx.x == 0) {
    *least = kFull;
    *most = 0;
  }
  __syncthreads();
  uint32_t mn = kFull;
  uint32_t mx = 0;
  for (uint32_t p = lo; p < hi; p += kCap) {
    uint64_t r[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const uint32_t j = p + u * kThreadsB + threadIdx.x;
      r[u] = j < hi ? recs[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const uint32_t j = p + u * kThreadsB + threadIdx.x;
      const uint32_t w = off_of(r[u]) >> 3;
      if (j < hi && w >= rlo && w < rhi) {
        mn = min(mn, w);
        mx = max(mx, w);
      }
    }
  }
  mn = __reduce_min_sync(kFull, mn);
  mx = __reduce_max_sync(kFull, mx);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(least, mn);
    atomicMax(most, mx);
  }
  __syncthreads();
}

// Words [a, z) of a bucket, z - a <= kDenseWords: every record of
// recs[lo, hi) in them adds its occurrences (saturating) and lowest event
// to its nibble's slot in shared memory; then a thread a word commits, the
// reads issued first, flags as commit() sets them.
__device__ void dense(BucketSmem& s, const uint64_t* __restrict__ recs,
                      uint32_t lo, uint32_t hi, uint32_t a, uint32_t z,
                      uint32_t* words, uint8_t* flags) {
  uint32_t* first = reinterpret_cast<uint32_t*>(s.buf[0]);
  uint32_t* occ = reinterpret_cast<uint32_t*>(s.buf[1]);
  const uint32_t n = 8 * (z - a);
  for (uint32_t i = threadIdx.x; i < n; i += kThreadsB) {
    first[i] = kEventMask;
    occ[i] = 0;
  }
  __syncthreads();
  for (uint32_t p = lo; p < hi; p += kCap) {
    uint64_t r[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const uint32_t j = p + u * kThreadsB + threadIdx.x;
      r[u] = j < hi ? recs[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const uint32_t j = p + u * kThreadsB + threadIdx.x;
      const uint32_t w = off_of(r[u]) >> 3;
      if (j >= hi || w < a || w >= z) continue;
      const uint32_t i = off_of(r[u]) - 8 * a;
      // saturation keeps the sum far from wrapping; a slot read first
      // spares a hot nibble's atomics
      if (occ[i] < kNibbleMax) atomicAdd(&occ[i], occ_of(r[u]));
      if (ev_of(r[u]) < first[i]) atomicMin(&first[i], ev_of(r[u]));
    }
  }
  __syncthreads();
  constexpr int kWords = (kDenseWords + kThreadsB - 1) / kThreadsB;
  uint32_t old[kWords];
  bool touched[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint32_t w = threadIdx.x + k * kThreadsB;
    touched[k] = false;
    old[k] = 0;
    if (w < z - a) {
      for (int q = 0; q < 8; ++q) touched[k] |= occ[8 * w + q] != 0;
      if (touched[k]) old[k] = words[a + w];
    }
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    if (!touched[k]) continue;
    const uint32_t w = threadIdx.x + k * kThreadsB;
    uint32_t word = old[k];
    for (uint32_t q = 0; q < 8; ++q) {
      const uint32_t c = occ[8 * w + q];
      if (c == 0) continue;
      const uint32_t shift = nibble_shift(q);
      const uint32_t was = (old[k] >> shift) & kNibbleMax;
      const uint32_t post = min(was + c, kNibbleMax);
      word = (word & ~(kNibbleMax << shift)) | post << shift;
      if (was == 0) flags[first[8 * w + q]] = 1;
    }
    if (word != old[k]) words[a + w] = word;
  }
  __syncthreads();
}

// ceil(log2(n)) for n >= 1
__device__ __forceinline__ int ceil_log2(uint32_t n) {
  return n <= 1 ? 0 : 32 - __clz(n - 1);
}

// Step 3: one block of kThreadsB per bucket (grid = the buckets in use),
// sizeof(BucketSmem) of dynamic shared memory. words is the flat buffer as
// nwords 32-bit words; flags the events' flag bytes.
__global__ void __launch_bounds__(kThreadsB, 2)
nib_bucket_kernel(const uint64_t* __restrict__ recs,
                  const uint32_t* __restrict__ start, Buckets bk,
                  uint64_t nwords, uint32_t* __restrict__ words,
                  uint8_t* __restrict__ flags) {
  extern __shared__ uint64_t smem[];
  BucketSmem& s = *reinterpret_cast<BucketSmem*>(smem);
  __shared__ uint32_t warp_sum[kWarpsB];
  __shared__ uint32_t stack_lo[kStack];
  __shared__ uint32_t stack_hi[kStack];
  __shared__ int top;
  __shared__ uint32_t count;
  __shared__ uint32_t least;
  __shared__ uint32_t most;
  __shared__ uint32_t largest;

  const uint32_t lo = start[blockIdx.x];
  const uint32_t hi = start[blockIdx.x + 1];
  if (lo == hi) return;
  KHMER_CLOCK_START;
  const uint64_t first_word = blockIdx.x * bk.span;
  const uint64_t left = nwords - first_word;
  uint32_t* bucket_words = words + first_word;
  const uint32_t span = static_cast<uint32_t>(left < bk.span ? left
                                                             : bk.span);
  if (span <= kDenseWords) {
    // small tables: the whole bucket in one dense pass, no sort
    dense(s, recs, lo, hi, 0, span, bucket_words, flags);
    KHMER_CLOCK(4);
    KHMER_CLOCK_COUNT(6);
    return;
  }
  if (threadIdx.x == 0) {
    top = 1;
    stack_lo[0] = 0;
    stack_hi[0] = span;
  }
  for (;;) {
    __syncthreads();
    if (top == 0) break;
    const uint32_t rlo = stack_lo[top - 1];
    const uint32_t rhi = stack_hi[top - 1];
    __syncthreads();
    if (threadIdx.x == 0) {
      --top;
      count = 0;
    }
    __syncthreads();
    const uint32_t base = 8 * rlo;
    const int bits = 3 + ceil_log2(rhi - rlo);
    int cur = 0;
    int m = 0;
    bool overflow = false;
    for (uint32_t p = lo; p < hi;) {
      int room = kCap - m;
      if (room < kCap / 2) {
        cur = sort_entries(s, cur, m, base, bits, warp_sum, &largest);
        KHMER_CLOCK(1);
        m = merge_runs(s.buf[cur], s.buf[cur ^ 1], m, &count);
        cur ^= 1;
        KHMER_CLOCK(2);
        if (m > kCap / 2) {
          overflow = true;
          break;
        }
        room = kCap - m;
      }
      const uint32_t end = hi - p < static_cast<uint32_t>(room)
                               ? hi : p + static_cast<uint32_t>(room);
      append(s.buf[cur], recs, p, end, rlo, rhi, &count);
      __syncthreads();
      KHMER_CLOCK(0);
      m = static_cast<int>(count);
      p = end;
    }
    if (!overflow) {
      cur = sort_entries(s, cur, m, base, bits, warp_sum, &largest);
      KHMER_CLOCK(1);
      commit(s.buf[cur], m, bucket_words, flags);
      __syncthreads();
      KHMER_CLOCK(3);
      continue;
    }
    // too many distinct nibbles: measure the range, then a dense pass or
    // two halves
    word_bounds(recs, lo, hi, rlo, rhi, &least, &most);
    const uint32_t a = least;
    const uint32_t z = most + 1;
    if (z - a <= kDenseWords) {
      dense(s, recs, lo, hi, a, z, bucket_words, flags);
      KHMER_CLOCK(4);
      continue;
    }
    if (threadIdx.x == 0) {
      const uint32_t mid = a + (z - a) / 2;
      stack_lo[top] = mid;
      stack_hi[top] = z;
      stack_lo[top + 1] = a;
      stack_hi[top + 1] = mid;
      top += 2;
    }
    KHMER_CLOCK(4);
  }
  KHMER_CLOCK(5);
  KHMER_CLOCK_COUNT(6);
}

// Step 4: *n_new grows by the flags set; a thread a word of four flag
// bytes, each 0 or 1, so its popcount counts them.
__global__ void __launch_bounds__(kTileThreads)
nib_count_new_kernel(const uint32_t* __restrict__ flagw, int64_t nwords,
                     unsigned long long* __restrict__ n_new) {
  __shared__ uint32_t block_sum;
  if (threadIdx.x == 0) block_sum = 0;
  __syncthreads();
  const int64_t i = blockIdx.x * static_cast<int64_t>(kTileThreads)
                    + threadIdx.x;
  const uint32_t c = __reduce_add_sync(
      kFull, i < nwords ? static_cast<uint32_t>(__popc(flagw[i])) : 0u);
  if ((threadIdx.x & 31) == 0 && c != 0) atomicAdd(&block_sum, c);
  __syncthreads();
  if (threadIdx.x == 0 && block_sum != 0) {
    atomicAdd(n_new, static_cast<unsigned long long>(block_sum));
  }
}

}  // namespace
}  // namespace khmer_nibble

// Update the joined nibble tables `flat` (`size` bytes, a multiple of 4,
// 4-byte aligned) in place with hashes[0:nvalid] and add the new count to
// *n_unique. primes/nibble_offsets are HOST arrays of ntables (the offsets
// in nibbles). recs [nvalid * ntables], counts [nbuckets], start
// [nbuckets + 1] and offsets [max_tiles * nbuckets] are the chunk's scratch
// (core/sketch_kernels.py nibble_update_plan); flags [round up(nvalid, 4)
// bytes, 4-byte aligned] gets each event's new flag.
extern "C" int khmer_nibble_update(uint8_t* flat, int64_t size, int ntables,
                                   const int64_t* primes,
                                   const int64_t* nibble_offsets,
                                   const int64_t* hashes, int64_t nvalid,
                                   int nbuckets, int64_t max_tiles,
                                   void* recs, void* counts, void* start,
                                   void* offsets, uint8_t* flags,
                                   int64_t* n_unique, int device,
                                   void* stream) {
  using namespace khmer_nibble;
  ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, nibble_offsets, &layout)
      || size <= 0 || size % 4 != 0
      || reinterpret_cast<uintptr_t>(flat) % 4 != 0
      || reinterpret_cast<uintptr_t>(flags) % 4 != 0 || nvalid < 0
      || nvalid > kEventMask || nvalid * ntables >= (int64_t{1} << 31)
      || nbuckets < 1 || static_cast<uint32_t>(nbuckets) > kMaxBuckets) {
    return cudaErrorInvalidValue;
  }
  const uint64_t nwords = static_cast<uint64_t>(size) / 4;
  const uint64_t span = (nwords + nbuckets - 1) / nbuckets;
  if (span > kMaxSpanWords) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nvalid == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const Buckets bk{span, ~0ULL / span};
  const auto nb = static_cast<uint32_t>((nwords + span - 1) / span);
  auto* cnt = static_cast<uint32_t*>(counts);
  if ((err = cudaMemsetAsync(cnt, 0, sizeof(uint32_t) * nb, s))
      != cudaSuccess) {
    return err;
  }
  const int count_smem = static_cast<int>(nb * sizeof(uint32_t));
  const int scatter_smem = static_cast<int>(
      kStage * (sizeof(uint64_t) + sizeof(uint32_t) + sizeof(uint16_t))
      + 2 * nb * sizeof(uint32_t));
  const int bucket_smem = static_cast<int>(sizeof(BucketSmem));
  if ((err = cudaFuncSetAttribute(
           nib_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           count_smem)) != cudaSuccess
      || (err = cudaFuncSetAttribute(
              nib_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
              scatter_smem)) != cudaSuccess
      || (err = cudaFuncSetAttribute(
              nib_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
              bucket_smem)) != cudaSuccess) {
    return err;
  }
  const int64_t nflag = (nvalid + 3) / 4 * 4;
  // a tile's records fill the stage: per_thread events for each of the
  // block's threads, or (more than kStage / kTileThreads tables) one event
  // for each of its first `width` threads (core/sketch_kernels.py
  // nibble_tiles)
  const bool wide = kTileThreads * ntables <= kStage;
  const int per_thread = wide ? kStage / (kTileThreads * ntables) : 1;
  const int width = wide ? kTileThreads : kStage / ntables / 32 * 32;
  const int64_t per_tile = int64_t{width} * per_thread;
  const auto tiles = static_cast<unsigned>((nvalid + per_tile - 1)
                                           / per_tile);
  if (static_cast<int64_t>(tiles) > max_tiles) return cudaErrorInvalidValue;
  auto* offs = static_cast<uint32_t*>(offsets);
  nib_count_kernel<<<tiles, kTileThreads, count_smem, s>>>(
      reinterpret_cast<const uint64_t*>(hashes), layout, nvalid, nflag,
      per_thread, width, bk, nb, cnt, offs, flags);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  nib_scatter_kernel<<<tiles, kTileThreads, scatter_smem, s>>>(
      reinterpret_cast<const uint64_t*>(hashes), layout, nvalid, per_thread,
      width, bk, nb, cnt, offs, static_cast<uint32_t*>(start),
      static_cast<uint64_t*>(recs));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  nib_bucket_kernel<<<nb, kThreadsB, bucket_smem, s>>>(
      static_cast<const uint64_t*>(recs),
      static_cast<const uint32_t*>(start), bk, nwords,
      reinterpret_cast<uint32_t*>(flat), flags);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t flag_words = nflag / 4;
  nib_count_new_kernel<<<static_cast<unsigned>((flag_words + kTileThreads - 1)
                                               / kTileThreads),
                         kTileThreads, 0, s>>>(
      reinterpret_cast<const uint32_t*>(flags), flag_words,
      reinterpret_cast<unsigned long long*>(n_unique));
  return cudaGetLastError();
}

#ifdef KHMER_NIBBLE_CLOCKS
// The diagnostic build's phase cycles (16 slots) into out, then zeroed.
extern "C" int khmer_nibble_clocks(unsigned long long* out) {
  using khmer_nibble::g_clocks;
  cudaError_t err = cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
  if (err != cudaSuccess) return err;
  unsigned long long zero[16] = {};
  return cudaMemcpyToSymbol(g_clocks, zero, sizeof(g_clocks));
}
#endif
