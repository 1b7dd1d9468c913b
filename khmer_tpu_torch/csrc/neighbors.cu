// Kernel L: the 8-neighbour probe of the bit tables, and their gather;
// kernel N: the same probe of the byte tables, with an abundance band.
//
// Replaces khmer_tpu/core/graphmixin.py:30-59 (make_neighbors_fn), an XLA
// function on the TPU, which builds each k-mer's four right and four left
// neighbours by 2-bit shifts and tests them in the bit tables through
// khmer_tpu/core/sketch_kernels.py:649 (_gather_counts, bit branch); the
// gather mode replaces that branch alone. Its plain PyTorch versions are
// khmer_tpu_torch/core/sketch_kernels.py: neighbors_plain and
// bit_gather_plain. The partition walk (csrc/tag_walk.cc) probes each
// level's survivors here.
//
// What it computes. For node i, (f, r) = (f[i], r[i]) and the k-mer mask
// M = 4^k - 1 (all ones at k = 32), neighbour j < 4 is
// (((f << 2) | j) & M, (r >> 2) | ((j ^ 1) << (2k - 2))), the k-mer to the
// right with base j, and neighbour 4 + j is ((f >> 2) | (j << (2k - 2)),
// ((r << 2) | (j ^ 1)) & M), to the left (reference hashgraph.hh:67-71).
// It is present iff the bit canon % p_t is set in each of the T tables,
// canon = min(nf, nr), in the port's joined bit buffer (sketch_kernels.py
// BitTables: flat bit 8 * offset_t + canon % p_t). out[i] has bit j set iff
// neighbour j is present. It writes no neighbours: the host rebuilds them
// from (f, r), so a node moves 16 B up and 1 B back. The gather mode
// writes, for each hash, 1 iff its own bit is set in every table (int32,
// as _gather_counts returns it).
//
// What bounds it: random bit reads. A probe of the 8 neighbours in T
// tables far larger than L2 (4 GB at -x 8e9 -N 4) reads a 32-byte sector
// for each bit it loads, so the floor is the distinct sectors a launch
// must read, well above its 17 B a node. A Bloom-filter probe is an AND
// over the tables, so the function needs table t only for the neighbours
// set in tables 0..t-1 (khmer's BitStorage stops at the first 0 bit):
// in a de Bruijn graph 2-3 of a node's 8 neighbours are present, so table
// 0 is most of it (on 10b's largest frontier 11 distinct sectors a node,
// against 22 for every table). And the partition walk probes a level at
// a time: a third of 10b's 3,078 launches probe fewer than 4,096 nodes,
// too few threads to keep the card's loads in flight.
//
// Design: eight lanes a node, one a neighbour (so a frontier of n nodes
// runs 8n threads), each probing its canonical value in stages: table 0
// first (kFirst tables), then, while set, kGroup more tables at a time,
// all loads of a stage issued before any is used; at T = 4 a lane waits
// at most two round trips and loads tables 1-3 only where table 0's bit
// is set. The node's byte is assembled by __ballot_sync; the four lanes
// of a node whose bits share a sector (the right neighbours' forward
// values are consecutive, as are the left ones' reverse values) load it
// in one warp request. The gather mode is one lane a hash, by the same
// rule. h % p_t is by the reciprocal the host computes (byte_common.cuh
// counter_index), the joined buffer's bit offsets passed in place of its
// byte offsets, as kernel J does. scripts/partition_cases.py probe_stages
// mirrors the rule; scripts/probe_bench.py builds the designs measured
// against it (PERF.md, kernel L).
//
// Kernel N replaces the byte branch of the same XLA function
// (khmer_tpu/core/graphmixin.py:30 make_neighbors_fn on a Countgraph, its
// presence from khmer_tpu/core/sketch_kernels.py:649 _gather_counts, byte
// branch: a neighbour is present where its least counter is above 0) and
// the count filter of the abundance-truncated walk
// (khmer_tpu/core/partition.py:186-193: the count, with the bigcount
// fix-up, in [min_count, max_count]). Its plain PyTorch version is
// khmer_tpu_torch/core/sketch_kernels.py byte_neighbors_plain. Bit j of
// out[i] is set iff neighbour j's least counter m over the T byte tables
// (sketch_kernels.py ByteTables) is at least 1. Given `band_out`, bit j of
// band_out[i] is set iff max(lo, 1) <= m <= hi, where a count of 255 is
// the bigcount table's count for the hash where the table has it
// (sketch_kernels.py bigcount_table, as kernel H reads it): the abundance
// walk queues every present child and rejects an out-of-band one when it
// pops it (csrc/tag_walk.cc), as the reference does.
//
// What bounds it: random byte reads, a 32-byte sector each, as for L; its
// byte bound is L's 17 B a node (with the band byte, 18). It has two
// modes, chosen by the level's size (the caller's crossover,
// sketch_kernels.NBR_SMALL_NODES). The staged mode, for large levels, is
// L's lanes and staging: since m <= c0, a lane whose table-0 counter is 0
// stops there; the others load kGroup more tables a stage while their
// least stays above 0. In a de Bruijn graph most of a node's 8 neighbours
// are absent, so table 0 is most of the loads, and a large level (phase
// 12's 2,977,731 nodes) runs at L2's random-request rate, where fewer
// requests is what counts. A walk's levels are mostly small (12b's
// average 2,230 nodes): eight lanes a node then fill a fraction of the
// card, and each lane waits on two dependent round trips (table 0, then
// tables 1-3). The small mode loads all 8 x T counters of a node at once,
// a lane a (neighbour, table) pair (a warp a node at T = 4; beyond four
// tables, T / 4 tables a lane), takes each neighbour's least by
// __shfl_xor_sync over its lanes, and so waits one round trip, in blocks
// of kSmallThreads that spread a 2,000-node level over every SM. In both
// modes the bytes are assembled by __ballot_sync, a saturated counter
// fails a band with hi < 255 without a lookup, and the bigcount table is
// searched only by a lane whose least is 255.
//
// N's nibble mode replaces the nibble branch of the same XLA function
// (make_neighbors_fn on a SmallCountgraph, its presence from
// _gather_counts' nibble branch, sketch_kernels.py:660-668) and its count
// filter; its plain PyTorch version is sketch_kernels.py
// nibble_neighbors_plain. The tables are kernel P's 4-bit counters
// (nibble_update.cu): table t's counter b is the high nibble of byte
// offset_t + b / 2 for an even b, the low one for an odd b; the layout's
// offsets are passed in nibbles, so one reduction gives byte and parity,
// as kernel Q reads them. Presence is the least counter above 0; a band
// [lo, hi] is tested on the 4-bit count, which saturates at 15 (no
// bigcount). The mode is the byte mode's two shapes, staged and small,
// with the counter read from its nibble.
//
// The walks' round trip. A level walk (csrc/level_walk.cc kt_level_run)
// calls khmer_byte_probe_level (N), khmer_nibble_probe_level (N's nibble
// mode) or khmer_bit_probe_level (L) on a probe context made once a walk
// (khmer_probe_ctx_new): the layout kind, the layout with
// its reciprocals, the band and the bigcount table, grow-only pinned host
// and device blocks and the stream. The walk writes each frontier into the
// pinned block (khmer_probe_block); a level then costs one copy up, the
// kernel, one copy back and a stream sync, with no allocation and no
// Python.

#include <algorithm>
#include <chrono>
#include <cstring>

#include "byte_common.cuh"
#include "level_block.h"

namespace khmer_nbr {
namespace {

using khmer_byte::big_count;
using khmer_byte::ByteLayout;
using khmer_byte::counter_index;
using khmer_cuda::kMaxCount;
using khmer_cuda::kThreads;
using khmer_cuda::thread_index;

constexpr int kFirst = 1;  // tables the first stage loads
constexpr int kGroup = 4;  // tables each later stage loads, while set

// Whether h's bit is set in tables [t0, t0 + kWidth) (a bit of an absent
// table reads 1), every load issued before any is used.
template <int kWidth>
__device__ __forceinline__ bool stage_set(const ByteLayout& layout,
                                          const uint8_t* flat, uint64_t h,
                                          int t0) {
  uint8_t v[kWidth];
#pragma unroll
  for (int g = 0; g < kWidth; ++g) {
    v[g] = 1;
    if (t0 + g < layout.ntables) {
      const uint64_t b = counter_index(layout, h, t0 + g);
      v[g] = flat[b >> 3] >> (b & 7) & 1;
    }
  }
  bool set = true;
#pragma unroll
  for (int g = 0; g < kWidth; ++g) set = set && v[g];
  return set;
}

// Whether h's bit is set in every table, the tables in stages.
__device__ __forceinline__ bool present(const ByteLayout& layout,
                                        const uint8_t* flat, uint64_t h) {
  if (!stage_set<kFirst>(layout, flat, h, 0)) return false;
  for (int t0 = kFirst; t0 < layout.ntables; t0 += kGroup) {
    if (!stage_set<kGroup>(layout, flat, h, t0)) return false;
  }
  return true;
}

// The canonical value of neighbour j of the node (fi, ri).
__device__ __forceinline__ uint64_t neighbor_canon(uint64_t fi, uint64_t ri,
                                                   int j, uint64_t mask,
                                                   int shift) {
  const uint64_t b = j & 3;
  uint64_t nf, nr;
  if (j < 4) {  // to the right with base b
    nf = ((fi << 2) | b) & mask;
    nr = (ri >> 2) | ((b ^ 1) << shift);
  } else {  // to the left
    nf = (fi >> 2) | (b << shift);
    nr = ((ri << 2) | (b ^ 1)) & mask;
  }
  return nf < nr ? nf : nr;
}

// Thread 8 i + j probes neighbour j of node i; lane 8 q of each warp
// writes node q's byte.
__global__ void __launch_bounds__(kThreads)
neighbors_kernel(const uint64_t* __restrict__ f,
                 const uint64_t* __restrict__ r, int64_t n, uint64_t mask,
                 int shift, const __grid_constant__ ByteLayout layout,
                 const uint8_t* __restrict__ flat, uint8_t* __restrict__ out) {
  const int64_t i = thread_index() >> 3;
  const int j = threadIdx.x & 7;
  bool set = false;
  if (i < n) {
    set = present(layout, flat, neighbor_canon(f[i], r[i], j, mask, shift));
  }
  const unsigned bits = __ballot_sync(~0u, set);
  if (i < n && j == 0) {
    out[i] = static_cast<uint8_t>(bits >> (threadIdx.x & 24));
  }
}

__global__ void __launch_bounds__(kThreads)
bit_gather_kernel(const uint64_t* __restrict__ hashes, int64_t n,
                  const __grid_constant__ ByteLayout layout,
                  const uint8_t* __restrict__ flat, int32_t* __restrict__ out) {
  const int64_t i = thread_index();
  if (i >= n) return;
  const uint64_t h = hashes[i];
  out[i] = static_cast<int32_t>(present(layout, flat, h));
}

// h's counter in table t: a byte, or (kNibble) the nibble at the flat
// nibble index, the high one of its byte for an even index.
template <bool kNibble>
__device__ __forceinline__ int counter(const ByteLayout& layout,
                                       const uint8_t* flat, uint64_t h,
                                       int t) {
  const uint64_t b = counter_index(layout, h, t);
  if (!kNibble) return flat[b];
  const unsigned v = flat[b >> 1];
  return static_cast<int>((b & 1) ? v & 0xFu : v >> 4);
}

// Kernel N's counter rule: the least of h's counters over the tables,
// table 0 first, then kGroup tables a stage while the least so far is
// above 0.
template <bool kNibble>
__device__ __forceinline__ int least_count(const ByteLayout& layout,
                                           const uint8_t* flat, uint64_t h) {
  int m = counter<kNibble>(layout, flat, h, 0);
  for (int t0 = kFirst; t0 < layout.ntables && m > 0; t0 += kGroup) {
    int v[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      v[g] = kMaxCount;
      if (t0 + g < layout.ntables) {
        v[g] = counter<kNibble>(layout, flat, h, t0 + g);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) m = min(m, v[g]);
  }
  return m;
}

// Kernel N: thread 8 i + j tests neighbour j of node i; lane 8 q of each
// warp writes node q's presence byte and, where asked, its band byte.
template <bool kNibble>
__global__ void __launch_bounds__(kThreads)
byte_neighbors_kernel(const uint64_t* __restrict__ f,
                      const uint64_t* __restrict__ r, int64_t n,
                      uint64_t mask, int shift,
                      const __grid_constant__ ByteLayout layout,
                      const uint8_t* __restrict__ flat, int lo, int hi,
                      const uint64_t* __restrict__ big_keys,
                      const int32_t* __restrict__ big_values, int64_t nbig,
                      uint8_t* __restrict__ out,
                      uint8_t* __restrict__ band_out) {
  const int64_t i = thread_index() >> 3;
  const int j = threadIdx.x & 7;
  bool present = false;
  bool in_band = false;
  if (i < n) {
    const uint64_t c = neighbor_canon(f[i], r[i], j, mask, shift);
    int m = least_count<kNibble>(layout, flat, c);
    present = m > 0;
    if (present && band_out != nullptr) {
      if (m == kMaxCount && nbig > 0) {
        m = big_count(big_keys, big_values, nbig, c);
      }
      in_band = m >= max(lo, 1) && m <= hi;
    }
  }
  const unsigned present_bits = __ballot_sync(~0u, present);
  const unsigned band_bits = __ballot_sync(~0u, in_band);
  if (i < n && j == 0) {
    out[i] = static_cast<uint8_t>(present_bits >> (threadIdx.x & 24));
    if (band_out != nullptr) {
      band_out[i] = static_cast<uint8_t>(band_bits >> (threadIdx.x & 24));
    }
  }
}

// Kernel N's small-level mode: lanes kLanes * i + 8 s + j (j < 8, s <
// kLanes / 8) load neighbour j's counters in tables s, s + kLanes / 8, ...
// of node i, all at once; the least goes round the neighbour's lanes by
// __shfl_xor_sync, and lane kLanes * i (of its warp) writes node i's
// presence byte and, where asked, its band byte.
constexpr int kSmallThreads = 128;

template <int kLanes, bool kNibble>
__global__ void __launch_bounds__(kSmallThreads)
byte_neighbors_small_kernel(const uint64_t* __restrict__ f,
                            const uint64_t* __restrict__ r, int64_t n,
                            uint64_t mask, int shift,
                            const __grid_constant__ ByteLayout layout,
                            const uint8_t* __restrict__ flat, int lo, int hi,
                            const uint64_t* __restrict__ big_keys,
                            const int32_t* __restrict__ big_values,
                            int64_t nbig, uint8_t* __restrict__ out,
                            uint8_t* __restrict__ band_out) {
  constexpr int kSlots = kLanes / 8;  // lanes of a neighbour
  // tables a lane loads at most: T / 4 beyond four tables, else one
  constexpr int kPer = kSlots == 4 ? khmer_byte::kMaxTables / 4 : 1;
  const int64_t i = thread_index() / kLanes;
  const int lane = threadIdx.x & 31;
  const int j = lane & 7;
  const int s = (lane & (kLanes - 1)) >> 3;
  int m = 0;
  uint64_t c = 0;
  if (i < n) {
    c = neighbor_canon(f[i], r[i], j, mask, shift);
    int v[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int t = s + q * kSlots;
      v[q] = t < layout.ntables ? counter<kNibble>(layout, flat, c, t)
                                : kMaxCount;
    }
    m = kMaxCount;
#pragma unroll
    for (int q = 0; q < kPer; ++q) m = min(m, v[q]);
  }
#pragma unroll
  for (int o = 8; o < kLanes; o <<= 1) {
    m = min(m, __shfl_xor_sync(~0u, m, o));
  }
  const bool present = i < n && s == 0 && m > 0;
  bool in_band = false;
  if (present && band_out != nullptr) {
    if (m == kMaxCount && nbig > 0) m = big_count(big_keys, big_values, nbig, c);
    in_band = m >= max(lo, 1) && m <= hi;
  }
  const unsigned present_bits = __ballot_sync(~0u, present);
  const unsigned band_bits = __ballot_sync(~0u, in_band);
  if (i < n && (lane & (kLanes - 1)) == 0) {
    out[i] = static_cast<uint8_t>(present_bits >> lane);
    if (band_out != nullptr) {
      band_out[i] = static_cast<uint8_t>(band_bits >> lane);
    }
  }
}

// The lanes the small mode gives a node: 8 a table, 32 from three tables.
inline int small_lanes(int ntables) { return ntables >= 3 ? 32 : 8 * ntables; }

// Kernel N on n > 0 nodes in the small-level mode where `small`, else the
// staged mode, on byte tables or (kNibble) nibble tables; returns the
// launch's error.
template <bool kNibble>
cudaError_t launch_neighbors_mode(const uint64_t* f, const uint64_t* r,
                                  int64_t n, int k, const ByteLayout& layout,
                                  const uint8_t* flat, int lo, int hi,
                                  const uint64_t* big_keys,
                                  const int32_t* big_values, int64_t nbig,
                                  uint8_t* out, uint8_t* band_out, bool small,
                                  cudaStream_t stream) {
  const uint64_t mask = k == 32 ? ~0ULL : (1ULL << (2 * k)) - 1;
  const int shift = 2 * k - 2;
  if (!small) {
    byte_neighbors_kernel<kNibble><<<khmer_cuda::grid_for(8 * n), kThreads,
                                     0, stream>>>(
        f, r, n, mask, shift, layout, flat, lo, hi, big_keys, big_values,
        nbig, out, band_out);
    return cudaGetLastError();
  }
  const int lanes = small_lanes(layout.ntables);
  const unsigned grid = static_cast<unsigned>(
      (n * lanes + kSmallThreads - 1) / kSmallThreads);
  switch (lanes) {
    case 8:
      byte_neighbors_small_kernel<8, kNibble>
          <<<grid, kSmallThreads, 0, stream>>>(
              f, r, n, mask, shift, layout, flat, lo, hi, big_keys,
              big_values, nbig, out, band_out);
      break;
    case 16:
      byte_neighbors_small_kernel<16, kNibble>
          <<<grid, kSmallThreads, 0, stream>>>(
              f, r, n, mask, shift, layout, flat, lo, hi, big_keys,
              big_values, nbig, out, band_out);
      break;
    default:
      byte_neighbors_small_kernel<32, kNibble>
          <<<grid, kSmallThreads, 0, stream>>>(
              f, r, n, mask, shift, layout, flat, lo, hi, big_keys,
              big_values, nbig, out, band_out);
  }
  return cudaGetLastError();
}

cudaError_t launch_byte_neighbors(const uint64_t* f, const uint64_t* r,
                                  int64_t n, int k, const ByteLayout& layout,
                                  const uint8_t* flat, int lo, int hi,
                                  const uint64_t* big_keys,
                                  const int32_t* big_values, int64_t nbig,
                                  uint8_t* out, uint8_t* band_out, bool small,
                                  bool nibble, cudaStream_t stream) {
  return nibble
             ? launch_neighbors_mode<true>(f, r, n, k, layout, flat, lo, hi,
                                           big_keys, big_values, nbig, out,
                                           band_out, small, stream)
             : launch_neighbors_mode<false>(f, r, n, k, layout, flat, lo, hi,
                                            big_keys, big_values, nbig, out,
                                            band_out, small, stream);
}

// The probe context's layout kinds (khmer_probe_ctx_new's `kind`).
enum LayoutKind { kByteKind = 0, kBitKind = 1, kNibbleKind = 2 };

// A walk's probe context (khmer_probe_ctx_new).
struct ProbeCtx {
  ByteLayout layout;
  const uint8_t* flat;
  int kind;  // LayoutKind: L on bit tables, N on byte or nibble tables
  int k;
  bool band;  // a band [lo, hi] was given
  int lo, hi;
  const uint64_t* big_keys;
  const int32_t* big_values;
  int64_t nbig;
  int64_t small_below;  // N's small-level mode below this many nodes
  int device;
  cudaStream_t stream;
  void* host = nullptr;  // pinned, a level's block (level_walk.h)
  size_t host_bytes = 0;
  uint8_t* dev = nullptr;  // the same block on the card
  size_t dev_bytes = 0;
  long long launches[2] = {0, 0};  // N staged (or L), N small
  double seconds[4] = {0, 0, 0, 0};  // upload, launch, copy back, sync
};

// Grow-only room for `bytes`: at least twice the last, from 1 MiB.
size_t grown(size_t have, size_t bytes) {
  return std::max(bytes, std::max<size_t>(2 * have, 1 << 20));
}

double since(std::chrono::steady_clock::time_point* t) {
  const auto now = std::chrono::steady_clock::now();
  const double s = std::chrono::duration<double>(now - *t).count();
  *t = now;
  return s;
}

// One level: the frontier fr (f of each of n nodes, then r) up, the
// kernel, the bytes back into masks (and band, where given), a sync.
int probe_level(ProbeCtx* c, const uint64_t* fr, int64_t n, uint8_t* masks,
                uint8_t* band) {
  if (n < 0 || (band != nullptr && !c->band)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return err;
  const size_t need = khmer_host::level_block_bytes(n);
  if (c->dev_bytes < need) {
    const size_t bytes = grown(c->dev_bytes, need);
    if (c->dev != nullptr) cudaFree(c->dev);
    c->dev = nullptr;
    c->dev_bytes = 0;
    err = cudaMalloc(&c->dev, bytes);
    if (err != cudaSuccess) return err;
    c->dev_bytes = bytes;
  }
  uint64_t* d_fr = reinterpret_cast<uint64_t*>(c->dev);
  uint8_t* d_out = c->dev + 16 * n;
  const bool bits = c->kind == kBitKind;
  uint8_t* d_band = bits || band == nullptr ? nullptr : d_out + n;
  auto t = std::chrono::steady_clock::now();
  err = cudaMemcpyAsync(d_fr, fr, 16 * n, cudaMemcpyHostToDevice, c->stream);
  if (err != cudaSuccess) return err;
  c->seconds[0] += since(&t);
  int mode = 0;
  if (bits) {
    const uint64_t mask = c->k == 32 ? ~0ULL : (1ULL << (2 * c->k)) - 1;
    neighbors_kernel<<<khmer_cuda::grid_for(8 * n), kThreads, 0,
                       c->stream>>>(d_fr, d_fr + n, n, mask, 2 * c->k - 2,
                                    c->layout, c->flat, d_out);
    err = cudaGetLastError();
  } else {
    mode = n < c->small_below;
    err = launch_byte_neighbors(d_fr, d_fr + n, n, c->k, c->layout, c->flat,
                                c->lo, c->hi, c->big_keys, c->big_values,
                                c->nbig, d_out, d_band, mode,
                                c->kind == kNibbleKind, c->stream);
  }
  if (err != cudaSuccess) return err;
  ++c->launches[mode];
  c->seconds[1] += since(&t);
  if (d_band != nullptr && band == masks + n) {
    err = cudaMemcpyAsync(masks, d_out, 2 * n, cudaMemcpyDeviceToHost,
                          c->stream);
  } else {
    err = cudaMemcpyAsync(masks, d_out, n, cudaMemcpyDeviceToHost,
                          c->stream);
    if (err == cudaSuccess && d_band != nullptr) {
      err = cudaMemcpyAsync(band, d_band, n, cudaMemcpyDeviceToHost,
                            c->stream);
    }
  }
  if (err != cudaSuccess) return err;
  c->seconds[2] += since(&t);
  err = cudaStreamSynchronize(c->stream);
  c->seconds[3] += since(&t);
  if (err != cudaSuccess) return err;
  if (bits && band != nullptr) {
    // a Nodegraph's present k-mers count 1
    if (c->lo <= 1 && 1 <= c->hi) {
      std::memcpy(band, masks, n);
    } else {
      std::memset(band, 0, n);
    }
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace khmer_nbr

// out[i] = the present-neighbour byte of node (f[i], r[i]) for i < n, at
// k-mer size k in [1, 32]. primes/bit_offsets are HOST arrays of ntables
// (the tables' offsets in the joined buffer, in bits).
extern "C" int khmer_neighbors(const uint8_t* flat, int ntables,
                               const int64_t* primes,
                               const int64_t* bit_offsets, const int64_t* f,
                               const int64_t* r, int64_t n, int k,
                               uint8_t* out, int device, void* stream) {
  using namespace khmer_nbr;
  ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, bit_offsets, &layout)
      || n < 0 || k < 1 || k > 32) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const uint64_t mask = k == 32 ? ~0ULL : (1ULL << (2 * k)) - 1;
  neighbors_kernel<<<khmer_cuda::grid_for(8 * n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint64_t*>(f),
      reinterpret_cast<const uint64_t*>(r), n, mask, 2 * k - 2, layout, flat,
      out);
  return cudaGetLastError();
}

// out[i] = 1 iff hashes[i]'s bit is set in every table, for i < n.
extern "C" int khmer_bit_gather(const uint8_t* flat, int ntables,
                                const int64_t* primes,
                                const int64_t* bit_offsets,
                                const int64_t* hashes, int64_t n,
                                int32_t* out, int device, void* stream) {
  using namespace khmer_nbr;
  ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, bit_offsets, &layout)
      || n < 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  bit_gather_kernel<<<khmer_cuda::grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint64_t*>(hashes), n, layout, flat, out);
  return cudaGetLastError();
}

// Kernel N: out[i] = the present-neighbour byte of node (f[i], r[i]) for
// i < n in the byte tables; band_out (nullable) gets the in-band byte (lo,
// hi: the band, clamped by the caller to [0, 65536] and [-1, 65535]).
// big_keys / big_values (device, nbig entries, keys ascending as u64) may
// be null with nbig 0. primes/offsets are HOST arrays of ntables (the
// tables' offsets in the joined buffer, in bytes). small: the small-level
// mode, else the staged one.
extern "C" int khmer_byte_neighbors(const uint8_t* flat, int ntables,
                                    const int64_t* primes,
                                    const int64_t* offsets, const int64_t* f,
                                    const int64_t* r, int64_t n, int k,
                                    int lo, int hi, const void* big_keys,
                                    const int32_t* big_values, int64_t nbig,
                                    uint8_t* out, uint8_t* band_out,
                                    int small, int device, void* stream) {
  using namespace khmer_nbr;
  ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, offsets, &layout) || n < 0
      || k < 1 || k > 32 || nbig < 0
      || (nbig > 0 && (big_keys == nullptr || big_values == nullptr))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  return launch_byte_neighbors(
      reinterpret_cast<const uint64_t*>(f),
      reinterpret_cast<const uint64_t*>(r), n, k, layout, flat, lo, hi,
      static_cast<const uint64_t*>(big_keys), big_values, nbig, out,
      band_out, small != 0, false, static_cast<cudaStream_t>(stream));
}

// Kernel N's nibble mode: khmer_byte_neighbors on the nibble tables
// (offsets in nibbles, as kernel Q takes them), the band tested on the
// 4-bit counts; no bigcount table.
extern "C" int khmer_nibble_neighbors(const uint8_t* flat, int ntables,
                                      const int64_t* primes,
                                      const int64_t* offsets,
                                      const int64_t* f, const int64_t* r,
                                      int64_t n, int k, int lo, int hi,
                                      uint8_t* out, uint8_t* band_out,
                                      int small, int device, void* stream) {
  using namespace khmer_nbr;
  ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, offsets, &layout) || n < 0
      || k < 1 || k > 32) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  return launch_byte_neighbors(
      reinterpret_cast<const uint64_t*>(f),
      reinterpret_cast<const uint64_t*>(r), n, k, layout, flat, lo, hi,
      nullptr, nullptr, 0, out, band_out, small != 0, true,
      static_cast<cudaStream_t>(stream));
}

// A walk's probe context: by its layout kind, kernel N on the byte tables
// (kind 0; primes and offsets as khmer_byte_neighbors takes them, its
// small-level mode below small_below nodes), kernel L on the bit tables
// (kind 1; offsets in bits) or N's nibble mode on the nibble tables (kind
// 2; offsets in nibbles), k-mers of size k; with band 1, [lo, hi]
// (clamped as for khmer_byte_neighbors) and the bigcount table (device,
// may be null with nbig 0; byte tables only). Launches on `stream`. Null
// if an argument is out of range. The context owns its pinned and device
// blocks.
extern "C" void* khmer_probe_ctx_new(const uint8_t* flat, int ntables,
                                     const int64_t* primes,
                                     const int64_t* offsets, int kind, int k,
                                     int band, int lo, int hi,
                                     const void* big_keys,
                                     const int32_t* big_values, int64_t nbig,
                                     int64_t small_below, int device,
                                     void* stream) {
  using namespace khmer_nbr;
  ProbeCtx* c = new ProbeCtx;
  if (!khmer_byte::make_layout(ntables, primes, offsets, &c->layout)
      || k < 1 || k > 32 || nbig < 0 || kind < kByteKind
      || kind > kNibbleKind
      || (nbig > 0 && (kind != kByteKind || big_keys == nullptr
                       || big_values == nullptr))) {
    delete c;
    return nullptr;
  }
  c->flat = flat;
  c->kind = kind;
  c->k = k;
  c->band = band != 0;
  c->lo = lo;
  c->hi = hi;
  c->big_keys = static_cast<const uint64_t*>(big_keys);
  c->big_values = big_values;
  c->nbig = nbig;
  c->small_below = small_below;
  c->device = device;
  c->stream = static_cast<cudaStream_t>(stream);
  return c;
}

extern "C" void khmer_probe_ctx_free(void* ctx) {
  auto* c = static_cast<khmer_nbr::ProbeCtx*>(ctx);
  if (c == nullptr) return;
  cudaSetDevice(c->device);
  if (c->host != nullptr) cudaFreeHost(c->host);
  if (c->dev != nullptr) cudaFree(c->dev);
  delete c;
}

// A pinned host block for a level of n nodes (level_walk.h: the frontier,
// then its bytes), grow-only; null if it cannot be had.
extern "C" void* khmer_probe_block(void* ctx, int64_t n) {
  using namespace khmer_nbr;
  auto* c = static_cast<ProbeCtx*>(ctx);
  const size_t need = khmer_host::level_block_bytes(n);
  if (c->host_bytes < need) {
    if (cudaSetDevice(c->device) != cudaSuccess) return nullptr;
    if (c->host != nullptr) cudaFreeHost(c->host);
    c->host = nullptr;
    const size_t bytes = grown(c->host_bytes, need);
    c->host_bytes = 0;
    if (cudaHostAlloc(&c->host, bytes, cudaHostAllocDefault)
        != cudaSuccess) {
      c->host = nullptr;
      return nullptr;
    }
    c->host_bytes = bytes;
  }
  return c->host;
}

// Kernel N on a level (csrc/level_walk.cc's probe): the frontier fr (host;
// the context's block or any host memory) of n nodes up, the presence
// bytes back into masks and, for a banded walk, the band bytes into band
// (the context must have a band), then a sync. Returns a CUDA error code.
extern "C" int khmer_byte_probe_level(void* ctx, const uint64_t* fr,
                                      int64_t n, uint8_t* masks,
                                      uint8_t* band) {
  auto* c = static_cast<khmer_nbr::ProbeCtx*>(ctx);
  if (c->kind != khmer_nbr::kByteKind) return cudaErrorInvalidValue;
  return khmer_nbr::probe_level(c, fr, n, masks, band);
}

// N's nibble mode on a level, as khmer_byte_probe_level.
extern "C" int khmer_nibble_probe_level(void* ctx, const uint64_t* fr,
                                        int64_t n, uint8_t* masks,
                                        uint8_t* band) {
  auto* c = static_cast<khmer_nbr::ProbeCtx*>(ctx);
  if (c->kind != khmer_nbr::kNibbleKind) return cudaErrorInvalidValue;
  return khmer_nbr::probe_level(c, fr, n, masks, band);
}

// Kernel L on a level, as khmer_byte_probe_level; a banded walk's band
// bytes are the presence bytes where the band holds 1, else 0.
extern "C" int khmer_bit_probe_level(void* ctx, const uint64_t* fr,
                                     int64_t n, uint8_t* masks,
                                     uint8_t* band) {
  auto* c = static_cast<khmer_nbr::ProbeCtx*>(ctx);
  if (c->kind != khmer_nbr::kBitKind) return cudaErrorInvalidValue;
  return khmer_nbr::probe_level(c, fr, n, masks, band);
}

// The context's counts and clocks: launches (L, or N's staged mode, byte
// or nibble), N's small-mode launches, and host seconds issuing the
// uploads, the launches and the copies back, and waiting in the syncs.
extern "C" void khmer_probe_ctx_stats(void* ctx, double* out) {
  const auto* c = static_cast<khmer_nbr::ProbeCtx*>(ctx);
  out[0] = static_cast<double>(c->launches[0]);
  out[1] = static_cast<double>(c->launches[1]);
  for (int i = 0; i < 4; ++i) out[2 + i] = c->seconds[i];
}
