// Kernel H: per-read count and trim over whole reads, reading the u8
// tables only.
//
// Replaces khmer_tpu/core/pipeline.py:755 (counts_for_records: the hash
// batch and the sketch's gather, XLA device functions on the TPU, then the
// host's trim_pos_from_counts and median_at_least_from_counts) and the
// pass-2 gather of trim-low-abund (khmer_tpu/core/diginorm.py:36
// make_pertable_counts through SeqWindow); its plain PyTorch version is
// khmer_tpu_torch/core/sketch_kernels.py:read_counts_plain, and its split
// into segments and their combine are mirrored by
// sketch_kernels.py:read_split_plain.
//
// Per read r of a [R, L] code matrix with lengths [R], from the minimum
// over the T tables of each valid window's counter:
//   trim_at[r]: 0 for a read with no window or one, or whose window 0 is
//     below `cutoff`; k + j - 1 for the first later window j below it;
//     else the read's length (utils/trimming.py trim_pos_from_counts);
//   n_ge[r]: the windows at or above `at_least` (median_at_least needs
//     that count alone).
// With a bigcount table (the map's u64 hashes in ascending order and
// their counts), a count of 255 becomes the table's count for its hash
// where it has one, as counts_for_records reads the map.
//
// What bounds it on the H100. At the table sizes users run (4 GB at -x 1e9
// -N 4) it is DRAM serving random 32-byte sectors: each window's T
// counters lie in T random sectors of tables far larger than the L2, and
// the codes and outputs are small beside them. Where the counters hit L2
// (config 3's 200 MB on reads whose k-mers repeat) it is the memory
// system's rate of random requests, one a counter, and the SM's: each
// warp's load of 32 random counters costs the load pipeline one pass per
// sector, and hashing a window from its k codes one at a time cost some
// 400 instructions. Measured (PERF.md section 6, row H): on a window of
// short reads the time moves with neither the items a thread batches (1
// to 4), the rows a tile (4 to 64) nor L1 caching, and equals the
// warp-a-read design's: about 110 G counter loads a second where they hit
// L2, 31 G at 4 GB. What the design buys is the parallelism of long
// rows.
//
// Design.
// - The grid covers (tile, segment) pairs: a tile is `rows` consecutive
//   rows, a segment `seg` consecutive windows of each of them
//   (sketch_kernels.py read_plan, from L and k alone). A row with more
//   windows than a segment is spread over as many blocks as it has
//   segments, across the card: a long-read run of row_runs or one
//   sequence of a million bases as well as a window of short reads.
// - A block packs its rows' codes for its segment, 16 bytes a load where
//   the row is aligned, into forward and reverse-complement 2-bit words in
//   shared memory (twobit_common.cuh pack_word); a window's canonical hash
//   is then two funnel shifts and a minimum (hash_at): O(1), not O(k).
// - The segment's (row, window) items lie flat over the block's threads, a
//   byte map in shared memory giving each item's row, so no lane idles at
//   the end of a read; a thread takes kBatch items and issues all their
//   counter loads, kTables tables at a time, before it uses any.
// - A warp folds its items per row: items of a row sit on consecutive
//   lanes in window order, so one lane a run of equal rows adds the run's
//   windows at or above `at_least` (a ballot) with one shared atomic, and
//   the run's lowest lane below `cutoff` takes the shared minimum of the
//   first such window (window 0's flag is that minimum being 0).
// - With one segment a row the block writes its rows' outputs. Otherwise
//   each block adds its rows' sums into int32 scratch and takes the
//   maximum of ~first with global atomics; the last of a tile's blocks to
//   finish (a counter a tile) forms the tile's outputs. One launch either
//   way, after the scratch is cleared on the same stream.
// - No staging by table 0: a window is settled by table 0 alone only
//   below min(cutoff, at_least), and on config 3's windows that saves
//   under 30% of the loads (PERF.md section 6, row H).
//
// Counts mode (counts non-null; count-median, the Countgraph's
// get_kmer_counts and get_median_count, khmer_tpu/core/pipeline.py:755
// counts_for_records): each item writes its window's least counter, 255
// where saturated, to counts[row][window] (u8 [nrows, L - k + 1]) in place
// of the two reductions, and the block writes no trim_at or n_ge; the host
// reads a 255 through the bigcount map. Only the codes go up (1 B a base)
// and a byte a window comes back, not 8 B hashes a k-mer.

#include "byte_common.cuh"
#include "twobit_common.cuh"

namespace khmer_read_trim {
namespace {

using khmer_byte::big_count;
using khmer_byte::ByteLayout;
using khmer_byte::counter_index;
using khmer_cuda::kMaxCount;
using khmer_twobit::hash_at;
using khmer_twobit::pack_word;

// core/sketch_kernels.py READ_THREADS and READ_MAX_ROWS
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxRows = 64;
constexpr int kBatch = 2;   // items a thread takes at once
constexpr int kTables = 4;  // tables whose loads it issues at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;  // no window below cutoff; no row

// trim_at of a read of `len` codes with `nw` windows whose first window
// below cutoff is `first` (kNone: none).
__device__ __forceinline__ int trim_of(int nw, int len, int first, int k) {
  return nw <= 1 || first == 0 ? 0 : first != kNone ? k + first - 1 : len;
}

struct Tile {
  int nw[kMaxRows];         // windows of each row in the matrix
  int len[kMaxRows];        // its length
  int ge[kMaxRows];         // the segment's windows >= at_least
  int first[kMaxRows];      // the segment's first window < cutoff
  int start[kMaxRows + 1];  // the segment's items before each row
  int last;                 // this block is its tile's last to finish
};

__global__ void __launch_bounds__(kBlock)
counts_kernel(const uint8_t* __restrict__ codes,
              const int32_t* __restrict__ lengths, int64_t nrows, int L,
              int k, int cutoff, int at_least, int rows_per_block, int seg,
              int nsegs, const __grid_constant__ ByteLayout layout,
              const uint8_t* __restrict__ flat,
              const uint64_t* __restrict__ big_keys,
              const int32_t* __restrict__ big_values, int64_t nbig,
              int32_t* __restrict__ trim_at, int32_t* __restrict__ n_ge,
              int32_t* __restrict__ scratch, uint8_t* __restrict__ counts) {
  __shared__ Tile s;
  extern __shared__ uint64_t smem[];
  const int pw = seg / 32 + 1;
  uint64_t* fw = smem;
  uint64_t* rw = fw + rows_per_block * pw;
  uint8_t* rowmap = reinterpret_cast<uint8_t*>(rw + rows_per_block * pw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile = blockIdx.x / nsegs;
  const int s0 = static_cast<int>(blockIdx.x - tile * nsegs) * seg;
  const int64_t row0 = tile * rows_per_block;
  const int rows = nrows - row0 < rows_per_block
                       ? static_cast<int>(nrows - row0) : rows_per_block;
  const int T = layout.ntables;
  if (tid < kMaxRows) {
    int nw = 0;
    int len = 0;
    if (tid < rows) {
      len = lengths[row0 + tid];
      nw = min(khmer_twobit::n_windows(len, k), L - k + 1);
    }
    s.nw[tid] = nw;
    s.len[tid] = len;
    s.ge[tid] = 0;
    s.first[tid] = kNone;
  }
  __syncthreads();
  if (warp == 0) {  // items of each row in this segment, their prefix
    int c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c[h] = min(max(s.nw[lane + 32 * h] - s0, 0), seg);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, c[h], d);
        if (lane >= d) c[h] += up;
      }
    }
    c[1] += __shfl_sync(kFull, c[0], 31);
    if (lane == 0) s.start[0] = 0;
    s.start[lane + 1] = c[0];
    s.start[lane + 33] = c[1];
  }
  __syncthreads();
  const int total = s.start[rows];
  if (total > 0) {
    for (int r = warp; r < rows; r += kWarps) {
      for (int i = s.start[r] + lane; i < s.start[r + 1]; i += 32) {
        rowmap[i] = static_cast<uint8_t>(r);
      }
    }
    // the words hash_at reads for a row's items: (items - 1) / 32 + 2
    for (int i = tid; i < rows * pw; i += kBlock) {
      const int r = i / pw;
      const int w = i - r * pw;
      const int items = s.start[r + 1] - s.start[r];
      if (items > 0 && w <= (items - 1) / 32 + 1) {
        pack_word(codes + (row0 + r) * L, s0 + 32 * w, L, fw + i, rw + i);
      }
    }
    __syncthreads();
    for (int base = 0; base < total; base += kBlock * kBatch) {
      // the batch's items: row, window and hash; a warp skips a slot
      // where it has no item
      bool any[kBatch];
      bool act[kBatch];
      int key[kBatch];
      int win[kBatch];
      uint64_t h[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kBlock + tid;
        any[u] = i - lane < total;
        act[u] = i < total;
        key[u] = kNone;
        win[u] = 0;
        h[u] = 0;
        if (act[u]) {
          const int r = rowmap[i];
          const int q = i - s.start[r];
          key[u] = r;
          win[u] = s0 + q;
          h[u] = hash_at(fw + r * pw, rw + r * pw, q, k);
        }
      }
      // the counters, kTables tables at a time: every load of the batch
      // issued before any is used
      int m[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) m[u] = kMaxCount;
      for (int t0 = 0; t0 < T; t0 += kTables) {
        int v[kTables][kBatch];
#pragma unroll
        for (int dt = 0; dt < kTables; ++dt) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            v[dt][u] = kMaxCount;
            if (t0 + dt < T && act[u]) {
              v[dt][u] = flat[counter_index(layout, h[u], t0 + dt)];
            }
          }
        }
#pragma unroll
        for (int dt = 0; dt < kTables; ++dt) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) m[u] = min(m[u], v[dt][u]);
        }
      }
      if (counts != nullptr) {  // counts mode: the same for the block
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (act[u]) {
            counts[(row0 + key[u]) * (L - k + 1) + win[u]] =
                static_cast<uint8_t>(m[u]);
          }
        }
        continue;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (act[u] && m[u] == kMaxCount && nbig > 0) {
          m[u] = big_count(big_keys, big_values, nbig, h[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!any[u]) continue;  // the same for the warp
        const unsigned ge = __ballot_sync(kFull, act[u] && m[u] >= at_least);
        const unsigned bad = __ballot_sync(kFull, act[u] && m[u] < cutoff);
        const int prev = __shfl_up_sync(kFull, key[u], 1);
        const unsigned lead = __ballot_sync(kFull,
                                            lane == 0 || prev != key[u]);
        if (key[u] != kNone) {
          // the run of lanes holding this row: [head, end)
          const int head = 31 - __clz(lead & (kFull >> (31 - lane)));
          const unsigned next = lead & (0xfffffffeu << lane);
          const unsigned below = next ? (1u << (__ffs(next) - 1)) - 1 : kFull;
          const unsigned run = below & (kFull << head);
          const int n = __popc(ge & run);
          if (lane == head && n) atomicAdd(s.ge + key[u], n);
          const unsigned b = bad & run;
          if (b && lane == __ffs(b) - 1) atomicMin(s.first + key[u], win[u]);
        }
      }
    }
  }
  __syncthreads();
  if (counts != nullptr) return;
  if (nsegs == 1) {
    if (tid < rows) {
      n_ge[row0 + tid] = s.ge[tid];
      trim_at[row0 + tid] = trim_of(s.nw[tid], s.len[tid], s.first[tid], k);
    }
    return;
  }
  // rows over several segments: int32 [nrows] sums, u32 [nrows] maxima of
  // ~first (0: none) and a u32 counter a tile
  int32_t* ge_all = scratch;
  unsigned* inv_first = reinterpret_cast<unsigned*>(scratch + nrows);
  unsigned* done = reinterpret_cast<unsigned*>(scratch + 2 * nrows);
  if (tid < rows && s.nw[tid] > s0) {
    if (s.ge[tid]) atomicAdd(ge_all + row0 + tid, s.ge[tid]);
    if (s.first[tid] != kNone) {
      atomicMax(inv_first + row0 + tid, ~static_cast<unsigned>(s.first[tid]));
    }
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) {
    s.last = atomicAdd(done + tile, 1u) == static_cast<unsigned>(nsegs - 1);
  }
  __syncthreads();
  if (s.last && tid < rows) {
    __threadfence();
    const unsigned f = __ldcg(inv_first + row0 + tid);
    n_ge[row0 + tid] = __ldcg(ge_all + row0 + tid);
    trim_at[row0 + tid] = trim_of(s.nw[tid], s.len[tid],
                                  f ? static_cast<int>(~f) : kNone, k);
  }
}

// Dynamic shared bytes of a block: for each row, the forward and reverse
// words of a segment and the row of each of its items.
inline int64_t smem_bytes(int rows, int seg) {
  return int64_t{rows} * (16 * (seg / 32 + 1) + seg);
}

}  // namespace
}  // namespace khmer_read_trim

// Rows 0..nrows-1 of codes [nrows, L] / lengths [nrows]: trim_at[r] and
// n_ge[r]. cutoff and at_least are clamped to [-1, 65536] by the caller.
// `rows` (rows a tile, at most 64) and `seg` (windows a segment, a multiple
// of 32) come from core/sketch_kernels.py read_plan(L, k); with more than
// one segment a row, `scratch` holds 2 nrows + ceil(nrows / rows) int32
// words (the wrapper's torch.empty; cleared here on the stream), else it
// may be null. big_keys / big_values (device, nbig entries, keys ascending
// as u64) may be null with nbig 0. primes/offsets are HOST arrays of
// ntables. With counts non-null (counts mode, u8 [nrows, L - k + 1]), each
// valid window's least counter goes there instead; trim_at, n_ge, scratch
// and the bigcount table are then not used and may be null.
extern "C" int khmer_read_counts(const uint8_t* flat, int ntables,
                                 const int64_t* primes,
                                 const int64_t* offsets,
                                 const uint8_t* codes,
                                 const int32_t* lengths, int64_t nrows,
                                 int L, int k, int cutoff, int at_least,
                                 int rows, int seg, const void* big_keys,
                                 const int32_t* big_values, int64_t nbig,
                                 int32_t* trim_at, int32_t* n_ge,
                                 int32_t* scratch, uint8_t* counts,
                                 int device, void* stream) {
  using namespace khmer_read_trim;
  khmer_byte::ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, offsets, &layout)
      || nrows < 0 || k < 1 || k > 32 || L < k || rows < 1
      || rows > kMaxRows || seg < 32 || seg % 32 || nbig < 0
      || (nbig > 0 && (big_keys == nullptr || big_values == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const int64_t nsegs = (int64_t{L} - k + seg) / seg;
  const int64_t tiles = (nrows + rows - 1) / rows;
  if (counts != nullptr) nbig = 0;
  if (nsegs > 1 && scratch == nullptr && counts == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (tiles * nsegs > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nrows == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  if (nsegs > 1 && counts == nullptr) {
    err = cudaMemsetAsync(scratch, 0, sizeof(int32_t) * (2 * nrows + tiles),
                          s);
    if (err != cudaSuccess) return err;
  }
  const int64_t smem = smem_bytes(rows, seg);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(counts_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  counts_kernel<<<static_cast<unsigned>(tiles * nsegs), kBlock,
                  static_cast<size_t>(smem), s>>>(
      codes, lengths, nrows, L, k, cutoff, at_least, rows, seg,
      static_cast<int>(nsegs), layout, flat,
      static_cast<const uint64_t*>(big_keys), big_values, nbig, trim_at,
      n_ge, scratch, counts);
  return cudaGetLastError();
}
