// Kernel E: the diginorm median test of a whole window (phase A).
//
// Replaces khmer_tpu/core/diginorm_scan.py:93 (make_med_ok), an XLA
// function on the TPU; its plain PyTorch version is
// khmer_tpu_torch/core/sketch_kernels.py:med_ok_plain, and the counters it
// loads are mirrored by sketch_kernels.py:med_load_plan.
//
// For each bundle b of a window (reads 2b and 2b + 1 of a [2B, L] code
// matrix), reject[b] is true iff every present read (length >= k) passes
// median_at_least(C) (reference hashtable.cc:333-364) under the tables as
// they stand: #(valid windows whose count, the minimum over the T tables,
// is >= C) >= (nvalid + 1) / 2, with nvalid = len - k + 1. Counts only
// grow during diginorm and the test is monotone in them, so a rejection
// here is final; the rest are the keep candidates of kernel F.
//
// What bounds it on the H100. At the table sizes users run (4 GB at -x 1e9
// -N 4) it is DRAM serving random 32-byte sectors, one per counter load:
// the only gain there is fewer loads. With tables that sit in L2 (config
// 2's 4 MB) it is the SM: each warp's load of 32 random counters costs the
// load pipeline one pass per sector, and hashing a window from its k codes
// one at a time cost some 400 instructions.
//
// Design.
// - A block takes a tile of `rows` rows (whole bundles) and walks them in
//   segments of `seg` windows. For a segment it packs each row's codes,
//   loaded 16 bytes at a time, into 2-bit words in shared memory: 32 codes
//   a u64, forward (first code most significant) and reverse complement
//   (first code least significant). A window's forward and reverse hash
//   are then two funnel shifts of two words each, and its canonical hash
//   their unsigned minimum: O(1) a window instead of O(k).
// - The segment's (row, window) items are laid out flat over the block's
//   threads, a map in shared memory giving each item's row, so no lane
//   idles at the tail of a read; a thread takes kBatch items at once and
//   issues all their loads before it uses any. A warp sums its items per
//   row (or per 32-window word) from a ballot of the lanes that pass, and
//   one lane a run of equal keys adds the sum with one shared atomic.
// - The tables are loaded in two rounds. Round 0 loads table 0 for every
//   valid window and keeps a bit per window whose table-0 count is >= C.
//   A read with fewer such windows than it needs fails, and so does its
//   bundle, whatever its mate holds. Round 1 loads tables 1..T-1 only for
//   the surviving windows of the bundles still undecided, and counts the
//   windows whose every table is >= C. The decision is exact: a window
//   counts iff every table's count is >= C. With one table, or rows so
//   long that two rows' bits overflow shared memory, one round loads every
//   table for every valid window (bit_words == 0).
// - One launch a window, no scratch beyond shared memory; an optional
//   counter takes the loads the block issued, one atomic a block.

#include "byte_common.cuh"
#include "twobit_common.cuh"

namespace khmer_digi_med {
namespace {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;
using khmer_twobit::hash_at;
using khmer_twobit::pack_word;

// core/sketch_kernels.py MED_THREADS and MED_MAX_ROWS
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxRows = 64;
constexpr int kBatch = 2;   // items a thread takes at once
constexpr int kTables = 4;  // tables whose loads it issues at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoKey = 0x7fffffff;  // a lane past the segment's items

struct Tile {
  int nw[kMaxRows];         // windows of each row in the matrix
  int need[kMaxRows];       // (nvalid + 1) / 2; 0 for an absent read
  int ge0[kMaxRows];        // windows whose table-0 count is >= C
  int ge[kMaxRows];         // windows whose every count is >= C
  int live[kMaxRows];       // the row takes part in the current round
  int start[kMaxRows + 1];  // the segment's items before each row
  unsigned long long loads;
};

// One round over the live rows of the tile: tables [t_lo, t_hi) for each
// valid window, or (`from_bits`) for each window whose bit is set. In round
// 0 of a staged tile (`to_bits`) a pass sets the window's bit; otherwise it
// adds to its row's ge. `rowmap` holds the row of each of a segment's
// items.
__device__ __forceinline__ void walk(
    Tile& s, uint64_t* fw, uint64_t* rw, uint32_t* bits, uint8_t* rowmap,
    int bit_words, const uint8_t* codes, int64_t row0, int rows, int L,
    int k, int seg, int cutoff, int t_lo, int t_hi, bool to_bits,
    bool from_bits, bool repack, const ByteLayout& layout,
    const uint8_t* __restrict__ flat, int* issued) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int W = L - k + 1;
  const int pw = seg / 32 + 1;
  for (int s0 = 0; s0 < W; s0 += seg) {
    if (warp == 0) {  // items of each row in this segment, their prefix
      int c[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        c[h] = r < rows && s.live[r] ? min(max(s.nw[r] - s0, 0), seg) : 0;
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
    if (total == 0) {
      __syncthreads();
      continue;
    }
    for (int r = warp; r < rows; r += kWarps) {
      for (int i = s.start[r] + lane; i < s.start[r + 1]; i += 32) {
        rowmap[i] = static_cast<uint8_t>(r);
      }
    }
    if (repack) {
      for (int i = tid; i < rows * pw; i += kBlock) {
        const int r = i / pw;
        if (s.start[r + 1] > s.start[r]) {
          pack_word(codes + (row0 + r) * L, s0 + 32 * (i - r * pw), L,
                    fw + i, rw + i);
        }
      }
    }
    __syncthreads();
    for (int base = 0; base < total; base += kBlock * kBatch) {
      // the batch's items: row, window, key and hash; a warp skips a
      // slot where it has no item
      bool any[kBatch];
      int key[kBatch];
      int win[kBatch];
      bool act[kBatch];
      uint64_t h[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kBlock + tid;
        any[u] = i - lane < total;
        key[u] = kNoKey;
        win[u] = 0;
        act[u] = false;
        h[u] = 0;
        if (any[u]) {
          const int ic = min(i, total - 1);
          const int r = rowmap[ic];
          const int q = ic - s.start[r];
          win[u] = s0 + q;
          const int word = r * bit_words + (win[u] >> 5);
          if (i < total) {
            key[u] = to_bits ? word : r;
            act[u] = !from_bits || ((bits[word] >> (win[u] & 31)) & 1u);
          }
          h[u] = hash_at(fw + r * pw, rw + r * pw, q, k);
        }
      }
      // the counters, kTables tables at a time: every load of the batch
      // issued before any is used
      int m[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) m[u] = khmer_cuda::kMaxCount;
      for (int t0 = t_lo; t0 < t_hi; t0 += kTables) {
        int v[kTables][kBatch];
#pragma unroll
        for (int dt = 0; dt < kTables; ++dt) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            v[dt][u] = khmer_cuda::kMaxCount;
            if (t0 + dt < t_hi && any[u]) {  // the same for the warp
              const uint64_t idx = counter_index(layout, h[u], t0 + dt);
              if (act[u]) v[dt][u] = flat[idx];
            }
          }
        }
#pragma unroll
        for (int dt = 0; dt < kTables; ++dt) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) m[u] = min(m[u], v[dt][u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!any[u]) continue;
        *issued += act[u] ? t_hi - t_lo : 0;
        // equal keys lie on consecutive lanes, with consecutive windows
        const unsigned pass = __ballot_sync(kFull, act[u] && m[u] >= cutoff);
        const int prev = __shfl_up_sync(kFull, key[u], 1);
        const unsigned lead = __ballot_sync(kFull,
                                            lane == 0 || prev != key[u]);
        if (((lead >> lane) & 1u) && key[u] != kNoKey) {
          const unsigned next = lead & (0xfffffffeu << lane);
          const int end = next ? __ffs(next) - 1 : 32;
          const unsigned run = static_cast<unsigned>(
              (static_cast<uint64_t>(pass) >> lane)
              & ((1ULL << (end - lane)) - 1));
          if (run && to_bits) {
            atomicOr(bits + key[u], run << (win[u] & 31));
          } else if (run) {
            atomicAdd(s.ge + key[u], __popc(run));
          }
        }
      }
    }
    __syncthreads();  // start, the map and the packed words are rewritten
  }
}

// A row fails round 0: present, with fewer table-0 survivors than needed.
__device__ __forceinline__ bool fails0(const Tile& s, int r) {
  return s.need[r] > 0 && s.ge0[r] < s.need[r];
}


__global__ void __launch_bounds__(kBlock)
med_kernel(const uint8_t* __restrict__ codes,
           const int32_t* __restrict__ lengths, int64_t nrows, int L, int k,
           int cutoff, int rows_per_block, int seg, int bit_words,
           const __grid_constant__ ByteLayout layout,
           const uint8_t* __restrict__ flat, uint8_t* __restrict__ reject,
           unsigned long long* __restrict__ loads) {
  __shared__ Tile s;
  extern __shared__ uint64_t smem[];
  const int pw = seg / 32 + 1;
  uint64_t* fw = smem;
  uint64_t* rw = fw + rows_per_block * pw;
  uint32_t* bits = reinterpret_cast<uint32_t*>(rw + rows_per_block * pw);
  uint8_t* rowmap = reinterpret_cast<uint8_t*>(bits
                                               + rows_per_block * bit_words);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row0 = blockIdx.x * static_cast<int64_t>(rows_per_block);
  const int rows = nrows - row0 < rows_per_block
                       ? static_cast<int>(nrows - row0) : rows_per_block;
  const int W = L - k + 1;
  const int T = layout.ntables;
  const bool staged = bit_words > 0 && T > 1;
  if (tid < kMaxRows) {
    int nw = 0;
    int need = 0;
    if (tid < rows) {
      const int nvalid = khmer_twobit::n_windows(lengths[row0 + tid], k);
      nw = min(nvalid, W);
      need = (nvalid + 1) / 2;
    }
    s.nw[tid] = nw;
    s.need[tid] = need;
    s.ge0[tid] = 0;
    s.ge[tid] = 0;
    s.live[tid] = nw > 0;
  }
  if (tid == 0) s.loads = 0;
  if (staged) {
    for (int i = tid; i < rows * bit_words; i += kBlock) bits[i] = 0;
  }
  __syncthreads();
  int issued = 0;
  walk(s, fw, rw, bits, rowmap, bit_words, codes, row0, rows, L, k, seg,
       cutoff, 0, staged ? 1 : T, staged, false, true, layout, flat,
       &issued);
  if (staged) {
    for (int r = warp; r < rows; r += kWarps) {
      int c = 0;
      for (int w = lane; w < (s.nw[r] + 31) >> 5; w += 32) {
        c += __popc(bits[r * bit_words + w]);
      }
      c = __reduce_add_sync(kFull, c);
      if (lane == 0) s.ge0[r] = c;
    }
    __syncthreads();
    if (tid < rows) {
      s.live[tid] = s.nw[tid] > 0 && !fails0(s, tid) && !fails0(s, tid ^ 1);
    }
    __syncthreads();
    // the packed words of round 0 still hold a tile of one segment
    walk(s, fw, rw, bits, rowmap, bit_words, codes, row0, rows, L, k, seg,
         cutoff, 1, T, false, true, W > seg, layout, flat, &issued);
  }
  if (tid < rows / 2) {
    // a read that failed round 0, or whose mate did, kept ge 0
    const int a = 2 * tid;
    reject[row0 / 2 + tid] =
        (s.need[a] == 0 || s.ge[a] >= s.need[a])
        && (s.need[a + 1] == 0 || s.ge[a + 1] >= s.need[a + 1]);
  }
  if (loads != nullptr) {
    const unsigned n = __reduce_add_sync(kFull,
                                         static_cast<unsigned>(issued));
    if (lane == 0 && n) {
      atomicAdd(&s.loads, static_cast<unsigned long long>(n));
    }
    __syncthreads();
    if (tid == 0 && s.loads) atomicAdd(loads, s.loads);
  }
}

// Dynamic shared bytes of a block: for each row, the forward and reverse
// words of a segment, the bits of every window and the row of each of its
// items in a segment.
inline int64_t smem_bytes(int rows, int seg, int bit_words) {
  return int64_t{rows}
         * (16 * (seg / 32 + 1) + 4 * int64_t{bit_words} + seg);
}

}  // namespace
}  // namespace khmer_digi_med

// reject[b] for b < nbundles from codes [2 nbundles, L] (u8 2-bit codes),
// lengths [2 nbundles] and the flat byte tables, and the counter loads
// issued added to *loads (may be null); primes/offsets are HOST arrays of
// ntables. `rows` (rows a block, even, at most 64), `seg` (windows a
// segment, a multiple of 32) and `bit_words` (32-bit words of window bits
// a row, 0 for one round) come from core/sketch_kernels.py med_plan(L, k).
extern "C" int khmer_diginorm_med(const uint8_t* flat, int ntables,
                                  const int64_t* primes,
                                  const int64_t* offsets,
                                  const uint8_t* codes,
                                  const int32_t* lengths, int64_t nbundles,
                                  int L, int k, int cutoff, int rows,
                                  int seg, int bit_words, uint8_t* reject,
                                  int64_t* loads, int device, void* stream) {
  using namespace khmer_digi_med;
  khmer_byte::ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, offsets, &layout)
      || nbundles < 0 || k < 1 || k > 32 || L < k || rows < 2
      || rows > kMaxRows || rows % 2 || seg < 32 || seg % 32
      || bit_words < 0
      || (bit_words > 0 && int64_t{bit_words} * 32 < L - k + 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbundles == 0) return cudaSuccess;
  const int64_t smem = smem_bytes(rows, seg, bit_words);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(med_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t nrows = 2 * nbundles;
  med_kernel<<<static_cast<unsigned>((nrows + rows - 1) / rows), kBlock,
               static_cast<size_t>(smem),
               static_cast<cudaStream_t>(stream)>>>(
      codes, lengths, nrows, L, k, cutoff, rows, seg, bit_words, layout,
      flat, reject, reinterpret_cast<unsigned long long*>(loads));
  return cudaGetLastError();
}
