// Kernel Q: the nibble-layout count gather, the min over T prime tables of
// 4-bit counters; and kernel R, the same gather without the min: every
// table's counter. Each has a hashes-in entry and a window (rows) entry
// that hashes a [B, L] matrix of 2-bit codes itself.
//
// Q replaces khmer_tpu/core/sketch_kernels.py:649 (_gather_counts, nibble
// branch :660), an XLA gather on the TPU; its plain PyTorch version is
// khmer_tpu_torch/core/sketch_kernels.py:nibble_gather_plain. It serves a
// SmallCountgraph's get() and the abundance histogram's main count (with a
// mask: only the events the histogram counts load). Its rows mode,
// khmer_nibble_row_counts (plain: nibble_row_counts_plain), replaces
// khmer_tpu/core/pipeline.py:503 make_hash_batch then _get_fn for
// core/pipeline.py counts_for_records: the min over tables of each valid
// window, a byte a window. R replaces :681 (make_pertable_get, nibble
// branch :692); its plain version is nibble_pertable_plain, and it serves
// the knot pipeline's evaluation. Its rows mode,
// khmer_nibble_pertable_rows (plain: nibble_pertable_rows_plain), replaces
// khmer_tpu/core/diginorm.py:36 (make_pertable_counts, nibble branch :51)
// for diginorm's and trim's windows (core/diginorm.py SeqWindow): each
// valid window's hash, every table's counter and the flat nibble index it
// was read from, which numbers the window's (table, counter) pairs.
//
// The layout is kernel P's (nibble_update.cu): table t's counter b is the
// high nibble of byte offset_t + b / 2 for an even b, the low one for an
// odd b; as a flat nibble index, 2 * offset_t + b, the layout's offsets in
// nibbles, so one reduction (byte_common.cuh counter_index, by the
// reciprocal the host computes) gives byte and parity.
//
// What bounds them: random single-byte reads, one a table a hash, as for
// kernels B and M (byte_gather.cu): each costs a 32-byte sector, so the
// floor is the distinct sectors they read. At 4 GB of tables every random
// gather of the port runs near 25 G distinct sectors a second, whatever
// its loads in flight (PERF.md section 6), so the one lever is to read
// fewer sectors: no counter that no caller reads.
//
// Design. Q is B's: kPerThread hashes a thread, loaded as 16-byte pairs,
// the byte loads of all of them in up to kGroup tables issued before any is
// used, the minimum (from 15) out as int32 in 8-byte pairs; with a mask, a
// masked-off hash loads nothing and writes 0. R is M's: a thread a (hash,
// table), grid row y on table y, the counters loaded under an L2
// evict-last policy and the hashes and output streaming. The rows modes
// are kernel H's (read_counts.cu) layout of work: the grid covers (tile,
// segment) pairs of sketch_kernels.read_plan (a row longer than a segment
// spreads over several blocks); a block packs its rows' codes for its
// segment into 2-bit words in shared memory (twobit_common.cuh pack_word)
// and hashes each window from two of them (hash_at), with no pass over k
// codes; the segment's valid windows lie flat over the threads (a byte
// map gives each item's row), so no lane idles past a read's end and no
// window past it loads; a thread takes kRowBatch windows and issues their
// counter loads, kRowTables tables at a time, under the evict-last policy,
// before it uses any; each output is stored streaming, consecutive windows
// of a row on consecutive lanes. The windows past a read's end in the
// block's segment get the fill (hash 0, counter 0, index -1; a count of 0),
// stored a warp a row.

#include "byte_common.cuh"
#include "twobit_common.cuh"

namespace khmer_nibble {
namespace {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;

constexpr int kNibbleMax = 15;
constexpr int kPerThread = 8;
constexpr int kBlock = 128;
static_assert(kPerThread % 2 == 0, "hashes load in pairs");

// The counter at flat nibble `key` of the byte `v` that holds it.
__device__ __forceinline__ int nibble_of(unsigned v, uint64_t key) {
  return static_cast<int>((key & 1) ? v & 0xFu : v >> 4);
}

// Hashes j, j + 1 with j = base + 2 * (p * blockDim + threadIdx), p <
// kPerThread / 2, of the block's kPerThread * blockDim. `paired`: hashes
// 16-byte and out 8-byte aligned, so whole pairs move as vectors. `mask`
// (null: every hash): where its byte is 0 the hash loads nothing and its
// count is 0.
template <int kGroup>
__global__ void __launch_bounds__(kBlock)
gather_kernel(const uint64_t* __restrict__ hashes,
              const uint8_t* __restrict__ mask, int64_t n, bool paired,
              const __grid_constant__ ByteLayout layout,
              const uint8_t* __restrict__ flat, int32_t* __restrict__ out) {
  const int64_t base =
      blockIdx.x * static_cast<int64_t>(blockDim.x) * kPerThread;
  int64_t first[kPerThread / 2];
  uint64_t h[kPerThread];
  bool on[kPerThread];
#pragma unroll
  for (int p = 0; p < kPerThread / 2; ++p) {
    const int64_t j =
        base + 2 * (p * static_cast<int64_t>(blockDim.x) + threadIdx.x);
    first[p] = j;
    if (paired && j + 1 < n) {
      const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(hashes + j);
      h[2 * p] = v.x;
      h[2 * p + 1] = v.y;
    } else {
      h[2 * p] = j < n ? hashes[j] : 0;
      h[2 * p + 1] = j + 1 < n ? hashes[j + 1] : 0;
    }
    on[2 * p] = j < n && (mask == nullptr || mask[j]);
    on[2 * p + 1] = j + 1 < n && (mask == nullptr || mask[j + 1]);
  }
  int count[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) count[k] = kNibbleMax;
  for (int t0 = 0; t0 < layout.ntables; t0 += kGroup) {
    // each counter's byte, and its nibble's shift in it (an even index:
    // the high nibble); past the last table, or masked off, a byte of 0xFF
    unsigned v[kGroup][kPerThread];
    unsigned shift[kGroup][kPerThread];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const bool load = t0 + g < layout.ntables && on[k];
        const uint64_t key = load ? counter_index(layout, h[k], t0 + g) : 0;
        shift[g][k] = (key & 1) ? 0 : 4;
        v[g][k] = load ? flat[key >> 1] : 0xFFu;
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        count[k] = min(count[k],
                       static_cast<int>((v[g][k] >> shift[g][k]) & 0xFu));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) count[k] = on[k] ? count[k] : 0;
#pragma unroll
  for (int p = 0; p < kPerThread / 2; ++p) {
    const int64_t j = first[p];
    if (paired && j + 1 < n) {
      *reinterpret_cast<int2*>(out + j) =
          make_int2(count[2 * p], count[2 * p + 1]);
    } else {
      if (j < n) out[j] = count[2 * p];
      if (j + 1 < n) out[j + 1] = count[2 * p + 1];
    }
  }
}

template <int kGroup>
void launch(const uint64_t* hashes, const uint8_t* mask, int64_t n,
            bool paired, const ByteLayout& layout, const uint8_t* flat,
            int32_t* out, cudaStream_t s) {
  const int64_t per_block = int64_t{kBlock} * kPerThread;
  gather_kernel<kGroup>
      <<<static_cast<unsigned>((n + per_block - 1) / per_block), kBlock, 0,
         s>>>(hashes, mask, n, paired, layout, flat, out);
}

// Kernel R's cache hints, as kernel M's (byte_gather.cu).
constexpr int kPerTableBlock = 256;

__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t load_hash(const uint64_t* p) {
  uint64_t v;
  asm("ld.global.cs.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned load_counter(const uint8_t* p,
                                                 uint64_t policy) {
  unsigned v;
  asm("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;" : "=r"(v)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void store_counter(uint8_t* p, unsigned v) {
  asm volatile("st.global.cs.u8 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kPerTableBlock)
pertable_kernel(const uint64_t* __restrict__ hashes, int64_t n,
                const __grid_constant__ ByteLayout layout,
                const uint8_t* __restrict__ flat,
                uint8_t* __restrict__ out) {
  const int64_t i = khmer_cuda::thread_index();
  if (i >= n) return;
  const int t = blockIdx.y;
  const uint64_t key = counter_index(layout, load_hash(hashes + i), t);
  store_counter(out + t * n + i,
                static_cast<unsigned>(nibble_of(
                    load_counter(flat + (key >> 1), keep_policy()), key)));
}

__device__ __forceinline__ void store_u64(int64_t* p, int64_t v) {
  asm volatile("st.global.cs.s64 [%0], %1;" : : "l"(p), "l"(v) : "memory");
}

// The rows modes: sketch_kernels.py READ_THREADS, READ_MAX_ROWS (kernel
// H's plan, read_plan)
constexpr int kRowBlock = 256;
constexpr int kRowWarps = kRowBlock / 32;
constexpr int kMaxRows = 64;
constexpr int kRowBatch = 2;   // windows a thread takes at once
constexpr int kRowTables = 4;  // tables whose loads it issues at once
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared bytes of a block (read_counts.cu smem_bytes): for each
// row, the forward and reverse words of a segment and the row of each of
// its items.
inline int64_t row_smem_bytes(int rows, int seg) {
  return int64_t{rows} * (16 * (seg / 32 + 1) + seg);
}

// Windows w < W = L - k + 1 of rows [row0, row0 + rows) in the block's
// segment [s0, s0 + seg). kPerTable (R): hash_out[row][w] (int64 [nrows,
// W]), counter_out[t][row][w] (u8 [T, nrows, W]) and index_out[t][row][w]
// (int64 [T, nrows, W], the flat nibble index); else (Q) counter_out[row]
// [w] (u8 [nrows, W]), the least counter over the tables.
template <bool kPerTable>
__global__ void __launch_bounds__(kRowBlock)
rows_kernel(const uint8_t* __restrict__ codes,
            const int32_t* __restrict__ lengths, int64_t nrows, int L,
            int k, int rows_per_block, int seg, int nsegs,
            const __grid_constant__ ByteLayout layout,
            const uint8_t* __restrict__ flat, int64_t* __restrict__ hash_out,
            uint8_t* __restrict__ counter_out,
            int64_t* __restrict__ index_out) {
  __shared__ int nw_of[kMaxRows];          // valid windows of each row
  __shared__ int start_of[kMaxRows + 1];   // segment items before each row
  extern __shared__ uint64_t smem[];
  const int pw = seg / 32 + 1;
  uint64_t* fw = smem;
  uint64_t* rw = fw + rows_per_block * pw;
  uint8_t* rowmap = reinterpret_cast<uint8_t*>(rw + rows_per_block * pw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int W = L - k + 1;
  const int64_t plane = nrows * W;
  const int64_t tile = blockIdx.x / nsegs;
  const int s0 = static_cast<int>(blockIdx.x - tile * nsegs) * seg;
  const int s1 = min(s0 + seg, W);
  const int64_t row0 = tile * rows_per_block;
  const int rows = nrows - row0 < rows_per_block
                       ? static_cast<int>(nrows - row0) : rows_per_block;
  const int T = layout.ntables;
  if (tid < kMaxRows) {
    nw_of[tid] = tid < rows ? min(khmer_twobit::n_windows(
                                      lengths[row0 + tid], k), W)
                            : 0;
  }
  __syncthreads();
  if (warp == 0) {  // items of each row in this segment, their prefix
    int c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c[h] = min(max(nw_of[lane + 32 * h] - s0, 0), seg);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, c[h], d);
        if (lane >= d) c[h] += up;
      }
    }
    c[1] += __shfl_sync(kFull, c[0], 31);
    if (lane == 0) start_of[0] = 0;
    start_of[lane + 1] = c[0];
    start_of[lane + 33] = c[1];
  }
  // the fill of the segment's windows past each read's end, a warp a row
  for (int r = warp; r < rows; r += kRowWarps) {
    const int64_t at = (row0 + r) * W;
    for (int w = max(nw_of[r], s0) + lane; w < s1; w += 32) {
      if (kPerTable) {
        store_u64(hash_out + at + w, 0);
        for (int t = 0; t < T; ++t) {
          store_counter(counter_out + t * plane + at + w, 0);
          store_u64(index_out + t * plane + at + w, -1);
        }
      } else {
        store_counter(counter_out + at + w, 0);
      }
    }
  }
  __syncthreads();
  const int total = start_of[rows];
  if (total == 0) return;  // the same for the block
  for (int r = warp; r < rows; r += kRowWarps) {
    for (int i = start_of[r] + lane; i < start_of[r + 1]; i += 32) {
      rowmap[i] = static_cast<uint8_t>(r);
    }
  }
  // the words hash_at reads for a row's items: (items - 1) / 32 + 2
  for (int i = tid; i < rows * pw; i += kRowBlock) {
    const int r = i / pw;
    const int w = i - r * pw;
    const int items = start_of[r + 1] - start_of[r];
    if (items > 0 && w <= (items - 1) / 32 + 1) {
      khmer_twobit::pack_word(codes + (row0 + r) * L, s0 + 32 * w, L,
                              fw + i, rw + i);
    }
  }
  __syncthreads();
  const uint64_t policy = keep_policy();
  for (int base = 0; base < total; base += kRowBlock * kRowBatch) {
    bool act[kRowBatch];
    int64_t at[kRowBatch];
    uint64_t h[kRowBatch];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int i = base + u * kRowBlock + tid;
      act[u] = i < total;
      at[u] = 0;
      h[u] = 0;
      if (act[u]) {
        const int r = rowmap[i];
        const int q = i - start_of[r];
        at[u] = (row0 + r) * W + s0 + q;
        h[u] = khmer_twobit::hash_at(fw + r * pw, rw + r * pw, q, k);
        if (kPerTable) store_u64(hash_out + at[u], static_cast<int64_t>(h[u]));
      }
    }
    int m[kRowBatch];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) m[u] = kNibbleMax;
    for (int t0 = 0; t0 < T; t0 += kRowTables) {
      uint64_t key[kRowTables][kRowBatch];
      unsigned v[kRowTables][kRowBatch];
#pragma unroll
      for (int dt = 0; dt < kRowTables; ++dt) {
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u) {
          const bool load = t0 + dt < T && act[u];
          key[dt][u] = load ? counter_index(layout, h[u], t0 + dt) : 0;
          v[dt][u] = load ? load_counter(flat + (key[dt][u] >> 1), policy)
                          : 0xFFu;
        }
      }
#pragma unroll
      for (int dt = 0; dt < kRowTables; ++dt) {
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u) {
          if (!act[u] || t0 + dt >= T) continue;
          const int c = nibble_of(v[dt][u], key[dt][u]);
          if (kPerTable) {
            const int64_t o = (t0 + dt) * plane + at[u];
            store_counter(counter_out + o, static_cast<unsigned>(c));
            store_u64(index_out + o, static_cast<int64_t>(key[dt][u]));
          } else {
            m[u] = min(m[u], c);
          }
        }
      }
    }
    if (!kPerTable) {
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        if (act[u]) store_counter(counter_out + at[u], m[u]);
      }
    }
  }
}

// One launch of a rows mode; the checks of its C entry points.
template <bool kPerTable>
int launch_rows(const uint8_t* flat, int ntables, const int64_t* primes,
                const int64_t* nibble_offsets, const uint8_t* codes,
                const int32_t* lengths, int64_t nrows, int L, int k,
                int rows, int seg, int64_t* hash_out, uint8_t* counter_out,
                int64_t* index_out, int device, void* stream) {
  ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, nibble_offsets, &layout)
      || nrows < 0 || k < 1 || k > 32 || L < k || rows < 1
      || rows > kMaxRows || seg < 32 || seg % 32 || counter_out == nullptr
      || (kPerTable && (hash_out == nullptr || index_out == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const int64_t nsegs = (int64_t{L} - k + seg) / seg;
  const int64_t tiles = (nrows + rows - 1) / rows;
  if (tiles * nsegs > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nrows == 0) return cudaSuccess;
  const int64_t smem = row_smem_bytes(rows, seg);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rows_kernel<kPerTable>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rows_kernel<kPerTable><<<static_cast<unsigned>(tiles * nsegs), kRowBlock,
                           static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      codes, lengths, nrows, L, k, rows, seg, static_cast<int>(nsegs),
      layout, flat, hash_out, counter_out, index_out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace khmer_nibble

// out[i] = min(15, min over tables t of the nibble at flat nibble index
// nibble_offsets[t] + hashes[i] % primes[t]), for i < n: kernel Q. With
// `mask` (u8 [n], or null), out[i] = 0 and nothing loaded where mask[i] is
// 0. primes/nibble_offsets are HOST arrays of ntables.
extern "C" int khmer_nibble_gather(const uint8_t* flat, int ntables,
                                   const int64_t* primes,
                                   const int64_t* nibble_offsets,
                                   const int64_t* hashes, int64_t n,
                                   const uint8_t* mask, int32_t* out,
                                   int device, void* stream) {
  using namespace khmer_nibble;
  ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, nibble_offsets, &layout)
      || n < 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const uint64_t* h = reinterpret_cast<const uint64_t*>(hashes);
  const bool paired = reinterpret_cast<uintptr_t>(h) % 16 == 0
                      && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ntables) {
    case 1: launch<1>(h, mask, n, paired, layout, flat, out, s); break;
    case 2: launch<2>(h, mask, n, paired, layout, flat, out, s); break;
    case 3: launch<3>(h, mask, n, paired, layout, flat, out, s); break;
    case 4: launch<4>(h, mask, n, paired, layout, flat, out, s); break;
    default: launch<8>(h, mask, n, paired, layout, flat, out, s); break;
  }
  return cudaGetLastError();
}

// out[t * n + i] = the nibble at flat nibble index nibble_offsets[t] +
// hashes[i] % primes[t], for t < ntables and i < n: kernel R.
extern "C" int khmer_nibble_pertable(const uint8_t* flat, int ntables,
                                     const int64_t* primes,
                                     const int64_t* nibble_offsets,
                                     const int64_t* hashes, int64_t n,
                                     uint8_t* out, int device,
                                     void* stream) {
  using namespace khmer_nibble;
  ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, nibble_offsets, &layout)
      || n < 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>((n + kPerTableBlock - 1)
                                       / kPerTableBlock),
                  static_cast<unsigned>(ntables));
  pertable_kernel<<<grid, kPerTableBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint64_t*>(hashes), n, layout, flat, out);
  return cudaGetLastError();
}

// Kernel R's rows mode. For rows r < nrows of codes [nrows, L] (2-bit
// codes, a byte each) with lengths [nrows] and each window w < W = L - k +
// 1, k in [1, 32], the canonical twobit hash of codes[r][w, w + k) (as
// twobit_common.cuh canonical): where w <= lengths[r] - k, hashes[r][w] =
// the hash, and for each table t, index[t][r][w] = nibble_offsets[t] + hash
// % primes[t] and counters[t][r][w] = the nibble there; elsewhere hashes 0,
// counters 0 and index -1, and nothing loaded. `rows` (rows a tile, at
// most 64) and `seg` (windows a segment, a multiple of 32) come from
// core/sketch_kernels.py read_plan(L, k). primes/nibble_offsets are HOST
// arrays of ntables.
extern "C" int khmer_nibble_pertable_rows(
    const uint8_t* flat, int ntables, const int64_t* primes,
    const int64_t* nibble_offsets, const uint8_t* codes,
    const int32_t* lengths, int64_t nrows, int L, int k, int rows, int seg,
    int64_t* hashes, uint8_t* counters, int64_t* index, int device,
    void* stream) {
  return khmer_nibble::launch_rows<true>(
      flat, ntables, primes, nibble_offsets, codes, lengths, nrows, L, k,
      rows, seg, hashes, counters, index, device, stream);
}

// Kernel Q's rows mode: the same windows, counts[r][w] (u8 [nrows, W]) the
// least counter over the tables of each valid window's hash, 0 elsewhere.
extern "C" int khmer_nibble_row_counts(
    const uint8_t* flat, int ntables, const int64_t* primes,
    const int64_t* nibble_offsets, const uint8_t* codes,
    const int32_t* lengths, int64_t nrows, int L, int k, int rows, int seg,
    uint8_t* counts, int device, void* stream) {
  return khmer_nibble::launch_rows<false>(
      flat, ntables, primes, nibble_offsets, codes, lengths, nrows, L, k,
      rows, seg, nullptr, counts, nullptr, device, stream);
}
