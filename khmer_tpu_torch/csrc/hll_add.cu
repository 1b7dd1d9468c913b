// Kernel K: the HyperLogLog add of a flat chunk, murmur and register max
// fused in one launch.
//
// Replaces khmer_tpu/core/hll.py:65 _make_add_batch (the scatter-max of
// rho into the registers) together with its hash, :300 _hll_flat_hash ->
// khmer_tpu/ops/hashing.py:437 murmur_hash_windows (:341
// _window_bytes_words, :370 _murmur3_x64_128_words), which XLA compiled.
// Its plain PyTorch version is khmer_tpu_torch/core/sketch_kernels.py:
// hll_add_plain.
//
// What it computes. A flat chunk is reads' 2-bit codes back to back, the
// ascending offsets of the reads that start in it and its fill. Window i is
// valid iff i + k <= fill and no read starts in (i, i + k - 1]. For each
// valid window: the ASCII bytes of the k-mer (A=0 T=1 C=2 G=3) and of its
// reverse complement (code ^ 1, read backwards), MurmurHash3_x64_128 (seed
// 0, h1) of each, h ^ r, or h for a palindrome (the 2-bit forward word of
// the window equal to its reverse word, the 64-bit words that keep the last
// 32 codes, as JAX tests it); then index = h & (2^p - 1), rho =
// clz64(h >> p) - p + 1 with clz64(0) = 64, and the register at index
// becomes max(itself, rho).
//
// What bounds it: integer work. Each window hashes 2k bytes through about
// a dozen 64-bit multiplies a hash; its inputs are one byte a window, its
// output 2^p bytes.
//
// Design. A block takes tiles of kTile windows in turn (grid-stride): it
// stages the tile's codes, kTile + k - 1 bytes, in shared memory with bit 7
// of a byte marking a read start (the starts of the tile found by one
// binary search over the chunk's starts), then each thread hashes its
// windows from shared memory, the forward bytes by reading up and the
// reverse complement's by reading down, 16 bytes a murmur block. For p <=
// kSmemP (2^14 registers, the default -e 0.01) the block keeps its own
// 32-bit registers in shared memory (atomicMax) and merges them once at its
// end, four registers a 32-bit word of the u8 registers, by a compare-and-
// swap of their bytewise maximum (there is no u8 atomicMax); above that the
// windows merge straight into the u8 registers by the same compare-and-swap,
// skipped where the register already holds as much (registers only grow,
// so a stale read never skips wrongly).

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace khmer_hll {
namespace {

constexpr int kThreads = 256;    // core/sketch_kernels.py HLL_THREADS
constexpr int kTile = 2048;      // windows a tile: HLL_TILE
constexpr int kSmemP = 14;       // HLL_SMEM_P
constexpr uint8_t kStart = 0x80; // a staged code's read-start mark

constexpr uint64_t kC1 = 0x87C37B91114253D5ULL;
constexpr uint64_t kC2 = 0x4CF5AD432745937FULL;

__device__ __forceinline__ uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fmix(uint64_t k) {
  k ^= k >> 33;
  k *= 0xFF51AFD7ED558CCDULL;
  k ^= k >> 33;
  k *= 0xC4CEB9FE1A85EC53ULL;
  k ^= k >> 33;
  return k;
}

// ASCII of a 2-bit code: 'A' 'T' 'C' 'G'
__device__ __forceinline__ uint64_t ascii(uint32_t code) {
  return (0x47435441u >> (8 * code)) & 0xFFu;
}

// Bytes [t0, t0 + n) of the window's k-mer (rc: of its reverse complement)
// packed little-endian into a word; win points at the window's first code.
__device__ __forceinline__ uint64_t word_at(const uint8_t* win, int k,
                                            int t0, int n, bool rc) {
  uint64_t w = 0;
  for (int b = 0; b < n; ++b) {
    const int t = t0 + b;
    const uint32_t c = rc ? (win[k - 1 - t] & 3u) ^ 1u : win[t] & 3u;
    w |= ascii(c) << (8 * b);
  }
  return w;
}

// MurmurHash3_x64_128 (seed 0) of the window's k bytes; returns h1.
__device__ uint64_t murmur(const uint8_t* win, int k, bool rc) {
  uint64_t h1 = 0, h2 = 0;
  const int nblocks = k / 16;
  for (int b = 0; b < nblocks; ++b) {
    uint64_t k1 = word_at(win, k, 16 * b, 8, rc);
    uint64_t k2 = word_at(win, k, 16 * b + 8, 8, rc);
    k1 *= kC1;
    k1 = rotl(k1, 31);
    k1 *= kC2;
    h1 ^= k1;
    h1 = rotl(h1, 27);
    h1 += h2;
    h1 = h1 * 5 + 0x52DCE729;
    k2 *= kC2;
    k2 = rotl(k2, 33);
    k2 *= kC1;
    h2 ^= k2;
    h2 = rotl(h2, 31);
    h2 += h1;
    h2 = h2 * 5 + 0x38495AB5;
  }
  const int tail = k % 16;
  if (tail > 8) {
    uint64_t k2 = word_at(win, k, 16 * nblocks + 8, tail - 8, rc);
    k2 *= kC2;
    k2 = rotl(k2, 33);
    k2 *= kC1;
    h2 ^= k2;
  }
  if (tail > 0) {
    uint64_t k1 = word_at(win, k, 16 * nblocks, tail < 8 ? tail : 8, rc);
    k1 *= kC1;
    k1 = rotl(k1, 31);
    k1 *= kC2;
    h1 ^= k1;
  }
  h1 ^= static_cast<uint64_t>(k);
  h2 ^= static_cast<uint64_t>(k);
  h1 += h2;
  h2 += h1;
  h1 = fmix(h1);
  h2 = fmix(h2);
  return h1 + h2;
}

// Registers idx..idx+3 of a u8 register array become their bytewise max
// with the bytes of `mine` (one 32-bit word, 4-byte aligned).
__device__ __forceinline__ void max_word(uint32_t* word, uint32_t mine) {
  uint32_t old = *reinterpret_cast<volatile uint32_t*>(word);
  for (;;) {
    const uint32_t want = __vmaxu4(old, mine);
    if (want == old) return;
    const uint32_t got = atomicCAS(word, old, want);
    if (got == old) return;
    old = got;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
hll_add_kernel(const uint8_t* __restrict__ codes, int64_t fill,
               const int64_t* __restrict__ starts, int64_t nstarts, int k,
               int p, uint8_t* __restrict__ registers) {
  extern __shared__ uint32_t smem[];
  const int nc = 1 << p;
  uint32_t* regs = smem;  // kShared: nc 32-bit registers
  uint8_t* tile = reinterpret_cast<uint8_t*>(kShared ? smem + nc : smem);
  __shared__ int64_t first_start;
  if (kShared) {
    for (int r = threadIdx.x; r < nc; r += kThreads) regs[r] = 0;
  }
  const int64_t nwin = fill - k + 1;
  for (int64_t w0 = blockIdx.x * static_cast<int64_t>(kTile); w0 < nwin;
       w0 += static_cast<int64_t>(gridDim.x) * kTile) {
    const int nw = nwin - w0 < kTile ? static_cast<int>(nwin - w0) : kTile;
    const int span = nw + k - 1;
    __syncthreads();  // the previous tile is done with `tile`
    for (int j = threadIdx.x; j < span; j += kThreads) {
      tile[j] = codes[w0 + j] & 3u;
    }
    if (threadIdx.x == 0) {
      // the first start > w0 (one at w0 itself bounds no window of the tile)
      int64_t lo = 0, hi = nstarts;
      while (lo < hi) {
        const int64_t mid = (lo + hi) / 2;
        if (starts[mid] <= w0) lo = mid + 1; else hi = mid;
      }
      first_start = lo;
    }
    __syncthreads();
    for (int64_t s = first_start + threadIdx.x; s < nstarts;
         s += kThreads) {
      const int64_t at = starts[s] - w0;
      if (at >= span) break;
      tile[at] |= kStart;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nw; i += kThreads) {
      const uint8_t* win = tile + i;
      bool valid = true;
      uint64_t f2 = 0, r2 = 0;
      for (int j = 0; j < k; ++j) {
        const uint8_t c = win[j];
        if (j > 0 && (c & kStart)) valid = false;
        const uint64_t code = c & 3u;
        if (k - 1 - j < 32) f2 |= code << (2 * (k - 1 - j));
        if (j < 32) r2 |= (code ^ 1u) << (2 * j);
      }
      if (!valid) continue;
      const uint64_t h = murmur(win, k, false);
      const uint64_t canon = f2 == r2 ? h : h ^ murmur(win, k, true);
      const uint32_t index = static_cast<uint32_t>(canon & (nc - 1));
      const uint64_t rest = canon >> p;
      const uint32_t rho = (rest ? __clzll(rest) : 64) - p + 1;
      if (kShared) {
        atomicMax(&regs[index], rho);
      } else {
        max_word(reinterpret_cast<uint32_t*>(registers) + (index >> 2),
                 rho << (8 * (index & 3)));
      }
    }
  }
  if (!kShared) return;
  __syncthreads();
  for (int q = threadIdx.x; q < nc / 4; q += kThreads) {
    const uint32_t mine = regs[4 * q] | regs[4 * q + 1] << 8
                          | regs[4 * q + 2] << 16 | regs[4 * q + 3] << 24;
    if (mine != 0) max_word(reinterpret_cast<uint32_t*>(registers) + q, mine);
  }
}

}  // namespace
}  // namespace khmer_hll

// Max the valid windows of the flat chunk codes [fill] (reads starting at
// the ascending offsets starts [nstarts]; entries >= fill ignored) into the
// 2^p u8 registers (4-byte aligned), on `blocks` blocks of stream s.
extern "C" int khmer_hll_add(const uint8_t* codes, int64_t fill,
                             const int64_t* starts, int64_t nstarts, int k,
                             int p, uint8_t* registers, int blocks,
                             int device, void* stream) {
  using namespace khmer_hll;
  if (k < 1 || k > kTile || p < 4 || p > 30 || fill < 0 || nstarts < 0
      || blocks < 1 || reinterpret_cast<uintptr_t>(registers) % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  if (fill < k) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile_bytes = (kTile + k - 1 + 3) / 4 * 4;
  if (p <= kSmemP) {
    const int smem = (4 << p) + tile_bytes;
    if ((err = cudaFuncSetAttribute(
             hll_add_kernel<true>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
        != cudaSuccess) {
      return err;
    }
    hll_add_kernel<true><<<blocks, kThreads, smem, s>>>(
        codes, fill, starts, nstarts, k, p, registers);
  } else {
    hll_add_kernel<false><<<blocks, kThreads, tile_bytes, s>>>(
        codes, fill, starts, nstarts, k, p, registers);
  }
  return cudaGetLastError();
}
