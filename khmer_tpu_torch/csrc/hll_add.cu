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
// 32 codes and the complements of the first 32, as JAX tests it); then
// index = h & (2^p - 1), rho = clz64(h >> p) - p + 1 with clz64(0) = 64,
// and the register at index becomes max(itself, rho).
//
// What bounds it: integer work. Each window hashes 2k bytes through about
// a dozen 64-bit multiplies a hash; its inputs are one byte a window, its
// output 2^p bytes.
//
// Design.
// - A block takes tiles of kTile windows in turn (grid-stride): it stages
//   the tile's codes, kTile + k - 1 bytes, in shared memory, a read start
//   marked in a spare bit of its code. One warp finds the tile's first
//   read start by a 32-ary search (each lane probes one of 32 points a
//   round) while the others stage; then the block marks the tile's starts.
// - A thread slides over a run of kRun consecutive windows of the tile.
//   It keeps two 64-bit 2-bit words as it goes, one code in a step: f2,
//   the window's last 32 codes, last code least significant, and r2, the
//   complements of its first 32, first code least significant (JAX's
//   rolling_hash_windows words): the palindrome test is f2 == r2. For k
//   <= 32, r2 holds the complements of the forward strand's codes in byte
//   order and f2 the reverse complement's codes complemented, so murmur's
//   little-endian 8-byte words come from 4-code groups of them: each code
//   spread to a nibble, then one byte permutation (__byte_perm) of the
//   ASCII of the complements, kAsciiComp, for 4 bytes; at k 20, 5 steps a
//   strand in place of 2k shared-memory byte reads. For k > 32 the words
//   are rebuilt from the staged codes, a byte at a time (word_at).
// - A window's validity comes from the position of the last read start
//   the slide has passed: a start in (i, i + k - 1] is the latest one
//   entered by the window's last code and lies past i.
// - For p <= kSmemP (2^14 registers, the default -e 0.01) a block keeps
//   its own 32-bit registers in shared memory, 64 KB at p 14, raised by
//   atomicMax. At its end it merges them, four a 32-bit word of the
//   device's u8 registers, by a compare-and-swap of their bytewise
//   maximum (__vmaxu4; there is no u8 atomicMax), skipped where the
//   registers already hold as much (registers only grow, so a stale read
//   never skips wrongly): 2^p / 4 of them a block. Above kSmemP the
//   windows merge straight into the device's registers by that
//   compare-and-swap. u8 registers in shared memory (16 KB at p 14, four
//   a word, by the same compare-and-swap) measured 2.5 times slower on
//   9a's first block (PERF.md section 6): every block starts its
//   registers at 0, so most of its windows raise one, and a
//   compare-and-swap loop costs several times one atomicMax.
// - 512-thread blocks, two an SM (__launch_bounds__): occupancy comes from
//   the threads of a block, and the 2^p / 4 merges a block stay few.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace khmer_hll {
namespace {

constexpr int kThreads = 512;     // core/sketch_kernels.py HLL_THREADS
constexpr int kBlocksPerSm = 2;   // HLL_BLOCKS_PER_SM
// windows a thread slides over (HLL_RUN): 7 words, an odd number, so a
// warp's lanes read 32 distinct shared-memory banks
constexpr int kRun = 28;
constexpr int kTile = kThreads * kRun;  // windows a tile: HLL_TILE
constexpr int kSmemP = 14;              // HLL_SMEM_P
constexpr int kSlideMaxK = 32;          // k up to which words slide
constexpr uint32_t kStart = 4;          // a staged code's read-start mark
// byte c: the ASCII of code c ^ 1 ('T' 'A' 'G' 'C')
constexpr uint32_t kAsciiComp = 0x43474154u;

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

// Bytes [8m, 8m + 8) of a strand of k <= 32 bytes whose byte t is the
// ASCII of code c_t ^ 1, from w = sum c_t << 2t (zeros past k): the 8
// codes spread to one a nibble, then a byte permutation of kAsciiComp for
// each 4 (nibble j selects byte j).
__device__ __forceinline__ uint64_t ascii_word(uint64_t w, int k, int m) {
  uint32_t x = static_cast<uint32_t>(w >> (16 * m)) & 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  const uint64_t word =
      static_cast<uint64_t>(__byte_perm(kAsciiComp, 0, x >> 16)) << 32
      | __byte_perm(kAsciiComp, 0, x);
  const int n = k - 8 * m;  // bytes of the k-mer in this word
  return n >= 8 ? word : word & ((1ULL << (8 * n)) - 1);
}

// MurmurHash3_x64_128 (seed 0) of k bytes whose m-th little-endian 8-byte
// word (zero past k) is word(m); returns h1.
template <class Word>
__device__ __forceinline__ uint64_t murmur(int k, const Word& word) {
  uint64_t h1 = 0, h2 = 0;
  const int nblocks = k / 16;
  for (int b = 0; b < nblocks; ++b) {
    uint64_t k1 = word(2 * b);
    uint64_t k2 = word(2 * b + 1);
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
    uint64_t k2 = word(2 * nblocks + 1);
    k2 *= kC2;
    k2 = rotl(k2, 33);
    k2 *= kC1;
    h2 ^= k2;
  }
  if (tail > 0) {
    uint64_t k1 = word(2 * nblocks);
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

// The registers of one 32-bit word of a u8 register array (4-byte
// aligned) become their bytewise max with the bytes of `mine`; no write
// where they already hold as much.
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

// The index of the first of the ascending starts [n] above w0 (n when
// none is), found by the calling warp: each round its lanes probe 32
// evenly spaced entries of [lo, hi), which holds the answer or ends at it.
__device__ int64_t first_start_after(const int64_t* __restrict__ starts,
                                     int64_t n, int64_t w0) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t at = lo + (lane + 1) * step - 1;
    const bool below = at < hi && starts[at] <= w0;
    const int m = __popc(__ballot_sync(0xFFFFFFFFu, below));
    // entries up to probe m - 1 are <= w0; probe m is above w0 or past hi
    const int64_t probe_m = lo + (m + 1) * step - 1;
    lo += m * step;
    hi = probe_m < hi ? probe_m : hi;
  }
  return lo;
}

// Steps a thread's run of windows [i0, i1) of the staged tile; `regs` are
// the block's shared registers (kShared), else `registers` the device's.
template <bool kShared>
__device__ __forceinline__ void slide_run(const uint8_t* tile, int i0,
                                          int i1, int k, int p,
                                          uint32_t* regs,
                                          uint8_t* registers) {
  const int k32 = k < 32 ? k : 32;
  const uint64_t mask = ~0ULL >> (64 - 2 * k32);
  const int top = 2 * (k32 - 1);
  uint64_t f2 = 0;  // the last 32 codes, the last least significant
  uint64_t r2 = 0;  // complements of the first 32, the first least
  int last = -1;    // the latest read start entered
  for (int q = i0; q < i0 + k - 1; ++q) {
    const uint32_t b = tile[q];
    if (b & kStart) last = q;
    f2 = ((f2 << 2) | (b & 3u)) & mask;
    if (q < i0 + k32 - 1) {
      r2 = (r2 >> 2) | static_cast<uint64_t>((b & 3u) ^ 1u) << top;
    }
  }
  for (int i = i0; i < i1; ++i) {
    const uint32_t b = tile[i + k - 1];
    if (b & kStart) last = i + k - 1;
    f2 = ((f2 << 2) | (b & 3u)) & mask;
    const uint32_t c32 = k > 32 ? tile[i + 31] : b;  // code k32 - 1
    r2 = (r2 >> 2) | static_cast<uint64_t>((c32 & 3u) ^ 1u) << top;
    if (last > i) continue;  // a read starts inside the window
    uint64_t h, r;
    const bool pal = f2 == r2;
    if (k <= kSlideMaxK) {
      h = murmur(k, [&](int m) { return ascii_word(r2, k, m); });
      r = pal ? 0 : murmur(k, [&](int m) { return ascii_word(f2, k, m); });
    } else {
      const uint8_t* win = tile + i;
      auto fwd = [&](int m) {
        return word_at(win, k, 8 * m, min(8, k - 8 * m), false);
      };
      auto rev = [&](int m) {
        return word_at(win, k, 8 * m, min(8, k - 8 * m), true);
      };
      h = murmur(k, fwd);
      r = pal ? 0 : murmur(k, rev);
    }
    const uint64_t canon = h ^ r;
    const uint32_t index = static_cast<uint32_t>(canon)
                           & ((1u << p) - 1);
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

template <bool kShared>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
hll_add_kernel(const uint8_t* __restrict__ codes, int64_t fill,
               const int64_t* __restrict__ starts, int64_t nstarts, int k,
               int p, uint8_t* __restrict__ registers) {
  extern __shared__ uint32_t smem[];
  const int nc = 1 << p;
  // kShared: the block's registers, one a 32-bit word, then the tile
  const int nwords = kShared ? nc : 0;
  uint32_t* regs = smem;
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem + nwords);
  __shared__ int64_t first_start;
  for (int r = threadIdx.x; r < nwords; r += kThreads) regs[r] = 0;
  const int64_t nwin = fill - k + 1;
  for (int64_t w0 = blockIdx.x * static_cast<int64_t>(kTile); w0 < nwin;
       w0 += static_cast<int64_t>(gridDim.x) * kTile) {
    const int nw = nwin - w0 < kTile ? static_cast<int>(nwin - w0) : kTile;
    const int span = nw + k - 1;
    __syncthreads();  // the previous tile is done with `tile`
    if (threadIdx.x < 32) {
      // a start at w0 itself bounds no window of the tile
      const int64_t first = first_start_after(starts, nstarts, w0);
      if (threadIdx.x == 0) first_start = first;
    }
    for (int j = threadIdx.x; j < span; j += kThreads) {
      tile[j] = codes[w0 + j] & 3u;
    }
    __syncthreads();
    for (int64_t s = first_start + threadIdx.x; s < nstarts;
         s += kThreads) {
      const int64_t at = starts[s] - w0;
      if (at >= span) break;
      tile[at] |= kStart;
    }
    __syncthreads();
    const int i0 = threadIdx.x * kRun;
    const int i1 = i0 + kRun < nw ? i0 + kRun : nw;
    if (i0 < i1) slide_run<kShared>(tile, i0, i1, k, p, regs, registers);
  }
  if (!kShared) return;
  __syncthreads();
  for (int q = threadIdx.x; q < nc / 4; q += kThreads) {
    const uint32_t mine = regs[4 * q] | regs[4 * q + 1] << 8
                          | regs[4 * q + 2] << 16 | regs[4 * q + 3] << 24;
    if (mine != 0) max_word(reinterpret_cast<uint32_t*>(registers) + q, mine);
  }
}

template <bool kShared>
cudaError_t launch(const uint8_t* codes, int64_t fill, const int64_t* starts,
                   int64_t nstarts, int k, int p, uint8_t* registers,
                   int blocks, int smem, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      hll_add_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  hll_add_kernel<kShared><<<blocks, kThreads, smem, s>>>(
      codes, fill, starts, nstarts, k, p, registers);
  return cudaGetLastError();
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
    return launch<true>(codes, fill, starts, nstarts, k, p, registers,
                        blocks, (4 << p) + tile_bytes, s);
  }
  return launch<false>(codes, fill, starts, nstarts, k, p, registers,
                       blocks, tile_bytes, s);
}
