// Kernel L: the 8-neighbour probe of the bit tables, and their gather.
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
// What bounds it: random bit reads. Each of the 8 T probes of a node reads
// one 32-byte sector of its own in tables far larger than L2 (4 GB at -x
// 8e9 -N 4), so the floor is the distinct sectors a launch reads, well
// above its 17 B a node.
//
// Design: one thread per node, which computes the eight canonical values
// and issues the loads of all eight in kGroup tables before it uses any
// (32 reads in flight a thread at T = 4); a later group of tables loads
// only the neighbours still present. h % p_t is by the reciprocal the host
// computes (byte_common.cuh counter_index), the joined buffer's bit offsets
// passed in place of its byte offsets, as kernel J does.

#include "byte_common.cuh"

namespace khmer_nbr {
namespace {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;
using khmer_cuda::kThreads;
using khmer_cuda::thread_index;

constexpr int kGroup = 4;  // tables whose loads a thread issues together

// Bits of `canon` present in tables [t0, t0 + kGroup) (all where absent).
template <int kN>
__device__ __forceinline__ unsigned group_bits(const ByteLayout& layout,
                                               const uint8_t* flat,
                                               const uint64_t* canon,
                                               unsigned live, int t0) {
  uint8_t v[kGroup][kN];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      v[g][j] = 1;
      if (t0 + g < layout.ntables && (live >> j & 1)) {
        const uint64_t b = counter_index(layout, canon[j], t0 + g);
        v[g][j] = flat[b >> 3] >> (b & 7) & 1;
      }
    }
  }
  unsigned out = live;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (!v[g][j]) out &= ~(1u << j);
    }
  }
  return out;
}

template <int kN>
__device__ __forceinline__ unsigned present_bits(const ByteLayout& layout,
                                                 const uint8_t* flat,
                                                 const uint64_t* canon) {
  unsigned live = (1u << kN) - 1;
  for (int t0 = 0; t0 < layout.ntables && live; t0 += kGroup) {
    live = group_bits<kN>(layout, flat, canon, live, t0);
  }
  return live;
}

__global__ void __launch_bounds__(kThreads)
neighbors_kernel(const uint64_t* __restrict__ f,
                 const uint64_t* __restrict__ r, int64_t n, uint64_t mask,
                 int shift, const __grid_constant__ ByteLayout layout,
                 const uint8_t* __restrict__ flat, uint8_t* __restrict__ out) {
  const int64_t i = thread_index();
  if (i >= n) return;
  const uint64_t fi = f[i], ri = r[i];
  uint64_t canon[8];
#pragma unroll
  for (uint64_t b = 0; b < 4; ++b) {
    const uint64_t rf = ((fi << 2) | b) & mask;
    const uint64_t rr = (ri >> 2) | ((b ^ 1) << shift);
    canon[b] = rf < rr ? rf : rr;
    const uint64_t lf = (fi >> 2) | (b << shift);
    const uint64_t lr = ((ri << 2) | (b ^ 1)) & mask;
    canon[4 + b] = lf < lr ? lf : lr;
  }
  out[i] = static_cast<uint8_t>(present_bits<8>(layout, flat, canon));
}

__global__ void __launch_bounds__(kThreads)
bit_gather_kernel(const uint64_t* __restrict__ hashes, int64_t n,
                  const __grid_constant__ ByteLayout layout,
                  const uint8_t* __restrict__ flat, int32_t* __restrict__ out) {
  const int64_t i = thread_index();
  if (i >= n) return;
  const uint64_t h = hashes[i];
  out[i] = static_cast<int32_t>(present_bits<1>(layout, flat, &h));
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
  neighbors_kernel<<<khmer_cuda::grid_for(n), kThreads, 0,
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
