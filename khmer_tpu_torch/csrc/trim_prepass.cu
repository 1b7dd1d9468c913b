// Kernel G's pre-pass: every bundle of a trim-low-abund pass-1 window
// against the tables as the window starts, in parallel, read only, so
// that the walk (csrc/trim_scan.cu) visits only the bundles whose answer
// an earlier bundle of the window can change.
//
// Part of the port of khmer_tpu/core/diginorm_scan.py:168
// (make_trim1_window); its plain PyTorch versions are
// khmer_tpu_torch/core/sketch_kernels.py:trim_mark_plain and
// trim_probe_plain (their composition: trim_classify_plain).
//
// Two launches a window, a warp a bundle (reads 2b and 2b + 1):
//   mark:  gather the min-over-tables count of every valid window; tally
//          per read the windows at or above trim_cov and digi_cov, window
//          0 below `cutoff` and the first later one that is; write the
//          bundle's branch and trim positions as of the window's start.
//          A bundle that would take branch 2 now is a CANDIDATE (state
//          LIVE): it sets the bit of every counter of every valid window,
//          in every table, in a set of 2^bits bits (the top `bits` bits of
//          counter * 2^64 / golden ratio). A bundle that is not is PROBE
//          if some window of it is below `cutoff`, PROBE_DIGI if besides
//          --diginorm's test fails (digi_cov then matters too), else
//          SETTLED.
//   probe: (after every mark) each PROBE bundle reloads its windows'
//          counters: it is LIVE iff for some window and some threshold X
//          that matters to it (cutoff; digi_cov for PROBE_DIGI) the count
//          is below X and every counter of the window below X is in the
//          set; else SETTLED.
// Why SETTLED is final (the walk never visits it): counts only rise, and
// only branch-2 bundles, all candidates, add. A bundle that passes
// trim_cov (or digi_cov) at the window's start passes it to the end, so a
// non-candidate is never consumed, and a window below X stays below X
// while one of its counters below X is never added to. Its outputs depend
// only on which windows are below cutoff and, when its --diginorm test
// fails at the start, below digi_cov. The set errs only towards LIVE (two
// counters may share a bit), which costs the walk a visit and changes no
// answer.
//
// What bounds it: DRAM serving the counters' random 32-byte sectors (T a
// window, the tables far beyond L2 at the sizes users run), as for kernel
// H, whose design this is: lanes take windows l, l + 32, ..., each loading
// its k codes at once and issuing its T counter loads together. The set,
// 2^16-2^27 bits (trim_plan, sized by the window), mostly sits in L2. No
// scratch beyond the set; the host clears it (cudaMemsetAsync) before the
// mark launch.

#include "byte_common.cuh"
#include "twobit_common.cuh"

namespace khmer_trim_pre {
namespace {

using khmer_byte::ByteLayout;
using khmer_byte::counter_index;
using khmer_cuda::kMaxCount;

// core/sketch_kernels.py TRIM_PRE_THREADS and the TRIM_* states
constexpr int kBlock = 256;
constexpr int kBundles = kBlock / 32;  // a warp a bundle
constexpr uint8_t kSettled = 0;
constexpr uint8_t kLive = 1;
constexpr uint8_t kProbe = 2;
constexpr uint8_t kProbeDigi = 3;
constexpr int kNone = 0x7fffffff;  // no bad window past the 0th
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kFib = 0x9E3779B97F4A7C15ULL;  // 2^64 / golden ratio

__device__ __forceinline__ uint32_t mark_bit(uint64_t counter, int bits) {
  return static_cast<uint32_t>((counter * kFib) >> (64 - bits));
}

__device__ __forceinline__ bool marked(const uint32_t* marks,
                                       uint64_t counter, int bits) {
  const uint32_t bit = mark_bit(counter, bits);
  return (marks[bit >> 5] >> (bit & 31)) & 1u;
}

// The trim position (hashtable.cc:504-533, as make_trim1_window takes it)
// of a read with `nvalid` windows: 0 if its window 0 is bad or it has one
// window, k + j - 1 for its first later bad window j, else nvalid + k - 1.
__device__ __forceinline__ int trim_pos(int nvalid, int bad0, int first_bad,
                                        int k) {
  if ((nvalid > 0 && bad0) || nvalid == 1) return 0;
  if (first_bad != kNone) return k + first_bad - 1;
  return nvalid + k - 1;
}

// median_at_least's threshold (nvalid + 1) / 2; an absent read passes.
__device__ __forceinline__ bool at_least(int ge, int nvalid) {
  return nvalid == 0 || ge >= (nvalid + 1) / 2;
}

// The canonical hash of window e of bundle b (read 0's windows first).
__device__ __forceinline__ uint64_t event_hash(const uint8_t* codes,
                                               int64_t b, int nv0, int e,
                                               int L, int k) {
  const int r = e >= nv0;
  return khmer_twobit::canonical_loads_first(
      codes + (2 * b + r) * L + (r ? e - nv0 : e), k);
}

__global__ void __launch_bounds__(kBlock)
mark_kernel(const uint8_t* __restrict__ codes,
            const int32_t* __restrict__ lengths, int64_t nbundles, int L,
            int k, int cutoff, int trim_cov, int digi_cov, int use_digi,
            int bits, const __grid_constant__ ByteLayout layout,
            const uint8_t* __restrict__ flat, uint32_t* marks,
            uint8_t* __restrict__ state, int32_t* __restrict__ branch,
            int32_t* __restrict__ trim_at,
            unsigned long long* __restrict__ n_cand) {
  __shared__ unsigned block_cand;
  if (threadIdx.x == 0) block_cand = 0;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int64_t b = blockIdx.x * static_cast<int64_t>(kBundles)
                    + threadIdx.x / 32;
  if (b < nbundles) {  // the whole warp
    const int W = L - k + 1;
    const int nv0 = min(khmer_twobit::n_windows(lengths[2 * b], k), W);
    const int nv1 = min(khmer_twobit::n_windows(lengths[2 * b + 1], k), W);
    const int nev = nv0 + nv1;
    const int T = layout.ntables;
    int ge_t[2] = {0, 0};
    int ge_d[2] = {0, 0};
    int bad0[2] = {0, 0};
    int first_bad[2] = {kNone, kNone};
    for (int e = lane; e < nev; e += 32) {
      const int r = e >= nv0;
      const int j = r ? e - nv0 : e;
      const uint64_t h = event_hash(codes, b, nv0, e, L, k);
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
      ge_t[r] = __reduce_add_sync(kFull, ge_t[r]);
      ge_d[r] = __reduce_add_sync(kFull, ge_d[r]);
      first_bad[r] = __reduce_min_sync(kFull, first_bad[r]);
      bad0[r] = __any_sync(kFull, bad0[r]);
    }
    const bool ok_trim = at_least(ge_t[0], nv0) && at_least(ge_t[1], nv1);
    const bool ok_digi = use_digi && at_least(ge_d[0], nv0)
                         && at_least(ge_d[1], nv1);
    const int br = ok_digi ? 0 : (ok_trim ? 1 : 2);
    if (lane == 0) {
      const bool low = bad0[0] || bad0[1] || first_bad[0] != kNone
                       || first_bad[1] != kNone;
      state[b] = br == 2 ? kLive
                 : (use_digi && !ok_digi) ? kProbeDigi
                 : low ? kProbe : kSettled;
      branch[b] = br;
      trim_at[2 * b] = trim_pos(nv0, bad0[0], first_bad[0], k);
      trim_at[2 * b + 1] = trim_pos(nv1, bad0[1], first_bad[1], k);
    }
    if (br == 2) {
      // a candidate: every counter it could add to goes into the set
      for (int e = lane; e < nev; e += 32) {
        const uint64_t h = event_hash(codes, b, nv0, e, L, k);
        for (int t = 0; t < T; ++t) {
          const uint32_t bit = mark_bit(counter_index(layout, h, t), bits);
          atomicOr(marks + (bit >> 5), 1u << (bit & 31));
        }
      }
      if (lane == 0) atomicAdd(&block_cand, 1u);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_cand && n_cand != nullptr) {
    atomicAdd(n_cand, static_cast<unsigned long long>(block_cand));
  }
}

__global__ void __launch_bounds__(kBlock)
probe_kernel(const uint8_t* __restrict__ codes,
             const int32_t* __restrict__ lengths, int64_t nbundles, int L,
             int k, int cutoff, int digi_cov, int bits,
             const __grid_constant__ ByteLayout layout,
             const uint8_t* __restrict__ flat,
             const uint32_t* __restrict__ marks,
             uint8_t* __restrict__ state) {
  const int lane = threadIdx.x % 32;
  const int64_t b = blockIdx.x * static_cast<int64_t>(kBundles)
                    + threadIdx.x / 32;
  if (b >= nbundles) return;  // the whole warp
  const uint8_t st = state[b];
  if (st != kProbe && st != kProbeDigi) return;
  const int dig = st == kProbeDigi ? digi_cov : -1;  // -1: no count below
  const int W = L - k + 1;
  const int nv0 = min(khmer_twobit::n_windows(lengths[2 * b], k), W);
  const int nev = nv0 + min(khmer_twobit::n_windows(lengths[2 * b + 1], k),
                            W);
  const int T = layout.ntables;
  bool hit = false;
  for (int e = lane; e < nev && !hit; e += 32) {
    const uint64_t h = event_hash(codes, b, nv0, e, L, k);
    int m = kMaxCount;
    for (int t = 0; t < T; ++t) {
      m = min(m, static_cast<int>(flat[counter_index(layout, h, t)]));
    }
    // the window can rise past X only if every counter below X is added to
    bool cut = m < cutoff;
    bool low = m < dig;
    if (!cut && !low) continue;
    for (int t = 0; t < T; ++t) {
      const uint64_t c = counter_index(layout, h, t);
      const int v = flat[c];
      if ((v < cutoff || v < dig) && !marked(marks, c, bits)) {
        cut = cut && v >= cutoff;
        low = low && v >= dig;
      }
    }
    hit = cut || low;
  }
  hit = __any_sync(kFull, hit);
  if (lane == 0) state[b] = hit ? kLive : kSettled;
}

}  // namespace
}  // namespace khmer_trim_pre

// The mark launch over bundles 0..nbundles-1 of codes [2 nbundles, L] /
// lengths [2 nbundles]: the set `marks` (2^bits bits, 32 a word) cleared
// and filled; state[b], branch[b], trim_at[2b], trim_at[2b + 1] for every
// b as of the window's start; the candidates added to *n_cand (may be
// null). cutoff, trim_cov and digi_cov are clamped to [-1, 256] by the
// caller; digi_cov counts only when use_digi is set. primes/offsets are
// HOST arrays of ntables; `bits` comes from core/sketch_kernels.py
// trim_plan.
extern "C" int khmer_trim_mark(const uint8_t* flat, int ntables,
                               const int64_t* primes,
                               const int64_t* offsets, const uint8_t* codes,
                               const int32_t* lengths, int64_t nbundles,
                               int L, int k, int cutoff, int trim_cov,
                               int digi_cov, int use_digi, int bits,
                               uint32_t* marks, uint8_t* state,
                               int32_t* branch, int32_t* trim_at,
                               int64_t* n_cand, int device, void* stream) {
  using namespace khmer_trim_pre;
  khmer_byte::ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, offsets, &layout)
      || nbundles < 0 || k < 1 || k > 32 || L < k || bits < 5
      || bits > 32) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbundles == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(marks, 0, (size_t{1} << bits) / 8, s);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (nbundles + kBundles - 1) / kBundles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  mark_kernel<<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
      codes, lengths, nbundles, L, k, cutoff, trim_cov, digi_cov,
      use_digi, bits, layout, flat, marks, state, branch, trim_at,
      reinterpret_cast<unsigned long long*>(n_cand));
  return cudaGetLastError();
}

// The probe launch: each PROBE / PROBE_DIGI bundle of `state` becomes LIVE
// or SETTLED against the set the mark launch filled. cutoff and digi_cov
// as for khmer_trim_mark (digi_cov matters only to PROBE_DIGI bundles).
extern "C" int khmer_trim_probe(const uint8_t* flat, int ntables,
                                const int64_t* primes,
                                const int64_t* offsets,
                                const uint8_t* codes, const int32_t* lengths,
                                int64_t nbundles, int L, int k, int cutoff,
                                int digi_cov, int bits,
                                const uint32_t* marks, uint8_t* state,
                                int device, void* stream) {
  using namespace khmer_trim_pre;
  khmer_byte::ByteLayout layout;
  if (!khmer_byte::make_layout(ntables, primes, offsets, &layout)
      || nbundles < 0 || k < 1 || k > 32 || L < k || bits < 5
      || bits > 32) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbundles == 0) return cudaSuccess;
  const int64_t blocks = (nbundles + kBundles - 1) / kBundles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  probe_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      codes, lengths, nbundles, L, k, cutoff, digi_cov, bits, layout, flat,
      marks, state);
  return cudaGetLastError();
}
