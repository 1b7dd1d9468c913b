// Exact stream-order read-modify-write of saturating u8 counters, through
// a persistent winner image.
//
// Used by the decoded-event blocked update (kernel D, proto_rmw.cu) alone:
// the blocked and byte updates (kernels 1 and A) moved to the bucketed
// single-pass core of bucket_common.cuh, which keeps no table-sized
// scratch. The event source `Ev` supplies
//
//   __device__ bool valid(int64_t i) const;
//   template <class F> __device__ void for_each_lane(int64_t i, F f) const;
//
// where for_each_lane calls f(flat counter index) once for each DISTINCT
// counter of event i.
//
// Semantics (sequential ByteStorage::add, reference storage.hh:571-624):
// each counter of each valid event gets +1, capped at 255; an event is new
// iff one of its counters was 0 at that moment. Hopper runs threads in no
// order, and the value an atomic returns cannot decide that, so the credit
// uses an equivalent rule: an event is new iff it is the lowest-index event
// of the chunk to touch a counter whose value before the chunk was 0.
// Three launches, in stream order:
//   1. claim:  atomicMin of the event index into the winner image, a
//              persistent int32 array of one entry per counter that holds
//              kIdxFill everywhere between chunks;
//   2. credit: winner == i && counter == 0, read before any increment;
//              each thread block adds its count with one 64-bit atomicAdd;
//              optionally the event's minimum pre-chunk counter;
//   3. commit: +1 per counter, capped at 255, by a CAS loop on the aligned
//              32-bit word (counters of different events share words), and
//              the reset of the winner entry to kIdxFill.
// Capped +1s commute, so the counters equal the sequential result; a
// duplicate of an event touches the same counters later, so only the
// first occurrence can win.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace khmer_rmw {

using khmer_cuda::grid_for;
using khmer_cuda::kMaxCount;
using khmer_cuda::kThreads;
using khmer_cuda::thread_index;

constexpr int32_t kIdxFill = 1 << 30;  // core/sketch_kernels.py IDX_FILL

// +1 on the u8 counter at `lane`, unless it holds 255. The word read is
// aligned down, so a buffer whose length is a multiple of 4 is never read
// past its end.
__device__ __forceinline__ void saturating_increment(uint8_t* table,
                                                     uint64_t lane) {
  unsigned int* word =
      reinterpret_cast<unsigned int*>(table + (lane & ~3ULL));
  const unsigned int shift = static_cast<unsigned int>(lane & 3) * 8;
  unsigned int old = *word;
  unsigned int assumed;
  do {
    assumed = old;
    if (((assumed >> shift) & 0xFFu) == kMaxCount) return;
    old = atomicCAS(word, assumed, assumed + (1u << shift));
  } while (old != assumed);
}

template <class Ev>
__global__ void claim_kernel(Ev ev, int64_t nvalid,
                             int32_t* __restrict__ winner) {
  const int64_t i = thread_index();
  if (i >= nvalid || !ev.valid(i)) return;
  ev.for_each_lane(i, [&](uint64_t lane) {
    atomicMin(&winner[lane], static_cast<int32_t>(i));
  });
}

// flags [m_total] (nullable): the event's new flag, false from nvalid on.
// min_old [nvalid] (nullable): the event's least counter before the chunk.
template <class Ev>
__global__ void credit_kernel(Ev ev, int64_t m_total, int64_t nvalid,
                              const uint8_t* __restrict__ table,
                              const int32_t* __restrict__ winner,
                              bool* __restrict__ flags,
                              uint8_t* __restrict__ min_old,
                              unsigned long long* __restrict__ n_new) {
  const int64_t i = thread_index();
  bool fresh = false;
  int lowest = kMaxCount;
  if (i < nvalid && ev.valid(i)) {
    ev.for_each_lane(i, [&](uint64_t lane) {
      const int value = table[lane];
      fresh |= (winner[lane] == static_cast<int32_t>(i)) && value == 0;
      lowest = min(lowest, value);
    });
  }
  if (flags != nullptr && i < m_total) flags[i] = fresh;
  if (min_old != nullptr && i < nvalid) {
    min_old[i] = static_cast<uint8_t>(lowest);
  }
  // every thread of the block reaches this barrier
  const int count = __syncthreads_count(fresh);
  if (threadIdx.x == 0 && count > 0) {
    atomicAdd(n_new, static_cast<unsigned long long>(count));
  }
}

template <class Ev>
__global__ void commit_kernel(Ev ev, int64_t nvalid,
                              uint8_t* __restrict__ table,
                              int32_t* __restrict__ winner) {
  const int64_t i = thread_index();
  if (i >= nvalid || !ev.valid(i)) return;
  ev.for_each_lane(i, [&](uint64_t lane) {
    saturating_increment(table, lane);
    winner[lane] = kIdxFill;
  });
}

// The three launches on stream s; events i < nvalid take part, the
// credit pass covers max(m_total, nvalid) threads.
template <class Ev>
cudaError_t launch_rmw(const Ev& ev, int64_t m_total, int64_t nvalid,
                       uint8_t* table, int32_t* winner, bool* flags,
                       uint8_t* min_old, unsigned long long* n_new,
                       cudaStream_t s) {
  cudaError_t err;
  if (nvalid > 0) {
    claim_kernel<<<grid_for(nvalid), kThreads, 0, s>>>(ev, nvalid, winner);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int64_t span = m_total > nvalid ? m_total : nvalid;
  if (span > 0) {
    credit_kernel<<<grid_for(span), kThreads, 0, s>>>(
        ev, m_total, nvalid, table, winner, flags, min_old, n_new);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (nvalid > 0) {
    commit_kernel<<<grid_for(nvalid), kThreads, 0, s>>>(ev, nvalid, table,
                                                        winner);
  }
  return cudaGetLastError();
}

}  // namespace khmer_rmw
