// The C interface that the walks share (level_walk.h): a pass, its
// frontier, the whole walk against a probe, the traversals' peak bytes,
// the walk's clocks, and freeing the walk. Each walk's own file makes its
// walk (kt_walk_new, kt_sweep_new, kt_exc_new) and reads its results.
// Built with g++ at first use by khmer_tpu_torch/ops/host.py.

#include <chrono>
#include <cstring>

#include "level_walk.h"

using khmer_host::BlockFn;
using khmer_host::WalkBase;

namespace {

// A probe of a level: the frontier fr (f of each of its n nodes, then r)
// in, a byte a node out in masks and, for a banded walk, in band (null
// otherwise). Returns 0, or an error code that ends the walk.
using ProbeFn = int (*)(void* ctx, const uint64_t* fr, int64_t n,
                        uint8_t* masks, uint8_t* band);

}  // namespace

extern "C" {

// One pass of a walk stepped from the caller (no banded walk): masks, a
// byte a node of the last frontier (null on the first pass). Returns the
// nodes to probe next, 0 when the walk has ended; kt_level_frontier hands
// them out.
long long kt_level_pass(void* walk, const uint8_t* masks) {
  return static_cast<WalkBase*>(walk)->pass(masks, nullptr);
}

// The frontier of the last pass: f of each node, then r of each (2 n u64).
void kt_level_frontier(void* walk, uint64_t* out) {
  const WalkBase& w = *static_cast<WalkBase*>(walk);
  if (w.n > 0) std::memcpy(out, w.frontier, 16 * w.n);
}

// The whole walk: pass, probe the frontier, pass on its bytes, until a
// pass finds no node to probe. Each level's block (level_walk.h) comes
// from block(ctx, n) where block is given (the card's probe hands out
// pinned host memory, so that the frontier goes up in one copy), else from
// the walk's own storage; probe(ctx, ...) writes the bytes into the same
// block, after the frontier. Returns 0 once the walk has ended, the
// probe's code if it failed (the walk is then left where it stopped and
// holds no answer), or -1 if no block could be had.
int kt_level_run(void* walk, ProbeFn probe, BlockFn block, void* ctx) {
  WalkBase& w = *static_cast<WalkBase*>(walk);
  w.block_fn = block;
  w.block_ctx = ctx;
  const uint8_t* masks = nullptr;
  const uint8_t* band = nullptr;
  int err = 0;
  for (;;) {
    const int64_t n = w.pass(masks, band);
    if (n <= 0) {
      err = n < 0 ? -1 : 0;
      break;
    }
    uint8_t* bytes = reinterpret_cast<uint8_t*>(w.frontier + 2 * n);
    const auto t0 = std::chrono::steady_clock::now();
    err = probe(ctx, w.frontier, n, bytes, w.banded ? bytes + n : nullptr);
    w.probe_s += khmer_host::seconds_since(t0);
    if (err != 0) break;
    masks = bytes;
    band = w.banded ? bytes + n : nullptr;
  }
  w.block_fn = nullptr;
  w.block_ctx = nullptr;
  w.frontier = nullptr;
  w.n = 0;
  return err;
}

// The most bytes the traversals held at the end of a pass (before those of
// the traversals that ended in it were freed).
long long kt_level_keeper_bytes(void* walk) {
  return static_cast<long long>(
      static_cast<WalkBase*>(walk)->peak_keeper_bytes);
}

// The walk's clocks so far: levels probed, nodes probed, and host seconds
// walking the levels, writing the frontiers, and in the probes.
void kt_level_stats(void* walk, double* out) {
  const WalkBase& w = *static_cast<WalkBase*>(walk);
  out[0] = static_cast<double>(w.levels);
  out[1] = static_cast<double>(w.nodes);
  out[2] = w.walk_s;
  out[3] = w.frontier_s;
  out[4] = w.probe_s;
}

void kt_level_free(void* walk) { delete static_cast<WalkBase*>(walk); }

}  // extern "C"
