// The C interface that both walks share (level_walk.h): a pass, its
// frontier, the traversals' peak bytes, and freeing the walk. Each walk's
// own file makes its walk (kt_walk_new, kt_exc_new) and reads its results.
// Built with g++ at first use by khmer_tpu_torch/ops/host.py.

#include <cstring>

#include "level_walk.h"

using khmer_host::WalkBase;

extern "C" {

// One pass: masks, a byte a node of the last frontier (null on the first
// pass), and band (nullable), the banded tag walk's band bytes of the same
// nodes (csrc/tag_walk.cc). Returns the nodes to probe next, 0 when the
// walk has ended; kt_level_frontier hands them out.
long long kt_level_pass(void* walk, const uint8_t* masks,
                        const uint8_t* band) {
  return static_cast<WalkBase*>(walk)->pass(masks, band);
}

// The frontier of the last pass: f of each node, then r of each (2 n u64).
void kt_level_frontier(void* walk, uint64_t* out) {
  const WalkBase& w = *static_cast<WalkBase*>(walk);
  std::memcpy(out, w.frontier.data(), 8 * w.frontier.size());
}

// The most bytes the traversals held at the end of a pass (before those of
// the traversals that ended in it were freed).
long long kt_level_keeper_bytes(void* walk) {
  return static_cast<long long>(
      static_cast<WalkBase*>(walk)->peak_keeper_bytes);
}

void kt_level_free(void* walk) { delete static_cast<WalkBase*>(walk); }

}  // extern "C"
