// The block that holds a level of a walk (level_walk.h), shared by the
// host walks and the card's probe (csrc/neighbors.cu): the frontier, f of
// each of its n nodes then r of each (16 n bytes), then the probe's bytes,
// the masks and, in a banded walk, the band bytes (2 n bytes).
#pragma once

#include <cstddef>
#include <cstdint>

namespace khmer_host {

inline size_t level_block_bytes(int64_t n) {
  return 18 * static_cast<size_t>(n);
}

}  // namespace khmer_host
