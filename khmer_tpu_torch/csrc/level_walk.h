// What the port's two walks share (tag_walk.cc, the partition walk;
// excursion_walk.cc, the knot pipeline's excursions): a node's neighbours
// and the pass driver.
//
// A walk runs a batch of traversals one breadth level of every traversal a
// pass. A pass shares the live traversals out over threads, a run of them
// each; a thread walks its run one traversal after another into a part of
// its own and writes their nodes to probe one after another, so that a
// level's nodes and the frontier lie in a few long arrays (the levels are
// short: a few nodes a traversal). The caller probes the frontier's
// neighbours on the card (kernel L or N, csrc/neighbors.cu): up go (f, r)
// of each node, back comes a byte, bit j set iff neighbour j is present
// (0-3: to the right with base code j, 4-7: to the left; codes A=0, T=1,
// C=2, G=3), which the next pass reads. The walk records the most bytes
// its traversals held at the end of a pass, so that the caller can size
// its next batch to its memory. level_walk.cc binds a walk's pass and
// frontier for the caller, and runs the whole walk against a probe
// (kt_level_run).
//
// A level lives in one block (level_block.h), which the walk keeps in
// storage of its own or in a buffer that the probe hands out (pinned host
// memory that goes up to the card in one copy, csrc/neighbors.cu).
#pragma once

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <thread>
#include <type_traits>
#include <vector>

#include "level_block.h"
#include "u64_set.h"

namespace khmer_host {

// the bases in the order the reference queues them: A, C, G, T
constexpr uint64_t kBaseOrder[4] = {0, 2, 3, 1};

// The neighbours of a node (f, r) of k-mers of size k.
struct KmerShift {
  explicit KmerShift(int k)
      : mask(k >= 32 ? ~0ULL : (1ULL << (2 * k)) - 1), shift(2 * k - 2) {}

  // calls fn(nf, nr) (or fn(nf, nr, j), j the neighbour's bit) for each
  // neighbour that the byte m says is present, to the right then to the
  // left, with the bases in kBaseOrder
  template <typename Fn>
  void each_child(uint64_t f, uint64_t r, unsigned m, Fn fn) const {
    for (int side = 0; side < 2; ++side) {
      for (uint64_t b : kBaseOrder) {
        const int j = 4 * side + static_cast<int>(b);
        if (!(m >> j & 1)) continue;
        uint64_t nf, nr;
        if (side == 0) {
          nf = ((f << 2) | b) & mask;
          nr = (r >> 2) | ((b ^ 1) << shift);
        } else {
          nf = (f >> 2) | (b << shift);
          nr = ((r << 2) | (b ^ 1)) & mask;
        }
        if constexpr (std::is_invocable_v<Fn, uint64_t, uint64_t, int>) {
          fn(nf, nr, j);
        } else {
          fn(nf, nr);
        }
      }
    }
  }

  uint64_t mask;
  int shift;
};

// A thread's share of a pass: the nodes to probe of its traversals, one
// after another, and which of its traversals go on.
struct PassPart {
  std::vector<uint64_t> sf, sr;
  std::vector<int64_t> live;
  size_t keeper_bytes = 0;  // its traversals' bytes, before frees

  void clear() {
    sf.clear();
    sr.clear();
    live.clear();
    keeper_bytes = 0;
  }
};

// Hands out a block for a level of n nodes, at least level_block_bytes(n)
// and 8-byte aligned (null if it cannot); the block of the level before is
// no longer read when it is called.
using BlockFn = void* (*)(void* ctx, int64_t n);

// What the C interface (level_walk.cc) reads of a walk.
class WalkBase {
 public:
  virtual ~WalkBase() = default;

  // One pass: masks holds the byte of each node of the last frontier (null
  // on the first pass), band (nullable) a second byte a node for a walk
  // that reads one. Returns the frontier's length, 0 once every traversal
  // has ended, -1 if no block could be had for it.
  virtual int64_t pass(const uint8_t* masks, const uint8_t* band) = 0;

  // The last pass's level: its frontier of n nodes and, after it, room
  // for the probe's bytes (the block above).
  uint64_t* frontier = nullptr;
  int64_t n = 0;
  size_t peak_keeper_bytes = 0;  // the most a pass's traversals held
  // whether each pass after the first takes band bytes (the banded tag walk)
  bool banded = false;
  // where the blocks come from: the walk's own storage while block_fn is
  // null
  BlockFn block_fn = nullptr;
  void* block_ctx = nullptr;
  // host seconds: walking the levels (the passes' threads), writing the
  // frontiers into their blocks, and in the probe (kt_level_run)
  double walk_s = 0, frontier_s = 0, probe_s = 0;
  int64_t levels = 0, nodes = 0;

 protected:
  // A block for a level of n nodes (see BlockFn).
  void* block(int64_t n) {
    if (block_fn != nullptr) return block_fn(block_ctx, n);
    own.resize((level_block_bytes(n) + 7) / 8);
    return own.data();
  }

 private:
  std::vector<uint64_t> own;
};

inline double seconds_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
      .count();
}

// The pass driver, over traversals Trav (with the start f0, r0 and lo,
// its first node in the frontier) and thread parts Part (a PassPart).
template <typename Trav, typename Part>
class LevelWalk : public WalkBase {
 public:
  LevelWalk(const uint64_t* start_f, const uint64_t* start_r, long long n,
            int k, int threads)
      : kmer(k), trav(n), parts(std::max(1, threads)) {
    for (long long i = 0; i < n; ++i) {
      trav[i].f0 = start_f[i];
      trav[i].r0 = start_r[i];
      live.push_back(i);
    }
  }

  int64_t pass(const uint8_t* masks, const uint8_t* band) override {
    constexpr int64_t kGrain = 64;  // traversals a thread takes at least
    const auto t0 = std::chrono::steady_clock::now();
    const int64_t nlive = static_cast<int64_t>(live.size());
    const int nt = static_cast<int>(std::max<int64_t>(
        1, std::min<int64_t>(parts.size(), nlive / kGrain)));
    auto run = [&](int p) {
      parts[p].clear();
      walk_run(masks, band, nlive * p / nt, nlive * (p + 1) / nt, parts[p]);
    };
    std::vector<std::thread> pool;
    for (int p = 1; p < nt; ++p) pool.emplace_back(run, p);
    run(0);
    for (auto& th : pool) th.join();
    const auto t1 = std::chrono::steady_clock::now();
    walk_s += std::chrono::duration<double>(t1 - t0).count();
    // the parts' nodes, one after another, into the frontier
    int64_t m = 0;
    size_t keeper_bytes = 0;
    for (int p = 0; p < nt; ++p) {
      m += static_cast<int64_t>(parts[p].sf.size());
      keeper_bytes += parts[p].keeper_bytes;
    }
    peak_keeper_bytes = std::max(peak_keeper_bytes, keeper_bytes);
    if (m > 0) {
      frontier = static_cast<uint64_t*>(block(m));
      if (frontier == nullptr) return -1;
    }
    n = m;
    live.clear();
    int64_t at = 0;
    for (int p = 0; p < nt; ++p) {
      const Part& q = parts[p];
      const size_t size = q.sf.size();
      std::memcpy(&frontier[at], q.sf.data(), 8 * size);
      std::memcpy(&frontier[m + at], q.sr.data(), 8 * size);
      gather(q, at, m);
      for (int64_t ti : q.live) {
        trav[ti].lo += at;
        live.push_back(ti);
      }
      at += static_cast<int64_t>(size);
    }
    frontier_s += seconds_since(t1);
    levels += m > 0;
    nodes += m;
    return m;
  }

  const KmerShift kmer;
  std::vector<Trav> trav;
  std::vector<int64_t> live;  // traversals with a level to walk

 protected:
  // Walk the traversals live[lo, hi) a level into the cleared part p: the
  // nodes each will have probed go to the end of p.sf, p.sr, its lo set to
  // the first of them within p, and those that go on to p.live.
  virtual void walk_run(const uint8_t* masks, const uint8_t* band,
                        int64_t lo, int64_t hi, Part& p) = 0;

  // Copy a part's own arrays, a value a node, to [at, at + its nodes) of
  // the frontier's n nodes.
  virtual void gather(const Part&, int64_t, int64_t) {}

  std::vector<Part> parts;  // one a thread
};

}  // namespace khmer_host
