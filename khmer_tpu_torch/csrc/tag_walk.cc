// The partition walk (find_all_tags) of a batch of start tags, on the host,
// one breadth level of every traversal a pass: the reference's
// SubsetPartition::find_all_tags (src/oxli/subset.cc:213-300), as JAX's
// native host engine runs it (find_all_tags_one, which JAX's CLIs run
// under KHMER_TPU_ENGINE=auto), made level-synchronous.
//
// The reference walks a FIFO queue: before each pop, with
// stop_big_traversals, a keeper of more than BIG_TRAVERSALS_ARE nodes ends
// the traversal with no tags; a popped node already kept, or (with
// break_on_stop_tags) a stop tag, is skipped; any other is kept; a kept
// node that is a tag is recorded and not expanded, but for the first node
// expanded (the start); a node at max_breadth is not expanded; an expanded
// node queues each present neighbour not kept at that moment, to the right
// then to the left, with the bases in the order A, C, G, T.
//
// A queue holds one breadth level after another, so a pass walks a level
// of every traversal of the batch in queue order and the caller probes the
// neighbours of all the nodes it expanded at once on the card (kernel L,
// csrc/neighbors.cu): up go (f, r) of each, back comes a byte, bit j set
// iff neighbour j is present (0-3: to the right with base code j, 4-7: to
// the left; codes A=0, T=1, C=2, G=3). The next pass queues the children:
// each kept node carries its keeping order, so "not kept at that moment"
// is "not kept, or kept after its parent". Every queued entry, repeats and
// nodes kept since they were queued included, is popped and meets the
// keeper's size test, as in the reference. (JAX's level walk, the device
// engine's _walk_level, queues children without that test and drops
// repeats within a level, and so cuts some traversals that the reference
// and the native engine let finish.)
//
// A pass shares the live traversals out over threads, a run of them each;
// a thread walks its run one traversal after another and writes their
// expanded nodes one after another, so that a level's entries and a
// frontier lie in a few long arrays (the levels are short: a few nodes a
// traversal). Each traversal keeps its own keeper, freed when it ends; the
// walk records the most bytes its keepers held at the end of a pass, so that
// the caller can size its next batch to its memory.
// Built with g++ at first use by khmer_tpu_torch/ops/host.py (TagWalk).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "u64_set.h"

namespace {

using khmer_host::mix64;
using khmer_host::U64Set;

constexpr size_t kBigTraversalsAre = 200;  // reference subset.cc:54
// the bases in the order the reference queues them: A, C, G, T
constexpr uint64_t kBaseOrder[4] = {0, 2, 3, 1};

// The keeper: canonical k-mer -> the order it was kept in (1, 2, ...), in
// open addressing (linear probing, at most 70% full; order 0: empty).
class Keeper {
 public:
  Keeper() { reset(64); }

  // its order, 0 if not kept
  uint32_t order(uint64_t v) const {
    for (size_t i = slot(v);; i = (i + 1) & mask_) {
      if (order_[i] == 0) return 0;
      if (keys_[i] == v) return order_[i];
    }
  }

  // keep v (not kept yet); returns its order
  uint32_t keep(uint64_t v) {
    if ((n_ + 1) * 10 >= keys_.size() * 7) grow();
    const uint32_t o = static_cast<uint32_t>(++n_);
    put(v, o);
    return o;
  }

  size_t size() const { return n_; }

  // the bytes its slots take
  size_t bytes() const { return keys_.size() * (8 + 4); }

 private:
  size_t slot(uint64_t v) const {
    return static_cast<size_t>(mix64(v)) & mask_;
  }

  void put(uint64_t v, uint32_t o) {
    size_t i = slot(v);
    while (order_[i] != 0) i = (i + 1) & mask_;
    keys_[i] = v;
    order_[i] = o;
  }

  void reset(size_t cap) {
    keys_.assign(cap, 0);
    order_.assign(cap, 0);
    mask_ = cap - 1;
  }

  void grow() {
    std::vector<uint64_t> keys = std::move(keys_);
    std::vector<uint32_t> order = std::move(order_);
    reset(keys.size() * 2);
    for (size_t i = 0; i < keys.size(); ++i) {
      if (order[i] != 0) put(keys[i], order[i]);
    }
  }

  std::vector<uint64_t> keys_;
  std::vector<uint32_t> order_;
  size_t mask_ = 0;
  size_t n_ = 0;
};

struct Traversal {
  uint64_t f0, r0;  // the start
  Keeper keeper;
  std::vector<uint64_t> tagged;
  uint32_t breadth = 0;
  bool first = true;
  int64_t lo = 0, n = 0;  // its expanded nodes in the frontier
};

// A thread's share of a pass, for a run of the live traversals: the level
// it is walking, then its traversals' expanded nodes one after another.
struct Part {
  std::vector<uint64_t> f, r;    // the queued level
  std::vector<uint64_t> sf, sr;  // the expanded nodes
  std::vector<uint32_t> so;      // and their keeping order
  std::vector<int64_t> live;     // its traversals that go on
  size_t keeper_bytes = 0;       // its traversals' keepers, before frees
};

struct Walk {
  uint64_t mask;
  int shift;
  U64Set tags{0};
  U64Set stops{0};
  uint32_t max_breadth;
  bool break_on_stop;
  bool stop_big;
  int threads;
  std::vector<Traversal> trav;
  std::vector<int64_t> live;       // traversals with a level to walk
  std::vector<uint64_t> frontier;  // f of each expanded node, then r
  std::vector<uint32_t> order;     // the keeping order of each
  std::vector<Part> parts;         // one a thread
  size_t peak_keeper_bytes = 0;    // the most a pass's keepers held
};

// Queue into p.f, p.r the present children of t's expanded nodes (in the
// frontier, each with its byte of `masks`) that were not kept when their
// parent was expanded, in the reference's order.
void queue_children(const Walk& w, const Traversal& t, const uint8_t* masks,
                    Part& p) {
  const int64_t n = static_cast<int64_t>(w.order.size());
  for (int64_t i = t.lo; i < t.lo + t.n; ++i) {
    const uint64_t f = w.frontier[i], r = w.frontier[n + i];
    const unsigned m = masks[i];
    for (int side = 0; side < 2; ++side) {
      for (uint64_t b : kBaseOrder) {
        if (!(m >> (4 * side + b) & 1)) continue;
        uint64_t nf, nr;
        if (side == 0) {
          nf = ((f << 2) | b) & w.mask;
          nr = (r >> 2) | ((b ^ 1) << w.shift);
        } else {
          nf = (f >> 2) | (b << w.shift);
          nr = ((r << 2) | (b ^ 1)) & w.mask;
        }
        const uint32_t kept = t.keeper.order(nf < nr ? nf : nr);
        if (kept == 0 || kept > w.order[i]) {
          p.f.push_back(nf);
          p.r.push_back(nr);
        }
      }
    }
  }
}

// Pop t's queued level p.f, p.r (the rules above); its expanded nodes go
// to the end of p.sf, p.sr, p.so. Returns false when the traversal has
// ended.
bool walk_level(const Walk& w, Traversal& t, Part& p) {
  const size_t before = p.sf.size();
  for (size_t i = 0; i < p.f.size(); ++i) {
    if (w.stop_big && t.keeper.size() > kBigTraversalsAre) {
      t.tagged.clear();
      p.sf.resize(before);
      p.sr.resize(before);
      p.so.resize(before);
      return false;
    }
    const uint64_t f = p.f[i], r = p.r[i];
    const uint64_t c = f < r ? f : r;
    if (t.keeper.order(c) != 0) continue;
    if (w.break_on_stop && w.stops.contains(c)) continue;
    const uint32_t kept = t.keeper.keep(c);
    if (!t.first && w.tags.contains(c)) {
      t.tagged.push_back(c);
      continue;
    }
    if (t.breadth >= w.max_breadth) continue;
    p.sf.push_back(f);
    p.sr.push_back(r);
    p.so.push_back(kept);
    t.first = false;
  }
  t.lo = static_cast<int64_t>(before);
  t.n = static_cast<int64_t>(p.sf.size() - before);
  return t.n > 0;
}

// A pass over the live traversals live[lo, hi) into part p.
void walk_run(Walk& w, const uint8_t* masks, int64_t lo, int64_t hi,
              Part& p) {
  p.sf.clear();
  p.sr.clear();
  p.so.clear();
  p.live.clear();
  p.keeper_bytes = 0;
  for (int64_t i = lo; i < hi; ++i) {
    Traversal& t = w.trav[w.live[i]];
    p.f.clear();
    p.r.clear();
    if (masks == nullptr) {
      p.f.push_back(t.f0);
      p.r.push_back(t.r0);
    } else {
      queue_children(w, t, masks, p);
      ++t.breadth;
    }
    const bool goes_on = walk_level(w, t, p);
    p.keeper_bytes += t.keeper.bytes();
    if (goes_on) {
      p.live.push_back(w.live[i]);
    } else {
      t.keeper = Keeper();  // ended: keep only its tags
    }
  }
}

}  // namespace

extern "C" {

// A walk from n start k-mers (f, r), with the graph's tags and stop tags.
void* kt_walk_new(const uint64_t* start_f, const uint64_t* start_r,
                  long long n, int k, const uint64_t* tags, long long n_tags,
                  const uint64_t* stops, long long n_stops, int max_breadth,
                  int break_on_stop, int stop_big, int threads) {
  Walk* w = new Walk();
  w->mask = k >= 32 ? ~0ULL : (1ULL << (2 * k)) - 1;
  w->shift = 2 * k - 2;
  w->tags = U64Set(static_cast<size_t>(n_tags));
  for (long long i = 0; i < n_tags; ++i) w->tags.insert(tags[i]);
  w->stops = U64Set(static_cast<size_t>(n_stops));
  for (long long i = 0; i < n_stops; ++i) w->stops.insert(stops[i]);
  w->max_breadth = static_cast<uint32_t>(max_breadth);
  w->break_on_stop = break_on_stop != 0;
  w->stop_big = stop_big != 0;
  w->threads = std::max(1, threads);
  w->parts.resize(w->threads);
  w->trav.resize(n);
  for (long long i = 0; i < n; ++i) {
    w->trav[i].f0 = start_f[i];
    w->trav[i].r0 = start_r[i];
    w->live.push_back(i);
  }
  return w;
}

void kt_walk_free(void* walk) { delete static_cast<Walk*>(walk); }

// One pass: queue the children of the last frontier that `masks` (a byte a
// node) says are present (null on the first pass), then pop a level of
// every live traversal. Each thread takes a run of the live traversals.
// Returns the nodes expanded, to probe next, 0 when the walk has ended;
// kt_walk_frontier hands them out.
long long kt_walk_pass(void* walk, const uint8_t* masks) {
  constexpr int64_t kGrain = 64;  // traversals a thread takes at least
  Walk& w = *static_cast<Walk*>(walk);
  const int64_t live = static_cast<int64_t>(w.live.size());
  const int nt = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(w.threads, live / kGrain)));
  auto run = [&](int p) {
    walk_run(w, masks, live * p / nt, live * (p + 1) / nt, w.parts[p]);
  };
  std::vector<std::thread> pool;
  for (int p = 1; p < nt; ++p) pool.emplace_back(run, p);
  run(0);
  for (auto& th : pool) th.join();
  // the parts' expanded nodes, one after another, into the frontier
  int64_t n = 0;
  size_t keeper_bytes = 0;
  for (int p = 0; p < nt; ++p) {
    n += static_cast<int64_t>(w.parts[p].so.size());
    keeper_bytes += w.parts[p].keeper_bytes;
  }
  w.peak_keeper_bytes = std::max(w.peak_keeper_bytes, keeper_bytes);
  w.frontier.resize(2 * n);
  w.order.resize(n);
  w.live.clear();
  int64_t at = 0;
  for (int p = 0; p < nt; ++p) {
    const Part& q = w.parts[p];
    const size_t m = q.so.size();
    std::memcpy(&w.frontier[at], q.sf.data(), 8 * m);
    std::memcpy(&w.frontier[n + at], q.sr.data(), 8 * m);
    std::memcpy(&w.order[at], q.so.data(), 4 * m);
    for (int64_t ti : q.live) {
      w.trav[ti].lo += at;
      w.live.push_back(ti);
    }
    at += static_cast<int64_t>(m);
  }
  return n;
}

// The frontier of the last pass: f of each node, then r of each (2 n u64).
void kt_walk_frontier(void* walk, uint64_t* out) {
  const Walk& w = *static_cast<Walk*>(walk);
  std::memcpy(out, w.frontier.data(), 8 * w.frontier.size());
}

// The most bytes the keepers held at the end of a pass (before the keepers
// of the traversals that ended in it were freed).
long long kt_walk_keeper_bytes(void* walk) {
  return static_cast<long long>(static_cast<Walk*>(walk)->peak_keeper_bytes);
}

// The number of tags each traversal found, once the walk has ended.
void kt_walk_counts(void* walk, long long* out) {
  const Walk& w = *static_cast<Walk*>(walk);
  for (size_t i = 0; i < w.trav.size(); ++i) out[i] = w.trav[i].tagged.size();
}

// The tags of every traversal, each ascending, one traversal after the
// other.
void kt_walk_tags(void* walk, uint64_t* out) {
  Walk& w = *static_cast<Walk*>(walk);
  for (Traversal& t : w.trav) {
    std::sort(t.tagged.begin(), t.tagged.end());
    std::memcpy(out, t.tagged.data(), 8 * t.tagged.size());
    out += t.tagged.size();
  }
}

}  // extern "C"
