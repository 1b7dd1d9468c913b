// The perimeter sweep (sweep_for_tags) of a batch of sequences, on the
// host, one breadth level of every sweep a pass: the reference's
// SubsetPartition::sweep_for_tags (src/oxli/subset.cc:305-394), as JAX's
// native host engine runs it (hg_sweep_for_tags, which JAX's graphs run
// under KHMER_TPU_ENGINE=auto), made level-synchronous.
//
// A sweep queues every k-mer of its sequence at breadth 0, marking each
// traversed first, and gives up (with no tags) once more than
// BIG_TRAVERSALS_ARE times half its k-mers are traversed, where asked. It
// then pops the FIFO queue: a stop tag (where asked) is skipped; any other
// node is marked traversed and counted; a tag is recorded and not
// expanded; a node at the sweep's range is not expanded, and one past it
// ends the sweep with the tags so far; any other is expanded: the limit is
// tested again (the native engine tests it after every expansion, JAX's
// Python engine only while the queue is not empty), and its present
// neighbours not traversed at that moment are queued, to the right then to
// the left, with the bases in the order A, C, G, T. Entries are popped
// again when a node was queued twice.
//
// A queue holds one breadth level after another, so a pass pops a level of
// every sweep of the batch in queue order, and the caller probes the
// neighbours of all the nodes it expanded at once on the card (kernel L or
// N; level_walk.h). A traversed node carries the order it was marked in,
// and each expanded node the number marked when it was expanded, so "not
// traversed at that moment" is "not marked, or marked after that". The
// test against the limit runs when a node is expanded (the number marked
// cannot grow between a node's pop and its children's queueing), which
// ends a sweep where the queue walk would. Built with g++ at first use by
// khmer_tpu_torch/ops/host.py (SweepWalk).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "level_walk.h"

namespace {

using khmer_host::Keeper;
using khmer_host::LevelWalk;
using khmer_host::PassPart;
using khmer_host::U64Set;

constexpr int64_t kBigTraversalsAre = 200;  // reference subset.cc:54

struct Sweep {
  uint64_t f0 = 0, r0 = 0;  // unused: a sweep starts from its seeds
  int64_t s0 = 0, s1 = 0;   // its seeds in the walk's seed arrays
  Keeper traversed;         // canonical k-mer -> the order it was marked in
  std::vector<uint64_t> tagged;
  int64_t total = 0;        // nodes popped and counted
  int64_t breadth = 0;
  int64_t lo = 0, n = 0;    // its expanded nodes in the frontier
};

struct Part : PassPart {
  std::vector<uint64_t> f, r;  // the queued level
  std::vector<uint32_t> so;    // marked nodes when each was expanded

  void clear() {
    PassPart::clear();
    so.clear();
  }
};

class Walk : public LevelWalk<Sweep, Part> {
 public:
  using LevelWalk::LevelWalk;

  std::vector<uint64_t> seed_f, seed_r;
  U64Set tags{0};
  U64Set stops{0};
  int64_t max_breadth = 0;
  bool break_on_stop = false;
  bool stop_big = false;
  std::vector<uint32_t> order;  // marked nodes when each frontier node was

 protected:
  void walk_run(const uint8_t* masks, const uint8_t*, int64_t lo,
                int64_t hi, Part& p) override {
    for (int64_t i = lo; i < hi; ++i) {
      Sweep& t = trav[live[i]];
      p.f.clear();
      p.r.clear();
      bool goes_on;
      if (masks == nullptr) {
        for (int64_t s = t.s0; s < t.s1; ++s) {
          const uint64_t c = seed_f[s] < seed_r[s] ? seed_f[s] : seed_r[s];
          if (t.traversed.order(c) == 0) t.traversed.keep(c);
          p.f.push_back(seed_f[s]);
          p.r.push_back(seed_r[s]);
        }
        goes_on = !over(t) && walk_level(t, p);
      } else {
        queue_children(t, masks, p);
        ++t.breadth;
        goes_on = walk_level(t, p);
      }
      p.keeper_bytes += t.traversed.bytes();
      if (goes_on) {
        p.live.push_back(live[i]);
      } else {
        t.traversed = Keeper();  // ended: keep only its tags
      }
    }
  }

  void gather(const Part& p, int64_t at, int64_t n) override {
    order.resize(n);
    std::memcpy(&order[at], p.so.data(), 4 * p.so.size());
  }

 private:
  // whether the sweep has traversed more than its limit allows
  bool over(const Sweep& t) const {
    return stop_big && static_cast<int64_t>(t.traversed.size())
                           > kBigTraversalsAre * ((t.s1 - t.s0) / 2);
  }

  // Queue into p.f, p.r the present children of t's expanded nodes that
  // were not traversed when their parent was expanded, in the reference's
  // order.
  void queue_children(const Sweep& t, const uint8_t* masks, Part& p) const {
    const int64_t n = static_cast<int64_t>(order.size());
    for (int64_t i = t.lo; i < t.lo + t.n; ++i) {
      kmer.each_child(frontier[i], frontier[n + i], masks[i],
                      [&](uint64_t nf, uint64_t nr) {
        const uint32_t marked = t.traversed.order(nf < nr ? nf : nr);
        if (marked == 0 || marked > order[i]) {
          p.f.push_back(nf);
          p.r.push_back(nr);
        }
      });
    }
  }

  // Pop t's queued level p.f, p.r (the rules above); its expanded nodes go
  // to the end of p.sf, p.sr, p.so. Returns false when the sweep has
  // ended.
  bool walk_level(Sweep& t, Part& p) const {
    const size_t before = p.sf.size();
    auto end = [&]() {
      p.sf.resize(before);
      p.sr.resize(before);
      p.so.resize(before);
      t.n = 0;
      return false;
    };
    for (size_t i = 0; i < p.f.size(); ++i) {
      const uint64_t f = p.f[i], r = p.r[i];
      const uint64_t c = f < r ? f : r;
      if (break_on_stop && stops.contains(c)) continue;
      if (t.traversed.order(c) == 0) t.traversed.keep(c);
      ++t.total;
      if (tags.contains(c)) {
        t.tagged.push_back(c);
        continue;
      }
      if (t.breadth == max_breadth) continue;
      if (t.breadth > max_breadth) return end();
      if (over(t)) {
        t.tagged.clear();
        return end();
      }
      p.sf.push_back(f);
      p.sr.push_back(r);
      p.so.push_back(static_cast<uint32_t>(t.traversed.size()));
    }
    t.lo = static_cast<int64_t>(before);
    t.n = static_cast<int64_t>(p.sf.size() - before);
    return t.n > 0;
  }
};

Walk& walk_of(void* walk) {
  return *static_cast<Walk*>(static_cast<khmer_host::WalkBase*>(walk));
}

}  // namespace

extern "C" {

// A sweep of each of n sequences: sweep i's seeds, its k-mers (f, r) in
// order, are seed_f/seed_r[offsets[i], offsets[i + 1]); with the graph's
// tags and stop tags and the range max_breadth. level_walk.cc runs its
// passes.
void* kt_sweep_new(const uint64_t* seed_f, const uint64_t* seed_r,
                   const long long* offsets, long long n, int k,
                   const uint64_t* tags, long long n_tags,
                   const uint64_t* stops, long long n_stops,
                   long long max_breadth, int break_on_stop, int stop_big,
                   int threads) {
  std::vector<uint64_t> zeros(n, 0);
  Walk* w = new Walk(zeros.data(), zeros.data(), n, k, threads);
  const long long m = n ? offsets[n] : 0;
  w->seed_f.assign(seed_f, seed_f + m);
  w->seed_r.assign(seed_r, seed_r + m);
  for (long long i = 0; i < n; ++i) {
    w->trav[i].s0 = offsets[i];
    w->trav[i].s1 = offsets[i + 1];
  }
  w->tags = U64Set(static_cast<size_t>(n_tags));
  for (long long i = 0; i < n_tags; ++i) w->tags.insert(tags[i]);
  w->stops = U64Set(static_cast<size_t>(n_stops));
  for (long long i = 0; i < n_stops; ++i) w->stops.insert(stops[i]);
  w->max_breadth = max_breadth;
  w->break_on_stop = break_on_stop != 0;
  w->stop_big = stop_big != 0;
  return static_cast<khmer_host::WalkBase*>(w);
}

// Each sweep's distinct tags (counts[i]) and the nodes it counted
// (totals[i]), once the walk has ended.
void kt_sweep_counts(void* walk, long long* counts, long long* totals) {
  Walk& w = walk_of(walk);
  for (size_t i = 0; i < w.trav.size(); ++i) {
    std::vector<uint64_t>& t = w.trav[i].tagged;
    std::sort(t.begin(), t.end());
    t.erase(std::unique(t.begin(), t.end()), t.end());
    counts[i] = static_cast<long long>(t.size());
    totals[i] = w.trav[i].total;
  }
}

// The tags of every sweep, each ascending, one sweep after the other
// (after kt_sweep_counts).
void kt_sweep_tags(void* walk, uint64_t* out) {
  const Walk& w = walk_of(walk);
  for (const Sweep& t : w.trav) {
    std::memcpy(out, t.tagged.data(), 8 * t.tagged.size());
    out += t.tagged.size();
  }
}

}  // extern "C"
