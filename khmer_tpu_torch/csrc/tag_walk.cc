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
// of every traversal of the batch in queue order, and the caller probes
// the neighbours of all the nodes it expanded at once (level_walk.h). The
// next pass queues the children: each kept node carries its keeping
// order, so "not kept at that moment" is "not kept, or kept after its
// parent". Every queued entry, repeats and nodes kept since they were
// queued included, is popped and meets the keeper's size test, as in the
// reference. (JAX's level walk, the device engine's _walk_level, queues
// children without that test and drops repeats within a level, and so
// cuts some traversals that the reference and the native engine let
// finish.) Each traversal keeps its own keeper, freed when it ends.
//
// The abundance-truncated walk (the reference's
// find_all_tags_truncate_on_abundance, subset.cc:399-496, as JAX's
// native engine's find_all_tags_one runs it) tests each popped node's count
// against a band after the keeper and stop-tag tests and before it is
// kept: a node out of the band is popped (so it meets the size test) but
// never kept, and the tag test never sees it. The caller gives the band's
// verdict on each start when the walk is made and, with each level's
// neighbour bytes, a second byte a node, bit j set iff neighbour j is in
// the band (kernel N); a child is queued by the presence byte alone, as in
// the reference.
// Built with g++ at first use by khmer_tpu_torch/ops/host.py (TagWalk).

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

constexpr size_t kBigTraversalsAre = 200;  // reference subset.cc:54

struct Traversal {
  uint64_t f0, r0;  // the start
  Keeper keeper;
  std::vector<uint64_t> tagged;
  uint32_t breadth = 0;
  bool first = true;
  int64_t lo = 0, n = 0;  // its expanded nodes in the frontier
};

// A thread's share of a pass: the level it is walking, then its
// traversals' expanded nodes (sf, sr) and their keeping order.
struct Part : PassPart {
  std::vector<uint64_t> f, r;  // the queued level
  std::vector<uint8_t> ok;     // whether each is in the band (banded walk)
  std::vector<uint32_t> so;

  void clear() {
    PassPart::clear();
    so.clear();
  }
};

class Walk : public LevelWalk<Traversal, Part> {
 public:
  using LevelWalk::LevelWalk;

  U64Set tags{0};
  U64Set stops{0};
  uint32_t max_breadth = 0;
  bool break_on_stop = false;
  bool stop_big = false;
  std::vector<uint32_t> order;  // the keeping order of each frontier node
  // the banded walk (WalkBase::banded): each start's verdict (each later
  // pass takes the band bytes of the last frontier)
  std::vector<uint8_t> start_ok;

 protected:
  void walk_run(const uint8_t* masks, const uint8_t* band, int64_t lo,
                int64_t hi, Part& p) override {
    for (int64_t i = lo; i < hi; ++i) {
      Traversal& t = trav[live[i]];
      p.f.clear();
      p.r.clear();
      p.ok.clear();
      if (masks == nullptr) {
        p.f.push_back(t.f0);
        p.r.push_back(t.r0);
        if (banded) p.ok.push_back(start_ok[live[i]]);
      } else {
        queue_children(t, masks, band, p);
        ++t.breadth;
      }
      const bool goes_on = walk_level(t, p);
      p.keeper_bytes += t.keeper.bytes();
      if (goes_on) {
        p.live.push_back(live[i]);
      } else {
        t.keeper = Keeper();  // ended: keep only its tags
      }
    }
  }

  void gather(const Part& p, int64_t at, int64_t n) override {
    order.resize(n);
    std::memcpy(&order[at], p.so.data(), 4 * p.so.size());
  }

 private:
  // Queue into p.f, p.r the present children of t's expanded nodes (in
  // the frontier, each with its byte of `masks`, and of `band` in a banded
  // walk) that were not kept when their parent was expanded, in the
  // reference's order.
  void queue_children(const Traversal& t, const uint8_t* masks,
                      const uint8_t* band, Part& p) const {
    const int64_t n = static_cast<int64_t>(order.size());
    for (int64_t i = t.lo; i < t.lo + t.n; ++i) {
      kmer.each_child(frontier[i], frontier[n + i], masks[i],
                      [&](uint64_t nf, uint64_t nr, int j) {
        const uint32_t kept = t.keeper.order(nf < nr ? nf : nr);
        if (kept == 0 || kept > order[i]) {
          p.f.push_back(nf);
          p.r.push_back(nr);
          if (banded) p.ok.push_back(band[i] >> j & 1);
        }
      });
    }
  }

  // Pop t's queued level p.f, p.r (the rules above); its expanded nodes
  // go to the end of p.sf, p.sr, p.so. Returns false when the traversal
  // has ended.
  bool walk_level(Traversal& t, Part& p) const {
    const size_t before = p.sf.size();
    for (size_t i = 0; i < p.f.size(); ++i) {
      if (stop_big && t.keeper.size() > kBigTraversalsAre) {
        t.tagged.clear();
        p.sf.resize(before);
        p.sr.resize(before);
        p.so.resize(before);
        return false;
      }
      const uint64_t f = p.f[i], r = p.r[i];
      const uint64_t c = f < r ? f : r;
      if (t.keeper.order(c) != 0) continue;
      if (break_on_stop && stops.contains(c)) continue;
      if (banded && !p.ok[i]) continue;
      const uint32_t kept = t.keeper.keep(c);
      if (!t.first && tags.contains(c)) {
        t.tagged.push_back(c);
        continue;
      }
      if (t.breadth >= max_breadth) continue;
      p.sf.push_back(f);
      p.sr.push_back(r);
      p.so.push_back(kept);
      t.first = false;
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

// A walk from n start k-mers (f, r), with the graph's tags and stop tags;
// level_walk.cc runs its passes. start_ok (n bytes, nullable): the banded
// walk, whether each start is in the band; each later pass then takes the
// band bytes beside the masks.
void* kt_walk_new(const uint64_t* start_f, const uint64_t* start_r,
                  long long n, int k, const uint64_t* tags, long long n_tags,
                  const uint64_t* stops, long long n_stops, int max_breadth,
                  int break_on_stop, int stop_big, int threads,
                  const uint8_t* start_ok) {
  Walk* w = new Walk(start_f, start_r, n, k, threads);
  if (start_ok != nullptr) {
    w->banded = true;
    w->start_ok.assign(start_ok, start_ok + n);
  }
  w->tags = U64Set(static_cast<size_t>(n_tags));
  for (long long i = 0; i < n_tags; ++i) w->tags.insert(tags[i]);
  w->stops = U64Set(static_cast<size_t>(n_stops));
  for (long long i = 0; i < n_stops; ++i) w->stops.insert(stops[i]);
  w->max_breadth = static_cast<uint32_t>(max_breadth);
  w->break_on_stop = break_on_stop != 0;
  w->stop_big = stop_big != 0;
  return static_cast<khmer_host::WalkBase*>(w);
}

// The number of tags each traversal found, once the walk has ended.
void kt_walk_counts(void* walk, long long* out) {
  const Walk& w = walk_of(walk);
  for (size_t i = 0; i < w.trav.size(); ++i) out[i] = w.trav[i].tagged.size();
}

// The tags of every traversal, each ascending, one traversal after the
// other.
void kt_walk_tags(void* walk, uint64_t* out) {
  Walk& w = walk_of(walk);
  for (Traversal& t : w.trav) {
    std::sort(t.tagged.begin(), t.tagged.end());
    std::memcpy(out, t.tagged.data(), 8 * t.tagged.size());
    out += t.tagged.size();
  }
}

}  // extern "C"
