// The excursions of the knot pipeline: a batch of bounded-radius
// traversals on the host, one breadth level of every traversal a pass, and
// the evaluation of their k-mers that turns the highly connected ones into
// stop tags (repartition_largest_partition).
//
// A traversal is the reference's Hashgraph::traverse_from_kmer
// (src/oxli/hashgraph.cc:503-570), as JAX's native host engine runs it
// (its traverse_from_kmer, which JAX's CLIs run under
// KHMER_TPU_ENGINE=auto): pop a FIFO queue; stop once an entry's breadth
// exceeds the radius, or, with max_count, once more than max_count nodes
// are kept; skip a node already kept or a stop tag; keep any other; queue
// its present neighbours not kept, to the right then to the left, with
// the bases in the order A, C, G, T. The queue holds one breadth level
// after another, and a level's new nodes are kept in the order their
// parents were, so a pass keeps a level of every traversal in the queue's
// order and the caller probes the neighbours of all the nodes it kept at
// once on the card (level_walk.h). A node at the radius is kept and not probed: its children would be
// popped past the radius.
//
// Each traversal records every kept node's (f, r) and neighbour byte, so
// that it can be walked again without the card against more stop tags: a
// stop tag only prunes, so the new walk keeps a subset of the old one's
// nodes, each at a breadth no smaller, and every node it expands was
// expanded (probed) before.
//
// The evaluation (kt_exc_evaluate) takes the traversals in order, as JAX
// walks the partition's tags one at a time (core/partition.py
// repartition_largest_partition). A traversal walked against the stop
// tags as they stood when the batch began is the one JAX walks exactly
// when it kept none of the stop tags that the traversals before it in the
// batch added; otherwise it is walked again. Each k-mer of a traversal of
// at least `threshold` nodes, in ascending order, reads its counter in
// every table: the table's counter when the batch began (kernel M, or R
// in nibble tables), plus the adds of the batch's earlier traversals
// (saturated where the card's counter is: 255 in a byte, 15 in a nibble),
// plus the adds of its own traversal's earlier k-mers. A k-mer whose least
// counter exceeds `frequency` becomes a stop tag; any other is added, to be
// committed after the batch in the order JAX commits them (kernel A, or P
// in nibble tables). A traversal under `threshold` nodes makes its
// start a small tag.
//
// The pass driver, the neighbours' arithmetic and the tables (the keeper,
// the stop tags, the counts) are level_walk.h's and u64_set.h's, shared
// with tag_walk.cc; the level's rules stay apart from tag_walk.cc's, whose
// traversals end at tags, record tags and keep no neighbour bytes.
// Built with g++ at first use by khmer_tpu_torch/ops/host.py
// (ExcursionWalk).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "level_walk.h"

namespace {

using khmer_host::Keeper;
using khmer_host::LevelWalk;
using khmer_host::PassPart;
using khmer_host::U64Map;
using khmer_host::U64Set;


struct Excursion {
  uint64_t f0, r0;  // the start
  Keeper keeper;    // canonical k-mer -> keeping order
  std::vector<uint64_t> f, r;  // each kept node, in keeping order
  std::vector<uint8_t> mask;   // its neighbour byte, once probed
  uint32_t breadth = 0;
  size_t level = 0;         // the first node of the last level
  int64_t lo = 0;           // its first node in the frontier
};

std::vector<uint64_t> sorted_keeper(const Excursion& t) {
  std::vector<uint64_t> out(t.f.size());
  for (size_t i = 0; i < t.f.size(); ++i) {
    out[i] = t.f[i] < t.r[i] ? t.f[i] : t.r[i];
  }
  std::sort(out.begin(), out.end());
  return out;
}

class Walk : public LevelWalk<Excursion, PassPart> {
 public:
  using LevelWalk::LevelWalk;

  U64Set stops{0};
  uint32_t radius = 0;
  size_t cap = 0;  // the most nodes a traversal keeps (max_count + 1), 0: any

  // Walk t again from its start over the neighbour bytes it recorded,
  // skipping the stop tags `extra` as well as the walk's own. Returns its
  // new keeper, in keeping order.
  std::vector<uint64_t> rewalk(const Excursion& t,
                               const U64Set& extra) const {
    Keeper kept;
    std::vector<uint64_t> out;
    std::vector<uint64_t> lf, lr, nf, nr;
    auto visit_again = [&](uint64_t f, uint64_t r) {
      const uint64_t c = f < r ? f : r;
      if (kept.order(c) != 0 || stops.contains(c) || extra.contains(c)) {
        return;
      }
      kept.keep(c);
      out.push_back(c);
      nf.push_back(f);
      nr.push_back(r);
    };
    visit_again(t.f0, t.r0);
    for (uint32_t breadth = 0; breadth < radius && !nf.empty(); ++breadth) {
      lf.swap(nf);
      lr.swap(nr);
      nf.clear();
      nr.clear();
      for (size_t i = 0; i < lf.size(); ++i) {
        // the node as the first walk probed it (the same neighbours)
        const uint64_t c = lf[i] < lr[i] ? lf[i] : lr[i];
        const size_t o = t.keeper.order(c) - 1;
        kmer.each_child(t.f[o], t.r[o], t.mask[o], visit_again);
      }
    }
    return out;
  }

 protected:
  void walk_run(const uint8_t* masks, const uint8_t*, int64_t lo,
                int64_t hi, PassPart& p) override {
    for (int64_t i = lo; i < hi; ++i) {
      Excursion& t = trav[live[i]];
      const bool goes_on = walk_level(t, masks);
      p.keeper_bytes += t.keeper.bytes() + t.f.capacity() * 17;
      if (!goes_on) continue;
      t.lo = static_cast<int64_t>(p.sf.size());
      p.sf.insert(p.sf.end(), t.f.begin() + t.level, t.f.end());
      p.sr.insert(p.sr.end(), t.r.begin() + t.level, t.r.end());
      p.live.push_back(live[i]);
    }
  }

 private:
  // Keep (f, r) in t unless it is kept, a stop tag, or t is full; false
  // once t is full.
  bool visit(Excursion& t, uint64_t f, uint64_t r) const {
    if (cap && t.keeper.size() >= cap) return false;
    const uint64_t c = f < r ? f : r;
    if (t.keeper.order(c) != 0 || stops.contains(c)) return true;
    t.keeper.keep(c);
    t.f.push_back(f);
    t.r.push_back(r);
    t.mask.push_back(0);
    return true;
  }

  // Walk t one level: keep the start (no masks) or the present children
  // of its last level, whose bytes `masks` holds from t.lo. Returns
  // whether its new level goes on to be probed.
  bool walk_level(Excursion& t, const uint8_t* masks) const {
    const size_t end = t.f.size();
    bool room = true;
    if (masks == nullptr) {
      room = visit(t, t.f0, t.r0);
    } else {
      for (size_t i = t.level; i < end && room; ++i) {
        const uint8_t m = masks[t.lo + static_cast<int64_t>(i - t.level)];
        t.mask[i] = m;
        kmer.each_child(t.f[i], t.r[i], m, [&](uint64_t nf, uint64_t nr) {
          room = room && visit(t, nf, nr);
        });
      }
      ++t.breadth;
    }
    t.level = masks == nullptr ? 0 : end;
    return room && t.f.size() > t.level && t.breadth < radius;
  }
};

Walk& walk_of(void* walk) {
  return *static_cast<Walk*>(static_cast<khmer_host::WalkBase*>(walk));
}

}  // namespace

extern "C" {

// A walk of radius `radius` (>= 0) from n start k-mers (f, r), with the
// graph's stop tags; max_count > 0 ends a traversal once it has kept
// max_count + 1 nodes. level_walk.cc runs its passes.
void* kt_exc_new(const uint64_t* start_f, const uint64_t* start_r,
                 long long n, int k, const uint64_t* stops, long long n_stops,
                 int radius, long long max_count, int threads) {
  Walk* w = new Walk(start_f, start_r, n, k, threads);
  w->stops = U64Set(static_cast<size_t>(n_stops));
  for (long long i = 0; i < n_stops; ++i) w->stops.insert(stops[i]);
  w->radius = static_cast<uint32_t>(radius);
  w->cap = max_count > 0 ? static_cast<size_t>(max_count) + 1 : 0;
  return static_cast<khmer_host::WalkBase*>(w);
}

// The nodes each traversal kept, once the walk has ended.
void kt_exc_counts(void* walk, long long* out) {
  const Walk& w = walk_of(walk);
  for (size_t i = 0; i < w.trav.size(); ++i) out[i] = w.trav[i].f.size();
}

// The keepers of the traversals that kept at least `least` nodes, each
// ascending, one after another.
void kt_exc_keepers(void* walk, long long least, uint64_t* out) {
  const Walk& w = walk_of(walk);
  for (const Excursion& t : w.trav) {
    if (static_cast<long long>(t.f.size()) < least) continue;
    const std::vector<uint64_t> keeper = sorted_keeper(t);
    std::memcpy(out, keeper.data(), 8 * keeper.size());
    out += keeper.size();
  }
}

// The evaluation of the batch (see above), the traversals in order. base:
// u8 [T, m], each table's counter of every k-mer that kt_exc_keepers
// gave with least = threshold (m of them), when the batch began. Writes
// the new stop tags to out_stops and the adds to out_adds, each in the
// order found, and a flag a traversal to out_small (1: its start is a
// small tag; 2: it was walked again, at least `threshold` nodes; 3: both);
// their counts to out_n[0], out_n[1]. Output buffers of m values do. A
// counter saturates at `saturation` (255 in a byte table, 15 in a nibble
// table): the earlier traversals' adds go onto the base as the table would
// hold them, this traversal's on top.
void kt_exc_evaluate(void* walk, const uint8_t* base, long long m,
                     const long long* primes, int ntables, long long threshold,
                     long long frequency, int saturation, uint64_t* out_stops,
                     uint64_t* out_adds, uint8_t* out_small,
                     long long* out_n) {
  const Walk& w = walk_of(walk);
  // a counter's key: its bin times the tables, plus its table
  auto key = [&](uint64_t km, int tb) {
    return (km % static_cast<uint64_t>(primes[tb])) *
               static_cast<uint64_t>(ntables) + static_cast<uint64_t>(tb);
  };
  U64Map carried;  // the adds of the batch's earlier traversals, by key
  U64Set added(64);
  std::vector<uint64_t> added_list;
  long long n_stops = 0, n_adds = 0;
  long long col = 0;  // the traversal's first column of base
  for (size_t j = 0; j < w.trav.size(); ++j) {
    const Excursion& t = w.trav[j];
    const std::vector<uint64_t> walked = sorted_keeper(t);
    const bool gathered = static_cast<long long>(walked.size()) >= threshold;
    bool stale = false;
    if (!added_list.empty()) {
      if (added_list.size() < walked.size()) {
        for (uint64_t c : added_list) {
          if (t.keeper.order(c) != 0) { stale = true; break; }
        }
      } else {
        for (uint64_t c : walked) {
          if (added.contains(c)) { stale = true; break; }
        }
      }
    }
    std::vector<uint64_t> keeper = walked;
    if (stale) {
      keeper = w.rewalk(t, added);
      std::sort(keeper.begin(), keeper.end());
    }
    const bool big = static_cast<long long>(keeper.size()) >= threshold;
    out_small[j] = (big ? 0 : 1) | (stale ? 2 : 0);
    if (big) {
      U64Map local;  // the adds of this traversal's earlier k-mers
      size_t at = 0;  // keeper[at] within walked, from col
      for (size_t i = 0; i < walked.size() && at < keeper.size(); ++i) {
        if (walked[i] != keeper[at]) continue;
        const uint64_t km = keeper[at++];
        long long cur = -1;
        for (int tb = 0; tb < ntables; ++tb) {
          const uint64_t kt = key(km, tb);
          long long v = base[tb * m + col + static_cast<long long>(i)]
                        + carried.get(kt);
          v = std::min<long long>(v, saturation) + local.get(kt);
          cur = cur < 0 ? v : std::min(cur, v);
        }
        if (cur > frequency) {
          out_stops[n_stops++] = km;
          added.insert(km);
          added_list.push_back(km);
        } else {
          out_adds[n_adds++] = km;
          for (int tb = 0; tb < ntables; ++tb) local.add(key(km, tb), 1);
        }
      }
      local.each([&](uint64_t kt, uint32_t n) { carried.add(kt, n); });
    }
    if (gathered) col += static_cast<long long>(walked.size());
  }
  out_n[0] = n_stops;
  out_n[1] = n_adds;
}

}  // extern "C"
